"""Model modules of the port, named after the JAX package's."""
