"""Ops of the port: MSDA (plain version and the CUDA kernel wrapper)."""
