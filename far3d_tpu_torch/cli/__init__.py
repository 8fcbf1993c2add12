"""Command-line tools of the port: ``python -m far3d_tpu_torch.cli.<name>``."""
