"""Command lines of the port: `python3 -m st_dadk_tpu_torch.cli.<name>` with
the flags of the JAX package's `scripts/<name>.py`."""
