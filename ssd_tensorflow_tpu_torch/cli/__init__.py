"""Command-line entry points: ``python -m ssd_tensorflow_tpu_torch.cli.train``."""
