"""Command-line entry points, as the JAX package's: ``python -m
ssd_tensorflow_tpu_torch.cli.<name>`` for ``train``, ``process_dataset``,
``infer``, ``export_model`` and ``detect``."""

#: what ``--data-parallel N`` (N >= 1) of the serving CLIs prints before exiting 1
DATA_PARALLEL_LEFT = (
    "[!] --data-parallel has no counterpart in the PyTorch port yet (ROADMAP.md queue 1 "
    "item 12: data-parallel serving); run with --data-parallel 0 on one card")
