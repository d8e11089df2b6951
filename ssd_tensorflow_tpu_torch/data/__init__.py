"""Input-side modules: the dataset sources (``sources``, ``source_*``), host
image I/O (``image_io``), the host data pipeline and the batched
on-device augmentation (``device_augment``)."""
