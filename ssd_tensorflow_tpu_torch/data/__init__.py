"""Input-side modules: the batched on-device augmentation (``device_augment``)."""
