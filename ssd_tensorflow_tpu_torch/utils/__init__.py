"""Host utilities: checkpoints."""
