"""Training steps (sharding, remat and multi-host are not ported yet)."""
