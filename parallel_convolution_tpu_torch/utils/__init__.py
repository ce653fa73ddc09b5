"""Configuration registries, device resolution and raw image I/O."""
