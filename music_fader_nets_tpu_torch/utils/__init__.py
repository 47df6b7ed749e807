"""Parameter-tree helpers."""
