"""Checkpoints and parameter trees, metrics logging, profiling helpers."""
