"""Arousal transfer: the latent shift vectors."""
