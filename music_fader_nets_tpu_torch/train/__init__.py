"""Training: the GM-VAE objective and the Trainer."""
