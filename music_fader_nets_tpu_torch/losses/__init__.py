"""ELBO terms and the GM-VAE / Pati regularizers."""
