"""ELBO terms and the families' regularizers (Pati, GM-VAE KL, GLSR,
FaderNets adversarial)."""
