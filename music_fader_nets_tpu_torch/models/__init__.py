"""Model pieces of the serving path: encoder streams, the global decoder,
the RegVAE tree and the GM-VAE entry points."""
