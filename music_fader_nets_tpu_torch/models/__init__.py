"""Model pieces: encoder streams, the attribute sub-decoders, the global
decoder, the RegVAE tree, the GM-VAE forward and entry points, and the fast
(kernel-layout) parameter view."""
