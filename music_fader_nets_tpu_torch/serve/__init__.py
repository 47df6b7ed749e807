"""Micro-batching serving of the GM-VAE on the GPU."""
from music_fader_nets_tpu_torch.serve.server import TransferServer  # noqa: F401
