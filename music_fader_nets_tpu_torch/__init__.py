"""music_fader_nets_tpu_torch — the PyTorch + CUDA port of
`music_fader_nets_tpu`, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it stays the reference; this package keeps its module
structure, names and parameter layouts (nested dicts of tensors, weights
input-major `(I, 3H)` / `(H, 3H)`, gate order r, z, n) so each module's
counterpart is easy to find and weights carry across with a plain copy.

This slice ports the GM-VAE serving path: the token bi-GRU encoder, the
latent shift and the 300-step greedy / Gumbel-max sampling decode, with
hand-written CUDA kernels (`csrc/`) in place of the three Pallas kernels on
that path. Every kernel wrapper keeps a plain PyTorch version beside it,
used only for tensors that lie on the CPU.

Layout:
  ops/        GRU primitives, sampling, kernel build + wrappers
  csrc/       CUDA C++ kernels (plain C interface, loaded with ctypes)
  models/     encoder / global decoder modules, RegVAE + GM-VAE pieces
  transfer/   latent shift vectors of arousal transfer
  serve/      micro-batching TransferServer and its JSON-lines CLI
  utils/      numpy <-> tensor parameter conversion
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Greedy token feedback turns one flipped near-tie into wholesale
# divergence, so every float32 product stays in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from music_fader_nets_tpu_torch.config import ModelConfig, load_config  # noqa: E402,F401


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU explicitly. Raises RuntimeError when CUDA is wanted but absent —
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
