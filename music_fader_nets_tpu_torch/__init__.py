"""music_fader_nets_tpu_torch — the PyTorch + CUDA port of
`music_fader_nets_tpu`, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it stays the reference; this package keeps its module
structure, names and parameter layouts (nested dicts of tensors, weights
input-major `(I, 3H)` / `(H, 3H)`, gate order r, z, n) so each module's
counterpart is easy to find and weights carry across with a plain copy.

Ported so far: the GM-VAE serving path (the token bi-GRU encoder, the
latent shift and the 300-step greedy / Gumbel-max sampling decode), the
training of all six families (their objectives, the `Trainer` with `fit`,
its step timers and its state in canonical trees), checkpoints and the
training CLI with resume, the single GM-VAE, the evaluation path
(reconstruction report, controllability metrics and their CLI, with the
host-side tokenizer they read), and arousal transfer to MIDI and WAV; the
serving, evaluation and transfer CLIs load what training saved. The
reference-facing surface too: the JAX package's public primitives and
subpackage exports, the tokenizer's compat layer, the VGMIDI label
filtering, the native C++ codec, the released-artifact parity harness
(`parity.py`) and the graft entry (`entry.py`). Hand-
written CUDA kernels (`csrc/`) stand in place of every Pallas kernel;
each training kernel is a `torch.autograd.Function` with a backward
kernel. Every kernel wrapper keeps a plain PyTorch version beside it, used
only for tensors that lie on the CPU.

Layout:
  ops/        GRU primitives, sampling, kernel build + wrappers
  csrc/       CUDA C++ kernels (plain C interface, loaded with ctypes)
  models/     encoder / sub-decoder / global decoder modules, RegVAE +
              GM-VAE pieces, the fast (kernel-layout) parameter view
  losses/     ELBO terms, GM-VAE KL terms, the Pati regularizer
  tokenizer/  MIDI notes, the 342-token performance codec, pianoroll
              attributes, key estimation, the corpus pipeline, the
              reference-API compat layer (host side)
  native/     the C++ tokenizer kernels, built with g++ at first use
  data/       corpora (cache, MIDI rebuild, synthetic), dataset views,
              batch iteration, VGMIDI annotation filtering
  train/      the objectives, the Trainer, the training CLI and what the
              other CLIs share with it, step profilers
  eval/       reconstruction report, controllability evaluators, eval CLI
  transfer/   arousal transfer (latent shift, decode, MIDI and WAV out)
              and its CLI
  serve/      micro-batching TransferServer and its JSON-lines CLI
  utils/      checkpoints and the reference .pt converter, parameter
              trees, metrics logging, profiling helpers
  parity.py   the released-artifact parity harness
  entry.py    the graft entry: the GM-VAE forward + loss
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Greedy token feedback turns one flipped near-tie into wholesale
# divergence, so every float32 product stays in full float32; and a bf16
# product outside the kernels (the mixed-precision objectives' input
# projections) accumulates in float32 before its one rounding, as XLA's
# does, rather than reducing split-K partials in bf16.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
