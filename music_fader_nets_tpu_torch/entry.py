"""The port's graft entry point (counterpart of the root
`__graft_entry__.entry()`, which runs the JAX package).

`entry(device=None)` returns `(fn, example_args)`: `fn(params, eps, batch,
step) -> (loss, metrics)` is the flagship model's (the GM-VAE's) forward
and its `gmm_loss`, and `example_args` are seeded full-width inputs for
one call on one card:

    from music_fader_nets_tpu_torch.entry import entry
    fn, args = entry()                 # device="cpu" for the plain path
    loss, metrics = fn(*args)

The params are the fast (kernel) layout the `Trainer` trains
(`models/fast.py::split_fast` of `init_reg_gmvae` from a
`torch.Generator` seeded 0), so on CUDA the forward runs the kernels of
the training path: the token encoder, the class-embedded sub-decoders and
the decoder with its cross-entropy head. `eps` is the objective's noise,
drawn by `train/objectives.py::draw_noise` from a generator seeded 1.
"""
from __future__ import annotations

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig

BATCH = 8


def example_batch(cfg: ModelConfig, B: int, rng=0) -> dict:
    """The root `__graft_entry__._example_batch` as numpy arrays (the same
    draws from `np.random.default_rng(rng)`)."""
    r = np.random.default_rng(rng)
    return {
        "x": r.integers(0, cfg.roll_dims, (B, cfg.seq_len)).astype(np.int32),
        "r": r.integers(0, cfg.rhythm_dims, (B, cfg.attr_len)).astype(
            np.int32),
        "n": r.integers(0, cfg.note_dims, (B, cfg.attr_len)).astype(np.int32),
        "c": r.random((B, cfg.chroma_dims)).astype(np.float32),
        "a": r.integers(0, 2, (B,)).astype(np.int32),
        "r_density": r.random(B).astype(np.float32),
        "n_density": r.random(B).astype(np.float32),
    }


def entry(device=None):
    """(fn, (params, eps, batch, step)): the GM-VAE forward + `gmm_loss` at
    full width, B=8, on CUDA unless `device="cpu"`."""
    from music_fader_nets_tpu_torch.models.fast import split_fast
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.train.objectives import (
        draw_noise, gmm_loss,
    )
    from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

    dev = resolve_device(device)
    cfg = ModelConfig(num_clusters=2, seq_len=100, attr_len=16)
    params = tree_to(split_fast(
        init_reg_gmvae(torch.Generator().manual_seed(0), cfg))[0], dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in example_batch(cfg, BATCH).items()}
    eps = tuple(e.to(dev) for e in draw_noise(
        gmm_loss, torch.Generator().manual_seed(1), BATCH, cfg))
    step = 0

    def fn(params, eps, batch, step):
        return gmm_loss(params, eps, batch, step, cfg)

    return fn, (params, eps, batch, step)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", float(fn(*args)[0]))
