"""Reconstruction / token-accuracy report (counterpart of
`music_fader_nets_tpu/eval/reconstruction.py`), the `evaluation_phase()`
pass of every reference trainer (reference trainer.py:280-376): CE terms,
Pati regularizers and per-sample token accuracy over a split, with the
reference's trimming of the event stream (the padded tail of the target is
cut, the prediction's prefix compared; trainer.py:329-349), as one masked
computation per batch.

The forward's random draws are the caller's, as in the `Trainer`:
`noise_fn(start, B) -> tuple` for the batch that starts at row `start`, by
default `draw(gen, B)` from a `torch.Generator` seeded from (seed, start).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.losses.elbo import nll_mean
from music_fader_nets_tpu_torch.losses.regularizers import pati_regularizer
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to


def _masked_accuracy(logp: torch.Tensor, targets: torch.Tensor,
                     trim: bool) -> torch.Tensor:
    """Sum over the batch of per-sample accuracy. trim=True keeps positions
    up to the target's last nonzero token (the reference's np.trim_zeros
    on a zero-padded tail)."""
    pred = torch.argmax(logp, dim=-1)
    targets = targets.long()
    if trim:
        T = targets.shape[1]
        pos = torch.arange(T, device=targets.device)[None, :]
        last = torch.where(targets != 0, pos, -1).max(dim=1).values   # (B,)
        mask = pos <= last[:, None]
    else:
        mask = torch.ones_like(targets, dtype=torch.bool)
    correct = mask & (pred == targets)
    lens = mask.sum(dim=1).clamp(min=1)
    return (correct.sum(dim=1) / lens).sum()


def _batch_metrics(fwd: Dict, batch: Dict, has_subdecoders: bool) -> Dict:
    """One batch's terms from its forward `fwd`: per-batch means, and
    per-sample sums under the keys that end in `_sum`."""
    out = {"CE_X": nll_mean(fwd["out"], batch["x"]),
           "acc_x_sum": _masked_accuracy(fwd["out"], batch["x"], True)}
    if has_subdecoders:
        out["CE_R"] = nll_mean(fwd["r_out"], batch["r"])
        out["CE_N"] = nll_mean(fwd["n_out"], batch["n"])
        out["acc_r_sum"] = _masked_accuracy(fwd["r_out"], batch["r"], False)
        out["acc_n_sum"] = _masked_accuracy(fwd["n_out"], batch["n"], False)
        out["l_r"] = pati_regularizer(fwd["z_r"][:, 0], batch["r_density"])
        out["l_n"] = pati_regularizer(fwd["z_n"][:, 0], batch["n_density"])
    if "qy_x_r" in fwd and "a" in batch:
        # GM-VAE supervised splits: arousal-classification accuracy of the
        # mixture posterior, argmax qy_x against the binarized label
        # (reference trainer_gmm.py:570-578), as a per-sample average
        y = batch["a"].long()
        for s in ("r", "n"):
            out[f"acc_q_x_{s}_sum"] = (
                torch.argmax(fwd[f"qy_x_{s}"], dim=-1) == y).float().sum()
    return out


def reconstruction_report(params, forward: Callable, arrays: Dict,
                          cfg: ModelConfig, draw: Optional[Callable] = None,
                          batch_size: int = 128, seed: int = 0,
                          has_subdecoders: bool = True,
                          noise_fn: Optional[Callable] = None,
                          device=None) -> Dict[str, float]:
    """forward(params, noise, batch) -> dict with 'out' (+ 'r_out',
    'n_out', 'z_r', 'z_n' for disentangled models), over batches of
    device tensors; `draw(gen, B)` or `noise_fn(start, B)` gives its noise
    (`train/cli.py::_forward_for` returns a family's forward and draw).
    The final partial batch counts too (the reference's DataLoader has
    drop_last=False and averages per-batch means with equal weight).
    Returns the averaged CE / regularizer terms and token accuracies. Runs
    on CUDA unless device='cpu'."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    if noise_fn is None:
        if draw is None:
            raise ValueError("reconstruction_report needs draw or noise_fn")

        def noise_fn(start, B):
            gen = torch.Generator().manual_seed(seed * 1_000_003 + start)
            return draw(gen, B)

    totals: Dict[str, float] = {}
    n_batches = 0
    n = len(arrays["x"])
    for s in range(0, n, batch_size):
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[s: s + batch_size])).to(dev) for k, v in arrays.items()}
        B = len(batch["x"])
        noise = tuple(e.to(dev, torch.float32) for e in noise_fn(s, B))
        with torch.no_grad():
            m = _batch_metrics(forward(params, noise, batch), batch,
                               has_subdecoders)
            vals = torch.stack([m[k].float() for k in sorted(m)]).tolist()
        for k, v in zip(sorted(m), vals):
            totals[k] = totals.get(k, 0.0) + v
        n_batches += 1

    if n_batches == 0:
        return {}
    return {(k[:-4] if k.endswith("_sum") else k):
            (v / n if k.endswith("_sum") else v / n_batches)
            for k, v in totals.items()}
