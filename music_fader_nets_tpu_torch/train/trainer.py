"""The GM-VAE trainer (counterpart of `music_fader_nets_tpu/train/trainer.py`,
its streaming path `run_epoch(compiled=False)`).

A step: the loss on the fast parameter layout (`models/fast.py`), its
backward, the global-norm clip at 1.0 and Adam(lr) (reference
trainer.py:49,157). Adam steps the fast-layout leaves; the parity-only
layers (`fast.FROZEN_KEYS`) and the frozen mixture logvar tables take no
update, as in the JAX package, where their gradients are zero.

The noise of the two reparameterisations is the caller's: `noise_fn(
host_step, B, Z) -> (eps_r, eps_n)`, by default N(0, 1) draws of a
`torch.Generator` seeded from (seed, host_step). The host step counts every
batch, training and evaluation, as the JAX Trainer's `_host_step` does, so
a test can hand both trainers the same draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.loader import batch_iterator
from music_fader_nets_tpu_torch.models import fast as fast_lib
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.utils.checkpoint import tree_map, tree_to

# leaves of the fast tree that Adam does not step (no gradient reaches
# them: reference gmm_model.py:151-184 keeps them fixed)
FROZEN_TABLES = ("logvar_r_lookup", "logvar_n_lookup")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    `max_norm`, else every gradient becomes g / norm * max_norm. (Not
    `torch.nn.utils.clip_grad_norm_`, which scales by max_norm / (norm +
    1e-6) and so differs.) In place; returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class Trainer:
    def __init__(self, cfg: ModelConfig, init_fn: Callable,
                 loss_fns: Dict[str, Callable], seed: int = 0, params=None,
                 device=None, noise_fn: Optional[Callable] = None):
        """loss_fns: named objectives, e.g. {"default": gmm_loss,
        "supervised": partial(gmm_loss, is_supervised=True)} for the
        dual-corpus GM-VAE loop. `params` is a canonical tree (default:
        `init_fn(torch.Generator().manual_seed(seed), cfg)`); it is copied.
        Runs on CUDA unless device="cpu" (RuntimeError without a card)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        if params is None:
            params = init_fn(torch.Generator().manual_seed(seed), cfg)
        params = tree_to(params, self.device)
        # merge_canonical reads only the canonical shapes
        self._template = tree_map(lambda t: t.to("meta"), params)
        fast, frozen = fast_lib.split_fast(params)
        own = (lambda t: t.detach().clone())
        self._fast = tree_map(own, fast)
        self._frozen = tree_map(own, frozen)
        self._trainable = [t for path, t in _leaves(self._fast)
                           if path[0] not in FROZEN_TABLES]
        for t in self._trainable:
            t.requires_grad_(True)
        self.optimizer = torch.optim.Adam(self._trainable, lr=cfg.lr)
        self._loss_fns = dict(loss_fns)
        self.noise_fn = noise_fn or self._default_noise
        self.step = 0            # training steps taken; drives KL annealing
        self._host_step = 0      # batches seen; drives the noise
        self.train_path = None   # "kernel" / "plain-cpu" of the last step

    def _default_noise(self, host_step: int, B: int, Z: int):
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + host_step)
        eps = torch.randn((2, B, Z), generator=gen)
        return eps[0], eps[1]

    @property
    def fast_params(self) -> Dict:
        """The fast-layout tree that Adam steps (live tensors)."""
        return self._fast

    @property
    def params(self) -> Dict:
        """The canonical tree (copies), `merge_canonical` of the fast one."""
        fast = tree_map(lambda t: t.detach().clone(), self._fast)
        return fast_lib.merge_canonical(fast, self._frozen, self._template)

    def _batch(self, batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, loss_fn: Callable, batch, eps):
        """One step on a batch of device tensors; returns the metrics."""
        cuda_gru.LAST_TRAIN_PATH = cuda_decoder.LAST_TRAIN_PATH = None
        loss, metrics = loss_fn(self._fast, eps, batch, self.step, self.cfg)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        paths = {cuda_gru.LAST_TRAIN_PATH, cuda_decoder.LAST_TRAIN_PATH}
        self.train_path = paths.pop() if len(paths) == 1 else "mixed"
        grads = []
        for t in self._trainable:
            if t.grad is None:      # optax steps a zero gradient too
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        with torch.no_grad():
            clip_by_global_norm_(grads, 1.0)
        self.optimizer.step()
        self.step += 1
        return metrics

    def run_epoch(self, arrays: Dict[str, np.ndarray],
                  variant: str = "default", train: bool = True,
                  shuffle: bool = True, seed: Optional[int] = None,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
        """One pass over `arrays` in batches (the last partial one
        dropped); returns the per-batch mean of each metric. Evaluation
        (train=False) runs the same objective without a gradient, as the
        JAX Trainer's eval step does."""
        n = len(next(iter(arrays.values())))
        if n == 0:
            return {}
        bs = min(batch_size or self.cfg.batch_size, n)
        loss_fn = self._loss_fns[variant]
        Z = self.cfg.z_dims
        totals, nb = None, 0
        for host_batch in batch_iterator(arrays, bs, shuffle=shuffle,
                                         seed=seed):
            eps = tuple(e.to(self.device, torch.float32)
                        for e in self.noise_fn(self._host_step, bs, Z))
            self._host_step += 1
            batch = self._batch(host_batch)
            if train:
                metrics = self.train_step(loss_fn, batch, eps)
            else:
                with torch.no_grad():
                    _, metrics = loss_fn(self._fast, eps, batch, self.step,
                                         self.cfg)
            vals = torch.stack([metrics[k].detach() for k in sorted(metrics)])
            totals = vals if totals is None else totals + vals
            nb += 1
        if totals is None:
            return {}
        return {k: v / nb for k, v in zip(sorted(metrics), totals.tolist())}
