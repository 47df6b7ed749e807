"""Weights and inputs made on the device from the run's seed.

The weights follow a reference's `param_spec` (the port's canonical
parameter layout): one draw of U[0, 1) for every uniform leaf together,
scaled to each leaf's bound in one multiply, and views of it; the
constant leaves filled. Both the program and the reference get these same
tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from h100bench.reference.common import from_leaves


def make_params(spec: List, gen: torch.Generator,
                device: torch.device) -> Dict:
    """The canonical tree of `spec`, float32 on `device`, from `gen`."""
    uni = [(path, shape, init[1]) for path, shape, init, _ in spec
           if init[0] == "uniform"]
    sizes = [math.prod(shape) for _, shape, _ in uni]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    bounds = torch.tensor([b for _, _, b in uni], device=device)
    scale = torch.repeat_interleave(bounds, torch.tensor(sizes,
                                                         device=device))
    flat = flat.mul_(2.0).sub_(1.0).mul_(scale)
    pairs, off = [], 0
    for (path, shape, _), n in zip(uni, sizes):
        pairs.append((path, flat[off:off + n].view(shape)))
        off += n
    for path, shape, init, _ in spec:
        if init[0] == "const":
            pairs.append((path, torch.full(shape, float(init[1]),
                                           device=device)))
    order = {path: i for i, (path, _, _, _) in enumerate(spec)}
    return from_leaves(sorted(pairs, key=lambda pt: order[pt[0]]))


def stepped_paths(spec: List) -> List:
    """The leaves Adam steps: those the forward reads, less the frozen."""
    return [path for path, _, _, used in spec if used is True]


def train_pool(gen: torch.Generator, cfg: dict, batch: int, n_batches: int,
               n_noise: int, device: torch.device) -> List:
    """`n_batches` in-schema batches of `batch` rows and their noise:
    tokens in [0, roll_dims), rhythm ids in [0, rhythm_dims), note ids in
    [0, note_dims), chroma in [0, 1), the densities as the corpus computes
    them (the share of rhythm steps equal to 1, the mean note id), and
    `n_noise` N(0, 1) draws of (batch, z_dim). Int32 ids, float32 else."""
    P, B, T, Ta = n_batches, batch, cfg["seq_len"], cfg["attr_len"]
    x = torch.randint(0, cfg["roll_dims"], (P, B, T), generator=gen,
                      device=device, dtype=torch.int32)
    r = torch.randint(0, cfg["rhythm_dims"], (P, B, Ta), generator=gen,
                      device=device, dtype=torch.int32)
    n = torch.randint(0, cfg["note_dims"], (P, B, Ta), generator=gen,
                      device=device, dtype=torch.int32)
    c = torch.rand((P, B, cfg["chroma_dims"]), generator=gen, device=device)
    eps = torch.randn((P, n_noise, B, cfg["z_dim"]), generator=gen,
                      device=device)
    rd = (r == 1).float().mean(-1)
    nd = n.float().mean(-1)
    return [({"x": x[i], "r": r[i], "n": n[i], "c": c[i],
              "r_density": rd[i], "n_density": nd[i]}, tuple(eps[i]))
            for i in range(P)]
