"""The collectives of data parallelism, standing in for those GSPMD inserts
in the JAX package: the flat gradient all-reduce and the parameter
broadcast of the `Trainer`, and a differentiable gather of batch rows for
the loss terms that read other ranks' rows.

Every collective here is an `all_reduce` (sum) or a `broadcast`: both the
gloo and the NCCL backend run them on CUDA tensors, where gloo runs
`all_gather` on CPU tensors only, and two ranks sharing one card must use
gloo (NCCL refuses two ranks on one device).

`mesh` is a `parallel.mesh.Mesh` over the default process group: its
`rank` and `n_data`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _flat_apply(tensors: Sequence[torch.Tensor], collective) -> None:
    """`collective(flat)` on one flat buffer per dtype holding every
    tensor, then each tensor copied back from it (in place)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.detach().copy_(flat[offset: offset + n].view_as(t))
            offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Each tensor replaced by its mean over the data ranks, in place, with
    one all-reduce of one flat buffer (per dtype). The sum is the same on
    every rank, so the result is bit-equal across ranks."""
    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.n_data)
    _flat_apply(tensors, mean)


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by rank 0's, in place, with one broadcast of
    one flat buffer (per dtype)."""
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, 0))


class _GatherRows(torch.autograd.Function):
    """Rows of every rank stacked in rank order. Forward: this rank's rows
    written into a zeroed buffer of the global size, then one all-reduce
    (sum): the sum adds only zeros, so the result is bit-exact. Backward:
    the cotangent all-reduced (each rank's loss reads every row), this
    rank's slice returned."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh) -> torch.Tensor:
        n = x.shape[0]
        out = x.new_zeros((mesh.n_data * n,) + tuple(x.shape[1:]))
        out[mesh.rank * n: (mesh.rank + 1) * n] = x
        dist.all_reduce(out)
        ctx.mesh, ctx.n = mesh, n
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        r, n = ctx.mesh.rank, ctx.n
        return g[r * n: (r + 1) * n], None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of `x` (leading axis this rank's rows, equal
    on every rank), differentiable: the backward hands each rank the sum
    over ranks of the cotangent of its rows. Under the `Trainer`'s mean
    all-reduce of the gradients, a term that every rank computes from the
    gathered rows then gets its gradient once, as in one process."""
    return _GatherRows.apply(x, mesh)

