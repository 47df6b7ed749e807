"""The collectives of data and tensor parallelism, standing in for those
GSPMD inserts in the JAX package: the flat gradient all-reduce over the
data group and the parameter broadcast of the `Trainer`, the gather of the
weights' slices over the model group, and a differentiable gather of batch
rows over the data group for the loss terms that read other ranks' rows.

Every collective here is an `all_reduce` (sum) or a `broadcast`: both the
gloo and the NCCL backend run them on CUDA tensors, where gloo runs
`all_gather` on CPU tensors only, and two ranks sharing one card must use
gloo (NCCL refuses two ranks on one device). A gather is therefore one
all-reduce of a zeroed buffer into which each rank wrote its part: the sum
adds only zeros, so it is exact (a -0.0 comes back as 0.0).

`mesh` is a `parallel.mesh.Mesh`: its sizes, its indices on both axes and
their process groups.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
    """Each tensor replaced by its mean over this rank's data group, in
    place, with one all-reduce of one flat buffer (per dtype). The sum is
    the same on every rank of the group, so the result is bit-equal across
    them. (Over the whole world under a model axis it would count each
    gradient n_model times.)"""
    def mean(flat):
        dist.all_reduce(flat, group=mesh.data_group)
        flat.div_(mesh.n_data)
    _flat_apply(tensors, mean)


def all_gather_model_(fulls: Sequence[torch.Tensor],
                      shards: Sequence[Optional[torch.Tensor]],
                      specs: Sequence[tuple], mesh) -> None:
    """Each `fulls[i]` rebuilt, in place, from the model group's shards:
    `shards[i]` is this rank's block of it along the axis that `specs[i]`
    puts over `model` (`mesh.model_slice`); with a spec that puts no axis
    there, the whole tensor, given by one rank of the group and None on
    the others. One zeroed flat buffer per dtype, each rank's shards
    written in, one all-reduce over the model group, then each full tensor
    copied back: exact, and bit-equal on every rank of the group."""
    # imported here: mesh.py imports this module
    from music_fader_nets_tpu_torch.parallel.mesh import model_slice
    by_dtype = {}
    for item in zip(fulls, shards, specs):
        by_dtype.setdefault(item[0].dtype, []).append(item)
    for items in by_dtype.values():
        flat = items[0][0].new_zeros(sum(f.numel() for f, _, _ in items))
        offset = 0
        for full, shard, spec in items:
            n = full.numel()
            if shard is not None:
                model_slice(flat[offset: offset + n].view_as(full), spec,
                            mesh.n_model, mesh.model_index).copy_(shard)
            offset += n
        dist.all_reduce(flat, group=mesh.model_group)
        offset = 0
        for full, _, _ in items:
            n = full.numel()
            full.detach().copy_(flat[offset: offset + n].view_as(full))
            offset += n


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by rank 0's, in place, with one broadcast of
    one flat buffer (per dtype)."""
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, 0))


class _GatherRows(torch.autograd.Function):
    """Rows of every data rank stacked in data-index order, over this
    rank's data group. Forward: this rank's rows written into a zeroed
    buffer of the global size, then one all-reduce (sum): the sum adds
    only zeros, so the result is bit-exact. Backward: the cotangent
    all-reduced (each rank's loss reads every row), this rank's slice
    returned. (Over the whole world under a model axis, the model
    replicas' rows would be summed in.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh) -> torch.Tensor:
        n = x.shape[0]
        r = mesh.data_index
        out = x.new_zeros((mesh.n_data * n,) + tuple(x.shape[1:]))
        out[r * n: (r + 1) * n] = x
        dist.all_reduce(out, group=mesh.data_group)
        ctx.mesh, ctx.n = mesh, n
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        r, n = ctx.mesh.data_index, ctx.n
        return g[r * n: (r + 1) * n], None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of `x` (leading axis this rank's rows, equal
    on every rank), differentiable: the backward hands each rank the sum
    over ranks of the cotangent of its rows. Under the `Trainer`'s mean
    all-reduce of the gradients, a term that every rank computes from the
    gathered rows then gets its gradient once, as in one process."""
    return _GatherRows.apply(x, mesh)

