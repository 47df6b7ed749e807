"""The device mesh and its layout rules (counterpart of
`music_fader_nets_tpu/parallel/mesh.py`), on `torch.distributed`.

The reference is single-process single-GPU (SURVEY.md §2.2); the JAX
package introduces a `jax.sharding.Mesh` with a `data` axis (batch rows)
and a `model` axis (the GRU gate dimension), and GSPMD inserts the
collectives. Here one process drives one rank of the default
`torch.distributed` process group, so a `Mesh` is that rank's view: the
axis sizes, its rank and its device. At this model's size pure data parallelism is
the right layout (the JAX package says so too), and that is what the port
runs: `make_mesh(n, 1)`. A `model` axis above 1 raises
`NotImplementedError` until the port has tensor parallelism (ROADMAP
queue 1 item 6); its layout rules are kept (`param_pspecs`), as tuples
that stand for `PartitionSpec`s.

Layout rules (the JAX package's):
  * batch tensors: first axis over `data` (`shard_batch` returns this
    rank's rows);
  * GRU weights `w_ih` / `w_hh` `(I, 3H)` and their biases `(3H,)`: last
    axis over `model`;
  * everything else replicated (`shard_params` broadcasts it from rank 0).

With a mesh the `Trainer` splits each batch's rows over the ranks, sets
the mesh as the trace mesh around its loss (`trace_mesh_scope`), where
the terms that couple a batch's rows (the Pati regulariser, GLSR's
faithful batch-0 read) gather what they read, and all-reduces the
gradients once a step (`train/trainer.py`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from music_fader_nets_tpu_torch.parallel.collectives import broadcast_
from music_fader_nets_tpu_torch.parallel.launch import placement

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of an `n_data x n_model` mesh: `shape` maps each
    axis name to its size (as `jax.sharding.Mesh.shape` does), `rank` is
    this process's rank in the default process group, `device` the device
    its tensors live on."""
    shape: Dict[str, int]
    rank: int
    device: torch.device

    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]


class NamedSharding(NamedTuple):
    """A layout on a mesh: `spec` is a tuple standing for a
    `PartitionSpec` (one axis name or None per tensor axis; () is
    replicated)."""
    mesh: Mesh
    spec: tuple


# The mesh a train / eval step runs under. The loss terms that couple the
# rows of a batch read it to gather what they need from the other ranks
# (losses/regularizers.py). Set by the Trainer around its loss.
_TRACE_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "music_fader_nets_torch_trace_mesh", default=None)


@contextlib.contextmanager
def trace_mesh_scope(mesh: Optional[Mesh]):
    token = _TRACE_MESH.set(mesh)
    try:
        yield
    finally:
        _TRACE_MESH.reset(token)


def current_trace_mesh() -> Optional[Mesh]:
    return _TRACE_MESH.get()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """This rank's `n_data x n_model` mesh over the initialised default
    process group, whose world size must be n_data * n_model (n_data
    defaults to world // n_model). The rank's device is
    `launch.placement(devices)`: the CPU for devices="cpu", the card named
    ("cuda:0"), or by default the rank's own card (CUDA; RuntimeError
    without one). n_model > 1 raises NotImplementedError."""
    if n_model != 1:
        raise NotImplementedError(
            f"a model axis of {n_model}: the port has no tensor parallelism "
            "yet (ROADMAP queue 1 item 6); use make_mesh(n, 1)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not match the "
                         f"process group's {world} ranks")
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank,
                placement(devices)[0])


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _leaf_pspec(path: tuple, leaf) -> tuple:
    """Partition rule for one parameter leaf, keyed by its path in the
    params tree (the JAX package's rules, :72-81)."""
    leaf_name = path[-1] if path else ""
    if leaf_name in ("w_ih", "w_hh") and leaf.ndim == 2:
        return (None, MODEL_AXIS)
    if leaf_name in ("b_ih", "b_hh") and leaf.ndim == 1:
        return (MODEL_AXIS,)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params):
    """Tree of partition specs (tuples) matching `params`."""
    return _map_with_path(_leaf_pspec, params)


def param_shardings(params, mesh: Mesh):
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _leaf_pspec(path, leaf)),
        params)


def shard_params(params, mesh: Mesh):
    """Every rank's params made rank 0's (one broadcast of all leaves, in
    place; the model axis is 1, so every leaf is replicated). Returns
    `params`."""
    leaves = []
    _map_with_path(lambda _, t: leaves.append(t), params)
    broadcast_(leaves)
    return params


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a batch dict (numpy arrays or tensors, leading
    axis the global batch): the `rank`-th of `n_data` equal blocks.
    Raises ValueError when the rows do not divide evenly."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"batch of {n} rows not divisible over "
                             f"{mesh.n_data} data ranks")
        per = n // mesh.n_data
        out[k] = v[mesh.rank * per: (mesh.rank + 1) * per]
    return out
