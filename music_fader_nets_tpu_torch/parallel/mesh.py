"""The device mesh and its layout rules (counterpart of
`music_fader_nets_tpu/parallel/mesh.py`), on `torch.distributed`.

The reference is single-process single-GPU (SURVEY.md §2.2); the JAX
package introduces a `jax.sharding.Mesh` with a `data` axis (batch rows)
and a `model` axis (the GRU gate dimension), and GSPMD inserts the
collectives. Here one process drives one rank of the default
`torch.distributed` process group, so a `Mesh` is that rank's view: the
axis sizes, its rank, its place on each axis, its device and the process
groups of its two axes. `make_mesh(n_data, n_model)` puts world rank r at
data index r // n_model and model index r % n_model, the row-major order
of JAX's `devices.reshape(n_data, n_model)`.

Layout rules (the JAX package's):
  * batch tensors: first axis over `data` (`shard_batch` returns this
    rank's rows, by its data index);
  * GRU weights `w_ih` / `w_hh` `(I, 3H)` and their biases `(3H,)`: last
    axis over `model` (`param_pspecs`, on the canonical tree; specs are
    tuples that stand for `PartitionSpec`s);
  * everything else replicated (`shard_params` broadcasts it from rank 0).

The `Trainer` steps the fast layout (`models/fast.py::split_fast`), whose
leaves stack or split the canonical ones: `fast_pspecs` is the same rule
read through `split_fast` (a fast leaf is sharded on its last axis exactly
when `split_fast` builds it from canonical leaves that `param_pspecs`
shards), and `model_shard` takes a tree's slices at one model index.

With a mesh the `Trainer` splits each batch's rows over the data ranks,
sets the mesh as the trace mesh around its loss (`trace_mesh_scope`),
where the terms that couple a batch's rows (the Pati regulariser, GLSR's
faithful batch-0 read) gather what they read over the data group, and
all-reduces the gradients over the data group once a step. Under a model
axis each rank stores, and steps Adam on, only its slice of the sharded
leaves; before a forward the model group gathers the slices, and the
unchanged kernels run on the whole weights (`train/trainer.py`). At this
model's size pure data parallelism is the faster layout (the JAX package
says so too); tensor parallelism buys the Adam state it does not hold.
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
    its tensors live on. `data_group` holds the ranks of this rank's model
    index (the ones its gradients are averaged over), `model_group` those
    of its data index (the ones that share its rows and hold the other
    slices of its weights); None stands for the default group, which each
    of them is when the other axis is 1."""
    shape: Dict[str, int]
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


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
    defaults to world // n_model; ValueError otherwise). World rank r sits
    at data index r // n_model and model index r % n_model. With
    n_model > 1 every rank makes every group of both axes, in one order
    (the data groups, then the model groups), as `dist.new_group` needs;
    a mesh whose model axis does not divide a sharded leaf's last axis
    (3H) is refused when a `Trainer` takes it (`model_shard`). The rank's
    device is `launch.placement(devices)`: the CPU for devices="cpu", the
    card named ("cuda:0"), or by default the rank's own card (CUDA;
    RuntimeError without one)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not match the "
                         f"process group's {world} ranks")
    device = placement(devices)[0]
    groups = {}
    if n_model > 1:
        by_data = [list(range(j, world, n_model)) for j in range(n_model)]
        by_model = [list(range(i * n_model, (i + 1) * n_model))
                    for i in range(n_data)]
        for axis, members in (("data_group", by_data),
                              ("model_group", by_model)):
            for ranks in members:
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank, device,
                **groups)


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


# fast-layout leaves built from a canonical `w_ih`: the encoders' padded
# stacks and the decoder cell's split at the vocab boundary
_FROM_W_IH = ("w_ih_p", "w_tok_p", "w_z")
# fast groups that stack canonical GRU leaves on a new leading axis
_STACKED_GROUPS = ("enc_rn", "enc_1", "enc_e", "sub_rn")


def _fast_leaf_pspec(path: tuple, leaf) -> tuple:
    """`_leaf_pspec` read through `split_fast`: a stacked group's leaf has
    the rule of the canonical leaf it stacks, one axis up front; a leaf
    built from a canonical `w_ih` has `w_ih`'s."""
    name = path[-1] if path else ""
    canonical = path[:-1] + ("w_ih" if name in _FROM_W_IH else name,)
    if path and path[0] in _STACKED_GROUPS:
        spec = _leaf_pspec(canonical, leaf[0])
        return (None,) + spec if spec else ()
    return _leaf_pspec(canonical, leaf)


def fast_pspecs(fast):
    """Tree of partition specs (tuples) matching a fast-layout tree
    (`models/fast.py::split_fast`): the last axis over `model` exactly for
    the leaves built from canonical leaves that `param_pspecs` shards."""
    return _map_with_path(_fast_leaf_pspec, fast)


def model_slice(t: torch.Tensor, spec: tuple, n_model: int,
                model_index: int) -> torch.Tensor:
    """The `model_index`-th of `n_model` equal blocks of `t` along the
    axis that `spec` puts over `model` (a view; `t` itself when `spec`
    puts no axis there). ValueError when n_model does not divide that
    axis."""
    if MODEL_AXIS not in spec:
        return t
    axis = spec.index(MODEL_AXIS)
    size = t.shape[axis]
    if size % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide the "
                         f"sharded axis of {size} (3H)")
    w = size // n_model
    return t.narrow(axis, model_index * w, w)


def model_shard(tree, specs, n_model: int, model_index: int):
    """Each leaf of `tree` sliced by its spec in `specs` (a tree of the
    same structure) at one model index (`model_slice`)."""
    if isinstance(tree, dict):
        return {k: model_shard(v, specs[k], n_model, model_index)
                for k, v in tree.items()}
    return model_slice(tree, specs, n_model, model_index)


def param_shardings(params, mesh: Mesh):
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _leaf_pspec(path, leaf)),
        params)


def shard_params(params, mesh: Mesh):
    """Every rank's params made rank 0's (one broadcast of all leaves,
    whole, in place). Under a model axis the `Trainer` then keeps its own
    slices of the sharded leaves (`fast_pspecs`, `model_shard`). Returns
    `params`."""
    leaves = []
    _map_with_path(lambda _, t: leaves.append(t), params)
    broadcast_(leaves)
    return params


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a batch dict (numpy arrays or tensors, leading
    axis the global batch): the `data_index`-th of `n_data` equal blocks,
    the same on every rank of a model group. Raises ValueError when the
    rows do not divide evenly."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"batch of {n} rows not divisible over "
                             f"{mesh.n_data} data ranks")
        per = n // mesh.n_data
        out[k] = v[mesh.data_index * per: (mesh.data_index + 1) * per]
    return out
