"""PyTorch port, `parallel/` and `shard_arrays_for_process` in one process:
the corpus shards and the partition rules against the JAX package's, the
fast layout's rule against `split_fast` of the canonical one, the mesh's
refusals (a size other than the world's, a model axis that does not
divide 3H, no process group), and, on a process group
of one gloo rank made here, the mesh, the collectives at world size 1 and
a mesh `Trainer` bit-equal to the one without a mesh. Two ranks are held
in tests/test_torch_data_parallel.py, the model axis over several ranks in
tests/test_torch_tensor_parallel.py."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from music_fader_nets_tpu.data.loader import (
    shard_arrays_for_process as j_shard,
)
from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import gmvae as j_gmvae
from music_fader_nets_tpu.models import vae as j_vae
from music_fader_nets_tpu.parallel import mesh as j_mesh
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.loader import shard_arrays_for_process
from music_fader_nets_tpu_torch.models import fast as fast_lib
from music_fader_nets_tpu_torch.models import gmvae, vae
from music_fader_nets_tpu_torch.parallel import collectives, launch
from music_fader_nets_tpu_torch.parallel import mesh as mesh_lib
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.trainer import FROZEN_TABLES, Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)


def _arrays(n):
    rng = np.random.default_rng(n)
    return {"x": rng.integers(0, 342, (n, 8)).astype(np.int32),
            "c": rng.random((n, 24)).astype(np.float32)}


@pytest.mark.parametrize("n,pi,pc", [(10, 0, 2), (10, 1, 2), (11, 1, 2),
                                     (11, 2, 3), (7, 0, 1), (5, 4, 5)])
def test_shard_arrays_for_process_matches_jax(n, pi, pc):
    """Contiguous equal shards, the remainder dropped on every process."""
    arrays = _arrays(n)
    got, want = (f(arrays, pi, pc) for f in (shard_arrays_for_process,
                                             j_shard))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(got[k]) == n // pc


def test_shard_arrays_for_process_refuses_empty_shards_and_defaults():
    with pytest.raises(ValueError, match="cannot be sharded"):
        j_shard(_arrays(3), 0, 4)
    with pytest.raises(ValueError, match="cannot be sharded"):
        shard_arrays_for_process(_arrays(3), 0, 4)
    # one process, no process group: unchanged, as JAX with one process
    arrays = _arrays(9)
    assert not dist.is_initialized()
    assert shard_arrays_for_process(arrays) is arrays
    assert j_shard(arrays) is arrays


@pytest.mark.parametrize("family", ["gmm", "vanilla", "cvae"])
def test_param_pspecs_match_jax(family):
    """The model-axis layout rules (kept for tensor parallelism) give each
    leaf the JAX PartitionSpec, read as a tuple."""
    init = {"gmm": j_gmvae.init_reg_gmvae, "vanilla": j_vae.init_reg_vae,
            "cvae": j_vae.init_cvae}[family]
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                      JConfig(**SMALL)))
    want = jax.tree_util.tree_leaves_with_path(
        j_mesh.param_pspecs(p), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    got = mesh_lib.param_pspecs(params_from_numpy(p))

    def at(tree, path):
        for k in path:
            tree = tree[k.key]
        return tree

    assert len(want) == sum(1 for _ in _leaves(got))
    assert any(spec != () for _, spec in _leaves(got))
    for path, spec in want:
        assert at(got, path) == tuple(spec), path


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", ["world_mismatch", "model_axis_vs_3H",
                                  "no_process_group"])
def test_make_mesh_refusals(case, tmp_path, monkeypatch):
    """A mesh whose size is not the world's, a model axis that does not
    divide 3H (refused where the `Trainer` slices its leaves), a mesh
    without a process group."""
    if case == "no_process_group":
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="process group"):
            mesh_lib.make_mesh(1, 2, devices="cpu")
        return
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        if case == "world_mismatch":
            for n_data, n_model in ((2, 2), (1, 2), (1, 8)):
                with pytest.raises(ValueError, match="does not match"):
                    mesh_lib.make_mesh(n_data, n_model, devices="cpu")
        else:
            # 3H = 96 at H=32: a model axis of 5 leaves a remainder
            fast = fast_lib.split_fast(gmvae.init_reg_gmvae(
                torch.Generator().manual_seed(0), ModelConfig(**SMALL)))[0]
            with pytest.raises(ValueError, match="does not divide"):
                mesh_lib.model_shard(fast, mesh_lib.fast_pspecs(fast), 5, 0)
    finally:
        dist.destroy_process_group()


FAMILIES = {"gmm": (j_gmvae.init_reg_gmvae, gmvae.init_reg_gmvae),
            "single_gmvae": (j_gmvae.init_single_gmvae,
                             gmvae.init_single_gmvae),
            "vanilla": (j_vae.init_reg_vae, vae.init_reg_vae),
            "cvae": (j_vae.init_cvae, vae.init_cvae),
            "fader": (j_vae.init_fader, vae.init_fader),
            "singlevae": (j_vae.init_single_vae, vae.init_single_vae)}


_GRU_GROUPS = ("enc_rn", "enc_1", "enc_e", "sub_rn", "grucell_g",
               "grucell_g_2")


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fast_pspecs_commute_with_split_fast(family, n_model):
    """For each model index, `split_fast` of the canonical tree sliced by
    `param_pspecs` (each spec the JAX package's) equals the fast tree
    sliced by `fast_pspecs`, leaf by leaf. The leaves sharded are the GRU
    groups', each along 3H; the frozen tables and the layers `split_fast`
    sets aside are never sliced."""
    j_init, _ = FAMILIES[family]
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                        JConfig(**SMALL)))
    canonical = params_from_numpy(p)
    specs = mesh_lib.param_pspecs(canonical)
    want_specs = jax.tree_util.tree_leaves_with_path(
        j_mesh.param_pspecs(p), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    for path, spec in want_specs:
        leaf = specs
        for k in path:
            leaf = leaf[k.key]
        assert leaf == tuple(spec), path
    fast, frozen = fast_lib.split_fast(canonical)
    fast_specs = mesh_lib.fast_pspecs(fast)
    sharded = {path for path, spec in _leaves(fast_specs) if spec}
    shapes = {path: t.shape for path, t in _leaves(fast)}
    assert sharded and all(path[0] in _GRU_GROUPS for path in sharded)
    assert all(shapes[path][-1] == 3 * SMALL["hidden_dims"]
               for path in sharded)
    assert not any(path[0] in FROZEN_TABLES for path in sharded)
    assert not set(frozen) & set(fast)
    for index in range(n_model):
        got = dict(_leaves(fast_lib.split_fast(mesh_lib.model_shard(
            canonical, specs, n_model, index))[0]))
        want = dict(_leaves(mesh_lib.model_shard(fast, fast_specs, n_model,
                                                 index)))
        assert set(got) == set(want)
        for path in want:
            assert torch.equal(got[path], want[path]), (path, index)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(1, 1, devices="cpu")


@pytest.fixture
def world1(tmp_path, monkeypatch):
    """A default process group of one gloo rank in this process, torn down
    after the test."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_mesh(devices="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_rank(world1):
    mesh = world1
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.axis_names == ("data", "model") == (j_mesh.DATA_AXIS,
                                                    j_mesh.MODEL_AXIS)
    assert mesh.device == torch.device("cpu") and mesh.n_data == 1
    with pytest.raises(ValueError, match="does not match"):
        mesh_lib.make_mesh(2, 1, devices="cpu")
    assert mesh_lib.batch_sharding(mesh).spec == ("data",)
    assert mesh_lib.replicated(mesh).spec == ()
    batch = _arrays(6)
    np.testing.assert_array_equal(mesh_lib.shard_batch(batch, mesh)["x"],
                                  batch["x"])
    shards = mesh_lib.param_shardings({"g": {"w_hh": torch.ones(2, 6)}},
                                      mesh)
    assert shards["g"]["w_hh"] == (mesh, (None, "model"))
    # a rank of its own: the default process group's rank
    assert shard_arrays_for_process(batch) is batch


def test_collectives_of_one_rank(world1):
    """At world size 1 the gather is the identity, value and gradient, and
    the mean all-reduce and the broadcast leave every tensor as it was."""
    mesh = world1
    x = torch.randn(5, 3, requires_grad=True)
    y = collectives.gather_rows(x, mesh)
    assert torch.equal(y, x.detach())
    w = torch.randn(5, 3)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)
    ts = [torch.randn(4), torch.randn(2, 3), torch.arange(3.0).double()]
    before = [t.clone() for t in ts]
    collectives.all_reduce_mean_(ts, mesh)
    collectives.broadcast_(ts)
    for a, b in zip(ts, before):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_trace_mesh_scope_nests_and_resets(world1):
    assert mesh_lib.current_trace_mesh() is None
    with mesh_lib.trace_mesh_scope(world1):
        assert mesh_lib.current_trace_mesh() is world1
        with mesh_lib.trace_mesh_scope(None):
            assert mesh_lib.current_trace_mesh() is None
        assert mesh_lib.current_trace_mesh() is world1
    assert mesh_lib.current_trace_mesh() is None


def test_mesh_trainer_of_one_rank_is_bit_equal(world1):
    """A GM-VAE Trainer on a 1 x 1 mesh takes the same steps as the
    Trainer without one (three of each branch, then an evaluation pass),
    bit for bit (an all-reduce of one rank, a gather of one rank), with
    the same metrics."""
    import functools
    losses = {"default": objectives.gmm_loss,
              "supervised": functools.partial(objectives.gmm_loss,
                                              is_supervised=True)}
    cfg = ModelConfig(**SMALL, batch_size=4)
    rng = np.random.default_rng(3)
    n = 12
    arrays = {"x": rng.integers(0, 342, (n, 8)).astype(np.int32),
              "r": rng.integers(0, 3, (n, 4)).astype(np.int32),
              "n": rng.integers(0, 16, (n, 4)).astype(np.int32),
              "c": rng.random((n, 24)).astype(np.float32),
              "r_density": rng.random(n).astype(np.float32),
              "n_density": rng.random(n).astype(np.float32),
              "a": rng.integers(0, 2, n).astype(np.int32)}
    runs = []
    for mesh in (None, world1):
        tr = Trainer(cfg, gmvae.init_reg_gmvae, losses, seed=0,
                     device="cpu", mesh=mesh)
        m = [tr.run_epoch(arrays, v, seed=1) for v in losses]
        m.append(tr.run_epoch(arrays, train=False, shuffle=False))
        runs.append((m, dict(_leaves(params_to_numpy(tr.params))), tr.step))
    (m0, p0, s0), (m1, p1, s1) = runs
    assert m0 == m1 and s0 == s1 == 6
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=str(k))


def test_init_from_env_without_torchrun(monkeypatch):
    """Without the torchrun environment, --mesh 1x1 joins a world of one
    in this process, over gloo on the CPU; with no card, the default
    (CUDA) device raises before any group is made."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert launch.placement("cpu") == (torch.device("cpu"), "gloo")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init_from_env()
    assert not dist.is_initialized()
    try:
        assert launch.init_from_env("cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert mesh_lib.make_mesh(1, 1, devices="cpu").rank == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("local,local_world,cards,device,want", [
    (0, 1, 1, None, ("cuda:0", "nccl")),        # a world of one
    (1, 4, 4, None, ("cuda:1", "nccl")),        # a card a rank
    (3, 4, 8, "cuda", ("cuda:3", "nccl")),
    (1, 2, 1, None, ("cuda:0", "gloo")),        # one card, shared
    (1, 2, 8, "cuda:0", ("cuda:0", "gloo")),    # the card named, shared
    (0, 1, 2, "cuda:1", ("cuda:1", "nccl")),
    (1, 4, 2, None, None),                      # cards left idle: raises
    (1, 2, 0, "cpu", ("cpu", "gloo")),
])
def test_placement(monkeypatch, local, local_world, cards, device, want):
    """One rule places a rank for `init_from_env`, `make_mesh` and
    `run_ranks`: its own card over NCCL when the host has one a rank, the
    shared card over gloo on a host of one card or when a card is named,
    and a refusal when cards would sit idle (card counts stubbed: the
    rule reads only `torch.cuda`'s count)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    if want is None:
        with pytest.raises(RuntimeError, match="2 cards"):
            launch.placement(device)
    else:
        assert launch.placement(device) == (torch.device(want[0]), want[1])
