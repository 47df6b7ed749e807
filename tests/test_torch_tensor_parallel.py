"""PyTorch port, tensor parallelism on `torch.distributed`: the `model` axis
of `parallel/` and the `Trainer` under it, at the small size of
tests/test_torch_data_parallel.py (H=32, z=8, T=8, attr_len=4), whose
helpers and bounds this module reuses.

Two module-scoped spawns (`parallel/launch.py::run_ranks`), on the CPU
over gloo:
- two ranks on a 1 x 2 mesh: three `Trainer` steps of the GM-VAE (both
  branches), vanilla and the CVAE, the first step's gradients taken apart,
  each against one process and bit-equal to it (the gather of the slices
  is exact, the clip reads the whole gradients, Adam is elementwise); the
  GM-VAE's first step in bf16, bit-equal to one process in bf16; the Adam
  state of each rank (3H / 2 columns of each sharded leaf); a state taken
  after two steps, continued one step on the mesh, in a fresh mesh Trainer
  that loads it, and in one process that loads it, all bit-equal; the
  training CLI with `--mesh 1x2` (one epoch and its checkpoint, then a
  resume);
- four ranks on a 2 x 2 mesh: the same objectives against one process at
  the bounds of data parallelism (two data ranks sum a gradient's rows in
  another order), the params bit-equal across the four ranks, the Adam
  state (3H / 2 columns), the state round trip on the mesh, and one step
  of `vanilla_loss` and `gmm_loss` from the JAX package's params and
  draws against the JAX Trainer on `make_mesh(2, 2)` (the conftest's 8
  CPU devices): loss rtol 2e-5, params atol 2e-5.

Then `dryrun_multichip(4)` on the CPU: its 2 x 2 and 4 x 1 meshes.
"""
import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import gmvae
from music_fader_nets_tpu_torch.parallel.launch import run_ranks
from music_fader_nets_tpu_torch.parallel.mesh import make_mesh, shard_batch
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import params_to_numpy

from test_torch_data_parallel import (
    B, GRAD_REL, NOISE_ONLY, SMALL, STEPS, _assert_params, _jax_inputs,
    _leaves, _rows, corpus, jax_step, objective_steps,
)

TP_OBJECTIVES = ("gmm", "gmm_supervised", "vanilla", "cvae")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
H3 = 3 * SMALL["hidden_dims"]
GMM = {"default": objectives.gmm_loss,
       "supervised": functools.partial(objectives.gmm_loss,
                                       is_supervised=True)}


def _params(tr) -> dict:
    return dict(_leaves(params_to_numpy(tr.params)))


def bf16_first_step(mesh) -> dict:
    """The GM-VAE's first step in bf16: its gradients and metrics."""
    tr = Trainer(ModelConfig(**SMALL, batch_size=B, dtype="bfloat16"),
                 gmvae.init_reg_gmvae, GMM, seed=0, device="cpu", mesh=mesh)
    batch = corpus(B, 1)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    loss_fn = GMM["default"]
    metrics = tr.compute_gradients(
        loss_fn, tr._batch(batch),
        tr._rank_noise(tr.noise_fn(0, B, loss_fn), len(batch["x"])))
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": {p: t.grad.numpy().copy()
                      for p, t in _leaves(tr.fast_params)
                      if t.grad is not None}}


def _step(tr, batch, host_step):
    """One GM-VAE step of `tr` on the rank's rows of a global batch, with
    the draws of `host_step`."""
    loss_fn = GMM["default"]
    if tr.mesh is not None:
        batch = shard_batch(batch, tr.mesh)
    tr.train_step(loss_fn, tr._batch(batch),
                  tr._rank_noise(tr.noise_fn(host_step, B, loss_fn),
                                 len(batch["x"])))


def state_round_trip(mesh) -> dict:
    """Two GM-VAE steps, the state taken, one more step; a fresh Trainer
    on the same mesh loads the state and takes that step too. Also the
    shapes of each trainable leaf and of its Adam moments on this rank."""
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), gmvae.init_reg_gmvae,
                 GMM, seed=0, device="cpu", mesh=mesh)
    data = corpus(3 * B, 6)
    for i in range(2):
        _step(tr, _rows(data, i * B, (i + 1) * B), i)
    shapes = {}
    for path, t, s in zip(tr._trainable_paths, tr._trainable, tr._stepped):
        st = tr.optimizer.state[s]
        shapes[path] = (tuple(t.shape), tuple(st["exp_avg"].shape),
                        tuple(st["exp_avg_sq"].shape))
    adam_bytes = sum(v.numel() * v.element_size()
                     for st in tr.optimizer.state.values()
                     for k, v in st.items() if k != "step")
    state = tr.state
    last = _rows(data, 2 * B, 3 * B)
    _step(tr, last, 2)
    again = Trainer(ModelConfig(**SMALL, batch_size=B), gmvae.init_reg_gmvae,
                    GMM, seed=0, device="cpu", mesh=mesh)
    again.load_state(state)
    _step(again, last, 2)
    return {"state": state, "shapes": shapes, "adam_bytes": adam_bytes,
            "continued": _params(tr), "reloaded": _params(again)}


def cli_runs(save_dir: str) -> dict:
    """The training CLI's vanilla run on `--mesh 1x2 --device cpu`: one
    epoch, then `--epochs 2` (a resume)."""
    from music_fader_nets_tpu_torch.train import cli as train_cli
    cfg = os.path.join(save_dir, "cfg.json")
    argv = ["--mesh", "1x2", "--device", "cpu", "--config", cfg,
            "--synthetic-size", "48",
            "--save-dir", os.path.join(save_dir, "params"),
            "--log-dir", os.path.join(save_dir, "log"),
            "--data-dir", os.path.join(save_dir, "no_cache")]
    runs = []
    for epochs in ("1", "2"):
        tr = train_cli.run_training("vanilla", "t",
                                    argv=argv + ["--epochs", epochs])
        runs.append({"epoch": tr.epoch, "step": tr.step,
                     "mesh": (tr.mesh.n_data, tr.mesh.n_model),
                     "params": _params(tr)})
    return {"runs": runs}


def _tp_rank(n_data: int, n_model: int, jax_inputs, save_dir) -> dict:
    mesh = make_mesh(n_data, n_model, devices="cpu")
    out = {"index": (mesh.data_index, mesh.model_index),
           "objectives": {name: objective_steps(name, mesh)
                          for name in TP_OBJECTIVES},
           "round_trip": state_round_trip(mesh)}
    if n_data == 1:
        out["bf16"] = bf16_first_step(mesh)
    if jax_inputs is not None:
        out["jax"] = {name: jax_step(*jax_inputs[name], name, mesh)
                      for name in jax_inputs}
    if save_dir is not None:
        out["cli"] = cli_runs(save_dir)
    return out


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    """The two ranks of the 1 x 2 mesh (one spawn for the module)."""
    save_dir = str(tmp_path_factory.mktemp("tp_cli"))
    with open(os.path.join(save_dir, "cfg.json"), "w") as f:
        json.dump({**SMALL, "batch_size": 8}, f)
    t0 = time.monotonic()
    results = run_ranks(_tp_rank, 2, args=(1, 2, None, save_dir),
                        timeout=150.0)
    assert time.monotonic() - t0 < 150.0
    return results, save_dir


@pytest.fixture(scope="module")
def two_by_two():
    """The four ranks of the 2 x 2 mesh (one spawn for the module) and the
    JAX inputs they were given."""
    inputs = _jax_inputs()
    t0 = time.monotonic()
    results = run_ranks(_tp_rank, 4, args=(2, 2, inputs, None),
                        timeout=150.0)
    assert time.monotonic() - t0 < 150.0
    return results, inputs


@pytest.fixture(scope="module")
def one_process():
    """The single-process runs, at the ranks' one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: objective_steps(name, None) for name in TP_OBJECTIVES}
    finally:
        torch.set_num_threads(threads)


def _assert_equal_trees(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_ranks_sit_row_major(one_by_two, two_by_two):
    """World rank r at data index r // n_model, model index r % n_model."""
    assert [r["index"] for r in one_by_two[0]] == [(0, 0), (0, 1)]
    assert [r["index"] for r in two_by_two[0]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


@pytest.mark.parametrize("name", TP_OBJECTIVES)
def test_one_by_two_is_bit_equal_to_one_process(one_by_two, one_process,
                                                name):
    want = one_process[name]
    for r in one_by_two[0]:
        got = r["objectives"][name]
        _assert_equal_trees(got["grads"], want["grads"])
        assert got["metrics"] == want["metrics"]
        assert got["epoch"] == want["epoch"]
        assert got["step"] == want["step"]
        _assert_equal_trees(got["params"], want["params"])


@pytest.mark.parametrize("name", TP_OBJECTIVES)
def test_two_by_two_matches_one_process(two_by_two, one_process, name):
    """At tests/test_torch_data_parallel.py's bounds; every rank's
    gradients, metrics and params bit-equal to rank 0's."""
    results, _ = two_by_two
    want = one_process[name]
    mine = results[0]["objectives"][name]
    for k, g in want["grads"].items():
        bound = (1e-7 if k[-2:] in NOISE_ONLY
                 else GRAD_REL * np.abs(g).max())
        assert np.abs(mine["grads"][k] - g).max() <= bound, k
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(mine["metrics"][k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in want["epoch"].items():
        np.testing.assert_allclose(mine["epoch"][k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    _assert_params(mine["params"], want["params"], STEPS)
    for r in results[1:]:
        other = r["objectives"][name]
        _assert_equal_trees(other["grads"], mine["grads"])
        assert other["metrics"] == mine["metrics"]
        _assert_equal_trees(other["params"], mine["params"])


def test_bf16_first_step_one_by_two(one_by_two):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = bf16_first_step(None)
    finally:
        torch.set_num_threads(threads)
    for r in one_by_two[0]:
        assert r["bf16"]["metrics"] == want["metrics"]
        _assert_equal_trees(r["bf16"]["grads"], want["grads"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_adam_state_holds_only_the_slices(one_by_two, two_by_two, mesh):
    """Each rank's Adam moments: 3H / n_model columns of each leaf that
    `fast_pspecs` shards (every GRU leaf: the encoder's, the sub-decoders',
    the decoder cells'), the whole of every other trainable leaf."""
    results = (one_by_two if mesh == "1x2" else two_by_two)[0]
    n_model = MESHES[mesh][1]
    for r in results:
        shapes = r["round_trip"]["shapes"]
        sharded = 0
        for path, (leaf, mu, nu) in shapes.items():
            assert mu == nu, path
            if path[0] in ("enc_rn", "sub_rn", "grucell_g", "grucell_g_2"):
                assert leaf[-1] == H3, path
                assert mu == leaf[:-1] + (H3 // n_model,), path
                sharded += 1
            else:
                assert mu == leaf, path
        # enc_rn and sub_rn: 4 leaves each; grucell_g: 5; grucell_g_2: 4
        assert sharded == 17
        # float32 mu and nu of the slices, against one process's
        assert r["round_trip"]["adam_bytes"] == sum(
            2 * 4 * np.prod(mu) for _, mu, _ in shapes.values())
        assert r["round_trip"]["adam_bytes"] < sum(
            2 * 4 * np.prod(leaf) for leaf, _, _ in shapes.values())


def test_state_of_one_by_two_resumes_in_one_process(one_by_two):
    """A 1 x 2 state (gathered: the whole params and Adam moments) loads
    into one process, and both continue bit-equal for one step; a fresh
    mesh Trainer that loads it continues bit-equal too."""
    results, _ = one_by_two
    mine = results[0]["round_trip"]
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), gmvae.init_reg_gmvae,
                 GMM, seed=0, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr.load_state(mine["state"])
        _step(tr, _rows(corpus(3 * B, 6), 2 * B, 3 * B), 2)
    finally:
        torch.set_num_threads(threads)
    one = _params(tr)
    for r in results:
        _assert_equal_trees(r["round_trip"]["continued"], one)
        _assert_equal_trees(r["round_trip"]["reloaded"], one)
    full = dict(_leaves(mine["state"].opt_state["mu"]))
    assert full[("gru_r", "fwd", "w_hh")].shape[-1] == H3


def test_two_by_two_state_round_trip(two_by_two):
    results, _ = two_by_two
    first = results[0]["round_trip"]["continued"]
    for r in results:
        _assert_equal_trees(r["round_trip"]["continued"], first)
        _assert_equal_trees(r["round_trip"]["reloaded"], first)


@pytest.mark.parametrize("loss_name", ["vanilla_loss", "gmm_loss"])
def test_two_by_two_matches_jax_mesh_trainer(two_by_two, loss_name):
    """The JAX Trainer on `make_mesh(2, 2)`: GRU weights sharded over
    `model` by GSPMD (its Pallas kernels step aside under a model axis)."""
    import jax
    from music_fader_nets_tpu.config import ModelConfig as JConfig
    from music_fader_nets_tpu.parallel import mesh as j_mesh
    from music_fader_nets_tpu.train import objectives as j_obj
    from music_fader_nets_tpu.train.trainer import Trainer as JTrainer

    results, inputs = two_by_two
    params, _, batch = inputs[loss_name]
    mesh = j_mesh.make_mesh(2, 2)
    jtr = JTrainer(JConfig(**SMALL, batch_size=B), None,
                   {"default": getattr(j_obj, loss_name)}, mesh=mesh,
                   params=jax.tree.map(np.asarray, params))
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    state, metrics = jtr._train_steps["default"](
        jtr.state, j_mesh.shard_batch(batch, mesh), rng)
    want = dict(_leaves(jax.tree.map(np.asarray, jax.device_get(
        state.params))))
    for r in results:
        got = r["jax"][loss_name]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=2e-5)
        _assert_params(got["params"], want, 1)


def test_training_cli_one_by_two_checkpoints_and_resumes(one_by_two):
    """`run_training("vanilla")` with `--mesh 1x2 --device cpu`: one epoch,
    one checkpoint (rank 0's), the same params on both ranks; `--epochs 2`
    resumes after epoch 1 on both."""
    results, save_dir = one_by_two
    name = "music_attr_vae_reg_vanilla"
    params_dir = os.path.join(save_dir, "params")
    assert os.listdir(os.path.join(params_dir, name)) == ["state.pt"]
    assert sum(d.startswith(name + "_")
               for d in os.listdir(params_dir)) == 2
    rank0, rank1 = (r["cli"]["runs"] for r in results)
    steps = rank0[0]["step"]
    assert steps > 0
    for runs in (rank0, rank1):
        assert [run["mesh"] for run in runs] == [(1, 2), (1, 2)]
        assert [run["epoch"] for run in runs] == [1, 2]
        assert [run["step"] for run in runs] == [steps, 2 * steps]
    for a, b in zip(rank0, rank1):
        _assert_equal_trees(a["params"], b["params"])


def test_dryrun_multichip_four_ranks(capsys):
    from music_fader_nets_tpu_torch.entry import dryrun_multichip
    ranks = dryrun_multichip(4, device="cpu")
    assert [r["device"] for r in ranks] == ["cpu"] * 4
    assert [m["mesh"] for m in ranks[0]["meshes"]] == [
        {"data": 2, "model": 2}, {"data": 4, "model": 1}]
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'data': 2, 'model': 2}" in out
    assert "dryrun_multichip ok: mesh={'data': 4, 'model': 1}" in out
