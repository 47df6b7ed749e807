"""PyTorch port, data parallelism on `torch.distributed`: two gloo ranks on
the CPU at 4 rows each against one process at 8 rows, and against the JAX
package's mesh `Trainer` (`make_mesh(2, 1)` on the conftest's 8 CPU
devices), at a small size (H=32, z=8, T=8, attr_len=4).

One module-scoped spawn of two ranks (`parallel/launch.py::run_ranks`)
runs, on a 2 x 1 mesh:
- three `Trainer` steps of each of the six objectives (the GM-VAE both
  branches; GLSR from step 21, where its regularizer counts, the others
  from 1000, inside the KL and adversarial ramps) on a global batch of 8,
  each rank feeding its 4 rows; the first step's gradients are taken
  apart (`compute_gradients`). Against the port's single-process
  `Trainer` at B=8 on the same batches and noise: the first step's
  all-reduced gradients within 2e-6 of each tensor's largest entry
  (`GRAD_REL`), the
  losses and epoch metrics to rtol=2e-5, the params after three steps to
  atol=2e-5 (the bounds of tests/test_sharding.py:42-48), and the params
  bit-equal across the ranks. The sub-decoders' output biases have a true
  gradient of exactly 0 (their log-softmax runs over the time axis): their
  gradients are float32 noise of ~1e-8, held to 1e-7, and Adam moves them
  by up to lr a step in either direction, so their params are held to
  2 * lr a step (tests/test_torch_train_trainer.py);
- one step of `vanilla_loss` and of `gmm_loss` from the JAX package's
  params and draws, against the JAX mesh Trainer on its Pallas path (the
  `_dp` shard_map wrappers, interpret mode): loss rtol 2e-5, params atol
  2e-5;
- a training epoch and an evaluation epoch on shards from
  `shard_arrays_for_process`, against one process on the corpus in the
  order the ranks' batches assemble it (tests/test_sharding.py:125-138);
- `_local_batch_size` at two ranks.

Then the training CLI over two ranks (one epoch, one checkpoint, then a
resume on both ranks), `dryrun_multichip(2)` (its 1 x 2 and 2 x 1
meshes), and the launcher's handling
of a failed and of a hung rank. The rank functions live here, in a module
that imports no JAX, so the spawned ranks import torch and the port only.
"""
import functools
import os
import time

import numpy as np
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.loader import shard_arrays_for_process
from music_fader_nets_tpu_torch.models import gmvae, vae
from music_fader_nets_tpu_torch.parallel.launch import run_ranks
from music_fader_nets_tpu_torch.parallel.mesh import make_mesh, shard_batch
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

RANKS, B, LR, STEPS = 2, 8, 1e-3, 3
SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
NOISE_ONLY = {("linear_out_r", "b"), ("linear_out_n", "b")}
# a gradient sums the batch's rows, 8 at once in one process and 4 + 4 over
# two ranks, and float32 rounds the two orders apart: 2.7e-7 of the
# tensor's largest entry at most, but 1.2e-6 / 1.35e-6 on the latent means'
# biases (`mu_r.b` of vanilla, `mu.b` of SingleVAE), whose row terms carry
# the Pati term and cancel. The readings are the same with the one-process
# reference at 1, 2, 4 and 8 threads; it runs at 1, as the ranks do.
GRAD_REL = 2e-6
GMM = {"default": objectives.gmm_loss,
       "supervised": functools.partial(objectives.gmm_loss,
                                       is_supervised=True)}
# name: (init, loss bundle, variant, first step)
OBJECTIVES = {
    "vanilla": (vae.init_reg_vae, {"default": objectives.vanilla_loss},
                "default", 1000),
    "glsr": (vae.init_reg_vae, {"default": objectives.glsr_loss},
             "default", 21),
    "cvae": (vae.init_cvae, {"default": objectives.cvae_loss}, "default",
             1000),
    "fader": (vae.init_fader, {"default": objectives.fader_loss},
              "default", 1000),
    "singlevae": (vae.init_single_vae,
                  {"default": objectives.singlevae_loss}, "default", 1000),
    "gmm": (gmvae.init_reg_gmvae, GMM, "default", 1000),
    "gmm_supervised": (gmvae.init_reg_gmvae, GMM, "supervised", 1000),
}


def corpus(n: int, seed: int) -> dict:
    """In-schema arrays from numpy: tokens in [0, 342), rhythm ids in
    [0, 3), note ids in [0, 16), chroma, densities, arousal labels."""
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    r = rng.integers(0, 3, (n, A)).astype(np.int32)
    nt = rng.integers(0, 16, (n, A)).astype(np.int32)
    return {"x": rng.integers(0, 342, (n, T)).astype(np.int32), "r": r,
            "n": nt, "c": rng.random((n, 24)).astype(np.float32),
            "r_density": (r == 1).mean(-1).astype(np.float32),
            "n_density": (nt / 16.0).mean(-1).astype(np.float32),
            "a": rng.integers(0, 2, n).astype(np.int32)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rows(arrays, lo, hi):
    return {k: v[lo:hi] for k, v in arrays.items()}


def _local(global_arrays, mesh):
    """A rank's rows of each consecutive global batch of B, in order."""
    if mesh is None:
        return global_arrays
    parts = [shard_batch(_rows(global_arrays, i, i + B), mesh)
             for i in range(0, len(global_arrays["x"]), B)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def objective_steps(name: str, mesh) -> dict:
    """The first step's gradients and metrics, then three steps (an epoch
    of three global batches of B, unshuffled) of one objective, on `mesh`
    or in one process."""
    init, losses, variant, first = OBJECTIVES[name]
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), init, losses, seed=0,
                 device="cpu", mesh=mesh)
    tr.step = first
    arrays = _local(corpus(STEPS * B, 1), mesh)
    rows = len(arrays["x"]) // STEPS
    loss_fn = losses[variant]
    metrics = tr.compute_gradients(
        loss_fn, tr._batch(_rows(arrays, 0, rows)),
        tr._rank_noise(tr.noise_fn(0, B, loss_fn), rows))
    grads = {p: t.grad.numpy().copy() for p, t in _leaves(tr.fast_params)
             if t.grad is not None}
    epoch = tr.run_epoch(arrays, variant, shuffle=False, batch_size=B)
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": grads, "epoch": epoch, "step": tr.step,
            "params": dict(_leaves(params_to_numpy(tr.params)))}


def jax_step(params, draws, batch, loss_name: str, mesh) -> dict:
    """One step of `loss_name` from the given canonical params, with the
    given draws for the global batch of B (numpy)."""
    losses = {"default": getattr(objectives, loss_name)}
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), None, losses,
                 params=params_from_numpy(params), device="cpu", mesh=mesh,
                 noise_fn=lambda *a, **k: tuple(torch.from_numpy(d)
                                                for d in draws))
    m = tr.run_epoch(_local(batch, mesh), shuffle=False, batch_size=B)
    return {"loss": m["loss"],
            "params": dict(_leaves(params_to_numpy(tr.params)))}


def shard_epochs(mesh) -> dict:
    """A training and an evaluation epoch of vanilla on the rank's shard of
    each split (`shard_arrays_for_process`), or on the whole of each split
    in the order the ranks' batches assemble it."""
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), vae.init_reg_vae,
                 {"default": objectives.vanilla_loss}, seed=0, device="cpu",
                 mesh=mesh)
    train, val = corpus(32, 4), corpus(12, 5)
    if mesh is None:
        train = {k: v[multihost_order(32, RANKS, B)] for k, v in
                 train.items()}
        val = {k: v[multihost_order(12, RANKS, B)] for k, v in val.items()}
    else:
        train, val = (shard_arrays_for_process(a) for a in (train, val))
    m_train = tr.run_epoch(train, shuffle=False)
    m_val = tr.run_epoch(val, train=False, shuffle=False)
    return {"train": m_train, "val": m_val, "step": tr.step,
            "params": dict(_leaves(params_to_numpy(tr.params)))}


def multihost_order(n, pc, bs):
    """tests/test_sharding.py's order: global batch b is process 0's rows
    b*bs/pc .. of its contiguous shard, then process 1's, ... (a
    batch of min(bs, n) rows when the shards are smaller than bs/pc)."""
    per = n // pc
    bsl = min(bs, per * pc) // pc
    order = []
    for b in range(per // bsl):
        for p in range(pc):
            order += list(range(p * per + b * bsl, p * per + (b + 1) * bsl))
    return np.asarray(order)


def _dp_rank(jax_inputs) -> dict:
    mesh = make_mesh(RANKS, 1, devices="cpu")
    out = {name: objective_steps(name, mesh) for name in OBJECTIVES}
    out["jax"] = {name: jax_step(*jax_inputs[name], name, mesh)
                  for name in jax_inputs}
    out["shards"] = shard_epochs(mesh)
    tr = Trainer(ModelConfig(**SMALL, batch_size=16), vae.init_reg_vae,
                 {"default": objectives.vanilla_loss}, mesh=mesh)
    out["local_bs"] = tr._local_batch_size(16)
    try:
        tr._local_batch_size(17)
        out["local_bs_odd"] = "no error"
    except ValueError as e:
        out["local_bs_odd"] = str(e)
    return out


def _jax_inputs():
    """The JAX package's params (PRNGKey 0) and draws for a global batch
    of B (fold_in(PRNGKey(0), 0) split into the two streams' normals,
    tests/test_torch_train_families.py) for vanilla and gmm, and a batch."""
    import jax
    from music_fader_nets_tpu.config import ModelConfig as JConfig
    from music_fader_nets_tpu.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu.models.vae import init_reg_vae
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    draws = tuple(np.array(jax.random.normal(k, (B, SMALL["z_dims"])))
                  for k in jax.random.split(rng))
    batch = _rows(corpus(B, 9), 0, B)
    return {name: (jax.tree.map(np.asarray,
                                init(jax.random.PRNGKey(0),
                                     JConfig(**SMALL))), draws, batch)
            for name, init in (("vanilla_loss", init_reg_vae),
                               ("gmm_loss", init_reg_gmvae))}


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results (one spawn for the module) and the JAX inputs
    they were given."""
    inputs = _jax_inputs()
    t0 = time.monotonic()
    results = run_ranks(_dp_rank, RANKS, args=(inputs,), timeout=120.0)
    assert time.monotonic() - t0 < 120.0
    return results, inputs


def _assert_params(got, want, steps, atol=2e-5):
    assert set(got) == set(want)
    for k in want:
        tol = 2 * LR * steps if k in NOISE_ONLY else atol
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=str(k))


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_two_ranks_match_one_process(ranks, name):
    results, _ = ranks
    mine, other = results[0][name], results[1][name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the ranks' count, so their BLAS sum order
    try:
        want = objective_steps(name, None)
    finally:
        torch.set_num_threads(threads)
    # the first step's all-reduced gradients
    assert set(mine["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        scale = np.abs(g).max()
        bound = 1e-7 if k[-2:] in NOISE_ONLY else GRAD_REL * scale
        assert np.abs(mine["grads"][k] - g).max() <= bound, (
            k, np.abs(mine["grads"][k] - g).max(), scale)
        np.testing.assert_array_equal(mine["grads"][k], other["grads"][k])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(mine["metrics"][k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
        assert mine["metrics"][k] == other["metrics"][k], k
    for k, v in want["epoch"].items():
        np.testing.assert_allclose(mine["epoch"][k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    assert mine["step"] == want["step"] == OBJECTIVES[name][3] + STEPS
    _assert_params(mine["params"], want["params"], STEPS)
    for k, p in mine["params"].items():
        np.testing.assert_array_equal(p, other["params"][k], err_msg=str(k))


@pytest.mark.parametrize("loss_name", ["vanilla_loss", "gmm_loss"])
def test_two_ranks_match_jax_mesh_trainer(ranks, loss_name, monkeypatch):
    """The JAX Trainer on `make_mesh(2, 1)` with its Pallas training
    kernels (interpret mode), so its batch rows go through the `_dp`
    shard_map wrappers, and GSPMD reduces the rest."""
    import jax
    from jax.experimental import pallas as pl
    from music_fader_nets_tpu.config import ModelConfig as JConfig
    from music_fader_nets_tpu.ops import pallas_gru
    from music_fader_nets_tpu.parallel import mesh as j_mesh
    from music_fader_nets_tpu.train import objectives as j_obj
    from music_fader_nets_tpu.train.trainer import Trainer as JTrainer

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    results, inputs = ranks
    params, _, batch = inputs[loss_name]
    mesh = j_mesh.make_mesh(2, 1)
    jtr = JTrainer(JConfig(**SMALL, batch_size=B, use_pallas_gru=True),
                   None, {"default": getattr(j_obj, loss_name)}, mesh=mesh,
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


def test_epoch_on_process_shards(ranks):
    """`shard_arrays_for_process` shards: a training epoch on 32 items
    (four steps of 4 rows a rank) and an evaluation epoch of one 8-row
    batch on 12 items (6 a rank, 2 left out of the batch), against the
    one-process run over the same global batches."""
    results, _ = ranks
    want = shard_epochs(None)
    for r in results:
        got = r["shards"]
        assert got["step"] == want["step"] == 4
        for split in ("train", "val"):
            np.testing.assert_allclose(got[split]["loss"],
                                       want[split]["loss"], rtol=2e-5)
        _assert_params(got["params"], want["params"], 4)


def test_local_batch_size(ranks):
    """The counterpart of tests/test_aux.py:155-171: one process feeds the
    whole batch; each of two ranks bs // 2; an odd global batch raises."""
    results, _ = ranks
    tr = Trainer(ModelConfig(**SMALL, batch_size=16), vae.init_reg_vae,
                 {"default": objectives.vanilla_loss}, device="cpu")
    assert tr._local_batch_size(16) == 16 and tr._local_batch_size(17) == 17
    for r in results:
        assert r["local_bs"] == 8
        assert "not divisible" in r["local_bs_odd"]


def _cli_rank(argv) -> dict:
    from music_fader_nets_tpu_torch.train import cli as train_cli
    tr = train_cli.run_training("vanilla", "t", argv=argv)
    return {"epoch": tr.epoch, "step": tr.step, "host_step": tr._host_step,
            "world": tr.mesh.n_data,
            "params": dict(_leaves(params_to_numpy(tr.params)))}


def test_training_cli_two_ranks_checkpoint_and_resume(tmp_path):
    """`run_training("vanilla")` with `--mesh 2x1 --device cpu`: one epoch
    on each rank's shard, one checkpoint (rank 0's), params equal on both
    ranks; `--epochs 2` resumes after epoch 1 on both ranks."""
    import json
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**SMALL, "batch_size": 8}))
    argv = ["--mesh", "2x1", "--device", "cpu", "--config", str(cfg),
            "--synthetic-size", "48", "--save-dir", str(tmp_path / "params"),
            "--log-dir", str(tmp_path / "log"), "--data-dir",
            str(tmp_path / "no_cache")]
    first = run_ranks(_cli_rank, RANKS, args=(argv + ["--epochs", "1"],))
    name = "music_attr_vae_reg_vanilla"
    saved = sorted(os.listdir(tmp_path / "params"))
    assert len(saved) == 2 and saved[0] == name
    assert saved[1].startswith(name + "_")
    assert os.listdir(tmp_path / "params" / name) == ["state.pt"]
    assert os.listdir(tmp_path / "log") == [name + ".jsonl"]
    assert [r["world"] for r in first] == [2, 2]
    assert first[0]["epoch"] == first[1]["epoch"] == 1
    steps = first[0]["step"]
    assert steps > 0 and first[1]["step"] == steps
    for k, p in first[0]["params"].items():
        np.testing.assert_array_equal(p, first[1]["params"][k])
    again = run_ranks(_cli_rank, RANKS, args=(argv + ["--epochs", "2"],))
    for r in again:
        assert r["epoch"] == 2 and r["step"] == 2 * steps
    for k, p in again[0]["params"].items():
        np.testing.assert_array_equal(p, again[1]["params"][k])


def test_dryrun_multichip(capsys):
    from music_fader_nets_tpu_torch.entry import dryrun_multichip
    ranks = dryrun_multichip(2, device="cpu")
    assert [r["device"] for r in ranks] == ["cpu", "cpu"]
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'data': 2, 'model': 1}" in out
    assert "dryrun_multichip ok: mesh={'data': 1, 'model': 2}" in out
    assert [m["mesh"] for m in ranks[0]["meshes"]] == [
        {"data": 1, "model": 2}, {"data": 2, "model": 1}]


def _fail_on_rank1():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()         # rank 0 waits for rank 1 here


def _sleep():
    time.sleep(60)


def test_launcher_reports_a_failed_or_hung_rank():
    """A rank that raises fails the run with its traceback at once (its
    peer, blocked in a collective, is killed); ranks that outlive the
    timeout are killed and raise TimeoutError."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(_fail_on_rank1, RANKS, timeout=60.0)
    assert time.monotonic() - t0 < 45.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(_sleep, RANKS, timeout=5.0)
    assert time.monotonic() - t0 < 30.0
