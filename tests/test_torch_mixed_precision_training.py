"""PyTorch port, bf16 mixed precision in training, on the CPU at a small
size: the counterpart of the JAX package's bf16 `Trainer` test
(tests/test_train.py:183-193) with its save -> restore round trip, the
training CLI with `--dtype bfloat16` (an epoch with its validation pass,
the GM-VAE on the dual corpus) and the serving CLI on a bf16 config, and
two gloo ranks in bf16 against one process in bf16, as
tests/test_torch_data_parallel.py holds float32.

Master params, gradients, the Adam state and checkpoints stay float32:
only the forward inside each objective runs in bf16. Bounds of the two
ranks against one process: in bf16 a rank sums its 4 rows' bias and
weight gradients in bf16 where one process sums 8, so the first step's
all-reduced gradients differ by bf16 roundings, not float32 ones: within
GRAD_REL (the bound of tests/test_torch_mixed_precision_objectives.py) of
each tensor's largest entry; the losses to rtol=1e-3; the ranks' params
bit-equal to each other."""
import contextlib
import functools
import io
import json

import numpy as np
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
from music_fader_nets_tpu_torch.data.synthetic import synth_vgmidi_ragged
from music_fader_nets_tpu_torch.models import gmvae, vae
from music_fader_nets_tpu_torch.parallel.launch import run_ranks
from music_fader_nets_tpu_torch.parallel.mesh import make_mesh, shard_batch
from music_fader_nets_tpu_torch.serve import cli as serve_cli
from music_fader_nets_tpu_torch.train import cli as train_cli
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.profile import random_corpus
from music_fader_nets_tpu_torch.train.trainer import Trainer, TrainState
from music_fader_nets_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
GRAD_REL = 4e-2
RANKS, B = 2, 8
GMM = {"default": objectives.gmm_loss,
       "supervised": functools.partial(objectives.gmm_loss,
                                       is_supervised=True)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _state_leaves(state):
    out = {("step",): torch.tensor(state.step),
           ("count",): torch.as_tensor(state.opt_state["count"])}
    for part, tree in (("params", state.params),
                       ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
        out.update({(part,) + k: v for k, v in _leaves(tree)})
    return out


def _vanilla(dtype, n=80):
    """A vanilla RegVAE Trainer at the JAX test's widths and n random
    in-schema segments (80% of them the train split)."""
    cfg = ModelConfig(hidden_dims=32, z_dims=8, batch_size=8, seq_len=40,
                      attr_len=8, dtype=dtype)
    tr = Trainer(cfg, vae.init_reg_vae,
                 {"default": objectives.vanilla_loss}, seed=0,
                 device="cpu")
    arrays = YamahaDataset(*random_corpus(cfg, n, 3),
                           mode="train").arrays()
    return tr, arrays


def test_bf16_trainer_two_epochs_and_checkpoint(tmp_path):
    """Two bf16 epochs (the JAX package's recipe): the loss finite and
    falling, params and the Adam moments float32; the checkpoint has the
    float32 format, leaf for leaf, and restores bit-exact; 3 steps + save
    + restore + 3 steps equal 6 straight steps."""
    tr, arrays = _vanilla("bfloat16")
    m1 = tr.run_epoch(arrays, seed=1)
    m2 = tr.run_epoch(arrays, seed=2)
    assert np.isfinite(m1["loss"]) and m2["loss"] < m1["loss"]
    state = tr.state
    assert all(v.dtype == torch.float32 for k, v in
               _state_leaves(state).items() if k[0] in ("params", "mu",
                                                         "nu"))
    ckpt.save_checkpoint(str(tmp_path / "bf16"), state)
    f32, _ = _vanilla("float32", n=10)
    ckpt.save_checkpoint(str(tmp_path / "f32"), f32.state)
    a = ckpt.restore_checkpoint(str(tmp_path / "bf16"))
    b = ckpt.restore_checkpoint(str(tmp_path / "f32"))
    assert a["layout"] == b["layout"] == "full"
    back = TrainState(a["params"], a["opt_state"], a["step"])
    got, want = _state_leaves(back), _state_leaves(state)
    fmt = _state_leaves(TrainState(b["params"], b["opt_state"], b["step"]))
    assert set(got) == set(want) == set(fmt)
    for k in want:
        assert got[k].dtype == fmt[k].dtype and got[k].shape == fmt[k].shape
        assert torch.equal(got[k], want[k]), k

    straight, arrays = _vanilla("bfloat16", n=30)        # 3 batches
    straight.run_epoch(arrays, seed=1)
    straight.run_epoch(arrays, seed=2)
    first, _ = _vanilla("bfloat16", n=30)
    first.run_epoch(arrays, seed=1)
    ckpt.save_checkpoint(str(tmp_path / "half"), first.state)
    h = ckpt.restore_checkpoint(str(tmp_path / "half"))
    second, _ = _vanilla("bfloat16", n=30)
    second.load_state(TrainState(h["params"], h["opt_state"], h["step"]))
    second.run_epoch(arrays, seed=2)
    assert second._host_step == straight._host_step
    got, want = _state_leaves(second.state), _state_leaves(straight.state)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def vgmidi_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vgmidi")
    for name, arr in zip(("song_tokens", "rhythm_lst", "note_lst",
                          "arousal_lst", "valence_lst", "chroma_lst"),
                         synth_vgmidi_ragged(48, 60, 8)):
        np.save(d / f"{name}.npy", arr)
    return d


def _run(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def test_train_cli_bf16_epoch_validation_and_serving(tmp_path, vgmidi_dir):
    """`train.cli gmm --dtype bfloat16` for one epoch on the dual corpus
    with its validation passes (kernel 3's finals in bf16 and the greedy
    loop): finite losses, a float32 checkpoint; then the server on the
    same bf16 config serves in float32, as the JAX server ignores the
    compute dtype."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**SMALL, "num_clusters": 2, "batch_size": 8,
                               "dtype": "bfloat16"}))
    common = ["--device", "cpu", "--config", str(cfg), "--synthetic-size",
              "48", "--vgmidi-dir", str(vgmidi_dir), "--save-dir",
              str(tmp_path / "params"), "--log-dir", str(tmp_path / "log"),
              "--data-dir", str(tmp_path / "no_cache")]
    tr, out = _run(train_cli.run_training, "gmm", "t", dual_corpus=True,
                   argv=common + ["--epochs", "1", "--dtype", "bfloat16"])
    assert tr.cfg.dtype == "bfloat16" and tr.train_path == "plain-cpu"
    assert "[vgmidi test]" in out and "[test]" in out
    name = "music_attr_vae_reg_gmm"
    with open(tmp_path / "log" / f"{name}.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert {r["split"] for r in recs} >= {"yamaha_train", "yamaha_val"}
    assert all(np.isfinite(r["loss"]) for r in recs)
    saved = ckpt.restore_checkpoint(str(tmp_path / "params" / name))
    assert all(t.dtype == torch.float32
               for _, t in _leaves(saved["params"]))
    _, out = _run(serve_cli.run_server, common + [
        "--bench", "4", "--steps", "10", "--max-batch", "4"])
    bench = json.loads(out.strip().splitlines()[-1])
    assert bench["serving_path"] == "plain-cpu" and bench["requests"] == 4


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    r = rng.integers(0, 3, (n, A)).astype(np.int32)
    nt = rng.integers(0, 16, (n, A)).astype(np.int32)
    return {"x": rng.integers(0, 342, (n, T)).astype(np.int32), "r": r,
            "n": nt, "c": rng.random((n, 24)).astype(np.float32),
            "r_density": (r == 1).mean(-1).astype(np.float32),
            "n_density": (nt / 16.0).mean(-1).astype(np.float32),
            "a": rng.integers(0, 2, n).astype(np.int32)}


def _local(arrays, mesh):
    if mesh is None:
        return arrays
    parts = [shard_batch({k: v[i:i + B] for k, v in arrays.items()}, mesh)
             for i in range(0, len(arrays["x"]), B)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def gmm_bf16_steps(mesh) -> dict:
    """The GM-VAE's first bf16 step's gradients and metrics, then an epoch
    of three global batches of B, on `mesh` or in one process."""
    tr = Trainer(ModelConfig(**SMALL, batch_size=B, dtype="bfloat16"),
                 gmvae.init_reg_gmvae, GMM, seed=0, device="cpu", mesh=mesh)
    tr.step = 1000
    arrays = _local(_corpus(3 * B, 1), mesh)
    rows = len(arrays["x"]) // 3
    loss_fn = GMM["default"]
    metrics = tr.compute_gradients(
        loss_fn, tr._batch({k: v[:rows] for k, v in arrays.items()}),
        tr._rank_noise(tr.noise_fn(0, B, loss_fn), rows))
    grads = {p: t.grad.numpy().copy() for p, t in _leaves(tr.fast_params)
             if t.grad is not None}
    epoch = tr.run_epoch(arrays, shuffle=False, batch_size=B)
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": grads, "epoch": epoch,
            "params": {k: v.numpy() for k, v in _leaves(tr.params)},
            "dtypes": sorted({str(t.grad.dtype) for _, t in
                              _leaves(tr.fast_params)
                              if t.grad is not None})}


def _bf16_rank():
    return gmm_bf16_steps(make_mesh(RANKS, 1, devices="cpu"))


def test_bf16_two_ranks_match_one_process():
    """Two gloo ranks, 4 rows each, against one process at 8 rows, in
    bf16: first-step gradients (float32 at the masters) within GRAD_REL of
    each tensor's largest entry, metrics and epoch losses to rtol=1e-3,
    and the two ranks' params bit-equal."""
    mine, other = run_ranks(_bf16_rank, RANKS, timeout=120.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = gmm_bf16_steps(None)
    finally:
        torch.set_num_threads(threads)
    assert mine["dtypes"] == want["dtypes"] == ["torch.float32"]
    assert set(mine["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        err = np.abs(mine["grads"][k] - g).max()
        if k[-2:] in {("linear_out_r", "b"), ("linear_out_n", "b")}:
            assert err <= 1e-3, (k, err)
        else:
            assert err <= GRAD_REL * np.abs(g).max(), (k, err)
        np.testing.assert_array_equal(mine["grads"][k], other["grads"][k])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(mine["metrics"][k], v, rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    for k, v in want["epoch"].items():
        np.testing.assert_allclose(mine["epoch"][k], v, rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    for k, p in mine["params"].items():
        assert p.dtype == np.float32
        np.testing.assert_array_equal(p, other["params"][k], err_msg=str(k))
