"""PyTorch port, `Trainer.fit`, the step timers, the training CLI and the
entry points that load what it saves, on the CPU at a small size (H=32,
z=8, T=8, attr_len=4).

- `fit` against the JAX `fit`: two epochs with a train and a val split, the
  JAX side on its default compiled epoch, the port on the compiled noise
  schedule (`run_epoch(compiled=True)`) fed JAX's draws: per-epoch train
  and val metrics (their `MetricsLogger` records) to rtol=1e-4, params to
  atol=1e-5 (the sub-decoders' output biases to 2 * lr a step, see
  tests/test_torch_train_trainer.py), the host step equal.
  `compiled_step_time` leaves the live trainer bit-unchanged.
- End to end: `run_training("gmm", dual_corpus=True)` for 2 epochs on the
  synthetic corpus (`--synthetic-size 48`) and ragged VGMIDI arrays from
  `data/synthetic.py`, then `--epochs 3`, which resumes after epoch 2 and
  takes one more epoch's steps; then the eval CLI, the server (in-process,
  `--bench`) and the transfer CLI from the saved directory. `vanilla`
  through the module's `main` for 1 epoch.
- `MetricsLogger` writes the JAX logger's records (but the time);
  `StepTimer` gives the JAX timer's summary keys; `profiler_trace` writes
  a Chrome trace."""
import contextlib
import io
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.data import datasets as j_datasets
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.train.objectives import gmm_loss as j_gmm_loss
from music_fader_nets_tpu.train.trainer import Trainer as JTrainer
from music_fader_nets_tpu.utils.logging import MetricsLogger as JLogger
from music_fader_nets_tpu.utils.profiling import StepTimer as JTimer
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.synthetic import synth_vgmidi_ragged
from music_fader_nets_tpu_torch.eval import cli as eval_cli
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.serve import cli as serve_cli
from music_fader_nets_tpu_torch.tokenizer.midi_io import read_midi
from music_fader_nets_tpu_torch.train import cli as train_cli
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.transfer import cli as transfer_cli
from music_fader_nets_tpu_torch.utils.checkpoint import (
    named_leaves, params_from_numpy, params_to_numpy,
)
from music_fader_nets_tpu_torch.utils.logging import MetricsLogger
from music_fader_nets_tpu_torch.utils.profiling import (
    StepTimer, profiler_trace,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B, LR = 4, 1e-3
NOISE_ONLY = {("linear_out_r", "b"), ("linear_out_n", "b")}


def _compiled_jax_noise_fn(seed):
    """The JAX Trainer's draws: fold_in(PRNGKey(seed), host_step), and in
    a compiled epoch fold_in of that with the training step
    (trainer.py:148, :261), split into the two streams' keys."""
    base = jax.random.PRNGKey(seed)

    def noise(host_step, n, loss_fn, step=None):
        rng = jax.random.fold_in(base, host_step)
        if step is not None:
            rng = jax.random.fold_in(rng, step)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n, SMALL["z_dims"])))) for k in jax.random.split(rng))
    return noise


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert r.pop("time") > 0
    return recs


def test_fit_matches_jax_fit(tmp_path):
    rng = np.random.default_rng(4)
    T, A, n = SMALL["seq_len"], SMALL["attr_len"], 20
    corpus = (rng.integers(0, 342, (n, T)), rng.integers(0, 3, (n, A)),
              rng.integers(0, 16, (n, A)), rng.random((n, 24)))
    train = j_datasets.YamahaDataset(*corpus, mode="train").arrays()
    val = j_datasets.YamahaDataset(*corpus, mode="val").arrays()
    j_tr = JTrainer(JConfig(**SMALL, batch_size=B), j_init,
                    {"default": j_gmm_loss}, seed=0)
    start = jax.tree.map(np.asarray, j_tr.params)
    tr = Trainer(ModelConfig(**SMALL, batch_size=B), init_reg_gmvae,
                 {"default": gmm_loss}, seed=0,
                 params=params_from_numpy(start), device="cpu",
                 noise_fn=_compiled_jax_noise_fn(0))
    j_log, log = JLogger("run", str(tmp_path / "jax")), MetricsLogger(
        "run", str(tmp_path / "port"))
    saved = []
    lines = []
    j_tr.fit(train, val, n_epochs=2, metrics_logger=j_log,
             log_fn=lambda s: None)
    tr.fit(train, val, n_epochs=2, metrics_logger=log, log_fn=lines.append,
           checkpoint_fn=lambda st, ep: saved.append((st.step, ep)))
    j_log.close()
    log.close()
    assert tr._host_step == j_tr._host_step == 2 * (4 + 1)
    assert tr.step == int(j_tr.state.step) == 8 and tr.epoch == 2
    assert saved == [(4, 1), (8, 2)]
    assert lines[0] == "Epoch 1 / 2" and lines[1].startswith("train loss:")
    assert "val loss:" in lines[1] and lines[2].startswith("train by term")
    mine, theirs = (_records(tmp_path / d / "run.jsonl")
                    for d in ("port", "jax"))
    assert [(r["epoch"], r["split"], r["step"]) for r in mine] == [
        (r["epoch"], r["split"], r["step"]) for r in theirs] == [
        (1, "train", 5), (1, "val", 5), (2, "train", 10), (2, "val", 10)]
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        for k in a:
            if k not in ("epoch", "split", "step"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{a['split']} {k}")
    got = dict(named_leaves(params_to_numpy(tr.params)))
    want = dict(named_leaves(jax.tree.map(np.asarray, j_tr.params)))
    assert set(got) == set(want)
    for k in want:
        bound = 2 * LR * tr.step if k in NOISE_ONLY else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bound,
                                   err_msg=str(k))

    # the timers: compiled_step_time times a copy, steady_state_step_time
    # steps the live trainer
    before = {k: v.clone() for k, v in named_leaves(tr.state.params)}
    mu = {k: v.clone() for k, v in named_leaves(tr.state.opt_state["mu"])}
    best, windows = tr.compiled_step_time(train, iters=2, spread=True)
    assert len(windows) == 3 and best == min(windows) > 0
    assert (tr.step, tr._host_step) == (8, 10)
    for k, v in named_leaves(tr.state.params):
        assert torch.equal(v, before[k]), k
    for k, v in named_leaves(tr.state.opt_state["mu"]):
        assert torch.equal(v, mu[k]), k
    assert tr.steady_state_step_time(train, warmup=1, iters=2) > 0
    assert tr.step == 8 + 1 + 3 * 2 and tr._host_step == 10


@pytest.fixture(scope="module")
def vgmidi_dir(tmp_path_factory):
    """Released-format VGMIDI arrays: ragged object arrays of per-song
    sequences (tests/test_cli.py's recipe)."""
    d = tmp_path_factory.mktemp("vgmidi")
    arrays = synth_vgmidi_ragged(48, 60, 8)
    for name, arr in zip(("song_tokens", "rhythm_lst", "note_lst",
                          "arousal_lst", "valence_lst", "chroma_lst"),
                         arrays):
        np.save(d / f"{name}.npy", arr)
    return d


def _common(tmp_path, vgmidi_dir):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**SMALL, "num_clusters": 2,
                               "batch_size": 8}))
    return ["--device", "cpu", "--config", str(cfg), "--synthetic-size",
            "48", "--vgmidi-dir", str(vgmidi_dir), "--save-dir",
            str(tmp_path / "params"), "--log-dir", str(tmp_path / "log"),
            "--data-dir", str(tmp_path / "no_cache")]


def _run(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def test_train_resume_serve_evaluate_transfer(tmp_path, vgmidi_dir):
    common = _common(tmp_path, vgmidi_dir)
    name = "music_attr_vae_reg_gmm"
    tr, out = _run(train_cli.run_training, "gmm", "t", dual_corpus=True,
                   argv=common + ["--epochs", "2"])
    assert out.count("vgmidi train - ") == 2 and "Epoch 2 / 2" in out
    assert "[vgmidi test]" in out and "acc_q_x_r" in out and "[test]" in out
    assert tr.epoch == 2 and tr.train_path == "plain-cpu"
    saved = sorted(os.listdir(tmp_path / "params"))
    assert saved[0] == name and saved[1].startswith(name + "_2")
    assert os.listdir(tmp_path / "params" / name) == ["state.pt"]
    recs = _records(tmp_path / "log" / f"{name}.jsonl")
    assert [r["split"] for r in recs[:4]] == [
        "vgmidi_train", "vgmidi_val", "yamaha_train", "yamaha_val"]
    assert len(recs) == 8 and all(np.isfinite(r["loss"]) for r in recs)

    # resume: one more epoch, after the saved one
    step2, per_epoch = tr.step, tr.step // 2
    tr3, out = _run(train_cli.run_training, "gmm", "t", dual_corpus=True,
                    argv=common + ["--epochs", "3"])
    assert f"resumed at step {step2}, after epoch 2" in out
    assert "Epoch 1 / 3" not in out and "Epoch 3 / 3" in out
    assert tr3.step == step2 + per_epoch and tr3.epoch == 3
    batches = tr._host_step // 2            # every batch of one epoch
    assert tr3._host_step == step2 + batches

    # evaluate, serve and transfer from the saved directory
    _, out = _run(eval_cli.main, ["gmm"] + common + [
        "--samples", "2", "--eval-epochs", "1", "--decode-steps", "10"])
    assert "restored full-state checkpoint layout" in out
    assert out.count("Consistency:") == 2

    _, out = _run(serve_cli.run_server, common + [
        "--bench", "4", "--steps", "10", "--max-batch", "4"])
    bench = json.loads(out.strip().splitlines()[-1])
    assert bench["serving_path"] == "plain-cpu" and bench["requests"] == 4
    assert "restored full-state checkpoint layout" in out

    mid = tmp_path / "t.mid"
    (toks, notes), out = _run(transfer_cli.main, common + [
        "--steps", "30", "--out", str(mid), "--wav", str(tmp_path / "t.wav")])
    assert toks.shape == (30,) and 0 <= toks.min() and toks.max() < 342
    assert len(read_midi(str(mid)).notes) == len(notes)
    assert os.path.getsize(tmp_path / "t.wav") > 44
    (sampled, _), _ = _run(transfer_cli.main, common + [
        "--steps", "30", "--temperature", "1.0", "--out",
        str(tmp_path / "s.mid")])
    assert not np.array_equal(sampled, toks)


def test_train_cli_main_single_corpus(tmp_path, vgmidi_dir):
    """`python -m music_fader_nets_tpu_torch.train.cli vanilla`, in
    process: fit, per-epoch and timestamped checkpoints, the report."""
    _, out = _run(train_cli.main, ["vanilla", "--epochs", "1"]
                  + _common(tmp_path, vgmidi_dir))
    assert "Save path:" in out and "train loss:" in out and "[test]" in out
    assert "vgmidi" not in out
    saved = sorted(os.listdir(tmp_path / "params"))
    assert saved[0] == "music_attr_vae_reg_vanilla" and len(saved) == 2


def test_logger_timer_and_trace_match_jax(tmp_path):
    metrics = {"loss": np.float32(1.5), "ce": 0.25}
    for cls, d in ((JLogger, "jax"), (MetricsLogger, "port")):
        log = cls("run", str(tmp_path / d))
        log.log(metrics, step=np.int64(3), epoch=1, split="train")
        log.log(metrics)
        log.close()
    assert (_records(tmp_path / "port" / "run.jsonl")
            == _records(tmp_path / "jax" / "run.jsonl"))
    timers = StepTimer(), JTimer()
    for t in timers:
        assert t.summary() == {}
        for _ in range(3):
            t.start()
            time.sleep(0.001)
            t.stop()
    mine, theirs = (t.summary() for t in timers)
    assert set(mine) == set(theirs) and mine["n"] == 3
    assert mine["p50_s"] >= 0.001
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
