"""PyTorch port, its parity harness (`music_fader_nets_tpu_torch/parity.py`)
and its graft entry (`music_fader_nets_tpu_torch/entry.py`) on the CPU.

The harness runs on stand-in `.pt` files for all six kinds, written by the
JAX package's `params_to_torch_state_dict` from its inits at a small size
(H=32, z=8, T=8), and a token array from the JAX codec: every section
passes with `--device cpu`, alone and as a sweep. A port tree with one
leaf perturbed (a converter fault) fails section 2 and the command exits
non-zero; a non-canonical token stream gets the first-divergence
diagnostics of tests/test_compat.py. `entry(device="cpu")` gives the JAX
`gmm_loss` of the same params, batch and noise (the noise of the JAX
forward handed over) to 1e-4."""
import contextlib
import io
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.tokenizer.midi_io import MidiNote as JNote
from music_fader_nets_tpu.tokenizer.performance_codec import (
    performance_encode as j_encode,
)
from music_fader_nets_tpu.train.cli import MODEL_REGISTRY as J_REGISTRY
from music_fader_nets_tpu.train.objectives import gmm_loss as j_gmm_loss
from music_fader_nets_tpu.utils.checkpoint import (
    params_to_torch_state_dict as j_to_sd,
)
from music_fader_nets_tpu_torch import entry as port_entry
from music_fader_nets_tpu_torch import parity
from music_fader_nets_tpu_torch.models.fast import split_fast
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.utils import checkpoint as t_ckpt
from music_fader_nets_tpu_torch.utils.checkpoint import (
    named_leaves, params_to_numpy,
)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_clusters=2, hidden_dims=32, z_dims=8, seq_len=8,
             attr_len=4)
EVAL_ARGS = ["--device", "cpu", "--synthetic-size", "48", "--samples", "1",
             "--eval-epochs", "1", "--decode-steps", "10"]


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """The six released names, each a JAX init's state_dict, the small
    config as JSON, and a canonical token array."""
    d = tmp_path_factory.mktemp("standins")
    cfg = JConfig(**SMALL)
    for i, (fname, kind) in enumerate(parity.RELEASED_CKPTS):
        p = J_REGISTRY[kind]["init"](jax.random.PRNGKey(i), cfg)
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in j_to_sd(p).items()}, d / fname)
    (d / "small.json").write_text(json.dumps(SMALL))
    notes = [JNote(60 + i % 12, 64, 0.3 * i, 0.3 * i + 0.2)
             for i in range(8)]
    t = j_encode(notes, add_eos=True)
    np.save(d / "song_tokens.npy", np.stack([np.pad(t, (0, 120 - len(t)))]))
    return d


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = parity.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("fname,kind", parity.RELEASED_CKPTS)
def test_harness_passes_on_standins(standins, fname, kind):
    """Sections 1-4 for one checkpoint on --device cpu, its kind inferred
    from the file name; section 2 also through the token-id inputs."""
    rc, out = _main(["--from-pt", str(standins / fname), "--tokens",
                     str(standins / "song_tokens.npy"), "--config",
                     str(standins / "small.json")] + EVAL_ARGS)
    assert rc == 0, out[-3000:]
    assert f"(kind={kind})" in out and "PARITY: ALL PASS" in out
    for section in ("[1] converter round trip", "[2] forward parity",
                    "[3] Table-1 eval at reference workloads: PASS",
                    "[4] token-stream re-encode: 1/1 rows exact (100.00%)"):
        assert section in out
    assert "global teacher decode (token ids)" in out
    if kind != "cvae":
        assert "(token ids): max|d|" in out.split("global teacher")[0]


def test_sweep_over_six_standins(standins, tmp_path):
    """--params-dir: one summary table, all PASS; a missing checkpoint and
    an unreadable one fail the sweep, the others still validated."""
    rc, out = _main(["--params-dir", str(standins), "--config",
                     str(standins / "small.json")] + EVAL_ARGS)
    assert rc == 0, out[-3000:]
    assert "sweep: ALL PASS" in out
    for kind in parity.KINDS:
        line = next(ln for ln in out.splitlines() if ln.startswith(kind))
        assert line.count("PASS") == 3 and "FAIL" not in line, line

    for fname, _ in parity.RELEASED_CKPTS:
        if fname != "music_attr_fader.pt":
            os.symlink(standins / fname, tmp_path / fname)
    os.unlink(tmp_path / "music_attr_vae_reg_glsr.pt")
    (tmp_path / "music_attr_vae_reg_glsr.pt").write_bytes(b"not torch")
    rc, out = _main(["--params-dir", str(tmp_path), "--skip-eval",
                     "--device", "cpu"])
    assert rc == 1 and "MISSING" in out and "FAILURES PRESENT" in out
    assert "ERROR validating music_attr_vae_reg_glsr.pt" in out
    for kind in ("cvae", "singlevae"):
        line = next(ln for ln in out.splitlines() if ln.startswith(kind))
        assert line.count("PASS") == 2, line


@pytest.mark.parametrize("leaf", [("gru_r", "bwd", "w_hh"),
                                  ("gru_d_n", "b_ih"),
                                  ("grucell_g_2", "w_hh"),
                                  ("grucell_g", "b_hh")])
def test_perturbed_leaf_fails_forward(standins, monkeypatch, leaf):
    """The port's tree with one leaf off by 1e-2 (as a converter fault
    would leave it) fails section 2 at the checks that read the leaf, and
    the command exits non-zero."""
    convert = t_ckpt.convert_torch_state_dict

    def faulty(sd):
        params = convert(sd)
        node = params
        for k in leaf[:-1]:
            node = node[k]
        node[leaf[-1]] = node[leaf[-1]] + 1e-2
        return params

    monkeypatch.setattr(t_ckpt, "convert_torch_state_dict", faulty)
    sd = parity.load_state_dict(str(standins / "music_attr_vae_reg_gmm.pt"))
    diffs = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ok = parity.check_forward(sd, "gmm", "cpu", diffs=diffs)
    assert not ok and "FAIL" in out.getvalue()
    bad = {k for k, d in diffs.items() if d > 1e-4}
    want = {("gru_r", "bwd", "w_hh"): "encoder mu_r",
            ("gru_d_n", "b_ih"): "sub_decoder_n",
            ("grucell_g_2", "w_hh"): "global teacher decode",
            ("grucell_g", "b_hh"): "global teacher decode"}[leaf]
    assert any(k.startswith(want) for k in bad), bad
    rc, _ = _main(["--from-pt", str(standins / "music_attr_vae_reg_gmm.pt"),
                   "--skip-eval", "--device", "cpu"])
    assert rc == 1


def test_token_divergence_diagnostics(tmp_path, capsys):
    """A redundant velocity event mid-stream (outside the codec's
    canonical image) is reported with its row, position, the token roles
    on both sides and a divergence histogram (tests/test_compat.py:98)."""
    from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote
    from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
        performance_encode,
    )
    notes = [MidiNote(60 + (i % 12), 64 + (i % 3) * 10, 0.3 * i,
                      0.3 * i + 0.25) for i in range(10)]
    good = performance_encode(notes, add_eos=True)
    bad = list(good)
    k = next(j for j, t in enumerate(bad) if 278 <= t < 342 and j > 2)
    bad.insert(k, bad[k])
    rows = np.stack([np.pad(np.asarray(good), (0, 150 - len(good))),
                     np.pad(np.asarray(bad), (0, 150 - len(bad)))])
    path = tmp_path / "song_tokens.npy"
    np.save(path, rows)
    assert not parity.check_token_stream(str(path), limit=0)
    out = capsys.readouterr().out
    assert "1/2 rows exact" in out
    assert f"row 1 diverges at pos {k + 1}" in out
    assert "SHIFT(" in out and "VEL(" in out
    assert "divergence histogram" in out
    assert parity.check_token_stream(str(path), limit=1)


def jax_noise(rng, n, z_dims):
    """The draws of the JAX forward: split(rng) -> normal per stream
    (objectives.py:119 -> gmvae.py:121-123)."""
    return tuple(np.array(jax.random.normal(k, (n, z_dims)))
                 for k in jax.random.split(rng))


def test_entry_matches_jax_gmm_loss():
    """entry(device="cpu"): the root entry's configuration, batch and
    step; params the fast layout of `init_reg_gmvae` seeded 0. Its
    `fn` on those params with the JAX forward's noise gives the JAX
    `gmm_loss` of the same canonical params, loss and every metric to
    1e-4."""
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(str(REPO))
    fn, (params, eps, batch, step) = port_entry.entry(device="cpu")
    jcfg = JConfig(num_clusters=2, seq_len=100, attr_len=16)
    j_batch = graft._example_batch(jcfg, B=port_entry.BATCH)
    assert set(batch) == set(j_batch) and step == 0
    for k, v in j_batch.items():
        np.testing.assert_array_equal(batch[k].numpy(), v)
    assert [tuple(e.shape) for e in eps] == [(8, jcfg.z_dims)] * 2

    canon = init_reg_gmvae(torch.Generator().manual_seed(0),
                           port_entry.ModelConfig(num_clusters=2,
                                                  seq_len=100, attr_len=16))
    fast = split_fast(canon)[0]
    assert [(k, torch.equal(v, dict(named_leaves(params))[k]))
            for k, v in named_leaves(fast)] == [
        (k, True) for k, _ in named_leaves(fast)]
    rng = jax.random.PRNGKey(1)
    noise = tuple(torch.from_numpy(e) for e in jax_noise(rng, 8,
                                                         jcfg.z_dims))
    with torch.no_grad():
        loss, metrics = fn(params, noise, batch, step)
    j_loss, j_metrics = j_gmm_loss(params_to_numpy(canon), rng, j_batch,
                                   step, jcfg)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    with torch.no_grad():
        assert np.isfinite(float(fn(params, eps, batch, step)[0]))
