"""PyTorch port, the evaluation path (`eval/reconstruction.py`,
`eval/controllability.py`, `eval/cli.py`, `train/cli.py`) against the JAX
package's, on the CPU at a small size (H=16, z=6, the real 342-token
vocabulary: the tokenizer reads the decoded rows).

Tolerances: the host-side metric helpers exactly or to 1e-6;
`reconstruction_report` every key to 1e-4 with the JAX per-batch noise
handed over (recovered from each JAX forward as (z - mu) / std); the
evaluators with `sample_z=False` (no PRNG in the comparison) and the
output head sharpened 8x, so that no greedy step is a near-tie: identical
decoded tokens, scores to 1e-6 (nan equal to nan where every sample of an
epoch was discarded)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_fader_nets_tpu import models as j_models
from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.data.datasets import (
    VGMIDIDataset as JVGMIDIDataset, YamahaDataset as JYamahaDataset,
)
from music_fader_nets_tpu.eval import controllability as j_ctrl
from music_fader_nets_tpu.eval import reconstruction as j_recon
from music_fader_nets_tpu.train import cli as j_train_cli
from music_fader_nets_tpu_torch import models
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.datasets import (
    VGMIDIDataset, YamahaDataset,
)
from music_fader_nets_tpu_torch.data.synthetic import (
    synth_corpus, synth_vgmidi,
)
from music_fader_nets_tpu_torch.eval import cli as eval_cli
from music_fader_nets_tpu_torch.eval import controllability as ctrl
from music_fader_nets_tpu_torch.eval import reconstruction as recon
from music_fader_nets_tpu_torch.train import cli as train_cli
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

DIMS = dict(hidden_dims=16, z_dims=6, batch_size=8, seq_len=60, attr_len=8)
CFG, JCFG = ModelConfig(**DIMS), JConfig(**DIMS)


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(96, 60, 8)


def _port_params(p):
    return params_from_numpy(jax.tree.map(np.asarray, p))


# ------------------------------------------------------------ metric helpers

def test_metric_helpers_match_jax():
    rng = np.random.default_rng(0)
    logp = rng.standard_normal((5, 9, 7)).astype(np.float32)
    targets = rng.integers(0, 7, (5, 9)).astype(np.int32)
    targets[0, 4:] = 0
    targets[1] = 0                             # an all-padding row
    targets[2, 3] = 0                          # an inner zero stays
    for b in range(5):                         # some correct predictions
        logp[b, np.arange(0, 9, 2), targets[b, ::2]] += 9.0
    for trim in (True, False):
        want = float(j_recon._masked_accuracy(jnp.asarray(logp),
                                              jnp.asarray(targets), trim))
        got = float(recon._masked_accuracy(torch.from_numpy(logp),
                                           torch.from_numpy(targets), trim))
        assert abs(got - want) < 1e-6 and got > 0
    for _ in range(4):
        x, y = rng.standard_normal(8), rng.standard_normal(8)
        assert ctrl._r2(x, y) == j_ctrl._r2(x, y)
    assert ctrl._r2(np.arange(4.0), np.full(4, 2.5)) == 1.0
    for row in (np.array([0, 0, 5, 7, 9, 1, 3, 0, 0]), np.array([0, 4, 6, 0]),
                rng.integers(0, 4, 30), rng.standard_normal((12, 6))):
        np.testing.assert_array_equal(ctrl.clean_output(row),
                                      j_ctrl.clean_output(row))
    np.testing.assert_array_equal(
        ctrl.clean_output(np.array([0, 0, 5, 7, 9, 1, 3, 0, 0])), [5, 7, 9])
    for _ in range(4):
        r, n = rng.integers(0, 3, 16), rng.integers(0, 6, 16)
        assert ctrl.get_classes(r, n) == j_ctrl.get_classes(r, n)


# ------------------------------------------------------ reconstruction report

def _jax_noise(kind, fwd, p, arrays, bs, seed):
    """start row -> the noise tuple of the JAX report's forward on the
    batch that starts there (its rng is fold_in(PRNGKey(seed), start))."""
    out = {}
    rng = jax.random.PRNGKey(seed)
    for s in range(0, len(arrays["x"]), bs):
        batch = {k: v[s:s + bs] for k, v in arrays.items()}
        f = fwd(p, jax.random.fold_in(rng, s), batch)
        if kind == "gmm":
            out[s] = tuple(np.array((f[f"z_{t}"] - f[f"mu_{t}"])
                                    / f[f"std_{t}"]) for t in ("r", "n"))
        else:
            out[s] = (np.array((f["z"] - f["mu"]) / f["std"]),)
    return out


@pytest.mark.parametrize("kind", ["gmm", "cvae", "singlevae"])
def test_reconstruction_report_matches_jax(corpus, kind):
    """Two full batches and a 3-row tail; for the GM-VAE a VGMIDI-shaped
    split, whose labels add the mixture posterior's accuracies."""
    if kind == "gmm":
        d, r, n, a, v, c = synth_vgmidi(24, 60, 8)
        arrays = VGMIDIDataset(d, r, n, c, a, v).arrays()
        j_arrays = JVGMIDIDataset(d, r, n, c, a, v).arrays()
    else:
        arrays = YamahaDataset(*corpus).arrays()
        j_arrays = JYamahaDataset(*corpus).arrays()
    arrays = {k: v[:19] for k, v in arrays.items()}
    j_arrays = {k: v[:19] for k, v in j_arrays.items()}
    p = train_cli.MODEL_REGISTRY[kind]  # same names in both registries
    assert p["name"] == j_train_cli.MODEL_REGISTRY[kind]["name"]
    p = j_train_cli.MODEL_REGISTRY[kind]["init"](jax.random.PRNGKey(1), JCFG)
    j_fwd, j_sub = j_train_cli._forward_for(kind, JCFG)
    want = j_recon.reconstruction_report(p, j_fwd, j_arrays, JCFG,
                                         batch_size=8, seed=5,
                                         has_subdecoders=j_sub)
    noise = _jax_noise(kind, j_fwd, p, j_arrays, 8, 5)
    sizes = []

    def noise_fn(start, B):
        sizes.append(B)
        return tuple(torch.from_numpy(e) for e in noise[start])

    fwd, has_sub, draw = train_cli._forward_for(kind, CFG)
    assert has_sub == j_sub
    got = recon.reconstruction_report(_port_params(p), fwd, arrays, CFG,
                                      batch_size=8, has_subdecoders=has_sub,
                                      noise_fn=noise_fn, device="cpu")
    assert sizes == [8, 8, 3]
    assert set(got) == set(want)
    assert ("acc_q_x_r" in got) == (kind == "gmm")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # the default noise: the family's own draws from a seeded generator
    again = [recon.reconstruction_report(
        _port_params(p), fwd, arrays, CFG, draw=draw, batch_size=8, seed=2,
        has_subdecoders=has_sub, device="cpu") for _ in range(2)]
    assert again[0] == again[1] and set(again[0]) == set(want)
    assert all(np.isfinite(v) for v in again[0].values())
    assert recon.reconstruction_report(
        {}, fwd, {"x": np.zeros((0, 60), np.int32)}, CFG, draw=draw,
        device="cpu") == {}


def test_forward_noise_of_every_family():
    """`_forward_for`'s draw gives what its forward takes, for all six."""
    arrays = YamahaDataset(*synth_corpus(16, 60, 8)).arrays()
    for kind, spec in train_cli.MODEL_REGISTRY.items():
        fwd, has_sub, draw = train_cli._forward_for(kind, CFG)
        params = spec["init"](torch.Generator().manual_seed(0), CFG)
        rep = recon.reconstruction_report(params, fwd, arrays, CFG,
                                          draw=draw, batch_size=8,
                                          has_subdecoders=has_sub,
                                          device="cpu")
        assert ("CE_R" in rep) == has_sub == (kind in ("vanilla", "glsr",
                                                       "gmm"))
        assert all(np.isfinite(v) for v in rep.values()), kind


# -------------------------------------------------------------- latent stats

def test_latent_stats_and_monotonicity_match_jax(corpus):
    arrays = {k: v[:43] for k, v in YamahaDataset(*corpus).arrays().items()}
    p = j_models.init_reg_vae(jax.random.PRNGKey(0), JCFG)
    tp = _port_params(p)

    def j_means(batch, rng):
        x_oh = jax.nn.one_hot(batch["x"], JCFG.roll_dims)
        (mu_r, _), (mu_n, _) = j_models.reg_vae_encode(p, x_oh)
        return mu_r, mu_n

    def means(batch, gen):
        (mu_r, _), (mu_n, _) = models.reg_vae_encode(tp, None,
                                                     tokens=batch["x"])
        return mu_r, mu_n

    want = j_ctrl.latent_stats(j_means, arrays, JCFG, batch_size=16)
    got = ctrl.latent_stats(means, arrays, CFG, batch_size=16, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    want = j_ctrl.latent_monotonicity(j_means, arrays, JCFG, batch_size=16)
    got = ctrl.latent_monotonicity(means, arrays, CFG, batch_size=16,
                                   device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # the tail batch counts: a sentinel in the last row shows in the min
    sub = dict(arrays, r_density=arrays["r_density"].copy())
    sub["r_density"][42] = -99.0
    stats = ctrl.latent_stats(
        lambda batch, gen: (batch["r_density"][:, None],) * 2, sub, CFG,
        batch_size=16, device="cpu")
    assert stats["z_r_min"] == -99.0


# ---------------------------------------------------------------- evaluators

def _logged(ev, log):
    """The evaluator, with every wave's decoded tokens (M, steps) kept."""
    inner = ev._decode_all

    def decode_all(z_full):
        log.append(inner(z_full))
        return log[-1]

    ev._decode_all = decode_all
    return ev


def _sharpened(init, seed):
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), JCFG))
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 8.0
    return p


def _same_run(ev, j_ev, arrays, lo, hi, r_std, n_std):
    """Both evaluators over `arrays`: identical decoded tokens, wave by
    wave, and equal scores."""
    log, j_log = [], []
    got = _logged(ev, log).evaluate(arrays, lo, hi, r_std, n_std)
    want = _logged(j_ev, j_log).evaluate(arrays, lo, hi, r_std, n_std)
    assert len(log) == len(j_log) >= 2
    for a, b in zip(log, j_log):
        assert a.shape == b.shape and a.shape[0] % 8 == 0
        np.testing.assert_array_equal(a, b)
    for f in ("consistency", "restrictiveness", "monotonicity"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    return got


@pytest.mark.parametrize("target", ["rhythm", "note"])
def test_controllability_evaluator_matches_jax(corpus, target):
    """The GM-VAE's latent slide through the token decode
    (`*_decode_tokens`, 64-row calls)."""
    arrays = YamahaDataset(*corpus, mode="test").arrays()
    p = _sharpened(j_models.init_reg_gmvae, 3)
    kw = dict(target=target, epochs=2, num_of_samples=3, decode_steps=40,
              seed=4, verbose=False, sample_z=False)
    rows = []

    def decode_tokens(params, z, steps, device):
        rows.append(z.shape[0])
        return models.reg_gmvae_decode_tokens(params, z, steps, device)

    j_ev = j_ctrl.ControllabilityEvaluator(
        p, JCFG, j_models.reg_gmvae_encode, j_models.reg_gmvae_global_decode,
        decode_tokens=j_models.reg_gmvae_decode_tokens, **kw)
    ev = ctrl.ControllabilityEvaluator(
        _port_params(p), CFG, models.reg_vae_encode,
        models.reg_gmvae_global_decode, decode_tokens=decode_tokens,
        device="cpu", **kw)
    got = _same_run(ev, j_ev, arrays, -1.5, 1.5, 0.2, 0.6)
    assert rows and all(r == 64 for r in rows)
    # this init decodes rows that parse back to attributes: real scores
    assert np.isfinite([got.consistency, got.restrictiveness,
                        got.monotonicity]).all()


@pytest.mark.parametrize("target", ["rhythm", "note"])
def test_single_and_condition_evaluators_match_jax(corpus, target):
    """SingleVAE (dims 0/1 of the one latent) and the CVAE's condition
    sweep, both through the argmax of `global_decode`'s log-probs."""
    arrays = YamahaDataset(*corpus, mode="test").arrays()
    kw = dict(target=target, epochs=2, num_of_samples=3, decode_steps=40,
              seed=6, verbose=False, sample_z=False)
    p = _sharpened(j_models.init_single_vae, 3)
    _same_run(
        ctrl.SingleVAEControllabilityEvaluator(
            _port_params(p), CFG, models.single_vae_encode,
            models.single_vae_global_decode, device="cpu", **kw),
        j_ctrl.SingleVAEControllabilityEvaluator(
            p, JCFG, j_models.single_vae_encode,
            j_models.single_vae_global_decode, **kw),
        arrays, -1.0, 1.0, 0.2, 0.6)
    p = _sharpened(j_models.init_cvae, 4)
    _same_run(
        ctrl.ConditionControllabilityEvaluator(
            _port_params(p), CFG, models.cvae_encode,
            models.cvae_global_decode, device="cpu", **kw),
        j_ctrl.ConditionControllabilityEvaluator(
            p, JCFG, j_models.cvae_encode, j_models.cvae_global_decode,
            **kw),
        arrays, 0.0, 1.0, 0.16, 0.88)


def test_sampled_z_is_seeded_and_differs_from_the_mean(corpus):
    arrays = YamahaDataset(*corpus, mode="test").arrays()
    params = models.init_reg_gmvae(torch.Generator().manual_seed(0), CFG)

    def z_of(sample_z, seed):
        ev = ctrl.ControllabilityEvaluator(
            params, CFG, models.reg_vae_encode, models.reg_vae_global_decode,
            seed=seed, sample_z=sample_z, device="cpu")
        items = {k: v[:2] for k, v in arrays.items()}
        return ev._z_batch_many(items, np.linspace(-1, 1, 8))

    a, b, mean = z_of(True, 1), z_of(True, 1), z_of(False, 1)
    assert a.shape == (16, 2 * CFG.z_dims + CFG.chroma_dims)
    assert torch.equal(a, b) and not torch.equal(a, z_of(True, 2))
    assert not torch.equal(a, mean)
    # the swept dim holds the slider values, one run of 8 per item
    np.testing.assert_allclose(mean[:, 0].numpy(),
                               np.tile(np.linspace(-1, 1, 8), 2), atol=1e-6)


# ----------------------------------------------------------------------- CLI

def _tiny_argv(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"hidden_dims": 16, "z_dims": 6, "num_clusters": 2}')
    return ["--device", "cpu", "--config", str(cfg), "--synthetic-size",
            "64", "--samples", "2", "--eval-epochs", "1", "--decode-steps",
            "30", "--save-dir", str(tmp_path / "params"), "--data-dir",
            str(tmp_path / "no_cache")]


@pytest.mark.parametrize("kind", ["gmm", "singlevae", "fader"])
def test_run_evaluation_prints_the_report(tmp_path, capsys, kind):
    eval_cli.main([kind] + _tiny_argv(tmp_path))
    out = capsys.readouterr().out
    assert "evaluating random init" in out
    assert out.count("Consistency:") == 2 and out.count("Monotonicity:") == 2
    assert ("=== rhythm fader" in out) and ("=== note fader" in out)
    assert ("latent stats (test)" in out) == (kind != "fader")
    assert ("condition-sweep std normalizers" in out) == (kind == "fader")


def test_cli_refuses_checkpoints_and_bfloat16(tmp_path, capsys):
    """A checkpoint that was asked for and cannot be read raises instead of
    evaluating a random init (the readable layouts are held in
    tests/test_torch_checkpoint.py). `--dtype bfloat16` is no longer
    refused: evaluation ignores the compute dtype, as the JAX package's
    does, so it prints the float32 report."""
    argv = _tiny_argv(tmp_path)
    reports = []
    for dtype in ("float32", "bfloat16"):
        eval_cli.run_evaluation("cvae", "t", argv + ["--dtype", dtype])
        reports.append(capsys.readouterr().out)
    assert "Consistency:" in reports[0] and reports[1] == reports[0]
    with pytest.raises(FileNotFoundError, match="x.pt"):
        eval_cli.run_evaluation("gmm", "t", argv + ["--from-pt", "x.pt"])
    (tmp_path / "params" / "music_attr_vae_reg_gmm").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        eval_cli.run_evaluation("gmm", "t", argv)
    with pytest.raises(SystemExit):            # the JAX CLI's TPU flags
        eval_cli.run_evaluation("cvae", "t", argv + ["--pallas-gru"])


def test_cli_shares_the_jax_cli_settings(tmp_path):
    assert eval_cli.WORKLOADS == __import__(
        "music_fader_nets_tpu.eval.cli", fromlist=["x"]).WORKLOADS
    for kind, spec in train_cli.MODEL_REGISTRY.items():
        theirs = j_train_cli.MODEL_REGISTRY[kind]
        assert (spec["name"], spec["config"], sorted(spec["losses"])) == (
            theirs["name"], theirs["config"], sorted(theirs["losses"]))
    ap = train_cli.build_argparser("t")
    args = ap.parse_args(["--data-type", "long", "--fixed-quirks",
                          "--kl-warmup", "5", "--free-bits", "0.5",
                          "--batch-size", "4", "--epochs", "2"])
    j_args = j_train_cli.build_argparser("t").parse_args(
        ["--data-type", "long", "--fixed-quirks", "--kl-warmup", "5",
         "--free-bits", "0.5", "--batch-size", "4", "--epochs", "2"])
    mine = train_cli.config_from_args("gmm", args)
    theirs = j_train_cli.config_from_args("gmm", j_args)
    for f in ("seq_len", "attr_len", "batch_size", "n_epochs",
              "num_clusters", "hidden_dims", "z_dims", "kl_warmup_steps",
              "free_bits", "faithful_negative_beta",
              "faithful_subdecoder_softmax_axis", "faithful_glsr_batch0"):
        assert getattr(mine, f) == getattr(theirs, f), f
    args = ap.parse_args(["--synthetic-size", "40", "--data-dir",
                          str(tmp_path / "none")])
    yam = train_cli.load_yamaha(args, CFG)
    assert [len(yam[m]) for m in ("train", "val", "test")] == [32, 4, 4]
    assert yam["train"].source == "synthetic"
    r_std, n_std = eval_cli._condition_stds(yam)
    assert r_std == float(np.std(yam["train"].arrays()["r_density"]))
    yam["train"].source = "cache"
    assert eval_cli._condition_stds(yam) == (eval_cli.CVAE_R_STD,
                                             eval_cli.CVAE_N_STD)
    vg = train_cli.load_vgmidi(ap.parse_args(
        ["--vgmidi-dir", str(tmp_path / "none")]))
    assert len(vg["train"]) == 460 and "a" in vg["test"].arrays()
