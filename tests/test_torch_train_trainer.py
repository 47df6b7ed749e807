"""PyTorch port, the GM-VAE `Trainer` and its data pipeline against the JAX
package at a small size (H=32, z=8, T=8, attr_len=4, B=4).

Three steps of `Trainer.run_epoch` on each side, from the same canonical
params, with the same batch order (the loaders' numpy shuffle) and the
same reparameterisation noise (the JAX Trainer's draws handed to the port
through `noise_fn`), then an evaluation pass and a supervised step, give
the same canonical params to atol=1e-5, and the same epoch metrics to
rtol=1e-4.

One exception, because Adam normalises near-zero gradients: an Adam step
moves an element by about lr * m / sqrt(v), near lr whatever the size of
the gradient. The sub-decoders' output biases (`linear_out_r.b`,
`linear_out_n.b`) have a true gradient of exactly 0: their log-softmax
runs over the TIME axis (the reference's quirk), along which a per-class
bias is constant. Their computed gradients are float32 rounding noise,
different on the two sides, so Adam moves them in different directions:
they are held only to the bound of that motion, 2 * lr per step."""
import functools

import jax
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.data import datasets as j_datasets
from music_fader_nets_tpu.data.loader import batch_iterator as j_batches
from music_fader_nets_tpu.losses.elbo import anneal_beta as j_anneal
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu.train.objectives import gmm_loss as j_gmm_loss
from music_fader_nets_tpu.train.trainer import Trainer as JTrainer
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data import datasets
from music_fader_nets_tpu_torch.data.loader import batch_iterator
from music_fader_nets_tpu_torch.losses.elbo import anneal_beta
from music_fader_nets_tpu_torch.models import fast
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.ops.cuda_clip import clip_by_global_norm_
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B, LR, STEPS = 4, 1e-3, 3


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def corpus(n, seed, supervised=False):
    """Fixed-shape corpus arrays in the loaders' schema, from numpy."""
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    out = [rng.integers(0, 342, (n, T)), rng.integers(0, 3, (n, A)),
           rng.integers(0, 16, (n, A)), rng.random((n, 24))]
    if supervised:
        out += [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)]
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_datasets_and_batch_order_match_jax():
    yam = corpus(40, 0)
    vg = corpus(40, 1, supervised=True)
    for mode in ("train", "val", "test"):
        for mine, theirs in (
                (datasets.YamahaDataset(*yam, mode=mode),
                 j_datasets.YamahaDataset(*yam, mode=mode)),
                (datasets.VGMIDIDataset(*vg, mode=mode),
                 j_datasets.VGMIDIDataset(*vg, mode=mode))):
            a, b = mine.arrays(), theirs.arrays()
            assert set(a) == set(b) and len(mine) == len(theirs)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    arrays = datasets.YamahaDataset(*yam).arrays()
    for seed in (0, 3):
        for x, y in zip(batch_iterator(arrays, 5, seed=seed),
                        j_batches(arrays, 5, seed=seed)):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    # the released ragged format: EOS re-inserted, rows padded, densities
    # over the unpadded tracks
    from music_fader_nets_tpu.data.synthetic import synth_vgmidi_ragged
    d, r, n, a, v, c = synth_vgmidi_ragged(24, seed=5)
    for mode in ("train", "val", "test"):
        a_, b_ = (cls(d, r, n, c, a, v, mode=mode).arrays()
                  for cls in (datasets.VGMIDIDataset,
                              j_datasets.VGMIDIDataset))
        for k in a_:
            assert a_[k].dtype == b_[k].dtype, k
            np.testing.assert_array_equal(a_[k], b_[k], err_msg=k)


@pytest.mark.parametrize("idx", [0, 3, -1, slice(2, 7), slice(None, None, 3)])
@pytest.mark.parametrize("kind", ["yamaha", "vgmidi", "vgmidi_ragged"])
def test_dataset_items_match_jax(kind, idx):
    """`ds[idx]` holds the JAX dataset's keys, with the same types and
    values, for an int, a negative int and a slice."""
    if kind == "yamaha":
        args, cls, j_cls = (corpus(40, 0), datasets.YamahaDataset,
                            j_datasets.YamahaDataset)
    else:
        if kind == "vgmidi":
            args = corpus(40, 1, supervised=True)
        else:
            from music_fader_nets_tpu.data.synthetic import (
                synth_vgmidi_ragged,
            )
            d, r, n, a, v, c = synth_vgmidi_ragged(24, seed=5)
            args = (d, r, n, c, a, v)
        cls, j_cls = datasets.VGMIDIDataset, j_datasets.VGMIDIDataset
    mine, theirs = cls(*args)[idx], j_cls(*args)[idx]
    assert list(mine) == list(theirs)
    for k in theirs:
        assert type(mine[k]) is type(theirs[k]), k
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_anneal_beta_and_config_match_jax():
    for step in (0, 999, 1000, 1500, 9999, 10000, 15000, 30000):
        for faithful in (True, False):
            np.testing.assert_allclose(
                anneal_beta(step, 0.2, faithful),
                float(j_anneal(step, 0.2, faithful)), rtol=1e-6)
        np.testing.assert_allclose(anneal_beta(step, 0.2, True, 500),
                                   float(j_anneal(step, 0.2, True, 500)),
                                   rtol=1e-6)
    assert anneal_beta(1500, 0.2) < 0.0       # the reference's quirk
    mine, theirs = ModelConfig(), JConfig()
    for f in ("batch_size", "n_epochs", "lr", "beta", "hidden_dims",
              "z_dims", "num_clusters", "seq_len", "attr_len",
              "eval_decode_steps", "dtype", "use_pallas_gru",
              "faithful_negative_beta", "faithful_subdecoder_softmax_axis",
              "faithful_glsr_batch0", "kl_warmup_steps", "free_bits",
              "ce_x_weight"):
        assert getattr(mine, f) == getattr(theirs, f), f
    # mixed precision constructs, as in the JAX package; another dtype
    # string does not
    assert ModelConfig(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="float16"):
        ModelConfig(dtype="float16")


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    """Below a global norm of 1 the gradients pass unchanged, above it they
    scale by 1 / norm, as optax.clip_by_global_norm(1.0) does (and unlike
    torch.nn.utils.clip_grad_norm_, which divides by norm + 1e-6)."""
    rng = np.random.default_rng(5)
    tree = {"a": (rng.standard_normal((7, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal(11) * scale).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update(tree, None)
    grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    norm = clip_by_global_norm_(grads, 1.0)
    assert (float(norm) > 1.0) == (scale > 1.0)
    for g, k in zip(grads, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


def _jax_noise_fn(seed):
    """The JAX Trainer's draws: fold_in(PRNGKey(seed), host_step), split
    into the two streams' keys (trainer.py:277, objectives.py:119,
    gmvae.py:121-123)."""
    base = jax.random.PRNGKey(seed)

    def noise(host_step, n, loss_fn):
        rng = jax.random.fold_in(base, host_step)
        keys = jax.random.split(rng)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n, SMALL["z_dims"])))) for k in keys)
    return noise


def test_trainer_steps_match_jax(pallas_interpret):
    """Three unsupervised steps, then an evaluation pass and one supervised
    step: the canonical params and the epoch metrics of both trainers."""
    jcfg = JConfig(**SMALL, batch_size=B, use_pallas_gru=True)
    cfg = ModelConfig(**SMALL, batch_size=B)
    j_tr = JTrainer(jcfg, j_init, {
        "default": j_gmm_loss,
        "supervised": functools.partial(j_gmm_loss, is_supervised=True)},
        seed=0)
    start = jax.tree.map(np.asarray, j_tr.params)
    tr = Trainer(cfg, init_reg_gmvae, {
        "default": gmm_loss,
        "supervised": functools.partial(gmm_loss, is_supervised=True)},
        seed=0, params=params_from_numpy(start), device="cpu",
        noise_fn=_jax_noise_fn(0))
    # 80% of 4B items: the train split holds STEPS = 3 batches
    yam = datasets.YamahaDataset(*corpus(4 * B, 2), mode="train").arrays()
    vg = datasets.VGMIDIDataset(*corpus(2 * B, 3, supervised=True),
                                mode="train").arrays()

    def both(**kw):
        a = tr.run_epoch(**kw)
        b = j_tr.run_epoch(compiled=False, **kw)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)

    both(arrays=yam, seed=1)
    assert tr.step == STEPS and tr.train_path == "plain-cpu"
    both(arrays=yam, train=False, shuffle=False)
    both(arrays=vg, variant="supervised", seed=2)
    assert tr.step == STEPS + 1

    got = dict(_leaves(params_to_numpy(tr.params)))
    want = dict(_leaves(jax.tree.map(np.asarray, j_tr.params)))
    before = dict(_leaves(start))
    assert set(got) == set(want)
    noise_only = {("linear_out_r", "b"), ("linear_out_n", "b")}
    for k in want:
        bound = 2 * LR * tr.step if k in noise_only else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bound,
                                   err_msg=str(k))
    # parity-only layers and the logvar tables take no update
    for k in fast.FROZEN_KEYS + ("logvar_r_lookup", "logvar_n_lookup"):
        for path in [p for p in got if p[0] == k]:
            np.testing.assert_array_equal(got[path], before[path])
    # pad rows of the fast layout stay at their stored zero
    fp = tr.fast_params
    assert not fp["enc_rn"]["w_ih_p"][:, 342:].any()
    assert not fp["grucell_g"]["w_tok_p"][342:].any()


def test_trainer_needs_cuda_unless_cpu_asked(monkeypatch):
    """The Trainer runs on CUDA by default and raises without a card; with
    device="cpu" it trains on its own seeded noise and hands back a
    canonical tree of the init's structure."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(hidden_dims=16, z_dims=4, seq_len=6, attr_len=4,
                      batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, init_reg_gmvae, {"default": gmm_loss})
    tr = Trainer(cfg, init_reg_gmvae, {"default": gmm_loss}, seed=3,
                 device="cpu")
    rng = np.random.default_rng(0)
    arrays = datasets.YamahaDataset(
        rng.integers(0, 342, (5, 6)), rng.integers(0, 3, (5, 4)),
        rng.integers(0, 16, (5, 4)), rng.random((5, 24))).arrays()
    m = tr.run_epoch(arrays, seed=0)
    assert tr.step == 2 and np.isfinite(m["loss"])
    init = params_to_numpy(init_reg_gmvae(torch.Generator().manual_seed(3),
                                          cfg))
    got = params_to_numpy(tr.params)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(init)]
    assert not np.array_equal(got["mu_r"]["w"], init["mu_r"]["w"])
