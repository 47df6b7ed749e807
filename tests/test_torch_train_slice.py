"""PyTorch port, the GM-VAE training slice against the JAX package at a
small size (H=32, z=8, T=8, attr_len=4, B=4, V=342): the fast parameter
layout both ways, and `gmm_loss` (unsupervised and supervised) with its
gradients on the fast layout, the JAX side on its kernel path
(`use_pallas_gru=True`, Pallas in interpret mode), the port on its plain
versions. Same params, batch and reparameterisation noise on both sides.

Tolerances: the loss to rtol=1e-5; gradients to atol=3e-4, rtol=2e-3, the
JAX package's own bound for the same loss on its fused kernels against its
scan path (tests/test_pallas_gru.py:434)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import fast as j_fast
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu.train.objectives import gmm_loss as j_gmm_loss
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import fast
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B = 4
GRAD_TOL = dict(atol=3e-4, rtol=2e-3)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


@pytest.fixture(scope="module")
def np_params():
    p = j_init(jax.random.PRNGKey(0), JConfig(**SMALL))
    return jax.tree.map(np.asarray, p)


def make_batch(seed: int, n: int = B, supervised: bool = False):
    """An in-schema batch from numpy: tokens in [0, 342), rhythm ids in
    [0, 3), note ids in [0, 16), chroma, densities, arousal labels."""
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    r = rng.integers(0, 3, (n, A)).astype(np.int32)
    nt = rng.integers(0, 16, (n, A)).astype(np.int32)
    b = {"x": rng.integers(0, 342, (n, T)).astype(np.int32), "r": r,
         "n": nt, "c": rng.random((n, 24)).astype(np.float32),
         "r_density": (r == 1).mean(-1).astype(np.float32),
         "n_density": nt.mean(-1).astype(np.float32)}
    if supervised:
        b["a"] = rng.integers(0, 2, n).astype(np.int32)
    return b


def jax_noise(rng, n, z_dims):
    """The draws of the JAX forward: split(rng) -> normal per stream
    (objectives.py:119 -> gmvae.py:121-123)."""
    rng_r, rng_n = jax.random.split(rng)
    return tuple(np.array(jax.random.normal(k, (n, z_dims)))
                 for k in (rng_r, rng_n))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_split_fast_matches_jax_and_merge_inverts(np_params):
    """JAX canonical params -> numpy -> port -> split_fast equals JAX's
    split_fast leaf for leaf; merge_canonical gives the canonical tree back
    exactly."""
    j_fp, j_frozen = j_fast.split_fast(np_params)
    tp = params_from_numpy(np_params)
    fp, frozen = fast.split_fast(tp)
    for got, want in ((fp, j_fp), (frozen, j_frozen)):
        g, w = list(_leaves(params_to_numpy(got))), list(
            _leaves(jax.tree.map(np.asarray, want)))
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, a), (_, b_) in zip(g, w):
            assert a.shape == b_.shape, k
            np.testing.assert_array_equal(a, b_, err_msg=str(k))
    assert set(frozen) == set(fast.FROZEN_KEYS)
    back = params_to_numpy(fast.merge_canonical(fp, frozen, tp))
    g, w = list(_leaves(back)), list(_leaves(np_params))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b_) in zip(g, w):
        np.testing.assert_array_equal(a, b_, err_msg=str(k))


@pytest.mark.parametrize("supervised", [False, True])
def test_gmm_loss_and_grads_match_jax(np_params, pallas_interpret,
                                      supervised):
    """The slice: `gmm_loss` on the fast layout, value and the gradient of
    every trainable leaf. The JAX side must have taken its kernel path."""
    jcfg = JConfig(**SMALL, use_pallas_gru=True)
    batch = make_batch(7, supervised=supervised)
    rng = jax.random.PRNGKey(11)
    step = 1500                  # inside the negative-beta window
    loss_fn = functools.partial(j_gmm_loss, is_supervised=supervised)
    j_fp, _ = j_fast.split_fast(np_params)
    pallas_gru.LAST_TRAIN_PATH = None
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda p: loss_fn(p, rng, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jnp.int32(step), jcfg),
        has_aux=True)(j_fp)
    assert pallas_gru.LAST_TRAIN_PATH == "kernel-single"

    cfg = ModelConfig(**SMALL)
    fp, _ = fast.split_fast(params_from_numpy(np_params))
    for _, t in _leaves(fp):
        t.requires_grad_(True)
    eps = tuple(torch.from_numpy(e) for e in jax_noise(rng, B, cfg.z_dims))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = gmm_loss(fp, eps, tb, step, cfg,
                             is_supervised=supervised)
    loss.backward()
    assert cuda_gru.LAST_TRAIN_PATH == cuda_decoder.LAST_TRAIN_PATH == \
        "plain-cpu"
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_grads)))
    for path, t in _leaves(fp):
        want = j_leaves[path]
        got = (np.zeros_like(want) if t.grad is None
               else t.grad.numpy())
        np.testing.assert_allclose(got, want, err_msg=str(path), **GRAD_TOL)
    # the frozen logvar tables take no gradient at all
    for k in ("logvar_r_lookup", "logvar_n_lookup"):
        assert fp[k].grad is None or not fp[k].grad.any()


def test_forward_routes_agree_with_jax(np_params):
    """`reg_gmvae_forward` over the canonical tree on the one-hot routes
    (plain teacher decode, canonical sub-decoders) against the JAX scan
    path; and the fast layout on the id routes (the kernels' plain
    versions here) against the canonical one: the same sub-decoder
    log-probs, and the fused NLL equal to the teacher log-probs gathered
    at the targets."""
    from music_fader_nets_tpu.models.gmvae import (
        reg_gmvae_forward as j_forward,
    )
    from music_fader_nets_tpu_torch.models.gmvae import reg_gmvae_forward
    from music_fader_nets_tpu_torch.train.objectives import _one_hots
    jcfg, cfg = JConfig(**SMALL), ModelConfig(**SMALL)
    batch = make_batch(9)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x, r, n = (jax.nn.one_hot(jb[k], d) for k, d in (
        ("x", 342), ("r", jcfg.rhythm_dims), ("n", jcfg.note_dims)))
    want = j_forward(np_params, rng, x, r, n, jb["c"], jcfg)
    eps = [torch.from_numpy(e) for e in jax_noise(rng, B, cfg.z_dims)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_numpy(np_params)
    got = reg_gmvae_forward(tp, *eps, *_one_hots(tb, cfg), tb["c"], cfg)
    for k in ("out", "r_out", "n_out", "mu_r", "std_n", "z", "qy_x_r",
              "log_logit_n"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    fp, _ = fast.split_fast(tp)
    ids = reg_gmvae_forward(fp, *eps, *_one_hots(tb, cfg), tb["c"], cfg,
                            tokens=tb["x"], nll_targets=tb["x"],
                            track_ids=(tb["r"], tb["n"]))
    assert ids["out"] is None
    picked = -got["out"].gather(-1, tb["x"].long()[..., None])[..., 0]
    np.testing.assert_allclose(ids["nll_x"].numpy(), picked.numpy(),
                               rtol=1e-5, atol=1e-5)
    for k in ("r_out", "n_out", "z"):
        np.testing.assert_allclose(ids[k].numpy(), got[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # the fast layout without class ids: the one-hot sub-decoder route
    oh = reg_gmvae_forward(fp, *eps, *_one_hots(tb, cfg), tb["c"], cfg,
                           tokens=tb["x"], nll_targets=tb["x"])
    for k in ("r_out", "n_out"):
        np.testing.assert_allclose(oh[k].numpy(), got[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
