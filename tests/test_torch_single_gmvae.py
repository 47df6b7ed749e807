"""PyTorch port, the single-encoder GM-VAE
(`models/gmvae.py::single_gmvae_forward`) against the JAX package's, at a
small size: train and eval forwards, canonical tree and fast layout, with
and without token ids (with them the JAX side runs its Pallas kernels 3
and 7 in interpret mode, the port their plain versions), every output key
to 1e-4 (float32, two summation orders over 12 steps), and the gradients
of a scalar of `out` and `qy_x` to atol=2e-4, rtol=1e-3 (the bound of the
kernels' own gradient tests). The noise is the JAX draw, recovered as
(z - mu) / std."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import fast as j_fast
from music_fader_nets_tpu.models import gmvae as j_gmvae
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import fast, gmvae
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

DIMS = dict(hidden_dims=16, z_dims=6, seq_len=12, attr_len=4,
            num_clusters=3)
TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
KEYS = ("out", "mu", "std", "z", "log_logit", "qy_x", "y")


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _case(seed=0, B=4):
    p = j_gmvae.init_single_gmvae(jax.random.PRNGKey(seed), JConfig(**DIMS))
    tok = np.random.default_rng(seed).integers(
        0, 342, (B, DIMS["seq_len"])).astype(np.int32)
    return p, tok, np.eye(342, dtype=np.float32)[tok]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_init_has_the_jax_tree():
    want = jax.tree.map(np.asarray, _case()[0])
    got = gmvae.init_single_gmvae(torch.Generator().manual_seed(0),
                                  ModelConfig(**DIMS))
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert set(a) == set(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape, k
    # one table, pow_exp = -1: logvar = -2 everywhere
    assert torch.all(got["logvar_lookup"] == -2.0)
    np.testing.assert_array_equal(want["logvar_lookup"], -2.0)
    back = params_to_numpy(params_from_numpy(want))
    for k, v in _leaves(back):
        np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", ["canonical", "fast"])
@pytest.mark.parametrize("with_tokens", [False, True])
def test_single_gmvae_forward_matches_jax(pallas_interpret, train, layout,
                                          with_tokens):
    p, tok, x_oh = _case()
    jcfg = JConfig(use_pallas_gru=with_tokens, **DIMS)
    jp = j_fast.split_fast(p)[0] if layout == "fast" else p
    want = j_gmvae.single_gmvae_forward(
        jp, jax.random.PRNGKey(3), jnp.asarray(x_oh), jcfg, train=train,
        tokens=jnp.asarray(tok) if with_tokens else None)
    eps = torch.from_numpy(np.array((want["z"] - want["mu"]) / want["std"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    if layout == "fast":
        tp = fast.split_fast(tp)[0]
        assert "enc_1" in tp and "w_tok_p" in tp["grucell_g"]
    got = gmvae.single_gmvae_forward(
        tp, eps, None if with_tokens else torch.from_numpy(x_oh),
        ModelConfig(**DIMS), train=train,
        tokens=torch.from_numpy(tok) if with_tokens else None)
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert got["out"].shape == (4, 12, 342)


def test_single_gmvae_gradients_match_jax(pallas_interpret):
    """d/dparams of sum(out * w) + sum(qy_x * v) through the token route
    (kernels 3/4 and 7/8 on the JAX side), with the noise held fixed."""
    p, tok, x_oh = _case(seed=1, B=3)
    jcfg = JConfig(use_pallas_gru=True, **DIMS)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 12, 342)).astype(np.float32)
    v = rng.standard_normal((3, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def jloss(p):
        f = j_gmvae.single_gmvae_forward(p, key, jnp.asarray(x_oh), jcfg,
                                         tokens=jnp.asarray(tok))
        return jnp.sum(f["out"] * w) + jnp.sum(f["qy_x"] * v), f
    (_, f), grads = jax.value_and_grad(jloss, has_aux=True)(p)
    # reparameterize draws eps from the key alone: the same in every call
    eps = torch.from_numpy(np.array((f["z"] - f["mu"]) / f["std"]))

    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    leaves = dict(_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    got = gmvae.single_gmvae_forward(tp, eps, None, ModelConfig(**DIMS),
                                     tokens=torch.from_numpy(tok))
    ((got["out"] * torch.from_numpy(w)).sum()
     + (got["qy_x"] * torch.from_numpy(v)).sum()).backward()
    want = dict(_leaves(jax.tree.map(np.asarray, grads)))
    for name, t in leaves.items():
        g = np.zeros(t.shape, np.float32) if t.grad is None else \
            t.grad.numpy()
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)
    # the frozen table and the unused layer take no gradient
    assert leaves["logvar_lookup"].grad is None
    assert not want["linear_init/w"].any()
    assert np.abs(want["mu_lookup"]).max() > 0
