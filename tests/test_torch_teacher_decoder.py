"""PyTorch port, the fused teacher decoder without a head
(`ops/cuda_decoder.py::decoder_teacher_fused`, kernels 7/8) and what routes
to it, against the JAX package with its Pallas kernels in interpret mode,
at small sizes. On the CPU the port's wrapper runs its plain version, with
autograd for the backward.

Tolerances: the decode's states and log-probs to 1e-5, its gradients to
atol=2e-4, rtol=1e-3 (the JAX package's own bounds for this kernel,
tests/test_pallas_gru.py:318-343); a model forward's `out` to 1e-4; the
scheduled-sampling decode to 1e-5 (tests/test_compat.py:55-72), with the
head sharpened so that no argmax of the feedback is a near-tie.

The wrapper tests hold the routing rule for CUDA tensors on the CPU, with
the device check and the launches faked: a teacher decode with `tokens`
takes the fused decoder's kernels, through `DecoderTeacher` when a gradient
is wanted, and never the generic stacked-GRU kernels."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import gmvae as j_gmvae
from music_fader_nets_tpu.models import modules as j_modules
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import gmvae, modules
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

VAL_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _dec_case(B=4, T=9, H=8, V=11, Z=6, seed=7, sharpen=1.0):
    """Decoder params (numpy tree), z, token ids and their one-hot."""
    p = jax.tree.map(np.asarray, j_modules.global_decoder_init(
        jax.random.PRNGKey(seed), Z, V, H))
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * sharpen
    rng = np.random.default_rng(seed)
    z = _normal(rng, (B, Z))
    tok = rng.integers(0, V, size=(B, T)).astype(np.int32)
    return p, z, tok, np.eye(V, dtype=np.float32)[tok]


def _to_fast(p, V):
    g = dict(p["grucell_g"])
    w_ih = g.pop("w_ih")
    g["w_tok_p"] = np.pad(w_ih[:V], ((0, vocab_pad(V) - V), (0, 0)))
    g["w_z"] = w_ih[V:]
    return dict(p, grucell_g=g)


@pytest.mark.parametrize("layout", ["canonical", "fast"])
def test_decoder_teacher_fused_matches_jax(pallas_interpret, layout):
    """Kernel 7's function: h2_seq (B, T, H) against the interpreted Pallas
    kernel, over the canonical tree and the fast layout's padded w_tok_p."""
    V = 11
    p, z, tok, _ = _dec_case()
    if layout == "fast":
        p = _to_fast(p, V)
    pallas_gru.LAST_TRAIN_PATH = None
    want = pallas_gru.decoder_teacher_fused(p, jnp.asarray(z),
                                            jnp.asarray(tok), V)
    assert pallas_gru.LAST_TRAIN_PATH == "kernel-single"
    got = cuda_decoder.decoder_teacher_fused(
        params_from_numpy(p), torch.from_numpy(z), torch.from_numpy(tok), V)
    assert cuda_decoder.LAST_TRAIN_PATH == "plain-cpu"
    assert got.shape == (4, 9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)


def test_decoder_teacher_fused_gradients_match_jax(pallas_interpret):
    """Kernel 8's function: the gradients of every decoder weight and of z
    for the scalar sum(h2_seq * tgt), against `jax.grad` through the
    interpreted Pallas backward."""
    V, B, T, H = 11, 3, 7, 8
    p, z, tok, _ = _dec_case(B=B, T=T, seed=8)
    p = {k: v for k, v in p.items() if k != "linear_out_g"}
    tgt = _normal(np.random.default_rng(9), (B, T, H))

    def jloss(p, z):
        return jnp.sum(pallas_gru.decoder_teacher_fused(
            p, z, jnp.asarray(tok), V) * tgt)
    gp, gz = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(z))

    tp = params_from_numpy(p)
    for leaf in (t for d in tp.values() for t in d.values()):
        leaf.requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    out = cuda_decoder.decoder_teacher_fused(tp, tz, torch.from_numpy(tok),
                                             V)
    (out * torch.from_numpy(tgt)).sum().backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), **GRAD_TOL)
    for k, d in tp.items():
        for n, t in d.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k][n]),
                                       err_msg=f"{k}.{n}", **GRAD_TOL)


def test_global_decoder_teacher_with_and_without_tokens(pallas_interpret):
    """Both routes of `global_decoder_teacher` give the same log-probs, and
    the one with tokens equals the JAX package's fused route; x_oh may be
    None with tokens."""
    p, z, tok, x_oh = _dec_case()
    tp, tz = params_from_numpy(p), torch.from_numpy(z)
    plain = modules.global_decoder_teacher(tp, tz, torch.from_numpy(x_oh))
    fused = modules.global_decoder_teacher(tp, tz, None,
                                           tokens=torch.from_numpy(tok))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), **VAL_TOL)
    want = j_modules.global_decoder_teacher(
        p, jnp.asarray(z), jnp.asarray(x_oh), use_pallas=True,
        tokens=jnp.asarray(tok))
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), **VAL_TOL)


def _fake_launches(monkeypatch, T, B, H):
    """Fake a CUDA device for CPU tensors and record the launches of the
    fused teacher decoder; any generic stacked-GRU launch fails the test."""
    calls = []
    monkeypatch.setattr(cuda_gru, "kernel_device",
                        lambda ts: torch.device("cuda"))

    def fwd(*args, stash):
        calls.append(("teacher_fwd", stash))
        st = torch.zeros((T, B, 4 * H)) if stash else None
        return (torch.zeros((T, B, H)), torch.zeros((T, B, H)), st, st)

    def bwd(g2, tok_t, *args):
        assert g2.shape == (T, B, H) and g2.is_contiguous()
        calls.append(("teacher_bwd",))
        shapes = [(args[-1], 3 * H), (B, 3 * H), (H, 3 * H), (3 * H,),
                  (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (B, H)]
        return tuple(torch.full(s, float(i + 1))
                     for i, s in enumerate(shapes))

    def no_stacked(*a, **k):
        raise AssertionError("the generic stacked-GRU kernel was launched")

    monkeypatch.setattr(cuda_decoder, "_launch_teacher_fwd", fwd)
    monkeypatch.setattr(cuda_decoder, "_launch_teacher_bwd", bwd)
    monkeypatch.setattr(cuda_stacked, "_launch_fwd", no_stacked)
    return calls


@pytest.mark.parametrize("want_grad", [True, False])
def test_teacher_with_tokens_takes_the_fused_decoder(monkeypatch, want_grad):
    """The routing rule on a CUDA tensor: `global_decoder_teacher` with
    `tokens` launches the fused teacher decoder (through `DecoderTeacher`
    with its gate stashes when a gradient is wanted, whose backward hands a
    contiguous (T, B, H) cotangent to kernel 8 and returns each gradient to
    its input), not two generic stacked-GRU launches over a one-hot
    product."""
    V, B, T, H = 11, 4, 9, 8
    p, z, tok, _ = _dec_case()
    calls = _fake_launches(monkeypatch, T, B, H)
    tp = params_from_numpy(p)
    leaves = [tp["grucell_g"]["w_hh"], tp["grucell_g_2"]["b_hh"]]
    for leaf in leaves:
        leaf.requires_grad_(want_grad)
    before = dict(cuda_decoder.LAUNCHES)
    out = modules.global_decoder_teacher(tp, torch.from_numpy(z), None,
                                         tokens=torch.from_numpy(tok))
    assert out.shape == (B, T, V)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"
    assert calls == [("teacher_fwd", want_grad)]
    assert cuda_decoder.LAUNCHES["decoder_teacher"] == (
        before["decoder_teacher"] + 1)
    if not want_grad:
        assert not out.requires_grad
        return
    out.sum().backward()
    assert calls[-1] == ("teacher_bwd",)
    assert cuda_decoder.LAUNCHES["decoder_teacher_bwd"] == (
        before["decoder_teacher_bwd"] + 1)
    # the fake backward's constants: whh1 is its 3rd output, bhh2 its 8th
    assert float(leaves[0].grad.flatten()[0]) == 3.0
    assert float(leaves[1].grad.flatten()[0]) == 8.0
    assert tp["grucell_g"]["b_hh"].grad is None


def _gmvae_case(seed=0):
    cfg = dict(hidden_dims=16, z_dims=8, seq_len=12, attr_len=4)
    jcfg = JConfig(use_pallas_gru=True, **cfg)
    key = jax.random.PRNGKey(seed)
    p = j_gmvae.init_reg_gmvae(key, jcfg)
    rng = np.random.default_rng(seed)
    B = 4
    tok = rng.integers(0, 342, (B, 12)).astype(np.int32)
    r = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, 4))]
    n = np.eye(16, dtype=np.float32)[rng.integers(0, 16, (B, 4))]
    c = rng.random((B, 24)).astype(np.float32)
    return ModelConfig(**cfg), jcfg, p, tok, r, n, c


def test_gmvae_forward_with_tokens_and_no_x_oh(pallas_interpret):
    """`reg_gmvae_forward(train=True, x_oh=None, tokens=tok)` without
    `nll_targets` returns `out`, equal to the JAX forward's through kernels
    3 and 7; the noise is the JAX draw recovered as (z - mu) / std."""
    cfg, jcfg, p, tok, r, n, c = _gmvae_case()
    x_oh = np.eye(342, dtype=np.float32)[tok]
    want = j_gmvae.reg_gmvae_forward(
        p, jax.random.PRNGKey(5), jnp.asarray(x_oh), jnp.asarray(r),
        jnp.asarray(n), jnp.asarray(c), jcfg, tokens=jnp.asarray(tok))
    eps = [torch.from_numpy(np.array(
        (want[f"z_{s}"] - want[f"mu_{s}"]) / want[f"std_{s}"]))
        for s in ("r", "n")]
    got = gmvae.reg_gmvae_forward(
        params_from_numpy(jax.tree.map(np.asarray, p)), *eps, None,
        torch.from_numpy(r), torch.from_numpy(n), torch.from_numpy(c), cfg,
        train=True, tokens=torch.from_numpy(tok))
    assert got["nll_x"] is None and got["out"].shape == (4, 12, 342)
    for k in ("out", "r_out", "n_out", "mu_r", "std_n", "qy_x_r"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_scheduled_sampling_limits_and_mixed_coins():
    """`global_decoder_scheduled`: all-True coins equal the teacher decode,
    all-False the greedy decode, and a mixed coin vector equals the JAX
    decode given the coins JAX draws from its key."""
    V, Z, H, B, T = 20, 6, 12, 3, 9
    p, z, tok, x_oh = _dec_case(B=B, T=T, H=H, V=V, Z=Z, seed=0, sharpen=8.0)
    tp, tz, tx = (params_from_numpy(p), torch.from_numpy(z),
                  torch.from_numpy(x_oh))
    teacher = modules.global_decoder_teacher(tp, tz, tx)
    greedy = modules.global_decoder_greedy(tp, tz, T)
    ones = torch.ones(T, dtype=torch.bool)
    np.testing.assert_allclose(
        modules.global_decoder_scheduled(tp, tz, tx, ones).numpy(),
        teacher.numpy(), **VAL_TOL)
    np.testing.assert_allclose(
        modules.global_decoder_scheduled(tp, tz, tx, ~ones).numpy(),
        greedy.numpy(), **VAL_TOL)

    key, eps = jax.random.PRNGKey(3), 0.5
    coins = np.asarray(jax.random.uniform(key, (T,)) < eps)
    assert coins.any() and not coins.all()
    want = j_modules.global_decoder_scheduled(
        p, jnp.asarray(z), jnp.asarray(x_oh), key, eps=eps)
    got = modules.global_decoder_scheduled(tp, tz, tx,
                                           torch.from_numpy(coins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)
    assert np.abs(got.numpy() - teacher.numpy()).max() > 1e-3
