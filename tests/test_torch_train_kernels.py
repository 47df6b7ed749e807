"""PyTorch port, training kernels' modules (`ops/cuda_gru.py`,
`ops/cuda_decoder.py`) against the JAX Pallas functions they replace, run
in interpret mode, at small sizes: values and the gradient of every float
input. On the CPU the port's wrappers run their plain versions, with
autograd for the backward.

Tolerances: values to 1e-5 (float32, two summation orders); encoder and
sub-decoder gradients to atol=2e-4, rtol=1e-3 (the JAX package's own bound
for its embed kernels, tests/test_pallas_gru.py:245); decoder NLL and its
gradients to atol=3e-4, rtol=2e-3 (tests/test_pallas_gru.py:434).

The last tests hold the wrappers' rule for CUDA tensors on the CPU, with
the device check and the launches faked: a call whose inputs want a
gradient goes through the autograd Function, whose backward returns each
gradient to the input it belongs to, and nothing else."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import vocab_pad

V = 342
VAL_TOL = dict(rtol=0, atol=1e-5)
EMBED_GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
DEC_TOL = dict(atol=3e-4, rtol=2e-3)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _embed_inputs(L, T, B, H, n_ids, rows, seed, per_row_add):
    """ids (L, T, B) int32 in [0, n_ids), weights with `rows` input rows
    (pad rows zero), the additive term (L, 3H) or per row (L, B, 3H), h0,
    and a fixed projection for the loss."""
    rng = np.random.default_rng(seed)
    G = 3 * H
    ids = rng.integers(0, n_ids, size=(L, T, B)).astype(np.int32)
    w_in = np.zeros((L, rows, G), np.float32)
    w_in[:, :n_ids] = _normal(rng, (L, n_ids, G), 0.3)
    add = _normal(rng, (L, B, G) if per_row_add else (L, G), 0.1)
    w_hh = _normal(rng, (L, H, G), 0.3)
    b_hh = _normal(rng, (L, G), 0.1)
    h0 = _normal(rng, (L, B, H), 0.5)
    return ids, [w_in, add, w_hh, b_hh, h0], rng


def _jax_value_and_grads(fn, ids, floats, proj):
    def loss(*fl):
        out = fn(jnp.asarray(ids), *fl)
        return jnp.sum(out * jnp.cos(out) * proj), out
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(floats))), has_aux=True)(
            *[jnp.asarray(f) for f in floats])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, ids, floats, proj):
    ts = [torch.from_numpy(f.copy()).requires_grad_(True) for f in floats]
    out = fn(torch.from_numpy(ids), *ts)
    (out * torch.cos(out) * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def test_embed_finals_values_and_grads_match_jax(pallas_interpret):
    """Kernels 3 (training variant) and 4: the encoder's final states and
    the gradients of w_ih, b_ih, w_hh, b_hh and h0."""
    L, T, B, H = 4, 7, 3, 32
    ids, floats, rng = _embed_inputs(L, T, B, H, V, vocab_pad(V), 0, False)
    proj = _normal(rng, (L, B, H), 1.0)
    want, want_g = _jax_value_and_grads(pallas_gru.stacked_gru_embed_finals,
                                        ids, floats, proj)
    got, got_g = _torch_value_and_grads(cuda_gru.stacked_gru_embed_finals,
                                        ids, floats, proj)
    assert cuda_gru.LAST_TRAIN_PATH == "plain-cpu"
    np.testing.assert_allclose(got, want, **VAL_TOL)
    for name, g, w in zip(("w_ih", "b_ih", "w_hh", "b_hh", "h0"), got_g,
                          want_g):
        np.testing.assert_allclose(g, w, err_msg=name, **EMBED_GRAD_TOL)
    # pad rows are never selected: exactly zero gradient
    assert not got_g[0][:, V:].any()


def test_embed_seq_values_and_grads_match_jax(pallas_interpret):
    """Kernels 5 and 6: the sub-decoders' h_seq and the gradients of w_emb,
    prez, w_hh, b_hh and h0, with the class table padded to Cp = 128 rows
    as the JAX path pads it."""
    L, T, B, H, C = 2, 8, 4, 32, 16
    ids, floats, rng = _embed_inputs(L, T, B, H, C, 128, 1, True)
    proj = _normal(rng, (L, T, B, H), 1.0)
    want, want_g = _jax_value_and_grads(pallas_gru.stacked_gru_embed_seq,
                                        ids, floats, proj)
    got, got_g = _torch_value_and_grads(cuda_gru.stacked_gru_embed_seq,
                                        ids, floats, proj)
    assert got.shape == (L, T, B, H)
    np.testing.assert_allclose(got, want, **VAL_TOL)
    for name, g, w in zip(("w_emb", "prez", "w_hh", "b_hh", "h0"), got_g,
                          want_g):
        np.testing.assert_allclose(g, w, err_msg=name, **EMBED_GRAD_TOL)
    assert not got_g[0][:, C:].any()


def _decoder_params(H, Zt, seed):
    from music_fader_nets_tpu.models.modules import global_decoder_init
    p = global_decoder_init(jax.random.PRNGKey(seed), Zt, V, H)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("layout", ["canonical", "fast"])
def test_decoder_nll_values_and_grads_match_jax(pallas_interpret, layout):
    """Kernels 9 and 10 through `decoder_teacher_fused_nll`: the per-
    position NLL (B, T) and the gradients of every decoder weight and of z,
    over the canonical tree or the fast layout's split, padded w_tok_p."""
    from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy
    H, Zt, B, T = 32, 20, 3, 6
    p = _decoder_params(H, Zt, 2)
    if layout == "fast":
        g = dict(p["grucell_g"])
        w_ih = g.pop("w_ih")
        g["w_tok_p"] = np.pad(w_ih[:V], ((0, vocab_pad(V) - V), (0, 0)))
        g["w_z"] = w_ih[V:]
        p = dict(p, grucell_g=g)
    rng = np.random.default_rng(3)
    z = _normal(rng, (B, Zt), 1.0)
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    proj = _normal(rng, (B, T), 1.0)

    def jloss(p, z):
        nll = pallas_gru.decoder_teacher_fused_nll(p, z, jnp.asarray(tokens),
                                                   V)
        return jnp.sum(nll * proj), nll
    (_, want), (gp, gz) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(p, z)

    tp = params_from_numpy(p)
    for leaf in (t for d in tp.values() for t in d.values()):
        leaf.requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    got = cuda_decoder.decoder_teacher_fused_nll(tp, tz,
                                                 torch.from_numpy(tokens), V)
    assert cuda_decoder.LAST_TRAIN_PATH == "plain-cpu"
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **DEC_TOL)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), **DEC_TOL)
    for k, d in tp.items():
        for n, t in d.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k][n]),
                                       err_msg=f"{k}.{n}", **DEC_TOL)
    if layout == "fast":
        assert not tp["grucell_g"]["w_tok_p"].grad[V:].any()


# ---------------------------------------------------------------- wrappers

class _Fake:
    """Fakes a CUDA device for CPU tensors and records which launch ran;
    the backward launch returns constants 1, 2, ... so a test can tell
    which input each gradient reached."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(cuda_gru, "kernel_device",
                            lambda ts: torch.device("cuda"))

    def consts(self, shapes):
        return tuple(None if s is None else torch.full(s, float(i + 1))
                     for i, s in enumerate(shapes))


def _grads_by_input(out, inputs):
    out.sum().backward()
    return [None if t.grad is None else float(t.grad.flatten()[0])
            for t in inputs]


@pytest.mark.parametrize("want_grad", [True, False])
def test_embed_finals_wrapper_differentiates_or_serves(monkeypatch,
                                                       want_grad):
    """On a CUDA tensor, `stacked_gru_embed_finals` with a gradient wanted
    goes through `EmbedFinals` (training kernels; its output is on the
    graph and every asked-for input gets its own gradient); without one,
    the serving kernel runs. Before the repair, the serving kernel ran in
    both cases and the encoder's weights got no gradient."""
    fake = _Fake(monkeypatch)
    L, T, B, H = 2, 3, 2, 4
    ids, floats, _ = _embed_inputs(L, T, B, H, 5, 8, 4, False)

    def train_fwd(ids_, w_in, add, w_hh, b_hh, h0, stash):
        fake.calls.append(("train", stash))
        return (torch.zeros((L, T, B, H)),
                torch.zeros((L, T, B, 4 * H)) if stash else None)

    def bwd(ids_, g, seq_grad, stash, h_seq, h0, w_hh, Vr, want_db_in,
            want_dprez):
        fake.calls.append(("bwd", seq_grad))
        assert want_db_in and not want_dprez
        return fake.consts([(L, Vr, 3 * H), (L, 3 * H), None, (L, H, 3 * H),
                            (L, 3 * H), (L, B, H)])

    def serve(*args):
        fake.calls.append(("serve",))
        return torch.zeros((L, B, H))

    monkeypatch.setattr(cuda_gru, "_launch_train_fwd", train_fwd)
    monkeypatch.setattr(cuda_gru, "_launch_bwd", bwd)
    monkeypatch.setattr(cuda_gru, "_launch_finals", serve)
    ts = [torch.from_numpy(f) for f in floats]
    # h0 wants no gradient: its slot must come back empty
    for t in ts[:4]:
        t.requires_grad_(want_grad)
    out = cuda_gru.stacked_gru_embed_finals(torch.from_numpy(ids), *ts)
    assert cuda_gru.LAST_ENCODE_PATH == "kernel"
    if not want_grad:
        assert fake.calls == [("serve",)] and not out.requires_grad
        return
    assert fake.calls == [("train", True)] and out.requires_grad
    assert cuda_gru.LAST_TRAIN_PATH == "kernel"
    assert _grads_by_input(out, ts) == [1.0, 2.0, 4.0, 5.0, None]
    assert fake.calls[-1] == ("bwd", False)


def test_embed_seq_wrapper_differentiates(monkeypatch):
    fake = _Fake(monkeypatch)
    L, T, B, H = 2, 3, 2, 4
    ids, floats, _ = _embed_inputs(L, T, B, H, 3, 8, 5, True)

    def train_fwd(ids_, w_in, add, w_hh, b_hh, h0, stash):
        fake.calls.append(("train", stash))
        return (torch.zeros((L, T, B, H)),
                torch.zeros((L, T, B, 4 * H)) if stash else None)

    def bwd(ids_, g, seq_grad, stash, h_seq, h0, w_hh, Vr, want_db_in,
            want_dprez):
        fake.calls.append(("bwd", seq_grad))
        assert want_dprez and not want_db_in
        return fake.consts([(L, Vr, 3 * H), None, (L, B, 3 * H),
                            (L, H, 3 * H), (L, 3 * H), (L, B, H)])

    monkeypatch.setattr(cuda_gru, "_launch_train_fwd", train_fwd)
    monkeypatch.setattr(cuda_gru, "_launch_bwd", bwd)
    ts = [torch.from_numpy(f).requires_grad_(True) for f in floats]
    out = cuda_gru.stacked_gru_embed_seq(torch.from_numpy(ids), *ts)
    assert fake.calls == [("train", True)] and out.requires_grad
    assert _grads_by_input(out, ts) == [1.0, 3.0, 4.0, 5.0, 6.0]
    assert fake.calls[-1] == ("bwd", True)
    with torch.no_grad():
        cuda_gru.stacked_gru_embed_seq(torch.from_numpy(ids), *ts)
    assert fake.calls[-1] == ("train", False)


def test_decoder_wrapper_differentiates(monkeypatch):
    fake = _Fake(monkeypatch)
    T, B, H, Vp = 3, 2, 4, 8
    G = 3 * H
    rng = np.random.default_rng(6)
    tok = torch.from_numpy(rng.integers(0, 6, (T, B)).astype(np.int32))
    shapes = [(Vp, G), (B, G), (H, G), (G,), (H, G), (G,), (H, G), (G,),
              (B, H), (H, Vp), (Vp,)]
    fl = [torch.from_numpy(_normal(rng, s, 0.1)) for s in shapes]

    def fwd(*args, stash):
        fake.calls.append(("fwd", stash))
        st = torch.zeros((T, B, 4 * H)) if stash else None
        return (torch.zeros((T, B)), torch.zeros((T, B, H)),
                torch.zeros((T, B, H)), st, st)

    def bwd(g, *args):
        fake.calls.append(("bwd",))
        return fake.consts(shapes)

    monkeypatch.setattr(cuda_decoder, "_launch_fwd", fwd)
    monkeypatch.setattr(cuda_decoder, "_launch_bwd", bwd)
    for t in fl[:-1]:
        t.requires_grad_(True)
    out = cuda_decoder.decoder_teacher_nll(tok, tok, *fl)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"
    assert fake.calls == [("fwd", True)] and out.requires_grad
    assert _grads_by_input(out, fl) == [float(i) for i in range(1, 11)] + [
        None]
    with torch.no_grad():
        cuda_decoder.decoder_teacher_nll(tok, tok, *fl)
    assert fake.calls[-1] == ("fwd", False)
