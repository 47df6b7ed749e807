"""PyTorch port, bf16 mixed precision: the training kernels' modules
(`ops/cuda_gru.py`, `ops/cuda_stacked.py`, `ops/cuda_decoder.py`) in
bfloat16 against the JAX Pallas functions they replace, called with bf16
operands in interpret mode, at small sizes: values and the gradient of
every float input. On the CPU the port's wrappers run the bf16 branches
of their plain versions, which round where the Pallas kernels write a
bf16 output ref and nowhere else.

Tolerances: values to atol=1e-2, a sixth of the JAX package's own bound
for its bf16 kernels against their scan (tests/test_pallas_gru.py:98-106,
6e-2; the NLL, a float32 output, to 1e-4); each gradient tensor to
GRAD_REL of its largest entry (one bf16 ulp is 2^-8 of a value; the
GM-VAE objective's gradients, test_torch_mixed_precision_objectives.py,
are held to the same bound and show it to lie below the JAX package's
own scan-vs-Pallas bf16 disagreement). The bf16 plain backward is also
held against autograd of the same functions in float64, which checks its
hand-written gate and head backward as mathematics.

Then the wrappers' dtype rule: float inputs must be all float32 or all
bfloat16 (a mix raises, on the CPU as on CUDA tensors), the decode
without a head (kernels 7/8), the masses head and the decode kernels
(11/12) take float32 only, and importing the port keeps bf16 products
from reducing in bf16."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.ops import cuda_decode, cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.ops import cuda_stacked
from music_fader_nets_tpu_torch.ops.gru import vocab_pad

V = 342
BF = torch.bfloat16
VAL_ATOL = 1e-2
GRAD_REL = 2e-2


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_np(a):
    """float32 values exactly representable in bf16 (RNE), so both sides
    start from the same bits."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _embed_inputs(L, T, B, H, n_ids, rows, seed, per_row_add):
    rng = np.random.default_rng(seed)
    G = 3 * H
    ids = rng.integers(0, n_ids, size=(L, T, B)).astype(np.int32)
    w_in = np.zeros((L, rows, G), np.float32)
    w_in[:, :n_ids] = _normal(rng, (L, n_ids, G), 0.3)
    add = _normal(rng, (L, B, G) if per_row_add else (L, G), 0.1)
    floats = [w_in, add, _normal(rng, (L, H, G), 0.3),
              _normal(rng, (L, G), 0.1), _normal(rng, (L, B, H), 0.5)]
    return ids, [_bf16_np(f) for f in floats], rng


def _jax_bf16(fn, ints, floats, proj):
    """fn(*ints, *floats) on bf16 operands: (out as float32, float32
    gradients of sum(out * cos(out) * proj), the output widened first)."""
    def loss(*fl):
        out = fn(*[jnp.asarray(i) for i in ints], *fl).astype(jnp.float32)
        return jnp.sum(out * jnp.cos(out) * proj), out
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(floats))), has_aux=True)(
            *[jnp.asarray(f, jnp.bfloat16) for f in floats])
    return np.asarray(out), [np.asarray(g.astype(jnp.float32))
                             for g in grads]


def _torch_run(fn, ints, floats, proj, dtype):
    ts = [torch.from_numpy(f.copy()).to(dtype).requires_grad_(True)
          for f in floats]
    out = fn(*[torch.from_numpy(i) for i in ints], *ts)
    o = out.to(torch.float64 if dtype == torch.float64 else torch.float32)
    (o * torch.cos(o) * torch.from_numpy(proj).to(o.dtype)).sum().backward()
    return out, ts


def _torch_bf16(fn, ints, floats, proj):
    out, ts = _torch_run(fn, ints, floats, proj, BF)
    assert all(t.grad.dtype == BF for t in ts)
    return out.float().detach().numpy(), [t.grad.float().numpy() for t in ts]


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _hold(got, want, got_g, want_g, names, val_atol=VAL_ATOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=val_atol)
    for name, g, w in zip(names, got_g, want_g):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= GRAD_REL, (name, _rel(g, w))


def _hold_float64(fn, ints, floats, proj, names):
    """The bf16 plain backward against autograd of the same function in
    float64 on the bf16 inputs: the roundings apart (GRAD_REL), the same
    gradients."""
    _, want_g = _torch_run(fn, ints, floats, proj, torch.float64)
    _, got_g = _torch_bf16(fn, ints, floats, proj)
    for name, g, w in zip(names, got_g, want_g):
        assert _rel(g, w.grad.numpy()) <= GRAD_REL, name


EMBED_NAMES = ("w_ih", "b_ih", "w_hh", "b_hh", "h0")


def test_embed_finals_bf16_matches_jax(pallas_interpret):
    """Kernels 3t (training variant, gate stash) and 4 in bf16: the
    encoder's final states (bf16) and the gradients of w_ih, b_ih, w_hh,
    b_hh, h0 (bf16)."""
    L, T, B, H = 4, 7, 3, 32
    ids, floats, rng = _embed_inputs(L, T, B, H, V, vocab_pad(V), 0, False)
    proj = _normal(rng, (L, B, H), 1.0)
    want, want_g = _jax_bf16(pallas_gru.stacked_gru_embed_finals, [ids],
                             floats, proj)
    got, got_g = _torch_bf16(cuda_gru.stacked_gru_embed_finals, [ids],
                             floats, proj)
    assert cuda_gru.LAST_TRAIN_PATH == "plain-cpu"
    _hold(got, want, got_g, want_g, EMBED_NAMES)
    assert not got_g[0][:, V:].any()
    _hold_float64(cuda_gru.stacked_gru_embed_finals, [ids], floats, proj,
                  EMBED_NAMES)


def test_embed_finals_serving_bf16_matches_jax(pallas_interpret):
    """Kernel 3 (finals, no gradient) in bf16, as the validation pass runs
    it: bf16 finals, the forward on the float32 carry."""
    L, T, B, H = 4, 7, 3, 32
    ids, floats, _ = _embed_inputs(L, T, B, H, V, vocab_pad(V), 2, False)
    want = pallas_gru.stacked_gru_embed_finals(
        jnp.asarray(ids), *[jnp.asarray(f, jnp.bfloat16) for f in floats])
    with torch.no_grad():
        got = cuda_gru.stacked_gru_embed_finals(
            torch.from_numpy(ids), *[torch.from_numpy(f).to(BF)
                                     for f in floats])
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=VAL_ATOL)


def test_embed_seq_bf16_matches_jax(pallas_interpret):
    """Kernels 5 and 6 in bf16: the sub-decoders' h_seq and the gradients
    of w_emb, prez, w_hh, b_hh and h0; the JAX side's class table padded
    to Cp = 128 rows, the port's 16 (the first 16 rows compared)."""
    L, T, B, H, C = 2, 8, 4, 32, 16
    ids, floats, rng = _embed_inputs(L, T, B, H, C, 128, 1, True)
    ids[0] %= 3
    proj = _normal(rng, (L, T, B, H), 1.0)
    want, want_g = _jax_bf16(pallas_gru.stacked_gru_embed_seq, [ids],
                             floats, proj)
    small = [floats[0][:, :C]] + floats[1:]
    got, got_g = _torch_bf16(cuda_gru.stacked_gru_embed_seq, [ids], small,
                             proj)
    want_g[0] = want_g[0][:, :C]
    _hold(got, want, got_g, want_g, ("w_emb", "prez", "w_hh", "b_hh", "h0"))
    assert not got_g[0][0, 3:].any()
    _hold_float64(cuda_gru.stacked_gru_embed_seq, [ids], small, proj,
                  ("w_emb", "prez", "w_hh", "b_hh", "h0"))


def test_stacked_gru_bf16_matches_jax(pallas_interpret):
    """Kernels 1 and 2 in bf16 (the CVAE encoder's generic stacked GRU):
    h_seq and the gradients of pre, w_hh, b_hh and h0. The port's
    backward reads the forward's bf16 gate stash where the Pallas kernel 2
    recomputes its gates in float32 from the rounded h_seq; the bound
    covers both."""
    L, T, B, H = 2, 9, 3, 32
    rng = np.random.default_rng(3)
    G = 3 * H
    floats = [_bf16_np(f) for f in (
        _normal(rng, (L, T, B, G), 0.5), _normal(rng, (L, H, G), 0.3),
        _normal(rng, (L, G), 0.1), _normal(rng, (L, B, H), 0.5))]
    proj = _normal(rng, (L, T, B, H), 1.0)
    want, want_g = _jax_bf16(pallas_gru.stacked_gru_pallas, [], floats,
                             proj)
    got, got_g = _torch_bf16(cuda_stacked.stacked_gru, [], floats, proj)
    assert cuda_stacked.LAST_TRAIN_PATH == "plain-cpu"
    names = ("pre", "w_hh", "b_hh", "h0")
    _hold(got, want, got_g, want_g, names)
    _hold_float64(cuda_stacked.stacked_gru, [], floats, proj, names)


def _decoder_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    Vp, G = vocab_pad(V), 3 * H
    tok = rng.integers(0, V, size=(T, B)).astype(np.int32)
    tgt = rng.integers(0, V, size=(T, B)).astype(np.int32)
    w_tok = np.zeros((Vp, G), np.float32)
    w_tok[:V] = _normal(rng, (V, G), 0.3)
    b_out = np.full((Vp,), -1e30, np.float32)
    b_out[:V] = _normal(rng, (V,), 0.1)
    floats = [w_tok, _normal(rng, (B, G), 0.1)]
    for _ in range(3):
        floats += [_normal(rng, (H, G), 0.3), _normal(rng, (G,), 0.1)]
    floats += [_normal(rng, (B, H), 0.5), _normal(rng, (H, Vp), 0.3), b_out]
    return tok, tgt, [_bf16_np(f) for f in floats], rng


DEC_NAMES = ("w_tok", "pre_z", "whh1", "bhh1", "wih2", "bih2", "whh2",
             "bhh2", "h1_0", "w_out", "b_out")


def test_decoder_ce_bf16_matches_jax(pallas_interpret):
    """Kernels 9 and 10 with the CE head in bf16: the per-position NLL
    (float32, the head in float32 from the float32 states inside the
    kernel) and the gradients of the eleven float inputs (the head's from
    the bf16-rounded h2_seq)."""
    T, B, H = 6, 4, 32
    tok, tgt, floats, rng = _decoder_inputs(T, B, H, 4)
    proj = _normal(rng, (T, B), 1.0)

    def j_fn(tok_, tgt_, *fl):
        return pallas_gru._dec_nll_core(tok_, tgt_, *fl[:9], tuple(fl[9:]))

    want, want_g = _jax_bf16(j_fn, [tok, tgt], floats, proj)
    got, got_g = _torch_bf16(cuda_decoder.decoder_teacher_nll, [tok, tgt],
                             floats, proj)
    assert cuda_decoder.LAST_TRAIN_PATH == "plain-cpu"
    _hold(got, want, got_g, want_g, DEC_NAMES, val_atol=1e-4)
    # the pad lanes of the head: no gradient at all
    assert not got_g[-2][:, V:].any() and not got_g[-1][V:].any()
    _hold_float64(cuda_decoder.decoder_teacher_nll, [tok, tgt], floats,
                  proj, DEC_NAMES)


def _stacked_args(dtypes):
    L, T, B, H = 1, 3, 2, 8
    shapes = ((L, T, B, 3 * H), (L, H, 3 * H), (L, 3 * H), (L, B, H))
    return [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("faked_cuda", [False, True])
def test_wrappers_refuse_mixed_float_dtypes(monkeypatch, faked_cuda):
    """float32 or bfloat16 on all float inputs together: a mix raises, on
    the CPU and (device check faked) on CUDA tensors, before any launch."""
    if faked_cuda:
        monkeypatch.setattr(cuda_gru, "kernel_device",
                            lambda ts: torch.device("cuda"))
    f32, bf = torch.float32, BF
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        cuda_stacked.stacked_gru(*_stacked_args((bf, f32, bf, bf)))
    L, T, B, H = 2, 3, 2, 8
    ids = torch.zeros((L, T, B), dtype=torch.int32)
    emb = [torch.zeros(s, dtype=d) for s, d in zip(
        ((L, 16, 3 * H), (L, 3 * H), (L, H, 3 * H), (L, 3 * H), (L, B, H)),
        (bf, bf, bf, f32, bf))]
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        cuda_gru.stacked_gru_embed_finals(ids, *emb)
    emb[1] = torch.zeros((L, B, 3 * H), dtype=bf)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        cuda_gru.stacked_gru_embed_seq(ids, *emb)
    tok, tgt, floats, _ = _decoder_inputs(2, 2, 8, 5)
    ts = [torch.from_numpy(f).to(bf) for f in floats]
    ts[4] = ts[4].float()
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        cuda_decoder.decoder_teacher_nll(torch.from_numpy(tok),
                                         torch.from_numpy(tgt), *ts)


@pytest.mark.parametrize("faked_cuda", [False, True])
def test_float32_only_kernels_refuse_bf16(monkeypatch, faked_cuda):
    """Rows 7/8 (the decode without a head) and 9/10 with the masses head
    raise on bf16 (no bf16 caller reaches them in the JAX package), naming
    ROADMAP; the decode kernels (rows 11/12) take float32 only."""
    if faked_cuda:
        monkeypatch.setattr(cuda_gru, "kernel_device",
                            lambda ts: torch.device("cuda"))
    tok, _, floats, _ = _decoder_inputs(2, 2, 8, 6)
    ts = [torch.from_numpy(f).to(BF) for f in floats]
    tok_t = torch.from_numpy(tok)
    with pytest.raises(ValueError, match="float32 only.*ROADMAP"):
        cuda_decoder.decoder_teacher(tok_t, *ts[:9])
    with pytest.raises(ValueError, match="float32 only.*ROADMAP"):
        cuda_decoder.decoder_teacher_masses(tok_t, *ts, [(0, 2)], 1)
    # the decode's arguments: w_tok, the two cells, the head, pre_z, h1_0
    args = tuple(ts[i] for i in (0, 2, 3, 4, 5, 6, 7, 9, 10, 1, 8))
    with pytest.raises(ValueError, match="float32.*ROADMAP"):
        cuda_decode._launch(args, V, ts[0].shape[0], 3)


def test_port_import_keeps_bf16_reductions_in_float32():
    """Importing the port turns TF32 off and keeps cuBLAS from reducing
    bf16 split-K partials in bf16, so a bf16 product outside the kernels
    rounds once, as XLA's does."""
    import music_fader_nets_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            is False)
