"""PyTorch port, the schedule of the forward chain kernel
(`csrc/gru_fwd_chain.cu`, driven by `csrc/decoder_ce.cu::
launch_decoder_recurrence` and `csrc/stacked_gru.cu::fader_stacked_gru`)
written out in plain PyTorch and held against the JAX package, Pallas
kernels in interpret mode, at a small size (H=32, T=8).

The kernels run the two-layer teacher decode as four parts, not step by
step with the layers interleaved as the reference's kernel does
(`music_fader_nets_tpu/ops/pallas_gru.py::_dec_fwd_ce_kernel` :1482):

1. layer 1's chain alone, over the gathered rows w_tok[tok[t]] + pre_z:
   teacher forcing fixes every layer-1 input in advance;
2. layer 2's input projection pre2x = h1_seq @ w_ih2 as one product over
   all steps;
3. layer 2's chain alone over pre2x + b_ih2, starting from h1_seq[0] (the
   reference's step-0 rule: layer 2's previous state at t = 0 is layer 1's
   new one, the `jnp.where(t == 0, h1n, h2_c)` before `pre2`);
4. the head over all T*B rows.

Here that schedule's h1_seq, h2_seq, gate stashes, NLL and masses are held
at atol=1e-4 (float32, other summation orders) to the JAX package's
`decoder_teacher_fused_nll`, `decoder_teacher_fused_masses` (n_rep 1 and 4)
and `decoder_teacher_fused` and to their Pallas kernels' own stashes; its
stash is fed to the backward schedule of
`tests/test_torch_decoder_bwd_schedule.py`, whose gradients are held to the
JAX VJP. Layer 2's chain started from zeros or from h1_0 misses the
reference. Kernel 1 is the single-chain form over rows in memory, held to
`stacked_gru_pallas` at L=2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.models.modules import global_decoder_init
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.losses.regularizers import GLSR_MASK_RANGES
from music_fader_nets_tpu_torch.ops import cuda_decoder
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy
from test_torch_decoder_bwd_schedule import _head_dh2
from test_torch_decoder_bwd_schedule import _schedule as _bwd_schedule

V = 342
H, Zt, T = 32, 20, 8
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _chain(xpre, w_hh, b_hh, h0):
    """One GRU chain over its input projections xpre (T, B, 3H) from h0
    (B, H): h_seq (T, B, H) and the gate stash [r, z, n, hn] (T, B, 4H),
    hn the n-section of the hidden projection."""
    hid = w_hh.shape[0]
    h, hs, stash = h0, [], []
    for t in range(xpre.shape[0]):
        ph = h @ w_hh + b_hh
        xr, xz, xn = xpre[t].split(hid, dim=-1)
        hr, hz, hn = ph.split(hid, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        hs.append(h)
        stash.append(torch.cat([r, z, n, hn], dim=-1))
    return torch.stack(hs), torch.stack(stash)


def _schedule(tok_t, weights, start="h1_seq[0]"):
    """The kernels' recurrence in its parts 1-3: (h1_seq, h2_seq, g41,
    g42). tok_t (T, B0) is shared by the n_rep = B / B0 row copies;
    `start` is layer 2's first previous state."""
    (w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0) = weights
    n_rep = pre_z.shape[0] // tok_t.shape[1]
    tok = tok_t.repeat(1, n_rep).long()
    # 1. layer 1
    h1_seq, g41 = _chain(w_tok[tok] + pre_z, whh1, bhh1, h1_0)
    # 2. layer 2's input projection, one product over all T*B rows
    steps, rows, hid = h1_seq.shape
    pre2x = (h1_seq.reshape(-1, hid) @ wih2).reshape(steps, rows, 3 * hid)
    # 3. layer 2
    h2_0 = {"h1_seq[0]": h1_seq[0], "zeros": torch.zeros_like(h1_0),
            "h1_0": h1_0}[start]
    h2_seq, g42 = _chain(pre2x + bih2, whh2, bhh2, h2_0)
    return h1_seq, h2_seq, g41, g42


def _head(h2_seq, w_out, b_out, head, tgt_t):
    """4. the head over all rows: NLL (T, B) or masses (T, K, B)."""
    logits = h2_seq @ w_out + b_out
    if head == "ce":
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, tgt_t.long()[..., None])[..., 0])
    p = torch.softmax(logits, -1)
    return torch.stack([p[..., lo:hi].sum(-1) for lo, hi in GLSR_MASK_RANGES],
                       dim=1)


def _inputs(head, n_rep, seed=11):
    """(JAX params, z (B, Zt), tokens (B0, T)) of a case."""
    B0 = 3
    p = jax.tree.map(np.asarray, global_decoder_init(
        jax.random.PRNGKey(seed), Zt, V, H))
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((n_rep * B0, Zt)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B0, T)).astype(np.int32)
    return p, z, tokens


def _jax_kernel(args, head, n_rep):
    """The JAX Pallas forward with its stashes: (h1_seq, h2_seq, head out
    (T, K, B) or None, g41, g42)."""
    j = [jnp.asarray(a.detach().numpy()) for a in args]
    if head == "none":
        h1, h2, g41, g42 = pallas_gru._dec_fwd_pallas(j[0], *j[2:11],
                                                      stash_gates=True)
        return h1, h2, None, g41, g42
    return pallas_gru._dec_fwd_ce_pallas(
        *j, stash_gates=True, head="ce" if head == "ce" else GLSR_MASK_RANGES,
        n_rep=n_rep)


CASES = [("ce", 1), ("masses", 1), ("masses", 4), ("none", 1)]


@pytest.mark.parametrize("head,n_rep", CASES)
def test_four_part_forward_matches_jax(pallas_interpret, head, n_rep):
    p, z, tokens = _inputs(head, n_rep)
    tp = params_from_numpy(p)
    tz, tok = torch.from_numpy(z), torch.from_numpy(tokens)
    with torch.no_grad():
        if head == "none":
            tok_t, weights = cuda_decoder._recurrence_args(tp, tz, tok, V)
            w_head = []
        else:
            tok_t, weights = cuda_decoder._fused_args(tp, tz, tok, V)
            weights, w_head = weights[:-2], list(weights[-2:])
        h1_seq, h2_seq, g41, g42 = _schedule(tok_t, weights)
        tgt_t = tok.t()
    # the Pallas kernel's own outputs and stashes
    j_h1, j_h2, j_out, j_g41, j_g42 = _jax_kernel(
        [tok_t, tgt_t.int(), *weights, *w_head], head, n_rep)
    for name, got, want in (("h1_seq", h1_seq, j_h1), ("h2_seq", h2_seq, j_h2),
                            ("g41", g41, j_g41), ("g42", g42, j_g42)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    # the head against the kernel's, then each result against the public
    # function's (B, T[, H]) or (B, K, T)
    jz, jtok = jnp.asarray(z), jnp.asarray(tokens)
    if head == "ce":
        out = _head(h2_seq, *w_head, head, tgt_t)                  # (T, B)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[:, 0],
                                   **TOL)
        got, want = out.t(), pallas_gru.decoder_teacher_fused_nll(
            p, jz, jtok, V)
    elif head == "masses":
        out = _head(h2_seq, *w_head, head, None)                   # (T, K, B)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
        got, want = out.permute(2, 1, 0), jnp.stack(
            pallas_gru.decoder_teacher_fused_masses(
                p, jz, jtok, V, GLSR_MASK_RANGES, n_rep=n_rep), axis=1)
    else:
        got, want = h2_seq.transpose(0, 1), pallas_gru.decoder_teacher_fused(
            p, jz, jtok, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head,n_rep", CASES)
def test_forward_stash_feeds_the_backward_schedule(pallas_interpret, head,
                                                   n_rep):
    """The stash the four-part forward writes, [r, z, n, hn] a step in the
    layout the backward chains read, drives the backward schedule to the
    JAX VJP of the fused decoder."""
    p, z, tokens = _inputs(head, n_rep, seed=21)
    B = z.shape[0]
    rng = np.random.default_rng(22)
    if head == "ce":
        cot = rng.standard_normal((B, T)).astype(np.float32)
        jfn = (lambda p, z: pallas_gru.decoder_teacher_fused_nll(
            p, z, jnp.asarray(tokens), V))
        g = torch.from_numpy(cot).t()
    elif head == "masses":
        cot = tuple(rng.standard_normal((B, T)).astype(np.float32)
                    for _ in GLSR_MASK_RANGES)
        jfn = (lambda p, z: pallas_gru.decoder_teacher_fused_masses(
            p, z, jnp.asarray(tokens), V, GLSR_MASK_RANGES, n_rep=n_rep))
        g = torch.stack([torch.from_numpy(c).t() for c in cot], dim=1)
    else:
        cot = rng.standard_normal((B, T, H)).astype(np.float32)
        jfn = (lambda p, z: pallas_gru.decoder_teacher_fused(
            p, z, jnp.asarray(tokens), V))
        g = torch.from_numpy(cot).transpose(0, 1)
    _, vjp = jax.vjp(jfn, p, jnp.asarray(z))
    want_p, want_z = vjp(cot)

    tp = params_from_numpy(p)
    for d in tp.values():
        for t in d.values():
            t.requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    tok = torch.from_numpy(tokens)
    if head == "none":
        tok_t, weights = cuda_decoder._recurrence_args(tp, tz, tok, V)
    else:
        tok_t, weights = cuda_decoder._fused_args(tp, tz, tok, V)
    with torch.no_grad():
        plain = [w.detach() for w in weights]
        rec = plain if head == "none" else plain[:-2]
        fwd = _schedule(tok_t, rec)
        if head == "none":
            grads = _bwd_schedule(tok_t, rec, g, fwd)
        else:
            dh2_head, head_grads = _head_dh2(fwd[1], *plain[-2:], head, g,
                                             tok.t())
            grads = _bwd_schedule(tok_t, rec, dh2_head, fwd) + head_grads
    torch.autograd.backward(list(weights), list(grads))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_z), **TOL)
    for k, d in tp.items():
        for n, t in d.items():
            got = t.grad if t.grad is not None else torch.zeros_like(t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_p[k][n]),
                                       err_msg=f"{k}.{n}", **TOL)


@pytest.mark.parametrize("start", ["zeros", "h1_0"])
def test_layer2_must_start_from_h1_seq0(pallas_interpret, start):
    """Layer 2's chain started anywhere but h1_seq[0] misses the reference:
    h2_seq and the NLL part from JAX's by more than the bound."""
    p, z, tokens = _inputs("ce", 1)
    tp = params_from_numpy(p)
    with torch.no_grad():
        tok_t, weights = cuda_decoder._fused_args(
            tp, torch.from_numpy(z), torch.from_numpy(tokens), V)
        h2_seq = _schedule(tok_t, weights[:-2], start)[1]
        nll = _head(h2_seq, *weights[-2:], "ce", torch.from_numpy(tokens).t())
    jz, jtok = jnp.asarray(z), jnp.asarray(tokens)
    want_h2 = np.asarray(pallas_gru.decoder_teacher_fused(p, jz, jtok, V))
    want_nll = np.asarray(pallas_gru.decoder_teacher_fused_nll(p, jz, jtok,
                                                               V))
    assert np.abs(h2_seq.transpose(0, 1).numpy() - want_h2).max() > 1e-2
    assert np.abs(nll.t().numpy() - want_nll).max() > TOL["atol"]


def test_single_chain_matches_stacked_gru_pallas(pallas_interpret):
    """Kernel 1: the chain over rows in memory, one per direction, against
    `stacked_gru_pallas` at L=2 (h_seq (L, T, B, H))."""
    L, B = 2, 5
    rng = np.random.default_rng(31)
    pre = (rng.standard_normal((L, T, B, 3 * H)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((L, H, 3 * H)) * 0.3).astype(np.float32)
    b_hh = (rng.standard_normal((L, 3 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((L, B, H)) * 0.5).astype(np.float32)
    want = pallas_gru.stacked_gru_pallas(*(jnp.asarray(a) for a in (
        pre, w_hh, b_hh, h0)))
    with torch.no_grad():
        got = torch.stack([_chain(*(torch.from_numpy(a[l]) for a in (
            pre, w_hh, b_hh, h0)))[0] for l in range(L)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
