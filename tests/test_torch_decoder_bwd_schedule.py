"""PyTorch port, the schedule of the decoder backward kernel
(`csrc/decoder_ce_bwd.cu::decoder_bwd_from_dh2`) written out in plain
PyTorch and held against the JAX package's VJP, Pallas kernels in
interpret mode, at a small size (H=32, T=8).

The kernel runs the two-layer backward as three parts, not step by step
with the layers interleaved as the reference's chain does
(`music_fader_nets_tpu/ops/pallas_gru.py::_dec_bwd_chain` :1222):

1. layer 2's chain alone, with the head's cotangent dh2_head[t] added on
   every step: its recurrence never reads layer 1;
2. the cotangent that layer 2 sends layer 1 on every step, inject[t] =
   dpre2x[t] w_ih2^T, as one product over all steps, plus, at t = 0, the dh
   that leaves layer 2's chain (the reference's step-0 rule: layer 2's
   previous state at t = 0 is layer 1's new one, :1245-1247, :1266-1270);
3. layer 1's chain alone, with inject[t] added on every step.

Here that schedule runs from the forward's gate stash, its gradients go
back through the port's own glue (`_fused_args` / `_recurrence_args`: the
padding, pre_z and h1_0 products) by autograd, and every parameter's and
z's gradient is held to the JAX VJP of `decoder_teacher_fused_nll`,
`decoder_teacher_fused_masses` (n_rep 1 and 4) and `decoder_teacher_fused`
at atol=1e-4 (float32, other summation orders)."""
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


def _forward_stash(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
                   h1_0):
    """h1_seq, h2_seq (T, B, H) and the gate stashes g41, g42 (T, B, 4H):
    [r, z, n, hn] a step, hn the n-section of the hidden projection."""
    n_rep = pre_z.shape[0] // tok_t.shape[1]
    tok = tok_t.repeat(1, n_rep).long()

    def cell(x, h, w_hh, b_hh):
        ph = h @ w_hh + b_hh
        r = torch.sigmoid(x[:, :H] + ph[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + ph[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * ph[:, 2 * H:])
        return (1 - z) * n + z * h, torch.cat([r, z, n, ph[:, 2 * H:]], -1)

    h1, h2 = h1_0, None
    out = []
    for t in range(tok.shape[0]):
        h1, s1 = cell(w_tok[tok[t]] + pre_z, h1, whh1, bhh1)
        h2p = h1 if t == 0 else h2
        h2, s2 = cell(h1 @ wih2 + bih2, h2p, whh2, bhh2)
        out.append((h1, h2, s1, s2))
    return [torch.stack(x) for x in zip(*out)]


def _chain(g, stash, h_prev, w_hh):
    """One layer's reversed chain with a cotangent g[t] on every step:
    (dpre_x, dpre_h) (T, B, 3H) and the dh that leaves step 0."""
    dh = torch.zeros_like(g[0])
    dpx, dph = [None] * len(g), [None] * len(g)
    for t in range(len(g) - 1, -1, -1):
        d = dh + g[t]
        r, z, n, hn = stash[t].split(H, dim=-1)
        dan = d * (1 - z) * (1 - n * n)
        dar = dan * hn * r * (1 - r)
        daz = d * (h_prev[t] - n) * z * (1 - z)
        dpx[t] = torch.cat([dar, daz, dan], dim=-1)
        dph[t] = torch.cat([dar, daz, dan * r], dim=-1)
        dh = d * z + dph[t] @ w_hh.t()
    return torch.stack(dpx), torch.stack(dph), dh


def _schedule(tok_t, weights, dh2_head, fwd=None):
    """The kernel's three-part schedule: the gradients of (w_tok, pre_z,
    whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0) from dh2_head (T, B, H), the
    cotangent of h2_seq; `fwd` = (h1_seq, h2_seq, g41, g42) of a forward,
    by default `_forward_stash`'s."""
    (w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0) = weights
    h1_seq, h2_seq, g41, g42 = (fwd if fwd is not None
                                else _forward_stash(tok_t, *weights))
    # 1. layer 2 (h2_prev(0) = h1_seq[0])
    h2p = torch.cat([h1_seq[:1], h2_seq[:-1]])
    s2x, s2h, dh2_0 = _chain(dh2_head, g42, h2p, whh2)
    # 2. layer 2's cotangent into layer 1, with the step-0 term
    inject = s2x @ wih2.t()
    inject[0] = inject[0] + dh2_0
    # 3. layer 1
    h1p = torch.cat([h1_0[None], h1_seq[:-1]])
    s1x, s1h, dh1_0 = _chain(inject, g41, h1p, whh1)
    # weight gradients; with n_rep copies the dpre1x rows are folded over
    # the copies before the token scatter
    B0 = tok_t.shape[1]
    folded = s1x.reshape(T, -1, B0, 3 * H).sum(1)
    dw_tok = torch.zeros_like(w_tok).index_add_(
        0, tok_t.reshape(-1).long(), folded.reshape(-1, 3 * H))
    outer = (lambda a, b: torch.einsum("tbi,tbj->ij", a, b))
    return (dw_tok, s1x.sum(0), outer(h1p, s1h), s1h.sum((0, 1)),
            outer(h1_seq, s2x), s2x.sum((0, 1)), outer(h2p, s2h),
            s2h.sum((0, 1)), dh1_0)


def _head_dh2(h2_seq, w_out, b_out, head, g, tgt_t):
    """dh2_head and the head's (dw_out, db_out) from its cotangent g: the CE
    head's NLL (T, B) or the masses head's (T, K, B)."""
    p = torch.softmax(h2_seq @ w_out + b_out, dim=-1)
    if head == "ce":
        onehot = torch.nn.functional.one_hot(tgt_t.long(), p.shape[-1])
        dlogits = (p - onehot) * g[..., None]
    else:
        inside = torch.zeros((len(GLSR_MASK_RANGES), p.shape[-1]))
        for k, (lo, hi) in enumerate(GLSR_MASK_RANGES):
            inside[k, lo:hi] = 1.0
        m = torch.einsum("tbv,kv->tkb", p, inside)
        dlogits = p * torch.einsum("tkb,kv->tbv", g, inside) - p * (
            g * m).sum(1)[..., None]
    return (dlogits @ w_out.t(),
            (torch.einsum("tbh,tbv->hv", h2_seq, dlogits),
             dlogits.sum((0, 1))))


CASES = [("ce", 1), ("masses", 1), ("masses", 4), ("none", 1)]


@pytest.mark.parametrize("head,n_rep", CASES)
def test_three_part_schedule_matches_jax_vjp(pallas_interpret, head, n_rep):
    B0 = 3
    B = n_rep * B0
    p = jax.tree.map(np.asarray, global_decoder_init(
        jax.random.PRNGKey(11), Zt, V, H))
    rng = np.random.default_rng(12)
    z = rng.standard_normal((B, Zt)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B0, T)).astype(np.int32)
    if head == "ce":
        cot = rng.standard_normal((B, T)).astype(np.float32)

        def jfn(p, z):
            return pallas_gru.decoder_teacher_fused_nll(
                p, z, jnp.asarray(tokens), V)
        g = torch.from_numpy(cot).t()
    elif head == "masses":
        cot = tuple(rng.standard_normal((B, T)).astype(np.float32)
                    for _ in GLSR_MASK_RANGES)

        def jfn(p, z):
            return pallas_gru.decoder_teacher_fused_masses(
                p, z, jnp.asarray(tokens), V, GLSR_MASK_RANGES,
                n_rep=n_rep)
        g = torch.stack([torch.from_numpy(c).t() for c in cot], dim=1)
    else:
        cot = rng.standard_normal((B, T, H)).astype(np.float32)

        def jfn(p, z):
            return pallas_gru.decoder_teacher_fused(
                p, z, jnp.asarray(tokens), V)
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
        if head == "none":
            grads = _schedule(tok_t, plain, g)
        else:
            h2_seq = _forward_stash(tok_t, *plain[:-2])[1]
            dh2_head, head_grads = _head_dh2(h2_seq, *plain[-2:], head, g,
                                             tok.t())
            grads = _schedule(tok_t, plain[:-2], dh2_head)
            grads = grads + head_grads
    torch.autograd.backward(list(weights), list(grads))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_z), **TOL)
    for k, d in tp.items():
        for n, t in d.items():
            # without a head, linear_out_g has no gradient on either side
            got = t.grad if t.grad is not None else torch.zeros_like(t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_p[k][n]),
                                       err_msg=f"{k}.{n}", **TOL)
