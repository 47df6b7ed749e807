"""The teacher-forced decoder with its heads (`csrc/decoder_ce.cu`,
`csrc/decoder_ce_bwd.cu`) and their plain PyTorch versions.

Counterparts of `music_fader_nets_tpu/ops/pallas_gru.py`:

- `decoder_teacher_fused_nll` (:2098, through `_dec_nll_core` :1791): both
  GRUCell layers over the teacher tokens (the reference's step-0 rule:
  layer 2's previous hidden at t = 0 is layer 1's new state), the logits
  head over the padded vocabulary and the per-position NLL.
- `decoder_teacher_fused_masses` (:2131, through `_dec_mask_core` :1842):
  the same decode with the masses head, K per-step softmax masses over
  vocabulary ranges, all that the GLSR regularizer reads of its
  perturbation decodes; its B rows may be n_rep copies of B/n_rep
  sequences that share their tokens.

The (B, T, V) log-probs never exist. The products around the kernels
(`pre_z`, `h1_0`, padding) stay torch ops with autograd, as the JAX package
left them to XLA.

Each wrapper runs the plain version for tensors on the CPU and the kernels
for tensors on a GPU; there is no fallback between the two. On a GPU, a
call whose float inputs want a gradient goes through `DecoderNLL` or
`DecoderMasses`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.ops import _build, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import _gates, vocab_pad

# wrapper calls that launched each kernel (forward: 2T + 1 device
# launches; backward: 3T + 12, the masses head's with n_rep > 1: 3T + 13)
LAUNCHES = {"decoder_ce": 0, "decoder_ce_bwd": 0, "decoder_masses": 0,
            "decoder_masses_bwd": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_TRAIN_PATH = None

# the padded head's pad lanes: exp() of them is exactly 0
PAD_LOGIT = -1e30
# the masses head takes at most this many vocabulary ranges
MAX_RANGES = 4


def _teacher_h2_plain(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                      bhh2, h1_0):
    """Layer 2's state h2 (B, H) of each step of the plain teacher decode,
    in order; tok_t (T, B) int."""
    h1, h2 = h1_0, None
    for t in range(tok_t.shape[0]):
        pre1 = w_tok[tok_t[t].long()] + pre_z
        h1 = _gates(pre1, h1 @ whh1 + bhh1, h1)
        h2p = h1 if t == 0 else h2
        h2 = _gates(h1 @ wih2 + bih2, h2p @ whh2 + bhh2, h2p)
        yield h2


def decoder_teacher_nll_plain(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2,
                              bih2, whh2, bhh2, h1_0, w_out, b_out):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    tok_t, tgt_t (T, B) int; w_tok (Vp, 3H); pre_z (B, 3H); whh1, wih2,
    whh2 (H, 3H); biases (3H); h1_0 (B, H); w_out (H, Vp); b_out (Vp).
    Returns nll (T, B)."""
    T, B = tok_t.shape
    out = []
    for t, h2 in enumerate(_teacher_h2_plain(tok_t, w_tok, pre_z, whh1,
                                             bhh1, wih2, bih2, whh2, bhh2,
                                             h1_0)):
        logits = h2 @ w_out + b_out
        lse = torch.logsumexp(logits, dim=-1)
        out.append(lse - logits.gather(1, tgt_t[t].long()[:, None])[:, 0])
    if not out:
        return h1_0.new_zeros((0, B))
    return torch.stack(out)


def decoder_teacher_masses_plain(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                                 whh2, bhh2, h1_0, w_out, b_out,
                                 ranges: Sequence[Tuple[int, int]],
                                 n_rep: int = 1):
    """Plain PyTorch version of the masses head: tok_t (T, B0) int with B =
    n_rep * B0 rows in pre_z and h1_0, row b reading tok_t[:, b % B0].
    Returns masses (T, K, B), out[t, k, b] = sum over [lo_k, hi_k) of
    softmax(h2 @ w_out + b_out)."""
    tok = tok_t.repeat(1, n_rep)
    out = []
    for h2 in _teacher_h2_plain(tok, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                                whh2, bhh2, h1_0):
        p = torch.softmax(h2 @ w_out + b_out, dim=-1)
        out.append(torch.stack([p[:, lo:hi].sum(-1) for lo, hi in ranges]))
    if not out:
        return h1_0.new_zeros((0, len(ranges), h1_0.shape[0]))
    return torch.stack(out)


def _check(tok_t, B: int, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
           bhh2, h1_0, w_out, b_out, tgt_t=None):
    """Shapes and types of a call over B rows (tok_t (T, B / n_rep))."""
    T = tok_t.shape[0]
    H = h1_0.shape[-1]
    G, Vp = 3 * H, w_tok.shape[0]
    want = {"w_tok": (Vp, G), "pre_z": (B, G), "whh1": (H, G),
            "bhh1": (G,), "wih2": (H, G), "bih2": (G,), "whh2": (H, G),
            "bhh2": (G,), "h1_0": (B, H), "w_out": (H, Vp), "b_out": (Vp,)}
    got = dict(w_tok=w_tok, pre_z=pre_z, whh1=whh1, bhh1=bhh1, wih2=wih2,
               bih2=bih2, whh2=whh2, bhh2=bhh2, h1_0=h1_0, w_out=w_out,
               b_out=b_out)
    if tgt_t is not None:
        want["tgt_t"], got["tgt_t"] = (T, B), tgt_t
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    for name, t in got.items():
        want_dt = torch.int32 if name == "tgt_t" else torch.float32
        if t.dtype != want_dt:
            raise ValueError(f"{name} must be {want_dt}, got {t.dtype}")
    if tok_t.dtype != torch.int32:
        raise ValueError(f"tok_t must be int32, got {tok_t.dtype}")


def _check_ranges(ranges, n_rep: int, Vp: int):
    if not 1 <= len(ranges) <= MAX_RANGES:
        raise ValueError(f"the masses head takes 1 to {MAX_RANGES} ranges, "
                         f"got {len(ranges)}")
    if any(not 0 <= lo <= hi <= Vp for lo, hi in ranges):
        raise ValueError(f"ranges {ranges} must lie in [0, {Vp}]")
    if n_rep < 1:
        raise ValueError(f"n_rep must be >= 1, got {n_rep}")


def _ranges_arg(ranges):
    flat = [int(v) for r in ranges for v in r]
    return (ctypes.c_int * len(flat))(*flat)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_buffers(T, B, H, dev, stash: bool):
    """(h1_seq, h2_seq, g41, g42) for a forward; the stashes are None
    without `stash`."""
    f32 = dict(dtype=torch.float32, device=dev)
    g4 = (lambda: torch.empty((T, B, 4 * H), **f32) if stash else None)
    return (torch.empty((T, B, H), **f32), torch.empty((T, B, H), **f32),
            g4(), g4())


def _launch_fwd(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                bhh2, h1_0, w_out, b_out, stash: bool):
    """fader_decoder_ce: (nll (T, B), h1_seq, h2_seq, g41, g42); the
    stashes are None without `stash`."""
    T, B = tok_t.shape
    dev = h1_0.device
    bufs = _fwd_buffers(T, B, h1_0.shape[-1], dev, stash)
    nll = torch.empty((T, B), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.fader_decoder_ce(
            T, B, h1_0.shape[-1], w_tok.shape[0], *(_ptr(t) for t in (
                tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                bhh2, h1_0, w_out, b_out, *bufs, nll)),
            cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_ce")
    return (nll, *bufs)


def _launch_masses_fwd(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                       bhh2, h1_0, w_out, b_out, ranges, n_rep: int,
                       stash: bool):
    """fader_decoder_masses: (masses (T, K, B), h1_seq, h2_seq, g41, g42)
    over B = n_rep * B0 rows; tok_t (T, B0) is tiled to the B rows."""
    T = tok_t.shape[0]
    B, H = h1_0.shape
    dev = h1_0.device
    bufs = _fwd_buffers(T, B, H, dev, stash)
    masses = torch.empty((T, len(ranges), B), dtype=torch.float32,
                         device=dev)
    tok = tok_t.repeat(1, n_rep).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.fader_decoder_masses(
            T, B, H, w_tok.shape[0], len(ranges), _ranges_arg(ranges),
            *(_ptr(t) for t in (tok, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                                whh2, bhh2, h1_0, w_out, b_out, *bufs,
                                masses)), cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_masses")
    return (masses, *bufs)


def _bwd_buffers(T, B, H, Vp, dev):
    """(transpose of a weight, scratch list, outputs list) of a backward:
    scratch dlogits, dh2_head, dh2_buf, dh1_carry, dh1_mid, s1x, s1h, s2x,
    s2h; outputs dw_tok, dpre_z, dwhh1, dbhh1, dwih2, dbih2, dwhh2, dbhh2,
    dh1_0, dw_out, db_out."""
    G = 3 * H
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = [torch.empty((T, B, Vp), **f32), torch.empty((T, B, H), **f32),
               torch.empty((2, B, H), **f32), torch.empty((B, H), **f32),
               torch.empty((B, H), **f32)] + [
                   torch.empty((T, B, G), **f32) for _ in range(4)]
    outs = [torch.empty(s, **f32) for s in (
        (Vp, G), (B, G), (H, G), (G,), (H, G), (G,), (H, G), (G,), (B, H),
        (H, Vp), (Vp,))]
    return (lambda w: w.t().contiguous()), scratch, outs


def _launch_bwd(g, tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1, wih2, whh2,
                h1_0, w_out, b_out):
    """fader_decoder_ce_bwd: (dw_tok, dpre_z, dwhh1, dbhh1, dwih2, dbih2,
    dwhh2, dbhh2, dh1_0, dw_out, db_out)."""
    T, B, H = h1_seq.shape
    Vp = w_out.shape[1]
    dev = h1_0.device
    tr, scratch, outs = _bwd_buffers(T, B, H, Vp, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.fader_decoder_ce_bwd(
            T, B, H, Vp, *(t.data_ptr() for t in (
                tok_t, tgt_t, g, h1_seq, h2_seq, g41, g42, h1_0, tr(whh1),
                tr(wih2), tr(whh2), w_out, b_out, tr(w_out), *scratch,
                *outs)), cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_ce_bwd")
    del scratch
    return tuple(outs)


def _launch_masses_bwd(g, tok_t, h1_seq, h2_seq, g41, g42, whh1, wih2,
                       whh2, h1_0, w_out, b_out, ranges, n_rep: int):
    """fader_decoder_masses_bwd: the gradients of `_launch_bwd`, from the
    masses' cotangent g (T, K, B); tok_t (T, B0)."""
    T, B, H = h1_seq.shape
    Vp = w_out.shape[1]
    dev = h1_0.device
    tr, scratch, outs = _bwd_buffers(T, B, H, Vp, dev)
    fold = (torch.empty((T, B // n_rep, 3 * H), dtype=torch.float32,
                        device=dev) if n_rep > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.fader_decoder_masses_bwd(
            T, B, H, Vp, n_rep, len(ranges), _ranges_arg(ranges),
            *(_ptr(t) for t in (
                tok_t, g, h1_seq, h2_seq, g41, g42, h1_0, tr(whh1),
                tr(wih2), tr(whh2), w_out, b_out, tr(w_out), *scratch,
                fold, *outs)), cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_masses_bwd")
    del scratch, fold
    return tuple(outs)


class DecoderNLL(torch.autograd.Function):
    """Kernels 9 (forward with the two gate stashes) and 10 (backward) as
    one differentiable op over (tok_t, tgt_t, w_tok, pre_z, whh1, bhh1,
    wih2, bih2, whh2, bhh2, h1_0, w_out, b_out)."""

    @staticmethod
    def forward(ctx, tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                whh2, bhh2, h1_0, w_out, b_out):
        nll, h1_seq, h2_seq, g41, g42 = _launch_fwd(
            tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
            h1_0, w_out, b_out, stash=True)
        LAUNCHES["decoder_ce"] += 1
        ctx.save_for_backward(tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1,
                              wih2, whh2, h1_0, w_out, b_out)
        return nll

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = _launch_bwd(g.contiguous(), *saved)
        LAUNCHES["decoder_ce_bwd"] += 1
        del saved
        return cuda_gru._mask(ctx, (None, None) + grads)


class DecoderMasses(torch.autograd.Function):
    """Kernels 9 and 10 with the masses head as one differentiable op over
    (tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0, w_out,
    b_out, ranges, n_rep) -> masses (T, K, B)."""

    @staticmethod
    def forward(ctx, tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
                h1_0, w_out, b_out, ranges, n_rep):
        masses, h1_seq, h2_seq, g41, g42 = _launch_masses_fwd(
            tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0,
            w_out, b_out, ranges, n_rep, stash=True)
        LAUNCHES["decoder_masses"] += 1
        ctx.save_for_backward(tok_t, h1_seq, h2_seq, g41, g42, whh1, wih2,
                              whh2, h1_0, w_out, b_out)
        ctx.ranges, ctx.n_rep = ranges, n_rep
        return masses

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = _launch_masses_bwd(g.contiguous(), *saved, ctx.ranges,
                                   ctx.n_rep)
        LAUNCHES["decoder_masses_bwd"] += 1
        del saved
        return cuda_gru._mask(ctx, (None,) + grads + (None, None))


def decoder_teacher_nll(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                        whh2, bhh2, h1_0, w_out, b_out):
    """Per-position NLL (T, B) of the teacher-forced decode. CPU tensors
    take the plain version; CUDA tensors launch the kernels, through
    `DecoderNLL` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    args = (tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
            h1_0, w_out, b_out)
    if cuda_gru.kernel_device(args) is None:
        LAST_TRAIN_PATH = "plain-cpu"
        return decoder_teacher_nll_plain(*args)
    T, B = tok_t.shape
    _check(tok_t, B, *args[2:], tgt_t=tgt_t)
    args = tuple(t.contiguous() for t in args)
    LAST_TRAIN_PATH = "kernel"
    if T * B == 0:
        return h1_0.new_zeros((T, B))
    if cuda_gru.wants_grad(*args[2:]):
        return DecoderNLL.apply(*args)
    nll = _launch_fwd(*args, stash=False)[0]
    LAUNCHES["decoder_ce"] += 1
    return nll


def decoder_teacher_masses(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                           whh2, bhh2, h1_0, w_out, b_out,
                           ranges: Sequence[Tuple[int, int]],
                           n_rep: int = 1):
    """Per-step masses (T, K, B) of the teacher-forced decode over B =
    n_rep * B0 rows sharing the B0 token columns of tok_t (T, B0). CPU
    tensors take the plain version; CUDA tensors launch the kernels,
    through `DecoderMasses` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
    args = (tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0,
            w_out, b_out)
    if cuda_gru.kernel_device(args) is None:
        LAST_TRAIN_PATH = "plain-cpu"
        return decoder_teacher_masses_plain(*args, ranges, n_rep)
    T, B0 = tok_t.shape
    _check_ranges(ranges, n_rep, w_tok.shape[0])
    _check(tok_t, B0 * n_rep, *args[1:])
    args = tuple(t.contiguous() for t in args)
    LAST_TRAIN_PATH = "kernel"
    if T * B0 == 0:
        return h1_0.new_zeros((T, len(ranges), h1_0.shape[0]))
    if cuda_gru.wants_grad(*args[1:]):
        return DecoderMasses.apply(*args, ranges, n_rep)
    masses = _launch_masses_fwd(*args, ranges, n_rep, stash=False)[0]
    LAUNCHES["decoder_masses"] += 1
    return masses


def _dec_w_split(p: Dict, V: int):
    """(w_tok padded to Vp rows, w_z) of the decoder cell's input
    projection: stored so in the fast layout (`models/fast.py`), derived
    from `w_ih` in the canonical one."""
    g = p["grucell_g"]
    if "w_tok_p" in g:
        return g["w_tok_p"], g["w_z"]
    w_ih = g["w_ih"]
    return F.pad(w_ih[:V], (0, 0, 0, vocab_pad(V) - V)), w_ih[V:]


def _fused_args(p: Dict, z: torch.Tensor, tokens: torch.Tensor, V: int):
    """The kernels' inputs from the decoder's params, z (B, Zt) and the
    token rows (B0, T): tok_t (T, B0) = [start = V-1, tokens[:, :-1]] and
    (w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0, w_out, b_out),
    the head padded to Vp (pad logits -1e30)."""
    w_tok, w_z = _dec_w_split(p, V)
    Vp = w_tok.shape[0]
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    pre_z = z @ w_z + g1["b_ih"]
    init = p["linear_init_global"]
    h1_0 = z @ init["w"] + init["b"]
    tgt = tokens.to(torch.int32)
    start = torch.full((tgt.shape[0], 1), V - 1, dtype=torch.int32,
                       device=tgt.device)
    tok_t = torch.cat([start, tgt[:, :-1]], dim=1).t()
    w_out = F.pad(p["linear_out_g"]["w"], (0, Vp - V))
    b_out = F.pad(p["linear_out_g"]["b"], (0, Vp - V), value=PAD_LOGIT)
    return tok_t, (w_tok, pre_z, g1["w_hh"], g1["b_hh"], g2["w_ih"],
                   g2["b_ih"], g2["w_hh"], g2["b_hh"], h1_0, w_out, b_out)


def decoder_teacher_fused_nll(p: Dict, z: torch.Tensor, tokens: torch.Tensor,
                              V: int) -> torch.Tensor:
    """Teacher decode + CE: per-position NLL (B, T) of the targets `tokens`
    (B, T), padding positions included (the `nll_mean` semantics before
    the mean). Inputs are [start = V-1, tokens[:, :-1]]."""
    tok_t, weights = _fused_args(p, z, tokens, V)
    tgt_t = tokens.to(torch.int32).t()
    return decoder_teacher_nll(tok_t, tgt_t, *weights).t()      # (B, T)


def decoder_teacher_fused_masses(p: Dict, z: torch.Tensor,
                                 tokens: torch.Tensor, V: int, ranges,
                                 n_rep: int = 1):
    """Teacher decode + masses head: a tuple of (B, T) tensors, one per
    vocabulary range [lo, hi), out_k[b, t] = sum over range k of
    softmax(logits[b, t]). z (B, Zt) holds n_rep stacked copies that share
    the teacher tokens (B0, T), B = n_rep * B0 (GLSR's four perturbations
    of z over one batch)."""
    B, B0 = z.shape[0], tokens.shape[0]
    if B0 * n_rep != B:
        raise ValueError(f"z has {B} rows, tokens {B0}, n_rep {n_rep}")
    tok_t, weights = _fused_args(p, z, tokens, V)
    mk = decoder_teacher_masses(tok_t, *weights, ranges, n_rep)
    return tuple(mk[:, k].t() for k in range(mk.shape[1]))      # (B, T)
