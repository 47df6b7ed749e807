"""The teacher-forced decoder with its cross-entropy head
(`csrc/decoder_ce.cu`, `csrc/decoder_ce_bwd.cu`) and its plain PyTorch
version.

Counterpart of `music_fader_nets_tpu/ops/pallas_gru.py::
decoder_teacher_fused_nll` (:2098, through `_dec_nll_core` :1791): both
GRUCell layers over the teacher tokens (the reference's step-0 rule: layer
2's previous hidden at t = 0 is layer 1's new state), the logits head over
the padded vocabulary and the per-position NLL, whose (B, T, V) log-probs
never exist. The products around the kernel (`pre_z`, `h1_0`, padding)
stay torch ops with autograd, as the JAX package left them to XLA.

The wrapper runs the plain version for tensors on the CPU and the kernels
for tensors on a GPU; there is no fallback between the two. On a GPU, a
call whose float inputs want a gradient goes through `DecoderNLL`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.ops import _build, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import _gates, vocab_pad

# wrapper calls that launched each kernel (forward: 2T + 1 device
# launches; backward: 3T + 12)
LAUNCHES = {"decoder_ce": 0, "decoder_ce_bwd": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_TRAIN_PATH = None

# the padded head's pad lanes: exp() of them is exactly 0
PAD_LOGIT = -1e30


def decoder_teacher_nll_plain(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2,
                              bih2, whh2, bhh2, h1_0, w_out, b_out):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    tok_t, tgt_t (T, B) int; w_tok (Vp, 3H); pre_z (B, 3H); whh1, wih2,
    whh2 (H, 3H); biases (3H); h1_0 (B, H); w_out (H, Vp); b_out (Vp).
    Returns nll (T, B)."""
    T, B = tok_t.shape
    h1, h2, out = h1_0, None, []
    for t in range(T):
        pre1 = w_tok[tok_t[t].long()] + pre_z
        h1 = _gates(pre1, h1 @ whh1 + bhh1, h1)
        h2p = h1 if t == 0 else h2
        h2 = _gates(h1 @ wih2 + bih2, h2p @ whh2 + bhh2, h2p)
        logits = h2 @ w_out + b_out
        lse = torch.logsumexp(logits, dim=-1)
        out.append(lse - logits.gather(1, tgt_t[t].long()[:, None])[:, 0])
    if not out:
        return h1_0.new_zeros((0, B))
    return torch.stack(out)


def _check(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
           h1_0, w_out, b_out):
    T, B = tok_t.shape
    H = h1_0.shape[-1]
    G, Vp = 3 * H, w_tok.shape[0]
    want = {"tgt_t": (T, B), "w_tok": (Vp, G), "pre_z": (B, G),
            "whh1": (H, G), "bhh1": (G,), "wih2": (H, G), "bih2": (G,),
            "whh2": (H, G), "bhh2": (G,), "h1_0": (B, H), "w_out": (H, Vp),
            "b_out": (Vp,)}
    got = dict(tgt_t=tgt_t, w_tok=w_tok, pre_z=pre_z, whh1=whh1, bhh1=bhh1,
               wih2=wih2, bih2=bih2, whh2=whh2, bhh2=bhh2, h1_0=h1_0,
               w_out=w_out, b_out=b_out)
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


def _launch_fwd(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                bhh2, h1_0, w_out, b_out, stash: bool):
    """fader_decoder_ce: (nll (T, B), h1_seq, h2_seq, g41, g42); the
    stashes are None without `stash`."""
    T, B = tok_t.shape
    H = h1_0.shape[-1]
    dev = h1_0.device
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load_library()
    h1_seq = torch.empty((T, B, H), **f32)
    h2_seq = torch.empty((T, B, H), **f32)
    g41 = torch.empty((T, B, 4 * H), **f32) if stash else None
    g42 = torch.empty((T, B, 4 * H), **f32) if stash else None
    nll = torch.empty((T, B), **f32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.fader_decoder_ce(
            T, B, H, w_tok.shape[0], tok_t.data_ptr(), tgt_t.data_ptr(),
            w_tok.data_ptr(), pre_z.data_ptr(), whh1.data_ptr(),
            bhh1.data_ptr(), wih2.data_ptr(), bih2.data_ptr(),
            whh2.data_ptr(), bhh2.data_ptr(), h1_0.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), h1_seq.data_ptr(),
            h2_seq.data_ptr(), ptr(g41), ptr(g42), nll.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fader_decoder_ce")
    return nll, h1_seq, h2_seq, g41, g42


def _launch_bwd(g, tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1, wih2, whh2,
                h1_0, w_out, b_out):
    """fader_decoder_ce_bwd: (dw_tok, dpre_z, dwhh1, dbhh1, dwih2, dbih2,
    dwhh2, dbhh2, dh1_0, dw_out, db_out)."""
    T, B, H = h1_seq.shape
    G, Vp = 3 * H, w_out.shape[1]
    dev = h1_0.device
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load_library()
    tr = (lambda w: w.t().contiguous())
    whh1T, wih2T, whh2T, w_outT = tr(whh1), tr(wih2), tr(whh2), tr(w_out)
    scratch = [torch.empty((T, B, Vp), **f32), torch.empty((T, B, H), **f32),
               torch.empty((2, B, H), **f32), torch.empty((B, H), **f32),
               torch.empty((B, H), **f32)] + [
                   torch.empty((T, B, G), **f32) for _ in range(4)]
    outs = [torch.empty(s, **f32) for s in (
        (Vp, G), (B, G), (H, G), (G,), (H, G), (G,), (H, G), (G,), (B, H),
        (H, Vp), (Vp,))]
    with torch.cuda.device(dev):
        err = lib.fader_decoder_ce_bwd(
            T, B, H, Vp, *(t.data_ptr() for t in (
                tok_t, tgt_t, g, h1_seq, h2_seq, g41, g42, h1_0, whh1T,
                wih2T, whh2T, w_out, b_out, w_outT, *scratch, *outs)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fader_decoder_ce_bwd")
    del scratch
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
        tok_t, tgt_t, h1_seq, h2_seq, g41, g42 = saved[:6]
        grads = _launch_bwd(g.contiguous(), tok_t, tgt_t, h1_seq, h2_seq,
                            g41, g42, *saved[6:])
        LAUNCHES["decoder_ce_bwd"] += 1
        del saved, h1_seq, h2_seq, g41, g42
        (dw_tok, dpre_z, dwhh1, dbhh1, dwih2, dbih2, dwhh2, dbhh2, dh1_0,
         dw_out, db_out) = grads
        return cuda_gru._mask(ctx, (None, None, dw_tok, dpre_z, dwhh1, dbhh1,
                                    dwih2, dbih2, dwhh2, dbhh2, dh1_0,
                                    dw_out, db_out))


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
    _check(*args)
    args = tuple(t.contiguous() for t in args)
    T, B = tok_t.shape
    LAST_TRAIN_PATH = "kernel"
    if T * B == 0:
        return h1_0.new_zeros((T, B))
    if cuda_gru.wants_grad(*args[2:]):
        return DecoderNLL.apply(*args)
    nll = _launch_fwd(*args, stash=False)[0]
    LAUNCHES["decoder_ce"] += 1
    return nll


def _dec_w_split(p: Dict, V: int):
    """(w_tok padded to Vp rows, w_z) of the decoder cell's input
    projection: stored so in the fast layout (`models/fast.py`), derived
    from `w_ih` in the canonical one."""
    g = p["grucell_g"]
    if "w_tok_p" in g:
        return g["w_tok_p"], g["w_z"]
    w_ih = g["w_ih"]
    return F.pad(w_ih[:V], (0, 0, 0, vocab_pad(V) - V)), w_ih[V:]


def decoder_teacher_fused_nll(p: Dict, z: torch.Tensor, tokens: torch.Tensor,
                              V: int) -> torch.Tensor:
    """Teacher decode + CE: per-position NLL (B, T) of the targets `tokens`
    (B, T), padding positions included (the `nll_mean` semantics before
    the mean). Inputs are [start = V-1, tokens[:, :-1]]."""
    B, T = tokens.shape
    w_tok, w_z = _dec_w_split(p, V)
    Vp = w_tok.shape[0]
    pre_z = z @ w_z + p["grucell_g"]["b_ih"]
    init = p["linear_init_global"]
    h1_0 = z @ init["w"] + init["b"]
    tgt = tokens.to(torch.int32)
    start = torch.full((B, 1), V - 1, dtype=torch.int32, device=tgt.device)
    tok_t = torch.cat([start, tgt[:, :-1]], dim=1).t()
    w_out = F.pad(p["linear_out_g"]["w"], (0, Vp - V))
    b_out = F.pad(p["linear_out_g"]["b"], (0, Vp - V), value=PAD_LOGIT)
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    nll = decoder_teacher_nll(tok_t, tgt.t(), w_tok, pre_z, g1["w_hh"],
                              g1["b_hh"], g2["w_ih"], g2["b_ih"], g2["w_hh"],
                              g2["b_hh"], h1_0, w_out, b_out)
    return nll.t()                                              # (B, T)
