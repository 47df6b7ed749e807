"""The teacher-forced decoder, without a head and with its heads
(`csrc/decoder_ce.cu`, `csrc/decoder_ce_bwd.cu`), and their plain PyTorch
versions.

Counterparts of `music_fader_nets_tpu/ops/pallas_gru.py`:

- `decoder_teacher_fused` (:2269, through `_dec_teacher_core`): both
  GRUCell layers over the teacher tokens, returning layer 2's states
  h2_seq; the logits head stays with the caller.
- `decoder_teacher_fused_nll` (:2098, through `_dec_nll_core` :1791): both
  GRUCell layers over the teacher tokens (the reference's step-0 rule:
  layer 2's previous hidden at t = 0 is layer 1's new state), the logits
  head over the padded vocabulary and the per-position NLL.
- `decoder_teacher_fused_masses` (:2131, through `_dec_mask_core` :1842):
  the same decode with the masses head, K per-step softmax masses over
  vocabulary ranges, all that the GLSR regularizer reads of its
  perturbation decodes; its B rows may be n_rep copies of B/n_rep
  sequences that share their tokens.

With a head the (B, T, V) log-probs never exist. The products around the kernels
(`pre_z`, `h1_0`, padding) stay torch ops with autograd, as the JAX package
left them to XLA.

Each wrapper runs the plain version for tensors on the CPU and the kernels
for tensors on a GPU; there is no fallback between the two. On a GPU, a
call whose float inputs want a gradient goes through `DecoderTeacher`,
`DecoderNLL` or `DecoderMasses`.

bfloat16: the CE decode (kernels 9/10) takes all-bf16 float inputs, the
kernels' bf16 instantiations on a GPU and the plain version's bf16 branch
on the CPU, with the rounding rule of `ops/cuda_gru.py` (h1_seq, h2_seq
and the stashes bf16; layer 2's input and the forward head read the
float32 states, as inside the Pallas kernel; the NLL float32). The decode
without a head (7/8) and the masses head (9/10-masses) are float32 only:
no bf16 caller reaches them in the JAX package (the single GM-VAE and
GLSR stay float32), and a bf16 call raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.ops import _build, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import _gates, vocab_pad

# wrapper calls that launched each kernel (forward and backward: a fixed
# number of device launches whatever T is, two of them the persistent
# chains)
LAUNCHES = {"decoder_teacher": 0, "decoder_teacher_bwd": 0, "decoder_ce": 0,
            "decoder_ce_bwd": 0, "decoder_masses": 0,
            "decoder_masses_bwd": 0,
            # the bf16 instantiations of the CE decode
            "decoder_ce_bf16": 0, "decoder_ce_bwd_bf16": 0}
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


def decoder_teacher_plain(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                          bhh2, h1_0):
    """Plain PyTorch version of the decode without a head: tok_t (T, B)
    int; w_tok (Vp, 3H); pre_z (B, 3H); whh1, wih2, whh2 (H, 3H); biases
    (3H); h1_0 (B, H). Returns h2_seq (T, B, H)."""
    out = list(_teacher_h2_plain(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                                 whh2, bhh2, h1_0))
    if not out:
        return h1_0.new_zeros((0,) + tuple(h1_0.shape))
    return torch.stack(out)


def decoder_teacher_nll_plain(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2,
                              bih2, whh2, bhh2, h1_0, w_out, b_out):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    tok_t, tgt_t (T, B) int; w_tok (Vp, 3H); pre_z (B, 3H); whh1, wih2,
    whh2 (H, 3H); biases (3H); h1_0 (B, H); w_out (H, Vp); b_out (Vp).
    Returns nll (T, B). bf16 inputs take `_nll_bf16`."""
    if h1_0.dtype == cuda_gru.BF16:
        return _nll_bf16(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                         whh2, bhh2, h1_0, w_out, b_out)
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


def _teacher_states32(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                      bhh2, h1_0):
    """Both layers of the teacher decode in float32 (float32 inputs):
    (h1_seq, h2_seq, g41, g42), the states and gate stashes, float32."""
    h1, h2, out = h1_0, None, ([], [], [], [])
    for t in range(tok_t.shape[0]):
        pre1 = _rows_of(w_tok, tok_t[t]) + pre_z
        h1, g41 = cuda_gru.gates_stash(pre1, h1 @ whh1 + bhh1, h1)
        h2p = h1 if t == 0 else h2
        h2, g42 = cuda_gru.gates_stash(h1 @ wih2 + bih2, h2p @ whh2 + bhh2,
                                       h2p)
        for acc, v in zip(out, (h1, h2, g41, g42)):
            acc.append(v)
    return tuple(torch.stack(v) for v in out)


def _rows_of(w, tok):
    """w[tok], zero rows for ids outside w (a one-hot of them is 0)."""
    return cuda_gru._rows(w[None], tok[None])[0]


def _ce_head32(h2, w_out, b_out, tgt_t):
    """(logits, lse, nll) of the CE head over (T, B, H) float32 states."""
    logits = h2 @ w_out + b_out
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.where((tgt_t >= 0) & (tgt_t < logits.shape[-1]),
                       tgt_t.long(), 0)
    logit_t = logits.gather(-1, pick[..., None])[..., 0]
    return logits, lse, lse - logit_t


class _DecoderNLLBf16Plain(torch.autograd.Function):
    """The bf16 plain version of kernels 9/10 (CE head)."""

    @staticmethod
    def forward(ctx, tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                whh2, bhh2, h1_0, w_out, b_out):
        f32 = [t.float() for t in (w_tok, pre_z, whh1, bhh1, wih2, bih2,
                                   whh2, bhh2, h1_0)]
        h1_seq, h2_seq, g41, g42 = _teacher_states32(tok_t, *f32)
        nll = _ce_head32(h2_seq, w_out.float(), b_out.float(), tgt_t)[2]
        saved = [v.to(cuda_gru.BF16) for v in (h1_seq, h2_seq, g41, g42)]
        ctx.save_for_backward(tok_t, tgt_t, *saved, whh1, wih2, whh2, h1_0,
                              w_out, b_out)
        ctx.Vp = w_tok.shape[0]
        return nll

    @staticmethod
    def backward(ctx, g):
        (tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1, wih2, whh2, h1_0,
         w_out, b_out) = (t.float() if t.is_floating_point() else t
                          for t in ctx.saved_tensors)
        T, B, H = h1_seq.shape
        logits, lse, _ = _ce_head32(h2_seq, w_out, b_out, tgt_t)
        tgt_oh = (tgt_t.long()[..., None]
                  == torch.arange(logits.shape[-1], device=tgt_t.device))
        dlogits = ((torch.exp(logits - lse[..., None]) - tgt_oh.float())
                   * g.float()[..., None])
        dw_out = torch.einsum("tbh,tbv->hv", h2_seq, dlogits)
        db_out = dlogits.sum(dim=(0, 1))
        dh2_head = dlogits @ w_out.t()
        # layer 2 from h1_seq[0] (the step-0 rule), then layer 1 with the
        # cotangent layer 2 sends it every step (+ the dh2 that leaves step 0)
        s2x, s2h, dh2_0 = cuda_gru.chain_bwd32(
            dh2_head[None], True, g42[None], h2_seq[None], h1_seq[:1], whh2[None])
        inject = s2x[0] @ wih2.t()
        inject[0] = inject[0] + dh2_0[0]
        s1x, s1h, dh1_0 = cuda_gru.chain_bwd32(
            inject[None], True, g41[None], h1_seq[None], h1_0[None], whh1[None])
        dw_tok = cuda_gru.scatter_rows(tok_t[None], s1x, ctx.Vp)[0]
        dpre_z = s1x[0].sum(dim=0)
        dwhh1, dbhh1 = cuda_gru.w_hh_grads(h1_seq[None], h1_0[None], s1h)
        dwih2 = torch.einsum("tbh,tbg->hg", h1_seq, s2x[0])
        dbih2 = s2x[0].sum(dim=(0, 1))
        dwhh2, dbhh2 = cuda_gru.w_hh_grads(h2_seq[None], h1_seq[:1], s2h)
        return (None, None) + cuda_gru.round_bf16((
            dw_tok, dpre_z, dwhh1[0], dbhh1[0], dwih2, dbih2, dwhh2[0],
            dbhh2[0], dh1_0[0], dw_out, db_out))


def _nll_bf16(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
              bhh2, h1_0, w_out, b_out):
    """bf16 plain version of `decoder_teacher_nll`: nll (T, B) float32."""
    if tok_t.shape[0] * tok_t.shape[1] == 0:
        return h1_0.new_zeros(tok_t.shape, dtype=torch.float32)
    return _DecoderNLLBf16Plain.apply(tok_t, tgt_t, w_tok, pre_z, whh1,
                                      bhh1, wih2, bih2, whh2, bhh2, h1_0,
                                      w_out, b_out)


F32_ONLY = ("{} takes float32 only: no bf16 caller reaches it in the JAX "
            "package (ROADMAP.md, queue 2: the f32-only kernels)")


def _float_dtype(names, tensors, kernel: bool, f32_only: str = ""):
    """The float inputs' one dtype (`ops/cuda_gru.py::float_dtype`);
    `f32_only` names a decode that refuses bfloat16."""
    dt = cuda_gru.float_dtype(dict(zip(names, tensors)), kernel)
    if f32_only and dt == cuda_gru.BF16:
        raise ValueError(F32_ONLY.format(f32_only))
    return dt


_REC_NAMES = ("w_tok", "pre_z", "whh1", "bhh1", "wih2", "bih2", "whh2",
              "bhh2", "h1_0")


def _check(tok_t, B: int, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
           bhh2, h1_0, w_out=None, b_out=None, tgt_t=None):
    """Shapes and types of a call over B rows (tok_t (T, B / n_rep));
    w_out and b_out are None for the decode without a head."""
    T = tok_t.shape[0]
    H = h1_0.shape[-1]
    G, Vp = 3 * H, w_tok.shape[0]
    want = {"w_tok": (Vp, G), "pre_z": (B, G), "whh1": (H, G),
            "bhh1": (G,), "wih2": (H, G), "bih2": (G,), "whh2": (H, G),
            "bhh2": (G,), "h1_0": (B, H)}
    got = dict(w_tok=w_tok, pre_z=pre_z, whh1=whh1, bhh1=bhh1, wih2=wih2,
               bih2=bih2, whh2=whh2, bhh2=bhh2, h1_0=h1_0)
    if w_out is not None:
        want.update(w_out=(H, Vp), b_out=(Vp,))
        got.update(w_out=w_out, b_out=b_out)
    if tgt_t is not None:
        want["tgt_t"], got["tgt_t"] = (T, B), tgt_t
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    if tgt_t is not None and tgt_t.dtype != torch.int32:
        raise ValueError(f"tgt_t must be int32, got {tgt_t.dtype}")
    cuda_gru.float_dtype({n: t for n, t in got.items() if n != "tgt_t"},
                         kernel=True)
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


def _fwd_buffers(T, B, H, dev, stash: bool, dtype=torch.float32):
    """(h1_seq, h2_seq, g41, g42) for a forward, in `dtype`; the stashes
    are None without `stash`."""
    kw = dict(dtype=dtype, device=dev)
    g4 = (lambda: torch.empty((T, B, 4 * H), **kw) if stash else None)
    return (torch.empty((T, B, H), **kw), torch.empty((T, B, H), **kw),
            g4(), g4())


def _fwd_call(entry: str, lead, ptrs, T: int, B: int, H: int, dev) -> None:
    """Call the forward entry `entry` with its leading ints `lead`, its
    pointer arguments `ptrs` and a scratch sized by
    `fader_decoder_fwd_scratch_floats` (the chains' barrier counters and
    k-major rows, layer 2's input projection); raise on a CUDA error."""
    lib = _build.load_library()
    with torch.cuda.device(dev):
        scratch, n = _build.entry_scratch(
            lib.fader_decoder_fwd_scratch_floats, (T, B, H), dev)
        err = getattr(lib, entry)(*lead, *(_ptr(t) for t in ptrs),
                                  scratch.data_ptr(), n,
                                  cuda_gru._stream(dev))
    _build.check(err, entry)


def _launch_teacher_fwd(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                        bhh2, h1_0, stash: bool):
    """fader_decoder_teacher: (h1_seq, h2_seq, g41, g42); the stashes are
    None without `stash`."""
    T, B = tok_t.shape
    H = h1_0.shape[-1]
    bufs = _fwd_buffers(T, B, H, h1_0.device, stash)
    _fwd_call("fader_decoder_teacher", (T, B, H, w_tok.shape[0]),
              (tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
               h1_0, *bufs), T, B, H, h1_0.device)
    return bufs


def _launch_fwd(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
                bhh2, h1_0, w_out, b_out, stash: bool):
    """fader_decoder_ce(_bf16): (nll (T, B) float32, h1_seq, h2_seq, g41,
    g42) in h1_0's dtype; the stashes are None without `stash`. The bf16
    entry also takes layer 1's and layer 2's float32 states (scratch)."""
    T, B = tok_t.shape
    H = h1_0.shape[-1]
    dev = h1_0.device
    dt = h1_0.dtype
    bufs = _fwd_buffers(T, B, H, dev, stash, dt)
    nll = torch.empty((T, B), dtype=torch.float32, device=dev)
    states32 = (() if dt == torch.float32 else tuple(
        torch.empty((T, B, H), dtype=torch.float32, device=dev)
        for _ in range(2)))
    _fwd_call(cuda_gru.key("fader_decoder_ce", dt), (T, B, H, w_tok.shape[0]),
              (tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2,
               bhh2, h1_0, w_out, b_out, *bufs, nll, *states32), T, B, H,
              dev)
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
    _fwd_call("fader_decoder_masses",
              (T, B, H, w_tok.shape[0], len(ranges), _ranges_arg(ranges)),
              (tok, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0,
               w_out, b_out, *bufs, masses), T, B, H, dev)
    return (masses, *bufs)


def _bwd_buffers(T, B, H, Vp, dev, head: bool = True):
    """(transpose of a weight, scratch list, outputs list) of a backward:
    scratch dlogits, dh2_head (both only with a head), s1x, s1h, s2x, s2h;
    outputs dw_tok, dpre_z, dwhh1, dbhh1, dwih2, dbih2, dwhh2, dbhh2, dh1_0
    and, with a head, dw_out, db_out."""
    G = 3 * H
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = ([torch.empty((T, B, Vp), **f32),
                torch.empty((T, B, H), **f32)] if head else []) + [
        torch.empty((T, B, G), **f32) for _ in range(4)]
    outs = [torch.empty(s, **f32) for s in (
        (Vp, G), (B, G), (H, G), (G,), (H, G), (G,), (H, G), (G,), (B, H))
        + (((H, Vp), (Vp,)) if head else ())]
    return (lambda w: w.t().contiguous()), scratch, outs


def _launch_teacher_bwd(g2, tok_t, h1_seq, h2_seq, g41, g42, whh1, wih2,
                        whh2, h1_0, Vp: int):
    """fader_decoder_teacher_bwd: (dw_tok, dpre_z, dwhh1, dbhh1, dwih2,
    dbih2, dwhh2, dbhh2, dh1_0) from g2 (T, B, H), the cotangent of
    h2_seq."""
    T, B, H = h1_seq.shape
    dev = h1_0.device
    tr, scratch, outs = _bwd_buffers(T, B, H, Vp, dev, head=False)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        red, n_red = _build.entry_scratch(
            lib.fader_decoder_bwd_scratch_floats, (T, B, H, Vp), dev)
        err = lib.fader_decoder_teacher_bwd(
            T, B, H, Vp, *(t.data_ptr() for t in (
                tok_t, g2, h1_seq, h2_seq, g41, g42, h1_0, tr(whh1),
                tr(wih2), tr(whh2), *scratch, *outs, red)), n_red,
            cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_teacher_bwd")
    del scratch, red
    return tuple(outs)


def _launch_bwd(g, tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1, wih2, whh2,
                h1_0, w_out, b_out):
    """fader_decoder_ce_bwd(_bf16): (dw_tok, dpre_z, dwhh1, dbhh1, dwih2,
    dbih2, dwhh2, dbhh2, dh1_0, dw_out, db_out), float32; g float32, the
    forward's tensors and the weights in h1_0's dtype."""
    T, B, H = h1_seq.shape
    Vp = w_out.shape[1]
    dev = h1_0.device
    tr, scratch, outs = _bwd_buffers(T, B, H, Vp, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        red, n_red = _build.entry_scratch(
            lib.fader_decoder_bwd_scratch_floats, (T, B, H, Vp), dev)
        name = cuda_gru.key("fader_decoder_ce_bwd", h1_0.dtype)
        err = getattr(lib, name)(
            T, B, H, Vp, *(t.data_ptr() for t in (
                tok_t, tgt_t, g, h1_seq, h2_seq, g41, g42, h1_0, tr(whh1),
                tr(wih2), tr(whh2), w_out, b_out, tr(w_out), *scratch,
                *outs, red)), n_red, cuda_gru._stream(dev))
    _build.check(err, name)
    del scratch, red
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
        red, n_red = _build.entry_scratch(
            lib.fader_decoder_bwd_scratch_floats, (T, B, H, Vp), dev)
        err = lib.fader_decoder_masses_bwd(
            T, B, H, Vp, n_rep, len(ranges), _ranges_arg(ranges),
            *(_ptr(t) for t in (
                tok_t, g, h1_seq, h2_seq, g41, g42, h1_0, tr(whh1),
                tr(wih2), tr(whh2), w_out, b_out, tr(w_out), *scratch,
                fold, *outs, red)), n_red, cuda_gru._stream(dev))
    _build.check(err, "fader_decoder_masses_bwd")
    del scratch, fold, red
    return tuple(outs)


class DecoderTeacher(torch.autograd.Function):
    """Kernels 7 (forward with the two gate stashes) and 8 (backward) as
    one differentiable op over (tok_t, w_tok, pre_z, whh1, bhh1, wih2,
    bih2, whh2, bhh2, h1_0) -> h2_seq (T, B, H)."""

    @staticmethod
    def forward(ctx, tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
                h1_0):
        h1_seq, h2_seq, g41, g42 = _launch_teacher_fwd(
            tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0,
            stash=True)
        LAUNCHES["decoder_teacher"] += 1
        ctx.save_for_backward(tok_t, h1_seq, h2_seq, g41, g42, whh1, wih2,
                              whh2, h1_0)
        ctx.Vp = w_tok.shape[0]
        return h2_seq

    @staticmethod
    def backward(ctx, g2):
        saved = ctx.saved_tensors
        # the cotangent usually arrives as a transposed view of a (B, T, H)
        # tensor: the kernel reads (T, B, H) rows
        grads = _launch_teacher_bwd(g2.contiguous(), *saved, ctx.Vp)
        LAUNCHES["decoder_teacher_bwd"] += 1
        del saved
        return cuda_gru._mask(ctx, (None,) + grads)


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
        LAUNCHES[cuda_gru.key("decoder_ce", h1_0.dtype)] += 1
        ctx.save_for_backward(tok_t, tgt_t, h1_seq, h2_seq, g41, g42, whh1,
                              wih2, whh2, h1_0, w_out, b_out)
        return nll

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        dt = saved[9].dtype
        grads = _launch_bwd(g.float().contiguous(), *saved)
        LAUNCHES[cuda_gru.key("decoder_ce_bwd", dt)] += 1
        del saved
        return cuda_gru._mask(ctx, (None, None)
                              + cuda_gru._returned(grads, dt))


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


def decoder_teacher(tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
                    h1_0):
    """Layer 2's states h2_seq (T, B, H) of the teacher-forced decode. CPU
    tensors take the plain version; CUDA tensors launch the kernels,
    through `DecoderTeacher` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    args = (tok_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0)
    kernel = cuda_gru.kernel_device(args) is not None
    _float_dtype(_REC_NAMES, args[1:], kernel, "decoder_teacher (kernels 7/8)")
    if not kernel:
        LAST_TRAIN_PATH = "plain-cpu"
        return decoder_teacher_plain(*args)
    T, B = tok_t.shape
    _check(tok_t, B, *args[1:])
    args = tuple(t.contiguous() for t in args)
    LAST_TRAIN_PATH = "kernel"
    if T * B == 0:
        return h1_0.new_zeros((T, B, h1_0.shape[-1]))
    if cuda_gru.wants_grad(*args[1:]):
        return DecoderTeacher.apply(*args)
    h2_seq = _launch_teacher_fwd(*args, stash=False)[1]
    LAUNCHES["decoder_teacher"] += 1
    return h2_seq


def decoder_teacher_nll(tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2,
                        whh2, bhh2, h1_0, w_out, b_out):
    """Per-position NLL (T, B) of the teacher-forced decode. CPU tensors
    take the plain version; CUDA tensors launch the kernels, through
    `DecoderNLL` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    args = (tok_t, tgt_t, w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2,
            h1_0, w_out, b_out)
    if cuda_gru.kernel_device(args) is None:
        _float_dtype(_REC_NAMES + ("w_out", "b_out"), args[2:], False)
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
    LAUNCHES[cuda_gru.key("decoder_ce", h1_0.dtype)] += 1
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
    kernel = cuda_gru.kernel_device(args) is not None
    _float_dtype(_REC_NAMES + ("w_out", "b_out"), args[1:], kernel,
                 "decoder_teacher_masses (kernels 9/10, masses head)")
    if not kernel:
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


def _recurrence_args(p: Dict, z: torch.Tensor, tokens: torch.Tensor,
                     V: int):
    """The recurrence's inputs from the decoder's params, z (B, Zt) and the
    token rows (B0, T): tok_t (T, B0) = [start = V-1, tokens[:, :-1]] and
    (w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0)."""
    w_tok, w_z = _dec_w_split(p, V)
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    pre_z = z @ w_z + g1["b_ih"]
    init = p["linear_init_global"]
    h1_0 = z @ init["w"] + init["b"]
    tgt = tokens.to(torch.int32)
    start = torch.full((tgt.shape[0], 1), V - 1, dtype=torch.int32,
                       device=tgt.device)
    tok_t = torch.cat([start, tgt[:, :-1]], dim=1).t()
    return tok_t, (w_tok, pre_z, g1["w_hh"], g1["b_hh"], g2["w_ih"],
                   g2["b_ih"], g2["w_hh"], g2["b_hh"], h1_0)


def _fused_args(p: Dict, z: torch.Tensor, tokens: torch.Tensor, V: int):
    """`_recurrence_args` and the head padded to Vp (pad logits -1e30):
    tok_t and (w_tok, ..., h1_0, w_out, b_out)."""
    tok_t, weights = _recurrence_args(p, z, tokens, V)
    Vp = weights[0].shape[0]
    w_out = F.pad(p["linear_out_g"]["w"], (0, Vp - V))
    b_out = F.pad(p["linear_out_g"]["b"], (0, Vp - V), value=PAD_LOGIT)
    return tok_t, weights + (w_out, b_out)


def decoder_teacher_fused(p: Dict, z: torch.Tensor, tokens: torch.Tensor,
                          V: int) -> torch.Tensor:
    """Teacher decode without a head: layer 2's states (B, T, H) over the
    inputs [start = V-1, tokens[:, :-1]]; the logits head stays with the
    caller (one product over all T*B rows)."""
    tok_t, weights = _recurrence_args(p, z, tokens, V)
    return decoder_teacher(tok_t, *weights).transpose(0, 1)     # (B, T, H)


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
