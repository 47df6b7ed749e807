"""The embedded-id GRU kernels (`csrc/embed_gru.cu`, `csrc/embed_gru_bwd.cu`)
and their plain PyTorch versions.

Counterparts of `music_fader_nets_tpu/ops/pallas_gru.py`:

- `stacked_gru_embed_finals` (:667): L stacked GRU directions over int32
  tokens whose input projection is the row `w_ih[l, tok]` (+ b_ih),
  returning only the final states — the encoder.
- `stacked_gru_embed_seq` (:1001): L directions over int32 class ids whose
  input projection is `w_emb[l, cls] + prez[l, b]`, returning the whole
  h_seq — the sub-decoders.

Each wrapper runs the plain version for tensors on the CPU and a kernel for
tensors on a GPU; there is no fallback between the two. On a GPU, a call
whose float inputs want a gradient goes through a `torch.autograd.Function`
(training forward with the gate stash, backward kernel); without a gradient
the encoder takes the serving entry (finals only, no stash). Every forward
entry is one cooperative launch of the persistent forward chain
(`csrc/gru_fwd_chain.cu`) whatever T is; a grid the card cannot hold at
once is an error, raised here.

bfloat16 (the mixed-precision objectives, `ModelConfig(dtype="bfloat16")`):
float inputs that are all bfloat16 take the kernels' bf16 instantiations
on a GPU and, on the CPU, the plain versions' bf16 branches; a mix of
float dtypes raises. Both round where the Pallas kernels write a bf16
output ref (h_seq, finals, the gate stash) and nowhere else: the carry,
the gates, every product and the backward's dpre rows and sums stay
float32, the backward reads the rounded h_seq and stash, and each gradient
is rounded to bf16 once, when it is returned (pallas_gru.py:654-658).
"""
from __future__ import annotations

import torch

from music_fader_nets_tpu_torch.ops import _build
from music_fader_nets_tpu_torch.ops.gru import _gates

# wrapper calls that launched each kernel (a forward call = one cooperative
# launch of the whole chain; a backward call = one cooperative launch of
# the backward chain, plus the reductions)
LAUNCHES = {"embed_gru": 0, "embed_gru_train": 0, "embed_gru_bwd": 0,
            "embed_seq": 0, "embed_seq_bwd": 0,
            # the bf16 instantiations of the same kernels
            "embed_gru_bf16": 0, "embed_gru_train_bf16": 0,
            "embed_gru_bwd_bf16": 0, "embed_seq_bf16": 0,
            "embed_seq_bwd_bf16": 0}
# most class-table rows the sub-decoders' backward sums inside its chain
# (`csrc/embed_gru_bwd.cu::kSeqClasses`); a larger table (the JAX path's
# padded 128-row one) takes the generic entry, its dpre_x stash and the
# class scatter after the chain
SEQ_CLASSES = 16
# which path served the last encoder call: "kernel" or "plain-cpu"
LAST_ENCODE_PATH = None
# which path served the last call that builds a gradient (encoder with
# grad, or sub-decoders): "kernel" or "plain-cpu"
LAST_TRAIN_PATH = None


def kernel_device(tensors):
    """The CUDA device of `tensors`, or None when they lie on the CPU (the
    plain version serves them). Raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


def wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


BF16 = torch.bfloat16


def float_dtype(named: dict, kernel: bool) -> torch.dtype:
    """The one dtype of the float tensors in `named` (name -> tensor). A
    kernel takes float32, or bfloat16 on all of them together; the CPU's
    plain versions any one float dtype. Raises ValueError on a mix."""
    dts = {t.dtype for t in named.values()}
    if len(dts) == 1:
        dt = next(iter(dts))
        if dt in (torch.float32, BF16) or (not kernel and dt.is_floating_point):
            return dt
    got = ", ".join(f"{n} {t.dtype}" for n, t in named.items())
    raise ValueError("float inputs must be all float32 or all bfloat16 "
                     f"(mixed precision), got {got}")


def key(name: str, dtype: torch.dtype) -> str:
    """The LAUNCHES key of kernel `name` in `dtype`."""
    return name + "_bf16" if dtype == BF16 else name


def entry(lib, name: str, dtype: torch.dtype):
    """The library entry `name`, or its bf16 instantiation."""
    return getattr(lib, key(name, dtype))


def round_bf16(grads):
    """Gradients computed in float32 rounded to bf16 (None kept), as the
    Pallas backward's wrappers round theirs to the input's dtype."""
    return tuple(None if g is None else g.to(BF16) for g in grads)


# ---- bf16 plain versions: float32 arithmetic on the widened inputs,
# bf16 where the Pallas kernels write a bf16 output ref

def gates_stash(pre_x, pre_h, h):
    """`ops/gru.py::_gates`, also returning the gate stash [r, z, n, hn]
    (..., 4H) the training kernels keep: (h', stash)."""
    xr, xz, xn = pre_x.chunk(3, dim=-1)
    hr, hz, hn = pre_h.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, torch.cat([r, z, n, hn], dim=-1)


def chain_fwd32(xpre, w_hh, b_hh, h0, T: int):
    """The float32 recurrence of L chains: xpre(t) -> (L, B, 3H) input
    projections; w_hh (L, H, 3H), b_hh (L, 3H), h0 (L, B, H), all float32.
    Returns (h_seq (L, T, B, H), stash (L, T, B, 4H)), float32."""
    h, hs, sts = h0, [], []
    for t in range(T):
        h, st = gates_stash(xpre(t), torch.bmm(h, w_hh) + b_hh[:, None, :], h)
        hs.append(h)
        sts.append(st)
    return torch.stack(hs, dim=1), torch.stack(sts, dim=1)


def chain_bwd32(g, every_step: bool, stash, h_seq, h0, w_hh):
    """The Pallas backward chain (`_gate_bwd`, pallas_gru.py:1205) in
    float32 from the stash and h_seq it was handed: g (L, T, B, H) on every
    step or (L, B, H) on the last; stash (L, T, B, 4H), h_seq (L, T, B,
    H), h0 (L, B, H), w_hh (L, H, 3H), all float32. Returns (dpx, dph)
    (L, T, B, 3H) and dh0 (L, B, H)."""
    L, T, B, H = h_seq.shape
    dh = torch.zeros_like(h0)
    w_t = w_hh.transpose(1, 2)
    dpx, dph = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        if every_step:
            dh = dh + g[:, t]
        elif t == T - 1:
            dh = dh + g
        r, z, n, hn = stash[:, t].chunk(4, dim=-1)
        hp = h0 if t == 0 else h_seq[:, t - 1]
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        dan = dn * (1.0 - n * n)
        dr = dan * hn
        dhn = dan * r
        dar = dr * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dpx[t] = torch.cat([dar, daz, dan], dim=-1)
        dph[t] = torch.cat([dar, daz, dhn], dim=-1)
        dh = dh * z + torch.bmm(dph[t], w_t)
    return torch.stack(dpx, dim=1), torch.stack(dph, dim=1), dh


def w_hh_grads(h_seq, h0, dph):
    """dW_hh = h_prev^T dph (h_prev: h0, then h_seq a step behind) and
    db_hh = sum of dph, float32."""
    h_prev = torch.cat([h0[:, None], h_seq[:, :-1]], dim=1)
    return (torch.einsum("ltbh,ltbg->lhg", h_prev, dph), dph.sum(dim=(1, 2)))


def scatter_rows(ids, dpx, V: int):
    """out[l, v] = sum of dpx[l, t, b] over the (t, b) with ids == v (ids
    outside [0, V) add nothing): the one-hot product of the Pallas
    kernels' dW_in accumulation, float32."""
    L, T, B, G = dpx.shape
    ids = ids.long().reshape(L, T * B)
    oh = ((ids[..., None] == torch.arange(V, device=ids.device))
          .to(dpx.dtype))                                     # (L, TB, V)
    return torch.bmm(oh.transpose(1, 2), dpx.reshape(L, T * B, G))


def _table_xpre(ids, w_in32, add32, per_row: bool):
    """xpre(t) of the gathered chain: w_in[l, ids[l, t, b]] + add[l(, b)]
    in float32, never rounded (pallas_gru.py:416-425)."""
    def xpre(t):
        a = add32 if per_row else add32[:, None, :]
        return _rows(w_in32, ids[:, t]) + a
    return xpre


class _EmbedBf16Plain(torch.autograd.Function):
    """The bf16 plain version of kernels 3t/4 (`seq_grad` False: the
    finals' cotangent) and 5/6 (`seq_grad` True: h_seq's, prez per row)."""

    @staticmethod
    def forward(ctx, ids, w_in, add, w_hh, b_hh, h0, seq_grad):
        T = ids.shape[1]
        h_seq32, stash32 = chain_fwd32(
            _table_xpre(ids, w_in.float(), add.float(), seq_grad),
            w_hh.float(), b_hh.float(), h0.float(), T)
        h_seq, stash = h_seq32.to(BF16), stash32.to(BF16)
        ctx.save_for_backward(ids, w_hh, h0, h_seq, stash)
        ctx.V, ctx.seq_grad = w_in.shape[1], seq_grad
        return h_seq if seq_grad else h_seq[:, -1].contiguous()

    @staticmethod
    def backward(ctx, g):
        ids, w_hh, h0, h_seq, stash = ctx.saved_tensors
        h_seq32, h032 = h_seq.float(), h0.float()
        dpx, dph, dh0 = chain_bwd32(g.to(BF16).float(), ctx.seq_grad,
                                    stash.float(), h_seq32, h032,
                                    w_hh.float())
        dw_in = scatter_rows(ids, dpx, ctx.V)
        dadd = dpx.sum(dim=1) if ctx.seq_grad else dpx.sum(dim=(1, 2))
        dw_hh, db_hh = w_hh_grads(h_seq32, h032, dph)
        return (None,) + round_bf16((dw_in, dadd, dw_hh, db_hh, dh0)) + (
            None,)


def _embed_finals_bf16(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """bf16 plain version of `stacked_gru_embed_finals` (kernels 3t/4; the
    serving variant 3 without a gradient): finals (L, B, H) bf16."""
    if tok_lt.shape[1] == 0:
        return h0.clone()
    return _EmbedBf16Plain.apply(tok_lt, w_ih, b_ih, w_hh, b_hh, h0, False)


def _embed_seq_bf16(cls_lt, w_emb, prez, w_hh, b_hh, h0):
    """bf16 plain version of `stacked_gru_embed_seq` (kernels 5/6): h_seq
    (L, T, B, H) bf16."""
    L, T, B = cls_lt.shape
    if T == 0:
        return h0.new_zeros((L, 0, B, h0.shape[-1]))
    return _EmbedBf16Plain.apply(cls_lt, w_emb, prez, w_hh, b_hh, h0, True)


def _rows(w, ids):
    """w[l, ids[l, b]] for each l, zero where an id lies outside w's rows
    (a one-hot of such an id is all zeros)."""
    L, V = w.shape[0], w.shape[1]
    ids = ids.long()
    valid = ((ids >= 0) & (ids < V)).unsqueeze(-1)
    lidx = torch.arange(L, device=ids.device)[:, None]
    return torch.where(valid, w[lidx, ids.clamp(0, V - 1)], 0.0)


def stacked_gru_embed_finals_plain(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    tok_lt (L, T, B) int; w_ih (L, Vp, 3H); b_ih/b_hh (L, 3H);
    w_hh (L, H, 3H); h0 (L, B, H). Returns finals (L, B, H). bf16 inputs
    take `_embed_finals_bf16`."""
    if h0.dtype == BF16:
        return _embed_finals_bf16(tok_lt, w_ih, b_ih, w_hh, b_hh, h0)
    h = h0
    for t in range(tok_lt.shape[1]):
        pre_x = _rows(w_ih, tok_lt[:, t]) + b_ih[:, None, :]
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre_x, pre_h, h)
    return h


def stacked_gru_embed_seq_plain(cls_lt, w_emb, prez, w_hh, b_hh, h0):
    """Plain PyTorch version of the sub-decoders' recurrence.
    cls_lt (L, T, B) int; w_emb (L, C, 3H); prez (L, B, 3H); w_hh
    (L, H, 3H); b_hh (L, 3H); h0 (L, B, H). Returns h_seq (L, T, B, H).
    bf16 inputs take `_embed_seq_bf16`."""
    if h0.dtype == BF16:
        return _embed_seq_bf16(cls_lt, w_emb, prez, w_hh, b_hh, h0)
    L, T, B = cls_lt.shape
    h, outs = h0, []
    for t in range(T):
        pre_x = _rows(w_emb, cls_lt[:, t]) + prez
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre_x, pre_h, h)
        outs.append(h)
    if not outs:
        return h0.new_zeros((L, 0, B, h0.shape[-1]))
    return torch.stack(outs, dim=1)


def _check_shapes(ids, w_in, add, w_hh, b_hh, h0, add_per_row: bool):
    L, T, B = ids.shape
    H = h0.shape[-1]
    G = 3 * H
    want = {"w_in": (L, w_in.shape[1], G),
            "add": (L, B, G) if add_per_row else (L, G),
            "w_hh": (L, H, G), "b_hh": (L, G), "h0": (L, B, H)}
    got = {"w_in": w_in, "add": add, "w_hh": w_hh, "b_hh": b_hh, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    float_dtype(got, kernel=True)
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_train_fwd(ids, w_in, add, w_hh, b_hh, h0, stash: bool):
    """fader_embed_gru_train(_bf16): h_seq (L, T, B, H) and, when `stash`,
    the gate stash (L, T, B, 4H), in h0's dtype; T >= 1."""
    L, T, B = ids.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    h_seq = torch.empty((L, T, B, H), dtype=h0.dtype, device=dev)
    st = (torch.empty((L, T, B, 4 * H), dtype=h0.dtype, device=dev)
          if stash else None)
    add_bs = 3 * H if add.dim() == 3 else 0
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_gru_fwd_scratch_floats, (L, B, H), dev)
        err = entry(lib, "fader_embed_gru_train", h0.dtype)(
            L, T, B, H, w_in.shape[1], add_bs, ids.data_ptr(),
            w_in.data_ptr(), add.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), h0.data_ptr(), h_seq.data_ptr(),
            None if st is None else st.data_ptr(), scratch.data_ptr(),
            n_scratch, _stream(dev))
    _build.check(err, key("fader_embed_gru_train", h0.dtype))
    return h_seq, st


def _launch_bwd(ids, g, seq_grad: bool, stash, h_seq, h0, w_hh, V: int,
                want_db_in: bool, want_dprez: bool):
    """fader_embed_gru_bwd(_bf16): (dw_in (L,V,3H), db_in (L,3H) or None,
    dprez (L,B,3H) or None, dw_hh, db_hh, dh0), float32; g float32, the
    forward's tensors and w_hh in h0's dtype."""
    L, T, B = ids.shape
    H = h0.shape[-1]
    G = 3 * H
    dev = h0.device
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    w_hhT = w_hh.transpose(1, 2).contiguous()
    dpx = torch.empty((L, T, B, G), **f32)
    dph = torch.empty((L, T, B, G), **f32)
    dw_in = torch.empty((L, V, G), **f32)
    db_in = torch.empty((L, G), **f32) if want_db_in else None
    dprez = torch.empty((L, B, G), **f32) if want_dprez else None
    dw_hh = torch.empty((L, H, G), **f32)
    db_hh = torch.empty((L, G), **f32)
    dh0 = torch.empty((L, B, H), **f32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_gru_bwd_scratch_floats, (L, T, B, H), dev)
        err = entry(lib, "fader_embed_gru_bwd", h0.dtype)(
            L, T, B, H, V, int(seq_grad), ids.data_ptr(), g.data_ptr(),
            stash.data_ptr(), h_seq.data_ptr(), h0.data_ptr(),
            w_hhT.data_ptr(), dpx.data_ptr(), dph.data_ptr(),
            dw_in.data_ptr(), ptr(db_in), ptr(dprez), dw_hh.data_ptr(),
            db_hh.data_ptr(), dh0.data_ptr(), scratch.data_ptr(), n_scratch,
            _stream(dev))
    _build.check(err, key("fader_embed_gru_bwd", h0.dtype))
    return dw_in, db_in, dprez, dw_hh, db_hh, dh0


def _launch_seq_bwd(ids, g, stash, h_seq, h0, w_hh, V: int):
    """fader_embed_seq_bwd(_bf16), the sub-decoders' backward for class
    tables of at most SEQ_CLASSES rows: (dw_emb (L,V,3H), dprez (L,B,3H),
    dw_hh, db_hh, dh0), float32."""
    L, T, B = ids.shape
    H = h0.shape[-1]
    G = 3 * H
    dev = h0.device
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    dw_emb = torch.empty((L, V, G), **f32)
    dprez = torch.empty((L, B, G), **f32)
    dw_hh = torch.empty((L, H, G), **f32)
    db_hh = torch.empty((L, G), **f32)
    dh0 = torch.empty((L, B, H), **f32)
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_embed_seq_bwd_scratch_floats, (L, T, B, H), dev)
        err = entry(lib, "fader_embed_seq_bwd", h0.dtype)(
            L, T, B, H, V, ids.data_ptr(), g.data_ptr(), stash.data_ptr(),
            h_seq.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
            dw_emb.data_ptr(), dprez.data_ptr(), dw_hh.data_ptr(),
            db_hh.data_ptr(), dh0.data_ptr(), scratch.data_ptr(), n_scratch,
            _stream(dev))
    _build.check(err, key("fader_embed_seq_bwd", h0.dtype))
    return dw_emb, dprez, dw_hh, db_hh, dh0


def _mask(ctx, grads):
    """None for every input that asked for no gradient."""
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


def _returned(grads, dtype):
    """A backward entry's float32 gradients as the op returns them: in the
    inputs' dtype (rounded once, for bf16)."""
    return round_bf16(grads) if dtype == BF16 else grads


class EmbedFinals(torch.autograd.Function):
    """Kernels 3 (training variant, gate stash) and 4 (backward from the
    final-state cotangent) as one differentiable op."""

    @staticmethod
    def forward(ctx, tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
        h_seq, stash = _launch_train_fwd(tok_lt, w_ih, b_ih, w_hh, b_hh, h0,
                                         True)
        LAUNCHES[key("embed_gru_train", h0.dtype)] += 1
        ctx.save_for_backward(tok_lt, w_hh, h0, h_seq, stash)
        ctx.V = w_ih.shape[1]
        return h_seq[:, -1].contiguous()

    @staticmethod
    def backward(ctx, g_fin):
        tok_lt, w_hh, h0, h_seq, stash = ctx.saved_tensors
        # the cotangent in the forward's dtype, as the Pallas backward's
        # wrapper casts it (pallas_gru.py:652), then read in float32
        g = g_fin.to(h0.dtype).float().contiguous()
        grads = _launch_bwd(tok_lt, g, False, stash, h_seq, h0, w_hh, ctx.V,
                            want_db_in=True, want_dprez=False)
        LAUNCHES[key("embed_gru_bwd", h0.dtype)] += 1
        del h_seq, stash
        dw_ih, db_ih, _, dw_hh, db_hh, dh0 = _returned(grads, h0.dtype)
        return _mask(ctx, (None, dw_ih, db_ih, dw_hh, db_hh, dh0))


class EmbedSeq(torch.autograd.Function):
    """Kernels 5 (forward with the gate stash) and 6 (backward from the
    per-step cotangent) as one differentiable op."""

    @staticmethod
    def forward(ctx, cls_lt, w_emb, prez, w_hh, b_hh, h0):
        h_seq, stash = _launch_train_fwd(cls_lt, w_emb, prez, w_hh, b_hh, h0,
                                         True)
        LAUNCHES[key("embed_seq", h0.dtype)] += 1
        ctx.save_for_backward(cls_lt, w_hh, h0, h_seq, stash)
        ctx.V = w_emb.shape[1]
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        cls_lt, w_hh, h0, h_seq, stash = ctx.saved_tensors
        g = g_seq.to(h0.dtype).float().contiguous()
        if ctx.V <= SEQ_CLASSES:
            dw_emb, dprez, dw_hh, db_hh, dh0 = _returned(_launch_seq_bwd(
                cls_lt, g, stash, h_seq, h0, w_hh, ctx.V), h0.dtype)
        else:
            dw_emb, _, dprez, dw_hh, db_hh, dh0 = _returned(_launch_bwd(
                cls_lt, g, True, stash, h_seq, h0, w_hh, ctx.V,
                want_db_in=False, want_dprez=True), h0.dtype)
        LAUNCHES[key("embed_seq_bwd", h0.dtype)] += 1
        del h_seq, stash
        return _mask(ctx, (None, dw_emb, dprez, dw_hh, db_hh, dh0))


def _launch_finals(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """The serving kernel, fader_embed_gru_finals(_bf16): finals only, no
    stash, in h0's dtype."""
    L, T, B = tok_lt.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    finals = torch.empty((L, B, H), dtype=h0.dtype, device=dev)
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_gru_fwd_scratch_floats, (L, B, H), dev)
        err = entry(lib, "fader_embed_gru_finals", h0.dtype)(
            L, T, B, H, w_ih.shape[1], tok_lt.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), finals.data_ptr(), scratch.data_ptr(), n_scratch,
            _stream(dev))
    _build.check(err, key("fader_embed_gru_finals", h0.dtype))
    return finals


def stacked_gru_embed_finals(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """Final states (L, B, H) of L GRU directions over tokens tok_lt
    (L, T, B) int32, already time-flipped for reversed directions.
    CPU tensors take the plain version; CUDA tensors launch a kernel: with
    a gradient wanted, the training kernels through `EmbedFinals`,
    otherwise the serving kernel."""
    global LAST_ENCODE_PATH, LAST_TRAIN_PATH
    tensors = (tok_lt, w_ih, b_ih, w_hh, b_hh, h0)
    grad = wants_grad(*tensors[1:])
    if kernel_device(tensors) is None:
        float_dtype(dict(zip(("w_ih", "b_ih", "w_hh", "b_hh", "h0"),
                             tensors[1:])), kernel=False)
        LAST_ENCODE_PATH = "plain-cpu"
        if grad:
            LAST_TRAIN_PATH = "plain-cpu"
        return stacked_gru_embed_finals_plain(*tensors)
    _check_shapes(*tensors, add_per_row=False)
    tok_lt, w_ih, b_ih, w_hh, b_hh, h0 = (t.contiguous() for t in tensors)
    L, T, B = tok_lt.shape
    LAST_ENCODE_PATH = "kernel"
    if L * B * h0.shape[-1] == 0 or (T == 0 and grad):
        return h0.clone()
    if grad:
        LAST_TRAIN_PATH = "kernel"
        return EmbedFinals.apply(tok_lt, w_ih, b_ih, w_hh, b_hh, h0)
    out = _launch_finals(tok_lt, w_ih, b_ih, w_hh, b_hh, h0)
    LAUNCHES[key("embed_gru", h0.dtype)] += 1
    return out


def stacked_gru_embed_seq(cls_lt, w_emb, prez, w_hh, b_hh, h0):
    """h_seq (L, T, B, H) of L GRU directions over class ids cls_lt
    (L, T, B) int32 with input projection `w_emb[l, cls] + prez[l, b]`.
    CPU tensors take the plain version; CUDA tensors launch the kernels,
    through `EmbedSeq` when a gradient is wanted (forward only, without
    the stash, otherwise)."""
    global LAST_TRAIN_PATH
    tensors = (cls_lt, w_emb, prez, w_hh, b_hh, h0)
    if kernel_device(tensors) is None:
        float_dtype(dict(zip(("w_emb", "prez", "w_hh", "b_hh", "h0"),
                             tensors[1:])), kernel=False)
        LAST_TRAIN_PATH = "plain-cpu"
        return stacked_gru_embed_seq_plain(*tensors)
    _check_shapes(*tensors, add_per_row=True)
    cls_lt, w_emb, prez, w_hh, b_hh, h0 = (t.contiguous() for t in tensors)
    L, T, B = cls_lt.shape
    LAST_TRAIN_PATH = "kernel"
    if T == 0 or L * B * h0.shape[-1] == 0:
        return h0.new_zeros((L, T, B, h0.shape[-1]))
    if wants_grad(*tensors[1:]):
        return EmbedSeq.apply(cls_lt, w_emb, prez, w_hh, b_hh, h0)
    h_seq, _ = _launch_train_fwd(cls_lt, w_emb, prez, w_hh, b_hh, h0, False)
    LAUNCHES[key("embed_seq", h0.dtype)] += 1
    return h_seq
