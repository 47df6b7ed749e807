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
the encoder takes the serving kernel (finals only, no stash).
"""
from __future__ import annotations

import torch

from music_fader_nets_tpu_torch.ops import _build
from music_fader_nets_tpu_torch.ops.gru import _gates

# wrapper calls that launched each kernel (one call = T device launches of
# its recurrence, plus the backward's reductions)
LAUNCHES = {"embed_gru": 0, "embed_gru_train": 0, "embed_gru_bwd": 0,
            "embed_seq": 0, "embed_seq_bwd": 0}
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
    w_hh (L, H, 3H); h0 (L, B, H). Returns finals (L, B, H)."""
    h = h0
    for t in range(tok_lt.shape[1]):
        pre_x = _rows(w_ih, tok_lt[:, t]) + b_ih[:, None, :]
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre_x, pre_h, h)
    return h


def stacked_gru_embed_seq_plain(cls_lt, w_emb, prez, w_hh, b_hh, h0):
    """Plain PyTorch version of the sub-decoders' recurrence.
    cls_lt (L, T, B) int; w_emb (L, C, 3H); prez (L, B, 3H); w_hh
    (L, H, 3H); b_hh (L, 3H); h0 (L, B, H). Returns h_seq (L, T, B, H)."""
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
        if got[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{got[name].dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_train_fwd(ids, w_in, add, w_hh, b_hh, h0, stash: bool):
    """fader_embed_gru_train: h_seq (L, T, B, H) and, when `stash`, the
    gate stash (L, T, B, 4H); T >= 1."""
    L, T, B = ids.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    h_seq = torch.empty((L, T, B, H), dtype=torch.float32, device=dev)
    st = (torch.empty((L, T, B, 4 * H), dtype=torch.float32, device=dev)
          if stash else None)
    add_bs = 3 * H if add.dim() == 3 else 0
    with torch.cuda.device(dev):
        err = lib.fader_embed_gru_train(
            L, T, B, H, w_in.shape[1], add_bs, ids.data_ptr(),
            w_in.data_ptr(), add.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), h0.data_ptr(), h_seq.data_ptr(),
            None if st is None else st.data_ptr(), _stream(dev))
    _build.check(err, "fader_embed_gru_train")
    return h_seq, st


def _launch_bwd(ids, g, seq_grad: bool, stash, h_seq, h0, w_hh, V: int,
                want_db_in: bool, want_dprez: bool):
    """fader_embed_gru_bwd: (dw_in (L,V,3H), db_in (L,3H) or None, dprez
    (L,B,3H) or None, dw_hh, db_hh, dh0)."""
    L, T, B = ids.shape
    H = h0.shape[-1]
    G = 3 * H
    dev = h0.device
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    w_hhT = w_hh.transpose(1, 2).contiguous()
    dh_buf = torch.empty((2, L, B, H), **f32)
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
        err = lib.fader_embed_gru_bwd(
            L, T, B, H, V, int(seq_grad), ids.data_ptr(), g.data_ptr(),
            stash.data_ptr(), h_seq.data_ptr(), h0.data_ptr(),
            w_hhT.data_ptr(), dh_buf.data_ptr(), dpx.data_ptr(),
            dph.data_ptr(), dw_in.data_ptr(), ptr(db_in), ptr(dprez),
            dw_hh.data_ptr(), db_hh.data_ptr(), dh0.data_ptr(), _stream(dev))
    _build.check(err, "fader_embed_gru_bwd")
    return dw_in, db_in, dprez, dw_hh, db_hh, dh0


def _mask(ctx, grads):
    """None for every input that asked for no gradient."""
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


class EmbedFinals(torch.autograd.Function):
    """Kernels 3 (training variant, gate stash) and 4 (backward from the
    final-state cotangent) as one differentiable op."""

    @staticmethod
    def forward(ctx, tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
        h_seq, stash = _launch_train_fwd(tok_lt, w_ih, b_ih, w_hh, b_hh, h0,
                                         True)
        LAUNCHES["embed_gru_train"] += 1
        ctx.save_for_backward(tok_lt, w_hh, h0, h_seq, stash)
        ctx.V = w_ih.shape[1]
        return h_seq[:, -1].contiguous()

    @staticmethod
    def backward(ctx, g_fin):
        tok_lt, w_hh, h0, h_seq, stash = ctx.saved_tensors
        dw_ih, db_ih, _, dw_hh, db_hh, dh0 = _launch_bwd(
            tok_lt, g_fin.contiguous(), False, stash, h_seq, h0, w_hh, ctx.V,
            want_db_in=True, want_dprez=False)
        LAUNCHES["embed_gru_bwd"] += 1
        del h_seq, stash
        return _mask(ctx, (None, dw_ih, db_ih, dw_hh, db_hh, dh0))


class EmbedSeq(torch.autograd.Function):
    """Kernels 5 (forward with the gate stash) and 6 (backward from the
    per-step cotangent) as one differentiable op."""

    @staticmethod
    def forward(ctx, cls_lt, w_emb, prez, w_hh, b_hh, h0):
        h_seq, stash = _launch_train_fwd(cls_lt, w_emb, prez, w_hh, b_hh, h0,
                                         True)
        LAUNCHES["embed_seq"] += 1
        ctx.save_for_backward(cls_lt, w_hh, h0, h_seq, stash)
        ctx.V = w_emb.shape[1]
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        cls_lt, w_hh, h0, h_seq, stash = ctx.saved_tensors
        dw_emb, _, dprez, dw_hh, db_hh, dh0 = _launch_bwd(
            cls_lt, g_seq.contiguous(), True, stash, h_seq, h0, w_hh, ctx.V,
            want_db_in=False, want_dprez=True)
        LAUNCHES["embed_seq_bwd"] += 1
        del h_seq, stash
        return _mask(ctx, (None, dw_emb, dprez, dw_hh, db_hh, dh0))


def _launch_finals(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """The serving kernel, fader_embed_gru_finals: finals only, no stash."""
    L, T, B = tok_lt.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    h_buf = torch.empty((2, L, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fader_embed_gru_finals(
            L, T, B, H, w_ih.shape[1], tok_lt.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), h_buf.data_ptr(), finals.data_ptr(), _stream(dev))
    _build.check(err, "fader_embed_gru_finals")
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
    LAUNCHES["embed_gru"] += 1
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
    LAUNCHES["embed_seq"] += 1
    return h_seq
