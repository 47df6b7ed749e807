"""The generic stacked-GRU kernels (`csrc/stacked_gru.cu`) and their plain
PyTorch version.

Counterpart of `music_fader_nets_tpu/ops/pallas_gru.py::stacked_gru_pallas`
(:332, forward `_fwd_kernel` :147, backward `_bwd_kernel` :238) and
`stacked_gru_scan_pallas` (:361): L independent GRU directions of equal
length over precomputed input projections `pre` (L, T, B, 3H), b_ih
included and reversed directions already time-flipped, returning h_seq
(L, T, B, H). Its callers: the CVAE encoder (input [one-hot, densities],
no token ids), the sub-decoders without class ids and the teacher decode
without tokens (`ops/gru.py::stacked_gru_scan` / `stacked_gru_seq`). The
hoisted projection and its weight gradient stay torch ops, as the JAX
package left them to XLA.

The wrapper runs the plain version for tensors on the CPU and the kernels
for tensors on a GPU; there is no fallback between the two. On a GPU, a
call whose float inputs want a gradient goes through `StackedGRU`
(forward with the gate stash, backward kernel); otherwise the forward runs
without the stash.
"""
from __future__ import annotations

import torch

from music_fader_nets_tpu_torch.ops import _build, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import _gates

# wrapper calls that launched each kernel (forward: T device launches;
# backward: T + 2)
LAUNCHES = {"stacked_gru": 0, "stacked_gru_bwd": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_TRAIN_PATH = None


def stacked_gru_plain(pre, w_hh, b_hh, h0):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    pre (L, T, B, 3H); w_hh (L, H, 3H); b_hh (L, 3H); h0 (L, B, H).
    Returns h_seq (L, T, B, H)."""
    h, outs = h0, []
    for t in range(pre.shape[1]):
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre[:, t], pre_h, h)
        outs.append(h)
    if not outs:
        return h0.new_zeros((h0.shape[0], 0) + tuple(h0.shape[1:]))
    return torch.stack(outs, dim=1)


def _check(pre, w_hh, b_hh, h0):
    L, T, B, G = pre.shape
    H = h0.shape[-1]
    want = {"pre": (L, T, B, 3 * H), "w_hh": (L, H, 3 * H),
            "b_hh": (L, 3 * H), "h0": (L, B, H)}
    got = {"pre": pre, "w_hh": w_hh, "b_hh": b_hh, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
        if got[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{got[name].dtype}")


def _launch_fwd(pre, w_hh, b_hh, h0, stash: bool):
    """fader_stacked_gru: h_seq (L, T, B, H) and, when `stash`, the gate
    stash (L, T, B, 4H); T >= 1."""
    L, T, B, _ = pre.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    h_seq = torch.empty((L, T, B, H), dtype=torch.float32, device=dev)
    st = (torch.empty((L, T, B, 4 * H), dtype=torch.float32, device=dev)
          if stash else None)
    with torch.cuda.device(dev):
        err = lib.fader_stacked_gru(
            L, T, B, H, pre.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), h_seq.data_ptr(),
            None if st is None else st.data_ptr(), cuda_gru._stream(dev))
    _build.check(err, "fader_stacked_gru")
    return h_seq, st


def _launch_bwd(g, stash, h_seq, h0, w_hh):
    """fader_stacked_gru_bwd: (dpre (L,T,B,3H), dw_hh, db_hh, dh0)."""
    L, T, B, H = h_seq.shape
    G = 3 * H
    dev = h0.device
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    w_hhT = w_hh.transpose(1, 2).contiguous()
    dh_buf = torch.empty((2, L, B, H), **f32)
    dph = torch.empty((L, T, B, G), **f32)
    dpre = torch.empty((L, T, B, G), **f32)
    dw_hh = torch.empty((L, H, G), **f32)
    db_hh = torch.empty((L, G), **f32)
    dh0 = torch.empty((L, B, H), **f32)
    with torch.cuda.device(dev):
        err = lib.fader_stacked_gru_bwd(
            L, T, B, H, *(t.data_ptr() for t in (
                g, stash, h_seq, h0, w_hhT, dh_buf, dph, dpre, dw_hh, db_hh,
                dh0)), cuda_gru._stream(dev))
    _build.check(err, "fader_stacked_gru_bwd")
    return dpre, dw_hh, db_hh, dh0


class StackedGRU(torch.autograd.Function):
    """Kernels 1 (forward with the gate stash) and 2 (backward from the
    h_seq cotangent) as one differentiable op over (pre, w_hh, b_hh, h0);
    the backward returns (dpre, dw_hh, db_hh, dh0), as `_vjp_bwd`
    (pallas_gru.py:347-355) does."""

    @staticmethod
    def forward(ctx, pre, w_hh, b_hh, h0):
        h_seq, stash = _launch_fwd(pre, w_hh, b_hh, h0, True)
        LAUNCHES["stacked_gru"] += 1
        ctx.save_for_backward(w_hh, h0, h_seq, stash)
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        w_hh, h0, h_seq, stash = ctx.saved_tensors
        grads = _launch_bwd(g_seq.contiguous(), stash, h_seq, h0, w_hh)
        LAUNCHES["stacked_gru_bwd"] += 1
        del h_seq, stash
        return cuda_gru._mask(ctx, grads)


def stacked_gru(pre, w_hh, b_hh, h0):
    """h_seq (L, T, B, H) of L GRU directions over input projections pre
    (L, T, B, 3H). CPU tensors take the plain version; CUDA tensors launch
    the kernels, through `StackedGRU` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    tensors = (pre, w_hh, b_hh, h0)
    if cuda_gru.kernel_device(tensors) is None:
        LAST_TRAIN_PATH = "plain-cpu"
        return stacked_gru_plain(*tensors)
    _check(*tensors)
    pre, w_hh, b_hh, h0 = (t.contiguous() for t in tensors)
    L, T, B, _ = pre.shape
    LAST_TRAIN_PATH = "kernel"
    if T == 0 or L * B * h0.shape[-1] == 0:
        return h0.new_zeros((L, T, B, h0.shape[-1]))
    if cuda_gru.wants_grad(*tensors):
        return StackedGRU.apply(pre, w_hh, b_hh, h0)
    h_seq, _ = _launch_fwd(pre, w_hh, b_hh, h0, False)
    LAUNCHES["stacked_gru"] += 1
    return h_seq
