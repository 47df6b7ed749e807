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

bfloat16 inputs (all of pre, w_hh, b_hh, h0) take the kernels' bf16
instantiations on a GPU and the plain version's bf16 branch on the CPU,
with the
rounding rule of `ops/cuda_gru.py`: h_seq and the stash bf16, the carry
and every product float32, dpre and the gradients rounded once. One
difference from the Pallas kernel 2, which recomputes its gates in float32
from the rounded h_seq (pallas_gru.py:254-260): here, as for kernels
4/6/10, the backward reads the forward's bf16 gate stash.
"""
from __future__ import annotations

import torch

from music_fader_nets_tpu_torch.ops import _build, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import _gates

# wrapper calls that launched each kernel (forward: one cooperative launch
# of the whole recurrence; backward: one of the whole chain, then the
# split-K GEMM with its sum and the column sums with theirs)
LAUNCHES = {"stacked_gru": 0, "stacked_gru_bwd": 0,
            # the bf16 instantiations
            "stacked_gru_bf16": 0, "stacked_gru_bwd_bf16": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_TRAIN_PATH = None


def stacked_gru_plain(pre, w_hh, b_hh, h0):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    pre (L, T, B, 3H); w_hh (L, H, 3H); b_hh (L, 3H); h0 (L, B, H).
    Returns h_seq (L, T, B, H). bf16 inputs take `_stacked_bf16`."""
    if h0.dtype == cuda_gru.BF16:
        return _stacked_bf16(pre, w_hh, b_hh, h0)
    h, outs = h0, []
    for t in range(pre.shape[1]):
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre[:, t], pre_h, h)
        outs.append(h)
    if not outs:
        return h0.new_zeros((h0.shape[0], 0) + tuple(h0.shape[1:]))
    return torch.stack(outs, dim=1)


class _StackedBf16Plain(torch.autograd.Function):
    """The bf16 plain version of kernels 1/2."""

    @staticmethod
    def forward(ctx, pre, w_hh, b_hh, h0):
        pre32 = pre.float()
        h_seq32, stash32 = cuda_gru.chain_fwd32(
            lambda t: pre32[:, t], w_hh.float(), b_hh.float(), h0.float(),
            pre.shape[1])
        h_seq, stash = h_seq32.to(cuda_gru.BF16), stash32.to(cuda_gru.BF16)
        ctx.save_for_backward(w_hh, h0, h_seq, stash)
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        w_hh, h0, h_seq, stash = ctx.saved_tensors
        h_seq32, h032 = h_seq.float(), h0.float()
        dpx, dph, dh0 = cuda_gru.chain_bwd32(
            g_seq.to(cuda_gru.BF16).float(), True, stash.float(), h_seq32,
            h032, w_hh.float())
        dw_hh, db_hh = cuda_gru.w_hh_grads(h_seq32, h032, dph)
        return cuda_gru.round_bf16((dpx, dw_hh, db_hh, dh0))


def _stacked_bf16(pre, w_hh, b_hh, h0):
    """bf16 plain version of `stacked_gru`: h_seq (L, T, B, H) bf16."""
    if pre.shape[1] == 0:
        return h0.new_zeros((h0.shape[0], 0) + tuple(h0.shape[1:]))
    return _StackedBf16Plain.apply(pre, w_hh, b_hh, h0)


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
    cuda_gru.float_dtype(got, kernel=True)


def _launch_fwd(pre, w_hh, b_hh, h0, stash: bool):
    """fader_stacked_gru(_bf16): h_seq (L, T, B, H) and, when `stash`, the
    gate stash (L, T, B, 4H), in h0's dtype; T >= 1."""
    L, T, B, _ = pre.shape
    H = h0.shape[-1]
    dev = h0.device
    lib = _build.load_library()
    h_seq = torch.empty((L, T, B, H), dtype=h0.dtype, device=dev)
    st = (torch.empty((L, T, B, 4 * H), dtype=h0.dtype, device=dev)
          if stash else None)
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_gru_fwd_scratch_floats, (L, B, H), dev)
        err = cuda_gru.entry(lib, "fader_stacked_gru", h0.dtype)(
            L, T, B, H, pre.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), h_seq.data_ptr(),
            None if st is None else st.data_ptr(), scratch.data_ptr(),
            n_scratch, cuda_gru._stream(dev))
    _build.check(err, cuda_gru.key("fader_stacked_gru", h0.dtype))
    return h_seq, st


def _launch_bwd(g, stash, h_seq, h0, w_hh):
    """fader_stacked_gru_bwd(_bf16): (dpre (L,T,B,3H), dw_hh, db_hh, dh0),
    float32; g float32, the forward's tensors and w_hh in h0's dtype."""
    L, T, B, H = h_seq.shape
    G = 3 * H
    dev = h0.device
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    w_hhT = w_hh.transpose(1, 2).contiguous()
    dph = torch.empty((L, T, B, G), **f32)
    dpre = torch.empty((L, T, B, G), **f32)
    dw_hh = torch.empty((L, H, G), **f32)
    db_hh = torch.empty((L, G), **f32)
    dh0 = torch.empty((L, B, H), **f32)
    with torch.cuda.device(dev):
        scratch, n_scratch = _build.entry_scratch(
            lib.fader_gru_bwd_scratch_floats, (L, T, B, H), dev)
        err = cuda_gru.entry(lib, "fader_stacked_gru_bwd", h0.dtype)(
            L, T, B, H, *(t.data_ptr() for t in (
                g, stash, h_seq, h0, w_hhT, dph, dpre, dw_hh, db_hh, dh0,
                scratch)), n_scratch, cuda_gru._stream(dev))
    _build.check(err, cuda_gru.key("fader_stacked_gru_bwd", h0.dtype))
    return dpre, dw_hh, db_hh, dh0


class StackedGRU(torch.autograd.Function):
    """Kernels 1 (forward with the gate stash) and 2 (backward from the
    h_seq cotangent) as one differentiable op over (pre, w_hh, b_hh, h0);
    the backward returns (dpre, dw_hh, db_hh, dh0), as `_vjp_bwd`
    (pallas_gru.py:347-355) does."""

    @staticmethod
    def forward(ctx, pre, w_hh, b_hh, h0):
        h_seq, stash = _launch_fwd(pre, w_hh, b_hh, h0, True)
        LAUNCHES[cuda_gru.key("stacked_gru", h0.dtype)] += 1
        ctx.save_for_backward(w_hh, h0, h_seq, stash)
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        w_hh, h0, h_seq, stash = ctx.saved_tensors
        # the cotangent in the forward's dtype (pallas_gru.py:351), read in
        # float32
        g = g_seq.to(h0.dtype).float().contiguous()
        grads = _launch_bwd(g, stash, h_seq, h0, w_hh)
        LAUNCHES[cuda_gru.key("stacked_gru_bwd", h0.dtype)] += 1
        del h_seq, stash
        return cuda_gru._mask(ctx, cuda_gru._returned(grads, h0.dtype))


def stacked_gru(pre, w_hh, b_hh, h0):
    """h_seq (L, T, B, H) of L GRU directions over input projections pre
    (L, T, B, 3H). CPU tensors take the plain version; CUDA tensors launch
    the kernels, through `StackedGRU` when a gradient is wanted."""
    global LAST_TRAIN_PATH
    tensors = (pre, w_hh, b_hh, h0)
    if cuda_gru.kernel_device(tensors) is None:
        cuda_gru.float_dtype(dict(zip(("pre", "w_hh", "b_hh", "h0"),
                                      tensors)), kernel=False)
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
    LAUNCHES[cuda_gru.key("stacked_gru", h0.dtype)] += 1
    return h_seq
