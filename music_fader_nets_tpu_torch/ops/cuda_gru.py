"""The embedded-token encoder kernel (`csrc/embed_gru.cu`) and its plain
PyTorch version.

Counterpart of `music_fader_nets_tpu/ops/pallas_gru.py::
stacked_gru_embed_finals` (forward only): L stacked GRU directions over
int32 tokens whose input projection is the row `w_ih[l, tok]`, returning
only the final states. The wrapper runs the plain version for tensors on
the CPU and the CUDA kernel for tensors on a GPU; there is no fallback
between the two.
"""
from __future__ import annotations

import torch

from music_fader_nets_tpu_torch.ops import _build
from music_fader_nets_tpu_torch.ops.gru import _gates

# wrapper calls that launched the kernel (one call = T device launches)
LAUNCHES = {"embed_gru": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_ENCODE_PATH = None


def stacked_gru_embed_finals_plain(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """Plain PyTorch version: a Python loop over steps of torch ops.
    tok_lt (L, T, B) int; w_ih (L, Vp, 3H); b_ih/b_hh (L, 3H);
    w_hh (L, H, 3H); h0 (L, B, H). Returns finals (L, B, H)."""
    L, T, _ = tok_lt.shape
    Vp = w_ih.shape[1]
    tok = tok_lt.long()
    valid = ((tok >= 0) & (tok < Vp)).unsqueeze(-1)            # (L, T, B, 1)
    lidx = torch.arange(L, device=tok.device)[:, None]
    h = h0
    for t in range(T):
        rows = w_ih[lidx, tok[:, t].clamp(0, Vp - 1)]           # (L, B, 3H)
        pre_x = torch.where(valid[:, t], rows, 0.0) + b_ih[:, None, :]
        pre_h = torch.bmm(h, w_hh) + b_hh[:, None, :]
        h = _gates(pre_x, pre_h, h)
    return h


def _check_shapes(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    L, T, B = tok_lt.shape
    H = h0.shape[-1]
    G = 3 * H
    want = {"w_ih": (L, w_ih.shape[1], G), "b_ih": (L, G),
            "w_hh": (L, H, G), "b_hh": (L, G), "h0": (L, B, H)}
    got = {"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
        if got[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{got[name].dtype}")
    if tok_lt.dtype != torch.int32:
        raise ValueError(f"tok_lt must be int32, got {tok_lt.dtype}")


def stacked_gru_embed_finals(tok_lt, w_ih, b_ih, w_hh, b_hh, h0):
    """Final states (L, B, H) of L GRU directions over tokens tok_lt
    (L, T, B) int32, already time-flipped for reversed directions.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAST_ENCODE_PATH
    tensors = (tok_lt, w_ih, b_ih, w_hh, b_hh, h0)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        LAST_ENCODE_PATH = "plain-cpu"
        return stacked_gru_embed_finals_plain(*tensors)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_shapes(*tensors)
    tok_lt, w_ih, b_ih, w_hh, b_hh, h0 = (t.contiguous() for t in tensors)
    L, T, B = tok_lt.shape
    H = h0.shape[-1]
    Vp = w_ih.shape[1]
    if L * B * H == 0:
        return h0.clone()
    lib = _build.load_library()
    finals = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    h_buf = torch.empty((2, L, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fader_embed_gru_finals(
            L, T, B, H, Vp, tok_lt.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h0.data_ptr(), h_buf.data_ptr(), finals.data_ptr(), stream)
    _build.check(err, "fader_embed_gru_finals")
    LAUNCHES["embed_gru"] += 1
    LAST_ENCODE_PATH = "kernel"
    return finals
