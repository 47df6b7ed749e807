"""The global-norm clip of the training step (`csrc/clip_norm.cu`) and its
plain PyTorch version.

optax.clip_by_global_norm: the gradients stay as they are when their
global norm is below `max_norm`, else every one becomes g / norm *
max_norm. (Not `torch.nn.utils.clip_grad_norm_`, which scales by max_norm
/ (norm + 1e-6) and so differs.) Both versions clip in place and return
the norm as a 0-d float32 tensor.

The wrapper runs the plain version for gradients on the CPU and the two
kernels for gradients on a GPU; there is no fallback between the two. On
a GPU every gradient must be a contiguous float32 tensor (the masters
stay float32 under mixed precision too): another dtype raises TypeError.
The kernels read a table of every leaf (`leaf_tables`) passed by value at
each launch, built anew each call from the tensors' addresses. The norm is
a sum of float32 block partials taken in double, so it may differ from the
plain version's float32 sums in its last bit; given the same norm the
scaled gradients have the plain version's bits.
"""
from __future__ import annotations

import numpy as np
import torch

from music_fader_nets_tpu_torch.ops import _build, cuda_gru

# wrapper calls that launched each kernel (a tree of more than
# TABLE_LEAVES leaves launches each once a table)
LAUNCHES = {"clip_sumsq": 0, "clip_scale": 0}
# which path served the last call: "kernel" or "plain-cpu"
LAST_CLIP_PATH = None

# csrc/clip_norm.cu: kClipLeaves, kClipThreads, the ClipTable's words
TABLE_LEAVES = 96
THREADS = 256
_HEAD = 4                                   # n, blocks, chunk, part_base
_OFFSET = _HEAD
_NUMEL = _OFFSET + TABLE_LEAVES + 1
_PTR = _NUMEL + TABLE_LEAVES
_VEC = _PTR + TABLE_LEAVES
TABLE_WORDS = _VEC + TABLE_LEAVES
BLOCKS_PER_SM = 8
MIN_GROUPS = 4          # groups of 4 floats a thread takes at least


def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """The plain version: optax's rule by torch ops, in place; returns the
    norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def _cdiv(a, b: int):
    """ceil(a / b) of an int or an integer array."""
    return -(-a // b)


def leaf_tables(leaves, sms: int):
    """The kernels' tables for `leaves` [(device address, element count)]
    on a card of `sms` SMs: a list of int64 arrays of TABLE_WORDS words
    (ClipTable's layout), TABLE_LEAVES leaves a table at most, and the
    partials they write in all. In a table the leaves' sizes are padded
    to 4 floats (`offset`, their prefix); a leaf whose base is 16-byte
    aligned is read by float4 (`vec`), its tail of numel % 4 floats and
    every unaligned leaf by scalar loads. Each block of a table takes
    `chunk` padded floats (a multiple of 4): at least MIN_GROUPS groups of
    4 a thread, at most BLOCKS_PER_SM blocks an SM. The tables' partials
    follow each other (`part_base`)."""
    tables, base = [], 0
    for s in range(0, len(leaves), TABLE_LEAVES):
        part = leaves[s: s + TABLE_LEAVES]
        k = len(part)
        ptr = np.array([p for p, _ in part], dtype=np.int64)
        numel = np.array([n for _, n in part], dtype=np.int64)
        offset = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(_cdiv(numel, 4) * 4, out=offset[1:])
        total = int(offset[-1])
        blocks = max(1, min(sms * BLOCKS_PER_SM,
                            _cdiv(total, THREADS * 4 * MIN_GROUPS)))
        chunk = max(4, _cdiv(_cdiv(total, blocks), 4) * 4)
        blocks = max(1, _cdiv(total, chunk))
        t = np.zeros(TABLE_WORDS, dtype=np.int64)
        t[:_HEAD] = (k, blocks, chunk, base)
        t[_OFFSET: _OFFSET + k + 1] = offset
        t[_NUMEL: _NUMEL + k] = numel
        t[_PTR: _PTR + k] = ptr
        t[_VEC: _VEC + k] = ptr % 16 == 0
        tables.append(t)
        base += blocks
    return tables, base


def _launch(grads, max_norm: float, dev) -> torch.Tensor:
    """fader_clip_global_norm over `grads` (contiguous float32 on `dev`):
    clips them in place, returns the norm (0-d, on `dev`)."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tables, n_partials = leaf_tables(
        [(g.data_ptr(), g.numel()) for g in grads], sms)
    words = np.concatenate(tables)
    with torch.cuda.device(dev):
        partials = torch.empty((n_partials,), dtype=torch.float32,
                               device=dev)
        norm = torch.empty((), dtype=torch.float32, device=dev)
        err = lib.fader_clip_global_norm(
            len(tables), words.ctypes.data, TABLE_WORDS, partials.data_ptr(),
            n_partials, max_norm, norm.data_ptr(), cuda_gru._stream(dev))
    _build.check(err, "fader_clip_global_norm")
    return norm


def clip_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """Clip `grads` in place by their global norm at `max_norm` (optax's
    rule); returns the norm. CPU gradients take the plain version, CUDA
    gradients the kernels; an empty list is a norm of 0. Raises TypeError
    for a CUDA gradient that is not float32, ValueError for one that is not
    contiguous or for gradients on several devices."""
    global LAST_CLIP_PATH
    grads = list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    dev = cuda_gru.kernel_device(grads)
    if dev is None:
        LAST_CLIP_PATH = "plain-cpu"
        return clip_by_global_norm_(grads, max_norm)
    for i, g in enumerate(grads):
        if g.dtype != torch.float32:
            raise TypeError(f"gradient {i} is {g.dtype}: the clip kernels "
                            f"take float32 gradients")
        if not g.is_contiguous():
            raise ValueError(f"gradient {i} is not contiguous")
    norm = _launch(grads, float(max_norm), dev)
    LAUNCHES["clip_sumsq"] += 1
    LAUNCHES["clip_scale"] += 1
    LAST_CLIP_PATH = "kernel"
    return norm
