"""Build and load the port's CUDA kernels.

`csrc/*.cu` compile with `nvcc` for sm_90a into one shared library with a
plain C interface, `build/torch_kernels/<hash>/libfader_kernels.so` at the
repository root, loaded with ctypes. The build runs at first use, from the
checkout's sources only, one `nvcc -c` per source started together, and
is cached on a hash of the sources and flags. Nothing here runs at import:
the CPU tests import every module on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libfader_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None       # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _digest() -> str:
    h = hashlib.sha256()
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, link, and move the library into
    place atomically. Raises RuntimeError with the compiler's output on
    failure."""
    global BUILD_SECONDS
    nvcc = _nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *CFLAGS, "-Xptxas", "-v", "-c",
                 str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o",
                               str(lib_tmp)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(lib_tmp, out_dir / LIB_NAME)
    BUILD_SECONDS = time.monotonic() - t0
    return out_dir / LIB_NAME


def _declare(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # an entry with scratch ends in (scratch, its size in floats, stream)
    tail = [P, LL, P]
    lib.fader_embed_gru_finals.argtypes = [I] * 5 + [P] * 7 + tail
    lib.fader_embed_gru_finals.restype = I
    lib.fader_greedy_decode.argtypes = [I] * 5 + [P] * 12 + tail
    lib.fader_greedy_decode.restype = I
    lib.fader_sample_decode.argtypes = [I] * 5 + [P] * 14 + tail
    lib.fader_sample_decode.restype = I
    lib.fader_embed_gru_train.argtypes = [I] * 6 + [P] * 8 + tail
    lib.fader_embed_gru_train.restype = I
    lib.fader_embed_gru_bwd.argtypes = [I] * 6 + [P] * 14 + tail
    lib.fader_embed_gru_bwd.restype = I
    lib.fader_embed_seq_bwd.argtypes = [I] * 5 + [P] * 11 + tail
    lib.fader_embed_seq_bwd.restype = I
    lib.fader_decoder_ce.argtypes = [I] * 4 + [P] * 18 + tail
    lib.fader_decoder_ce.restype = I
    lib.fader_decoder_ce_bwd.argtypes = [I] * 4 + [P] * 31 + tail
    lib.fader_decoder_ce_bwd.restype = I
    lib.fader_decoder_masses.argtypes = [I] * 5 + [P] * 18 + tail
    lib.fader_decoder_masses.restype = I
    lib.fader_decoder_masses_bwd.argtypes = [I] * 6 + [P] * 32 + tail
    lib.fader_decoder_masses_bwd.restype = I
    lib.fader_decoder_teacher.argtypes = [I] * 4 + [P] * 14 + tail
    lib.fader_decoder_teacher.restype = I
    lib.fader_decoder_teacher_bwd.argtypes = [I] * 4 + [P] * 23 + tail
    lib.fader_decoder_teacher_bwd.restype = I
    lib.fader_stacked_gru.argtypes = [I] * 4 + [P] * 6 + tail
    lib.fader_stacked_gru.restype = I
    lib.fader_stacked_gru_bwd.argtypes = [I] * 4 + [P] * 10 + tail
    lib.fader_stacked_gru_bwd.restype = I
    # the bf16 entries of the training kernels take the arguments of their
    # float32 entries (the decoder's forward two more: its float32 states)
    for name in ("fader_embed_gru_finals", "fader_embed_gru_train",
                 "fader_embed_gru_bwd", "fader_embed_seq_bwd",
                 "fader_decoder_ce_bwd", "fader_stacked_gru"):
        fn = getattr(lib, name + "_bf16")
        fn.argtypes = getattr(lib, name).argtypes
        fn.restype = I
    # kernel 2 in bf16 takes pre, w_hh, b_hh and a pre_h scratch in place
    # of the stash
    lib.fader_stacked_gru_bwd_bf16.argtypes = [I] * 4 + [P] * 13 + tail
    lib.fader_stacked_gru_bwd_bf16.restype = I
    lib.fader_decoder_ce_bf16.argtypes = [I] * 4 + [P] * 20 + tail
    lib.fader_decoder_ce_bf16.restype = I
    lib.fader_gemm_tn.argtypes = ([I] * 5 + [P, LL, I, P, LL, I, P, LL, P,
                                               LL] + tail)
    lib.fader_gemm_tn.restype = I
    lib.fader_reduce_scratch_floats.argtypes = [I] * 4
    lib.fader_reduce_scratch_floats.restype = LL
    lib.fader_launch_probe.argtypes = [I, I, P]
    lib.fader_launch_probe.restype = I
    lib.fader_decode_scratch_floats.argtypes = [I] * 2
    lib.fader_decode_scratch_floats.restype = LL
    for fn in (lib.fader_gru_bwd_scratch_floats,
               lib.fader_embed_seq_bwd_scratch_floats,
               lib.fader_decoder_bwd_scratch_floats):
        fn.argtypes = [I] * 4
        fn.restype = LL
    for fn in (lib.fader_gru_fwd_scratch_floats,
               lib.fader_decoder_fwd_scratch_floats):
        fn.argtypes = [I] * 3
        fn.restype = LL
    lib.fader_error_string.argtypes = [I]
    lib.fader_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if this checkout's
    sources have not been built yet."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            path = out_dir / LIB_NAME
            if not path.exists():
                path = _build(out_dir)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


def entry_scratch(size_fn, dims, dev):
    """The scratch of an entry: (tensor, its floats), sized by the
    library's own `size_fn(*dims)` for the current device (the barrier
    counters and k-major rows of the persistent chains and of the decode,
    the decode's argmax keys, the decoder's layer-2 input projection and
    cross-layer cotangent, the split-K partial tiles of the weight-gradient
    GEMM, the column sums' partials). Call it with `dev` current."""
    n = int(size_fn(*dims))
    return torch.empty((max(n, 1),), dtype=torch.float32, device=dev), n


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = load_library().fader_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
