"""The float32 dW GEMM (`csrc/grad_reduce.cu::gemm_tn<float>`) alone, on
one GPU.

    python -m music_fader_nets_tpu_torch.train.dw_gemm [--reps 20]

At every (L, M, N, K) that the training cells' backward entries pass to it
(`shapes`: the encoders' and the stacked GRU's recurrent dW, the
sub-decoders', the decoder's three and its logits' dW), with A made of two
row blocks as the entries pass h_prev (h0's B rows, then h_seq's), it
times the CUDA-core kernel (`fma`) and the tensor-core kernel (`wg`) in
turns (the order, then the reverse) by CUDA events, with what the entries
run (`rule`) and PyTorch's float32 `torch.bmm` with TF32 off (the library
yardstick, which the port never calls), and prints one JSON line a shape:
ms and TFLOP/s of each, and each one's worst error against a float64
product, elementwise over |A|^T |B| (`err_*`; `err_tf32`: the same
`torch.bmm` with TF32 on). `ok` holds when the tensor-core kernel's error
is within 2x the CUDA-core kernel's, plain TF32's is not, two calls of
each kernel give the same bits, the rule runs the tensor-core kernel
wherever it takes the call, and that is no slower than the CUDA-core
kernel (within `SLOWER`). Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.ops import _build
from music_fader_nets_tpu_torch.ops.gru import vocab_pad

# `fader_gemm_tn`'s routes: what the backward entries run, the CUDA-core
# kernel, the tensor-core kernel
ROUTES = {"rule": 0, "fma": 1, "wg": 2}
ERR_RATIO = 2.0      # the tensor cores' error against the CUDA cores' at most
SLOWER = 1.03        # timing noise allowed when holding `rule` to `fma`


def shapes(cfg) -> dict:
    """{name: (L, M, N, K, n0)} of every float32 gemm_tn call of the
    training cells' backward (GM-VAE and CVAE) at the config's widths; n0
    rows of A come from h0 (the batch), none where A is a layer's own
    outputs (the decoder's layer-2 input and logits' dW)."""
    H, G, B = cfg.hidden_dims, 3 * cfg.hidden_dims, cfg.batch_size
    R = cfg.seq_len * B
    return {
        "encoder_dw_hh": (4, H, G, R, B),
        "stacked_dw_hh": (2, H, G, R, B),
        "decoder_dw_hh": (1, H, G, R, B),
        "decoder_dw_ih2": (1, H, G, R, 0),
        "decoder_dw_out": (1, H, vocab_pad(cfg.roll_dims), R, 0),
        "subdecoder_dw_hh": (2, H, G, cfg.attr_len * B, B),
    }


def tensor_cores_take(M, N, K, n0) -> bool:
    """Whether `gemm_tn<float>` runs its call on the tensor cores
    (`grad_reduce.cu::launch_wg`) for contiguous operands as the backward
    entries pass them (A rows of M floats, h0's n0 rows then h_seq's, B
    rows of N floats; 16-byte aligned tensors): rows of 16-byte multiples
    and the seam on a 16-row slab or absent."""
    return M % 4 == 0 and N % 4 == 0 and (n0 % 16 == 0 or n0 >= K)


def operands(L, M, N, K, n0, gen, dev):
    """A as two row blocks (a0 (L, n0, M), a1 (L, K - n0, M); GRU states
    in (-1, 1)) and B (L, K, N) (gate cotangents, normal, scaled by 1e-3)."""
    a0 = torch.rand((L, n0, M), generator=gen) * 2 - 1
    a1 = torch.rand((L, K - n0, M), generator=gen) * 2 - 1
    b = torch.randn((L, K, N), generator=gen) * 1e-3
    return a0.to(dev), a1.to(dev), b.to(dev)


def gemm_tn(route, a0, a1, b):
    """C (L, M, N) = A[l]^T B[l] through `fader_gemm_tn`'s route."""
    lib = _build.load_library()
    L, K, N = b.shape
    M, n0 = a0.shape[2], a0.shape[1]
    c = torch.empty((L, M, N), dtype=torch.float32, device=b.device)
    scratch, n = _build.entry_scratch(lib.fader_reduce_scratch_floats,
                                      (L, M, N, K), b.device)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib.fader_gemm_tn(
        route, L, M, N, K, a0.data_ptr(), n0 * M, n0, a1.data_ptr(),
        (K - n0) * M, M, b.data_ptr(), K * N, c.data_ptr(), M * N,
        scratch.data_ptr(), n, stream), "fader_gemm_tn")
    return c


def library(a0, a1, b):
    """The same product by torch.bmm in float32."""
    return torch.bmm(torch.cat([a0, a1], 1).transpose(1, 2), b)


def scaled_error(c, a0, a1, b) -> float:
    """max over elements of |c - A^T B| / (|A|^T |B|), in float64."""
    a = torch.cat([a0, a1], 1).double()
    bd = b.double()
    exact = torch.bmm(a.transpose(1, 2), bd)
    scale = torch.bmm(a.abs().transpose(1, 2), bd.abs())
    return float(((c.double() - exact).abs() / scale).max())


def turns_ms(fns: dict, reps: int) -> dict:
    """Median ms of each callable, timed in turns (the order, then the
    reverse) by CUDA events after two warm-up calls each."""
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    ts = {k: [] for k in fns}
    order = list(fns)
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fns[k]()
            e.record()
            e.synchronize()
            ts[k].append(s.elapsed_time(e))
    return {k: statistics.median(v) for k, v in ts.items()}


def measure(name, L, M, N, K, n0, reps, gen, dev) -> dict:
    """One shape's line (see the module's docstring). Where the tensor
    cores cannot take the call (`wg_takes` false: rows not 16-byte
    multiples, a seam off a 16-row slab), the rule must run the CUDA-core
    kernel."""
    a0, a1, b = operands(L, M, N, K, n0, gen, dev)
    routes = dict(ROUTES)
    try:
        gemm_tn(ROUTES["wg"], a0, a1, b)
    except RuntimeError as e:
        if "CUDA error 801" not in str(e):       # cudaErrorNotSupported
            raise
        del routes["wg"]
    out = {k: gemm_tn(r, a0, a1, b) for k, r in routes.items()}
    again = {k: gemm_tn(r, a0, a1, b) for k, r in routes.items()}
    bit_equal = all(torch.equal(out[k], again[k]) for k in routes)
    rule = next((k for k in ("wg", "fma")
                 if k in out and torch.equal(out["rule"], out[k])), None)
    err = {k: scaled_error(out[k], a0, a1, b) for k in ("fma", "wg")
           if k in out}
    err["library"] = scaled_error(library(a0, a1, b), a0, a1, b)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        err["tf32"] = scaled_error(library(a0, a1, b), a0, a1, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    fns = {k: (lambda r=r: gemm_tn(r, a0, a1, b)) for k, r in routes.items()}
    fns["library"] = lambda: library(a0, a1, b)
    ms = turns_ms(fns, reps) if reps else {}
    flop = 2.0 * L * M * N * K
    line = {"shape": name, "L": L, "M": M, "N": N, "K": K, "n0": n0,
            "wg_takes": "wg" in routes, "rule_runs": rule,
            "bit_equal": bit_equal,
            **{f"err_{k}": v for k, v in err.items()},
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_tflops": flop / v / 1e9 for k, v in ms.items()}}
    checks = {
        "tf32_fails": err["tf32"] > ERR_RATIO * err["fma"],
        "bit_equal": bit_equal,
        "rule_is_its_kernel": rule == ("wg" if "wg" in routes else "fma"),
        "takes_as_stated": ("wg" in routes) == tensor_cores_take(M, N, K, n0),
    }
    if "wg" in routes:
        checks["wg_within_2x_fma"] = err["wg"] <= ERR_RATIO * err["fma"]
    if ms:
        checks["rule_no_slower"] = ms["rule"] <= SLOWER * ms["fma"]
    line["failed"] = [k for k, ok in checks.items() if not ok]
    line["ok"] = not line["failed"]
    return line


def report(cfg, reps: int, seed: int = 0, dev=None) -> list:
    """The lines of every main-path shape, then of two ragged ones (not
    timed): M, N and K past the tiles with the seam on a slab (the tensor
    cores), and an M of 130 floats with a seam at row 5 (the CUDA-core
    kernel)."""
    dev = dev or resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    lines = [measure(name, *shape, reps, gen, dev)
             for name, shape in shapes(cfg).items()]
    for name, shape, n0 in (("ragged", (2, 136, 408, 777), 48),
                            ("ragged_fallback", (1, 130, 344, 1234), 5)):
        lines.append(measure(name, *shape, n0, 0, gen, dev))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for line in report(load_config(args.config), args.reps, args.seed):
        print(json.dumps({**line, "device": torch.cuda.get_device_name(),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
