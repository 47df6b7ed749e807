"""Where the device time of the two GRU backward kernels goes, on one GPU.

    python -m music_fader_nets_tpu_torch.train.bwd_split [--reps 5]

Runs the backward of the encoder (`stacked_gru_embed_finals`, L=4) and of
the generic stacked GRU (`stacked_gru`, L=2) at the config's full width
(T=seq_len, B=batch_size, H=hidden_dims; random weights and inputs from a
seed) under `torch.profiler` and prints, for each, one JSON line: the
device ms of one backward call split by what its kernels do (`chain`: the
dh recurrence; `dw_gemm`: dW_hh = h_prev^T dpre_h with its split-K sum;
`scatter`: the token scatter of dW_in; `sums`: the bias and per-sequence
sums; `other`: memsets, the weight transpose, autograd's own copies), and
the call's time by CUDA events. Runs on CUDA only; device times from CUPTI.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.ops import cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.ops.gru import vocab_pad

# part of a backward call -> substrings of its kernels' names
PARTS = {
    "chain": ("gru_bwd_chain", "gru_bwd_step", "rows_gemm_add"),
    "dw_gemm": ("gemm_tn_kernel", "gemm_kernel", "splitk_sum"),
    "scatter": ("segment_rows",),
    "sums": ("colsum", "sum_over_t"),
}


def kernel_split(fn, reps: int = 3):
    """Device ms of one call of `fn` by part (`PARTS`, and `other`), the
    mean over `reps` profiled calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {part: 0.0 for part in (*PARTS, "other")}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((p for p, keys in PARTS.items()
                     if any(k in e.name for k in keys)), "other")
        split[part] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return split


def event_ms(fn, reps: int) -> float:
    """Median ms of `fn` by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def backward_of(fn, floats, cot):
    """A callable that runs only the backward of `fn(*floats)` under the
    cotangent `cot`, over a retained graph."""
    ts = [t.detach().clone().requires_grad_(True) for t in floats]
    out = fn(*ts)
    return lambda: torch.autograd.grad(out, ts, cot, retain_graph=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = load_config(args.config)
    T, B, H, V = cfg.seq_len, cfg.batch_size, cfg.hidden_dims, cfg.roll_dims
    G, Vp = 3 * H, vocab_pad(V)
    gen = torch.Generator().manual_seed(args.seed)

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    rows = {}
    L = 4
    tok = torch.randint(0, V, (L, T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    rows["embed_gru_bwd"] = (
        {"L": L, "T": T, "B": B, "H": H, "Vp": Vp},
        backward_of(lambda *fl: cuda_gru.stacked_gru_embed_finals(tok, *fl),
                    [rand((L, Vp, G), 0.05), rand((L, G), 0.05),
                     rand((L, H, G), 0.04), rand((L, G), 0.05),
                     rand((L, B, H), 0.1)], rand((L, B, H), 1.0)))
    L = 2
    rows["stacked_gru_bwd"] = (
        {"L": L, "T": T, "B": B, "H": H},
        backward_of(cuda_stacked.stacked_gru,
                    [rand((L, T, B, G), 0.5), rand((L, H, G), 0.04),
                     rand((L, G), 0.05), rand((L, B, H), 0.1)],
                    rand((L, T, B, H), 1.0)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for name, (shape, bwd) in rows.items():
        print(json.dumps({"kernel": name, "shape": shape,
                          "bwd_ms": event_ms(bwd, args.reps),
                          "split_ms": kernel_split(bwd, args.reps),
                          "device": torch.cuda.get_device_name(),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
