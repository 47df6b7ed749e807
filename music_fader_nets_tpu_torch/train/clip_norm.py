"""The training step's global-norm clip (`ops/cuda_clip.py`) alone, on one
GPU.

    python -m music_fader_nets_tpu_torch.train.clip_norm [--reps 50]

For the trainable leaves of the GM-VAE and of the CVAE at the default
widths (`tree_shapes`: 43 and 21 leaves), normal gradients scaled to a
global norm of 0.1 (below max_norm = 1: left as they are) and of 50
(scaled), it holds the kernels to the plain versions (`compare`) and
prints one JSON line a tree: the norms (the kernels', the torch ops' and
a float64 one), each case's largest distance in ulps from the gradients
clipped with the float64 norm (`reference`) and from the torch ops',
whether the scaled gradients have the bits of g / norm * max_norm taken by
torch ops with the kernels' norm, whether the gradients below max_norm
are untouched and whether two calls give the same bits; then the device
ms of a call by CUDA events (`kernel_ms`, `plain_ms`, the gradients put
back between calls outside the timed span), the host ms of issuing one
(`kernel_host_ms`, `plain_host_ms`), and the bound ms (every float read
once, and read and written once more when scaled, at 3.35 TB/s). Runs on
CUDA only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import fast as fast_lib
from music_fader_nets_tpu_torch.ops import cuda_clip
from music_fader_nets_tpu_torch.train.profile import FAMILIES
from music_fader_nets_tpu_torch.train.trainer import trainable_leaves

PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 20_000_000   # ~10 ms of the SM clock
NORMS = {"below": 0.1, "above": 50.0}
MAX_NORM = 1.0
NORM_REL = 1e-6      # float32 order noise of the norm against float64
MAX_ULPS = 2         # the gradients against the float64 norm's rule


def tree_shapes(family: str, cfg: ModelConfig = None) -> list:
    """The shapes of `family`'s trainable leaves in the Trainer's order."""
    cfg = cfg or ModelConfig()
    params = FAMILIES[family][0](torch.Generator().manual_seed(0), cfg)
    fast, _ = fast_lib.split_fast(params)
    return [tuple(t.shape) for _, t in trainable_leaves(fast)]


def draw(shapes, norm: float, gen: torch.Generator, dev) -> list:
    """Normal gradients of `shapes` scaled to a global norm of `norm`."""
    gs = [torch.randn(s, generator=gen) for s in shapes]
    total = sum(float((g.double() ** 2).sum()) for g in gs) ** 0.5
    return [(g * (norm / total)).to(dev) for g in gs]


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 ulps between `a` and `b` (finite,
    float32): their bits as integers ordered like the values."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def reference(grads0, max_norm: float = MAX_NORM):
    """The float64 norm and the gradients clipped as the benchmark's
    reference clips them (h100bench/reference/common.py::clip_global_norm):
    the sum of squares in float64, its root rounded to float32, then g /
    norm * max_norm."""
    norm64 = torch.sqrt(sum((g.double() ** 2).sum() for g in grads0))
    norm = norm64.float()
    if norm < max_norm:
        return float(norm64), list(grads0)
    return float(norm64), [g / norm * max_norm for g in grads0]


def compare(grads0, max_norm: float = MAX_NORM) -> dict:
    """The kernels against the plain versions on copies of `grads0`
    (CUDA, float32): the norms (the kernels', the torch ops', the float64
    one), `max_ulps` from the gradients `reference` clips and
    `max_ulps_plain` from the torch ops' (whose float32 sums put their
    norm an ulp or two off), `exact` (the scaled gradients equal g / norm
    * max_norm by torch ops with the kernels' norm; below max_norm, the
    input's bits) and `repeat_bit_equal` (a second call's norm and
    gradients)."""
    got = [g.clone() for g in grads0]
    again = [g.clone() for g in grads0]
    plain = [g.clone() for g in grads0]
    norm = cuda_clip.clip_global_norm_(got, max_norm)
    norm2 = cuda_clip.clip_global_norm_(again, max_norm)
    norm_plain = cuda_clip.clip_by_global_norm_(plain, max_norm)
    norm64, ref = reference(grads0, max_norm)
    nk = float(norm)
    rule = (grads0 if nk < max_norm
            else [g / norm * max_norm for g in grads0])
    return {
        "norm": nk, "norm_plain": float(norm_plain), "norm_f64": norm64,
        "norm_rel_err": abs(nk - norm64) / max(norm64, 1e-30),
        "max_ulps": max((ulps(a, b) for a, b in zip(got, ref)), default=0),
        "max_ulps_plain": max((ulps(a, b) for a, b in zip(got, plain)),
                              default=0),
        "exact": all(torch.equal(a, b) for a, b in zip(got, rule)),
        "repeat_bit_equal": bool(torch.equal(norm, norm2)) and all(
            torch.equal(a, b) for a, b in zip(got, again)),
    }


def failures(r: dict) -> list:
    """What one `compare` result breaks of the rules above."""
    bad = []
    if r["norm_rel_err"] > NORM_REL:
        bad.append(f"norm off float64 by {r['norm_rel_err']}")
    if r["max_ulps"] > MAX_ULPS:
        bad.append(f"{r['max_ulps']} ulps from the float64 norm's rule")
    if not r["exact"]:
        bad.append("not the rule's bits given the norm")
    if not r["repeat_bit_equal"]:
        bad.append("two calls differ in a bit")
    return bad


def _events_ms(fn, restore, reps: int) -> float:
    """Median device ms of `fn` by CUDA events, `restore` run before each
    call outside the timed span. The stream first sleeps ~10 ms, so the
    host has issued the whole call before the first event is reached and
    the span holds the device's work alone."""
    ts = []
    for _ in range(reps + 2):
        restore()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts[2:])


def _host_ms(fn, restore, reps: int) -> float:
    """Median host ms of issuing `fn` (no wait for the device), the device
    idle at each call's start."""
    ts = []
    for _ in range(reps + 2):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(ts[2:])


def measure(family: str, reps: int, gen, dev) -> dict:
    """One tree's line (see the module's docstring)."""
    shapes = tree_shapes(family)
    floats = sum(torch.Size(s).numel() for s in shapes)
    line = {"tree": family, "leaves": len(shapes), "floats": floats,
            "odd_leaves": sum(torch.Size(s).numel() % 4 != 0
                              for s in shapes)}
    for case, norm in NORMS.items():
        line[case] = compare(draw(shapes, norm, gen, dev))
    grads0 = draw(shapes, NORMS["above"], gen, dev)
    work = [g.clone() for g in grads0]

    def restore():
        for w, g in zip(work, grads0):
            w.copy_(g)

    def kernel():
        cuda_clip.clip_global_norm_(work, MAX_NORM)

    def plain():
        cuda_clip.clip_by_global_norm_(work, MAX_NORM)

    line["kernel_ms"] = _events_ms(kernel, restore, reps)
    line["plain_ms"] = _events_ms(plain, restore, reps)
    line["kernel_host_ms"] = _host_ms(kernel, restore, reps)
    line["plain_host_ms"] = _host_ms(plain, restore, reps)
    below = [g * (NORMS["below"] / NORMS["above"]) for g in grads0]
    line["kernel_ms_below"] = _events_ms(
        lambda: cuda_clip.clip_global_norm_(below, MAX_NORM), lambda: None,
        reps)
    line["bound_ms"] = 12 * floats / PEAK_BYTES_PER_S * 1e3
    line["bound_ms_below"] = 4 * floats / PEAK_BYTES_PER_S * 1e3
    line["failed"] = [f"{case}: {m}" for case in NORMS
                      for m in failures(line[case])]
    line["ok"] = not line["failed"]
    return line


def report(reps: int = 50, seed: int = 0, dev=None) -> list:
    """The GM-VAE's and the CVAE's lines."""
    dev = resolve_device(dev)
    if dev.type != "cuda":
        raise RuntimeError("the clip's report needs a CUDA device")
    gen = torch.Generator().manual_seed(seed)
    return [measure(f, reps, gen, dev) for f in ("gmvae", "cvae")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    ok = True
    for line in report(args.reps, args.seed):
        line["device"] = torch.cuda.get_device_name(0)
        line["nvidia_smi"] = smi
        print(json.dumps(line), flush=True)
        ok &= line["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
