"""Where the serving path's device time goes, on one GPU.

    python -m music_fader_nets_tpu_torch.serve.profile [--requests 128]

Builds a TransferServer at the config's full width with random weights
(seeded), warms it, then serves `--requests` greedy 300-step transfers in
full batches under `torch.profiler`, and prints JSON lines: device time
per kernel name (sum, count, mean), the device's busy and idle share of
the profiled window, and the card's name and power limit. Runs on CUDA
only; the numbers are device times from CUPTI.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.serve.server import TransferServer


def _busy_us(events) -> float:
    """Union length of the device kernels' intervals (overlaps counted
    once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = load_config(args.config)
    params = init_reg_gmvae(torch.Generator().manual_seed(args.seed), cfg)
    rng = np.random.default_rng(args.seed)
    reqs = [{"id": i, "direction": "low_to_high",
             "tokens": rng.integers(2, cfg.roll_dims,
                                    size=cfg.seq_len).tolist(),
             **({"temperature": args.temperature, "seed": i}
                if args.temperature > 0 else {})}
            for i in range(args.requests)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with TransferServer(params, cfg, max_batch=64, device=dev) as srv:
        srv.request(reqs[0])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            resps = [f.result() for f in [srv.submit(r) for r in reqs]]
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        stats = srv.stats()
    if any("error" in r for r in resps):
        raise RuntimeError("a profiled request failed")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    total = sum(d[1] for d in by_name.values())
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(json.dumps({"kernel": name[:120], "count": n,
                          "device_ms": us / 1e3, "mean_us": us / n,
                          "share": us / total if total else None}))
    busy = _busy_us(kernels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "requests": len(reqs), "batches": stats["batches"],
        "temperature": args.temperature, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
        "kernel_events": len(kernels), "device": torch.cuda.get_device_name(),
        "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
