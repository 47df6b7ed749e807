"""Where a GM-VAE training step's device time goes, on one GPU.

    python -m music_fader_nets_tpu_torch.train.profile [--steps 5]

Builds the `Trainer` at the config's full width with random weights
(seeded) on random in-schema batches (`random_corpus`), takes two warm-up
steps, then profiles `--steps` unsupervised steps at `--batch` rows under
`torch.profiler`, and prints JSON lines: device time per kernel name (sum,
count, mean), the device's busy and idle share of the profiled window, the
host's ms per step, and the card's name and power limit. Runs on CUDA
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
from music_fader_nets_tpu_torch.config import ModelConfig, load_config
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.serve.profile import _busy_us
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.train.trainer import Trainer


def random_corpus(cfg: ModelConfig, n: int, seed: int,
                  supervised: bool = False):
    """In-schema corpus arrays from numpy, in the loaders' argument order
    (data, rhythm, note, chroma[, arousal, valence]): tokens in
    [0, roll_dims), rhythm ids in [0, rhythm_dims), note ids in
    [0, note_dims), chroma in [0, 1), arousal and valence in [-1, 1)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, cfg.roll_dims, (n, cfg.seq_len)),
           rng.integers(0, cfg.rhythm_dims, (n, cfg.attr_len)),
           rng.integers(0, cfg.note_dims, (n, cfg.attr_len)),
           rng.random((n, cfg.chroma_dims))]
    if supervised:
        out += [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)]
    return out


def main(argv=None) -> None:
    from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = load_config(args.config)
    tr = Trainer(cfg, init_reg_gmvae, {"default": gmm_loss}, seed=args.seed,
                 device=dev)
    # the train split keeps 80% of the corpus
    n = (args.steps + 2) * args.batch * 5 // 4 + 5
    arrays = YamahaDataset(*random_corpus(cfg, n, args.seed),
                           mode="train").arrays()
    warm = {k: v[:2 * args.batch] for k, v in arrays.items()}
    timed = {k: v[2 * args.batch:(args.steps + 2) * args.batch]
             for k, v in arrays.items()}
    tr.run_epoch(warm, batch_size=args.batch, seed=0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        metrics = tr.run_epoch(timed, batch_size=args.batch, seed=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = len(timed["x"]) // args.batch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    total = sum(d[1] for d in by_name.values())
    for name, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(json.dumps({"kernel": name[:120], "count": cnt,
                          "device_ms_per_step": us / 1e3 / steps,
                          "mean_us": us / cnt,
                          "share": us / total if total else None}))
    busy = _busy_us(kernels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "steps": steps, "batch": args.batch, "train_path": tr.train_path,
        "loss": metrics.get("loss"), "wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
        "kernel_events": len(kernels), "device": torch.cuda.get_device_name(),
        "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
