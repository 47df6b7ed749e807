"""What a cooperative launch costs the host, against an ordinary launch, on
one GPU.

    python -m music_fader_nets_tpu_torch.serve.launch_cost [--n 2000]

The persistent kernels (the forward and backward chains, the decode) are
cooperative launches behind an occupancy query (`csrc/gru_tile.cuh::
try_cooperative`). This enqueues `--n` launches of an empty 128-block
kernel through that path and as ordinary launches (`fader_launch_probe`),
in turns (ordinary, cooperative, cooperative, ordinary), and prints one
JSON line each: the host's µs to enqueue one launch (host clock around the
enqueue, no synchronise) and the device's µs a launch (CUDA events over the
run); then the host's µs to enqueue one greedy decode call through its
wrapper (`cuda_decode._launch`: allocations, the memset and the
cooperative launch, B=64, 300 steps, H=512) beside the call's device ms,
and the card's name and power limit. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.models.modules import global_decoder_init
from music_fader_nets_tpu_torch.ops import _build, cuda_decode, cuda_gru
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to


def probe(lib, cooperative: bool, n: int, dev) -> dict:
    """Host µs to enqueue one launch and device µs a launch over n."""
    stream = cuda_gru._stream(dev)
    _build.check(lib.fader_launch_probe(int(cooperative), 10, stream),
                 "fader_launch_probe")
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    t0 = time.perf_counter()
    err = lib.fader_launch_probe(int(cooperative), n, stream)
    host = time.perf_counter() - t0
    e.record()
    e.synchronize()
    _build.check(err, "fader_launch_probe")
    return {"launch": "cooperative" if cooperative else "ordinary",
            "n": n, "host_us_per_launch": host * 1e6 / n,
            "device_us_per_launch": s.elapsed_time(e) * 1e3 / n}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = load_config(args.config)
    lib = _build.load_library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    tag = {"device": torch.cuda.get_device_name(), "nvidia_smi": smi}
    with torch.cuda.device(dev):
        for coop in (False, True, True, False):
            print(json.dumps({**probe(lib, coop, args.n, dev), **tag}),
                  flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    H, V, steps = cfg.hidden_dims, cfg.roll_dims, cfg.transfer_decode_steps
    Zt = 2 * cfg.z_dims + cfg.chroma_dims
    gview = tree_to(global_decoder_init(gen, Zt, V, H), dev)
    z = torch.randn((64, Zt), generator=gen).to(dev)
    dargs, V, Vp = cuda_decode._prep_decode_args(gview, z)
    host, device = [], []
    for _ in range(12):
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        t0 = time.perf_counter()
        cuda_decode._launch(dargs, V, Vp, steps)
        host.append((time.perf_counter() - t0) * 1e6)
        e.record()
        e.synchronize()
        device.append(s.elapsed_time(e))
    print(json.dumps({"call": "greedy_decode", "B": 64, "steps": steps,
                      "host_us_per_call": sorted(host[2:])[len(host[2:]) // 2],
                      "device_ms_per_call":
                          sorted(device[2:])[len(device[2:]) // 2], **tag}),
          flush=True)


if __name__ == "__main__":
    main()
