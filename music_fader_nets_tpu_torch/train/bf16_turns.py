"""The bf16 training kernels against their float32 rows, and against another
checkout's, in turns on one GPU.

    python -m music_fader_nets_tpu_torch.train.bf16_turns [--reps 10]
        [--against DIR]

At the config's full width (T=seq_len, B=batch_size, H=hidden_dims; random
weights and inputs from a seed) it times, for each bf16 training row, the
forward and the backward of its wrapper by CUDA events (medians), and the
forward without a gradient (the encoder's: row 3, finals only), the bf16
call and the float32 call of the same inputs in turns (bf16, float32,
float32, bf16): the generic stacked GRU (rows 1/2, L=2), the encoder (3t/4,
L=4), the sub-decoders (5/6, L=2, T=attr_len) and the teacher decoder with
the CE head (9/10). Each bf16 backward is also split by part (CUPTI:
`bwd_split.kernel_split`), with the dW GEMM's and the NN GEMM's rate in
TFLOP/s of useful work (2 M N K over their device ms) and the chain's
device us a step, and a SHA-1 of the float32 backward's gradients (its
bits: equal across two checkouts whose float32 kernels compute the same).
First it prints a SHA-1 of each float32 forward entry's outputs on fixed
inputs (`f32_forward_sha1`: equal across two checkouts whose float32
forward chains compute the same; `chip_smoke.py` holds them to the
values of the build before the bf16 forward chain's redesign).
Then the GM-VAE `Trainer` (B=batch_size, unsupervised)
in float32 and in bf16, in turns, 2 warm-up and 3 timed steps each: ms a
step (host clock, synchronised). One JSON line a row, then one for the
steps, each with the card's name and power limit.

With --against DIR (the root of another checkout, its package under
DIR/music_fader_nets_tpu_torch) the same measurement runs in four
processes in turns, DIR's package, this one's, this one's, DIR's, each
printing its lines tagged with its tree; DIR's kernels build into DIR's
own build directory. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def f32_forward_sha1(dev) -> dict:
    """{row: SHA-1 of what its float32 forward entry writes} on fixed
    inputs made on the CPU from a seed: rows 1 (the stacked GRU's h_seq),
    3 (the encoder's finals), 3t (its h_seq and gate stash), 5 (the
    sub-decoders' h_seq and stash), 7, 9 and 9-masses (the three decoder
    entries' outputs) at T=9, B=37 (a partial row tile) and H=512. Equal
    across two builds whose float32 forward chains compute the same
    bits."""
    import torch

    from music_fader_nets_tpu_torch.ops import cuda_gru, cuda_stacked
    from music_fader_nets_tpu_torch.ops.gru import vocab_pad
    from music_fader_nets_tpu_torch.train.bwd_split import decoder_cases

    T, B, H, V = 9, 37, 512, 342
    G, Vp = 3 * H, vocab_pad(V)
    gen = torch.Generator().manual_seed(17)

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def ids(L, n):
        return torch.randint(0, n, (L, T, B), generator=gen,
                             dtype=torch.int32).to(dev)

    def sha(out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return hashlib.sha1(b"".join(o.detach().cpu().numpy().tobytes()
                                     for o in outs)).hexdigest()

    enc = [rand((4, Vp, G), 0.05), rand((4, G), 0.05),
           rand((4, H, G), 0.04), rand((4, G), 0.05), rand((4, B, H), 0.1)]
    tok = ids(4, V)
    seq = [rand((2, 16, G), 0.2), rand((2, B, G), 0.2),
           rand((2, H, G), 0.04), rand((2, G), 0.05), rand((2, B, H), 0.5)]
    cls = ids(2, 16)
    stacked = [rand((2, T, B, G), 0.5), rand((2, H, G), 0.04),
               rand((2, G), 0.05), rand((2, B, H), 0.1)]
    with torch.no_grad():
        out = {"3": sha(cuda_gru.stacked_gru_embed_finals(tok, *enc)),
               "3t": sha(cuda_gru._launch_train_fwd(tok, *enc, True)),
               "5": sha(cuda_gru._launch_train_fwd(cls, *seq, True)),
               "1": sha(cuda_stacked.stacked_gru(*stacked))}
        for name, (_, fn, floats, _) in decoder_cases(T, B, H, V, rand,
                                                      dev).items():
            out[name] = sha(fn(*floats))
    return out


def measure(reps: int, seed: int, tree: str) -> None:
    """This process's measurement, over the package it imports."""
    import numpy as np
    import torch

    from music_fader_nets_tpu_torch import resolve_device
    from music_fader_nets_tpu_torch.config import ModelConfig, load_config
    from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.ops import cuda_gru, cuda_stacked
    from music_fader_nets_tpu_torch.ops.gru import vocab_pad
    from music_fader_nets_tpu_torch.train import objectives
    from music_fader_nets_tpu_torch.train.bwd_split import (
        decoder_cases, embed_seq_case, event_ms, kernel_split)
    from music_fader_nets_tpu_torch.train.profile import random_corpus
    from music_fader_nets_tpu_torch.train.trainer import Trainer

    dev = resolve_device("cuda")
    cfg = load_config(None)
    T, B, H, V = cfg.seq_len, cfg.batch_size, cfg.hidden_dims, cfg.roll_dims
    G, Vp, A = 3 * H, vocab_pad(V), cfg.attr_len
    gen = torch.Generator().manual_seed(seed)
    smi = _smi()
    print(json.dumps({"tree": tree, "f32_fwd_sha1": f32_forward_sha1(dev),
                      "nvidia_smi": smi}), flush=True)

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    tok = torch.randint(0, V, (4, T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    _, dec_fn, dec_fl, dec_cot = decoder_cases(T, B, H, V, rand,
                                               dev)["decoder_ce"]
    _, seq_fn, seq_fl, seq_cot = embed_seq_case(cfg, A, rand, gen, dev)
    # row: (fn, float inputs, cotangent, {part: 2 M N K of its GEMMs},
    # chain steps a backward)
    rows = {
        "stacked_gru": (
            cuda_stacked.stacked_gru,
            [rand((2, T, B, G), 0.5), rand((2, H, G), 0.04),
             rand((2, G), 0.05), rand((2, B, H), 0.1)],
            rand((2, T, B, H), 1.0),
            {"dw_gemm": 2.0 * 2 * H * G * T * B,
             "nn_gemm": 2.0 * 2 * T * B * H * G}, T),
        "encoder": (
            lambda *fl: cuda_gru.stacked_gru_embed_finals(tok, *fl),
            [rand((4, Vp, G), 0.05), rand((4, G), 0.05),
             rand((4, H, G), 0.04), rand((4, G), 0.05),
             rand((4, B, H), 0.1)],
            rand((4, B, H), 1.0), {"dw_gemm": 2.0 * 4 * H * G * T * B}, T),
        "subdecoders": (seq_fn, seq_fl, seq_cot,
                        {"dw_gemm": 2.0 * 2 * H * G * A * B}, A),
        "decoder_ce": (
            dec_fn, dec_fl, dec_cot,
            {"dw_gemm": 2.0 * T * B * (3 * H * G + H * Vp),
             "nn_gemm": 2.0 * T * B * (G * H + Vp * H)}, 2 * T),
    }
    for name, (fn, floats, cot, gemm_flops, steps) in rows.items():
        runs = {}
        for dt in (torch.bfloat16, torch.float32):
            # the training forward (gradient wanted) and the backward of
            # one retained graph; the cotangent in the output's dtype
            ts = [t.to(dt).requires_grad_(True) for t in floats]
            out = fn(*ts)
            runs[dt] = (lambda ts=ts: fn(*ts),
                        lambda out=out, ts=ts: torch.autograd.grad(
                            out, ts, cot.to(out.dtype), retain_graph=True))
        turns = []
        for dt in (torch.bfloat16, torch.float32, torch.float32,
                   torch.bfloat16):
            fwd, bwd = runs[dt]
            with torch.no_grad():
                nograd = event_ms(fwd, reps)
            turns.append({"dtype": str(dt).split(".")[1],
                          "fwd_ms": event_ms(fwd, reps),
                          "fwd_nograd_ms": nograd,
                          "bwd_ms": event_ms(bwd, reps)})
        f32_sha1 = hashlib.sha1(b"".join(
            g.cpu().numpy().tobytes()
            for g in runs[torch.float32][1]())).hexdigest()
        split, launches = kernel_split(runs[torch.bfloat16][1], 3)
        rate = {part + "_tflops": flops / (split[part] * 1e9)
                for part, flops in gemm_flops.items() if split[part] > 0}
        print(json.dumps({
            "tree": tree, "row": name, "turns": turns,
            "bf16_bwd_split_ms": split, "bf16_bwd_launches": launches,
            **rate, "chain_us_a_step": split["chain"] * 1e3 / steps,
            "f32_grads_sha1": f32_sha1,
            "device": torch.cuda.get_device_name(), "nvidia_smi": smi}),
            flush=True)
        del runs

    yam = YamahaDataset(*random_corpus(cfg, 5 * B, seed + 3),
                        mode="train").arrays()

    def take(lo, hi):
        return {k: v[lo:hi] for k, v in yam.items()}

    losses = {"default": objectives.gmm_loss}
    trainers = {"float32": Trainer(cfg, init_reg_gmvae, losses, seed=seed,
                                   device="cuda"),
                "bfloat16": Trainer(ModelConfig(dtype="bfloat16"),
                                    init_reg_gmvae, losses, seed=seed,
                                    device="cuda")}
    steps = []
    for label in ("float32", "bfloat16", "bfloat16", "float32"):
        tr = trainers[label]
        tr.run_epoch(take(3 * B, 5 * B), batch_size=B, seed=3)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        metrics = tr.run_epoch(take(0, 3 * B), batch_size=B, seed=4)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        steps.append({"dtype": label, "ms_per_step": wall * 1e3 / 3,
                      "seq_per_s": 3 * B / wall,
                      "train_path": tr.train_path,
                      "finite": bool(all(np.isfinite(v)
                                         for v in metrics.values()))})
    print(json.dumps({"tree": tree, "gmvae_steps_in_turns": steps, "B": B,
                      "device": torch.cuda.get_device_name(),
                      "nvidia_smi": smi}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", default=None,
                    help="root of another checkout, timed in turns")
    ap.add_argument("--tree", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.against is None:
        measure(args.reps, args.seed, args.tree)
        return
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(args.against)
    for label, root in (("against", other), ("this", here), ("this", here),
                        ("against", other)):
        # run this file over `root`'s package: the child's path starts at
        # `root`, so `music_fader_nets_tpu_torch` is that checkout's
        code = ("import runpy, sys; sys.argv = [sys.argv[0]] + sys.argv[1:];"
                f"runpy.run_path({os.path.abspath(__file__)!r}, "
                "run_name='__main__')")
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", code, "--reps", str(args.reps), "--seed",
             str(args.seed), "--tree", f"{label}:{root}"], cwd=root, env=env)
        if proc.returncode != 0:
            raise SystemExit(f"the run over {root} failed "
                             f"({proc.returncode})")


if __name__ == "__main__":
    main()
