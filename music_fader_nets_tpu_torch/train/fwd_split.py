"""Where the device time of the forward recurrences goes, on one GPU.

    python -m music_fader_nets_tpu_torch.train.fwd_split [--reps 5]

Runs, at the config's full width (T=seq_len, B=batch_size, H=hidden_dims;
random weights and inputs from a seed), the training forward (inputs that
want a gradient, so the gate stash is written) of the encoder
(`stacked_gru_embed_finals`, L=4: row 3t), of the sub-decoders
(`stacked_gru_embed_seq`, L=2, T=attr_len: row 5), of the generic stacked
GRU (`stacked_gru`, L=2, the CVAE encoder's shape: row 1) and of the
teacher-forced decoder without a head (`decoder_teacher`, row 7), with the
CE head (`decoder_teacher_nll`, row 9) and with the masses head
(`decoder_teacher_masses`, GLSR's n_rep=4 copies of B rows, row
9-masses), and the serving encoder's forward without a gradient (finals
only, L=4, B=64: row 3), under `torch.profiler`, and prints one JSON line
each: the device ms of one forward call split by what its kernels do
(`step`: the per-step kernels a host loop launched before the persistent
chain, `embed_gru_step`, `embed_gru_train_step`, `dec_ce_layer2`,
`stacked_gru_step`; `chain`: the persistent recurrence `gru_fwd_chain`;
`gemm`: a product off the recurrence, `gemm_nn`; `head`: the CE or masses
head; `other`: memsets and copies), the call's kernel
launches at T and at T/2 (a launch a step shows as a count that grows
with T; the memsets that zero the chains' barrier counters, one a chain,
are timed but not counted, as the profiler has been seen to drop one)
and the call's time by CUDA events. Runs on CUDA only; device times from
CUPTI.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.ops import cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.train.bwd_split import (
    decoder_cases, event_ms, kernel_split,
)

# device events timed but not counted as launches
SKIP = ("Memset",)
# part of a forward call -> substrings of its kernels' names
PARTS = {
    "step": ("embed_gru_step", "embed_gru_train_step", "dec_ce_layer2",
             "stacked_gru_step"),
    "chain": ("gru_fwd_chain",),
    "gemm": ("gemm_nn",),
    "head": ("ce_head", "mass_head"),
}


def forward_of(fn, floats):
    """A callable that runs `fn` on copies of `floats` that want a
    gradient (the training forward, gate stash included)."""
    ts = [t.detach().clone().requires_grad_(True) for t in floats]
    return lambda: fn(*ts)


def embed_rows(T, A, B, H, V, rand, dev):
    """{row: (shape, forward callable)} of the encoder (L=4, T steps, B
    rows, training; and B // 2 rows without a gradient, the serving call)
    and of the sub-decoders (L=2, A steps, 16 classes)."""
    G, Vp = 3 * H, vocab_pad(V)
    gen = torch.Generator().manual_seed(T + A)

    def ids(L, t, b, n):
        return torch.randint(0, n, (L, t, b), generator=gen,
                             dtype=torch.int32).to(dev)

    def enc(b):
        return [rand((4, Vp, G), 0.05), rand((4, G), 0.05),
                rand((4, H, G), 0.04), rand((4, G), 0.05),
                rand((4, b, H), 0.1)]

    tok, tok_s, cls = ids(4, T, B, V), ids(4, T, B // 2, V), ids(2, A, B, 16)
    serve = enc(B // 2)
    return {
        "embed_gru_train": (
            {"L": 4, "T": T, "B": B, "H": H, "Vp": Vp},
            forward_of(lambda *fl: cuda_gru.stacked_gru_embed_finals(
                tok, *fl), enc(B))),
        "embed_seq": (
            {"L": 2, "T": A, "B": B, "H": H, "C": 16},
            forward_of(lambda *fl: cuda_gru.stacked_gru_embed_seq(cls, *fl),
                       [rand((2, 16, G), 0.05), rand((2, B, G), 0.5),
                        rand((2, H, G), 0.04), rand((2, G), 0.05),
                        rand((2, B, H), 0.1)])),
        "embed_gru": (
            {"L": 4, "T": T, "B": B // 2, "H": H, "Vp": Vp},
            lambda: cuda_gru.stacked_gru_embed_finals(tok_s, *serve)),
    }


def forward_rows(T, B, H, V, rand, dev, A=16):
    """{row: (shape, forward callable)} of the encoder entries and the
    sub-decoders' (`embed_rows`, A steps), the stacked GRU at L=2 and the
    three decoder entries at T steps and B rows."""
    L, G = 2, 3 * H
    rows = embed_rows(T, A, B, H, V, rand, dev)
    rows["stacked_gru"] = (
        {"L": L, "T": T, "B": B, "H": H},
        forward_of(cuda_stacked.stacked_gru,
                   [rand((L, T, B, G), 0.5), rand((L, H, G), 0.04),
                    rand((L, G), 0.05), rand((L, B, H), 0.1)]))
    for name, (shape, fn, floats, _) in decoder_cases(T, B, H, V, rand,
                                                      dev).items():
        rows[name] = (shape, forward_of(fn, floats))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = load_config(args.config)
    T, B, H, V = cfg.seq_len, cfg.batch_size, cfg.hidden_dims, cfg.roll_dims
    gen = torch.Generator().manual_seed(args.seed)

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    A = cfg.attr_len
    rows = forward_rows(T, B, H, V, rand, dev, A)
    half = forward_rows(T // 2, B, H, V, rand, dev, A // 2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for name, (shape, fwd) in rows.items():
        split, launches = kernel_split(fwd, args.reps, PARTS, SKIP)
        line = {"kernel": name, "shape": shape,
                "fwd_ms": event_ms(fwd, args.reps), "split_ms": split,
                "launches": launches,
                "launches_at_half_T": kernel_split(half[name][1], 1, PARTS,
                                                   SKIP)[1]}
        print(json.dumps({**line, "device": torch.cuda.get_device_name(),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
