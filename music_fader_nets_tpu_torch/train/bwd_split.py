"""Where the device time of the GRU and decoder backward kernels goes, on
one GPU.

    python -m music_fader_nets_tpu_torch.train.bwd_split [--reps 5]

Runs, at the config's full width (T=seq_len, B=batch_size, H=hidden_dims;
random weights and inputs from a seed), the backward of the encoder
(`stacked_gru_embed_finals`, L=4), of the sub-decoders
(`stacked_gru_embed_seq`, L=2, T=attr_len, a class table of max(rhythm_dims,
note_dims) rows, the rhythm direction's ids in [0, rhythm_dims), the note
direction's in [0, note_dims): row 6), of the generic stacked GRU
(`stacked_gru`, L=2) and of the teacher-forced decoder with the CE head
(`decoder_teacher_nll`, row 10), with the masses head (`decoder_teacher_
masses`, GLSR's n_rep=4 copies of B rows and `GLSR_MASK_RANGES`, row
10-masses) and without a head (`decoder_teacher`, row 8), under
`torch.profiler`, and prints one JSON line each: the device ms of one
backward call split by what its kernels do (`chain`: the dh recurrences;
`head`: the CE or masses head's dlogits; `nn_gemm`: the products off the
recurrence, dh2_head = dlogits w_out^T and the decoder's cross-layer
cotangent; `dw_gemm`: dW = h_prev^T dpre with its split-K sum; `scatter`:
the token scatter of dW_in; `sums`: the bias and per-sequence sums;
`other`: memsets, the weight transposes, autograd's own copies; the
sub-decoders' chain sums their classes, dprez and db_hh itself), the
call's device launches (kernels and memsets; for the sub-decoders and the
decoder rows also at T/2, to show that no launch is made per step) and the
call's time by CUDA events. Runs on CUDA only; device times from CUPTI.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.losses.regularizers import GLSR_MASK_RANGES
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.ops.gru import vocab_pad

# part of a backward call -> substrings of its kernels' names
PARTS = {
    "chain": ("gru_bwd_chain",),
    "head": ("ce_head", "mass_head"),
    "nn_gemm": ("gemm_nn",),
    "dw_gemm": ("gemm_tn", "splitk_sum"),
    "scatter": ("segment_rows",),
    "sums": ("colsum", "sum_over_t"),
}


def kernel_split(fn, reps: int = 3, parts=PARTS, skip=()):
    """(device ms of one call of `fn` by part (`parts`: name -> substrings
    of its kernels' names, and `other`), device launches of one call:
    kernels and memsets, less the events whose names start with a prefix
    in `skip`, which are timed but not counted), over `reps` profiled
    calls after one warm-up call. A profile that caught no device event
    at all (seen now and then right after another profile) is taken
    again, up to twice."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    split = {part: 0.0 for part in (*parts, "other")}
    n = 0
    for e in events:
        n += not e.name.startswith(tuple(skip))
        part = next((p for p, keys in parts.items()
                     if any(k in e.name for k in keys)), "other")
        split[part] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return split, n / reps


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


def decoder_cases(T, B, H, V, rand, dev):
    """{entry: (shape, fn, float inputs, output cotangent)} of the three
    teacher-forced decoder entries at T steps, B token rows (the masses
    head: n_rep = 4 copies of them) and width H: `fn(*floats)` runs the
    entry's wrapper."""
    G, Vp = 3 * H, vocab_pad(V)
    gen = torch.Generator().manual_seed(T)
    tgt = torch.randint(0, V, (T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    tok = torch.cat([torch.full((1, B), V - 1, dtype=torch.int32,
                                device=dev), tgt[:-1]])
    w_out = torch.nn.functional.pad(rand((H, V), 0.04), (0, Vp - V))
    b_out = torch.nn.functional.pad(rand((V,), 0.05), (0, Vp - V),
                                    value=cuda_decoder.PAD_LOGIT)

    def rec(rows):
        """w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0."""
        return [rand((Vp, G), 0.04), rand((rows, G), 0.5), rand((H, G), 0.04),
                rand((G,), 0.05), rand((H, G), 0.04), rand((G,), 0.05),
                rand((H, G), 0.04), rand((G,), 0.05), rand((rows, H), 0.5)]

    n_rep, K = 4, len(GLSR_MASK_RANGES)
    return {
        "decoder_ce": (
            {"T": T, "B": B, "H": H, "Vp": Vp},
            lambda *fl: cuda_decoder.decoder_teacher_nll(tok, tgt, *fl),
            rec(B) + [w_out, b_out],
            torch.full((T, B), 1.0 / (T * B), device=dev)),
        "decoder_masses": (
            {"T": T, "B0": B, "n_rep": n_rep, "rows": n_rep * B, "H": H,
             "Vp": Vp, "K": K},
            lambda *fl: cuda_decoder.decoder_teacher_masses(
                tok, *fl, GLSR_MASK_RANGES, n_rep),
            rec(n_rep * B) + [w_out, b_out],
            rand((T, K, n_rep * B), 1.0 / (T * B))),
        "decoder_teacher": (
            {"T": T, "B": B, "H": H, "Vp": Vp},
            lambda *fl: cuda_decoder.decoder_teacher(tok, *fl), rec(B),
            rand((T, B, H), 0.01)),
    }


def decoder_rows(T, B, H, V, rand, dev):
    """{row: (shape, backward callable)} of the three decoder backward
    entries (`decoder_cases`)."""
    return {name + "_bwd": (shape, backward_of(fn, floats, cot))
            for name, (shape, fn, floats, cot) in decoder_cases(
                T, B, H, V, rand, dev).items()}


def embed_seq_case(cfg, T, rand, gen, dev):
    """(shape, fn, float inputs, output cotangent) of the sub-decoders'
    entry at T steps, as the main path calls it: L = 2 directions (rhythm,
    note) over B = batch_size rows, a class table of max(rhythm_dims,
    note_dims) rows, direction 0's ids in [0, rhythm_dims), direction 1's
    in [0, note_dims)."""
    L, B, H = 2, cfg.batch_size, cfg.hidden_dims
    G, C = 3 * H, max(cfg.rhythm_dims, cfg.note_dims)
    cls = torch.stack([
        torch.randint(0, n, (T, B), generator=gen, dtype=torch.int32)
        for n in (cfg.rhythm_dims, cfg.note_dims)]).to(dev)
    return ({"L": L, "T": T, "B": B, "H": H, "C": C},
            lambda *fl: cuda_gru.stacked_gru_embed_seq(cls, *fl),
            [rand((L, C, G), 0.05), rand((L, B, G), 0.5),
             rand((L, H, G), 0.04), rand((L, G), 0.05), rand((L, B, H), 0.5)],
            rand((L, T, B, H), 1.0))


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
    A = cfg.attr_len
    shape, fn, floats, cot = embed_seq_case(cfg, A, rand, gen, dev)
    rows["embed_seq_bwd"] = (shape, backward_of(fn, floats, cot))
    L = 2
    rows["stacked_gru_bwd"] = (
        {"L": L, "T": T, "B": B, "H": H},
        backward_of(cuda_stacked.stacked_gru,
                    [rand((L, T, B, G), 0.5), rand((L, H, G), 0.04),
                     rand((L, G), 0.05), rand((L, B, H), 0.1)],
                    rand((L, T, B, H), 1.0)))
    rows.update(decoder_rows(T, B, H, V, rand, dev))
    half = decoder_rows(T // 2, B, H, V, rand, dev)
    _, fn, floats, cot = embed_seq_case(cfg, A // 2, rand, gen, dev)
    half["embed_seq_bwd"] = (None, backward_of(fn, floats, cot))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for name, (shape, bwd) in rows.items():
        split, launches = kernel_split(bwd, args.reps)
        line = {"kernel": name, "shape": shape,
                "bwd_ms": event_ms(bwd, args.reps), "split_ms": split,
                "launches": launches}
        if name in half:
            line["launches_at_half_T"] = kernel_split(half[name][1], 1)[1]
        print(json.dumps({**line, "device": torch.cuda.get_device_name(),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
