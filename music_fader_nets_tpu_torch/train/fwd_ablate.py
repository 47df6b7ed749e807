"""Ablations of the persistent forward chain (`csrc/gru_fwd_chain.cu`), on
one GPU.

    python -m music_fader_nets_tpu_torch.train.fwd_ablate [--variants V ...]
        [--gap] [--reps 5]

Each variant is a copy of this package under `build/fwd_ablate/<name>/`
with one edit to `csrc/gru_fwd_chain.cu`, built there and run in a fresh
process: `train/fwd_split.py`'s device ms of the forward rows by part and,
with `--gap`, GLSR's first-step gradient gap at step 21 (kernel path
against plain path, and each against a float64 run of the plain path, as
`chip_smoke.py`'s `train_family` phase takes them). The variants:

- `base`: the source as it is;
- `no_wait`: the step barrier's wait removed (blocks run ahead on stale
  rows: the barrier's cost);
- `no_product`: no product slabs (everything but the product);
- `no_l2_read`: h[t-1]'s copies zero-filled (the product without reading
  the other blocks' rows from L2);
- `late_xpre`: the next step's xpre loaded between arrive and wait, not
  while the step multiplies (fewer live registers);
- `blocked_k`: each warp takes 8 consecutive k of every 64 instead of
  every 8th k (another summation order, the same work).

All but `base` and `blocked_k` compute wrong values and serve timing only.
Prints one JSON line a variant and measurement.

    python -m music_fader_nets_tpu_torch.train.fwd_ablate --bf16-chain
        [--variants V ...] [--reps 5]

ablates instead the bf16 chain's tensor-core product (`gru_fwd_chain<RB,
bf16, bf16>` and `<RB, float, bf16>`) at the training forward of row 3t
bf16 (the encoder: L=4, T=seq_len, B=batch_size, H=hidden_dims, 64-row
tiles) and row 9 bf16 (the decoder with the CE head: two L=1 chains of
16-row tiles), printing each forward's chain device ms and us a chain
step (CUPTI; in `base`, also the float32 chain's on the same inputs
widened):

- `base`: the source as it is;
- `no_product`: no product phase (no copy of h[t-1], no split, no MMA);
- `no_l2_read`: the MMAs over whatever the warps' rings hold, no copy of
  h[t-1]'s rows from L2;
- `no_wait`: the blocks of a row tile do not wait at the step barrier
  (they still arrive).

With those four run, a last line gives each row's us a step by part:
`product` (base - no_product), `l2_read` (base - no_l2_read), `wait`
(base - no_wait) and `rest` (no_product: the gates, the barrier, the
stores). These three compute wrong values. Three design alternatives
compute the same sums in the same order as `base` (each line's
`out_sha1` of the forward's output must equal base's):

- `stages_8`: rings of 8 k-steps, not 4 (the shared memory the bf16 slab
  freed holds h[t-1]'s rows further ahead);
- `prefetch`: a k-step's fragments loaded and split while the previous
  k-step's MMAs run (two register sets);
- `pieces`: the producer publishes h[t] as its three bf16 pieces, 6 bytes
  a value, and the consumers read the A fragments by ldmatrix.trans: no
  split, 1.5x the bytes from L2.

Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
OUT = PKG.parent / "build" / "fwd_ablate"
SRC = "csrc/gru_fwd_chain.cu"

# variant -> (old text, new text) edits of SRC, each found exactly once
EDITS = {
    "base": [],
    "no_wait": [("      wait(t + 2);\n", "")],
    "no_product": [("  const int nslab = Kp / KK;",
                    "  const int nslab = 0;")],
    "no_l2_read": [("""          cp_async<16>(dst + kk * WR + 4 * quad,
                         k < H ? src + (size_t)k * Bp + 4 * quad : src,
                         k < H ? 16 : 0);""",
                    "          cp_async<16>(dst + kk * WR + 4 * quad, src, "
                    "0);")],
    "late_xpre": [("    if (!last) load_x(t + 1, nr, nz, nn);\n", ""),
                  ("      arrive();\n    }",
                   "      arrive();\n      load_x(t + 1, nr, nz, nn);\n    }")],
    "blocked_k": [("const int k = sl * KK + warp + kWarps * kk;",
                   "const int k = sl * KK + warp * kFwdWarpK + kk;"),
                  ("sW + ((size_t)sl * KK + warp) * kFwdN",
                   "sW + ((size_t)sl * KK + warp * kFwdWarpK) * kFwdN"),
                  ("ws + (size_t)kk * kWarps * kFwdN", "ws + (size_t)kk * kFwdN")],
}

# the bf16 chain's design alternatives (--bf16-chain), each computing the
# same sums in the same order as `base`: `stages_8`, rings of 8 k-steps
# (the freed shared memory holds h[t-1]'s rows further ahead);
# `prefetch`, a k-step's fragments loaded and split while the previous
# k-step's MMAs run; `pieces`, the producer publishes h[t] as its three
# bf16 pieces (k-major, 6 bytes a value) and the consumers read the A
# fragments by ldmatrix.trans, no split
TC_FRAGS_OLD = """    for (int sl = 0; sl < tslabs; ++sl) {
      cp_async_wait<kFwdTcStages - 2>();
      // the warp's own copies have landed and its lanes have left the
      // stage that is refilled next
      __syncwarp();
      if (sl + kFwdTcStages - 1 < tslabs) fill(sl + kFwdTcStages - 1);
      cp_async_commit();
      const int k0 = sl * KT + set * kFwdTcK;
      uint32_t bw[24];        // B fragments of the 12 column tiles
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {"""
TC_SPLIT_OLD = """      const float* a =
          tring + (sl % kFwdTcStages) * (kFwdTcK * RS) + 2 * q * RS + g;
      uint32_t ap[3][4];      // pieces hi, mid, lo
      split3(a[0], a[RS], ap[0][0], ap[1][0], ap[2][0]);
      split3(a[8], a[RS + 8], ap[0][1], ap[1][1], ap[2][1]);
      split3(a[8 * RS], a[9 * RS], ap[0][2], ap[1][2], ap[2][2]);
      split3(a[8 * RS + 8], a[9 * RS + 8], ap[0][3], ap[1][3], ap[2][3]);"""
TC_PREFETCH = [
    (TC_FRAGS_OLD, """    uint32_t bw[24], ap[3][4];
    // slab sl's fragments: B of the 12 column tiles, A's pieces
    auto frags = [&](int sl, uint32_t (&bw)[24], uint32_t (&ap)[3][4]) {
      cp_async_wait<kFwdTcStages - 2>();
      __syncwarp();
      if (sl + kFwdTcStages - 1 < tslabs) fill(sl + kFwdTcStages - 1);
      cp_async_commit();
      const int k0 = sl * KT + set * kFwdTcK;
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {"""),
    (TC_SPLIT_OLD, """      const float* a =
          tring + (sl % kFwdTcStages) * (kFwdTcK * RS) + 2 * q * RS + g;
      split3(a[0], a[RS], ap[0][0], ap[1][0], ap[2][0]);
      split3(a[8], a[RS + 8], ap[0][1], ap[1][1], ap[2][1]);
      split3(a[8 * RS], a[9 * RS], ap[0][2], ap[1][2], ap[2][2]);
      split3(a[8 * RS + 8], a[9 * RS + 8], ap[0][3], ap[1][3], ap[2][3]);
    };
    if (tslabs > 0) frags(0, bw, ap);
    for (int sl = 0; sl < tslabs; ++sl) {
      uint32_t nbw[24], nap[3][4];
      if (sl + 1 < tslabs) frags(sl + 1, nbw, nap);"""),
    ("""          mma_bf16(acc[nt], ap[pc], bw[2 * nt], bw[2 * nt + 1]);
    }""", """          mma_bf16(acc[nt], ap[pc], bw[2 * nt], bw[2 * nt + 1]);
#pragma unroll
      for (int i = 0; i < 24; ++i) bw[i] = nbw[i];
#pragma unroll
      for (int i = 0; i < 12; ++i) ap[i / 4][i % 4] = nap[i / 4][i % 4];
    }"""),
]
TC_PIECES = [
    ("  return chain_counter_floats(L, B) + 2LL * L * H * chain_bp(B);",
     "  return chain_counter_floats(L, B) + 3LL * L * H * chain_bp(B);"),
    ("constexpr int kFwdBufTc = 128 * kFwdTcRed;",
     "constexpr int kFwdBufTc = 18432;"),
    ("""      if (idx < kCopies && c0 + c < H)
        *reinterpret_cast<float4*>(dT + (size_t)(c0 + c) * Bp + 4 * quad) =
            sT[(size_t)quad * kTStride + c];""",
     """      if (idx < kCopies && c0 + c < H) {
        const float4 v = sT[(size_t)quad * kTStride + c];
        if constexpr (is_f32<S>) {
          *reinterpret_cast<float4*>(dT + (size_t)(c0 + c) * Bp + 4 * quad) =
              v;
        } else {
          bf16* at = reinterpret_cast<bf16*>(p.hT) +
                     ((size_t)parity * p.L + l) * 3 * H * Bp + b0 +
                     (size_t)(c0 + c) * Bp + 4 * quad;
          uint32_t h0, m0, l0, h1, m1, l1;
          split3(v.x, v.y, h0, m0, l0);
          split3(v.z, v.w, h1, m1, l1);
          *reinterpret_cast<uint2*>(at) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(at + (size_t)H * Bp) = make_uint2(m0, m1);
          *reinterpret_cast<uint2*>(at + 2 * (size_t)H * Bp) =
              make_uint2(l0, l1);
        }
      }"""),
    ("""    static_assert(kWarps * kFwdTcStages * kFwdTcK * RS <= kFwdBufTc,
                  "rings fit");""", """    static_assert(kWarps * kFwdTcStages * 3 * kFwdTcK * 12 <= kFwdBufTc,
                  "rings fit");"""),
    ("""    const float* src = p.hT + ((size_t)((t + 1) & 1) * p.L + l) * H * Bp +
                       b0 + 16 * mw;
    float* tring = buf + warp * (kFwdTcStages * kFwdTcK * RS);
    auto fill = [&](int sl) {
      float* dst = tring + (sl % kFwdTcStages) * (kFwdTcK * RS);
#pragma unroll
      for (int n = 0; n < kFwdTcK * 4 / 32; ++n) {
        const int idx = lane + n * 32;
        const int kk = idx >> 2, quad = idx & 3;
        const int k = sl * KT + set * kFwdTcK + kk;
        cp_async<16>(dst + kk * RS + 4 * quad,
                     k < H ? src + (size_t)k * Bp + 4 * quad : src,
                     k < H ? 16 : 0);
      }
    };""", """    // the pieces' ring: [stage][piece][k][24 bf16] (48-byte rows: the 8
    // rows an ldmatrix reads fall on distinct banks)
    constexpr int PR = 24, PS = 3 * kFwdTcK * PR;
    const bf16* src = reinterpret_cast<const bf16*>(p.hT) +
                      ((size_t)((t + 1) & 1) * p.L + l) * 3 * H * Bp + b0 +
                      16 * mw;
    bf16* tring = reinterpret_cast<bf16*>(buf) + warp * (kFwdTcStages * PS);
    auto fill = [&](int sl) {
      bf16* dst = tring + (sl % kFwdTcStages) * PS;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int idx = lane + n * 32;
        const int kk = (idx & 31) >> 1, half = idx & 1;
        const int k = sl * KT + set * kFwdTcK + kk;
        const bf16* from = src + (size_t)n * H * Bp;
        cp_async<16>(dst + (n * kFwdTcK + kk) * PR + 8 * half,
                     k < H ? from + (size_t)k * Bp + 8 * half : from,
                     k < H ? 16 : 0);
      }
    };"""),
    (TC_SPLIT_OLD, """      const bf16* pa = tring + (sl % kFwdTcStages) * PS +
                       ((lane >> 4) * 8 + (lane & 7)) * PR +
                       ((lane >> 3) & 1) * 8;
      uint32_t ap[3][4];      // pieces hi, mid, lo
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        ldsm_x4_trans(ap[pc], pa + pc * kFwdTcK * PR);"""),
]

# the bf16 chain's variants (--bf16-chain): ablations, then the design
# alternatives
TC_EDITS = {
    "base": [],
    "no_product": [("    const int tslabs = (H + KT - 1) / KT;",
                    "    const int tslabs = 0;")],
    "no_l2_read": [("        cp_async<16>(dst + kk * RS + 4 * quad,",
                    "        if (false) cp_async<16>(dst + kk * RS + "
                    "4 * quad,")],
    "no_wait": [("      wait(t + 2);\n", "")],
    "stages_8": [("constexpr int kFwdTcStages = 4;",
                  "constexpr int kFwdTcStages = 8;"),
                 ("constexpr int kFwdBufTc = 128 * kFwdTcRed;",
                  "constexpr int kFwdBufTc = 20480;")],
    "prefetch": TC_PREFETCH,
    "pieces": TC_PIECES,
}

# the bf16 chain's sweep, run inside a variant's directory: argv = reps,
# then "1" to time the float32 chain on the same inputs too
TC_SWEEP = r"""
import hashlib, json, sys, torch
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.ops import cuda_gru
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.train.bwd_split import (
    decoder_cases, kernel_split)
from music_fader_nets_tpu_torch.train.fwd_split import (
    PARTS, SKIP, forward_of)
cfg, dev = ModelConfig(), torch.device("cuda")
T, B, H, V = cfg.seq_len, cfg.batch_size, cfg.hidden_dims, cfg.roll_dims
G, Vp = 3 * H, vocab_pad(V)
reps, with_f32 = int(sys.argv[1]), sys.argv[2] == "1"
gen = torch.Generator().manual_seed(0)
def rand(shape, scale):
    return (torch.randn(shape, generator=gen) * scale).to(dev)
tok = torch.randint(0, V, (4, T, B), generator=gen,
                    dtype=torch.int32).to(dev)
_, dec_fn, dec_fl, _ = decoder_cases(T, B, H, V, rand, dev)["decoder_ce"]
rows = {"3t": (lambda *fl: cuda_gru.stacked_gru_embed_finals(tok, *fl),
               [rand((4, Vp, G), 0.05), rand((4, G), 0.05),
                rand((4, H, G), 0.04), rand((4, G), 0.05),
                rand((4, B, H), 0.1)], T),
        "9": (dec_fn, dec_fl, 2 * T)}
for row, (fn, floats, steps) in rows.items():
    for dt in (torch.bfloat16, torch.float32)[:2 if with_f32 else 1]:
        fl = [t.to(dt) if t.is_floating_point() else t for t in floats]
        fwd = forward_of(fn, fl)
        split, launches = kernel_split(fwd, reps, PARTS, SKIP)
        out = fwd().detach().float().cpu().numpy().tobytes()
        print(json.dumps({"row": row, "dtype": str(dt).split(".")[1],
                          "split_ms": split,
                          "chain_us_a_step": split["chain"] * 1e3 / steps,
                          "launches": launches,
                          "out_sha1": hashlib.sha1(out).hexdigest()}),
              flush=True)
"""

# the GLSR first-step gap, run inside a variant's directory
GAP = r"""
import json, torch
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.train.profile import FAMILIES, random_corpus
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import tree_map
cfg, B, dev = ModelConfig(), 128, torch.device("cuda")
init_fn, loss_fn, step = FAMILIES["glsr"]
batch = {k: torch.from_numpy(v[:B]).to(dev) for k, v in YamahaDataset(
    *random_corpus(cfg, 7 * B, 2), mode="train").arrays().items()}
tr = Trainer(cfg, init_fn, {"default": loss_fn}, seed=0, device="cuda")
eps = tuple(e.to(dev) for e in tr.noise_fn(0, B, loss_fn))
leaves = tr.optimizer.param_groups[0]["params"]
def grads(params=tr.fast_params, eps=eps, batch=batch, leaves=leaves):
    loss, _ = loss_fn(params, eps, batch, step, cfg)
    return torch.autograd.grad(loss, leaves, allow_unused=True)
def worst(a, b):
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-3)
               for x, y in zip(a, b) if y is not None)
wrappers = [(m, n) for m, ns in ((cuda_gru, ("stacked_gru_embed_finals",
            "stacked_gru_embed_seq")), (cuda_decoder, ("decoder_teacher",
            "decoder_teacher_nll", "decoder_teacher_masses")),
            (cuda_stacked, ("stacked_gru",))) for n in ns]
kernel = grads()
for m, n in wrappers:
    setattr(m, n, getattr(m, n + "_plain"))
copies = {}
def to64(t):
    copies[id(t)] = t.detach().double().requires_grad_(t.requires_grad)
    return copies[id(t)]
p64 = tree_map(to64, tr.fast_params)
plain = grads()
f64 = grads(p64, tuple(e.double() for e in eps),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}, [copies[id(t)] for t in leaves])
print(json.dumps({"glsr_first_step_rel": {
    "kernel_vs_plain": worst(kernel, plain),
    "kernel_vs_float64": worst(kernel, f64),
    "plain_vs_float64": worst(plain, f64)}}))
"""


def package_copy(root: Path, src: str, edits) -> Path:
    """A copy of the package under `root` with `edits` ((old, new) text
    pairs, each found exactly once) made to its file `src`; `root`."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / PKG.name / src
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{root.name}: edit not found once in {src}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def make_variant(name: str) -> Path:
    """A copy of the package with `name`'s edits; its directory."""
    return package_copy(OUT / name, SRC, EDITS[name])


def run(root: Path, args) -> str:
    return subprocess.run([sys.executable, *args], cwd=root, check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout


def bf16_chain(variants, reps: int) -> None:
    """The --bf16-chain ablation: one JSON line a variant, row and dtype,
    then the rows' us a step by part when all four variants ran."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    us = {}
    for name in variants:
        root = package_copy(OUT / ("bf16_" + name), SRC, TC_EDITS[name])
        try:
            out = run(root, ["-c", TC_SWEEP, str(reps),
                             str(int(name == "base"))])
        except subprocess.CalledProcessError as e:
            print(json.dumps({"variant": name, "failed": e.stderr[-2000:]}),
                  flush=True)
            continue
        for line in out.splitlines():
            row = json.loads(line)
            if row["dtype"] == "bfloat16":
                us[(name, row["row"])] = row["chain_us_a_step"]
            print(json.dumps({"variant": name, **row, "nvidia_smi": smi}),
                  flush=True)
    if {"base", "no_product", "no_l2_read", "no_wait"} <= {n for n, _ in us}:
        parts = {}
        for r in ("3t", "9"):
            base = us[("base", r)]
            parts[r] = {"base": base,
                        "product": base - us[("no_product", r)],
                        "l2_read": base - us[("no_l2_read", r)],
                        "wait": base - us[("no_wait", r)],
                        "rest": us[("no_product", r)]}
        print(json.dumps({"us_a_step_by_part": parts, "nvidia_smi": smi}),
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16-chain", action="store_true")
    ap.add_argument("--variants", nargs="+", default=None,
                    choices=sorted(set(EDITS) | set(TC_EDITS)))
    ap.add_argument("--gap", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.bf16_chain:
        bf16_chain(args.variants or list(TC_EDITS), args.reps)
        return
    for name in args.variants or list(EDITS):
        root = make_variant(name)
        for line in run(root, ["-m", f"{PKG.name}.train.fwd_split", "--reps",
                               str(args.reps)]).splitlines():
            row = json.loads(line)
            print(json.dumps({"variant": name, "kernel": row["kernel"],
                              "fwd_ms": row["fwd_ms"],
                              "split_ms": row["split_ms"],
                              "device": row["device"],
                              "nvidia_smi": row["nvidia_smi"]}), flush=True)
        if args.gap and name in ("base", "blocked_k"):
            gap = json.loads(run(root, ["-c", GAP]).splitlines()[-1])
            print(json.dumps({"variant": name, **gap}), flush=True)


if __name__ == "__main__":
    main()
