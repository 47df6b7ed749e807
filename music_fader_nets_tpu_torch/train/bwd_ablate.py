"""Ablations of the sub-decoders' backward (row 6: the persistent backward
chain's sub-decoders' mode, `csrc/embed_gru_bwd.cu::gru_bwd_chain<RB,
true>`), on one GPU.

    python -m music_fader_nets_tpu_torch.train.bwd_ablate [--variants V ...]
        [--steps 1 8 16] [--reps 5]

Each variant is a copy of this package under `build/bwd_ablate/<name>/`
with edits to `csrc/embed_gru_bwd.cu`, built there and run in a fresh
process. It prints, at the sub-decoders' shape (L=2, B=batch_size,
H=hidden_dims, 16 class rows, the rhythm direction's ids in [0, 3)) and at
each T of `--steps`, the device ms of one backward call by part
(`train/bwd_split.py`'s parts) and its device launches: of the
sub-decoders' entry (`fader_embed_seq_bwd`) and, beside it in the same
process, of the generic entry on the same inputs (`fader_embed_gru_bwd`
with a per-step cotangent: dpre_x stashed, then the class scatter and the
sums as kernels of their own, after a transpose of w_hh). The variants:

- `base`: the source as it is;
- `no_sums`: the chain sums nothing over the steps (dprez, db_hh and
  dW_emb come out as zeros): the sums' cost;
- `no_class`: dprez and db_hh summed, dW_emb not: the class sums' cost;
- `quad_branch`: the class sums by a branch on the (warp-uniform) class's
  quad of 4 classes, predicated adds inside it;
- `onehot_fma`: the class sums as fmaf(one-hot, value, sum) for all 16
  classes (a non-finite value in one class would reach them all).

`no_sums` and `no_class` compute wrong gradients and serve timing only.
Prints one JSON line a variant and T.

    python -m music_fader_nets_tpu_torch.train.bwd_ablate --bf16-chain
        [--reps 5]

ablates instead the bf16 chain's tensor-core product (`gru_bwd_chain<RB,
false, bf16>`) at the encoder's backward (row 4 bf16: L=4, T=seq_len,
B=batch_size, H=hidden_dims), printing the chain's device ms and us a step
(and, in `tc_base`, the float32 chain's on the same inputs widened):

- `tc_base`: the source as it is;
- `tc_no_mma`: no MMA (the dph rows still copied into the warps' rings);
- `tc_no_l2`: the MMAs over whatever the rings hold, no copy of the dph
  rows from L2;
- `tc_no_product`: no product phase at all (no copy, no split, no MMA);
- `tc_no_wait`: the blocks of a row tile do not wait at the step
  barrier (they still arrive).

All but `tc_base` compute wrong gradients. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from music_fader_nets_tpu_torch.train.fwd_ablate import PKG, package_copy

OUT = PKG.parent / "build" / "bwd_ablate"
SRC = "csrc/embed_gru_bwd.cu"

CLASS_ADDS = """#pragma unroll
    for (int v = 0; v < kSeqClasses; ++v)
      add_if(id == v, s.c[v], dar[i], daz[i], dan[i]);"""

# variant -> (old text, new text) edits of SRC, each found exactly once
EDITS = {
    "base": [],
    "no_sums": [("      seq_add(seq, dar, daz, dan, dhn);\n", "")],
    "no_class": [(CLASS_ADDS, "    (void)id;")],
    "quad_branch": [(CLASS_ADDS, """#pragma unroll
    for (int q = 0; q < kSeqClasses / 4; ++q)
      if ((id >> 2) == q) {
#pragma unroll
        for (int v = 4 * q; v < 4 * q + 4; ++v)
          add_if(id == v, s.c[v], dar[i], daz[i], dan[i]);
      }""")],
    "onehot_fma": [(CLASS_ADDS, """#pragma unroll
    for (int v = 0; v < kSeqClasses; ++v) {
      const float m = id == v ? 1.f : 0.f;
      s.c[v][0] = fmaf(m, dar[i], s.c[v][0]);
      s.c[v][1] = fmaf(m, daz[i], s.c[v][1]);
      s.c[v][2] = fmaf(m, dan[i], s.c[v][2]);
    }""")],
}

# the sweep, run inside a variant's directory: argv = reps, then the Ts
SWEEP = r"""
import json, sys, torch
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.ops import cuda_gru
from music_fader_nets_tpu_torch.train.bwd_split import kernel_split
cfg, dev = ModelConfig(), torch.device("cuda")
L, B, H, V = 2, cfg.batch_size, cfg.hidden_dims, 16
G = 3 * H
reps = int(sys.argv[1])
for T in map(int, sys.argv[2:]):
    gen = torch.Generator().manual_seed(T)
    cls = torch.stack([
        torch.randint(0, cfg.rhythm_dims, (T, B), generator=gen),
        torch.randint(0, cfg.note_dims, (T, B), generator=gen)]).to(
            torch.int32).to(dev)
    w_emb, prez, w_hh, b_hh, h0 = (
        (torch.randn(s, generator=gen) * 0.1).to(dev)
        for s in ((L, V, G), (L, B, G), (L, H, G), (L, G), (L, B, H)))
    cot = torch.randn((L, T, B, H), generator=gen).to(dev)
    h_seq, stash = cuda_gru._launch_train_fwd(cls, w_emb, prez, w_hh, b_hh,
                                              h0, True)
    entries = {
        "seq": lambda: cuda_gru._launch_seq_bwd(cls, cot, stash, h_seq, h0,
                                                w_hh, V),
        "generic": lambda: cuda_gru._launch_bwd(
            cls, cot, True, stash, h_seq, h0, w_hh, V, want_db_in=False,
            want_dprez=True)}
    for name, fn in entries.items():
        split, launches = kernel_split(fn, reps)
        print(json.dumps({"T": T, "entry": name, "split_ms": split,
                          "device_ms": sum(split.values()),
                          "launches": launches}), flush=True)
"""


# the bf16 chain's variants (--bf16-chain)
TC_EDITS = {
    "tc_base": [],
    "tc_no_mma": [(
        "              mma_bf16(acc[mt][nt], ap[pc][mt], bw[2 * nt], "
        "bw[2 * nt + 1]);", "              (void)ap, (void)bw;")],
    "tc_no_l2": [("          cp_async<16>(dst + kk * RS + 4 * quad,",
                  "          if (false) cp_async<16>(dst + kk * RS + "
                  "4 * quad,")],
    "tc_no_product": [("      const int nslab = Gp / KT;",
                       "      const int nslab = 0;")],
    "tc_no_wait": [("      while (*reinterpret_cast<volatile unsigned*>(ctr) "
                    "< group * step) {\n      }\n", "")],
}

# the bf16 chain's sweep: the encoder's backward entry in bf16 (and, with
# argv[2] == "1", in float32 on the same inputs widened)
TC_SWEEP = r"""
import json, sys, torch
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.ops import cuda_gru
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.train.bwd_split import kernel_split
cfg, dev = ModelConfig(), torch.device("cuda")
L, T, B, H = 4, cfg.seq_len, cfg.batch_size, cfg.hidden_dims
G, Vp = 3 * H, vocab_pad(cfg.roll_dims)
reps, with_f32 = int(sys.argv[1]), sys.argv[2] == "1"
gen = torch.Generator().manual_seed(0)
tok = torch.randint(0, cfg.roll_dims, (L, T, B), generator=gen,
                    dtype=torch.int32).to(dev)
floats = [(torch.randn(s, generator=gen) * 0.05).to(dev) for s in (
    (L, Vp, G), (L, G), (L, H, G), (L, G), (L, B, H))]
g = torch.randn((L, B, H), generator=gen).to(dev)
for dt in (torch.bfloat16, torch.float32)[:2 if with_f32 else 1]:
    w_ih, b_ih, w_hh, b_hh, h0 = (t.to(dt) for t in floats)
    h_seq, stash = cuda_gru._launch_train_fwd(tok, w_ih, b_ih, w_hh, b_hh,
                                              h0, True)
    split, launches = kernel_split(lambda: cuda_gru._launch_bwd(
        tok, g, False, stash, h_seq, h0, w_hh, Vp, want_db_in=True,
        want_dprez=False), reps)
    print(json.dumps({"T": T, "dtype": str(dt), "split_ms": split,
                      "chain_us_a_step": split["chain"] * 1e3 / T,
                      "launches": launches}), flush=True)
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16-chain", action="store_true")
    ap.add_argument("--variants", nargs="+", default=None,
                    choices=list(EDITS) + list(TC_EDITS))
    ap.add_argument("--steps", nargs="+", type=int, default=[1, 8, 16])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    edits = TC_EDITS if args.bf16_chain else EDITS
    for name in args.variants or list(edits):
        root = package_copy(OUT / name, SRC, edits[name])
        sweep = ([TC_SWEEP, str(args.reps), str(int(name == "tc_base"))]
                 if args.bf16_chain else
                 [SWEEP, str(args.reps), *map(str, args.steps)])
        out = subprocess.run(
            [sys.executable, "-c", *sweep], cwd=root, check=True,
            capture_output=True, text=True, timeout=900).stdout
        for line in out.splitlines():
            print(json.dumps({"variant": name, **json.loads(line),
                              "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
