"""Ablations of the persistent decode kernel (`csrc/decode.cu`), on one GPU.

    python -m music_fader_nets_tpu_torch.serve.decode_ablate [--variants V ...]
        [--reps 10]

Each variant is a copy of this package under `build/decode_ablate/<name>/`
with edits to `csrc/decode.cu`, built there and run in a fresh process: the
greedy decode's device ms a call (CUDA events, median of `--reps`) at the
config's width and decode steps, B=64 and B=1, random weights from a seed,
and whether its tokens equal the plain decode's. The variants:

- `base`: the source as it is;
- `no_wait`: the grid barrier's wait removed (a block arrives and goes
  on: the wait's cost);
- `no_sync`: the grid barrier reduced to the block's own __syncthreads (no
  arrival, no wait);
- `no_product`: no product slabs (everything but the operands' loads and
  the FMAs);
- `no_logits`: phase C's product and argmax skipped (the logits' cost);
- `no_skew`: the partial tiles without their bank skew (right tokens);
- `fence_counter`: the barrier as the forward and backward chains build
  theirs (__threadfence, atomicAdd, a volatile spin, __threadfence) in
  place of the release add and acquire loads (right tokens too).

All but `base`, `no_skew` and `fence_counter` compute wrong tokens and
serve timing only.
Prints one JSON line a variant and batch size. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from music_fader_nets_tpu_torch.train.fwd_ablate import PKG, package_copy

OUT = PKG.parent / "build" / "decode_ablate"
SRC = "csrc/decode.cu"

_ARRIVE = """      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :: "l"(p.counter) : "memory");
"""
_WAIT = """      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen) : "l"(p.counter) : "memory");
      } while (seen < (unsigned)NB * phase);
"""
# variant -> (old text, new text) edits of SRC, each found exactly once
EDITS = {
    "base": [],
    "no_wait": [(_WAIT, "")],
    "no_sync": [(_ARRIVE, "      ;\n"), (_WAIT, "")],
    "no_product": [("  const int nslab = Kp / KC;", "  const int nslab = 0;")],
    "no_logits": [("    for (int q = 0; q < ntb; ++q) {",
                   "    for (int q = 0; q < 0; ++q) {")],
    "no_skew": [("  return r * kDecCols + (r / 8) * 4 + c;",
                 "  return r * kDecCols + c;")],
    "fence_counter": [(_ARRIVE, """    {
      __threadfence();
      atomicAdd(p.counter, 1u);
    }
"""), (_WAIT, """      while (*reinterpret_cast<volatile unsigned*>(p.counter) <
             (unsigned)NB * phase) {
      }
      __threadfence();
""")],
}

# the measurement, run inside a variant's directory
MEASURE = r"""
import json, subprocess, sys, torch
from music_fader_nets_tpu_torch.config import load_config
from music_fader_nets_tpu_torch.models.modules import global_decoder_init
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to
reps = int(sys.argv[1])
cfg, dev = load_config(None), torch.device("cuda")
gen = torch.Generator().manual_seed(0)
H, V, steps = cfg.hidden_dims, cfg.roll_dims, cfg.transfer_decode_steps
Zt = 2 * cfg.z_dims + cfg.chroma_dims
gview = tree_to(global_decoder_init(gen, Zt, V, H), dev)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip()
for B in (64, 1):
    z = torch.randn((B, Zt), generator=gen).to(dev)
    got = cuda_decode.cuda_greedy_decode(gview, z, steps)
    same = bool(torch.equal(got, cuda_decode.plain_decode_tokens(
        gview, z, steps)))
    ts = []
    for _ in range(reps + 2):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        cuda_decode.cuda_greedy_decode(gview, z, steps)
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    ts = sorted(ts[2:])
    print(json.dumps({"B": B, "steps": steps, "ms": ts[len(ts) // 2],
                      "tokens_equal_plain": same,
                      "device": torch.cuda.get_device_name(),
                      "nvidia_smi": smi}), flush=True)
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(EDITS),
                    choices=list(EDITS))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    for name in args.variants:
        root = package_copy(OUT / name, SRC, EDITS[name])
        out = subprocess.run([sys.executable, "-c", MEASURE, str(args.reps)],
                             cwd=root, check=True, capture_output=True,
                             text=True, timeout=600).stdout
        for line in out.splitlines():
            print(json.dumps({"variant": name, **json.loads(line)}),
                  flush=True)


if __name__ == "__main__":
    main()
