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
Prints one JSON line a variant and measurement. Runs on CUDA only.
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
    "no_l2_read": [("""        cp_async<16>(dst + kk * WR + 4 * quad,
                       k < H ? src + (size_t)k * Bp + 4 * quad : src,
                       k < H ? 16 : 0);""",
                    "        cp_async<16>(dst + kk * WR + 4 * quad, src, 0);")],
    "late_xpre": [("    if (!last) load_x(t + 1, nr, nz, nn);\n", ""),
                  ("      arrive();\n    }",
                   "      arrive();\n      load_x(t + 1, nr, nz, nn);\n    }")],
    "blocked_k": [("const int k = sl * KK + warp + kWarps * kk;",
                   "const int k = sl * KK + warp * kFwdWarpK + kk;"),
                  ("sW + ((size_t)sl * KK + warp) * kFwdN",
                   "sW + ((size_t)sl * KK + warp * kFwdWarpK) * kFwdN"),
                  ("ws + (size_t)kk * kWarps * kFwdN", "ws + (size_t)kk * kFwdN")],
}

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(EDITS),
                    choices=list(EDITS))
    ap.add_argument("--gap", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    for name in args.variants:
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
