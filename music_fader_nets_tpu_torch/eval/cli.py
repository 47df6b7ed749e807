"""The controllability evaluation entry point (counterpart of
`music_fader_nets_tpu/eval/cli.py` and the reference's `test_*_v2.py`
scripts, README.md:38-40):

    python -m music_fader_nets_tpu_torch.eval.cli gmm --samples 5

evaluates one of vanilla, glsr, gmm, singlevae, cvae, fader on the card
(`--device cpu` for the plain path on the CPU), with the params of
`--from-pt` or of the checkpoint the training CLI saved under
`--save-dir` (`_load_params`); with neither, a seeded random init, as the
JAX CLI does.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from music_fader_nets_tpu_torch import models, resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.eval.controllability import (
    ConditionControllabilityEvaluator,
    ControllabilityEvaluator,
    SingleVAEControllabilityEvaluator,
    latent_monotonicity,
    latent_stats,
)
from music_fader_nets_tpu_torch.train.cli import (
    MODEL_REGISTRY, build_argparser, config_from_args, load_yamaha,
)
from music_fader_nets_tpu_torch.utils.checkpoint import (
    check_params_like, load_pt_checkpoint, restore_checkpoint, tree_to,
)

# Eval workload sizes per model family, (epochs, samples per epoch)
# (reference test_vanilla_v2.py:154-155, test_gmm_v2.py:203-204,
# test_cvae_v2.py:316-326)
WORKLOADS = {
    "vanilla": (2, 100), "glsr": (2, 100),
    "gmm": (2, 20), "singlevae": (2, 20),
    "cvae": (10, 100), "fader": (10, 100),
}

# Yamaha dataset std normalizers the reference hard-codes for the
# condition-sweep evaluators (test_cvae_v2.py:120-121)
CVAE_R_STD = 0.16162585
CVAE_N_STD = 0.8861338


def _condition_stds(yam):
    """Density-std normalizers for the condition-sweep evaluators: the
    reference's constants of the real Yamaha corpus (test_cvae_v2.py:
    120-121), or, on the synthetic corpus, whose n_density std is ~0.55
    and not 0.886, the train split's own stds. Provenance is the loader's
    (`load_yamaha` stamps `source` on each split)."""
    if getattr(yam["train"], "source", "cache") != "synthetic":
        return CVAE_R_STD, CVAE_N_STD
    tr = yam["train"].arrays()
    return float(np.std(tr["r_density"])), float(np.std(tr["n_density"]))


def _load_params(kind: str, cfg: ModelConfig, args):
    """The family's params on the CPU: from `--from-pt` (a reference `.pt`
    state_dict), else from the checkpoint under `--save-dir` (the
    full-state or the params-only layout; which one is printed), else, when
    neither was asked for nor exists, a seeded random init with a warning.
    A checkpoint that was asked for and cannot be read (a missing
    `--from-pt` file, a truncated or corrupt file, an Orbax directory of
    the JAX package, another family's or width's params) raises: a random
    init in its place would be a silent wrong answer."""
    spec = MODEL_REGISTRY[kind]
    template = spec["init"](torch.Generator().manual_seed(args.seed), cfg)
    if args.from_pt:
        params = load_pt_checkpoint(args.from_pt)
        print(f"Loaded torch checkpoint {args.from_pt}")
    else:
        ckpt_dir = os.path.join(args.save_dir, spec["name"])
        if not os.path.isdir(ckpt_dir):
            print(f"WARNING: no checkpoint at {ckpt_dir}; evaluating "
                  "random init")
            return template
        print(f"Loading {ckpt_dir}")
        ck = restore_checkpoint(ckpt_dir)
        params = ck["params"]
        print("restored full-state checkpoint layout" if ck["layout"] ==
              "full" else "restored legacy params-only checkpoint layout")
    check_params_like(params, template)
    return params


def run_evaluation(kind: str, description: str, argv=None,
                   epochs: Optional[int] = None,
                   num_of_samples: Optional[int] = None) -> None:
    ap = build_argparser(description)
    ap.add_argument("--samples", type=int, default=None,
                    help="samples per eval epoch")
    ap.add_argument("--eval-epochs", type=int, default=None)
    ap.add_argument("--decode-steps", type=int, default=100)
    ap.add_argument("--is_cvae", action="store_true",
                    help="(fader entry only) evaluate the plain CVAE instead "
                         "- mirrors the reference's --is_cvae flag")
    ap.add_argument("--mean-z", action="store_true",
                    help="slide around the posterior MEAN instead of a "
                         "sampled z (the reference samples, "
                         "test_class.py:233-254; mean-z removes the sampling "
                         "noise from the consistency metric)")
    args = ap.parse_args(argv)
    if kind == "fader" and args.is_cvae:
        kind = "cvae"
    dev = resolve_device(args.device)
    cfg = config_from_args(kind, args)
    params = tree_to(_load_params(kind, cfg, args), dev)
    yam = load_yamaha(args, cfg)
    ep, ns = WORKLOADS[kind]
    ep = args.eval_epochs or epochs or ep
    ns = args.samples or num_of_samples or ns
    common = dict(epochs=ep, num_of_samples=ns,
                  decode_steps=args.decode_steps, seed=args.seed,
                  sample_z=not args.mean_z, device=dev)

    def draw(gen, mu, std):
        eps = torch.randn(mu.shape, generator=gen)
        return mu + std * eps.to(mu.device, mu.dtype)

    if kind in ("vanilla", "glsr", "gmm"):
        # models.reg_gmvae_* are the RegVAE's encode and decodes
        def encode_batched(batch, gen):
            (mu_r, std_r), (mu_n, std_n) = models.reg_vae_encode(
                params, None, tokens=batch["x"])
            return draw(gen, mu_r, std_r), draw(gen, mu_n, std_n)

        # slider ranges come from the TEST split's z extremes; the density
        # normalizers from the TRAIN split (reference test_vanilla_v2.py:
        # 148-150 evaluates on test_x_loader after run_through on train)
        stats = latent_stats(encode_batched, yam["train"].arrays(), cfg,
                             seed=args.seed, device=dev)
        stats_te = latent_stats(encode_batched, yam["test"].arrays(), cfg,
                                seed=args.seed, device=dev)
        print("latent stats (train):", stats)
        print("latent stats (test):", stats_te)
        for target, lo, hi in (("rhythm", stats_te["z_r_min"],
                                stats_te["z_r_max"]),
                               ("note", stats_te["z_n_min"],
                                stats_te["z_n_max"])):
            print(f"=== {target} fader ===")
            ev = ControllabilityEvaluator(
                params, cfg, models.reg_vae_encode,
                models.reg_vae_global_decode, target=target,
                decode_tokens=models.reg_vae_decode_tokens, **common)
            ev.evaluate(yam["test"].arrays(), lo, hi,
                        stats["r_std"], stats["n_std"])

    elif kind == "singlevae":
        def encode_batched(batch, gen):
            mu, std = models.single_vae_encode(params, None,
                                               tokens=batch["x"])
            z = draw(gen, mu, std)
            return z, z[:, 1:]          # dims 0/1 of the single latent

        stats = latent_stats(encode_batched, yam["train"].arrays(), cfg,
                             seed=args.seed, device=dev)
        stats_te = latent_stats(encode_batched, yam["test"].arrays(), cfg,
                                seed=args.seed, device=dev)
        print("latent stats (train):", stats)
        print("latent stats (test):", stats_te)

        # direct z-space monotonicity on encoder means
        # (reference test_singlevae_v2.py:311-330)
        def encode_means(batch, gen):
            mu, _ = models.single_vae_encode(params, None, tokens=batch["x"])
            return mu, mu[:, 1:]

        print("z-space monotonicity:",
              latent_monotonicity(encode_means, yam["test"].arrays(), cfg,
                                  device=dev))
        for target, lo, hi in (("rhythm", stats_te["z_r_min"],
                                stats_te["z_r_max"]),
                               ("note", stats_te["z_n_min"],
                                stats_te["z_n_max"])):
            print(f"=== {target} fader ===")
            ev = SingleVAEControllabilityEvaluator(
                params, cfg, models.single_vae_encode,
                models.single_vae_global_decode, target=target, **common)
            ev.evaluate(yam["test"].arrays(), lo, hi,
                        stats["r_std"], stats["n_std"])

    else:                                # cvae / fader: condition sweep
        encode = (models.cvae_encode if kind == "cvae"
                  else lambda p, x, rd, nd: models.fader_encode(p, x))
        decode = (models.cvae_global_decode if kind == "cvae"
                  else models.fader_global_decode)
        r_std, n_std = _condition_stds(yam)
        print(f"condition-sweep std normalizers: r_std={r_std} n_std={n_std}")
        for target in ("rhythm", "note"):
            print(f"=== {target} fader (condition sweep) ===")
            ev = ConditionControllabilityEvaluator(
                params, cfg, encode, decode, target=target, **common)
            # condition values sweep k/8 in [0, 1) (test_cvae_v2.py:37,74-78)
            ev.evaluate(yam["test"].arrays(), 0.0, 1.0, r_std, n_std)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m music_fader_nets_tpu_torch.eval.cli",
        description="Controllability evaluation of one model family; the "
                    "options after the family are run_evaluation's "
                    "(--help after a family lists them).")
    ap.add_argument("kind", choices=sorted(WORKLOADS))
    kind = ap.parse_args(argv[:1]).kind
    run_evaluation(kind, f"Controllability evaluation: {kind}", argv[1:])


if __name__ == "__main__":
    main()
