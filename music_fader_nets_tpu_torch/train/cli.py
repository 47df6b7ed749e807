"""What the evaluation entry points share with the trainers' (counterpart
of `music_fader_nets_tpu/train/cli.py`): the model registry, the argument
parser, the config and corpus loaders, and each family's forward for the
reconstruction report. `run_training`, `make_trainer` and the checkpoint
helpers wait for the checkpoint slice (ROADMAP.md).

The JAX CLI's `--mesh`, `--pallas-gru` and `--platform` have no meaning
here: the port runs on one CUDA device with its kernels always on, or,
with `--device cpu`, on the CPU with their plain versions.
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Callable, Dict, Tuple

import torch.nn.functional as F

from music_fader_nets_tpu_torch import models
from music_fader_nets_tpu_torch.config import ModelConfig, load_config
from music_fader_nets_tpu_torch.data.corpus import (
    get_classic_piano, get_vgmidi,
)
from music_fader_nets_tpu_torch.data.datasets import (
    VGMIDIDataset, YamahaDataset,
)
from music_fader_nets_tpu_torch.train import objectives

MODEL_REGISTRY: Dict[str, Dict] = {
    "vanilla": dict(init=models.init_reg_vae,
                    losses={"default": objectives.vanilla_loss},
                    config="configs/model_config_v2.json",
                    name="music_attr_vae_reg_vanilla"),
    "glsr": dict(init=models.init_reg_vae,
                 losses={"default": objectives.glsr_loss},
                 config="configs/model_config_v2.json",
                 name="music_attr_vae_reg_glsr"),
    "gmm": dict(init=models.init_reg_gmvae,
                losses={"default": objectives.gmm_loss,
                        "supervised": functools.partial(
                            objectives.gmm_loss, is_supervised=True)},
                config="configs/gmm_model_config.json",
                name="music_attr_vae_reg_gmm"),
    "cvae": dict(init=models.init_cvae,
                 losses={"default": objectives.cvae_loss},
                 config="configs/model_config_v2.json",
                 name="music_attr_cvae"),
    "fader": dict(init=models.init_fader,
                  losses={"default": objectives.fader_loss},
                  config="configs/model_config_v2.json",
                  name="music_attr_fader"),
    "singlevae": dict(init=models.init_single_vae,
                      losses={"default": objectives.singlevae_loss},
                      config="configs/model_config_v2.json",
                      name="music_attr_vae_singlevae"),
}


def build_argparser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", default=None, help="JSON config path")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--save-dir", default="params")
    ap.add_argument("--data-dir", default=None,
                    help="corpus cache dir (reference data/values_v3 schema)")
    ap.add_argument("--midi-dirs", nargs="*", default=None,
                    help="rebuild corpus from these MIDI directories")
    ap.add_argument("--vgmidi-dir", default=None,
                    help="VGMIDI released-arrays dir (song_tokens.npy etc., "
                         "reference data/filtered_songs_disambiguate); "
                         "ragged object arrays are handled as the reference "
                         "does (EOS re-insert + pad, ptb_v2.py:459-470)")
    ap.add_argument("--synthetic-size", type=int, default=2048,
                    help="synthetic corpus size when no cache/MIDI exists")
    ap.add_argument("--data-type", default="short", choices=["short", "long"],
                    help="corpus variant: short = 4 beats/<=100 tokens, "
                         "long = 16 beats/<=250 tokens (ptb_v2.py:301-303)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to run: cuda (default; an error without a "
                         "card) with the kernels, or cpu with their plain "
                         "versions")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute dtype: float32; bfloat16 is not ported "
                         "and raises")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kl-warmup", type=int, default=None,
                    help="replace the reference KL anneal with a linear "
                         "0->beta warmup over N steps (the reference "
                         "schedule applies NO KL before step 10000, so "
                         "short runs train with beta=0 throughout)")
    ap.add_argument("--free-bits", type=float, default=None,
                    help="floor each latent dim's KL at this many nats "
                         "before averaging (Kingma et al. free bits); "
                         "0/unset = reference behavior")
    ap.add_argument("--fixed-quirks", action="store_true",
                    help="disable faithful replication of reference quirks "
                         "(negative-beta window, time-axis sub-decoder "
                         "softmax, GLSR batch-0 bug)")
    ap.add_argument("--from-pt", default=None,
                    help="initialize from a reference .pt state_dict (not "
                         "ported yet: raises)")
    return ap


def config_from_args(kind: str, args) -> ModelConfig:
    spec = MODEL_REGISTRY[kind]
    path = args.config or (spec["config"]
                           if os.path.exists(spec["config"]) else None)
    overrides = {}
    if args.epochs is not None:
        overrides["n_epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if getattr(args, "dtype", None):
        overrides["dtype"] = args.dtype
    if getattr(args, "data_type", "short") == "long":
        overrides.update(seq_len=250, attr_len=64)
    if args.fixed_quirks:
        overrides.update(faithful_negative_beta=False,
                         faithful_subdecoder_softmax_axis=False,
                         faithful_glsr_batch0=False)
    if getattr(args, "kl_warmup", None) is not None:
        overrides["kl_warmup_steps"] = args.kl_warmup
    if getattr(args, "free_bits", None) is not None:
        overrides["free_bits"] = args.free_bits
    return load_config(path, **overrides)


def load_yamaha(args, cfg: ModelConfig):
    *data, source = get_classic_piano(
        data_type=getattr(args, "data_type", "short"),
        cache_dir=args.data_dir,
        midi_dirs=args.midi_dirs,
        n_synthetic=args.synthetic_size,
        return_source=True)
    splits = {mode: YamahaDataset(*data, mode=mode)
              for mode in ("train", "val", "test")}
    for ds in splits.values():
        # corpus provenance ("cache" / "midi" / "synthetic"), read by
        # eval/cli.py::_condition_stds
        ds.source = source
    return splits


def load_vgmidi(args):
    d, r, n, a, v, c = get_vgmidi(
        vgmidi_dir=getattr(args, "vgmidi_dir", None))
    return {mode: VGMIDIDataset(d, r, n, c, a, v, mode=mode)
            for mode in ("train", "val", "test")}


def _forward_for(kind: str, cfg: ModelConfig
                 ) -> Tuple[Callable, bool, Callable]:
    """(forward, has_subdecoders, draw) of a family for the reconstruction
    report: forward(params, noise, batch) is its training forward over
    one-hots of the batch's device tensors (teacher-forced, no token ids:
    the generic stacked-GRU route, as the JAX report takes), and
    draw(gen, B) the noise tuple that forward takes."""
    draw = functools.partial(
        objectives.draw_noise,
        MODEL_REGISTRY[kind]["losses"]["default"], cfg=cfg)

    def one_hot(ids, n):
        return F.one_hot(ids.long(), n).float()

    def disentangled(fwd_fn):
        def f(params, noise, batch):
            return fwd_fn(params, noise[0], noise[1],
                          one_hot(batch["x"], cfg.roll_dims),
                          one_hot(batch["r"], cfg.rhythm_dims),
                          one_hot(batch["n"], cfg.note_dims), batch["c"],
                          cfg)
        return f

    if kind in ("vanilla", "glsr"):
        return disentangled(models.reg_vae_forward), True, draw
    if kind == "gmm":
        return disentangled(models.reg_gmvae_forward), True, draw

    def conditioned(fwd_fn):
        def f(params, noise, batch):
            return fwd_fn(params, *noise, one_hot(batch["x"], cfg.roll_dims),
                          batch["c"], batch["r_density"][:, None],
                          batch["n_density"][:, None], cfg)
        return f

    if kind in ("cvae", "fader"):
        return conditioned(models.cvae_forward if kind == "cvae"
                           else models.fader_forward), False, draw

    def single(params, noise, batch):
        return models.single_vae_forward(
            params, noise[0], one_hot(batch["x"], cfg.roll_dims), batch["c"],
            cfg)

    return single, False, draw
