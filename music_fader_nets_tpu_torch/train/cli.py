"""The training entry point and what the evaluation, serving and transfer
entry points share with it (counterpart of
`music_fader_nets_tpu/train/cli.py`): the model registry, the argument
parser, the config and corpus loaders, the trainer with resume and the
checkpoint helpers, `run_training`, and each family's forward for the
reconstruction report.

    python -m music_fader_nets_tpu_torch.train.cli gmm --epochs 2

trains one of vanilla, glsr, gmm, cvae, fader, singlevae (gmm on the dual
corpus: supervised VGMIDI epochs at batch 32, then Yamaha) on the card, or
with `--device cpu` on the CPU's plain path. Each epoch it checkpoints to
`<save-dir>/<name>/state.pt` (params, Adam state, step and epoch), and at
the end to `<save-dir>/<name>_<timestamp>/`; run again with a larger
`--epochs`, it resumes after the saved epoch. `--from-pt` starts from a
reference `.pt` state_dict instead.

`--mesh DxM` trains on a D x M mesh of D * M ranks, one process each,
started by torchrun, which gives the process group its rank, world size
and address (`parallel/launch.py::init_from_env`): data-parallel over D
ranks, and tensor-parallel over M (each rank stores, and steps Adam on,
its 1/M slice of the GRU weights; `train/trainer.py`):

    torchrun --nproc_per_node 2 -m music_fader_nets_tpu_torch.train.cli \
        gmm --mesh 2x1          # or --mesh 1x2

Each rank trains on the shard of every split of its data index
(`data/loader.py::shard_arrays_for_process` over D; the M ranks of a
model group share their rows) at `--batch-size / D` rows of each global
batch, on `cuda:LOCAL_RANK` over NCCL, or over gloo on the CPU
(`--device cpu`) or when the ranks share a card; rank 0 alone logs,
checkpoints and reports, and a resumed run resumes on every rank. The
checkpoint holds the whole params and Adam state whatever the mesh. The
JAX CLI's
`--pallas-gru` and `--platform` have no meaning here: the port runs its
kernels on CUDA always, or, with `--device cpu`, their plain versions on
the CPU.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
from datetime import datetime
from typing import Callable, Dict, Tuple

import torch.distributed as dist
import torch.nn.functional as F

from music_fader_nets_tpu_torch import models, resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig, load_config
from music_fader_nets_tpu_torch.data.corpus import (
    get_classic_piano, get_vgmidi,
)
from music_fader_nets_tpu_torch.data.datasets import (
    VGMIDIDataset, YamahaDataset,
)
from music_fader_nets_tpu_torch.data.loader import shard_arrays_for_process
from music_fader_nets_tpu_torch.eval.reconstruction import (
    reconstruction_report,
)
from music_fader_nets_tpu_torch.parallel import mesh as mesh_lib
from music_fader_nets_tpu_torch.parallel.launch import init_from_env
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.trainer import Trainer, TrainState
from music_fader_nets_tpu_torch.utils.checkpoint import (
    load_pt_checkpoint, restore_checkpoint, save_checkpoint,
)
from music_fader_nets_tpu_torch.utils.logging import MetricsLogger

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
    ap.add_argument("--mesh", default=None,
                    help="mesh shape as DATAxMODEL, e.g. 2x1 or 1x2: "
                         "data-parallel over DATA and tensor-parallel over "
                         "MODEL ranks, DATA * MODEL of them started by "
                         "torchrun (default: one process on one device)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to run: cuda (default; an error without a "
                         "card) with the kernels, or cpu with their plain "
                         "versions")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute dtype: float32 (default) or bfloat16 "
                         "mixed precision (the five objectives other than "
                         "GLSR run their forward in bf16; master weights, "
                         "Adam state and checkpoints stay float32)")
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
                    help="initialize from a reference .pt state_dict "
                         "(tensors; the JAX package's "
                         "params_to_torch_state_dict exports one); a file "
                         "that cannot be read raises")
    ap.add_argument("--log-dir", default="log",
                    help="where the per-epoch metrics JSONL is written")
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


def make_mesh(args):
    """The `--mesh DATAxMODEL` of this rank (joining the torchrun process
    group), or None."""
    if not getattr(args, "mesh", None):
        return None
    nd, nm = (int(x) for x in args.mesh.lower().split("x"))
    return mesh_lib.make_mesh(nd, nm, devices=init_from_env(args.device))


def make_trainer(kind: str, cfg: ModelConfig, args) -> Trainer:
    """The family's Trainer on `--device` (on `--mesh`, this rank's device;
    the params broadcast from rank 0, each rank keeping its slices of the
    sharded leaves), from `--from-pt` if given, else
    resumed from `<save-dir>/<name>/` if that holds a checkpoint: the full
    state (params, Adam state, step; the noise stream resumes at the step
    and the epochs after the saved one), or a params-only file with a fresh
    optimizer at step 0. The reference saves only the state_dict, so its
    resume restarts the KL anneal at step 0 (SURVEY.md §5); keeping the
    step is the JAX package's deliberate fix. A checkpoint that cannot be
    read raises; it is never replaced by a random init. On a mesh every
    rank reads the checkpoint."""
    spec = MODEL_REGISTRY[kind]
    mesh = make_mesh(args)
    trainer = Trainer(cfg, spec["init"], spec["losses"], seed=args.seed,
                      device=None if mesh else resolve_device(args.device),
                      mesh=mesh)
    say = _lead_print(trainer)
    ckpt_dir = os.path.join(args.save_dir, spec["name"])
    if args.from_pt:
        trainer.load_state(TrainState(load_pt_checkpoint(args.from_pt),
                                      None, 0))
        say(f"Loaded torch checkpoint {args.from_pt}")
    elif os.path.isdir(ckpt_dir):
        ck = restore_checkpoint(ckpt_dir)
        trainer.load_state(TrainState(ck["params"], ck["opt_state"],
                                      ck["step"]))
        trainer.epoch = ck["epoch"]
        if ck["layout"] == "full":
            say(f"Loading {ckpt_dir} (resumed at step {trainer.step}, "
                f"after epoch {trainer.epoch})")
        else:
            say(f"Loading {ckpt_dir} (params only; optimizer reset)")
    else:
        say(f"Save path: {ckpt_dir}")
    return trainer


def _lead_print(trainer: Trainer) -> Callable:
    """`print` on the rank that logs (rank 0, or the only process), a
    no-op on the others."""
    return print if trainer.is_lead else (lambda *a, **k: None)


def _save(path: str, state: TrainState, epoch: int) -> None:
    save_checkpoint(path, {"params": state.params,
                           "opt_state": state.opt_state,
                           "step": state.step, "epoch": epoch})


def checkpoint_fn(kind: str, args) -> Callable[[TrainState, int], None]:
    """save(state, epoch): the full state to `<save-dir>/<name>/`."""
    ckpt_dir = os.path.join(args.save_dir, MODEL_REGISTRY[kind]["name"])

    def save(state: TrainState, epoch: int):
        print("Saving model...")
        _save(ckpt_dir, state, epoch)

    return save


def save_timestamped(kind: str, args, state: TrainState, epoch: int) -> str:
    """The full state to `<save-dir>/<name>_<ISO time>/`; returns the
    directory."""
    stamp = datetime.now().isoformat().replace(":", "-")
    path = os.path.join(args.save_dir,
                        f"{MODEL_REGISTRY[kind]['name']}_{stamp}")
    _save(path, state, epoch)
    print(f"Model saved as {path}!")
    return path


def _terms(m: Dict[str, float]) -> str:
    return " ".join(f"{k}: {v:.4f}" for k, v in sorted(m.items()))


def run_training(kind: str, description: str, dual_corpus: bool = False,
                 argv=None) -> Trainer:
    """The shared trainer main() (reference trainer.py:199-380): corpus ->
    epochs of training and validation, a checkpoint after each, a
    timestamped one at the end -> the reconstruction report on the Yamaha
    train and test splits (and, for the dual-corpus GM-VAE, the VGMIDI
    ones, with the mixture posterior's arousal accuracy). Returns the
    trainer. On `--mesh` each rank trains on the shard of each split of
    its data index, and rank 0 alone logs, checkpoints and reports (every
    rank takes the final state: a collective under a model axis)."""
    args = build_argparser(description).parse_args(argv)
    cfg = config_from_args(kind, args)
    trainer = make_trainer(kind, cfg, args)
    say = _lead_print(trainer)
    ck = checkpoint_fn(kind, args)
    logger = (MetricsLogger(MODEL_REGISTRY[kind]["name"], args.log_dir)
              if trainer.is_lead else None)
    yam = load_yamaha(args, cfg)
    say("Train / Validation / Test")
    say(len(yam["train"]), len(yam["val"]), len(yam["test"]))
    mesh = trainer.mesh
    if mesh is not None:
        say(f"mesh {mesh.n_data}x{mesh.n_model}: each rank keeps "
            f"1/{mesh.n_data} of each split and 1/{mesh.n_model} of the "
            f"GRU weights' Adam state")

    def shard(ds):
        if mesh is None:
            return ds.arrays()
        return shard_arrays_for_process(ds.arrays(), mesh.data_index,
                                        mesh.n_data)

    vgm = None
    try:
        if not dual_corpus:
            trainer.fit(shard(yam["train"]), shard(yam["val"]),
                        n_epochs=cfg.n_epochs, checkpoint_fn=ck,
                        metrics_logger=logger,
                        start_epoch=trainer.epoch + 1)
        else:
            vgm = load_vgmidi(args)
            say("VGMIDI: Train / Validation / Test")
            say(len(vgm["train"]), len(vgm["val"]), len(vgm["test"]))
            for epoch in range(trainer.epoch + 1, cfg.n_epochs + 1):
                say(f"Epoch {epoch} / {cfg.n_epochs}")
                # supervised VGMIDI phase (batch 32, reference
                # trainer_gmm.py:88), then the unsupervised Yamaha phase
                sup = trainer.run_epoch(shard(vgm["train"]),
                                        variant="supervised", seed=epoch,
                                        batch_size=32, compiled=True)
                sup_val = trainer.run_epoch(shard(vgm["val"]),
                                            variant="supervised",
                                            train=False, batch_size=32,
                                            shuffle=False, compiled=True)
                uns = trainer.run_epoch(shard(yam["train"]), seed=epoch,
                                        compiled=True)
                uns_val = trainer.run_epoch(shard(yam["val"]),
                                            train=False, shuffle=False,
                                            compiled=True)
                say("vgmidi train - " + _terms(sup))
                say("vgmidi val   - " + _terms(sup_val))
                say("yamaha train - " + _terms(uns))
                say("yamaha val   - " + _terms(uns_val))
                for split, m in (("vgmidi_train", sup),
                                 ("vgmidi_val", sup_val),
                                 ("yamaha_train", uns),
                                 ("yamaha_val", uns_val)):
                    if logger is not None:
                        logger.log(m, step=trainer._host_step, epoch=epoch,
                                   split=split)
                trainer.epoch = epoch
                trainer.checkpoint(ck, epoch)
    finally:
        if logger is not None:
            logger.close()
    state = trainer.state
    if not trainer.is_lead:
        return trainer
    save_timestamped(kind, args, state, trainer.epoch)

    # evaluation phase (reference trainer.py:280-376); for the dual-corpus
    # GM-VAE also the VGMIDI splits, with the arousal-classification
    # accuracy of the mixture posterior (reference trainer_gmm.py:570-605)
    fwd, has_sub, draw = _forward_for(kind, cfg)
    params = state.params
    reports = [(f"[{split}] ", yam[split], cfg.batch_size)
               for split in ("train", "test")]
    if vgm is not None:
        reports += [(f"[vgmidi {split}] ", vgm[split], 32)
                    for split in ("train", "test") if len(vgm[split])]
    for label, ds, bs in reports:
        rep = reconstruction_report(params, fwd, ds.arrays(), cfg, draw=draw,
                                    batch_size=min(bs, len(ds)),
                                    seed=args.seed, has_subdecoders=has_sub,
                                    device=trainer.device)
        say(label + _terms(rep))
    return trainer


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


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m music_fader_nets_tpu_torch.train.cli",
        description="Train one model family; the options after the family "
                    "are run_training's (--help after a family lists "
                    "them). gmm trains on the dual corpus (VGMIDI "
                    "supervised + Yamaha), as trainer_gmm.py does.")
    ap.add_argument("kind", choices=sorted(MODEL_REGISTRY))
    kind = ap.parse_args(argv[:1]).kind
    try:
        run_training(kind, f"Train {kind}", dual_corpus=kind == "gmm",
                     argv=argv[1:])
    finally:
        if dist.is_initialized():       # joined for --mesh
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
