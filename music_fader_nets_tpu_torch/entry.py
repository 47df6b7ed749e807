"""The port's graft entry point (counterpart of the root
`__graft_entry__.entry()`, which runs the JAX package).

`entry(device=None)` returns `(fn, example_args)`: `fn(params, eps, batch,
step) -> (loss, metrics)` is the flagship model's (the GM-VAE's) forward
and its `gmm_loss`, and `example_args` are seeded full-width inputs for
one call on one card:

    from music_fader_nets_tpu_torch.entry import entry
    fn, args = entry()                 # device="cpu" for the plain path
    loss, metrics = fn(*args)

The params are the fast (kernel) layout the `Trainer` trains
(`models/fast.py::split_fast` of `init_reg_gmvae` from a
`torch.Generator` seeded 0), so on CUDA the forward runs the kernels of
the training path: the token encoder, the class-embedded sub-decoders and
the decoder with its cross-entropy head. `eps` is the objective's noise,
drawn by `train/objectives.py::draw_noise` from a generator seeded 1.

`dryrun_multichip(n, device=None)` is the counterpart of the root
`__graft_entry__.dryrun_multichip`: one unsupervised and one supervised
GM-VAE training step at its tiny shapes on n ranks, on an (n/2) x 2 mesh
(data x model) for even n, then on the n x 1 mesh: on the cards (NCCL
with a card a rank, else gloo with the ranks sharing card 0) unless
`device="cpu"`, which runs n gloo ranks on the CPU as the JAX dryrun does.
"""
from __future__ import annotations

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig

BATCH = 8


def example_batch(cfg: ModelConfig, B: int, rng=0) -> dict:
    """The root `__graft_entry__._example_batch` as numpy arrays (the same
    draws from `np.random.default_rng(rng)`)."""
    r = np.random.default_rng(rng)
    return {
        "x": r.integers(0, cfg.roll_dims, (B, cfg.seq_len)).astype(np.int32),
        "r": r.integers(0, cfg.rhythm_dims, (B, cfg.attr_len)).astype(
            np.int32),
        "n": r.integers(0, cfg.note_dims, (B, cfg.attr_len)).astype(np.int32),
        "c": r.random((B, cfg.chroma_dims)).astype(np.float32),
        "a": r.integers(0, 2, (B,)).astype(np.int32),
        "r_density": r.random(B).astype(np.float32),
        "n_density": r.random(B).astype(np.float32),
    }


def entry(device=None):
    """(fn, (params, eps, batch, step)): the GM-VAE forward + `gmm_loss` at
    full width, B=8, on CUDA unless `device="cpu"`."""
    from music_fader_nets_tpu_torch.models.fast import split_fast
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.train.objectives import (
        draw_noise, gmm_loss,
    )
    from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

    dev = resolve_device(device)
    cfg = ModelConfig(num_clusters=2, seq_len=100, attr_len=16)
    params = tree_to(split_fast(
        init_reg_gmvae(torch.Generator().manual_seed(0), cfg))[0], dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in example_batch(cfg, BATCH).items()}
    eps = tuple(e.to(dev) for e in draw_noise(
        gmm_loss, torch.Generator().manual_seed(1), BATCH, cfg))
    step = 0

    def fn(params, eps, batch, step):
        return gmm_loss(params, eps, batch, step, cfg)

    return fn, (params, eps, batch, step)


def _dryrun_rank(n: int, device) -> dict:
    """One rank of `dryrun_multichip`: on JAX's (n/2) x 2 mesh for even n,
    then on the n x 1 mesh, one step of each GM-VAE branch on its data
    index's shard of a batch of 2 * n_data rows (the JAX dryrun's); each
    mesh's global losses and training path."""
    import functools

    from music_fader_nets_tpu_torch.data.loader import (
        shard_arrays_for_process,
    )
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.parallel.mesh import make_mesh
    from music_fader_nets_tpu_torch.train.objectives import gmm_loss
    from music_fader_nets_tpu_torch.train.trainer import Trainer

    runs = []
    meshes = ([(n // 2, 2)] if n % 2 == 0 else []) + [(n, 1)]
    for n_data, n_model in meshes:
        cfg = ModelConfig(hidden_dims=64, z_dims=16, num_clusters=2,
                          seq_len=24, attr_len=8, batch_size=2 * n_data)
        mesh = make_mesh(n_data, n_model, devices=device)
        trainer = Trainer(cfg, init_reg_gmvae, {
            "default": gmm_loss,
            "supervised": functools.partial(gmm_loss, is_supervised=True)},
            mesh=mesh)
        shard = shard_arrays_for_process(example_batch(cfg, cfg.batch_size),
                                         mesh.data_index, n_data)
        losses = {variant: trainer.run_epoch(shard, variant,
                                             shuffle=False)["loss"]
                  for variant in ("default", "supervised")}
        runs.append({"mesh": dict(mesh.shape), "losses": losses,
                     "train_path": trainer.train_path})
    return {"meshes": runs, "device": str(trainer.device)}


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One unsupervised and one supervised GM-VAE training step (H=64,
    z=16, T=24, attr_len=8, B=2 n_data) on n ranks placed by
    `parallel.launch.placement(device)` (CUDA unless `device="cpu"`): on
    the (n/2) x 2 mesh for even n, as the JAX dryrun, then on the n x 1
    mesh. Raises unless on each mesh every rank's losses are finite and
    equal; prints `dryrun_multichip ok: mesh=...` with the losses, a line
    a mesh, and returns each rank's meshes (shape, losses, training path)
    and device."""
    from music_fader_nets_tpu_torch.parallel.launch import run_ranks

    ranks = run_ranks(_dryrun_rank, n_devices, args=(n_devices, device),
                      device=device, timeout=300.0)
    for i, first in enumerate(ranks[0]["meshes"]):
        losses = first["losses"]
        if not all(np.isfinite(v) for v in losses.values()) or any(
                r["meshes"][i]["losses"] != losses for r in ranks):
            raise RuntimeError(f"dryrun_multichip: losses by rank {ranks}")
        print(f"dryrun_multichip ok: mesh={first['mesh']} "
              f"device={ranks[0]['device']} "
              f"unsup_loss={losses['default']:.4f} "
              f"sup_loss={losses['supervised']:.4f}")
    return ranks


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", float(fn(*args)[0]))
