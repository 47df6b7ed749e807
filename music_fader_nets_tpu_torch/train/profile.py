"""The training families and random in-schema data, for the scripts that
drive a family's `Trainer` at full width (`chip_smoke.py`, the ablations,
the bf16 turns) and their tests.

Where a training step's time goes is read by the benchmark's traced run:
`python3 h100bench/run.py --workload <cell> --seed <n> --seconds 30
--trace 1`.
"""
from __future__ import annotations

import numpy as np

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import vae
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.train import objectives

# family: (init, objective, first step)
FAMILIES = {
    "gmvae": (init_reg_gmvae, objectives.gmm_loss, 0),
    "vanilla": (vae.init_reg_vae, objectives.vanilla_loss, 0),
    "glsr": (vae.init_reg_vae, objectives.glsr_loss, 21),
    "cvae": (vae.init_cvae, objectives.cvae_loss, 0),
    "fader": (vae.init_fader, objectives.fader_loss, 0),
    "singlevae": (vae.init_single_vae, objectives.singlevae_loss, 0),
}


def random_corpus(cfg: ModelConfig, n: int, seed: int,
                  supervised: bool = False):
    """In-schema corpus arrays from numpy, in the loaders' argument order
    (data, rhythm, note, chroma[, arousal, valence]): tokens in
    [0, roll_dims), rhythm ids in [0, rhythm_dims), note ids in
    [0, note_dims), chroma in [0, 1), arousal and valence in [-1, 1)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, cfg.roll_dims, (n, cfg.seq_len)),
           rng.integers(0, cfg.rhythm_dims, (n, cfg.attr_len)),
           rng.integers(0, cfg.note_dims, (n, cfg.attr_len)),
           rng.random((n, cfg.chroma_dims))]
    if supervised:
        out += [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)]
    return out
