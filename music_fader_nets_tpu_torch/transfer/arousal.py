"""Arousal transfer's latent shift (counterpart of
`music_fader_nets_tpu/transfer/arousal.py::compute_shift_vectors`): the
directions between the GM-VAE component means along which serving moves z.
The MIDI-producing `arousal_transfer` waits for the tokenizer's port."""
from __future__ import annotations

from typing import Dict

import numpy as np


def compute_shift_vectors(params) -> Dict[str, np.ndarray]:
    """Shift directions from the mixture mean tables (notebook cell 11:
    `r_low_to_high = mu_r_lookup(1) - mu_r_lookup(0)` and the note-stream
    analog), as float32 numpy vectors."""
    mu_r = params["mu_r_lookup"].detach().cpu().numpy()
    mu_n = params["mu_n_lookup"].detach().cpu().numpy()
    return {
        "r_low_to_high": mu_r[1] - mu_r[0],
        "r_high_to_low": mu_r[0] - mu_r[1],
        "n_low_to_high": mu_n[1] - mu_n[0],
        "n_high_to_low": mu_n[0] - mu_n[1],
    }
