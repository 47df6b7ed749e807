"""Musical attribute extraction from a pianoroll segment.

Equivalent of the reference's `get_music_attributes`
(reference ptb_v2.py:132-156): per-step 3-class rhythm track, note density
(#sounding pitches), 12-bin chroma sums, and mean velocity — all derived
through the event codec's pitch-list view for identical semantics.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from music_fader_nets_tpu_torch.tokenizer.event_codec import (
    encode_pianoroll,
)


def get_music_attributes(pr: np.ndarray, beat: int = 24
                         ) -> Tuple[list, list, np.ndarray, np.ndarray, np.ndarray]:
    """pr (T, 128) velocity roll -> (events, rhythm, note_density, chroma,
    velocity). `beat` kept for signature parity; the roll is already
    quantized."""
    events, _, _, rhythm = encode_pianoroll(pr)

    pr = np.asarray(pr)
    mask = pr > 0
    note_density = mask.sum(axis=1)

    chroma = np.zeros((pr.shape[0], 12))
    for note in range(12):
        chroma[:, note] = np.sum(pr[:, note::12], axis=1)

    counts = np.maximum(note_density, 1)
    velocity = (pr.sum(axis=1, dtype=np.int64) // counts).astype(int)
    velocity = np.where(note_density > 0, velocity, 0)

    return events, rhythm, note_density, chroma, velocity


def rhythm_density(rhythm) -> float:
    """Fraction of steps that are onsets (reference ptb_v2.py:421)."""
    rhythm = np.asarray(rhythm)
    return float((rhythm == 1).sum() / len(rhythm))


def note_density_mean(note_density) -> float:
    """Mean per-step note count (reference ptb_v2.py:422)."""
    nd = np.asarray(note_density)
    return float(nd.sum() / len(nd))
