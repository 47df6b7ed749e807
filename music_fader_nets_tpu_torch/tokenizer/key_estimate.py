"""Krumhansl-Schmuckler key estimation — music21-free.

Replicates the semantics of the reference's `get_harmony_vector`
(reference ptb_v2.py:95-129): a 24-dim vector (12 major then 12 minor keys,
index = pitch class of the tonic, minor offset +12) that is either one-hot
at the winning key or filled with each candidate key's correlation
coefficient with values below 0.1 zeroed.

The correlation is the Pearson r between the duration-weighted pitch-class
distribution and the rotated Krumhansl-Kessler probe-tone profiles (the
classic K-S algorithm; music21's default analyzer uses the same family of
profiles, so winners agree on clearly tonal material).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote

# Krumhansl & Kessler (1982) probe-tone ratings
MAJOR_PROFILE = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
MINOR_PROFILE = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def key_correlations(pc_dist: np.ndarray) -> np.ndarray:
    """(24,) Pearson correlations: entries 0-11 major keys C..B,
    12-23 minor keys C..B."""
    out = np.zeros(24)
    for tonic in range(12):
        out[tonic] = _pearson(pc_dist, np.roll(MAJOR_PROFILE, tonic))
        out[12 + tonic] = _pearson(pc_dist, np.roll(MINOR_PROFILE, tonic))
    return out


def pitch_class_distribution(notes: List[MidiNote]) -> np.ndarray:
    """Duration-weighted pitch-class histogram."""
    pc = np.zeros(12)
    for n in notes:
        pc[n.pitch % 12] += max(n.end - n.start, 0.0)
    return pc


def harmony_vector_from_chroma(pc_dist: np.ndarray,
                               is_one_hot: bool = False,
                               threshold: float = 0.1) -> Optional[np.ndarray]:
    """24-dim key vector with the reference's output convention
    (ptb_v2.py:108-124): one-hot at the winner, or all candidates'
    correlation coefficients with sub-threshold values zeroed."""
    if pc_dist.sum() <= 0:
        return None
    corr = key_correlations(pc_dist)
    res = np.zeros(24)
    if is_one_hot:
        res[int(np.argmax(corr))] = 1.0
    else:
        res = corr.copy()
        res[res < threshold] = 0.0
        if np.count_nonzero(res) == 0:
            res[int(np.argmax(corr))] = max(corr.max(), threshold)
    return res


def harmony_vector_from_notes(notes: List[MidiNote],
                              is_one_hot: bool = False) -> Optional[np.ndarray]:
    return harmony_vector_from_chroma(pitch_class_distribution(notes),
                                      is_one_hot)


def harmony_vector_from_pianoroll(pr: np.ndarray,
                                  is_one_hot: bool = False) -> Optional[np.ndarray]:
    pc = np.zeros(12)
    for note in range(12):
        pc[note] = pr[:, note::12].astype(float).sum()
    return harmony_vector_from_chroma(pc, is_one_hot)
