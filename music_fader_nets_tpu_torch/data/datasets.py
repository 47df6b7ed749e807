"""Dataset views over corpus arrays (copy of
`music_fader_nets_tpu/data/datasets.py`; reference ptb_v2.py:400-489):
the same split fractions and density precomputation, vectorized, returning
whole-array views the batcher gathers from."""
from __future__ import annotations

from typing import Dict

import numpy as np


def _split(arr, mode: str, t_frac: float, v_frac: float):
    tlen, vlen = int(t_frac * len(arr)), int(v_frac * len(arr))
    if mode == "train":
        return arr[:tlen]
    if mode == "val":
        return arr[tlen:vlen]
    if mode == "test":
        return arr[vlen:]
    raise ValueError(mode)


class YamahaDataset:
    """80/10/10 contiguous split (reference ptb_v2.py:410); r_density =
    fraction of rhythm steps == 1, n_density = mean note count
    (ptb_v2.py:421-422)."""

    def __init__(self, data, rhythm, note, chroma, mode="train"):
        self.data = _split(np.asarray(data), mode, 0.8, 0.9).astype(np.int32)
        self.rhythm = _split(np.asarray(rhythm), mode, 0.8,
                             0.9).astype(np.int32)
        self.note = _split(np.asarray(note), mode, 0.8, 0.9).astype(np.int32)
        self.chroma = _split(np.asarray(chroma), mode, 0.8,
                             0.9).astype(np.float32)
        self.r_density = (self.rhythm == 1).mean(axis=-1).astype(np.float32)
        self.n_density = self.note.mean(axis=-1).astype(np.float32)

    def __len__(self):
        return len(self.data)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "x": self.data, "r": self.rhythm, "n": self.note, "c": self.chroma,
            "r_density": self.r_density, "n_density": self.n_density,
        }


def _is_ragged(a) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == object
    return isinstance(a, (list, tuple))


class VGMIDIDataset:
    """90/5/5 contiguous split, arousal binarized at 0 (reference
    ptb_v2.py:448,472-473). Fixed-shape 2-D arrays only (what the synthetic
    corpus gives); the released ragged arrays, with their EOS re-insert and
    re-pad, wait for the corpus loaders (ROADMAP.md)."""

    def __init__(self, data, rhythm, note, chroma, arousal, valence,
                 mode="train"):
        if _is_ragged(data) or _is_ragged(rhythm) or _is_ragged(note):
            raise NotImplementedError(
                "ragged VGMIDI arrays are not ported yet; pass fixed-shape "
                "2-D arrays")
        self.data = _split(np.asarray(data), mode, 0.9, 0.95).astype(np.int32)
        self.rhythm = _split(np.asarray(rhythm), mode, 0.9,
                             0.95).astype(np.int32)
        self.note = _split(np.asarray(note), mode, 0.9, 0.95).astype(np.int32)
        self.r_density = (self.rhythm == 1).mean(axis=-1).astype(np.float32)
        self.n_density = self.note.mean(axis=-1).astype(np.float32)
        self.chroma = _split(np.asarray(chroma), mode, 0.9,
                             0.95).astype(np.float32)
        arousal = _split(np.asarray(arousal), mode, 0.9,
                         0.95).astype(np.float32)
        self.valence = _split(np.asarray(valence), mode, 0.9,
                              0.95).astype(np.float32)
        self.arousal = (arousal >= 0).astype(np.int32)

    def __len__(self):
        return len(self.data)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "x": self.data, "r": self.rhythm, "n": self.note, "c": self.chroma,
            "a": self.arousal, "v": self.valence,
            "r_density": self.r_density, "n_density": self.n_density,
        }
