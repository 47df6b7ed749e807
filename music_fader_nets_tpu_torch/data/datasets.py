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

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays().items()}

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "x": self.data, "r": self.rhythm, "n": self.note, "c": self.chroma,
            "r_density": self.r_density, "n_density": self.n_density,
        }


def _is_ragged(a) -> bool:
    """True for the released VGMIDI format: a dtype=object array (or plain
    list) of per-song variable-length sequences (reference
    ptb_v2.py:375-377)."""
    if isinstance(a, np.ndarray):
        return a.dtype == object
    return isinstance(a, (list, tuple))


def _pad_rows(rows, insert_eos: bool = False, dtype=np.int32) -> np.ndarray:
    """Zero-pad variable-length rows to the longest row (reference
    ptb_v2.py:460,468-469). With insert_eos, first insert EOS (token 1)
    before each row's LAST element, the reference's `np.insert(k, -1, 1)`
    at ptb_v2.py:459; an empty row becomes a lone EOS."""
    rows = [np.asarray(r).ravel() for r in rows]
    if insert_eos:
        rows = [np.insert(r, -1, 1) if len(r) else np.array([1], dtype)
                for r in rows]
    T = max((len(r) for r in rows), default=0)
    out = np.zeros((len(rows), T), dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class VGMIDIDataset:
    """90/5/5 contiguous split, arousal binarized at 0 (reference
    ptb_v2.py:448,472-473). Ragged inputs (the released dtype=object
    arrays, or lists of variable-length sequences) get the reference's
    treatment (ptb_v2.py:459-470): EOS re-inserted before each token row's
    last element, rows zero-padded to the split's longest, densities over
    the unpadded tracks. Fixed-shape 2-D arrays (the synthetic corpus,
    which already carries EOS and padding) skip that."""

    def __init__(self, data, rhythm, note, chroma, arousal, valence,
                 mode="train"):
        if _is_ragged(data) or _is_ragged(rhythm) or _is_ragged(note):
            d_rows = _split(list(data), mode, 0.9, 0.95)
            r_rows = [np.asarray(k).ravel() for k in
                      _split(list(rhythm), mode, 0.9, 0.95)]
            n_rows = [np.asarray(k).ravel() for k in
                      _split(list(note), mode, 0.9, 0.95)]
            self.data = _pad_rows(d_rows, insert_eos=True)
            self.rhythm = _pad_rows(r_rows)
            self.note = _pad_rows(n_rows)
            self.r_density = np.array(
                [(k == 1).sum() / max(len(k), 1) for k in r_rows], np.float32)
            self.n_density = np.array(
                [k.sum() / max(len(k), 1) for k in n_rows], np.float32)
        else:
            self.data = _split(np.asarray(data), mode, 0.9,
                               0.95).astype(np.int32)
            self.rhythm = _split(np.asarray(rhythm), mode, 0.9,
                                 0.95).astype(np.int32)
            self.note = _split(np.asarray(note), mode, 0.9,
                               0.95).astype(np.int32)
            self.r_density = (self.rhythm == 1).mean(axis=-1).astype(
                np.float32)
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

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays().items()}

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "x": self.data, "r": self.rhythm, "n": self.note, "c": self.chroma,
            "a": self.arousal, "v": self.valence,
            "r_density": self.r_density, "n_density": self.n_density,
        }
