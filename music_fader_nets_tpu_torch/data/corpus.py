"""Corpus loaders with the reference's `.npy` cache schema (own copy of
`music_fader_nets_tpu/data/corpus.py`).

`get_classic_piano` mirrors reference ptb_v2.py:276-368: on cache hit it
loads `data/values_v3/{data,rhythm,note_density,chroma}.npy` and applies the
chroma sanitization (keep top-3 bins, drop all-zero rows,
ptb_v2.py:349-363); on cache miss it either rebuilds from MIDI via the
tokenizer (when a MIDI directory is supplied) or generates the
synthetic corpus so the pipeline is always runnable.

`get_vgmidi` mirrors ptb_v2.py:371-397 (released `.npy` arrays + lazily
cached chroma).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from music_fader_nets_tpu_torch.data import synthetic

CACHE_DIR = os.environ.get("FADERNETS_DATA_DIR", "data/values_v3")
VGMIDI_DIR = os.environ.get("FADERNETS_VGMIDI_DIR",
                            "data/filtered_songs_disambiguate")


def _sanitize_chroma(data, rhythm, note, chroma):
    """Keep each row's top-3 chroma bins; drop rows with all-zero chroma
    (reference ptb_v2.py:349-363)."""
    chroma = np.array(chroma, dtype=np.float64, copy=True)
    # threshold at the third-largest value per row (ties kept, as np ref does)
    third = -np.sort(-chroma, axis=-1)[:, 2:3]
    chroma[chroma < third] = 0.0
    keep = np.count_nonzero(chroma, axis=-1) > 0
    return data[keep], rhythm[keep], note[keep], chroma[keep]


def build_from_midi(midi_files: Sequence[str], data_type: str = "short",
                    n_workers: Optional[int] = None):
    """Rebuild the Yamaha-style corpus from MIDI files with the
    tokenizer, host-parallel (the reference is serial, ptb_v2.py:297)."""
    from music_fader_nets_tpu_torch.tokenizer import pipeline
    return pipeline.build_corpus(midi_files, data_type=data_type,
                                 n_workers=n_workers)


def get_classic_piano(data_type: str = "short",
                      cache_dir: Optional[str] = None,
                      midi_dirs: Optional[Sequence[str]] = None,
                      synthetic_fallback: bool = True,
                      n_synthetic: int = 2048,
                      return_source: bool = False,
                      ) -> Tuple[np.ndarray, ...]:
    """Load the Yamaha-style corpus: cached `.npy` arrays, else a rebuild
    from MIDI dirs, else the synthetic fallback (reference ptb_v2.py:276-368).

    With `return_source=True` a fifth element is appended: the provenance
    string `"cache" | "midi" | "synthetic"`. This is the single source of
    truth for "is this real data" — consumers (e.g. the condition-sweep
    std normalizers, eval/cli.py) must branch on it rather than re-deriving
    provenance from the filesystem."""
    cache_dir = cache_dir or CACHE_DIR
    cache = os.path.join(cache_dir, "data.npy")

    if os.path.exists(cache):
        data = np.load(os.path.join(cache_dir, "data.npy"))
        rhythm = np.load(os.path.join(cache_dir, "rhythm.npy"))
        note = np.load(os.path.join(cache_dir, "note_density.npy"))
        chroma = np.load(os.path.join(cache_dir, "chroma.npy"))
        out = _sanitize_chroma(data, rhythm, note, chroma)
        return (*out, "cache") if return_source else out

    if midi_dirs:
        files = sorted(
            os.path.join(d, k) for d in midi_dirs for k in os.listdir(d))
        data, rhythm, note, chroma = build_from_midi(files, data_type)
        # deterministic shuffle, seed 777 (reference ptb_v2.py:325-331)
        rng = np.random.RandomState(777)
        idx = np.arange(len(data))
        rng.shuffle(idx)
        data, rhythm, note, chroma = data[idx], rhythm[idx], note[idx], chroma[idx]
        os.makedirs(cache_dir, exist_ok=True)
        np.save(os.path.join(cache_dir, "data.npy"), data)
        np.save(os.path.join(cache_dir, "rhythm.npy"), rhythm)
        np.save(os.path.join(cache_dir, "note_density.npy"), note)
        np.save(os.path.join(cache_dir, "chroma.npy"), chroma)
        out = (data, rhythm, note, chroma)
        return (*out, "midi") if return_source else out

    if not synthetic_fallback:
        raise FileNotFoundError(
            f"no corpus cache at {cache} and no MIDI dirs given")
    seq_len = 100 if data_type == "short" else 250
    attr_len = 16 if data_type == "short" else 64
    out = synthetic.synth_corpus(n_synthetic, seq_len, attr_len)
    return (*out, "synthetic") if return_source else out


def get_vgmidi(vgmidi_dir: Optional[str] = None,
               synthetic_fallback: bool = True, n_synthetic: int = 512):
    vgmidi_dir = vgmidi_dir or VGMIDI_DIR
    tokens_path = os.path.join(vgmidi_dir, "song_tokens.npy")
    if os.path.exists(tokens_path):
        data = np.load(tokens_path, allow_pickle=True)
        rhythm = np.load(os.path.join(vgmidi_dir, "rhythm_lst.npy"),
                         allow_pickle=True)
        note = np.load(os.path.join(vgmidi_dir, "note_lst.npy"),
                       allow_pickle=True)
        valence = np.load(os.path.join(vgmidi_dir, "valence_lst.npy"))
        arousal = np.load(os.path.join(vgmidi_dir, "arousal_lst.npy"))
        chroma_path = os.path.join(vgmidi_dir, "chroma_lst.npy")
        if os.path.exists(chroma_path):
            chroma = np.load(chroma_path)
        else:
            # lazily compute chroma by decoding tokens -> notes -> key vector
            # (reference ptb_v2.py:381-391, without the tmp-file round trip)
            from music_fader_nets_tpu_torch.tokenizer import pipeline
            chroma = pipeline.chroma_from_token_rows(data)
            np.save(chroma_path, chroma)
        return data, rhythm, note, arousal, valence, chroma

    if not synthetic_fallback:
        raise FileNotFoundError(f"no VGMIDI arrays under {vgmidi_dir}")
    return synthetic.synth_vgmidi(n_synthetic)
