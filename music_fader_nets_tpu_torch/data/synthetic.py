"""Synthetic corpus generator (own copy of
`music_fader_nets_tpu/data/synthetic.py`: numpy and the port's tokenizer).

Produces arrays with the exact schema of the reference's cached corpus
(`data/values_v3/{data,rhythm,note_density,chroma}.npy`, reference
ptb_v2.py:336-339) so every downstream component — datasets, trainers,
evaluators, benchmarks — runs without the (unreleased) Yamaha/VGMIDI MIDI
corpora.

Segments are generated as NOTES on a 120bpm/beat-res-4 grid and pushed
through the REAL tokenizer stack: performance tokens from
`performance_encode`, rhythm/note-density/chroma from the quantized
pianoroll — so tokens and attribute tracks are mutually consistent, exactly
as in a corpus built from MIDI. (Earlier versions drew tokens and attributes
independently, which made controllability training demos meaningless: the
eval round trip measures attributes OF the generated tokens.) Corpus
invariants the reference filters for hold by construction (rhythm starts
with an onset, ptb_v2.py:264; top-3 chroma bins, ptb_v2.py:352-356).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from music_fader_nets_tpu_torch.config import CHROMA_DIMS

EOS = 1
STEP_SEC = 0.125          # 120 bpm, beat_resolution=4

# a handful of diatonic pitch pools so chroma/key vary per segment
_SCALES = [
    [60, 62, 64, 65, 67, 69, 71, 72],       # C major
    [57, 59, 60, 62, 64, 65, 68, 69],       # A minor (harmonic)
    [62, 64, 66, 67, 69, 71, 73, 74],       # D major
    [55, 57, 59, 60, 62, 64, 66, 67],       # G major
    [65, 67, 69, 70, 72, 74, 76, 77],       # F major
]


def _gen_segment(rng, attr_len: int, max_tokens: int):
    """One segment: notes on the grid with controlled onset density and
    polyphony -> (tokens, rhythm, note_density, chroma) via the tokenizer."""
    from music_fader_nets_tpu_torch.tokenizer.attributes import get_music_attributes
    from music_fader_nets_tpu_torch.tokenizer.key_estimate import (
        harmony_vector_from_notes,
    )
    from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote
    from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
        performance_encode,
    )
    scale = _SCALES[int(rng.integers(len(_SCALES)))]
    onset_p = float(rng.uniform(0.3, 0.95))      # rhythm-density knob
    max_poly = int(rng.integers(1, 5))           # note-density knob
    notes = []
    for t in range(attr_len):
        if t == 0 or rng.random() < onset_p:
            n_notes = int(rng.integers(1, max_poly + 1))
            pitches = rng.choice(scale, size=min(n_notes, len(scale)),
                                 replace=False)
            dur_steps = int(rng.integers(1, 3))
            for p in pitches:
                notes.append(MidiNote(int(p), int(rng.integers(40, 120)),
                                      t * STEP_SEC,
                                      min(t + dur_steps, attr_len) * STEP_SEC))
    notes.sort(key=lambda n: (n.start, n.pitch))

    tokens = performance_encode(notes)
    tokens.append(EOS)
    if len(tokens) > max_tokens:
        return None

    # quantized roll on the same grid -> attributes
    pr = np.zeros((attr_len, 128), np.uint8)
    for n in notes:
        s = int(round(n.start / STEP_SEC))
        e = max(s + 1, int(round(n.end / STEP_SEC)))
        pr[s: min(e, attr_len), n.pitch] = n.velocity
    _, rhythm, note_density, _, _ = get_music_attributes(pr, beat=4)
    if rhythm[0] != 1:
        return None

    chroma = harmony_vector_from_notes(notes)
    if chroma is None:
        return None
    third = -np.sort(-chroma)[2]
    chroma = np.where(chroma < third, 0.0, chroma)    # top-3 bins

    return tokens, np.asarray(rhythm), np.asarray(note_density), chroma


def synth_corpus(n_segments: int = 2048, seq_len: int = 100, attr_len: int = 16,
                 seed: int = 777) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (data (N, seq_len) int, rhythm (N, attr_len) int,
    note_density (N, attr_len) int, chroma (N, 24) float)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n_segments, seq_len), dtype=np.int64)
    rhythm = np.zeros((n_segments, attr_len), dtype=np.int64)
    note_density = np.zeros((n_segments, attr_len), dtype=np.int64)
    chroma = np.zeros((n_segments, CHROMA_DIMS), dtype=np.float64)

    i = 0
    guard = 0
    while i < n_segments and guard < 20 * n_segments:
        guard += 1
        seg = _gen_segment(rng, attr_len, seq_len)
        if seg is None:
            continue
        toks, r, nd, c = seg
        data[i, : len(toks)] = toks
        rhythm[i] = r
        note_density[i] = nd
        chroma[i] = c
        i += 1
    if i < n_segments:
        raise RuntimeError("synthetic generator failed to fill the corpus")
    return data, rhythm, note_density, chroma


def synth_vgmidi(n_segments: int = 512, seq_len: int = 100, attr_len: int = 16,
                 seed: int = 778):
    """Synthetic VGMIDI-shaped corpus with arousal/valence labels
    (reference ptb_v2.py:371-397). Arousal correlates with onset density so
    the supervised GM-VAE branch has signal to learn."""
    data, rhythm, note, chroma = synth_corpus(n_segments, seq_len, attr_len,
                                              seed)
    rng = np.random.default_rng(seed + 1)
    r_density = (rhythm == 1).mean(axis=-1)
    arousal = (r_density - r_density.mean()) * 2 + rng.normal(
        0, 0.2, n_segments)
    valence = rng.uniform(-1.0, 1.0, size=n_segments)
    return data, rhythm, note, arousal, valence, chroma


def synth_vgmidi_ragged(n_segments: int = 64, seq_len: int = 100,
                        attr_len: int = 16, seed: int = 779):
    """Released-format VGMIDI stand-in: dtype=object arrays of per-song
    VARIABLE-length token/rhythm/note sequences (what `np.load(...,
    allow_pickle=True)` yields for the real release, reference
    ptb_v2.py:375-377). Token rows carry NO EOS and no padding — the
    reference's `VGMIDIDataset` re-inserts EOS and pads (ptb_v2.py:459-470),
    and that path is exactly what these fixtures exercise."""
    rng = np.random.default_rng(seed)
    d_rows, r_rows, n_rows, chroma_rows, r_dens = [], [], [], [], []
    guard = 0
    while len(d_rows) < n_segments and guard < 50 * n_segments:
        guard += 1
        a_len = int(rng.integers(max(4, attr_len // 2), attr_len + 1))
        seg = _gen_segment(rng, a_len, seq_len)
        if seg is None:
            continue
        toks, r, nd, c = seg
        d_rows.append(np.asarray(toks[:-1], dtype=np.int64))   # strip EOS
        r_rows.append(np.asarray(r, dtype=np.int64))
        n_rows.append(np.asarray(nd, dtype=np.int64))
        chroma_rows.append(c)
        r_dens.append((np.asarray(r) == 1).mean())
    if len(d_rows) < n_segments:
        raise RuntimeError("synthetic generator failed to fill the corpus")

    def _obj(rows):
        out = np.empty(len(rows), dtype=object)
        for i, row in enumerate(rows):
            out[i] = row
        return out

    r_dens = np.asarray(r_dens)
    arousal = (r_dens - r_dens.mean()) * 2 + rng.normal(0, 0.2, n_segments)
    valence = rng.uniform(-1.0, 1.0, size=n_segments)
    return (_obj(d_rows), _obj(r_rows), _obj(n_rows), arousal, valence,
            np.asarray(chroma_rows))
