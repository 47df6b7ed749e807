"""Corpus building pipeline: MIDI files -> (tokens, rhythm, note_density,
chroma) arrays with the reference's cache schema.

Mirrors `process_data`/`get_classic_piano` (reference ptb_v2.py:217-341)
with three deliberate improvements, documented per SURVEY.md §2.4:
  * host-parallel over files (the reference is serial, ptb_v2.py:297);
  * no tmp.mid side-effect files — segments are sliced and tokenized in
    memory;
  * the chroma/key vector is computed from the segment's notes (the
    reference calls `get_harmony_vector()` with no argument at
    ptb_v2.py:265, which crashes the rebuild path as shipped; only its
    cached-.npy path ever worked).
"""
from __future__ import annotations

import multiprocessing
from typing import List, Optional, Sequence, Tuple

import numpy as np

from music_fader_nets_tpu_torch.tokenizer import attributes as attr_lib
from music_fader_nets_tpu_torch.tokenizer import key_estimate
from music_fader_nets_tpu_torch.tokenizer import performance_codec
from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiData, MidiNote, read_midi
from music_fader_nets_tpu_torch.tokenizer.pianoroll import quantize_pianoroll


def slice_notes(md: MidiData, start: float, end: float) -> List[MidiNote]:
    """Notes overlapping [start, end), shifted to t=0 and clipped at the
    segment end (reference `slice_midi`, ptb_v2.py:60-92: keeps notes whose
    onset is inside the window)."""
    out = []
    for n in md.notes:
        if n.start > end or n.start < start:
            continue
        out.append(MidiNote(n.pitch, n.velocity, n.start - start,
                            min(n.end, end) - start))
    return out


def process_file(path: str, beat_res: int = 4, num_of_beats: int = 4,
                 max_tokens: int = 100):
    """One MIDI file -> lists of (tokens, rhythm, note_density, chroma) per
    kept segment. Filters replicate ptb_v2.py:241-264."""
    data, rhythms, notes_d, chromas = [], [], [], []
    try:
        md = read_midi(path)
        pr = quantize_pianoroll(md, beat_resolution=beat_res)
        beats = md.get_beats(md.time_signatures[0][0]
                             if md.time_signatures else
                             min((n.start for n in md.notes), default=0.0))
    except Exception:
        return data, rhythms, notes_d, chromas

    seg = beat_res * num_of_beats
    for j in range(0, len(pr), seg):
        if (j + seg) // beat_res >= len(beats):
            break
        new_pr = pr[j: j + seg]
        seg_notes = slice_notes(md, beats[j // beat_res],
                                beats[(j + seg) // beat_res])
        ms = np.argmax(new_pr, axis=-1)
        # non-empty + uniqueness + fill filters (ptb_v2.py:252-253)
        if not (len(seg_notes) > 0 and len(np.unique(ms)) > 2
                and np.count_nonzero(ms) >= 0.75 * len(ms)):
            continue
        _, rhythm, note_density, _, _ = attr_lib.get_music_attributes(
            new_pr, beat=beat_res)
        events = performance_codec.performance_encode(seg_notes)
        events.append(performance_codec.EOS)      # ptb_v2.py:261
        # rhythm must start with an onset; token budget (ptb_v2.py:264)
        if rhythm[0] != 1 or len(events) > max_tokens:
            continue
        chroma = key_estimate.harmony_vector_from_notes(seg_notes)
        if chroma is None:
            continue
        data.append(events)
        rhythms.append(rhythm)
        notes_d.append(note_density)
        chromas.append(chroma)
    return data, rhythms, notes_d, chromas


def _worker(args):
    return process_file(*args)


def build_corpus(midi_files: Sequence[str], data_type: str = "short",
                 n_workers: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Files -> padded corpus arrays (reference ptb_v2.py:297-322 semantics:
    pad token streams to max length with 0, stack attributes)."""
    if data_type == "short":
        beat_res, num_beats, max_tokens = 4, 4, 100
    else:                                          # "long" (ptb_v2.py:303)
        beat_res, num_beats, max_tokens = 4, 16, 250

    jobs = [(f, beat_res, num_beats, max_tokens) for f in midi_files]
    n_workers = n_workers or max(1, multiprocessing.cpu_count() - 1)
    if n_workers > 1 and len(jobs) > 1:
        with multiprocessing.Pool(n_workers) as pool:
            results = pool.map(_worker, jobs)
    else:
        results = [_worker(j) for j in jobs]

    data, rhythms, notes_d, chromas = [], [], [], []
    for d, r, n, c in results:
        data += d
        rhythms += r
        notes_d += n
        chromas += c
    if not data:
        empty = np.zeros((0, max_tokens), int)
        return empty, np.zeros((0, beat_res * num_beats), int), \
            np.zeros((0, beat_res * num_beats), int), np.zeros((0, 24))

    maxlen = max(len(d) for d in data)
    padded = np.zeros((len(data), maxlen), dtype=int)
    for i, d in enumerate(data):
        padded[i, : len(d)] = d
    return padded, np.array(rhythms), np.array(notes_d), np.array(chromas)


def chroma_from_token_rows(token_rows, is_one_hot: bool = True) -> np.ndarray:
    """VGMIDI lazy chroma: decode each token row to notes and estimate the
    key vector (reference ptb_v2.py:381-391, without tmp files)."""
    out = []
    for row in token_rows:
        notes = performance_codec.performance_decode(
            [t for t in np.asarray(row).tolist() if t > 1])
        c = key_estimate.harmony_vector_from_notes(notes, is_one_hot=is_one_hot)
        out.append(c if c is not None else np.zeros(24))
    return np.array(out)


def attributes_from_tokens(tokens, beat_res: int = 4):
    """Generated tokens -> (rhythm, note_density) via decode -> quantized
    pianoroll -> attribute extraction. This is the evaluation round trip
    (reference test_class.py:130-137) done in memory."""
    notes = performance_codec.performance_decode(
        [t for t in np.asarray(tokens).tolist() if t > 1])
    if not notes:
        return None
    md = MidiData(notes, [(0.0, 120.0)], [], end_time=max(n.end for n in notes))
    try:
        pr = quantize_pianoroll(md, beat_resolution=beat_res,
                                first_beat_time=notes[0].start)
    except Exception:
        return None
    if pr.size == 0:
        return None
    _, rhythm, note_density, _, _ = attr_lib.get_music_attributes(
        pr, beat=beat_res)
    return rhythm, note_density
