"""Beat-quantized pianoroll from parsed MIDI.

Semantics mirror the reference's vendored pypianoroll parser
(`parse_pretty_midi`, reference polyphonic_event_based_v2.py:195-414):
notes are snapped to a `beat_resolution`-per-beat grid via the fractional
position between beat times, a velocity roll (n_steps, 128) is filled from
onset to offset in 'max' merge mode, with the same two collision rules
(clear the cell before an onset if occupied; shorten a note whose offset
lands on an occupied cell).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiData


def quantize_pianoroll(md: MidiData, beat_resolution: int = 4,
                       first_beat_time: Optional[float] = None) -> np.ndarray:
    """(beat_resolution * n_beats, 128) uint8 velocity roll."""
    if first_beat_time is None:
        if md.time_signatures:
            first_beat_time = md.time_signatures[0][0]
        else:
            first_beat_time = min((n.start for n in md.notes), default=0.0)

    beat_times = np.asarray(md.get_beats(first_beat_time))
    if len(beat_times) == 0:
        raise ValueError("cannot derive beat timings")
    n_steps = beat_resolution * len(beat_times)
    one_more = 2 * beat_times[-1] - beat_times[-2] if len(beat_times) > 1 \
        else beat_times[-1] + 0.5
    beat_plus = np.append(beat_times, one_more)

    roll = np.zeros((n_steps, 128), np.uint8)
    notes = [n for n in md.notes if n.end > first_beat_time]
    if not notes:
        return roll

    def to_step(times):
        idx = np.searchsorted(beat_times, times) - 1
        idx = np.clip(idx, 0, len(beat_times) - 1)
        remained = times - beat_times[idx]
        ratios = remained / (beat_plus[idx + 1] - beat_times[idx])
        return idx, ratios

    starts = np.array([n.start for n in notes])
    ends = np.array([n.end for n in notes])
    pitches = np.array([n.pitch for n in notes])
    b_on, r_on = to_step(starts)
    note_ons = np.round((b_on + r_on) * beat_resolution).astype(int)
    b_off, r_off = to_step(ends)
    note_offs = ((b_off + r_off) * beat_resolution).astype(int)

    for i, start in enumerate(note_ons):
        end = note_offs[i]
        vel = notes[i].velocity
        if vel < 1:
            continue
        p = pitches[i]
        if 0 < start < n_steps and roll[start - 1, p]:
            roll[start - 1, p] = 0
        if end < n_steps - 1 and roll[end, p]:
            end -= 1
        s, e = max(0, start), min(n_steps, end)
        if e > s:
            roll[s:e, p] = np.maximum(roll[s:e, p], vel)
    return roll
