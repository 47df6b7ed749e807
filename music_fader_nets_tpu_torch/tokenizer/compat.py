"""Reference-API compatibility surface (the port's copy of
`music_fader_nets_tpu/tokenizer/compat.py`, over the port's own codec
modules).

Thin aliases with the reference's function names and signatures so code
written against `ptb_v2.py` / `polyphonic_event_based_v2.py` maps 1:1:

  magenta_encode_midi / magenta_decode_midi   (ptb_v2.py:38-57)
  encode_midi / decode_events                 (polyphonic_event_based_v2.py:161-176)
  slice_midi                                  (ptb_v2.py:60-92)
  get_harmony_vector                          (ptb_v2.py:95-129)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from music_fader_nets_tpu_torch.tokenizer import event_codec
from music_fader_nets_tpu_torch.tokenizer.key_estimate import (
    harmony_vector_from_notes,
)
from music_fader_nets_tpu_torch.tokenizer.midi_io import (
    MidiData, read_midi, write_midi,
)
from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
    performance_decode_to_mididata, performance_encode,
)
from music_fader_nets_tpu_torch.tokenizer.pianoroll import quantize_pianoroll
from music_fader_nets_tpu_torch.tokenizer.pipeline import slice_notes


def magenta_encode_midi(midi_filename: str, is_eos: bool = False) -> List[int]:
    """MIDI file -> 342-vocab performance tokens (ptb_v2.py:38-46)."""
    md = read_midi(midi_filename)
    return performance_encode(md.notes, add_eos=is_eos)


def magenta_decode_midi(notes, is_eos: bool = False) -> MidiData:
    """Tokens -> MidiData (the reference returns a PrettyMIDI object,
    ptb_v2.py:49-57); write with `tokenizer.write_midi`."""
    toks = [int(t) for t in np.asarray(list(notes)).ravel().tolist() if t > 1]
    return performance_decode_to_mididata(toks)


def encode_midi(fname, beat: int = 24, is_pr: bool = False):
    """Pianoroll/MIDI -> (events, pitch_lst, velocity_lst, pr, rhythm)
    with the reference's return signature
    (polyphonic_event_based_v2.py:161-170)."""
    if not is_pr:
        md = read_midi(fname)
        pr = quantize_pianoroll(md, beat_resolution=beat)[: beat * 8]
    else:
        pr = np.asarray(fname)
    events, pitch_lst, vel_lst, rhythm = event_codec.encode_pianoroll(pr)
    return events, pitch_lst, vel_lst, pr, rhythm


def decode_events(events):
    """(polyphonic_event_based_v2.py:173-176)."""
    return event_codec.decode_events(events)


def slice_midi(md: MidiData, beats, start_idx: int, end_idx: int,
               out_path: Optional[str] = None) -> MidiData:
    """Beat-window slice (ptb_v2.py:60-92). The reference always writes a
    tmp.mid side effect; here the file write is opt-in."""
    notes = slice_notes(md, beats[start_idx], beats[end_idx])
    end = max((n.end for n in notes), default=0.0)
    out = MidiData(notes, md.tempo_changes, md.time_signatures,
                   md.resolution, end)
    if out_path:
        write_midi(out, out_path)
    return out


def get_harmony_vector(fname: Optional[str] = None, is_one_hot: bool = False,
                       notes=None):
    """Estimated-key 24-vector (ptb_v2.py:95-129). Accepts a MIDI path like
    the reference, or a note list directly (fixing the reference's
    no-argument call crash at ptb_v2.py:265)."""
    if notes is None:
        if fname is None:
            raise TypeError("get_harmony_vector needs a filename or notes")
        notes = read_midi(fname).notes
    return harmony_vector_from_notes(notes, is_one_hot=is_one_hot)
