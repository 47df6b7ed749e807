"""342-token MidiPerformance codec — replacement for the reference's
custom Magenta fork (`MidiPerformanceEncoder`, reference ptb_v2.py:20-46).

Vocab layout (fixed by ptb_v2.py:25-35 + the mask evidence in
trainer_glsr.py:125-133):
  0         PAD
  1         EOS
  2..89     NOTE_ON  pitch 21..108          (88)
  90..177   NOTE_OFF pitch 21..108          (88)
  178..277  TIME_SHIFT 1..100 steps @ 100 steps/sec (10ms .. 1s)
  278..341  VELOCITY bins 1..64 over MIDI 1..127 (bin size 2)
  => EVENT_DIMS = 342

Encoding follows Magenta's `Performance.from_quantized_sequence`: note
times quantized to 10ms steps, events emitted in step order with ties broken
by note order (earlier-starting note first, its offset before a later note's
onset at the same step), a VELOCITY event before a NOTE_ON whenever the
velocity bin changes, and gaps covered by TIME_SHIFTs of at most 100 steps.
"""
from __future__ import annotations

from typing import List

from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiData, MidiNote

PAD = 0
EOS = 1
EVENT_DIMS = 342

STEPS_PER_SECOND = 100          # reference ptb_v2.py:27
NUM_VELOCITY_BINS = 64          # reference ptb_v2.py:26
MIN_PITCH = 21                  # reference ptb_v2.py:28
MAX_PITCH = 108                 # reference ptb_v2.py:29
MAX_SHIFT_STEPS = 100

_NUM_PITCHES = MAX_PITCH - MIN_PITCH + 1        # 88
NOTE_ON_BASE = 2
NOTE_OFF_BASE = NOTE_ON_BASE + _NUM_PITCHES      # 90
SHIFT_BASE = NOTE_OFF_BASE + _NUM_PITCHES        # 178
VEL_BASE = SHIFT_BASE + MAX_SHIFT_STEPS          # 278

_MIN_VEL, _MAX_VEL = 1, 127
_VEL_BIN_SIZE = -(-(_MAX_VEL - _MIN_VEL + 1) // NUM_VELOCITY_BINS)  # ceil=2


def token_role(t: int) -> str:
    """Human-readable role of a token id — for parity diagnostics
    (parity.py::check_token_stream first-divergence reports)."""
    t = int(t)
    if t == PAD:
        return "PAD"
    if t == EOS:
        return "EOS"
    if NOTE_ON_BASE <= t < NOTE_OFF_BASE:
        return f"ON(p{t - NOTE_ON_BASE + MIN_PITCH})"
    if NOTE_OFF_BASE <= t < SHIFT_BASE:
        return f"OFF(p{t - NOTE_OFF_BASE + MIN_PITCH})"
    if SHIFT_BASE <= t < VEL_BASE:
        return f"SHIFT({t - SHIFT_BASE + 1})"
    if VEL_BASE <= t < EVENT_DIMS:
        return f"VEL(b{t - VEL_BASE + 1})"
    return f"INVALID({t})"


def velocity_to_bin(velocity: int) -> int:
    v = max(_MIN_VEL, min(_MAX_VEL, velocity))
    return (v - _MIN_VEL) // _VEL_BIN_SIZE + 1


def bin_to_velocity(b: int) -> int:
    return _VEL_BIN_SIZE * (b - 1) + _MIN_VEL


def performance_encode(notes: List[MidiNote], add_eos: bool = False) -> List[int]:
    """Note list -> token ids. Pitches outside [21, 108] are dropped (the
    Magenta encoder's behavior for out-of-range pitches)."""
    notes = [n for n in notes if MIN_PITCH <= n.pitch <= MAX_PITCH]
    notes = sorted(notes, key=lambda n: (n.start, n.pitch))
    events = []                                  # (step, sort_idx, is_off, i)
    for i, n in enumerate(notes):
        # Magenta's sequences_lib.quantize_to_step with QUANTIZE_CUTOFF=0.5:
        # int(seconds * sps + 0.5). Python round() would bankers-round exact
        # half-steps DOWN half the time (round(12.5) == 12) — and MIDI tick
        # grids land on exact half-steps constantly — so the formula must be
        # the fork's add-then-truncate, bit for bit.
        on_step = int(n.start * STEPS_PER_SECOND + 0.5)
        off_step = max(on_step + 1, int(n.end * STEPS_PER_SECOND + 0.5))
        events.append((on_step, i, False))
        events.append((off_step, i, True))
    events.sort(key=lambda e: (e[0], e[1], e[2]))

    tokens: List[int] = []
    cur_step = 0
    # Magenta initializes the running velocity bin to 0 so the first note-on
    # always emits a velocity event
    cur_bin = 0
    for step, i, is_off in events:
        gap = step - cur_step
        while gap > 0:
            shift = min(gap, MAX_SHIFT_STEPS)
            tokens.append(SHIFT_BASE + shift - 1)
            gap -= shift
        cur_step = step
        n = notes[i]
        if is_off:
            tokens.append(NOTE_OFF_BASE + n.pitch - MIN_PITCH)
        else:
            b = velocity_to_bin(n.velocity)
            if b != cur_bin:
                tokens.append(VEL_BASE + b - 1)
                cur_bin = b
            tokens.append(NOTE_ON_BASE + n.pitch - MIN_PITCH)
    if add_eos:
        tokens.append(EOS)
    return tokens


def performance_decode(tokens, default_velocity: int = 100,
                       trailing_note_seconds: float = 0.1) -> List[MidiNote]:
    """Token ids -> note list. PAD/EOS and malformed tokens are skipped;
    notes left open at the end are closed `trailing_note_seconds` after the
    final event (Magenta closes them at the performance end time)."""
    notes: List[MidiNote] = []
    open_notes = {}
    step = 0
    velocity = default_velocity
    for t in tokens:
        t = int(t)
        if NOTE_ON_BASE <= t < NOTE_OFF_BASE:
            pitch = t - NOTE_ON_BASE + MIN_PITCH
            if pitch in open_notes:
                s0, v0 = open_notes.pop(pitch)
                if step > s0:
                    notes.append(MidiNote(pitch, v0, s0 / STEPS_PER_SECOND,
                                          step / STEPS_PER_SECOND))
            open_notes[pitch] = (step, velocity)
        elif NOTE_OFF_BASE <= t < SHIFT_BASE:
            pitch = t - NOTE_OFF_BASE + MIN_PITCH
            if pitch in open_notes:
                s0, v0 = open_notes.pop(pitch)
                if step > s0:
                    notes.append(MidiNote(pitch, v0, s0 / STEPS_PER_SECOND,
                                          step / STEPS_PER_SECOND))
        elif SHIFT_BASE <= t < VEL_BASE:
            step += t - SHIFT_BASE + 1
        elif VEL_BASE <= t < EVENT_DIMS:
            velocity = bin_to_velocity(t - VEL_BASE + 1)
        # PAD, EOS, out-of-range: skip
    end = step + int(round(trailing_note_seconds * STEPS_PER_SECOND))
    for pitch, (s0, v0) in open_notes.items():
        notes.append(MidiNote(pitch, v0, s0 / STEPS_PER_SECOND,
                              max(end, s0 + 1) / STEPS_PER_SECOND))
    notes.sort(key=lambda n: (n.start, n.pitch))
    return notes


def performance_decode_to_mididata(tokens, **kw) -> MidiData:
    notes = performance_decode(tokens, **kw)
    end = max((n.end for n in notes), default=0.0)
    return MidiData(notes, [(0.0, 120.0)], [(0.0, 4, 4)], end_time=end)
