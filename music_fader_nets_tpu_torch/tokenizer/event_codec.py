"""388-token pianoroll event codec.

Vocab scheme (reference polyphonic_event_based_v2.py:6-10):
  0-127   note-on (pitch)
  128     start, 129 end (unused by the round trip)
  130     time-shift (advance one grid step)
  131-258 note-off (pitch + 131)
  259     empty (unused)
  260-387 velocity (value + 260)

Encoding walks the pianoroll step by step maintaining the held-pitch set:
note-offs for vanished pitches, off+on for pitches whose velocity changed,
note-on+velocity for new pitches, then one shift per step — the exact
recurrence of the reference's `pr_to_events` (polyphonic_event_based_v2.py:
32-81). `decode_events` inverts it; round-trip equality over the pianoroll
is the codec's contract (the reference's only self-verifying test,
polyphonic_event_based_v2.py:417-424).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

START = 128
END = 129
SHIFT = 130
OFFSET_DISPLACEMENT = 131
EMPTY = 259
VELOCITY_DISPLACEMENT = 260
VOCAB = 388
DEFAULT_VELOCITY = 100


def pianoroll_to_pitch_lists(pr: np.ndarray) -> Tuple[List[list], List[list]]:
    """Per-step lists of sounding pitches and their velocities."""
    pitch_lst, vel_lst = [], []
    for row in pr:
        idx = np.flatnonzero(row > 0)
        pitch_lst.append(list(idx))
        vel_lst.append([int(row[j]) for j in idx])
    return pitch_lst, vel_lst


def pitch_lists_to_events(pitch_lst, vel_lst) -> List[int]:
    events: List[int] = []
    vel_of = {}
    held: List[int] = []

    for h in sorted(pitch_lst[0]):
        i = pitch_lst[0].index(h)
        events += [h, vel_lst[0][i] + VELOCITY_DISPLACEMENT]
        vel_of[h] = vel_lst[0][i]
        held.append(h)
    events.append(SHIFT)

    for step in range(1, len(pitch_lst)):
        cur = pitch_lst[step]
        for p in sorted(k for k in held if k not in cur):
            events.append(p + OFFSET_DISPLACEMENT)
            held.remove(p)
        restrike = []
        for j, p in enumerate(cur):
            if p in held and vel_lst[step][j] != vel_of[p]:
                events.append(p + OFFSET_DISPLACEMENT)
                held.remove(p)
                restrike.append(p)
        for p in sorted([k for k in cur if k not in held] ):
            i = pitch_lst[step].index(p)
            events += [p, vel_lst[step][i] + VELOCITY_DISPLACEMENT]
            vel_of[p] = vel_lst[step][i]
            held.append(p)
        held.sort()
        events.append(SHIFT)

    for p in list(held):
        events.append(p + OFFSET_DISPLACEMENT)
        held.remove(p)
    return events


def events_to_pitch_lists(events) -> Tuple[List[list], List[list]]:
    pitch_lst, vel_lst = [], []
    cur: List[int] = []
    vel_of = {}
    prev_onset = 0
    for e in events:
        e = int(e)
        if e == SHIFT:
            cur_set = sorted(set(cur))
            if 0 in cur_set:
                cur_set.remove(0)
            vel_lst.append([vel_of.get(c, DEFAULT_VELOCITY) for c in cur_set])
            pitch_lst.append(cur_set)
        elif e in (START, END, EMPTY):
            continue
        elif e < OFFSET_DISPLACEMENT:          # onset
            cur.append(e)
            prev_onset = e
        elif e - OFFSET_DISPLACEMENT in cur:   # offset
            cur.remove(e - OFFSET_DISPLACEMENT)
        elif e - VELOCITY_DISPLACEMENT > 0:    # velocity
            if prev_onset in cur:
                vel_of[prev_onset] = e - VELOCITY_DISPLACEMENT
    return pitch_lst, vel_lst


def pitch_lists_to_pianoroll(pitch_lst, vel_lst) -> np.ndarray:
    pr = np.zeros((len(pitch_lst), 128))
    for i, pitches in enumerate(pitch_lst):
        for j, p in enumerate(pitches):
            pr[i, p] = vel_lst[i][j]
    return pr


def pitch_lists_to_rhythm(pitch_lst) -> List[int]:
    """Per-step 3-class rhythm: 0 rest, 1 onset, 2 hold (a step whose pitch
    set equals or is contained in the previous step's is a hold —
    reference polyphonic_event_based_v2.py:140-158)."""
    rhythm = [1 if len(pitch_lst[0]) > 0 else 0]
    prev = pitch_lst[0]
    for i in range(1, len(pitch_lst)):
        cur = pitch_lst[i]
        if len(cur) == 0:
            rhythm.append(0)
        elif cur == prev or all(p in prev for p in cur):
            rhythm.append(2)
        else:
            rhythm.append(1)
        prev = cur
    return rhythm


def rhythm_from_pianoroll(pr: np.ndarray) -> List[int]:
    """Vectorized 3-class rhythm track, identical to
    `pitch_lists_to_rhythm` over the roll's pitch sets."""
    mask = np.asarray(pr) > 0
    count = mask.sum(axis=1)
    if len(mask) == 0:
        return []
    # cur is a subset of prev <=> no pitch sounds now that didn't before
    subset = ~(mask[1:] & ~mask[:-1]).any(axis=1)
    rest = np.where(subset, 2, 1)
    tail = np.where(count[1:] == 0, 0, rest)
    return [1 if count[0] > 0 else 0] + tail.tolist()


def encode_pianoroll(pr: np.ndarray):
    """pr (T,128) -> (events, pitch_lst, vel_lst, rhythm)."""
    pitch_lst, vel_lst = pianoroll_to_pitch_lists(pr)
    rhythm = rhythm_from_pianoroll(pr)
    events = pitch_lists_to_events(pitch_lst, vel_lst)
    return events, pitch_lst, vel_lst, rhythm


def decode_events(events):
    """events -> (pr, pitch_lst, vel_lst)."""
    pitch_lst, vel_lst = events_to_pitch_lists(events)
    pr = pitch_lists_to_pianoroll(pitch_lst, vel_lst)
    return pr, pitch_lst, vel_lst
