"""Self-contained Standard MIDI File reader/writer.

Replaces the reference's `pretty_midi` dependency (reference ptb_v2.py:10)
with a dependency-free host-side parser. Supports format 0/1 files, running
status, tempo (set-tempo meta 0x51) and time-signature (0x58) maps, note
on/off pairing per (channel, pitch) with sustain-free semantics matching
pretty_midi's defaults: a note-on with velocity 0 is a note-off; re-striking
an open pitch closes the previous note at the new onset.

Times are float seconds, converted through the tempo map exactly once at
parse time (like pretty_midi's tick->time table).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple


@dataclasses.dataclass
class MidiNote:
    pitch: int
    velocity: int
    start: float
    end: float


@dataclasses.dataclass
class MidiData:
    notes: List[MidiNote]
    tempo_changes: List[Tuple[float, float]]          # (time_sec, bpm)
    time_signatures: List[Tuple[float, int, int]]     # (time_sec, num, den)
    resolution: int = 480
    end_time: float = 0.0

    def get_beats(self, start_time: float = 0.0) -> List[float]:
        """Beat times from the tempo map (quarter-note beats), from
        `start_time` to the end of the last note — the same contract as
        `pretty_midi.PrettyMIDI.get_beats`."""
        end = max(self.end_time,
                  max((n.end for n in self.notes), default=0.0))
        beats = []
        t = start_time
        tempos = sorted(self.tempo_changes) or [(0.0, 120.0)]
        i = 0
        guard = 0
        while t <= end + 1e-9 and guard < 1_000_000:
            guard += 1
            beats.append(t)
            while i + 1 < len(tempos) and tempos[i + 1][0] <= t + 1e-9:
                i += 1
            # walk one beat; a tempo change mid-beat consumes the remaining
            # beat fraction at the new tempo (pretty_midi semantics)
            remaining = 1.0
            cur = t
            j = i
            while remaining > 1e-12:
                period = 60.0 / tempos[j][1]
                seg_end = tempos[j + 1][0] if j + 1 < len(tempos) else float("inf")
                dt = remaining * period
                if cur + dt <= seg_end + 1e-12:
                    cur += dt
                    remaining = 0.0
                else:
                    remaining -= (seg_end - cur) / period
                    cur = seg_end
                    j += 1
            t = cur
            i = j
        return beats


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def read_midi(path: str) -> MidiData:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntrk, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    pos = 8 + hlen

    # collect (tick, kind, payload) events from every track
    tempo_ticks: List[Tuple[int, float]] = []       # (tick, bpm)
    tsig_ticks: List[Tuple[int, int, int]] = []
    raw_notes: List[Tuple[int, int, int, int, int]] = []  # on/off events

    for _ in range(ntrk):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tpos, tend = pos + 8, pos + 8 + tlen
        pos = tend
        tick = 0
        status = 0
        while tpos < tend:
            delta, tpos = _read_varlen(data, tpos)
            tick += delta
            b = data[tpos]
            if b & 0x80:
                status = b
                tpos += 1
            ev = status & 0xF0
            ch = status & 0x0F
            if ev in (0x80, 0x90):
                pitch, vel = data[tpos], data[tpos + 1]
                tpos += 2
                on = ev == 0x90 and vel > 0
                raw_notes.append((tick, ch, pitch, vel, 1 if on else 0))
            elif ev in (0xA0, 0xB0, 0xE0):
                tpos += 2
            elif ev in (0xC0, 0xD0):
                tpos += 1
            elif status == 0xFF:
                meta = data[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(data, tpos)
                payload = data[tpos:tpos + mlen]
                tpos += mlen
                if meta == 0x51 and mlen == 3:
                    usec = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    tempo_ticks.append((tick, 60e6 / usec))
                elif meta == 0x58 and mlen >= 2:
                    tsig_ticks.append((tick, payload[0], 2 ** payload[1]))
            elif status in (0xF0, 0xF7):
                mlen, tpos = _read_varlen(data, tpos)
                tpos += mlen
            else:
                raise ValueError(f"unhandled status byte {status:#x}")

    if not tempo_ticks or tempo_ticks[0][0] != 0:
        tempo_ticks.insert(0, (0, 120.0))
    tempo_ticks.sort()

    # tick -> seconds via the tempo map
    def tick_to_time_fn():
        anchors = [(0, 0.0)]
        t_sec = 0.0
        for i in range(1, len(tempo_ticks)):
            dt = tempo_ticks[i][0] - tempo_ticks[i - 1][0]
            t_sec += dt / division * 60.0 / tempo_ticks[i - 1][1]
            anchors.append((tempo_ticks[i][0], t_sec))

        def conv(tick):
            lo = 0
            for j in range(len(anchors) - 1, -1, -1):
                if anchors[j][0] <= tick:
                    lo = j
                    break
            base_tick, base_t = anchors[lo]
            bpm = tempo_ticks[lo][1]
            return base_t + (tick - base_tick) / division * 60.0 / bpm
        return conv

    conv = tick_to_time_fn()

    # pair note on/off
    notes: List[MidiNote] = []
    open_notes = {}
    for tick, ch, pitch, vel, on in sorted(raw_notes,
                                           key=lambda e: (e[0], e[4])):
        key = (ch, pitch)
        if on:
            if key in open_notes:
                st, sv = open_notes.pop(key)
                if tick > st:
                    notes.append(MidiNote(pitch, sv, conv(st), conv(tick)))
            open_notes[key] = (tick, vel)
        else:
            if key in open_notes:
                st, sv = open_notes.pop(key)
                if tick > st:
                    notes.append(MidiNote(pitch, sv, conv(st), conv(tick)))
    for (ch, pitch), (st, sv) in open_notes.items():
        end_tick = max((e[0] for e in raw_notes), default=st)
        if end_tick > st:
            notes.append(MidiNote(pitch, sv, conv(st), conv(end_tick)))
    notes.sort(key=lambda n: (n.start, n.pitch))

    tempo_changes = [(conv(t), bpm) for t, bpm in tempo_ticks]
    tsigs = [(conv(t), n, d) for t, n, d in sorted(tsig_ticks)]
    end_time = max((n.end for n in notes), default=0.0)
    return MidiData(notes, tempo_changes, tsigs, division, end_time)


def write_midi(md: MidiData, path: str) -> None:
    """Write a format-0 SMF with the tempo map and all notes."""
    division = md.resolution
    tempos = sorted(md.tempo_changes) or [(0.0, 120.0)]

    def time_to_tick(t: float) -> int:
        tick = 0.0
        for i in range(len(tempos)):
            seg_start = tempos[i][0]
            seg_end = tempos[i + 1][0] if i + 1 < len(tempos) else float("inf")
            if t <= seg_start:
                break
            dt = min(t, seg_end) - seg_start
            tick += dt * tempos[i][1] / 60.0 * division
        return int(round(tick))

    events = []                                    # (tick, order, bytes)
    for t, bpm in tempos:
        usec = int(round(60e6 / bpm))
        events.append((time_to_tick(t), 0,
                       bytes([0xFF, 0x51, 0x03]) + usec.to_bytes(3, "big")))
    for t, num, den in md.time_signatures:
        dd = max(0, (den.bit_length() - 1))
        events.append((time_to_tick(t), 0,
                       bytes([0xFF, 0x58, 0x04, num, dd, 24, 8])))
    for n in md.notes:
        events.append((time_to_tick(n.start), 1,
                       bytes([0x90, n.pitch & 0x7F, max(1, min(127, n.velocity))])))
        events.append((time_to_tick(n.end), 1,
                       bytes([0x80, n.pitch & 0x7F, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    last_tick = 0
    for tick, _, payload in events:
        track += _write_varlen(tick - last_tick)
        track += payload
        last_tick = tick
    track += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, division))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))
