"""Dependency-free audio preview: render decoded notes to a WAV file (own
copy of `music_fader_nets_tpu/transfer/audio.py`).

The reference previews arousal-transfer output through pyfluidsynth + a
SoundFont (`arousal_transfer.ipynb` cell 2, `IPython.display.Audio`).
fluidsynth is a C synthesizer pip dependency; here the preview is a small
vectorized NumPy additive synth (damped harmonic stack per note, roughly
piano-shaped) written with the stdlib `wave` module — zero dependencies,
host-side only (preview is not a compute-path concern).

Public surface:
    render_notes(notes, sample_rate=22050) -> float32 mono [-1, 1]
    write_wav(path, audio, sample_rate=22050)
    notes_to_wav(notes, path)  -- one-call convenience used by the CLI
"""
from __future__ import annotations

import wave
from typing import Iterable, List, Sequence

import numpy as np

from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote

# Harmonic stack amplitudes: fundamental + 5 overtones, 1/h^1.7 rolloff
# (bright enough to read as a piano without ringing like an organ).
_HARMONICS = np.arange(1, 7, dtype=np.float64)
_H_AMPS = 1.0 / _HARMONICS ** 1.7
_RELEASE_S = 0.12       # post-note-off tail
_ATTACK_S = 0.004       # click-free onset ramp


def _midi_hz(pitch: int) -> float:
    return 440.0 * 2.0 ** ((pitch - 69) / 12.0)


def render_notes(notes: Sequence[MidiNote], sample_rate: int = 22050,
                 gain: float = 0.85) -> np.ndarray:
    """Mix every note into one mono float32 buffer.

    Each note is a damped harmonic stack: amplitude ~ velocity/127,
    per-harmonic exponential decay whose time constant shrinks with pitch
    and harmonic index (high notes and high partials die faster, as on a
    real string). The result is peak-normalized to `gain` only if it
    would otherwise clip, so relative dynamics survive.
    """
    notes = [n for n in notes
             if n.end > n.start >= 0 and 0 <= n.pitch < 128]
    if not notes:
        return np.zeros(int(0.25 * sample_rate), dtype=np.float32)
    end_time = max(n.end for n in notes) + _RELEASE_S
    out = np.zeros(int(np.ceil(end_time * sample_rate)) + 1, dtype=np.float64)
    for n in notes:
        dur = (n.end - n.start) + _RELEASE_S
        m = int(dur * sample_rate)
        if m <= 0:
            continue
        t = np.arange(m, dtype=np.float64) / sample_rate
        f0 = _midi_hz(n.pitch)
        # piano-ish decay: ~2.5s at C2 down to ~0.3s at C7
        tau = np.clip(8.0 * (55.0 / f0) ** 0.8, 0.25, 3.0)
        # (H, m) phase matrix; drop harmonics above Nyquist
        freqs = f0 * _HARMONICS
        keep = freqs < 0.45 * sample_rate
        if not keep.any():
            continue
        phases = 2 * np.pi * freqs[keep, None] * t[None, :]
        decays = np.exp(-t[None, :] * (_HARMONICS[keep, None] / tau))
        voice = (_H_AMPS[keep, None] * decays * np.sin(phases)).sum(axis=0)
        # onset ramp + release fade (linear, short)
        a = min(int(_ATTACK_S * sample_rate), m)
        if a > 0:
            voice[:a] *= np.linspace(0.0, 1.0, a)
        r = min(int(_RELEASE_S * sample_rate), m)
        if r > 0:
            voice[-r:] *= np.linspace(1.0, 0.0, r)
        amp = (max(n.velocity, 1) / 127.0) ** 1.5 * 0.22
        i0 = int(n.start * sample_rate)
        out[i0:i0 + m] += amp * voice
    peak = np.abs(out).max()
    if peak > gain:
        out *= gain / peak
    return out.astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 22050) -> None:
    """16-bit PCM mono WAV via the stdlib `wave` module."""
    pcm = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def notes_to_wav(notes: Iterable[MidiNote], path: str,
                 sample_rate: int = 22050) -> np.ndarray:
    """Render + write in one call (the CLI `--wav` path); returns the
    audio buffer so callers/tests can inspect it."""
    audio = render_notes(list(notes), sample_rate)
    write_wav(path, audio, sample_rate)
    return audio
