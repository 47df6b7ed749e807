"""PyTorch port, the host-side tokenizer and corpora
(`music_fader_nets_tpu_torch/tokenizer/`, `data/synthetic.py`,
`data/corpus.py`): each copied function against the JAX package's on seeded
random note lists, rolls and token rows. Everything here is integer or
float64 arithmetic in the same order, so the comparisons are exact. The JAX
package may dispatch to its native C++ tokenizer where that is built; it is
bit-identical to the pure-Python path the port copies."""
import numpy as np
import pytest

from music_fader_nets_tpu.data import corpus as j_corpus
from music_fader_nets_tpu.data import synthetic as j_synth
from music_fader_nets_tpu.tokenizer import attributes as j_attr
from music_fader_nets_tpu.tokenizer import event_codec as j_events
from music_fader_nets_tpu.tokenizer import key_estimate as j_key
from music_fader_nets_tpu.tokenizer import midi_io as j_midi
from music_fader_nets_tpu.tokenizer import performance_codec as j_perf
from music_fader_nets_tpu.tokenizer import pianoroll as j_roll
from music_fader_nets_tpu.tokenizer import pipeline as j_pipe
from music_fader_nets_tpu_torch.data import corpus, synthetic
from music_fader_nets_tpu_torch.tokenizer import (
    attributes, event_codec, key_estimate, midi_io, performance_codec,
    pianoroll, pipeline,
)


def _notes(seed, n=40, span=6.0):
    """The same random note list for both packages: (port's, JAX's)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        start = float(rng.uniform(0, span))
        rows.append((int(rng.integers(15, 115)), int(rng.integers(1, 128)),
                     start, start + float(rng.uniform(0.02, 1.5))))
    return ([midi_io.MidiNote(*r) for r in rows],
            [j_midi.MidiNote(*r) for r in rows])


def _as_rows(notes):
    return [(n.pitch, n.velocity, n.start, n.end) for n in notes]


def _roll(seed, T=32):
    rng = np.random.default_rng(seed)
    pr = np.zeros((T, 128), np.uint8)
    for _ in range(3 * T):
        t, d = int(rng.integers(0, T)), int(rng.integers(1, 5))
        pr[t:t + d, int(rng.integers(30, 90))] = int(rng.integers(1, 128))
    return pr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_performance_codec_round_trip_matches(seed):
    mine, theirs = _notes(seed)
    for eos in (False, True):
        assert performance_codec.performance_encode(mine, add_eos=eos) == \
            j_perf.performance_encode(theirs, add_eos=eos)
    toks = performance_codec.performance_encode(mine)
    assert min(toks) >= 2 and max(toks) < performance_codec.EVENT_DIMS
    assert _as_rows(performance_codec.performance_decode(toks)) == \
        _as_rows(j_perf.performance_decode(toks))
    # arbitrary rows, malformed ones included, decode the same
    rng = np.random.default_rng(seed + 10)
    rows = rng.integers(0, 342, size=(5, 80))
    for row in rows:
        assert _as_rows(performance_codec.performance_decode(row)) == \
            _as_rows(j_perf.performance_decode(row))
    for t in (0, 1, 2, 90, 178, 278, 341, 400):
        assert performance_codec.token_role(t) == j_perf.token_role(t)


@pytest.mark.parametrize("seed", [3, 4])
def test_pianoroll_attributes_and_events_match(seed):
    mine, theirs = _notes(seed)
    md = midi_io.MidiData(mine, [(0.0, 120.0), (2.0, 90.0)], [(0.0, 4, 4)])
    j_md = j_midi.MidiData(theirs, [(0.0, 120.0), (2.0, 90.0)],
                           [(0.0, 4, 4)])
    assert md.get_beats(0.0) == j_md.get_beats(0.0)
    pr = pianoroll.quantize_pianoroll(md)
    np.testing.assert_array_equal(pr, j_roll.quantize_pianoroll(j_md))
    assert pr.any()
    for roll in (pr, _roll(seed)):
        got = attributes.get_music_attributes(roll)
        want = j_attr.get_music_attributes(roll)
        assert list(got[0]) == list(want[0])          # events
        assert list(got[1]) == list(want[1])          # rhythm
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)
        events = got[0]
        for a, b in zip(event_codec.decode_events(events),
                        j_events.decode_events(events)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        np.testing.assert_array_equal(event_codec.decode_events(events)[0],
                                      roll)           # the codec's contract
        assert attributes.rhythm_density(got[1]) == \
            j_attr.rhythm_density(want[1])
        assert attributes.note_density_mean(got[2]) == \
            j_attr.note_density_mean(want[2])


@pytest.mark.parametrize("seed", [5, 6])
def test_key_estimate_matches(seed):
    mine, theirs = _notes(seed)
    for one_hot in (False, True):
        np.testing.assert_array_equal(
            key_estimate.harmony_vector_from_notes(mine, one_hot),
            j_key.harmony_vector_from_notes(theirs, one_hot))
    roll = _roll(seed)
    np.testing.assert_array_equal(
        key_estimate.harmony_vector_from_pianoroll(roll),
        j_key.harmony_vector_from_pianoroll(roll))
    assert key_estimate.harmony_vector_from_notes([]) is None


def test_pipeline_functions_match():
    rows, _, _, _ = j_synth.synth_corpus(12, 60, 8, seed=11)
    for row in rows:
        got = pipeline.attributes_from_tokens(row)
        want = j_pipe.attributes_from_tokens(row)
        assert got is not None
        assert list(got[0]) == list(want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert pipeline.attributes_from_tokens([0, 1, 0]) is None
    rng = np.random.default_rng(12)
    noise_rows = rng.integers(0, 342, size=(6, 50))
    for row in noise_rows:
        got = pipeline.attributes_from_tokens(row)
        want = j_pipe.attributes_from_tokens(row)
        assert (got is None) == (want is None)
        if got is not None:
            assert list(got[0]) == list(want[0])
            np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(pipeline.chroma_from_token_rows(rows),
                                  j_pipe.chroma_from_token_rows(rows))
    mine, theirs = _notes(13)
    md = midi_io.MidiData(mine, [(0.0, 120.0)], [])
    j_md = j_midi.MidiData(theirs, [(0.0, 120.0)], [])
    assert _as_rows(pipeline.slice_notes(md, 1.0, 3.0)) == \
        _as_rows(j_pipe.slice_notes(j_md, 1.0, 3.0))


def test_midi_files_and_corpus_build_match(tmp_path):
    """A MIDI file written by the port reads back the same through both
    readers, and `build_corpus` over it gives the JAX package's arrays."""
    files = []
    for i in range(2):
        rng = np.random.default_rng(20 + i)
        notes = []
        for step in range(0, 64, 2):
            p = rng.choice([60, 62, 64, 65, 67, 69, 71])
            notes.append(midi_io.MidiNote(
                int(p), int(rng.integers(40, 110)), step * 0.125,
                (step + 2) * 0.125))
        md = midi_io.MidiData(notes, [(0.0, 120.0)], [(0.0, 4, 4)],
                              end_time=8.0)
        path = str(tmp_path / f"song{i}.mid")
        midi_io.write_midi(md, path)
        files.append(path)
        a, b = midi_io.read_midi(path), j_midi.read_midi(path)
        assert _as_rows(a.notes) == _as_rows(b.notes) and len(a.notes) == 32
        assert a.tempo_changes == b.tempo_changes
        assert a.time_signatures == b.time_signatures
    got = pipeline.build_corpus(files, n_workers=1)
    want = j_pipe.build_corpus(files, n_workers=1)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_synthetic_corpora_match():
    for a, b in zip(synthetic.synth_corpus(48, 60, 8, seed=3),
                    j_synth.synth_corpus(48, 60, 8, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.synth_vgmidi(24, seed=4),
                    j_synth.synth_vgmidi(24, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.synth_vgmidi_ragged(10, seed=5),
                    j_synth.synth_vgmidi_ragged(10, seed=5)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_corpus_loaders_match(tmp_path):
    """`get_classic_piano`: the synthetic fallback with its provenance, and
    a cache hit with the chroma sanitization; `get_vgmidi`'s fallback."""
    got = corpus.get_classic_piano(cache_dir=str(tmp_path / "none"),
                                   n_synthetic=32, return_source=True)
    want = j_corpus.get_classic_piano(cache_dir=str(tmp_path / "none"),
                                      n_synthetic=32, return_source=True)
    assert got[-1] == want[-1] == "synthetic"
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    cache = tmp_path / "cache"
    cache.mkdir()
    data, rhythm, note, chroma = (np.array(a, copy=True) for a in got[:-1])
    chroma[0] = 0.0                       # an all-zero row is dropped
    chroma[1] = np.linspace(0.1, 1.0, 24)  # more than 3 bins: top-3 kept
    for name, arr in (("data", data), ("rhythm", rhythm),
                      ("note_density", note), ("chroma", chroma)):
        np.save(cache / f"{name}.npy", arr)
    got = corpus.get_classic_piano(cache_dir=str(cache), return_source=True)
    want = j_corpus.get_classic_piano(cache_dir=str(cache),
                                      return_source=True)
    assert got[-1] == want[-1] == "cache" and len(got[0]) == 31
    assert np.count_nonzero(got[3][0]) == 3
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        corpus.get_classic_piano(cache_dir=str(tmp_path / "none"),
                                 synthetic_fallback=False)
    for a, b in zip(corpus.get_vgmidi(str(tmp_path / "none"), n_synthetic=16),
                    j_corpus.get_vgmidi(str(tmp_path / "none"),
                                        n_synthetic=16)):
        np.testing.assert_array_equal(a, b)
