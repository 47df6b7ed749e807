"""PyTorch port, the rest of the tokenizer: the reference-API compat layer
(`tokenizer/compat.py`) and the VGMIDI annotation filtering
(`data/vgmidi_labels.py`) against the JAX package on the same inputs
(the cases of tests/test_compat.py and tests/test_aux.py), and the port's
native codec (`native/`) bit-identical to its pure-Python path on
tests/test_native.py's random inputs, with `PATH` saying which path
served, `FADERNETS_NO_NATIVE=1` selecting Python, concurrent builds ending
in one build, and a failed build raising. All exact."""
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from music_fader_nets_tpu.data import vgmidi_labels as j_labels
from music_fader_nets_tpu.tokenizer import compat as j_compat
from music_fader_nets_tpu_torch import native
from music_fader_nets_tpu_torch.data import vgmidi_labels as t_labels
from music_fader_nets_tpu_torch.tokenizer import compat as t_compat
from music_fader_nets_tpu_torch.tokenizer import (
    event_codec, performance_codec,
)
from music_fader_nets_tpu_torch.tokenizer.midi_io import (
    MidiData, MidiNote, write_midi,
)

REPO = Path(__file__).resolve().parent.parent


def _demo_midi(tmp_path):
    notes = [MidiNote(60 + (i % 12), 80, i * 0.25, i * 0.25 + 0.25)
             for i in range(32)]
    md = MidiData(notes, [(0.0, 120.0)], [(0.0, 4, 4)], end_time=8.0)
    p = str(tmp_path / "demo.mid")
    write_midi(md, p)
    return p, md


def _notes(md):
    return [(n.pitch, n.velocity, n.start, n.end) for n in md.notes]


def _same(a, b):
    """Equal, recursing into tuples and lists; arrays bit for bit."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("case", ["magenta", "encode_midi", "slice_harmony"])
def test_compat_matches_jax(tmp_path, case):
    """The three cases of tests/test_compat.py, each output equal to the
    JAX package's on the same MIDI file."""
    p, md = _demo_midi(tmp_path)
    if case == "magenta":
        toks = t_compat.magenta_encode_midi(p, is_eos=True)
        assert toks == j_compat.magenta_encode_midi(p, is_eos=True)
        assert toks[-1] == 1 and all(0 <= t < 342 for t in toks)
        back = t_compat.magenta_decode_midi(toks)
        assert _notes(back) == _notes(j_compat.magenta_decode_midi(toks))
        assert len(back.notes) == len(md.notes)
    elif case == "encode_midi":
        got = t_compat.encode_midi(p, beat=4)
        _same(got, j_compat.encode_midi(p, beat=4))
        events, pitch_lst, _, pr, rhythm = got
        assert pr.shape[1] == 128 and len(rhythm) == len(pitch_lst)
        _same(t_compat.decode_events(events), j_compat.decode_events(events))
        _same(t_compat.encode_midi(pr, is_pr=True),
              j_compat.encode_midi(pr, is_pr=True))
    else:
        beats = md.get_beats(0.0)
        seg = t_compat.slice_midi(md, beats, 0, 4,
                                  out_path=str(tmp_path / "seg.mid"))
        want = j_compat.slice_midi(md, beats, 0, 4)
        assert _notes(seg) == _notes(want) and len(seg.notes) > 0
        assert seg.end_time == want.end_time
        assert (tmp_path / "seg.mid").stat().st_size > 0
        _same(t_compat.get_harmony_vector(fname=p),
              j_compat.get_harmony_vector(fname=p))
        v2 = t_compat.get_harmony_vector(notes=md.notes, is_one_hot=True)
        _same(v2, j_compat.get_harmony_vector(notes=md.notes,
                                              is_one_hot=True))
        assert v2.sum() == 1.0
        with pytest.raises(TypeError):
            t_compat.get_harmony_vector()


def test_vgmidi_labels_match_jax():
    """The cases of tests/test_aux.py: DTW distance, the outlier-cluster
    filter and the annotator averaging, equal to the JAX package's."""
    a = np.array([0.0, 1, 2, 3])
    b = np.array([0.0, 0, 1, 2])
    assert t_labels.dtw_distance(a, a) == 0.0
    assert t_labels.dtw_distance(a, b) == j_labels.dtw_distance(a, b)
    assert t_labels.dtw_distance(a, b) < np.linalg.norm(a - b)

    rng = np.random.default_rng(0)
    T = 20
    base = np.sin(np.linspace(0, 3, T))
    arousal = np.concatenate([base + rng.normal(0, 0.01, (6, T)),
                              base + 2 + rng.normal(0, 0.01, (3, T)),
                              rng.normal(0, 3.0, (4, T))])
    valence = rng.normal(0, 1, arousal.shape)
    np.testing.assert_array_equal(
        t_labels.dtw_kmeans(arousal, k=3, seed=0),
        j_labels.dtw_kmeans(arousal, k=3, seed=0))
    got = t_labels.filter_annotations(arousal, valence, seed=0)
    _same(got, j_labels.filter_annotations(arousal, valence, seed=0))
    assert np.abs(got[0] - base).mean() < 0.5

    rng = np.random.default_rng(1)
    av = {f"song_{i}": {"musicianship": 5 if i <= 20 else 1,
                        "arousal": (np.ones(10) * (i % 3)).tolist(),
                        "valence": rng.normal(0, 1, 10).tolist()}
          for i in range(1, 31)}
    got = t_labels.get_average_av_values(av, "song")
    _same(got, j_labels.get_average_av_values(av, "song"))
    assert got[0].shape == (10,)
    assert t_labels.get_average_av_values({}, "nope") is None
    _same(t_labels.filter_annotations(arousal[:2], valence[:2]),
          j_labels.filter_annotations(arousal[:2], valence[:2]))


def _random_notes(rng, n=50):
    notes, t = [], 0.0
    for _ in range(n):
        t += float(rng.random() * 0.3)
        notes.append(MidiNote(int(rng.integers(21, 109)),
                              int(rng.integers(1, 128)),
                              t, t + float(rng.random() * 1.5) + 0.01))
    return notes


def _random_pr(rng, T=40):
    pr = np.zeros((T, 128), np.int64)
    for t in range(T):
        for p in rng.choice(np.arange(1, 128), size=rng.integers(0, 5),
                            replace=False):
            pr[t: t + int(rng.integers(1, 4)), p] = int(rng.integers(1, 128))
    return pr


def _both(monkeypatch, fn):
    """fn() on the native path, then on the pure-Python path; each call
    checked to have been served by the path asked for."""
    monkeypatch.setattr(native, "HAVE_NATIVE", True)
    got = fn()
    assert native.PATH == "native"
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    ref = fn()
    assert native.PATH == "python"
    return got, ref


@pytest.mark.parametrize("site", ["perf_encode", "perf_decode",
                                  "encode_pianoroll"])
def test_native_bit_identical_to_python(monkeypatch, site):
    """The three dispatch sites on tests/test_native.py's random inputs:
    the native output equals the pure-Python one exactly (tokens, note
    times as floats, events)."""
    rng = np.random.default_rng({"perf_encode": 0, "perf_decode": 1,
                                 "encode_pianoroll": 2}[site])
    for trial in range(10):
        if site == "perf_encode":
            notes = _random_notes(rng)
            for eos in (True, False):
                got, ref = _both(monkeypatch, lambda: performance_codec
                                 .performance_encode(notes, add_eos=eos))
                assert got == ref, trial
        elif site == "perf_decode":
            toks = performance_codec.performance_encode(_random_notes(rng))
            toks = toks + [int(t) for t in rng.integers(0, 345, 20)]
            got, ref = _both(monkeypatch, lambda: performance_codec
                             .performance_decode(toks))
            assert [(n.pitch, n.velocity, n.start, n.end) for n in got] == \
                [(n.pitch, n.velocity, n.start, n.end) for n in ref], trial
        else:
            pr = _random_pr(rng)
            got, ref = _both(monkeypatch,
                             lambda: event_codec.encode_pianoroll(pr))
            _same(got, ref)
            back, _, _ = event_codec.decode_events(got[0])
            out = np.zeros_like(pr)
            out[: back.shape[0]] = back[: pr.shape[0]]
            np.testing.assert_array_equal(pr, out)
    # an empty note list, which the native encoder does not take, goes
    # the Python way
    monkeypatch.setattr(native, "HAVE_NATIVE", True)
    assert performance_codec.performance_encode([], add_eos=True) == [1]
    assert native.PATH == "python"


def test_native_switch_and_build_dir(monkeypatch):
    """FADERNETS_NO_NATIVE=1 at import selects Python; unset, the native
    module is built (or found) under build/torch_native/<hash>/ and
    loaded under the port's own name, never the JAX package's build."""
    monkeypatch.setenv("FADERNETS_NO_NATIVE", "1")
    importlib.reload(native)
    try:
        assert native.HAVE_NATIVE is False
        notes = _random_notes(np.random.default_rng(3), n=5)
        performance_codec.performance_encode(notes)
        assert native.PATH == "python"
    finally:
        monkeypatch.delenv("FADERNETS_NO_NATIVE")
        importlib.reload(native)
    assert native.HAVE_NATIVE is True
    mod = native.fadertok()
    assert mod.__name__ == native.MODULE
    path = Path(mod.__file__)
    assert path.parent == native.build_dir()
    assert path.parent.parent == REPO / "build" / "torch_native"
    assert "music_fader_nets_tpu/" not in str(path)


def test_native_concurrent_builds_end_in_one(tmp_path):
    """Three processes building into an empty build root at once all load
    a working module, and one build directory is left (no temporary
    directory behind)."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from music_fader_nets_tpu_torch import native\n"
        "native.BUILD_ROOT = Path(sys.argv[1])\n"
        "m = native.fadertok()\n"
        "import numpy as np\n"
        "print(m.perf_encode(np.array([60], np.int64), np.array([80], "
        "np.int64), np.array([0.0]), np.array([0.5]), 1).tolist())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert len({o for o, _ in outs}) == 1
    assert len(list(tmp_path.iterdir())) == 1


def test_native_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing is left in the build root."""
    bad = tmp_path / "fadertok.cc"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    root = tmp_path / "root"
    monkeypatch.setattr(native, "BUILD_ROOT", root)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native._build(native.build_dir())
    assert list(root.iterdir()) == []
