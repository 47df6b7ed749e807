"""The device launch counts that chip_smoke.py holds the persistent kernels
to (`device_launches`) and that the split tools print (`train/bwd_split.py::
kernel_split`), on the CPU under a scripted profiler: a call counts only
the device events between two launches of the library's empty
`launch_probe` kernel, and a profile that lost a probe is taken again
(`device_launches` opens with a lead probe pair, so the loss of one lead
probe alone costs nothing)."""
from __future__ import annotations

import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from music_fader_nets_tpu_torch.train import bwd_split

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeProfile:
    """Stands in for `torch.profiler.profile`: its device events are the
    launches made while it is open, less those at the indices that the
    script gives the session (one set of indices per session, in order)."""

    script: list = []
    current = None
    sessions = 0

    def __init__(self, activities=None):
        self.launched = []

    def __enter__(self):
        FakeProfile.current = self
        FakeProfile.sessions += 1
        self.drop = FakeProfile.script.pop(0) if FakeProfile.script else set()
        return self

    def __exit__(self, *exc):
        FakeProfile.current = None
        return False

    def events(self):
        return [e for i, e in enumerate(self.launched) if i not in self.drop]


def launch(name: str) -> None:
    prof = FakeProfile.current
    if prof is not None:
        t = len(prof.launched)
        prof.launched.append(SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            time_range=SimpleNamespace(start=t, end=t + 1)))


@pytest.fixture
def profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setattr(bwd_split, "launch_probe",
                        lambda: launch(bwd_split.PROBE))
    FakeProfile.sessions = 0
    yield FakeProfile
    FakeProfile.script = []


def _call(*names):
    return lambda: [launch(n) for n in names]


# device_launches(calls=3) records P P m K P m K P m K P (indices 0-10):
# a lead probe pair, then each call closed by a probe
LAUNCH_CASES = {
    "complete": (("Memset", "gru_fwd_chain"), [set()], (1, 1, []), 1),
    "lost_first_probe": (("Memset", "gru_fwd_chain"), [{0}, set()],
                         (1, 1, []), 1),
    "lost_second_lead_probe": (("Memset", "gru_fwd_chain"), [{1}, set()],
                               (1, 1, []), 1),
    "lost_both_lead_probes": (("Memset", "gru_fwd_chain"), [{0, 1}, set()],
                              (1, 1, []), 2),
    "lost_leading_events": (("Memset", "gru_fwd_chain"), [{0, 1, 2}, set()],
                            (1, 1, []), 2),
    "lost_a_calls_kernel": (("Memset", "gru_fwd_chain"), [{6}],
                            (1, 1, []), 1),
    "lost_middle_probe": (("Memset", "gru_fwd_chain"), [{4}, set()],
                          (1, 1, []), 2),
    "lost_first_calls_events": (("Memset", "gru_fwd_chain"),
                                [{0, 2, 3}, set()], (1, 1, []), 2),
    "kernel_a_step": (("stacked_gru_step",) * 4, [set()],
                      (4, 0, ["stacked_gru_step"]), 1),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_device_launches_counts_between_probes(profiler, case):
    names, script, want, sessions = LAUNCH_CASES[case]
    profiler.script = [set(s) for s in script]
    assert _chip_smoke().device_launches(_call(*names)) == want
    assert profiler.sessions == sessions


def test_device_launches_raises_when_every_profile_loses_a_probe(profiler):
    # P P K P K P K P: each profile loses the probe after the first call
    profiler.script = [{3}] * 5
    with pytest.raises(RuntimeError, match="lost a probe"):
        _chip_smoke().device_launches(_call("gru_fwd_chain"))
    assert profiler.sessions == 5


# kernel_split(reps=3) records P K m K m K m P (indices 0-7)
@pytest.mark.parametrize("script,sessions", [([set()], 1),
                                             ([{0}, set()], 2),
                                             ([{7}, {0, 7}, set()], 3)])
def test_kernel_split_counts_between_probes(profiler, script, sessions):
    profiler.script = [set(s) for s in script]
    split, launches = bwd_split.kernel_split(_call("gru_bwd_chain", "Memset"))
    assert launches == 2
    assert split["chain"] == pytest.approx(1e-3)
    assert split["other"] == pytest.approx(1e-3)
    assert profiler.sessions == sessions


def test_kernel_split_raises_when_every_profile_loses_a_probe(profiler):
    profiler.script = [{0}] * 4
    with pytest.raises(RuntimeError, match="lost a probe"):
        bwd_split.kernel_split(_call("gru_bwd_chain"))
