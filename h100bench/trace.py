"""The traced stretch of a `--trace 1` run: CUPTI's CUDA activity only, over
a bounded stretch in the middle of the window, started and stopped on the
main thread, its events read in memory once the program's threads have
stopped. No Chrome trace is written.

`busy_us` is a frozen copy of `serve/profile.py::_busy_us` (the union of
the device intervals, overlaps counted once); `summary`'s time by name and
the readers' per-step arithmetic follow `train/profile.py`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# (name, start us, end us) of one device activity
Event = Tuple[str, float, float]


def busy_us(events: List[Event]) -> float:
    """Union length of the events' intervals (overlaps counted once)."""
    spans = sorted((s, e) for _, s, e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def is_launch(name: str) -> bool:
    """A kernel or a memset: what a wrapper launches (copies are not)."""
    return not name.startswith("Memcpy")


class Stretch:
    """One profiled stretch. On a CPU device it records nothing, so the
    device metrics read nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._prof = None
        self.wall_s: Optional[float] = None
        self._t0 = None

    def warm(self, fn) -> None:
        """Start and stop the profiler once around `fn` in set-up. CUPTI's
        first start takes seconds; its cost a launch stays after it
        (PERF.md, section 6)."""
        if not self.cuda:
            fn()
            return
        prof = _profiler()
        prof.start()
        fn()
        torch.cuda.synchronize()
        prof.stop()

    def start(self) -> None:
        if self.cuda:
            self._prof = _profiler()
            self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.wall_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.stop()

    def events(self) -> List[Event]:
        """The device activities of the stretch (kernels, memsets,
        copies), read from the profiler's results in memory."""
        if self._prof is None:
            return []
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                s, d = float(e.start_us()), float(e.duration_us())
            out.append((e.name(), s, s + d))
        self._prof = None
        return out


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def summary(events: List[Event], wall_s: float) -> Dict:
    """What the readers take from a stretch: the busy seconds, the
    launches, the device time by name and the longest idle gaps."""
    busy = busy_us(events) / 1e6
    by_name: Dict[str, float] = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    ordered = sorted(events, key=lambda ev: ev[1])
    end, last = None, None
    for name, s, e in ordered:
        if end is not None and s > end:
            gaps.append((f"after {last[:60]} / before {name[:60]}",
                         (s - end) / 1e6))
        if end is None or e > end:
            end, last = e, name
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy, "wall_s": wall_s,
            "launches": sum(is_launch(n) for n, _, _ in events),
            "events": len(events),
            "device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:10]]}
