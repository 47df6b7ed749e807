"""The program's own spans in a `--trace 1` run (`utils/profiling.py` of the
port), put on the device trace's clock.

`ProgramSpans` turns the recorder on for the window, and at the start of
the traced stretch reads one pair of clocks (`perf_counter_ns`, the spans'
clock, and `time_ns`, the Unix clock that the profiler's events are read
in) and launches one marker kernel inside a `bench.marker` span on the
main thread. `clock_gap_us` proves the mapping: the CUDA runtime call of
that launch, which CUPTI stamps on the host, has to lie inside the mapped
span widened by 50 us. `idle_by_span` puts each idle interval of the
stretch (the complement of the device activity's union, as `busy_us`
computes it, inside the stretch's mapped ends) down to the innermost open
span of each program thread, sliced where those spans change.
`complete` adds what the readers read to a cell's record: the durations
of the spans that ended before the stretch (CUPTI off), and the clock gap
and the attribution of the stretch.

With a program that has no recorder (an older checkout), nothing is
recorded, and every reader of the spans reads None.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MARKER = "bench.marker"
# the marker's kernel: `torch.cuda._sleep`'s, a name no program op has
MARKER_KERNEL = "spin_kernel"
MARKER_CYCLES = 1000
WIDEN_US = 50.0
# the program's threads, by their names, as an attribution label names them
THREADS = {"fader-serve-dispatch": "dispatch", "fader-serve-fetch": "fetch",
           "MainThread": "main"}
LABEL_CHARS = 63


def program():
    """The port's profiling module, or None where it has no recorder."""
    try:
        from music_fader_nets_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "SPANS") else None


class ProgramSpans:
    """The program's spans over one run's window: made in set-up, `enable()`
    at the window's start, `start()` right after the stretch's profiler
    started, `stop()` right before it stops, `drain()` once the program's
    threads are joined or after the last synchronise."""

    def __init__(self, device: torch.device, capacity: int = 1 << 20):
        self.mod = program()
        self.cuda = device.type == "cuda"
        self.capacity = capacity
        self.offset_ns: Optional[int] = None
        self.stretch_ns: List[int] = []
        if self.cuda:
            # the marker kernel's module loads at its first launch (ms):
            # here, so that the marker's span is a launch long
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize(device)

    def enable(self) -> None:
        if self.mod is not None:
            self.mod.enable(self.capacity)

    def start(self) -> None:
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        self.offset_ns = unix - (a + b) // 2
        self.stretch_ns = [a]
        if self.mod is None:
            return
        rec = self.mod.SPANS
        with rec.span(rec.name(MARKER)):
            if self.cuda:
                torch.cuda._sleep(MARKER_CYCLES)

    def stop(self) -> None:
        self.stretch_ns.append(time.perf_counter_ns())

    def drain(self) -> Optional[Dict]:
        if self.mod is None:
            return None
        self.mod.disable()
        return self.mod.drain()


def clock_marks(kineto_events) -> Dict:
    """What the marker check reads of a profile's events (`kineto_results.
    events()`): the marker kernels' correlation ids, and every CUDA
    runtime call's (start us, end us) by correlation id."""
    kernels, runtime = [], {}
    for e in kineto_events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if MARKER_KERNEL in name:
                kernels.append(e.correlation_id())
        elif name.startswith("cuda"):
            s = e.start_ns() / 1e3
            runtime[e.correlation_id()] = (s, s + e.duration_ns() / 1e3)
    return {"marker_kernels": kernels, "runtime": runtime}


def without_marker(events: List) -> List:
    """The device events less the marker's kernel, so that the stretch's
    launches and device time are the program's alone."""
    return [ev for ev in events if MARKER_KERNEL not in ev[0]]


def _rows(spans: Dict, name: str) -> np.ndarray:
    """The row indices of the closed spans called `name`."""
    if name not in spans["names"]:
        return np.zeros(0, dtype=np.int64)
    return np.nonzero((spans["name"] == spans["names"].index(name))
                      & (spans["t1"] > 0))[0]


def clock_gap_us(spans: Dict, marks: Dict, offset_ns: int) -> Optional[float]:
    """Microseconds from the `bench.marker` span's start, mapped onto the
    Unix clock by `offset_ns`, to the start of its kernel's runtime call;
    None unless the call lies inside the mapped span widened by WIDEN_US
    at each end (or when the span or the call is missing)."""
    rows = _rows(spans, MARKER)
    calls = [marks["runtime"][c] for c in marks["marker_kernels"]
             if c in marks["runtime"]]
    if len(rows) != 1 or len(calls) != 1:
        return None
    r = rows[0]
    m0 = (int(spans["t0"][r]) + offset_ns) / 1e3
    m1 = (int(spans["t1"][r]) + offset_ns) / 1e3
    s, e = calls[0]
    if s < m0 - WIDEN_US or e > m1 + WIDEN_US:
        return None
    return s - m0


def _gaps(events: List, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals inside [lo, hi]: its complement of the union of
    the events' intervals (us)."""
    out, cur = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in events
                       if e > lo and s < hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def _segments(spans: Dict, lo: float, hi: float, offset_ns: int
              ) -> List[Tuple[float, float, str]]:
    """[lo, hi] (us, Unix clock) cut where any program thread's innermost
    open span changes: (start, end, label), the label each thread's
    `thread:span` joined by '|' or 'none'. A request's waits (thread -1)
    belong to no thread; a span still open ends at hi."""
    t0 = (spans["t0"] + offset_ns) / 1e3
    t1 = np.where(spans["t1"] > 0, (spans["t1"] + offset_ns) / 1e3, hi)
    keep = np.nonzero((spans["thread"] >= 0) & (t1 > lo) & (t0 < hi))[0]
    # (time, 0 = end before 1 = start, row)
    marks = sorted([(float(t1[r]), 0, int(r)) for r in keep]
                   + [(float(t0[r]), 1, int(r)) for r in keep])
    labels = {k: THREADS.get(v, v) for k, v in spans["threads"].items()}
    names = spans["names"]
    open_: Dict[int, List[int]] = {}
    out, cur = [], lo

    def label() -> str:
        parts = []
        for th in sorted(open_, key=lambda k: labels.get(k, str(k))):
            rows = open_[th]
            if rows:
                inner = max(rows, key=lambda r: (spans["t0"][r], r))
                parts.append(f"{labels.get(th, th)}:"
                             f"{names[spans['name'][inner]]}")
        return "|".join(parts)[:LABEL_CHARS] or "none"

    for t, kind, r in marks:
        t = min(max(t, lo), hi)
        if t > cur:
            out.append((cur, t, label()))
            cur = t
        rows = open_.setdefault(int(spans["thread"][r]), [])
        if kind:
            rows.append(r)
        elif r in rows:
            rows.remove(r)
    if hi > cur:
        out.append((cur, hi, label()))
    return out


def idle_by_span(spans: Dict, events: List, window_ns: List[int],
                 offset_ns: int) -> List[List]:
    """Every idle second of the stretch (`window_ns`, the spans' clock),
    put down to what the program's threads were inside: [[label,
    seconds]], largest first; the seconds sum to the stretch's idle
    time."""
    lo, hi = ((t + offset_ns) / 1e3 for t in window_ns)
    segs = _segments(spans, lo, hi, offset_ns)
    out: Dict[str, float] = {}
    i = 0
    for g0, g1 in _gaps(events, lo, hi):
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            s, e, lab = segs[j]
            d = min(e, g1) - max(s, g0)
            if d > 0:
                out[lab] = out.get(lab, 0.0) + d / 1e6
            j += 1
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]


def durations_ms(spans: Dict, before_ns: int, cpu: bool = False
                 ) -> Dict[str, List[float]]:
    """The ms of every closed span that ended before `before_ns`, by name:
    wall time, or with `cpu` its thread's CPU time (the spans that record
    it)."""
    a, b = ("c0", "c1") if cpu else ("t0", "t1")
    out = {}
    for k, name in enumerate(spans["names"]):
        rows = np.nonzero((spans["name"] == k) & (spans["t1"] > 0)
                          & (spans["t1"] <= before_ns) & (spans[a] >= 0))[0]
        if len(rows):
            out[name] = ((spans[b][rows] - spans[a][rows]) / 1e6).tolist()
    return out


def complete(rec: Dict, ps: ProgramSpans, spans: Optional[Dict],
             events: List, marks: Dict) -> None:
    """Add the spans' readings to a traced run's record: `rec["spans"]`
    (wall and CPU durations before the stretch, and the spans dropped)
    and, in
    `rec["trace"]`, `clock_gap_us`, the whole `idle_attribution` and its
    10 largest entries as `idle_by_span` (None when the clock check
    failed)."""
    if spans is None or len(ps.stretch_ns) != 2:
        return
    rec["spans"] = {"before": durations_ms(spans, ps.stretch_ns[0]),
                    "cpu_before": durations_ms(spans, ps.stretch_ns[0], True),
                    "dropped": int(spans["dropped"])}
    gap = clock_gap_us(spans, marks, ps.offset_ns)
    whole = None if gap is None else idle_by_span(
        spans, events, ps.stretch_ns, ps.offset_ns)
    rec["trace"].update(clock_gap_us=gap, idle_attribution=whole,
                        idle_by_span=None if whole is None else whole[:10])
