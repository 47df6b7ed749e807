"""Profiling helpers (counterpart of `music_fader_nets_tpu/utils/
profiling.py`): a `torch.profiler` trace of a block, written as a Chrome
trace, and a host-clock step timer that waits for the card before it
reads the clock (a CUDA call returns before its work is done).

Beyond the counterpart: `SPANS`, the program's in-memory span recorder,
which the server and the Trainer write to and `enable()`, `disable()` and
`drain()` drive. Off by default; a span site then costs one flag test.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from array import array
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profiler_trace(log_dir: str = "log/trace"):
    """Profile a block (host and, where a card is in use, CUDA activity,
    as `train/profile.py` does) and write `<log_dir>/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto):
        with profiler_trace(): trainer.run_epoch(...)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates host-observed step durations. `stop()` first waits for
    all work queued on the card (when CUDA is in use), so a step's time
    includes its device work."""

    def __init__(self):
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self.times)
        if len(t) == 0:
            return {}
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "p90_s": float(np.percentile(t, 90)), "n": len(t)}


# the columns of a span, with their array typecodes: name id, thread index
# (-1: a request's wait, which belongs to no thread), parent, the id that
# links spans across threads, a small argument, start and end
# (`time.perf_counter_ns`), and the thread's CPU time at each end
# (`time.thread_time_ns`; -1 where the site does not ask for it)
_COLUMNS = (("name", "H"), ("thread", "h"), ("parent", "q"), ("link", "q"),
            ("arg", "q"), ("t0", "q"), ("t1", "q"), ("c0", "q"), ("c1", "q"))


class _Off:
    """The context of a span site while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "tok")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec.close(self.tok)
        return None


class SpanRecorder:
    """Spans of the program's host work, kept in flat `array` columns of a
    fixed capacity (no object per span for the collector to walk); spans
    beyond the capacity are counted as dropped, never raised on.

    A span's parent is the innermost span open on its thread when it
    opened. Sites use the name ids `name()` interns, `span()` (a context)
    or `open()` / `close()`, and `record()` for a span whose start was
    read earlier; every site tests `on` first, so that a recorder that is
    off reads no clock and allocates nothing."""

    def __init__(self):
        self.on = False
        self._names: Dict[str, int] = {}
        self._tokens = itertools.count()
        self._threads: Dict[int, str] = {}
        self._thread_ids = itertools.count()
        self._local = threading.local()
        # (first token, capacity, columns) of the buffer being written;
        # replaced whole, so a thread that read it writes one buffer
        self._buf = None

    def name(self, s: str) -> int:
        """The small int that stands for the span name `s`."""
        return self._names.setdefault(s, len(self._names))

    def enable(self, capacity: int = 1 << 18) -> None:
        """Record from now on into a fresh buffer of `capacity` spans."""
        self._buf = self._fresh(capacity)
        self.on = True

    def disable(self) -> None:
        """Stop opening spans; spans open now still close."""
        self.on = False

    def drain(self) -> Optional[Dict]:
        """What was recorded since `enable()` or the last drain, the
        recorder then writing into an empty buffer (of no capacity when it
        is off): {column: numpy array} (`parent` as the index of the
        parent's row, -1 for none; `t1` 0 for a span still open), `names`
        (by id), `threads` (index -> thread name) and `dropped`. None if
        it was never enabled."""
        buf = self._buf
        if buf is None:
            return None
        base, cap, cols = buf
        self._buf = self._fresh(cap if self.on else 0)
        total = self._buf[0] - base - 1
        n = min(total, cap)
        out = {k: np.array(cols[k][:n]) for k, _ in _COLUMNS}
        par = out["parent"] - base - 1
        out["parent"] = np.where((par >= 0) & (par < n), par, -1)
        out.update(names=sorted(self._names, key=self._names.get),
                   threads=dict(self._threads), dropped=total - n)
        return out

    def _fresh(self, cap: int):
        """A buffer of `cap` spans: (the token before its first, cap,
        columns)."""
        cols = {k: array(t, [0]) * cap for k, t in _COLUMNS}
        cols["c0"] = array("q", [-1]) * cap
        cols["c1"] = array("q", [-1]) * cap
        return next(self._tokens), cap, cols

    def _stack(self) -> List[int]:
        """This thread's open spans (tokens), registering the thread."""
        try:
            return self._local.stack
        except AttributeError:
            th = threading.current_thread()
            self._local.index = next(self._thread_ids)
            self._threads[self._local.index] = th.name
            self._local.stack = []
            return self._local.stack

    def _row(self, tok: int, name: int, thread: int, parent: int,
             link: int, arg: int, t0: int, c0: int):
        """Write a span's start at its token's row; its columns, or None
        when the token lies outside the buffer (dropped or stale)."""
        base, cap, cols = self._buf
        i = tok - base - 1
        if not 0 <= i < cap:
            return None
        cols["name"][i] = name
        cols["thread"][i] = thread
        cols["parent"][i] = parent
        cols["link"][i] = link
        cols["arg"][i] = arg
        cols["t0"][i] = t0
        cols["c0"][i] = c0
        return cols, i

    def open(self, name: int, link: int = -1, cpu: bool = False) -> int:
        """Open a span on this thread; returns its token for `close`."""
        st = self._stack()
        tok = next(self._tokens)
        self._row(tok, name, self._local.index, st[-1] if st else -1, link,
                  -1, time.perf_counter_ns(),
                  time.thread_time_ns() if cpu else -1)
        st.append(tok)
        return tok

    def close(self, tok: int) -> None:
        """Close the span `open` returned `tok` for (on the same thread)."""
        t1 = time.perf_counter_ns()
        st = self._stack()
        if tok in st:
            st.remove(tok)
        base, cap, cols = self._buf
        i = tok - base - 1
        if 0 <= i < cap:
            cols["t1"][i] = t1
            if cols["c0"][i] >= 0:
                cols["c1"][i] = time.thread_time_ns()

    def span(self, name: int, link: int = -1, cpu: bool = False):
        """`with SPANS.span(id, link):` a span around the block."""
        if not self.on:
            return _OFF
        o = _Open()
        o.rec, o.tok = self, self.open(name, link, cpu)
        return o

    def record(self, name: int, t0: int, c0: int = -1, link: int = -1,
               arg: int = -1, own: bool = True) -> None:
        """A span that started at `t0` (and thread CPU time `c0`, or -1)
        and ends now: on this thread, under its innermost open span, or
        with `own=False` a request's wait, which belongs to no thread."""
        t1 = time.perf_counter_ns()
        thread, parent = -1, -1
        if own:
            st = self._stack()
            thread, parent = self._local.index, st[-1] if st else -1
        got = self._row(next(self._tokens), name, thread, parent, link, arg,
                        t0, c0)
        if got is not None:
            cols, i = got
            cols["t1"][i] = t1
            if c0 >= 0:
                cols["c1"][i] = time.thread_time_ns()


SPANS = SpanRecorder()


def enable(capacity: int = 1 << 18) -> None:
    """Turn the program's spans on, into a fresh buffer of `capacity`."""
    SPANS.enable(capacity)


def disable() -> None:
    """Turn the program's spans off (the default)."""
    SPANS.disable()


def drain() -> Optional[Dict]:
    """The spans recorded since `enable()` or the last drain
    (`SpanRecorder.drain`)."""
    return SPANS.drain()
