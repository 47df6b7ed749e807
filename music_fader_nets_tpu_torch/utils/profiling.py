"""Profiling helpers (counterpart of `music_fader_nets_tpu/utils/
profiling.py`): a `torch.profiler` trace of a block, written as a Chrome
trace, and a host-clock step timer that waits for the card before it
reads the clock (a CUDA call returns before its work is done).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

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
