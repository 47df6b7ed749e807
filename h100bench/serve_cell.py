"""A serving cell: the port's `TransferServer` under a fixed load.

Requests are made on the host from the seed: prompts of the mix's length
(token ids in [0, roll_dims)), chroma in [0, 1), directions in the mix's
exact ratio in a seeded order, the mix's lam and temperature. Arrivals
are a closed loop (each of `clients` sends its next request when its last
returns) or an open one (Poisson at `rate`, in bursts of `burst` requests
sent together). Latency runs from `submit` (or, open, from when the
request was due) to the Future's result; the rate counts the requests
completed inside the window.

Once the window has closed, the load stops, every request in flight is
waited for (a minute at most), the server is closed and its threads
joined, and only then is the trace read and the reference run on a
seeded sample of the greedy requests completed in the window.
"""
from __future__ import annotations

import gc
import threading
import time
from array import array
from typing import Callable, Dict, List

import numpy as np
import torch

from h100bench import compare, weights
from h100bench.reference.common import Arith
from h100bench.trace import Stretch, summary

DRAIN_S = 60.0


def make_requests(cfg: dict, tr: dict, rng: np.random.Generator) -> List:
    """The mix's request pool, `pool_requests` of them."""
    n, T = tr["pool_requests"], tr["prompt_len"]
    tokens = rng.integers(0, cfg["roll_dims"], (n, T))
    chroma = rng.random((n, cfg["chroma_dims"]), dtype=np.float32)
    ratio = tr["directions"]
    cycle = [d for d, k in ratio.items() for _ in range(k)]
    dirs = [cycle[i % len(cycle)] for i in range(n)]
    rng.shuffle(dirs)
    sampled = rng.random(n) < tr.get("sampled_share", 0.0)
    reqs = []
    for i in range(n):
        req = {"id": i, "tokens": tokens[i].tolist(),
               "chroma": chroma[i].tolist(), "direction": dirs[i],
               "lam": tr["lam"], "steps": tr["steps"]}
        if sampled[i]:
            req.update(temperature=tr["temperature"], seed=i)
        reqs.append(req)
    return reqs


class Load:
    """Drives a server with the pool's requests from the main thread and
    the server's own callbacks, and records every completion."""

    def __init__(self, server, reqs: List, arrival: Dict):
        self.server, self.reqs, self.arrival = server, reqs, arrival
        self.lock = threading.Lock()
        self.next = 0
        self.outstanding = 0
        self.stop_at = float("inf")
        self.drained = threading.Event()
        # each completion's index, due and done times, batch_ms and ok, in
        # flat arrays: no object the collector would walk again and again
        self.done = {"i": array("q"), "due": array("d"), "t": array("d"),
                     "batch_ms": array("d"), "ok": array("b")}
        self.kept: Dict[int, array] = {}
        self.keep = set()

    def _send(self, due: float) -> None:
        with self.lock:
            i = self.next
            self.next += 1
            self.outstanding += 1
        req = self.reqs[i % len(self.reqs)]
        fut = self.server.submit(req)
        fut.add_done_callback(lambda f: self._finish(i, due, f))

    def _finish(self, i: int, due: float, fut) -> None:
        t = time.perf_counter()
        resp = fut.result()
        ok = "error" not in resp
        again = False
        with self.lock:
            d = self.done
            d["i"].append(i)
            d["due"].append(due)
            d["t"].append(t)
            d["batch_ms"].append(resp.get("batch_ms") or float("nan"))
            d["ok"].append(ok)
            if ok and i in self.keep:
                self.kept[i] = array("h", resp["tokens"])
            self.outstanding -= 1
            if self.arrival["kind"] == "closed" and t < self.stop_at:
                again = True
            elif self.outstanding == 0 and t >= self.stop_at:
                self.drained.set()
        if again:
            self._send(time.perf_counter())

    def run(self, t0: float, seconds: float, stretch: Stretch,
            trace: bool, trace_s: float) -> Dict:
        """The window from t0: the load, and when `trace` the traced
        stretch, `trace_s` long from the moment the profiler has started,
        in its middle. Returns the stretch's batch count and what the
        window did before it."""
        self.stop_at = t0 + seconds
        self.t0, self.stretch, self.trace_s = t0, stretch, trace_s
        start = self.server.stats()
        self.b_start = start["batches"]
        self.before, self.b0, self.b1 = None, None, None
        # the next time the stretch acts at, or None
        self.next_mark = t0 + seconds / 2 - trace_s / 2 if trace else None
        if self.arrival["kind"] == "closed":
            for _ in range(self.arrival["clients"]):
                self._send(time.perf_counter())
            while self.next_mark is not None:
                _sleep_until(self.next_mark)
                self._mark()
        else:
            self._open(t0, seconds)
        _sleep_until(self.stop_at)
        with self.lock:
            if self.outstanding == 0:
                self.drained.set()
        self.drained.wait(DRAIN_S)
        end = self.server.stats()
        return {"batches": None if self.b0 is None else self.b1 - self.b0,
                "before": self.before,
                "window_batches": end["batches"] - start["batches"],
                "window_rows": end["batch_rows"] - start["batch_rows"]}

    def _mark(self) -> None:
        """Start the stretch (and note what the window did before it), or
        stop it `trace_s` after the profiler's start returned."""
        if self.b0 is None:
            b = self.server.stats()["batches"]
            self.before = {"batches": b - self.b_start,
                           "seconds": time.perf_counter() - self.t0}
            self.stretch.start()
            self.b0 = self.server.stats()["batches"]
            self.next_mark = time.perf_counter() + self.trace_s
        else:
            self.stretch.stop()
            self.b1 = self.server.stats()["batches"]
            self.next_mark = None

    def _open(self, t0: float, seconds: float) -> None:
        """Poisson arrivals of bursts, due times drawn from the run's
        seed; the stretch's marks kept on the way."""
        rng = np.random.default_rng(self.arrival["seed"])
        burst = self.arrival.get("burst", 1)
        gap = burst / self.arrival["rate"]
        due = t0
        while due < t0 + seconds:
            while self.next_mark is not None and self.next_mark <= due:
                _sleep_until(self.next_mark)
                self._mark()
            _sleep_until(due)
            for _ in range(burst):
                self._send(due)
            due += rng.exponential(gap)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class PortServer:
    """The program: the port's TransferServer with the mix's settings."""

    def __init__(self, cell, tree0: Dict, device: torch.device):
        prog = cell.cfg["program"]
        cfg = cell.resolve(prog["config"])(cell.config_path)
        self.server = cell.resolve(prog["server"])(
            tree0, cfg, device=device, **cell.traffic["server"])

    def path(self) -> str:
        return self.server.serving_path


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, make_program: Callable = PortServer,
        also_check: Callable = None) -> Dict:
    """One run of a serving cell; returns the record the readers and the
    result line read. `also_check(tree0, sample)` adds readings of its
    own on the compared sample (the calibration's control)."""
    tr, cfg = cell.traffic, cell.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree0 = weights.make_params(cell.reference.param_spec(cfg), gen, device)
    rng = np.random.default_rng(seed)
    reqs = make_requests(cfg, tr, rng)
    prog = make_program(cell, tree0, device)
    server = prog.server
    warm = Load(server, reqs, {"kind": "closed",
                               "clients": tr["warm_requests"]})
    warm.run(time.perf_counter(), 0.0, None, False, 0.0)
    stretch = Stretch(device)
    if trace:
        # CUPTI's first start takes seconds: paid here, while the server
        # is idle, rather than in the window
        stretch.warm(lambda: server.request(reqs[0]))
    arrival = dict(tr["arrival"], seed=seed)
    load = Load(server, reqs, arrival)
    load.keep = keep_set(reqs, tr["keep_share"], rng)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    marks = load.run(t0, seconds, stretch, trace, tr["trace_seconds"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0
    path = prog.path()
    server.close()
    gc.unfreeze()
    events = stretch.events()
    t_end = t0 + seconds
    with load.lock:
        done = {k: np.frombuffer(v, dtype=v.typecode) for k, v in
                load.done.items()}
        kept = dict(load.kept)
        attempted = load.next
    ok = done["ok"].astype(bool)
    win = ok & (done["t"] <= t_end)
    in_window = done["i"][win]
    failed = attempted - int(ok.sum())
    del prog, server, load, warm
    readings = _check(cell, tree0, reqs, kept, in_window, rng, device,
                      also_check)
    rec = {"kind": "serve", "setup_s": setup_s, "window_s": seconds,
           "completed": int(win.sum()),
           "latency_s": (done["t"] - done["due"])[win].tolist(),
           "batch_ms": done["batch_ms"][win].tolist(),
           "attempted": attempted, "failed": failed,
           "memory_peak_bytes": int(peak), "readings": readings,
           "path": path, "rows": tr["server"]["max_batch"],
           "served_batches": marks["window_batches"],
           "served_rows": marks["window_rows"]}
    if trace:
        rec["trace"] = summary(events, stretch.wall_s)
        rec["trace"]["batches"] = marks["batches"]
        rec["before_trace"] = marks["before"]
    return rec


def keep_set(reqs: List, share: float, rng) -> set:
    """The request indices (of the first 2**20) whose served tokens are
    kept for the check: a seeded `share` of them, greedy requests only
    (the reference's comparison holds for greedy tokens)."""
    idx = np.nonzero(rng.random(1 << 20) < share)[0]
    greedy = np.array(["temperature" not in r for r in reqs])
    return set(idx[greedy[idx % len(reqs)]].tolist())


def sample(kept: Dict, in_window, n: int, rng) -> List[int]:
    """A seeded sample of `n` of the kept requests completed in the
    window (`in_window`: their indices)."""
    cand = sorted(int(i) for i in in_window if int(i) in kept)
    if len(cand) <= n:
        return cand
    return sorted(rng.choice(np.array(cand), size=n, replace=False).tolist())


def batch_of(directions: Dict, reqs: List, kept: Dict, idx: List[int],
             device: torch.device) -> Dict:
    """The sampled requests as the reference reads them: prompts, chroma,
    the direction's sign, lam and the served tokens."""
    rs = [reqs[i % len(reqs)] for i in idx]
    t = (lambda a, dt: torch.tensor(a, dtype=dt, device=device))
    return {"tokens": t([r["tokens"] for r in rs], torch.int64),
            "chroma": t([r["chroma"] for r in rs], torch.float32),
            "sign": t([directions[r["direction"]] for r in rs],
                      torch.float32),
            "lam": t([r["lam"] for r in rs], torch.float32),
            "served": t([kept[i] for i in idx], torch.int64)}


def _blocks(req: Dict, size: int):
    n = req["tokens"].shape[0]
    for a in range(0, n, size):
        yield {k: v[a:a + size] for k, v in req.items()}


def _check(cell, tree0, reqs, kept, in_window, rng, device,
           also_check=None) -> Dict:
    """The reference's readings on the sample: the widest logit gap, and
    whether every sampled answer is whole (the mix's length, ids in
    range)."""
    tr, cfg = cell.traffic, cell.cfg
    idx = sample(kept, in_window, tr["check_requests"], rng)
    whole = bool(idx) and all(
        len(kept[i]) == tr["steps"]
        and all(0 <= t < cfg["roll_dims"] for t in kept[i]) for i in idx)
    if not whole:
        return {"logit_gap": None, "whole": False, "sampled": len(idx)}
    req = batch_of(cell.reference.DIRECTIONS, reqs, kept, idx, device)
    gap, ar = 0.0, Arith()
    with torch.no_grad(), ar:
        for blk in _blocks(req, tr["check_block"]):
            gap = max(gap, compare.serve_gap(
                cell.reference.served_logits(ar, tree0, blk, cfg),
                blk["served"]))
    out = {"logit_gap": gap, "whole": True, "sampled": len(idx)}
    if also_check is not None:
        out.update(also_check(tree0, req))
    return out
