"""PyTorch port, the program's span recorder (`utils/profiling.py`), its
sites in the server and the Trainer, and what the benchmark reads of it
(`h100bench/spans.py`, the seven span readers under `h100bench/metrics/`),
on the CPU at a small size (H=32, z=8, T=8).

The recorder: off, it records nothing and reads no clock; on, it nests
parents per thread, links ids across threads and counts what does not fit.
The server on the CPU over two batches: every request's `serve.queue`
links to a batch that has the four dispatch spans and the three fetch
spans, each set on its own thread, and the responses' `batch_ms` keeps
its meaning. A CPU `train_step`: forward, backward, clip and adam inside
`train.step`, in that order. The idle attribution, the clock check and
the readers on synthetic events and spans with known answers."""
import threading
import time
from concurrent.futures import wait as wait_futures

import numpy as np
import pytest
import torch

from h100bench import harness, spans as bench_spans
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.serve import server as server_mod
from music_fader_nets_tpu_torch.serve.server import TransferServer
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.train.profile import random_corpus
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils import profiling
from music_fader_nets_tpu_torch.utils.profiling import SpanRecorder

CFG = ModelConfig(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)


@pytest.fixture
def program_spans():
    """The program's recorder on for one test, and off after it."""
    profiling.enable(1 << 12)
    try:
        yield
    finally:
        profiling.disable()
        profiling.drain()


def _rows(sp, name):
    return list(np.nonzero(sp["name"] == sp["names"].index(name))[0])


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read")

    rec = SpanRecorder()
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    name = rec.name("x")
    with rec.span(name, 3, cpu=True):
        pass
    assert rec.drain() is None
    rec.enable(8)
    rec.disable()
    with rec.span(name):
        pass
    out = rec.drain()
    assert len(out["name"]) == 0 and out["dropped"] == 0


def test_off_costs_the_program_no_clock(monkeypatch):
    """The server's and the Trainer's sites, the program's recorder off."""
    def boom():
        raise AssertionError("a clock was read")

    assert not profiling.SPANS.on
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    tr = Trainer(CFG, init_reg_gmvae, {"default": gmm_loss}, device="cpu")
    arrays = YamahaDataset(*random_corpus(CFG, 10, 0), mode="train").arrays()
    assert np.isfinite(tr.run_epoch(arrays, batch_size=4)["loss"])
    params = init_reg_gmvae(torch.Generator().manual_seed(0), CFG)
    with TransferServer(params, CFG, steps=6, max_batch=2, device="cpu") \
            as srv:
        assert "tokens" in srv.request(_request(0))


def test_parents_nest_per_thread():
    rec = SpanRecorder()
    a, b, c = rec.name("a"), rec.name("b"), rec.name("c")
    rec.enable(16)
    ready, done = threading.Event(), threading.Event()

    def other():
        with rec.span(c, 7):
            ready.set()
            done.wait(10)

    th = threading.Thread(target=other, name="other")
    with rec.span(a, 1):
        th.start()
        assert ready.wait(10)
        with rec.span(b, 1):
            pass
        done.set()
    th.join(10)
    assert not th.is_alive()
    sp = rec.drain()
    ia, ib, ic = (_rows(sp, n)[0] for n in "abc")
    assert sp["parent"][ia] == -1 and sp["parent"][ib] == ia
    assert sp["parent"][ic] == -1
    assert sp["thread"][ia] == sp["thread"][ib] != sp["thread"][ic]
    assert sp["threads"][int(sp["thread"][ic])] == "other"
    assert sp["t0"][ia] <= sp["t0"][ib] <= sp["t1"][ib] <= sp["t1"][ia]


def test_ids_link_across_threads():
    rec = SpanRecorder()
    put, work = rec.name("put"), rec.name("work")
    rec.enable(16)
    t_put = time.perf_counter_ns()

    def take():
        rec.record(put, t_put, link=42, arg=5, own=False)
        with rec.span(work, 42, cpu=True):
            pass

    th = threading.Thread(target=take)
    th.start()
    th.join(10)
    sp = rec.drain()
    ip, iw = _rows(sp, "put")[0], _rows(sp, "work")[0]
    assert sp["link"][ip] == sp["link"][iw] == 42 and sp["arg"][ip] == 5
    assert sp["thread"][ip] == -1 and sp["thread"][iw] >= 0
    assert sp["t0"][ip] == t_put <= sp["t1"][ip]
    assert sp["c0"][ip] == -1 and 0 <= sp["c0"][iw] <= sp["c1"][iw]


def test_drops_are_counted_at_capacity():
    rec = SpanRecorder()
    x = rec.name("x")
    rec.enable(4)
    for k in range(10):
        with rec.span(x, k):
            rec.record(x, time.perf_counter_ns(), link=k)
    sp = rec.drain()
    assert len(sp["name"]) == 4 and sp["dropped"] == 16
    assert (sp["t1"] >= sp["t0"]).all()
    # the recorder goes on into a fresh buffer of the same capacity
    with rec.span(x, 99):
        pass
    sp = rec.drain()
    assert list(sp["link"]) == [99] and sp["dropped"] == 0


def _request(i):
    rng = np.random.default_rng(i)
    return {"id": i, "tokens": rng.integers(2, CFG.roll_dims, 8).tolist(),
            "direction": "low_to_high", "lam": 0.5}


def test_server_spans_over_two_batches(program_spans):
    params = init_reg_gmvae(torch.Generator().manual_seed(0), CFG)
    with TransferServer(params, CFG, steps=6, max_batch=4,
                        max_wait_ms=2000.0, device="cpu") as srv:
        futs = [srv.submit(_request(i)) for i in range(8)]
        wait_futures(futs, timeout=120)
        resps = [f.result() for f in futs]
        assert srv.stats()["batches"] == 2
    sp = profiling.drain()
    assert sp["dropped"] == 0 and (sp["t1"] > 0).all()
    names = sp["names"]
    queue = _rows(sp, "serve.queue")
    assert len(queue) == 8 and len(_rows(sp, "serve.submit")) == 8
    assert sorted(sp["link"][queue]) == list(range(8))
    assert (sp["thread"][queue] == -1).all()
    assert (sp["t1"][queue] >= sp["t0"][queue]).all()
    dispatch = ("serve.gather", "serve.assemble", "serve.slot_wait",
                "serve.enqueue")
    fetch = ("serve.fetch_wait", "serve.copy_back", "serve.respond")
    by_batch = {}
    for seq in set(sp["arg"][queue].tolist()):
        rows = np.nonzero((sp["link"] == seq) & (sp["thread"] >= 0))[0]
        got = {names[sp["name"][r]]: r for r in rows}
        assert set(dispatch) | set(fetch) <= set(got)
        threads = [{sp["threads"][int(sp["thread"][got[n]])] for n in group}
                   for group in (dispatch, fetch)]
        assert threads == [{"fader-serve-dispatch"}, {"fader-serve-fetch"}]
        # gather, assemble, slot wait, enqueue in turn on the dispatch
        # thread; the CPU time of each within its wall time
        ends = [(sp["t0"][got[n]], sp["t1"][got[n]]) for n in dispatch]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        for n in dispatch + fetch:
            r = got[n]
            assert 0 <= sp["c1"][r] - sp["c0"][r]
        assert sp["arg"][got["serve.gather"]] == \
            server_mod.GATHER_CLOSED.index("full")
        by_batch[seq] = got
    assert len(by_batch) == 2
    for resp in resps:
        seq = int(sp["arg"][queue][list(sp["link"][queue]).index(
            resp["id"])])
        got = by_batch[seq]
        # batch_ms: from the launch (after the slot wait) to the answer
        lo = (sp["t0"][got["serve.respond"]]
              - sp["t0"][got["serve.enqueue"]]) / 1e6
        hi = (sp["t1"][got["serve.respond"]]
              - sp["t1"][got["serve.slot_wait"]]) / 1e6
        assert lo - 0.01 <= resp["batch_ms"] <= hi + 0.01


def test_train_step_spans_in_order(program_spans):
    tr = Trainer(CFG, init_reg_gmvae, {"default": gmm_loss}, device="cpu")
    arrays = YamahaDataset(*random_corpus(CFG, 5, 1), mode="train").arrays()
    tr.run_epoch(arrays, batch_size=4)
    sp = profiling.drain()
    step = _rows(sp, "train.step")
    assert len(step) == 1
    step = step[0]
    kids = [_rows(sp, f"train.{n}")[0]
            for n in ("forward", "backward", "clip", "adam")]
    assert not _rows(sp, "train.allreduce")
    assert all(sp["parent"][k] == step for k in kids)
    assert (sp["link"][kids + [step]] == 0).all()
    times = [sp["t0"][step]] + [t for k in kids
                                for t in (sp["t0"][k], sp["t1"][k])] \
        + [sp["t1"][step]]
    assert times == sorted(times)
    assert (sp["c0"][kids] >= 0).all()


def _synthetic():
    """Two threads of the server and a marker on the main thread, in ns
    with the Unix clock 0 ns away from the spans' clock."""
    names = ["serve.enqueue", "serve.gather", "serve.respond",
             "serve.submit", "serve.queue", bench_spans.MARKER]
    # (name, thread, t0 us, t1 us)
    rows = [(0, 0, 10, 40), (1, 0, 50, 90), (2, 1, 30, 60), (3, 1, 35, 45),
            (4, -1, 0, 100), (5, 2, 1000, 1020)]
    us = np.array([[r[2], r[3]] for r in rows], dtype=np.int64) * 1000
    return {"name": np.array([r[0] for r in rows]),
            "thread": np.array([r[1] for r in rows]),
            "parent": np.array([-1, -1, -1, 2, -1, -1]),
            "link": np.zeros(6, np.int64), "arg": np.zeros(6, np.int64),
            "t0": us[:, 0], "t1": us[:, 1],
            "c0": np.full(6, -1), "c1": np.full(6, -1), "names": names,
            "threads": {0: "fader-serve-dispatch", 1: "fader-serve-fetch",
                        2: "MainThread"}, "dropped": 0}


EVENTS = [("k", 0.0, 10.0), ("k", 40.0, 50.0), ("k", 42.0, 45.0),
          ("k", 90.0, 95.0)]


def test_idle_attribution_known_answer():
    got = dict(bench_spans.idle_by_span(_synthetic(), EVENTS, [0, 100_000],
                                        0))
    want = {"dispatch:serve.enqueue": 20,
            "dispatch:serve.enqueue|fetch:serve.respond": 5,
            "dispatch:serve.enqueue|fetch:serve.submit": 5,
            "dispatch:serve.gather|fetch:serve.respond": 10,
            "dispatch:serve.gather": 30, "none": 5}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6)
    # the attribution sums to the window less the events' union
    assert sum(got.values()) == pytest.approx(75e-6)
    # a window on another clock: the same answer once mapped
    shifted = bench_spans.idle_by_span(
        _synthetic(), [(n, s + 7.0, e + 7.0) for n, s, e in EVENTS],
        [0, 100_000], 7000)
    assert dict(shifted) == pytest.approx(got)


class _Event:
    def __init__(self, name, device, start_us, dur_us, corr):
        self._a = (name, device, start_us, dur_us, corr)

    def name(self):
        return self._a[0]

    def device_type(self):
        return self._a[1]

    def start_ns(self):
        return int(self._a[2] * 1000)

    def duration_ns(self):
        return int(self._a[3] * 1000)

    def correlation_id(self):
        return self._a[4]


@pytest.mark.parametrize("call_us, gap", [(1005.0, 5.0), (960.0, -40.0),
                                          (1200.0, None), (900.0, None)])
def test_clock_check(call_us, gap):
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    marks = bench_spans.clock_marks([
        _Event("at::cuda::spin_kernel(long)", cuda, 5000.0, 1.0, 7),
        _Event("void other_kernel", cuda, 5001.0, 1.0, 8),
        _Event("cudaLaunchKernel", cpu, call_us, 4.0, 7),
        _Event("cudaLaunchKernel", cpu, 1010.0, 4.0, 8),
        _Event("aten::mul", cpu, 1001.0, 4.0, 0)])
    assert marks["marker_kernels"] == [7] and set(marks["runtime"]) == {7, 8}
    got = bench_spans.clock_gap_us(_synthetic(), marks, 0)
    assert got == (None if gap is None else pytest.approx(gap))


def _complete(call_us):
    ps = bench_spans.ProgramSpans(torch.device("cpu"))
    ps.offset_ns, ps.stretch_ns = 0, [0, 100_000]
    rec = {"kind": "serve", "trace": {"batches": 2}}
    marks = {"marker_kernels": [7], "runtime": {7: (call_us, call_us + 1)}}
    bench_spans.complete(rec, ps, _synthetic(), EVENTS, marks)
    return rec


def test_complete_fills_the_record():
    rec = _complete(1003.0)
    t = rec["trace"]
    assert t["clock_gap_us"] == pytest.approx(3.0)
    assert len(t["idle_by_span"]) == 6 == len(t["idle_attribution"])
    assert t["idle_by_span"][0] == ["dispatch:serve.gather",
                                    pytest.approx(30e-6)]
    # only the queue span ended before the stretch's start (at 0): none
    assert rec["spans"] == {"before": {}, "cpu_before": {}, "dropped": 0}
    failed = _complete(1500.0)["trace"]
    assert failed["clock_gap_us"] is None
    assert failed["idle_attribution"] is None is failed["idle_by_span"]


TRAIN_BEFORE = {"train.step": [10.0, 10.0], "train.forward": [1.0, 3.0],
                "train.backward": [4.0, 6.0], "train.clip": [0.5, 0.5],
                "train.adam": [1.0, 1.0]}
SERVE_BEFORE = {"serve.queue": [1.0, 2.0, 10.0], "serve.enqueue": [3.0, 4.0,
                                                                   5.0],
                "serve.respond": [1.0, 1.0, 7.0]}
ATTRIBUTION = [["none", 0.5], ["dispatch:serve.enqueue", 0.02],
               ["dispatch:serve.enqueue|fetch:serve.respond", 0.01],
               ["dispatch:serve.gather|fetch:serve.enqueue", 0.2]]


@pytest.mark.parametrize("metric, kind, want", [
    ("forward_call_ms.train", "train", 2.0),
    ("backward_call_ms.train", "train", 5.0),
    ("optim_call_ms.train", "train", 1.5),
    ("queue_wait_ms.serve", "serve", 2.0),
    ("enqueue_ms.serve", "serve", 4.0),
    ("respond_ms.serve", "serve", 1.0),
    ("idle_enqueue_ms.serve", "serve", 10.0)])
def test_span_readers(metric, kind, want):
    read = harness.reader(metric)
    before = TRAIN_BEFORE if kind == "train" else SERVE_BEFORE
    rec = {"kind": kind, "spans": {"before": before, "dropped": 0},
           "trace": {"batches": 3, "idle_attribution": ATTRIBUTION,
                     "clock_gap_us": 4.0}}
    assert read(rec) == pytest.approx(want)
    # the other kind of cell, a program without spans, a failed clock
    assert read(dict(rec, kind="serve" if kind == "train" else "train")) \
        is None
    assert read({"kind": kind, "trace": {"batches": 3}}) is None
    failed = dict(rec, trace={"batches": 3, "idle_attribution": None,
                              "clock_gap_us": None})
    if metric.startswith("idle_"):
        assert read(failed) is None
    else:
        assert read(failed) == read(rec)
