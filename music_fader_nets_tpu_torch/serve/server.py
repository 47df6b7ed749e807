"""Batched serving of fader-controlled generation on the GPU (counterpart
of `music_fader_nets_tpu/serve/server.py`, same request schema).

  * **Fixed shape.** Every batch is padded to `max_batch` x `seq_len` and
    runs one program: encoder kernel -> mean or seeded z -> per-row latent
    shift -> `steps`-step decode kernel. `steps` is fixed per server;
    requests asking for fewer get a truncated slice.
  * **Two programs.** An all-greedy batch runs the greedy decode kernel; a
    batch with at least one sampled row runs the sampling kernel, with
    per-row 1/T and per-row Gumbel noise (zero for greedy rows, which then
    decode exactly as greedy).
  * **Micro-batching.** Concurrent requests coalesce (up to `max_batch`
    rows or `max_wait_ms`) into one launch.
  * **Pipelined dispatch.** One dispatch thread enqueues all device work
    asynchronously on the current CUDA stream and never waits on the
    device; a fetch thread waits for its batch's results, where device
    faults surface, so batch N+1 launches while batch N's tokens come back
    (at most `pipeline_depth` batches in flight).
  * **Staging.** A batch's inputs are assembled in one host buffer of a
    staging set, sent with one copy, and its results copied back into the
    set's host buffers, after which the set's CUDA event is recorded. On
    CUDA the buffers are page-locked, so neither copy waits on the stream;
    on the CPU the same code runs on plain buffers with no event. There is
    one set more than launch slots, so the next batch is assembled while
    `pipeline_depth` batches are in flight.

Requests are plain dicts (the JSON-line protocol of `serve/cli.py`):

    {"id": "r1", "tokens": [...], "chroma": [24 floats]?,
     "direction": "low_to_high"|"high_to_low"|"none", "lam": 1.0,
     "steps": 300?, "seed": 7?, "temperature": 0.9?, "return_z": false?}

`direction`/`lam` move z along the GM-VAE component-mean line; z is the
posterior mean unless `seed` asks for a sampled z (eps from numpy's
`default_rng(seed)`, as the JAX server draws it). `temperature` > 0 samples
that row's tokens from softmax(logits / T); sampled rows are reproducible
per `seed` (without one, a server nonce makes them vary). Trees without
mixture tables are served reconstruct-only.

The server runs on CUDA unless `device="cpu"` is asked for, where every
kernel wrapper takes its plain PyTorch version (`serving_path` says which).

With the program's spans on (`utils/profiling.py`), a request records
`serve.submit` and `serve.queue` (its wait from the put until the
dispatcher takes it, linked by the request's index, its `arg` the batch's
number); a batch records, with its number, `serve.gather` (from the
blocking get of its first request until it closes; `arg` full, deadline
or shutdown: `GATHER_CLOSED`), `serve.assemble`, `serve.slot_wait` and
`serve.enqueue` on the dispatch thread, and `serve.fetch_wait`,
`serve.copy_back` and `serve.respond` on the fetch thread, each with the
thread's CPU time at both ends.
"""
from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.vae import _global_view, reg_vae_encode
from music_fader_nets_tpu_torch.ops.cuda_decode import (
    check_temperature, cuda_greedy_decode, cuda_sample_decode,
)
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.ops.sampling import gumbel_rows, reparameterize
from music_fader_nets_tpu_torch.transfer.arousal import compute_shift_vectors
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to
from music_fader_nets_tpu_torch.utils.profiling import SPANS

_DIRECTIONS = ("none", "low_to_high", "high_to_low")
# how a batch's gather ended: its `arg`
GATHER_CLOSED = ("full", "deadline", "shutdown")
_SUBMIT, _QUEUE, _GATHER, _ASSEMBLE, _SLOT_WAIT, _ENQUEUE, _FETCH_WAIT, \
    _COPY_BACK, _RESPOND = (SPANS.name(f"serve.{n}") for n in (
        "submit", "queue", "gather", "assemble", "slot_wait", "enqueue",
        "fetch_wait", "copy_back", "respond"))


class TransferServer:
    """Micro-batching model server over one params tree.

    Thread-safe: `submit` from any thread returns a Future; one dispatcher
    thread owns all device launches. Use as a context manager or call
    `close()`."""

    def __init__(self, params, cfg: ModelConfig, *,
                 steps: Optional[int] = None, max_batch: int = 64,
                 max_wait_ms: float = 5.0, pipeline_depth: int = 2,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.steps = int(steps or cfg.transfer_decode_steps)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.params = tree_to(params, self.device)
        self._gview = _global_view(self.params)
        self._vp = vocab_pad(cfg.roll_dims)
        try:
            self._shifts = compute_shift_vectors(self.params)
        except KeyError:           # no mixture tables: reconstruct-only
            self._shifts = None
        self.serving_path = ("kernel" if self.device.type == "cuda"
                             else "plain-cpu")
        depth = max(1, int(pipeline_depth))
        B, Z = self.max_batch, cfg.z_dims
        fields = {"tokens": ((B, cfg.seq_len), torch.int32),
                  "chroma": ((B, cfg.chroma_dims), torch.float32),
                  "shift_r": ((B, Z), torch.float32),
                  "shift_n": ((B, Z), torch.float32),
                  "lam": ((B,), torch.float32),
                  "eps_r": ((B, Z), torch.float32),
                  "eps_n": ((B, Z), torch.float32),
                  "inv_t": ((B,), torch.float32)}
        staging = [_Staging(fields, self.device) for _ in range(depth + 1)]
        # builds the kernels on first use and surfaces any launch failure
        # here, at construction
        self._warmup(staging)
        # the sets not in flight; the dispatcher takes one before it
        # assembles a batch, so it never waits here (one more set than
        # slots), and the fetch thread puts it back before the slot
        self._free: "queue.SimpleQueue" = queue.SimpleQueue()
        for st in staging:
            self._free.put(st)
        self._nonce = itertools.count(1)
        # request indices (while spans are on) and batch numbers
        self._rids = itertools.count()
        self._seqs = itertools.count()

        self._q: "queue.Queue" = queue.Queue()
        # a semaphore (not a bounded queue, whose slot would free at fetch
        # START) holds each launch slot until its fetch COMPLETES
        self._inflight: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._lock = threading.Lock()
        # staged_batches: batches whose results came back through a staging
        # set; fetch_ready: those whose results were already on the host
        # when the fetch thread came for them (the host paces serving)
        self._stats = {"requests": 0, "batches": 0, "batch_rows": 0,
                       "rejected": 0, "staged_batches": 0, "fetch_ready": 0}
        self._lat_ms: List[float] = []
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True,
                                        name="fader-serve-dispatch")
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True,
                                         name="fader-serve-fetch")
        self._thread.start()
        self._fetcher.start()

    # ------------------------------------------------------------------ API

    def submit(self, req: Any) -> Future:
        """Enqueue one request dict; resolves to a response dict (never
        raises: malformed requests resolve to {"error": ...})."""
        if not SPANS.on:
            return self._submit(req, -1)
        rid = next(self._rids)
        with SPANS.span(_SUBMIT, rid):
            return self._submit(req, rid)

    def _submit(self, req: Any, rid: int) -> Future:
        fut: Future = Future()
        if not isinstance(req, dict):
            with self._lock:
                self._stats["rejected"] += 1
            fut.set_result({"error": "request must be a JSON object"})
            return fut
        try:
            row = self._validate(req)
        except (KeyError, ValueError, TypeError, OverflowError) as e:
            with self._lock:
                self._stats["rejected"] += 1
            fut.set_result({"id": req.get("id"), "error": str(e)})
            return fut
        with self._lock:
            if self._closed:
                fut.set_result({"id": req.get("id"),
                                "error": "server closed"})
                return fut
            if rid >= 0:
                row["span"] = (rid, time.perf_counter_ns())
            self._q.put((row, fut, time.monotonic()))
        return fut

    def request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return self.submit(req).result()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            lat = sorted(self._lat_ms)
        s["serving_path"] = self.serving_path
        s["mean_batch_rows"] = (round(s["batch_rows"] / s["batches"], 2)
                                if s["batches"] else None)
        if lat:
            s["latency_ms_p50"] = round(lat[len(lat) // 2], 2)
            s["latency_ms_p95"] = round(lat[int(len(lat) * 0.95)], 2)
        return s

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=30)
        self._fetcher.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ internals

    def _validate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.cfg
        tokens = np.zeros((cfg.seq_len,), np.int32)
        raw = np.asarray(req["tokens"], np.int32).ravel()
        if raw.size == 0:
            raise ValueError("empty 'tokens'")
        if raw.size > cfg.seq_len:
            raise ValueError(f"'tokens' longer than the server's seq_len "
                             f"({raw.size} > {cfg.seq_len}); re-slice or "
                             f"run a server with a longer --config seq_len")
        if raw.min() < 0 or raw.max() >= cfg.roll_dims:
            raise ValueError(f"token ids must be in [0, {cfg.roll_dims})")
        tokens[:raw.size] = raw
        chroma = np.zeros((cfg.chroma_dims,), np.float32)
        if req.get("chroma") is not None:
            c = np.asarray(req["chroma"], np.float32).ravel()
            if c.size != cfg.chroma_dims:
                raise ValueError(f"chroma must have {cfg.chroma_dims} dims")
            chroma = c
        direction = req.get("direction", "none") or "none"
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {_DIRECTIONS}")
        if direction != "none" and self._shifts is None:
            raise ValueError("this checkpoint has no GM-VAE mixture tables; "
                             "only direction='none' (reconstruction) is "
                             "served")
        steps = req.get("steps")
        steps = self.steps if steps is None else int(steps)
        if not 0 < steps <= self.steps:
            raise ValueError(f"steps must be in (0, {self.steps}] (the "
                             f"server's decode length)")
        seed = req.get("seed")
        if seed is not None and int(seed) < 0:
            raise ValueError("seed must be a non-negative integer")
        temperature = float(req.get("temperature", 0.0) or 0.0)
        # beyond float32 1/T bounds the decode could emit pad-lane ids
        check_temperature(temperature)
        return {"id": req.get("id"), "tokens": tokens, "chroma": chroma,
                "direction": direction, "lam": float(req.get("lam", 1.0)),
                "steps": steps,
                "seed": None if seed is None else int(seed),
                "temperature": temperature,
                "return_z": bool(req.get("return_z", False))}

    def _run(self, st: "_Staging", noise_seeds=None):
        """Enqueue one padded batch, assembled in `st`, on the device:
        encode -> z -> decode. Returns device tensors (tokens (B, steps)
        int32, z (B, Z_total)); nothing here waits for the device."""
        dev = self.device
        with torch.inference_mode():
            x = st.send(dev)
            (mu_r, std_r), (mu_n, std_n) = reg_vae_encode(
                self.params, None, tokens=x["tokens"])
            # eps rows are ZERO for deterministic (mean) rows
            lam_t = x["lam"][:, None]
            z_r = (reparameterize(mu_r, std_r, x["eps_r"])
                   + lam_t * x["shift_r"])
            z_n = (reparameterize(mu_n, std_n, x["eps_n"])
                   + lam_t * x["shift_n"])
            z = torch.cat([z_r, z_n, x["chroma"]], dim=-1)
            if noise_seeds is None:
                out = cuda_greedy_decode(self._gview, z, self.steps)
            else:
                noise = gumbel_rows(noise_seeds, self.steps, self._vp, dev)
                out = cuda_sample_decode(self._gview, z, noise, x["inv_t"],
                                         self.steps)
        return out, z

    def _warmup(self, staging: List["_Staging"]) -> None:
        """One all-padding greedy batch; its results give the shape and
        layout of every set's result buffers."""
        st = staging[0]
        self._assemble([], st)
        out, z = self._run(st)
        for s in staging:
            s.hold_results(out, z)
        st.receive(out, z)
        st.wait()

    def _dispatch_loop(self) -> None:
        gather = None    # (ns, CPU ns) the gather began at, spans on
        while True:
            if gather is None and SPANS.on:
                gather = (time.perf_counter_ns(), time.thread_time_ns())
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._closed:
                    break
                continue
            if first is None:
                break
            seq = next(self._seqs)
            traced = gather is not None
            if traced:
                self._taken(first, seq)
            batch = [first]
            closed = 0
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                closed = 1
                if rem <= 0:
                    break
                try:
                    item = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if item is None:
                    self._closed = True
                    closed = 2
                    break
                if traced:
                    self._taken(item, seq)
                batch.append(item)
                closed = 0
            if traced:
                SPANS.record(_GATHER, *gather, link=seq, arg=closed)
                gather = None
            try:
                self._launch_batch(batch, seq)
            except Exception as e:           # resolve, never wedge callers
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_result({"error": f"batch failed: {e!r}"})
            if self._closed and self._q.empty():
                break
        # a submit racing close() can land behind the shutdown sentinel
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_result({"id": item[0]["id"],
                                    "error": "server closed"})
        self._inflight.put(None)             # drain the fetcher

    @staticmethod
    def _taken(item, seq: int) -> None:
        """A request taken into batch `seq`: its `serve.queue` span."""
        span = item[0].get("span")
        if span is not None:
            SPANS.record(_QUEUE, span[1], link=span[0], arg=seq, own=False)

    def _launch_batch(self, batch, seq: int) -> None:
        """Assemble and enqueue one padded batch (number `seq`); the fetch
        thread brings the results back and resolves the futures."""
        st = self._free.get_nowait()
        try:
            with SPANS.span(_ASSEMBLE, seq, cpu=True):
                noise_seeds = self._assemble(batch, st)
            # backpressure: blocks once pipeline_depth batches are in flight
            with SPANS.span(_SLOT_WAIT, seq, cpu=True):
                self._slots.acquire()
        except Exception:
            self._free.put(st)
            raise
        t0 = time.monotonic()
        want_z = any(row["return_z"] for row, _, _ in batch)
        try:
            with SPANS.span(_ENQUEUE, seq, cpu=True):
                out, z = self._run(st, noise_seeds)
                st.receive(out, z if want_z else None)
        except Exception:
            self._free.put(st)
            self._slots.release()    # never leak a launch slot
            raise
        self._inflight.put((batch, st, want_z, t0, seq))

    def _assemble(self, batch, st: "_Staging"):
        """Write the padded batch into `st`'s host buffers, every field
        reset first (zeros, inv_t ones); returns the rows' noise seeds, or
        None for an all-greedy batch."""
        cfg, a = self.cfg, st.arrays
        st.clear()
        a["inv_t"].fill(1.0)
        noise_seeds: List[Optional[int]] = [None] * self.max_batch
        for i, (row, _, _) in enumerate(batch):
            a["tokens"][i] = row["tokens"]
            a["chroma"][i] = row["chroma"]
            if row["direction"] != "none":
                a["shift_r"][i] = self._shifts[f"r_{row['direction']}"]
                a["shift_n"][i] = self._shifts[f"n_{row['direction']}"]
                a["lam"][i] = row["lam"]
            if row["seed"] is not None:
                rng = np.random.default_rng(row["seed"])
                a["eps_r"][i] = rng.standard_normal(cfg.z_dims)
                a["eps_n"][i] = rng.standard_normal(cfg.z_dims)
            if row["temperature"] > 0:
                a["inv_t"][i] = 1.0 / row["temperature"]
                noise_seeds[i] = (row["seed"] if row["seed"] is not None
                                  else next(self._nonce))
        sampled = any(s is not None for s in noise_seeds)
        return noise_seeds if sampled else None

    def _fetch_loop(self) -> None:
        while True:
            wait = ((time.perf_counter_ns(), time.thread_time_ns())
                    if SPANS.on else None)
            item = self._inflight.get()
            if item is None:
                return
            batch, st, want_z, t0, seq = item
            if wait is not None:
                SPANS.record(_FETCH_WAIT, *wait, link=seq)
            try:
                with SPANS.span(_COPY_BACK, seq, cpu=True):
                    ready = st.wait()
                    n = len(batch)
                    out = st.out[:n].numpy().copy()
                    z = st.z[:n].numpy().copy() if want_z else None
            except Exception as e:   # device-side failure surfaces here
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_result({"error": f"batch failed: {e!r}"})
                continue
            finally:
                self._free.put(st)
                self._slots.release()
            with SPANS.span(_RESPOND, seq, cpu=True):
                self._respond(batch, out, z, t0, ready)

    def _respond(self, batch, out, z, t0: float, ready: bool) -> None:
        """The batch's stats, and each row's response set on its future
        (which runs the callbacks)."""
        batch_ms = (time.monotonic() - t0) * 1e3
        n = len(batch)
        done_t = time.monotonic()
        with self._lock:
            self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["batch_rows"] += n
            self._stats["staged_batches"] += 1
            self._stats["fetch_ready"] += ready
            for _, _, t_in in batch:
                self._lat_ms.append((done_t - t_in) * 1e3)
            del self._lat_ms[:-4096]
        for i, (row, fut, t_in) in enumerate(batch):
            try:
                resp = {"id": row["id"],
                        "tokens": out[i, :row["steps"]].tolist(),
                        "batch_rows": n,
                        "batch_ms": round(batch_ms, 2),
                        "latency_ms": round((done_t - t_in) * 1e3, 2)}
                if row["return_z"]:
                    resp["z"] = np.round(z[i], 6).tolist()
                fut.set_result(resp)
            except Exception as e:   # never let one row kill the thread
                if not fut.done():
                    fut.set_result({"error": f"marshal failed: {e!r}"})


class _Staging:
    """One pipeline slot's transfer buffers. The padded batch's inputs lie
    in one host buffer, a numpy view per field (`arrays`), and go to the
    device in one copy; the results come back into host buffers laid out
    as the device's, after which `event` is recorded. On CUDA the host
    buffers are page-locked, so no copy waits on the stream; on the CPU
    they are plain and the work is done when `receive` returns."""

    def __init__(self, fields: Dict[str, Any], device: torch.device):
        self.pin = device.type == "cuda"
        # every field starts on a 256-byte boundary of the one buffer
        self._fields, n = {}, 0
        for name, (shape, dtype) in fields.items():
            self._fields[name] = (n, shape, dtype)
            n += -(-math.prod(shape) // 64) * 64
        self.host = torch.empty(n, dtype=torch.float32, pin_memory=self.pin)
        self._flat = self.host.numpy()
        self.arrays = {k: v.numpy() for k, v in self._views(self.host).items()}
        self.event = torch.cuda.Event() if self.pin else None
        self.out = self.z = None

    def _views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[o:o + math.prod(shape)].view(dtype).view(shape)
                for name, (o, shape, dtype) in self._fields.items()}

    def hold_results(self, out: torch.Tensor, z: torch.Tensor) -> None:
        """Host buffers for results shaped and strided as `out` and `z`,
        so that each comes back in one copy."""
        self.out = torch.empty_strided(out.shape, out.stride(),
                                       dtype=out.dtype, pin_memory=self.pin)
        self.z = torch.empty_strided(z.shape, z.stride(), dtype=z.dtype,
                                     pin_memory=self.pin)
        if self.event is not None:     # made at its first record, so now
            self.event.record(torch.cuda.current_stream(out.device))

    def clear(self) -> None:
        self._flat.fill(0)

    def send(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The inputs on `device` (one copy, not waited for), by field."""
        return self._views(self.host.to(device, non_blocking=True))

    def receive(self, out: torch.Tensor, z: Optional[torch.Tensor]) -> None:
        """Copy the results back (z only when given), then record the
        event on the current stream."""
        self.out.copy_(out, non_blocking=True)
        if z is not None:
            self.z.copy_(z, non_blocking=True)
        if self.event is not None:
            self.event.record(torch.cuda.current_stream(out.device))

    def wait(self) -> bool:
        """Wait for the results; whether they were already there."""
        if self.event is None or self.event.query():
            return True
        self.event.synchronize()
        return False
