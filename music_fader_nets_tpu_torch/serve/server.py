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
    asynchronously on the current CUDA stream; a fetch thread materialises
    results with `.cpu()`, where device faults surface, so batch N+1
    launches while batch N's tokens come back (at most `pipeline_depth`
    batches in flight).

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
"""
from __future__ import annotations

import itertools
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

_DIRECTIONS = ("none", "low_to_high", "high_to_low")


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
        # builds the kernels on first use and surfaces any launch failure
        # here, at construction
        self._warmup()
        self._nonce = itertools.count(1)

        self._q: "queue.Queue" = queue.Queue()
        # a semaphore (not a bounded queue, whose slot would free at fetch
        # START) holds each launch slot until its fetch COMPLETES
        self._inflight: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(max(1, int(pipeline_depth)))
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "batch_rows": 0,
                       "rejected": 0}
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

    def _run(self, tokens, chroma, shift_r, shift_n, lam, eps_r, eps_n,
             noise_seeds=None, inv_t=None):
        """Enqueue one padded batch on the device: encode -> z -> decode.
        Returns device tensors (tokens (B, steps) int32, z (B, Z_total));
        nothing here waits for the device."""
        dev = self.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        with torch.inference_mode():
            (mu_r, std_r), (mu_n, std_n) = reg_vae_encode(
                self.params, None, tokens=t(tokens))
            # eps rows are ZERO for deterministic (mean) rows
            lam_t = t(lam)[:, None]
            z_r = reparameterize(mu_r, std_r, t(eps_r)) + lam_t * t(shift_r)
            z_n = reparameterize(mu_n, std_n, t(eps_n)) + lam_t * t(shift_n)
            z = torch.cat([z_r, z_n, t(chroma)], dim=-1)
            if noise_seeds is None:
                out = cuda_greedy_decode(self._gview, z, self.steps)
            else:
                noise = gumbel_rows(noise_seeds, self.steps, self._vp, dev)
                out = cuda_sample_decode(self._gview, z, noise, t(inv_t),
                                         self.steps)
        return out, z

    def _warmup(self) -> None:
        B, cfg = self.max_batch, self.cfg
        z = np.zeros((B, cfg.z_dims), np.float32)
        out, _ = self._run(np.zeros((B, cfg.seq_len), np.int32),
                           np.zeros((B, cfg.chroma_dims), np.float32),
                           z, z, np.zeros((B,), np.float32), z, z)
        out.cpu()

    def _dispatch_loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._closed:
                    break
                continue
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    item = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if item is None:
                    self._closed = True
                    break
                batch.append(item)
            try:
                self._launch_batch(batch)
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

    def _launch_batch(self, batch) -> None:
        """Assemble and enqueue one padded batch; the fetch thread brings
        the results back and resolves the futures."""
        B, cfg = self.max_batch, self.cfg
        tokens = np.zeros((B, cfg.seq_len), np.int32)
        chroma = np.zeros((B, cfg.chroma_dims), np.float32)
        shift_r = np.zeros((B, cfg.z_dims), np.float32)
        shift_n = np.zeros((B, cfg.z_dims), np.float32)
        lam = np.zeros((B,), np.float32)
        eps_r = np.zeros((B, cfg.z_dims), np.float32)
        eps_n = np.zeros((B, cfg.z_dims), np.float32)
        inv_t = np.ones((B,), np.float32)
        noise_seeds: List[Optional[int]] = [None] * B
        for i, (row, _, _) in enumerate(batch):
            tokens[i] = row["tokens"]
            chroma[i] = row["chroma"]
            if row["direction"] != "none":
                shift_r[i] = self._shifts[f"r_{row['direction']}"]
                shift_n[i] = self._shifts[f"n_{row['direction']}"]
                lam[i] = row["lam"]
            if row["seed"] is not None:
                rng = np.random.default_rng(row["seed"])
                eps_r[i] = rng.standard_normal(cfg.z_dims)
                eps_n[i] = rng.standard_normal(cfg.z_dims)
            if row["temperature"] > 0:
                inv_t[i] = 1.0 / row["temperature"]
                noise_seeds[i] = (row["seed"] if row["seed"] is not None
                                  else next(self._nonce))
        sampled = any(s is not None for s in noise_seeds)

        # backpressure: blocks once pipeline_depth batches are in flight
        self._slots.acquire()
        t0 = time.monotonic()
        try:
            out, z = self._run(tokens, chroma, shift_r, shift_n, lam, eps_r,
                               eps_n, noise_seeds if sampled else None,
                               inv_t)
        except Exception:
            self._slots.release()    # never leak a launch slot
            raise
        self._inflight.put((batch, out, z, t0))

    def _fetch_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, out_dev, z_dev, t0 = item
            try:
                out = out_dev.cpu().numpy()
                z = (z_dev.cpu().numpy()
                     if any(row["return_z"] for row, _, _ in batch)
                     else None)
            except Exception as e:   # device-side failure surfaces here
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_result({"error": f"batch failed: {e!r}"})
                continue
            finally:
                self._slots.release()
            batch_ms = (time.monotonic() - t0) * 1e3
            n = len(batch)
            done_t = time.monotonic()
            with self._lock:
                self._stats["requests"] += n
                self._stats["batches"] += 1
                self._stats["batch_rows"] += n
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
