r"""The port's serving entry point: JSON-lines model serving over
stdin/stdout or TCP, plus an offered-load --bench mode.

    python -m music_fader_nets_tpu_torch.serve.cli --save-dir params \
        --bench 256

serves the `--kind` family's params (gmm: arousal transfer; vanilla / glsr:
reconstruct-only) from `--from-pt` or the checkpoint the training CLI saved
under `--save-dir`, as the evaluation CLI loads them (`--random-init`
serves seeded random weights instead, for protocol checks). Protocol: one
JSON request per line (schema in `serve/server.py`), one JSON response per
line, in request order; `{"op": "stats"}` returns serving telemetry.
Responses are pipelined, so a streaming client gets real micro-batching.
Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import collections
import json
import sys
import time

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.eval.cli import _load_params
from music_fader_nets_tpu_torch.serve.server import TransferServer
from music_fader_nets_tpu_torch.train.cli import (
    MODEL_REGISTRY, build_argparser, config_from_args,
)

SERVE_KINDS = ("gmm", "vanilla", "glsr")


def _load(kind, cfg, args):
    if args.random_init:
        return MODEL_REGISTRY[kind]["init"](
            torch.Generator().manual_seed(args.seed), cfg)
    return _load_params(kind, cfg, args)


def _bench(server: TransferServer, n: int, cfg) -> None:
    """Offered-load throughput: submit n requests at once, wait for all,
    report end-to-end transfers/s (host assembly, device work and response
    marshalling included)."""
    rng = np.random.default_rng(0)
    direction = "low_to_high" if server._shifts is not None else "none"
    reqs = [{"id": i, "direction": direction, "lam": 1.0,
             "tokens": rng.integers(2, cfg.roll_dims,
                                    size=cfg.seq_len).tolist()}
            for i in range(n)]
    server.request(reqs[0])                     # warm
    t0 = time.monotonic()
    futs = [server.submit(r) for r in reqs]
    for f in futs:
        resp = f.result()
        if "error" in resp:
            raise RuntimeError(f"bench request failed: {resp}")
    dt = time.monotonic() - t0
    stats = server.stats()
    print(json.dumps({
        "metric": "serve_transfers_per_sec", "value": n / dt,
        "unit": "req/s", "requests": n, "steps": server.steps,
        "max_batch": server.max_batch, "serving_path": server.serving_path,
        "device": (torch.cuda.get_device_name(server.device)
                   if server.device.type == "cuda" else "cpu"),
        "mean_batch_rows": stats["mean_batch_rows"],
        "latency_ms_p50": stats.get("latency_ms_p50"),
        "latency_ms_p95": stats.get("latency_ms_p95"),
    }))


def _stdin_loop(server: TransferServer) -> None:
    pending = collections.deque()

    def flush(block: bool) -> None:
        while pending and (block or pending[0].done()):
            print(json.dumps(pending.popleft().result()), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            flush(block=True)      # keep output in request order
            print(json.dumps({"error": f"bad json: {e}"}), flush=True)
            continue
        if isinstance(req, dict) and req.get("op") == "stats":
            flush(block=True)
            print(json.dumps(server.stats()), flush=True)
            continue
        pending.append(server.submit(req))
        flush(block=False)
    flush(block=True)


def _tcp_loop(server: TransferServer, port: int) -> None:
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                try:
                    req = json.loads(raw.decode())
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    resp = {"error": f"bad json: {e}"}
                else:
                    resp = (server.stats()
                            if isinstance(req, dict)
                            and req.get("op") == "stats"
                            else server.submit(req).result())
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    class Srv(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Srv(("127.0.0.1", port), Handler) as srv:
        print(f"serving on 127.0.0.1:{srv.server_address[1]}", flush=True)
        srv.serve_forever()


def run_server(argv=None) -> None:
    ap = build_argparser("Micro-batched fader-generation model server "
                         "(PyTorch + CUDA)")
    ap.add_argument("--kind", default="gmm", choices=SERVE_KINDS,
                    help="model family (gmm serves arousal transfer; "
                         "vanilla/glsr reconstruct-only)")
    ap.add_argument("--steps", type=int, default=None,
                    help="decode length (default: cfg.transfer_decode_steps"
                         " = 300)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--tcp", type=int, default=None,
                    help="serve a TCP port instead of stdin/stdout")
    ap.add_argument("--bench", type=int, default=None, metavar="N",
                    help="offered-load mode: N synthetic requests, print "
                         "one throughput JSON line and exit")
    ap.add_argument("--random-init", action="store_true",
                    help="serve random weights made from --seed instead "
                         "of a checkpoint (protocol smoke testing)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config_from_args(args.kind, args)
    params = _load(args.kind, cfg, args)
    server = TransferServer(params, cfg, steps=args.steps,
                            max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms, device=dev)
    print(f"# serving kind={args.kind} steps={server.steps} "
          f"max_batch={server.max_batch} device={server.device} "
          f"path={server.serving_path}", file=sys.stderr)
    try:
        if args.bench is not None:
            _bench(server, args.bench, cfg)
        elif args.tcp is not None:
            _tcp_loop(server, args.tcp)
        else:
            _stdin_loop(server)
    finally:
        server.close()


if __name__ == "__main__":
    run_server()
