#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`music_fader_nets_tpu_torch`)
on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from `music_fader_nets_tpu_torch/csrc/`, holds each one
against its plain PyTorch version at the serving path's full-width shapes
(H=512, z=128, V=342 -> Vp=384, seq_len=100, 300 decode steps, B=64 and
B=1, float32), times kernel, plain version and, where one PyTorch call
computes the same function, that call, then drives the GM-VAE serving path
(`TransferServer`, random weights from a seed) with 130 mixed requests and
checks the responses against the plain path. Every phase prints one JSON
line; the kernels line follows, then the card's name and power limit as
nvidia-smi reports them, then the final status line. Any failed check
exits non-zero without the status line. Needs one CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet: float32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL_ENCODER = 1e-4      # finals after 100 f32 steps, two summation orders
TOL_NEAR_TIE = 1e-4     # a parting argmax must be this close to the max
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import music_fader_nets_tpu_torch  # noqa: F401  (sets TF32 off)
    from music_fader_nets_tpu_torch.config import ModelConfig
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.models.modules import global_decoder_init
    from music_fader_nets_tpu_torch.models.vae import (
        _global_view, reg_vae_encode,
    )
    from music_fader_nets_tpu_torch.ops import _build, cuda_decode, cuda_gru
    from music_fader_nets_tpu_torch.ops.gru import (
        direction_tokens, gru_init, stack_directions, vocab_pad,
    )
    from music_fader_nets_tpu_torch.ops.sampling import gumbel_rows
    from music_fader_nets_tpu_torch.serve.server import TransferServer
    from music_fader_nets_tpu_torch.transfer.arousal import (
        compute_shift_vectors,
    )
    from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    # ------------------------------------------------------------- build
    t0 = time.monotonic()
    _build.load_library()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "compiled_here": _build.BUILD_SECONDS is not None})

    def time_ms(fn, reps, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def bound(flops, nbytes):
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cfg = ModelConfig()
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    Vp = vocab_pad(V)
    T, B, L = cfg.seq_len, 64, 4
    steps = cfg.transfer_decode_steps
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    kernels = {}

    # ---------------------------------------------------- encoder kernel
    with torch.inference_mode():
        dirs = [gru_init(gen, V, H) for _ in range(L)]
        w_ih_p, b_ih, w_hh, b_hh = (t.to(dev) for t in stack_directions(dirs))
        tokens = torch.from_numpy(
            rng.integers(0, V, size=(B, T)).astype(np.int32)).to(dev)
        tok_lt = direction_tokens(tokens, [False, True, False, True])
        h0 = torch.zeros((L, B, H), device=dev)
        enc_args = (tok_lt, w_ih_p, b_ih, w_hh, b_hh, h0)
        got = cuda_gru.stacked_gru_embed_finals(*enc_args)
        ref = cuda_gru.stacked_gru_embed_finals_plain(*enc_args)
        torch.cuda.synchronize()
        enc_err = float((got - ref).abs().max())
        ms = time_ms(lambda: cuda_gru.stacked_gru_embed_finals(*enc_args), 20)
        plain_ms = time_ms(
            lambda: cuda_gru.stacked_gru_embed_finals_plain(*enc_args), 5)
        # yardstick: cuDNN computing the same finals, two bidirectional
        # nn.GRU(342, 512) on the one-hot input, carrying the same weights
        grus = []
        for s in range(2):
            g = torch.nn.GRU(V, H, batch_first=True, bidirectional=True).to(dev)
            for d, suf in ((2 * s, ""), (2 * s + 1, "_reverse")):
                getattr(g, "weight_ih_l0" + suf).copy_(w_ih_p[d, :V].t())
                getattr(g, "weight_hh_l0" + suf).copy_(w_hh[d].t())
                getattr(g, "bias_ih_l0" + suf).copy_(b_ih[d])
                getattr(g, "bias_hh_l0" + suf).copy_(b_hh[d])
            grus.append(g)
        x_oh = torch.nn.functional.one_hot(tokens.long(), V).float()

        def cudnn():
            return torch.cat([g(x_oh)[1] for g in grus])

        lib_err = float((cudnn() - got).abs().max())
        lib_ms = time_ms(cudnn, 20)
    G = 3 * H
    b_ms, b_by = bound(2.0 * L * T * B * H * G, nbytes(*enc_args) + nbytes(got))
    emit({"phase": "encoder", "shape": {"L": L, "T": T, "B": B, "H": H,
                                        "Vp": Vp},
          "max_abs_err": enc_err, "tol": TOL_ENCODER, "ms": ms,
          "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_max_abs_err": lib_err, "bound_ms": b_ms})
    if not enc_err <= TOL_ENCODER:
        return fail(f"encoder kernel vs plain: {enc_err} > {TOL_ENCODER}")
    kernels["embed_gru"] = {
        "name": "embed_gru", "route": "cuda",
        "source": "music_fader_nets_tpu_torch/csrc/embed_gru.cu",
        "replaces": "music_fader_nets_tpu/ops/pallas_gru.py:428",
        "max_abs_err": enc_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    # ----------------------------------------------------- decode kernels
    Zt = 2 * Z + cfg.chroma_dims
    with torch.inference_mode():
        gview = tree_to(global_decoder_init(gen, Zt, V, H), dev)
        res = {}
        for nb in (64, 1):
            z = torch.from_numpy(rng.standard_normal((nb, Zt))
                                 .astype(np.float32)).to(dev)
            args, _, _ = cuda_decode._prep_decode_args(gview, z)
            got = cuda_decode.cuda_greedy_decode(gview, z, steps)
            ref = cuda_decode.plain_decode_tokens(gview, z, steps)
            try:
                parted, gap = cuda_decode.near_tie_partings(
                    args, V, got, ref, tol=TOL_NEAR_TIE)
            except AssertionError as e:
                return fail(f"greedy decode B={nb}: {e}")
            kms = time_ms(
                lambda: cuda_decode.cuda_greedy_decode(gview, z, steps), 10)
            pms = (time_ms(lambda: cuda_decode.plain_decode_tokens(
                gview, z, steps), 3, warm=1) if nb == 64 else None)
            res[nb] = (z, got, kms, pms, args, gap)
            emit({"phase": "greedy_decode", "B": nb, "steps": steps,
                  "identical": bool(parted == 0), "near_tie_rows": parted,
                  "largest_gap": gap, "tol": TOL_NEAR_TIE, "ms": kms,
                  "plain_ms": pms})
        z64, greedy64, g_ms, g_plain_ms, args64, _ = res[64]
        # for token outputs the error is the largest near-tie gap at which
        # kernel and plain tokens parted (0.0: identical)
        g_err = max(r[5] for r in res.values())
        w_bytes = nbytes(*args64[:9])
        dec_flops = 2.0 * steps * 64 * (3 * H * G + H * V)
        g_bound, g_by = bound(dec_flops, w_bytes + nbytes(*args64[9:])
                              + steps * 64 * 4)
        b1_bound, _ = bound(dec_flops / 64,
                            w_bytes + nbytes(*res[1][4][9:]) + steps * 4)
        emit({"phase": "greedy_decode_bounds", "bound_ms_b64": g_bound,
              "bound_ms_b1": b1_bound, "ms_b1": res[1][2],
              "note": "B=1 is bound by step latency and L2 reads of the "
                      "~13 MB of weights each step, not by FLOPs"})
        kernels["greedy_decode"] = {
            "name": "greedy_decode", "route": "cuda",
            "source": "music_fader_nets_tpu_torch/csrc/decode.cu",
            "replaces": "music_fader_nets_tpu/ops/pallas_decode.py:83",
            "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain_ms,
            "bound_ms": g_bound, "bound_by": g_by, "library_ms": None}

        # sampling: rows alternate sampled (T = 0.9, noise) and greedy
        # (inv_t = 1, zero noise)
        seeds = [1000 + b if b % 2 == 0 else None for b in range(64)]
        noise = gumbel_rows(seeds, steps, Vp, dev)
        inv_t = torch.tensor([1.0 / 0.9 if s is not None else 1.0
                              for s in seeds], device=dev)
        got = cuda_decode.cuda_sample_decode(gview, z64, noise, inv_t, steps)
        ref = cuda_decode.plain_sample_tokens(gview, z64, noise, inv_t,
                                              steps)
        try:
            parted, gap = cuda_decode.near_tie_partings(
                args64, V, got, ref, noise, inv_t, TOL_NEAR_TIE)
        except AssertionError as e:
            return fail(f"sample decode: {e}")
        as_greedy = cuda_decode.cuda_sample_decode(
            gview, z64, torch.zeros_like(noise), torch.ones_like(inv_t),
            steps)
        bit_exact = bool(torch.equal(as_greedy, greedy64))
        greedy_rows_same = bool(torch.equal(got[1::2], greedy64[1::2]))
        s_ms = time_ms(lambda: cuda_decode.cuda_sample_decode(
            gview, z64, noise, inv_t, steps), 10)
        s_plain_ms = time_ms(lambda: cuda_decode.plain_sample_tokens(
            gview, z64, noise, inv_t, steps), 3, warm=1)
    emit({"phase": "sample_decode", "B": 64, "steps": steps,
          "identical": bool(parted == 0), "near_tie_rows": parted,
          "largest_gap": gap, "inv_t1_zero_noise_equals_greedy": bit_exact,
          "greedy_rows_in_mixed_batch_equal_greedy": greedy_rows_same,
          "ms": s_ms, "plain_ms": s_plain_ms})
    if not (bit_exact and greedy_rows_same):
        return fail("sampling kernel with inv_t=1 and zero noise differs "
                    "from the greedy kernel")
    s_bound, s_by = bound(dec_flops, w_bytes + nbytes(*args64[9:])
                          + nbytes(noise, inv_t) + steps * 64 * 4)
    kernels["sample_decode"] = {
        "name": "sample_decode", "route": "cuda",
        "source": "music_fader_nets_tpu_torch/csrc/decode.cu",
        "replaces": "music_fader_nets_tpu/ops/pallas_decode.py:116",
        "max_abs_err": gap, "ms": s_ms, "plain_ms": s_plain_ms,
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": None}

    # ----------------------------------------------------------- serving
    params = init_reg_gmvae(torch.Generator().manual_seed(SEED), cfg)
    n_req = 130
    sampled_ids = set(range(0, 16, 2))         # 8 sampled rows, all early
    dirs_cycle = ("none", "low_to_high", "high_to_low")
    reqs = []
    for i in range(n_req):
        r = {"id": i, "direction": dirs_cycle[i % 3], "lam": 1.0,
             "tokens": rng.integers(2, V, size=cfg.seq_len).tolist(),
             "return_z": i % 10 == 1}
        if i % 5 == 3 or i in sampled_ids:
            r["seed"] = 7 + i
        if i in sampled_ids:
            r["temperature"] = 0.9
        reqs.append(r)
    with TransferServer(params, cfg, steps=steps, max_batch=64,
                        max_wait_ms=5.0, device="cuda") as srv:
        # the counts of the main path's run: every kernel launch from here
        # to the read below serves a request
        for counts in (cuda_gru.LAUNCHES, cuda_decode.LAUNCHES):
            for k in counts:
                counts[k] = 0
        t0 = time.monotonic()
        futs = [srv.submit(r) for r in reqs]
        resps = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        launches = {**cuda_gru.LAUNCHES, **cuda_decode.LAUNCHES}
        stats = srv.stats()
    bad = [r for r in resps if "error" in r or len(r["tokens"]) != steps
           or min(r["tokens"]) < 0 or max(r["tokens"]) >= V]
    # reference: greedy rows recomputed by the plain path (one-hot scan
    # encoder + plain decode) on the same card
    checked, ref_parted, z_err = 0, 0, 0.0
    with torch.inference_mode():
        p_dev = tree_to(params, dev)
        shifts = compute_shift_vectors(p_dev)
        for r, resp in zip(reqs, resps):
            if "temperature" in r or "seed" in r or "error" in resp:
                continue
            tok = torch.tensor([r["tokens"]], device=dev)
            x = torch.nn.functional.one_hot(tok.long(), V).float()
            (mu_r, _), (mu_n, _) = reg_vae_encode(p_dev, x)
            if r["direction"] != "none":
                mu_r = mu_r + torch.from_numpy(
                    shifts[f"r_{r['direction']}"]).to(dev)
                mu_n = mu_n + torch.from_numpy(
                    shifts[f"n_{r['direction']}"]).to(dev)
            z = torch.cat([mu_r, mu_n, torch.zeros((1, cfg.chroma_dims),
                                                   device=dev)], dim=-1)
            if r["return_z"]:
                z_err = max(z_err, float((torch.tensor(
                    resp["z"], device=dev) - z[0]).abs().max()))
            args, _, _ = cuda_decode._prep_decode_args(
                _global_view(p_dev), z)
            ref = cuda_decode.plain_decode_tokens(_global_view(p_dev), z,
                                                  steps)
            got = torch.tensor([resp["tokens"]], device=dev)
            try:
                n, _ = cuda_decode.near_tie_partings(
                    args, V, got, ref, tol=TOL_NEAR_TIE)
            except AssertionError as e:
                return fail(f"served request {r['id']} vs plain path: {e}")
            ref_parted += n
            checked += 1
            if checked == 6:
                break
    emit({"phase": "serving", "requests": n_req, "errors": len(bad),
          "req_per_s": n_req / wall, "wall_s": wall,
          "latency_ms_p50": stats.get("latency_ms_p50"),
          "latency_ms_p95": stats.get("latency_ms_p95"),
          "batches": stats["batches"],
          "mean_batch_rows": stats["mean_batch_rows"],
          "serving_path": stats["serving_path"], "launches": launches,
          "plain_checked_rows": checked, "plain_near_tie_rows": ref_parted,
          "z_max_abs_err": z_err})
    if bad:
        return fail(f"{len(bad)} bad responses, first: {bad[0]}")
    if stats["serving_path"] != "kernel":
        return fail(f"serving_path is {stats['serving_path']!r}")
    if not all(v > 0 for v in launches.values()):
        return fail(f"a kernel of the serving path never launched: "
                    f"{launches}")
    if checked == 0 or not z_err <= TOL_ENCODER:
        return fail(f"served z vs plain path: {z_err} (rows {checked})")

    for name, k in kernels.items():
        k["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: v[k] for k in keys} for v in kernels.values()]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
