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
checks the responses against the plain path. Then the training kernels
(encoder, sub-decoders, decoder + cross-entropy; forward and backward) are
held, values and every gradient, against autograd of their plain versions
at the training shapes (B=128), and the GM-VAE `Trainer` takes supervised
B=32 and unsupervised B=128 steps and an evaluation pass at full width on
random in-schema batches, its first step's loss and gradients held against
the plain path on the card. The generic stacked-GRU kernels (the CVAE
encoder's shape, L=2, I=344) and the decoder with the masses head (GLSR's
perturbation decode, 4 x 128 rows) are held the same way, and the other
five families (vanilla RegVAE, GLSR, CVAE, FaderNets, SingleVAE) each
train 5 steps at B=128 through their `Trainer`, first step against the
plain path, timed over the last 3. Every phase prints one JSON
line; the kernels line follows, then the card's name and power limit as
nvidia-smi reports them, then the final status line. Any failed check
exits non-zero without the status line. Needs one CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
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
# training kernels against autograd of their plain versions, float32 with
# other summation orders: outputs to an absolute bound; each gradient
# tensor to a bound relative to its largest entry, or to 1e-3 where that
# entry is smaller (a gradient that is float32 noise around an exact 0,
# such as the sub-decoders' output biases under their time-axis
# log-softmax, has no scale of its own). A weight gradient sums T*B =
# 12,800 products.
TOL_TRAIN_OUT = 1e-4
TOL_TRAIN_GRAD_REL = 1e-4
GRAD_SCALE_FLOOR = 1e-3
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


@contextlib.contextmanager
def plain_path(cuda_gru, cuda_decoder, cuda_stacked):
    """Route the training path's five kernel wrappers to their plain
    versions while the block runs, on CUDA tensors as well: the reference
    the kernel path is held to on the same card."""
    swaps = [(cuda_gru, "stacked_gru_embed_finals"),
             (cuda_gru, "stacked_gru_embed_seq"),
             (cuda_decoder, "decoder_teacher_nll"),
             (cuda_decoder, "decoder_teacher_masses"),
             (cuda_stacked, "stacked_gru")]
    saved = [getattr(m, name) for m, name in swaps]
    for m, name in swaps:
        setattr(m, name, getattr(m, name + "_plain"))
    try:
        yield
    finally:
        for (m, name), fn in zip(swaps, saved):
            setattr(m, name, fn)


def leaf_errors(got, want):
    """(absolute error, error relative to the tensor's largest entry,
    floored at GRAD_SCALE_FLOOR) for each pair of gradient tensors; None
    counts as 0."""
    import torch
    errs = []
    for a, b in zip(got, want):
        if a is None and b is None:
            errs.append((0.0, 0.0))
            continue
        a = torch.zeros_like(b) if a is None else a
        b = torch.zeros_like(a) if b is None else b
        e = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        errs.append((e, e / max(scale, GRAD_SCALE_FLOOR)))
    return errs


def grad_errors(got, want):
    """(largest absolute error, largest relative error) of `leaf_errors`."""
    errs = leaf_errors(got, want)
    return (max((e[0] for e in errs), default=0.0),
            max((e[1] for e in errs), default=0.0))


def named_leaves(tree, prefix=""):
    """(path, tensor) of each leaf of a nested dict, in dict order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def worst_leaf(got, want, names):
    """`grad_errors` with the name of the leaf that holds the largest
    relative error."""
    errs = leaf_errors(got, want)
    i = max(range(len(errs)), key=lambda j: errs[j][1])
    return {"grad_max_abs_err": max(e[0] for e in errs),
            "grad_max_rel_err": errs[i][1], "worst_leaf": names[i]}


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
    from music_fader_nets_tpu_torch.data.datasets import (
        VGMIDIDataset, YamahaDataset,
    )
    from music_fader_nets_tpu_torch.ops import (
        _build, cuda_decode, cuda_decoder, cuda_gru, cuda_stacked,
    )
    from music_fader_nets_tpu_torch.ops.gru import (
        direction_tokens, gru_init, stack_directions, vocab_pad,
    )
    from music_fader_nets_tpu_torch.ops.sampling import gumbel_rows
    from music_fader_nets_tpu_torch.serve.server import TransferServer
    from music_fader_nets_tpu_torch.losses.regularizers import (
        GLSR_MASK_RANGES,
    )
    from music_fader_nets_tpu_torch.train.objectives import gmm_loss
    from music_fader_nets_tpu_torch.train.profile import (
        FAMILIES, random_corpus,
    )
    from music_fader_nets_tpu_torch.train.trainer import Trainer
    from music_fader_nets_tpu_torch.transfer.arousal import (
        compute_shift_vectors,
    )
    from music_fader_nets_tpu_torch.utils.checkpoint import tree_map, tree_to

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
    if not all(launches[k] > 0 for k in kernels):
        return fail(f"a kernel of the serving path never launched: "
                    f"{launches}")
    if checked == 0 or not z_err <= TOL_ENCODER:
        return fail(f"served z vs plain path: {z_err} (rows {checked})")

    serving_launches = launches

    # ------------------------------------------------- training kernels
    # Each kernel pair (training forward with the gate stash, backward) is
    # driven through its autograd Function and held, output and every
    # gradient, against autograd of its plain version on the same inputs
    # and output cotangent. Forward and backward are timed apart: the
    # backward as torch.autograd.grad over a retained graph.
    def fwd_bwd(fn, ids, floats, cot):
        ts = [t.detach().clone().requires_grad_(True) for t in floats]
        out = fn(ids, *ts)
        grads = torch.autograd.grad(out, ts, cot, retain_graph=True)
        return ts, out, grads

    def time_fwd_bwd(fn, ids, ts, cot, reps, warm=2):
        f_ms = time_ms(lambda: fn(ids, *ts), reps, warm)
        out = fn(ids, *ts)
        b_ms = time_ms(lambda: torch.autograd.grad(out, ts, cot,
                                                   retain_graph=True),
                       reps, warm)
        return f_ms, b_ms

    def train_kernel_phase(phase, names, srcs, replaces, fn, plain, ids,
                           floats, cot, shape, flops, lib=None, extra=None):
        """names/srcs/replaces: (forward, backward). flops: (forward,
        backward). lib: (forward callable, its leaves, its cotangent) or
        None. extra: more keys for the phase's line."""
        ts, out, grads = fwd_bwd(fn, ids, floats, cot)
        _, out_p, grads_p = fwd_bwd(plain, ids, floats, cot)
        torch.cuda.synchronize()
        out_err = float((out - out_p).detach().abs().max())
        g_abs, g_rel = grad_errors(grads, grads_p)
        k_f, k_b = time_fwd_bwd(fn, ids, ts, cot, 10)
        p_ts = [t.detach().clone().requires_grad_(True) for t in floats]
        p_f, p_b = time_fwd_bwd(plain, ids, p_ts, cot, 3, warm=1)
        l_f = l_b = lib_err = None
        if lib is not None:
            lib_fn, lib_leaves, lib_cot = lib
            with torch.no_grad():
                lib_err = float((lib_fn() - out).abs().max())
            l_f = time_ms(lib_fn, 10)
            lib_out = lib_fn()
            l_b = time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, lib_cot, retain_graph=True), 10)
        in_bytes = nbytes(ids, *floats)
        f_bound, f_by = bound(flops[0], in_bytes + nbytes(out))
        b_bound, b_by = bound(flops[1], in_bytes + nbytes(cot, *grads))
        emit({"phase": phase, "shape": shape, "out_max_abs_err": out_err,
              "tol_out": TOL_TRAIN_OUT, "grad_max_abs_err": g_abs,
              "grad_max_rel_err": g_rel, "tol_grad_rel": TOL_TRAIN_GRAD_REL,
              "fwd_ms": k_f, "bwd_ms": k_b, "fwd_bwd_ms": k_f + k_b,
              "plain_fwd_ms": p_f, "plain_bwd_ms": p_b,
              "library_fwd_ms": l_f, "library_bwd_ms": l_b,
              "library_max_abs_err": lib_err, "bound_fwd_ms": f_bound,
              "bound_bwd_ms": b_bound, **(extra or {})})
        if not (out_err <= TOL_TRAIN_OUT and g_rel <= TOL_TRAIN_GRAD_REL):
            return fail(f"{phase}: kernel vs plain output {out_err}, "
                        f"gradients {g_rel} (relative)")
        for i, (nm, src, rep, err, ms_, pms, lms, bd, by) in enumerate((
                (names[0], srcs[0], replaces[0], out_err, k_f, p_f, l_f,
                 f_bound, f_by),
                (names[1], srcs[1], replaces[1], g_abs, k_b, p_b, l_b,
                 b_bound, b_by))):
            kernels[nm] = {
                "name": nm, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": err, "ms": ms_,
                "plain_ms": pms, "bound_ms": bd, "bound_by": by,
                "library_ms": lms}
        return 0

    del resps, futs
    TB = cfg.batch_size                                   # 128
    csrc = "music_fader_nets_tpu_torch/csrc/"
    pg = "music_fader_nets_tpu/ops/pallas_gru.py:"

    # encoder: L=4 directions, T=100, B=128, Vp=384 (kernels 3-train, 4)
    dirs = [gru_init(gen, V, H) for _ in range(L)]
    w_ih_p, b_ih, w_hh, b_hh = (t.to(dev) for t in stack_directions(dirs))
    tokens = torch.from_numpy(
        rng.integers(0, V, size=(TB, T)).astype(np.int32)).to(dev)
    tok_lt = direction_tokens(tokens, [False, True, False, True])
    h0 = (torch.randn((L, TB, H), generator=gen) * 0.1).to(dev)
    cot = torch.randn((L, TB, H), generator=gen).to(dev)
    grus = []
    for s in range(2):
        g = torch.nn.GRU(V, H, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, suf in ((2 * s, ""), (2 * s + 1, "_reverse")):
                getattr(g, "weight_ih_l0" + suf).copy_(w_ih_p[d, :V].t())
                getattr(g, "weight_hh_l0" + suf).copy_(w_hh[d].t())
                getattr(g, "bias_ih_l0" + suf).copy_(b_ih[d])
                getattr(g, "bias_hh_l0" + suf).copy_(b_hh[d])
        grus.append(g)
    x_oh = torch.nn.functional.one_hot(tokens.long(), V).float()
    h0_lib = h0.clone().requires_grad_(True)

    def cudnn_enc():
        return torch.cat([g_(x_oh, h0_lib[2 * i:2 * i + 2])[1]
                          for i, g_ in enumerate(grus)])

    enc_leaves = [p_ for g_ in grus for p_ in g_.parameters()] + [h0_lib]
    enc_f = 2.0 * L * T * TB * H * G
    rc = train_kernel_phase(
        "train_encoder_kernels", ("embed_gru_train", "embed_gru_bwd"),
        (csrc + "embed_gru.cu", csrc + "embed_gru_bwd.cu"),
        (pg + "428", pg + "536"), cuda_gru.stacked_gru_embed_finals,
        cuda_gru.stacked_gru_embed_finals_plain, tok_lt,
        [w_ih_p, b_ih, w_hh, b_hh, h0], cot,
        {"L": L, "T": T, "B": TB, "H": H, "Vp": Vp},
        (enc_f, 2 * enc_f), lib=(cudnn_enc, enc_leaves, cot))
    if rc:
        return rc
    del grus, x_oh, dirs

    # sub-decoders: L=2 (rhythm, note), T=16, B=128, classes padded to
    # dm=16 rows, prez = z @ w_z + b_ih (kernels 5, 6)
    A, C = cfg.attr_len, max(cfg.rhythm_dims, cfg.note_dims)
    s_gru = [gru_init(gen, C + Z, H) for _ in range(2)]
    w_emb = torch.stack([p_["w_ih"][:C] for p_ in s_gru]).to(dev)
    w_z = torch.stack([p_["w_ih"][C:] for p_ in s_gru]).to(dev)
    s_bih = torch.stack([p_["b_ih"] for p_ in s_gru]).to(dev)
    s_whh = torch.stack([p_["w_hh"] for p_ in s_gru]).to(dev)
    s_bhh = torch.stack([p_["b_hh"] for p_ in s_gru]).to(dev)
    zs = torch.randn((2, TB, Z), generator=gen).to(dev)
    prez = torch.bmm(zs, w_z) + s_bih[:, None, :]
    s_h0 = (torch.randn((2, TB, H), generator=gen) * 0.5).to(dev)
    cls_lt = torch.from_numpy(np.stack([
        rng.integers(0, cfg.rhythm_dims, (A, TB)),
        rng.integers(0, cfg.note_dims, (A, TB))]).astype(np.int32)).to(dev)
    s_cot = torch.randn((2, A, TB, H), generator=gen).to(dev)
    sub_lib = []
    for i in range(2):
        g = torch.nn.GRU(C + Z, H, batch_first=True).to(dev)
        with torch.no_grad():
            g.weight_ih_l0.copy_(torch.cat([w_emb[i], w_z[i]]).t())
            g.weight_hh_l0.copy_(s_whh[i].t())
            g.bias_ih_l0.copy_(s_bih[i])
            g.bias_hh_l0.copy_(s_bhh[i])
        sub_lib.append(g)
    sub_x = [torch.cat([torch.nn.functional.one_hot(
        cls_lt[i].t().long(), C).float(),
        zs[i][:, None, :].expand(TB, A, Z)], dim=-1) for i in range(2)]
    s_h0_lib = s_h0.clone().requires_grad_(True)

    def cudnn_sub():
        return torch.stack([g_(sub_x[i], s_h0_lib[i:i + 1])[0].transpose(
            0, 1) for i, g_ in enumerate(sub_lib)])

    sub_leaves = [p_ for g_ in sub_lib for p_ in g_.parameters()] + [
        s_h0_lib]
    sub_f = 2.0 * 2 * A * TB * H * G
    rc = train_kernel_phase(
        "train_subdecoder_kernels", ("embed_seq", "embed_seq_bwd"),
        (csrc + "embed_gru.cu", csrc + "embed_gru_bwd.cu"),
        (pg + "779", pg + "888"), cuda_gru.stacked_gru_embed_seq,
        cuda_gru.stacked_gru_embed_seq_plain, cls_lt,
        [w_emb, prez, s_whh, s_bhh, s_h0], s_cot,
        {"L": 2, "T": A, "B": TB, "H": H, "C": C},
        (sub_f, 2 * sub_f), lib=(cudnn_sub, sub_leaves, s_cot))
    if rc:
        return rc
    del sub_lib, sub_x

    # decoder + cross-entropy: T=100, B=128, Vp=384 (kernels 9, 10)
    d_tgt = torch.from_numpy(
        rng.integers(0, V, size=(T, TB)).astype(np.int32)).to(dev)
    d_tok = torch.cat([torch.full((1, TB), V - 1, dtype=torch.int32,
                                  device=dev), d_tgt[:-1]])
    g1, g2 = gview["grucell_g"], gview["grucell_g_2"]
    d_wtok = torch.nn.functional.pad(g1["w_ih"][:V], (0, 0, 0, Vp - V))
    d_prez = (torch.randn((TB, Zt), generator=gen).to(dev)
              @ g1["w_ih"][V:] + g1["b_ih"])
    d_h10 = (torch.randn((TB, H), generator=gen) * 0.5).to(dev)
    d_wout = torch.nn.functional.pad(gview["linear_out_g"]["w"],
                                     (0, Vp - V))
    d_bout = torch.nn.functional.pad(gview["linear_out_g"]["b"], (0, Vp - V),
                                     value=cuda_decoder.PAD_LOGIT)
    d_cot = torch.full((T, TB), 1.0 / (T * TB), device=dev)

    def with_tgt(f):
        return lambda ids, *fl: f(ids, d_tgt, *fl)

    dec_f = 2.0 * T * TB * (3 * H * G + H * Vp)
    rc = train_kernel_phase(
        "train_decoder_ce_kernels", ("decoder_ce", "decoder_ce_bwd"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1482", pg + "1627"),
        with_tgt(cuda_decoder.decoder_teacher_nll),
        with_tgt(cuda_decoder.decoder_teacher_nll_plain), d_tok,
        [d_wtok, d_prez, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
         g2["w_hh"], g2["b_hh"], d_h10, d_wout, d_bout], d_cot,
        {"T": T, "B": TB, "H": H, "Vp": Vp},
        (dec_f, 2.0 * T * TB * (6 * H * G + 3 * H * Vp)))
    if rc:
        return rc

    # generic stacked GRU: the CVAE encoder's L=2 directions over the
    # hoisted projections of x_in = [one-hot, r_density, n_density]
    # (I = 344), T=100, B=128 (kernels 1, 2). Yardstick: cuDNN's
    # bidirectional nn.GRU over x_in with the same weights, which also does
    # the input projection; the kernel's row leaves that to an einsum,
    # timed apart (einsum_ms) so the two compare as einsum + kernel.
    I = V + 2
    e_dirs = [gru_init(gen, I, H) for _ in range(2)]
    e_wih = torch.stack([d["w_ih"] for d in e_dirs]).to(dev)
    e_bih = torch.stack([d["b_ih"] for d in e_dirs]).to(dev)
    e_whh = torch.stack([d["w_hh"] for d in e_dirs]).to(dev)
    e_bhh = torch.stack([d["b_hh"] for d in e_dirs]).to(dev)
    e_dens = torch.rand((TB, 1, 2), generator=gen).to(dev)
    x_in = torch.cat([torch.nn.functional.one_hot(tokens.long(), V).float(),
                      e_dens.expand(TB, T, 2)], dim=-1)

    def project():
        x_dir = torch.stack([x_in, x_in.flip(1)])
        return (torch.einsum("lbti,lig->ltbg", x_dir, e_wih)
                + e_bih[:, None, None, :])

    e_pre = project()
    einsum_ms = time_ms(project, 10)
    e_h0 = (torch.randn((2, TB, H), generator=gen) * 0.1).to(dev)
    e_cot = torch.randn((2, T, TB, H), generator=gen).to(dev)
    e_gru = torch.nn.GRU(I, H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, suf in ((0, ""), (1, "_reverse")):
            getattr(e_gru, "weight_ih_l0" + suf).copy_(e_wih[d].t())
            getattr(e_gru, "weight_hh_l0" + suf).copy_(e_whh[d].t())
            getattr(e_gru, "bias_ih_l0" + suf).copy_(e_bih[d])
            getattr(e_gru, "bias_hh_l0" + suf).copy_(e_bhh[d])
    e_h0_lib = e_h0.clone().requires_grad_(True)

    def cudnn_stacked():
        out = e_gru(x_in, e_h0_lib)[0]                     # (B, T, 2H)
        return torch.stack([out[..., :H].transpose(0, 1),
                            out[..., H:].flip(1).transpose(0, 1)])

    e_leaves = list(e_gru.parameters()) + [e_h0_lib]
    no_ids = torch.empty(0, dtype=torch.int32, device=dev)

    def skip_ids(f):
        return lambda ids, *fl: f(*fl)

    st_f = 2.0 * 2 * T * TB * H * G
    rc = train_kernel_phase(
        "train_stacked_gru_kernels", ("stacked_gru", "stacked_gru_bwd"),
        (csrc + "stacked_gru.cu", csrc + "stacked_gru.cu"),
        (pg + "147", pg + "238"), skip_ids(cuda_stacked.stacked_gru),
        skip_ids(cuda_stacked.stacked_gru_plain), no_ids,
        [e_pre, e_whh, e_bhh, e_h0], e_cot,
        {"L": 2, "T": T, "B": TB, "H": H, "I": I},
        (st_f, 2 * st_f), lib=(cudnn_stacked, e_leaves, e_cot),
        extra={"einsum_ms": einsum_ms,
               "library_note": "cuDNN bidirectional nn.GRU over x_in "
                               "includes the input projection: compare "
                               "it with einsum_ms + ms"})
    if rc:
        return rc
    del e_gru, e_leaves, x_in, e_pre, e_cot

    # decoder + masses head: GLSR's perturbation decode, B0=128 token rows
    # shared by n_rep=4 copies (512 rows), T=100, K=2 ranges (kernels 9,
    # 10 with head = ranges)
    n_rep, MB = 4, 4 * TB
    m_prez = (torch.randn((MB, Zt), generator=gen).to(dev)
              @ g1["w_ih"][V:] + g1["b_ih"])
    m_h10 = (torch.randn((MB, H), generator=gen) * 0.5).to(dev)
    m_cot = (torch.randn((T, len(GLSR_MASK_RANGES), MB), generator=gen)
             / (T * TB)).to(dev)

    def with_ranges(f):
        return lambda ids, *fl: f(ids, *fl, GLSR_MASK_RANGES, n_rep)

    rc = train_kernel_phase(
        "train_decoder_masses_kernels",
        ("decoder_masses", "decoder_masses_bwd"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1482", pg + "1627"),
        with_ranges(cuda_decoder.decoder_teacher_masses),
        with_ranges(cuda_decoder.decoder_teacher_masses_plain), d_tok,
        [d_wtok, m_prez, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
         g2["w_hh"], g2["b_hh"], m_h10, d_wout, d_bout], m_cot,
        {"T": T, "B0": TB, "n_rep": n_rep, "rows": MB, "H": H, "Vp": Vp,
         "K": len(GLSR_MASK_RANGES)},
        (2.0 * T * MB * (3 * H * G + H * Vp),
         2.0 * T * MB * (6 * H * G + 3 * H * Vp)))
    if rc:
        return rc
    del m_prez, m_h10, m_cot

    # ------------------------------------------------------- train step
    # The port's Trainer at ModelConfig() widths on random in-schema
    # batches: the dual-corpus loop's supervised (VGMIDI-shaped, B=32) and
    # unsupervised (Yamaha-shaped, B=128) phases and an evaluation pass.
    # First, its first step's loss and gradients on the kernel path
    # against the plain path on this card, same batch and noise.
    tr = Trainer(cfg, init_reg_gmvae, {
        "default": gmm_loss,
        "supervised": functools.partial(gmm_loss, is_supervised=True)},
        seed=SEED, params=params, device="cuda")
    SB = 32
    yam = YamahaDataset(*random_corpus(cfg, 10 * TB, SEED),
                        mode="train").arrays()            # 8 batches
    vg = VGMIDIDataset(*random_corpus(cfg, 7 * SB, SEED + 1,
                                      supervised=True),
                       mode="train").arrays()             # 6 batches
    first = {k: torch.from_numpy(v[:TB]).to(dev) for k, v in yam.items()}
    eps = tuple(e.to(dev) for e in tr.noise_fn(0, TB, gmm_loss))
    leaves = tr.optimizer.param_groups[0]["params"]        # Adam's leaves

    def loss_grads():
        loss, _ = gmm_loss(tr.fast_params, eps, first, 0, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)

    loss_k, grads_k = loss_grads()
    paths = (cuda_gru.LAST_TRAIN_PATH, cuda_decoder.LAST_TRAIN_PATH)
    with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
        loss_p, grads_p = loss_grads()
    torch.cuda.synchronize()
    step_loss_err = abs(float(loss_k) - float(loss_p))
    step_abs, step_rel = grad_errors(grads_k, grads_p)
    del grads_k, grads_p

    def take(arrays, lo, hi):
        return {k: v[lo:hi] for k, v in arrays.items()}

    for counts in (cuda_gru.LAUNCHES, cuda_decoder.LAUNCHES):
        for k in counts:
            counts[k] = 0
    runs = {}
    for name, arrays, bs, variant in (("unsupervised", yam, TB, "default"),
                                      ("supervised", vg, SB, "supervised")):
        warm = tr.run_epoch(take(arrays, 0, 2 * bs), variant,
                            batch_size=bs, seed=1)
        n_timed = len(arrays["x"]) // bs - 2
        t0 = time.monotonic()
        timed = tr.run_epoch(take(arrays, 2 * bs, (2 + n_timed) * bs),
                             variant, batch_size=bs, seed=2)
        wall = time.monotonic() - t0
        runs[name] = {"B": bs, "steps": 2 + n_timed, "warm": warm,
                      "timed": timed, "ms_per_step": wall * 1e3 / n_timed,
                      "seq_per_s": n_timed * bs / wall,
                      "train_path": tr.train_path}
    evals = tr.run_epoch(take(yam, 0, 2 * TB), train=False, shuffle=False,
                         batch_size=TB)
    torch.cuda.synchronize()
    train_launches = {**cuda_gru.LAUNCHES, **cuda_decoder.LAUNCHES}
    finite = all(np.isfinite(v) for r in runs.values()
                 for m in (r["warm"], r["timed"]) for v in m.values()) and \
        all(np.isfinite(v) for v in evals.values())
    emit({"phase": "train_step", "first_step": {
              "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
              "loss_abs_err": step_loss_err, "grad_max_abs_err": step_abs,
              "grad_max_rel_err": step_rel, "tol_grad_rel": TOL_TRAIN_GRAD_REL,
              "kernel_paths": paths},
          "runs": runs, "eval": evals, "finite": finite,
          "train_path": tr.train_path, "launches": train_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if paths != ("kernel", "kernel"):
        return fail(f"first step ran {paths}, not the kernels")
    if not (step_loss_err <= TOL_TRAIN_OUT * max(1.0, abs(float(loss_p)))
            and step_rel <= TOL_TRAIN_GRAD_REL):
        return fail(f"first step kernel vs plain: loss {step_loss_err}, "
                    f"gradients {step_rel} (relative)")
    if not finite:
        return fail("a training loss is not finite")
    if any(r["train_path"] != "kernel" for r in runs.values()):
        return fail(f"train_path: {[r['train_path'] for r in runs.values()]}")
    train_kernels = ("embed_gru_train", "embed_gru_bwd", "embed_seq",
                     "embed_seq_bwd", "decoder_ce", "decoder_ce_bwd")
    if not all(train_launches[k] > 0 for k in train_kernels):
        return fail(f"a training kernel never launched: {train_launches}")

    # ----------------------------------------------- the other families
    # Each family's Trainer at ModelConfig() widths on random in-schema
    # batches at B=128: its first step's loss and gradients on the kernel
    # path against the plain path on this card, at a step where every term
    # of its loss counts (GLSR at 21, where its regularizer and so the
    # masses head's cotangent start; the others at 1000, inside the KL and
    # adversarial ramps), both also against a float64 run of the plain
    # path (the witness of which float32 path strays), then 2 warm-up
    # and 3 timed steps with the counts set to 0 just before and read just
    # after. Each family's failure ends the run.
    family_kernels = {"vanilla": (), "glsr": ("decoder_masses",
                                              "decoder_masses_bwd"),
                      "cvae": ("stacked_gru", "stacked_gru_bwd"),
                      "fader": (), "singlevae": ()}
    fam_corpus = YamahaDataset(*random_corpus(cfg, 7 * TB, SEED + 2),
                               mode="train").arrays()     # 5 batches
    fam_first = {k: torch.from_numpy(v[:TB]).to(dev)
                 for k, v in fam_corpus.items()}
    all_counts = (cuda_gru.LAUNCHES, cuda_decoder.LAUNCHES,
                  cuda_stacked.LAUNCHES)
    family_launches = {}
    for fam in family_kernels:
        init_fn, loss_fn, profile_step = FAMILIES[fam]
        first_step = profile_step or 1000        # GLSR's 21, else 1000
        ftr = Trainer(cfg, init_fn, {"default": loss_fn}, seed=SEED,
                      device="cuda")
        ftr.step = first_step
        f_eps = tuple(e.to(dev) for e in ftr.noise_fn(0, TB, loss_fn))
        f_leaves = ftr.optimizer.param_groups[0]["params"]
        leaf_name = {id(t): name for name, t in named_leaves(ftr.fast_params)}

        def f_loss_grads(params=ftr.fast_params, eps=f_eps, batch=fam_first,
                         leaves=f_leaves):
            loss, _ = loss_fn(params, eps, batch, first_step, cfg)
            return loss.detach(), torch.autograd.grad(loss, leaves,
                                                      allow_unused=True)

        for m in (cuda_gru, cuda_decoder, cuda_stacked):
            m.LAST_TRAIN_PATH = None
        f_loss_k, f_grads_k = f_loss_grads()
        f_paths = sorted({m.LAST_TRAIN_PATH for m in (
            cuda_gru, cuda_decoder, cuda_stacked)} - {None})
        copies = {}

        def to64(t):
            c = t.detach().double().requires_grad_(t.requires_grad)
            copies[id(t)] = c
            return c

        p64 = tree_map(to64, ftr.fast_params)
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            f_loss_p, f_grads_p = f_loss_grads()
            f_loss_64, f_grads_64 = f_loss_grads(
                p64, tuple(e.double() for e in f_eps),
                {k: v.double() if v.is_floating_point() else v
                 for k, v in fam_first.items()},
                [copies[id(t)] for t in f_leaves])
        torch.cuda.synchronize()
        f_loss_err = abs(float(f_loss_k) - float(f_loss_p))
        names = [leaf_name[id(t)] for t in f_leaves]
        f_worst = worst_leaf(f_grads_k, f_grads_p, names)
        f_abs, f_rel = f_worst["grad_max_abs_err"], f_worst["grad_max_rel_err"]
        # both float32 paths against the float64 one: if both are right
        # they sit about equally far from it
        f_witness = {
            key: {**worst_leaf(g, f_grads_64, names),
                  "loss_abs_err": abs(float(loss) - float(f_loss_64))}
            for key, loss, g in (("kernel", f_loss_k, f_grads_k),
                                 ("plain", f_loss_p, f_grads_p))}
        del f_grads_k, f_grads_p, f_grads_64, p64, copies
        torch.cuda.reset_peak_memory_stats()
        for counts in all_counts:
            for k in counts:
                counts[k] = 0
        f_warm = ftr.run_epoch(take(fam_corpus, 0, 2 * TB), batch_size=TB,
                               seed=1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        f_timed = ftr.run_epoch(take(fam_corpus, 2 * TB, 5 * TB),
                                batch_size=TB, seed=2)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        f_launches = {k: v for counts in all_counts for k, v in
                      counts.items() if v}
        family_launches[fam] = f_launches
        f_finite = all(np.isfinite(v) for m in (f_warm, f_timed)
                       for v in m.values())
        emit({"phase": "train_family", "family": fam, "B": TB,
              "first_step": {
                  "step": first_step, "loss_kernel": float(f_loss_k),
                  "loss_plain": float(f_loss_p), "loss_abs_err": f_loss_err,
                  "grad_max_abs_err": f_abs, "grad_max_rel_err": f_rel,
                  "grad_worst_leaf": f_worst["worst_leaf"],
                  "tol_grad_rel": TOL_TRAIN_GRAD_REL,
                  "kernel_paths": f_paths, "float64_witness": f_witness},
              "steps": 5, "timed_steps": 3, "warm": f_warm,
              "timed": f_timed, "ms_per_step": wall * 1e3 / 3,
              "seq_per_s": 3 * TB / wall, "finite": f_finite,
              "train_path": ftr.train_path, "launches": f_launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if f_paths != ["kernel"]:
            return fail(f"{fam}: first step ran {f_paths}, not the kernels")
        if not (f_loss_err <= TOL_TRAIN_OUT * max(1.0, abs(float(f_loss_p)))
                and f_rel <= TOL_TRAIN_GRAD_REL):
            return fail(f"{fam}: first step kernel vs plain: loss "
                        f"{f_loss_err}, gradients {f_rel} (relative)")
        if not f_finite:
            return fail(f"{fam}: a training loss is not finite")
        if ftr.train_path != "kernel":
            return fail(f"{fam}: train_path is {ftr.train_path!r}")
        if not all(f_launches.get(k, 0) > 0 for k in family_kernels[fam]):
            return fail(f"{fam}: a kernel of its path never launched: "
                        f"{f_launches}")
        del ftr, f_leaves

    launches = {**serving_launches,
                **{k: train_launches[k] for k in train_kernels},
                **{k: family_launches[fam][k]
                   for fam, ks in family_kernels.items() for k in ks}}
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
