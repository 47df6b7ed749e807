#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`music_fader_nets_tpu_torch`)
on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from `music_fader_nets_tpu_torch/csrc/`, holds each one
against its plain PyTorch version at the serving path's full-width shapes
(H=512, z=128, V=342 -> Vp=384, seq_len=100, 300 decode steps, B=64 and
B=1, float32), times kernel, plain version and, where one PyTorch call
computes the same function, that call (first the float32 dW GEMM at every
shape the training cells pass it, `dw_gemm`: the tensor-core kernel
against the CUDA-core one in turns, both against a float64 product, plain
TF32 failing the same check, repeats bit-equal; `train/dw_gemm.py`),
then drives the GM-VAE serving path
(`TransferServer`, random weights from a seed) with 130 mixed requests and
checks the responses against the plain path. Then the training kernels
(encoder, sub-decoders, decoder + cross-entropy; forward and backward) are
held, values and every gradient, against autograd of their plain versions
at the training shapes (B=128), and the GM-VAE `Trainer` takes supervised
B=32 and unsupervised B=128 steps and an evaluation pass at full width on
random in-schema batches, its first step's loss and gradients held against
the plain path on the card. The generic stacked-GRU kernels (the CVAE
encoder's shape, L=2, I=344) and the decoder with the masses head (GLSR's
perturbation decode, 4 x 128 rows) are held the same way, as is the decoder
without a head (the fused teacher decoder), and the other five families
(vanilla RegVAE, GLSR, CVAE, FaderNets, SingleVAE) each train 5 steps at
B=128 through their `Trainer`, first step against the plain path, timed
over the last 3. The single GM-VAE's forward and backward (encoder kernels
and the fused teacher decoder) are held against the plain path and a
float64 witness, and the evaluation path runs at full width on the
synthetic corpus: the eval CLI, a reconstruction report (kernel path
against plain path), the rhythm and note controllability evaluators (every
decoded row against the plain decode) and one epoch of the CVAE's
condition sweep. Each training-kernel phase also runs its forward and its
backward twice and fails unless every output and gradient has the same
bits; the encoder's, the sub-decoders', the generic stacked GRU's and the
three decoder phases print their backward's device ms by part (chain,
head, NN GEMM, dW GEMM, scatter, sums; CUPTI) and its device launches (the
sub-decoders' also at T/2: equal, and at most 3 kernels and a memset, or
the phase fails; the rhythm direction's unused class rows must get an
exact 0), the generic stacked
GRU's and the three decoder phases also their forward's (step, chain,
GEMM, head) with its kernel launches at T and at T/2 (equal, or the phase
fails), and the stacked GRU's phase times kernel + einsum and cuDNN's
bidirectional GRU in turns. A `ragged_backward` phase holds the six
backward entries against their plain versions at a shape that crosses
the tiles of the persistent chains, the split-K seam and the NN GEMM's
tiles, a `ragged_forward` phase the four forward entries of the
persistent forward chain at partial row tiles, one step and ragged
widths (and the encoder's two entries, and the decode at B = 1, 37, 64,
1-17 steps, H = 136 and 512, greedy and sampling, under the near-tie
rule), and a `long_geometry` phase the decoder CE and the encoder forward
+ backward at T=250, B=128. No kernel may launch a step at a time: the
encoder, greedy_decode and sample_decode phases print their device
launches at T (steps) and T/2 (must be one kernel each, memsets apart;
a call is counted between two launches of the library's empty
`launch_probe` kernel in one profile, and a profile that lost a probe is
taken again, since the profiler now and then loses a profile's first
events), train_step, train_family, single_gmvae and long_geometry replay every
encoder and sub-decoder forward their steps called at T and T/2, the
profiled warm-up steps and a profiled serving burst list any per-step
kernel of the earlier port (`PER_STEP_KERNELS`, must be none), serving
prints its launches per 64-row batch, and a `determinism` phase holds two
calls of each persistent kernel (decode greedy and sampling, encoder
finals and training forward) bit-equal. Every token tensor a decode
kernel returns (greedy_decode, sample_decode, ragged_forward, serving,
evaluation, train_cli) is range-checked right after its launch. A
`train_cli` phase then drives the user's path from training to use at full
width in a temporary directory: the training CLI's `run_training("gmm")`
on the dual corpus for 2 epochs (rows 3t, 4, 5, 6, 9 and 10 of the CE head
must launch, and row 1 in its reconstruction report), the same command
with --epochs 3 (must resume at the saved step and take one epoch's
steps), 3 steps + save + restore + 3 steps bit-equal to 6 straight steps,
then the server, the eval CLI and the transfer CLI (greedy and sampled,
MIDI and WAV out) loading the saved checkpoint, their decoded rows held
against the plain decode of the restored params. Then the reference-
facing surface: the public GRU primitives (`ops.gru_scan` both ways,
`ops.bigru_final_state`, an encoder stream, both sub-decoders) at full
width, B=128, forward and gradients against the plain path, kernels 1/2
counted and the bi-GRU timed against cuDNN in turns (`primitives`); the
port's parity harness on full-width stand-ins of the six released
checkpoints, section 2 on this card against the CPU replica with the
token-id forms that run kernels 3 and 7 (`parity`); the native tokenizer
against its pure-Python path (`native`); and `entry()` against the plain
path (`entry`). Last, data parallelism: the GM-VAE `Trainer` on a mesh of
one NCCL rank, bit-equal to the Trainer without one, and on two ranks
sharing the card over gloo, 64 + 64 rows against one process at 128
(`data_parallel`), then `entry.dryrun_multichip(2)` on the card
(`dryrun_multichip`, its 1 x 2 and 2 x 1 meshes). Tensor parallelism sits
between the two: two ranks sharing the card over gloo on a 1 x 2 mesh,
each holding half of the GRU leaves' Adam state, against one process
(`tensor_parallel`). Then bf16 mixed precision (`mixed_precision`): each
bf16 kernel pair against its bf16 plain version, timed in turns with its
float32 kernels; the float32 forward entries' outputs hashed and held
to the bits of the build before the bf16 forward chain's redesign; rows
2, 4, 6 and 10 bf16 (their backward products on the tensor cores) and
the forwards of rows 1, 3, 3t, 5 and 9 bf16 (the forward chain's product
on the tensor cores) at ragged shapes, each forward called twice,
bit-equal; the GM-VAE's bf16 steps, timed in turns with
float32; the other casting families; GLSR; the training CLI in bf16.
Every phase prints one JSON line; the kernels line
follows, then the card's name and power limit as nvidia-smi reports
them, then the final status line. Any failed
check exits non-zero without the status line. Needs one CUDA device;
imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
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
# bf16 mixed precision (the `mixed_precision` phase): a bf16 kernel against
# its bf16 plain version rounds the same values at the same points (its
# tensor-core products split a float32 operand into three bf16 pieces, so
# they keep float32 products), but a float32 sum in another order can land
# a value on the other side of a bf16 rounding (one ulp, 2^-8 relative)
# and the flip propagates: outputs
# to 1e-2 (the CPU tests' bound against the Pallas kernels), each kernel
# gradient to 2e-2 of its tensor's largest entry; an objective's first
# step, through the bf16 torch ops around the kernels, its loss to 1e-3
# relative and each gradient tensor to 4e-2 (the CPU tests' bound against
# the JAX package, below its own scan-vs-Pallas bf16 disagreement)
PEAK_BF16_FLOPS = 989e12
MP_TOL_OUT = 1e-2
MP_TOL_GRAD_REL = 2e-2
MP_TOL_LOSS_REL = 1e-3
MP_TOL_STEP_GRAD_REL = 4e-2
# SHA-1 of what each float32 forward entry writes on fixed inputs
# (`train/bf16_turns.py::f32_forward_sha1`), taken on an H100 from the
# build before the bf16 forward chain moved onto the tensor cores (commit
# f1eaded): the float32 instance of the chain must keep its bits
F32_FWD_SHA1 = {
    "3": "44c6e56e146b70ade722125ef896178ce4993750",
    "3t": "870c3cf9af289437fd7b3edb30acbee58754f4e3",
    "5": "52378f89957ef070bfb06daca1e5c146601f3eab",
    "1": "872fb2d5d8fecf5b455aa441d9d379d78b202476",
    "decoder_ce": "2cefd4eed2f0e2e3fd03b62e054aa47b6c2f455d",
    "decoder_masses": "8ca8e737aaeb2c03a20d36fc71b4092fb9ddbbce",
    "decoder_teacher": "3bddb40e37def9b8e17e7e2566ea400edc827d3b",
}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


@contextlib.contextmanager
def plain_path(cuda_gru, cuda_decoder, cuda_stacked):
    """Route the training path's six kernel wrappers to their plain
    versions while the block runs, on CUDA tensors as well: the reference
    the kernel path is held to on the same card."""
    swaps = [(cuda_gru, "stacked_gru_embed_finals"),
             (cuda_gru, "stacked_gru_embed_seq"),
             (cuda_decoder, "decoder_teacher"),
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


SCORE_FIELDS = ("consistency", "restrictiveness", "monotonicity")


def dataclass_values(scores):
    """EvalScores -> {field: [mean, std]}, a nan (every sample of an epoch
    discarded) written as the string "nan"."""
    return {f: [v if np.isfinite(v) else "nan" for v in getattr(scores, f)]
            for f in SCORE_FIELDS}


class TokenGuard:
    """Stands in for `cuda_decode._launch` while the script runs: every
    token tensor a decode kernel returns is range-checked (0 <= token < V,
    after a synchronise) right after its launch, before any plain code
    indexes with it. A tensor out of range raises and is recorded with the
    phase and the tensor's name; `paused` skips the check inside timing
    loops."""

    def __init__(self, cuda_decode):
        self.launch = cuda_decode._launch
        self.phase = None
        self.paused = False
        self.checked = 0
        self.bad = []
        cuda_decode._launch = self

    def __call__(self, args, V, Vp, steps, noise=None, inv_t=None):
        toks = self.launch(args, V, Vp, steps, noise, inv_t)
        if self.paused or toks.numel() == 0:
            return toks
        lo, hi = (int(v) for v in toks.aminmax())
        self.checked += 1
        if not (0 <= lo and hi < V):
            name = "sample_decode" if noise is not None else "greedy_decode"
            msg = (f"phase {self.phase}: {name} tokens {tuple(toks.shape)} "
                   f"span [{lo}, {hi}], outside [0, {V})")
            self.bad.append(msg)
            raise AssertionError(msg)
        return toks

    def start(self, phase):
        self.phase, self.checked = phase, 0

    @contextlib.contextmanager
    def pause(self):
        self.paused = True
        try:
            yield
        finally:
            self.paused = False


# the per-step kernels the port launched before its persistent kernels
# (one launch a step from a host loop): none of them may run on any phase
PER_STEP_KERNELS = ("embed_gru_step", "embed_gru_train_step", "dec_layer1",
                    "dec_layer2", "dec_logits", "dec_finish",
                    "stacked_gru_step", "dec_ce_layer2")


class DeviceWatch:
    """Profiles the device work of the block it wraps (torch.profiler,
    CUPTI): `kernels` and `memsets` launched, and the names among
    PER_STEP_KERNELS seen (`per_step_kernels`, must stay empty). Launches
    of the library's empty `launch_probe` kernel are marks, not work:
    `between_probes` counts the events between each two of them."""

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.events = sorted(
            (e.time_range.start, e.name) for e in self.prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        counts = self._count(n for _, n in self.events)
        self.kernels, self.memsets, self.per_step_kernels = counts
        return False

    @staticmethod
    def _count(names):
        from music_fader_nets_tpu_torch.train.bwd_split import PROBE
        kernels = memsets = 0
        seen = set()
        for name in names:
            if PROBE in name:
                continue
            if name.startswith("Memset"):
                memsets += 1
            else:
                kernels += 1
            seen.update(k for k in PER_STEP_KERNELS if k in name)
        return kernels, memsets, sorted(seen)

    def between_probes(self):
        """(kernels, memsets, per-step kernels) of the device events
        between each two consecutive probes, in device time order."""
        from music_fader_nets_tpu_torch.train.bwd_split import PROBE
        marks = [i for i, (_, n) in enumerate(self.events) if PROBE in n]
        return [self._count(n for _, n in self.events[a + 1:b])
                for a, b in zip(marks, marks[1:])]


def device_launches(fn, calls=3, profiles=5):
    """(kernel launches, memsets, per-step kernels seen) of one call of
    `fn` after a warm-up call. One profile brackets each of `calls` calls
    between two launches of the library's empty kernel (`train/bwd_split.
    py::launch_probe`): probe, call, probe, call, ..., probe. A call
    counts the device events between its two probes, and the count is the
    most over the calls of a profile that recorded every probe. The profiler has been seen to
    drop a call's events (a count of 0, or 0.5 over two calls), and every
    event of a profile taken right after another, never to add any (once,
    every profile of a replay in the 3 s after GLSR's profiled steps,
    thousands of launches a step, lost a probe): a profile that lost a
    probe is taken again after a pause of a second, then two, ..., up to
    `profiles` profiles. A profile's first events are the ones it has
    been seen to lose, so it opens with a lead probe pair that brackets
    nothing: with every probe seen, that empty interval is dropped; with
    only the lead probe lost, the first interval holds the first call
    (not empty) and the profile counts; an empty first interval and one
    interval short means a later probe was lost, and the profile is taken
    again."""
    import torch
    from music_fader_nets_tpu_torch.train.bwd_split import (
        PROBE, launch_probe,
    )
    fn()
    torch.cuda.synchronize()
    probes = []
    for attempt in range(profiles):
        with DeviceWatch() as w:
            launch_probe()
            launch_probe()
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
                launch_probe()
        counts = w.between_probes()
        if counts and counts[0][:2] == (0, 0):
            counts = counts[1:] if len(counts) == calls + 1 else []
        if len(counts) == calls:
            best = max((k, m) for k, m, _ in counts)
            seen = sorted(set().union(*(set(s) for *_, s in counts)))
            return best[0], best[1], seen
        probes.append(sum(PROBE in n for _, n in w.events))
        time.sleep(1.0 * (attempt + 1))
    raise RuntimeError(f"the profiler lost a probe in each of {profiles} "
                       f"profiles (probes seen of {calls + 2}: {probes})")


class EmbedCalls:
    """While the block runs, records the shape of every call of the
    encoder's and the sub-decoders' forward launchers (`cuda_gru.
    _launch_finals`, `_launch_train_fwd`); `replay` then launches each
    recorded entry on random inputs of its shape at T and at T // 2 and
    returns their device launches, which must be one kernel each (plus the
    memset of the chain's counters) at both lengths."""

    def __init__(self, cuda_gru):
        self.m, self.shapes = cuda_gru, {}

    def __enter__(self):
        self.saved = (self.m._launch_finals, self.m._launch_train_fwd)
        fin, train = self.saved

        def finals(tok_lt, w_ih, *rest):
            self._note("embed_gru", tok_lt, w_ih, rest[0], None)
            return fin(tok_lt, w_ih, *rest)

        def train_fwd(ids, w_in, add, w_hh, b_hh, h0, stash):
            name = "embed_seq" if add.dim() == 3 else "embed_gru_train"
            self._note(name, ids, w_in, add, stash)
            return train(ids, w_in, add, w_hh, b_hh, h0, stash)

        self.m._launch_finals, self.m._launch_train_fwd = finals, train_fwd
        return self

    def __exit__(self, *exc):
        self.m._launch_finals, self.m._launch_train_fwd = self.saved
        return False

    def _note(self, name, ids, w_in, add, stash):
        L, T, B = ids.shape
        key = f"{name} L={L} T={T} B={B}"
        self.shapes[key] = (name, L, T, B, w_in.shape[1],
                            add.shape[-1] // 3, add.dim() == 3, stash)

    def replay(self, dev):
        import torch
        gen = torch.Generator().manual_seed(SEED + 11)
        out = {}
        for key, (name, L, T, B, V, H, per_row, stash) in sorted(
                self.shapes.items()):
            def inputs(t):
                def r(*shape):
                    return (torch.randn(shape, generator=gen) * 0.05).to(dev)
                ids = torch.randint(0, V, (L, t, B), generator=gen,
                                    dtype=torch.int32).to(dev)
                add = r(L, B, 3 * H) if per_row else r(L, 3 * H)
                return (ids, r(L, V, 3 * H), add, r(L, H, 3 * H),
                        r(L, 3 * H), r(L, B, H))

            full, half = inputs(T), inputs(max(T // 2, 1))
            if name == "embed_gru":
                fn = self.m._launch_finals
            else:
                fn = functools.partial(self.m._launch_train_fwd,
                                       stash=stash)
            with torch.no_grad():
                k_t, m_t, old_t = device_launches(lambda: fn(*full))
                k_h, _, old_h = device_launches(lambda: fn(*half))
            out[key] = {"launches": k_t, "launches_half_T": k_h,
                        "memsets": m_t,
                        "per_step_kernels": sorted(set(old_t + old_h))}
        return out


def embed_launch_faults(launches):
    """The recorded entries that launched other than one kernel at T and
    at T // 2, or a per-step kernel."""
    return {k: v for k, v in launches.items()
            if v["launches"] != 1 or v["launches_half_T"] != 1
            or v["per_step_kernels"]}


def zero_counts(*counts) -> None:
    """Set every launch count of the given LAUNCHES dicts to 0."""
    for c in counts:
        for k in c:
            c[k] = 0


def read_counts(*counts) -> dict:
    """The non-zero launch counts of the given LAUNCHES dicts."""
    return {k: v for c in counts for k, v in c.items() if v}


DP_STEPS = 3            # steps of each GM-VAE branch in data_parallel
# the sub-decoders' output biases: a true gradient of exactly 0 (their
# log-softmax runs over the time axis), so Adam moves them by up to lr a
# step in a direction float32 rounding picks (tests/test_torch_train_
# trainer.py); held to 2 * lr a step where params are compared by value
NOISE_ONLY_PARAMS = ("linear_out_r/b", "linear_out_n/b")


def dp_drive(mesh) -> dict:
    """The data_parallel and tensor_parallel phases' run of the GM-VAE
    `Trainer` at ModelConfig() widths from seed SEED, on `mesh` (None: one
    process, the reference): each branch's first-step loss, metrics and
    all-reduced gradients (global B=128 unsupervised, B=32 supervised; the
    rank feeds the rows of its data index), then DP_STEPS steps of each
    branch with the training kernels' launch counts set to 0 just before
    and read just after, the canonical params after them, Adam's bytes on
    this rank, the step time (`steady_state_step_time`, global B=128) and,
    on a mesh, the one all-reduce's time and bytes, and under a model axis
    the gather's time and bytes. Tensors come back on the CPU."""
    import torch
    import torch.distributed as dist
    from music_fader_nets_tpu_torch.config import ModelConfig
    from music_fader_nets_tpu_torch.data.datasets import (
        VGMIDIDataset, YamahaDataset,
    )
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
    from music_fader_nets_tpu_torch.parallel.collectives import (
        all_reduce_mean_,
    )
    from music_fader_nets_tpu_torch.parallel.mesh import shard_batch
    from music_fader_nets_tpu_torch.train.objectives import gmm_loss
    from music_fader_nets_tpu_torch.train.profile import random_corpus
    from music_fader_nets_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig()
    losses = {"default": gmm_loss,
              "supervised": functools.partial(gmm_loss, is_supervised=True)}
    tr = Trainer(cfg, init_reg_gmvae, losses, seed=SEED,
                 device=None if mesh else "cuda", mesh=mesh)
    TB, SB = cfg.batch_size, 32
    yam = YamahaDataset(*random_corpus(cfg, 10 * TB, SEED),
                        mode="train").arrays()            # 8 batches
    vg = VGMIDIDataset(*random_corpus(cfg, 7 * SB, SEED + 1,
                                      supervised=True),
                       mode="train").arrays()             # 5 batches

    def local(arrays, bs, lo, n):
        """The rank's rows of global batches lo .. lo + n - 1."""
        parts = [{k: v[i * bs: (i + 1) * bs] for k, v in arrays.items()}
                 for i in range(lo, lo + n)]
        if mesh is not None:
            parts = [shard_batch(p, mesh) for p in parts]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    leaves = tr._trainable          # the whole leaves the forward reads
    branches = (("unsupervised", yam, TB, "default"),
                ("supervised", vg, SB, "supervised"))
    first = {}
    for host_step, (name, arrays, bs, variant) in enumerate(branches):
        loss_fn = losses[variant]
        rows = local(arrays, bs, 0, 1)
        m = tr.compute_gradients(
            loss_fn, tr._batch(rows),
            tr._rank_noise(tr.noise_fn(host_step, bs, loss_fn),
                           len(rows["x"])))
        first[name] = {"metrics": {k: float(v.detach())
                                   for k, v in m.items()},
                       "grads": [t.grad.detach().cpu() for t in leaves]}
    counts = (cuda_gru.LAUNCHES, cuda_decoder.LAUNCHES)
    zero_counts(*counts)
    epochs = {name: tr.run_epoch(local(arrays, bs, 1, DP_STEPS), variant,
                                 batch_size=bs, shuffle=False)
              for name, arrays, bs, variant in branches}
    torch.cuda.synchronize()
    launches = read_counts(*counts)
    params = list(named_leaves(tr.params))
    out = {"first": first, "epochs": epochs, "launches": launches,
           "train_path": tr.train_path, "step": tr.step,
           "device": str(tr.device),
           "backend": dist.get_backend() if mesh else None,
           "param_names": [name for name, _ in params],
           "params": [t.cpu() for _, t in params],
           "adam_bytes": sum(v.numel() * v.element_size()
                             for st in tr.optimizer.state.values()
                             for k, v in st.items() if k != "step"),
           "ms_per_step": 1e3 * tr.steady_state_step_time(
               yam, warmup=1, iters=5, batch_size=TB)}
    if mesh is not None and mesh.n_model > 1:
        ts = []
        for _ in range(6):
            tr._stale = True        # the weights are current: re-gathered
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._gather()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["gather_ms"] = statistics.median(ts[1:])
        out["gather_bytes"] = sum(t.numel() * t.element_size()
                                  for t in leaves)
        out["sharded_bytes"] = sum(t.numel() * t.element_size()
                                   for t, spec in zip(leaves, tr._specs)
                                   if spec)
    if mesh is not None:
        grads = [t.grad for t in leaves]
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean_(grads, mesh)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"] = statistics.median(ts[1:])
        out["allreduce_bytes"] = sum(g.numel() * g.element_size()
                                     for g in grads)
    return out


def dp_rank(device: str, n_model: int = 1) -> dict:
    """One rank of data_parallel (b) / (c) (n_model 1) or tensor_parallel
    (a) / (c) (n_model 2): `dp_drive` on this rank's mesh of
    world / n_model x n_model, placed as `run_ranks` placed its process
    group ("cuda:0": the ranks share card 0 over gloo; "cuda": a card each
    over NCCL)."""
    from music_fader_nets_tpu_torch.parallel.mesh import make_mesh
    return dp_drive(make_mesh(n_model=n_model, devices=device))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import music_fader_nets_tpu_torch  # noqa: F401  (sets TF32 off)
    from music_fader_nets_tpu_torch.config import ModelConfig
    from music_fader_nets_tpu_torch import models
    from music_fader_nets_tpu_torch.data.synthetic import synth_corpus
    from music_fader_nets_tpu_torch.eval import cli as eval_cli
    from music_fader_nets_tpu_torch.eval.controllability import (
        ConditionControllabilityEvaluator, ControllabilityEvaluator,
        latent_stats,
    )
    from music_fader_nets_tpu_torch.eval.reconstruction import (
        reconstruction_report,
    )
    from music_fader_nets_tpu_torch.models.fast import split_fast
    from music_fader_nets_tpu_torch.models.gmvae import (
        init_reg_gmvae, init_single_gmvae, reg_gmvae_forward,
        single_gmvae_forward,
    )
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
    from music_fader_nets_tpu_torch.train.bf16_turns import f32_forward_sha1
    from music_fader_nets_tpu_torch.train import dw_gemm
    from music_fader_nets_tpu_torch.train.bwd_split import kernel_split
    from music_fader_nets_tpu_torch.train.fwd_split import (
        PARTS as FWD_PARTS, SKIP as FWD_SKIP,
    )
    from music_fader_nets_tpu_torch.serve import cli as serve_cli
    from music_fader_nets_tpu_torch.train import cli as train_cli
    from music_fader_nets_tpu_torch.train.cli import _forward_for
    from music_fader_nets_tpu_torch.train.objectives import gmm_loss
    from music_fader_nets_tpu_torch.train.profile import (
        FAMILIES, random_corpus,
    )
    from music_fader_nets_tpu_torch.train.trainer import Trainer, TrainState
    from music_fader_nets_tpu_torch.transfer import cli as transfer_cli
    from music_fader_nets_tpu_torch.transfer.arousal import (
        arousal_transfer, compute_shift_vectors, transfer_latent,
    )
    from music_fader_nets_tpu_torch.utils import checkpoint as ckpt
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

    # ------------------------------------------------- float32 dW GEMM
    # every (L, M, N, K) the training cells pass gemm_tn<float>: the
    # tensor-core kernel and the CUDA-core one in turns, each against a
    # float64 product, plain TF32 beside them, repeats bit-equal
    for line in dw_gemm.report(ModelConfig(), reps=20, seed=SEED, dev=dev):
        emit({"phase": "dw_gemm", **line})
        if not line["ok"]:
            return fail(f"dw_gemm {line['shape']}: {line['failed']}")

    guard = TokenGuard(cuda_decode)
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
        # device launches of one call at T and at T/2: one cooperative
        # kernel (and the memset of its counters) whatever T is
        half_args = (tok_lt[:, :T // 2].contiguous(),) + enc_args[1:]
        enc_l = device_launches(
            lambda: cuda_gru.stacked_gru_embed_finals(*enc_args))
        enc_lh = device_launches(
            lambda: cuda_gru.stacked_gru_embed_finals(*half_args))
    G = 3 * H
    b_ms, b_by = bound(2.0 * L * T * B * H * G, nbytes(*enc_args) + nbytes(got))
    emit({"phase": "encoder", "shape": {"L": L, "T": T, "B": B, "H": H,
                                        "Vp": Vp},
          "max_abs_err": enc_err, "tol": TOL_ENCODER, "ms": ms,
          "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_max_abs_err": lib_err, "bound_ms": b_ms,
          "launches": enc_l[0], "launches_half_T": enc_lh[0],
          "memsets": enc_l[1], "per_step_kernels": enc_l[2] + enc_lh[2]})
    if not enc_err <= TOL_ENCODER:
        return fail(f"encoder kernel vs plain: {enc_err} > {TOL_ENCODER}")
    if enc_l[0] != 1 or enc_lh[0] != 1 or enc_l[2] or enc_lh[2]:
        return fail(f"encoder launches at T, T/2: {enc_l}, {enc_lh}")
    kernels["embed_gru"] = {
        "name": "embed_gru", "route": "cuda",
        "source": "music_fader_nets_tpu_torch/csrc/gru_fwd_chain.cu",
        "replaces": "music_fader_nets_tpu/ops/pallas_gru.py:428",
        "max_abs_err": enc_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    # ----------------------------------------------------- decode kernels
    Zt = 2 * Z + cfg.chroma_dims
    with torch.inference_mode():
        gview = tree_to(global_decoder_init(gen, Zt, V, H), dev)
        res = {}
        for nb in (64, 1):
            guard.start("greedy_decode")
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
            with guard.pause():
                kms = time_ms(lambda: cuda_decode.cuda_greedy_decode(
                    gview, z, steps), 10)
                # the decode entry's device launches at steps and steps/2
                d_l = device_launches(lambda: cuda_decode._launch(
                    args, V, Vp, steps))
                d_lh = device_launches(lambda: cuda_decode._launch(
                    args, V, Vp, steps // 2))
            pms = (time_ms(lambda: cuda_decode.plain_decode_tokens(
                gview, z, steps), 3, warm=1) if nb == 64 else None)
            res[nb] = (z, got, kms, pms, args, gap)
            emit({"phase": "greedy_decode", "B": nb, "steps": steps,
                  "identical": bool(parted == 0), "near_tie_rows": parted,
                  "largest_gap": gap, "tol": TOL_NEAR_TIE, "ms": kms,
                  "plain_ms": pms, "launches": d_l[0],
                  "launches_half_steps": d_lh[0], "memsets": d_l[1],
                  "per_step_kernels": d_l[2] + d_lh[2],
                  "token_checks": guard.checked})
            if d_l[0] != 1 or d_lh[0] != 1 or d_l[2] or d_lh[2]:
                return fail(f"greedy decode B={nb} launches at steps, "
                            f"steps/2: {d_l}, {d_lh}")
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
              "bound_ms_b1": b1_bound, "ms_b64": g_ms, "ms_b1": res[1][2],
              "note": "B=1 is bound by step latency (three grid barriers "
                      "and three dependent phases a step), not by FLOPs"})
        kernels["greedy_decode"] = {
            "name": "greedy_decode", "route": "cuda",
            "source": "music_fader_nets_tpu_torch/csrc/decode.cu",
            "replaces": "music_fader_nets_tpu/ops/pallas_decode.py:83",
            "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain_ms,
            "bound_ms": g_bound, "bound_by": g_by, "library_ms": None}

        # sampling: rows alternate sampled (T = 0.9, noise) and greedy
        # (inv_t = 1, zero noise)
        guard.start("sample_decode")
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
        with guard.pause():
            s_ms = time_ms(lambda: cuda_decode.cuda_sample_decode(
                gview, z64, noise, inv_t, steps), 10)
            s_l = device_launches(lambda: cuda_decode._launch(
                args64, V, Vp, steps, noise, inv_t))
            s_lh = device_launches(lambda: cuda_decode._launch(
                args64, V, Vp, steps // 2, noise[:steps // 2], inv_t))
            s_ms_b1 = time_ms(lambda: cuda_decode.cuda_sample_decode(
                gview, z64[:1], noise[:, :1], inv_t[:1], steps), 10)
        s_plain_ms = time_ms(lambda: cuda_decode.plain_sample_tokens(
            gview, z64, noise, inv_t, steps), 3, warm=1)
    emit({"phase": "sample_decode", "B": 64, "steps": steps,
          "identical": bool(parted == 0), "near_tie_rows": parted,
          "largest_gap": gap, "inv_t1_zero_noise_equals_greedy": bit_exact,
          "greedy_rows_in_mixed_batch_equal_greedy": greedy_rows_same,
          "ms": s_ms, "ms_b1": s_ms_b1, "plain_ms": s_plain_ms,
          "launches": s_l[0], "launches_half_steps": s_lh[0],
          "memsets": s_l[1], "per_step_kernels": s_l[2] + s_lh[2],
          "token_checks": guard.checked})
    if not (bit_exact and greedy_rows_same):
        return fail("sampling kernel with inv_t=1 and zero noise differs "
                    "from the greedy kernel")
    if s_l[0] != 1 or s_lh[0] != 1 or s_l[2] or s_lh[2]:
        return fail(f"sample decode launches at steps, steps/2: {s_l}, "
                    f"{s_lh}")
    s_bound, s_by = bound(dec_flops, w_bytes + nbytes(*args64[9:])
                          + nbytes(noise, inv_t) + steps * 64 * 4)
    s_b1_bound, _ = bound(dec_flops / 64, w_bytes + nbytes(*res[1][4][9:])
                          + nbytes(noise[:, :1], inv_t[:1]) + steps * 4)
    emit({"phase": "sample_decode_bounds", "bound_ms_b64": s_bound,
          "bound_ms_b1": s_b1_bound, "ms_b64": s_ms, "ms_b1": s_ms_b1})
    kernels["sample_decode"] = {
        "name": "sample_decode", "route": "cuda",
        "source": "music_fader_nets_tpu_torch/csrc/decode.cu",
        "replaces": "music_fader_nets_tpu/ops/pallas_decode.py:116",
        "max_abs_err": gap, "ms": s_ms, "plain_ms": s_plain_ms,
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": None}

    # ------------------------------------------------------- determinism
    # two calls of each persistent kernel on the same inputs give the same
    # bits: the decode (greedy and sampling, B=64) and the encoder (serving
    # finals, and the training forward's h_seq and gate stash)
    with torch.inference_mode(), guard.pause():
        det = {
            "greedy_decode": [cuda_decode.cuda_greedy_decode(
                gview, z64, steps) for _ in range(2)],
            "sample_decode": [cuda_decode.cuda_sample_decode(
                gview, z64, noise, inv_t, steps) for _ in range(2)],
            "embed_gru": [cuda_gru.stacked_gru_embed_finals(*enc_args)
                          for _ in range(2)],
            "embed_gru_train": [cuda_gru._launch_train_fwd(*enc_args, True)
                                for _ in range(2)]}
        torch.cuda.synchronize()
        det = {k: all(torch.equal(a, b) for a, b in zip(*(
                   x if isinstance(x, tuple) else (x,) for x in v)))
               for k, v in det.items()}
    emit({"phase": "determinism", "bit_equal": det})
    if not all(det.values()):
        return fail(f"a persistent kernel's repeat differs in a bit: {det}")

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
    guard.start("serving")
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
        # device launches per batch: a burst of 64 greedy requests,
        # profiled
        b0 = stats["batches"]
        with DeviceWatch() as burst:
            done = [f.result(timeout=600) for f in [srv.submit(
                {"id": 1000 + i, "direction": "low_to_high",
                 "tokens": rng.integers(2, V, size=cfg.seq_len).tolist()})
                for i in range(64)]]
        burst_batches = srv.stats()["batches"] - b0
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
          "launches_per_batch": {
              "kernels": burst.kernels / max(burst_batches, 1),
              "memsets": burst.memsets / max(burst_batches, 1),
              "batches": burst_batches},
          "per_step_kernels": burst.per_step_kernels,
          "plain_checked_rows": checked, "plain_near_tie_rows": ref_parted,
          "z_max_abs_err": z_err, "token_checks": guard.checked})
    if burst.per_step_kernels or any("error" in r for r in done):
        return fail(f"serving burst: per-step kernels "
                    f"{burst.per_step_kernels}")
    if guard.bad:
        return fail(f"decode kernel tokens out of range: {guard.bad}")
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
                           floats, cot, shape, flops, lib=None, extra=None,
                           split=False, pad_rows=None, raw_fwd=None,
                           half=None, bwd_half=None, max_bwd_launches=None):
        """names/srcs/replaces: (forward, backward). flops: (forward,
        backward). lib: (forward callable, its leaves, its cotangent) or
        None. extra: more keys for the phase's line. split: also the
        backward's device ms by part (chain, dW GEMM, scatter, sums).
        pad_rows: (index of a float input, first pad row[, direction])
        whose gradient rows from there on (of that direction only, when
        given) must be exactly 0. raw_fwd: a call of the
        forward entry that returns every tensor it writes (outputs and
        gate stashes), held bit-equal over two calls. half: (fn, ids,
        floats) of the forward at T/2; with it the forward's device ms by
        part (step, chain, GEMM, head) and its kernel launches at T and
        T/2 (memsets timed, not counted) join the line. bwd_half: (ids,
        floats, cot) at T/2; with it and `split`, the backward's device
        launches at T/2 join the line and must equal those at T, and be
        at most `max_bwd_launches` (kernels and memsets) when given."""
        ts, out, grads = fwd_bwd(fn, ids, floats, cot)
        _, out_p, grads_p = fwd_bwd(plain, ids, floats, cot)
        # the chains and reductions use no atomics: a second forward and a
        # second backward call give the same bits
        grads_2 = torch.autograd.grad(out, ts, cot, retain_graph=True)
        fwd_again = [(out, fn(ids, *ts))]
        if raw_fwd is not None:
            fwd_again += list(zip(raw_fwd(), raw_fwd()))
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, grads_2))
        fwd_same_bits = all(a is None and b is None or torch.equal(a, b)
                            for a, b in fwd_again)
        if pad_rows is not None:
            pad_grad = grads[pad_rows[0]]
            if len(pad_rows) > 2:
                pad_grad = pad_grad[pad_rows[2]:pad_rows[2] + 1]
        pads_zero = (pad_rows is None or float(
            pad_grad[:, pad_rows[1]:].abs().max()) == 0.0)
        del grads_2, fwd_again
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
        bwd_split = None
        if split:
            bwd_split = kernel_split(lambda: torch.autograd.grad(
                out, ts, cot, retain_graph=True))
            bwd_split = {"bwd_split_ms": bwd_split[0],
                         "bwd_launches": bwd_split[1]}
            if bwd_half is not None:
                bh_ids, bh_floats, bh_cot = bwd_half
                bh_ts, bh_out, _ = fwd_bwd(fn, bh_ids, bh_floats, bh_cot)
                bwd_split["bwd_launches_half_T"] = kernel_split(
                    lambda: torch.autograd.grad(bh_out, bh_ts, bh_cot,
                                                retain_graph=True))[1]
                del bh_ts, bh_out
        fwd_split = None
        if half is not None:
            h_fn, h_ids, h_floats = half
            h_ts = [t.detach().clone().requires_grad_(True)
                    for t in h_floats]
            parts, _ = kernel_split(lambda: fn(ids, *ts), 3, FWD_PARTS,
                                    FWD_SKIP)
            fwd_split = {"fwd_split_ms": parts,
                         "fwd_launches": device_launches(
                             lambda: fn(ids, *ts))[0],
                         "fwd_launches_half_T": device_launches(
                             lambda: h_fn(h_ids, *h_ts))[0]}
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
              "bound_bwd_ms": b_bound,
              "determinism": same_bits and fwd_same_bits,
              "determinism_fwd": fwd_same_bits, "determinism_bwd": same_bits,
              **({} if pad_rows is None else {"pad_rows_zero": pads_zero}),
              **(bwd_split or {}), **(fwd_split or {}),
              **(extra or {})})
        if not (out_err <= TOL_TRAIN_OUT and g_rel <= TOL_TRAIN_GRAD_REL):
            return fail(f"{phase}: kernel vs plain output {out_err}, "
                        f"gradients {g_rel} (relative)")
        if not same_bits:
            return fail(f"{phase}: two backward calls differ in a bit")
        if not fwd_same_bits:
            return fail(f"{phase}: two forward calls differ in a bit")
        if fwd_split is not None and (
                fwd_split["fwd_launches"] != fwd_split["fwd_launches_half_T"]
                or fwd_split["fwd_launches"] < 1
                or fwd_split["fwd_split_ms"]["step"] > 0.0):
            return fail(f"{phase}: the forward launches a kernel a step: "
                        f"{fwd_split}")
        if not pads_zero:
            return fail(f"{phase}: a pad row's gradient is not exactly 0")
        if bwd_split is not None and bwd_half is not None and (
                bwd_split["bwd_launches"]
                != bwd_split["bwd_launches_half_T"]):
            return fail(f"{phase}: the backward launches a kernel a step: "
                        f"{bwd_split}")
        if max_bwd_launches is not None and not (
                0 < bwd_split["bwd_launches"] <= max_bwd_launches):
            return fail(f"{phase}: the backward made "
                        f"{bwd_split['bwd_launches']} device launches, more "
                        f"than {max_bwd_launches}")
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
        (csrc + "gru_fwd_chain.cu", csrc + "embed_gru_bwd.cu"),
        (pg + "428", pg + "536"), cuda_gru.stacked_gru_embed_finals,
        cuda_gru.stacked_gru_embed_finals_plain, tok_lt,
        [w_ih_p, b_ih, w_hh, b_hh, h0], cot,
        {"L": L, "T": T, "B": TB, "H": H, "Vp": Vp},
        (enc_f, 2 * enc_f), lib=(cudnn_enc, enc_leaves, cot), split=True,
        pad_rows=(0, V),
        raw_fwd=lambda: cuda_gru._launch_train_fwd(
            tok_lt, w_ih_p, b_ih, w_hh, b_hh, h0, True),
        half=(cuda_gru.stacked_gru_embed_finals,
              tok_lt[:, :T // 2].contiguous(), [w_ih_p, b_ih, w_hh, b_hh, h0]))
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
    # the backward: one memset, the chain (which also sums the classes,
    # dprez and db_hh), the dW_hh GEMM and its split-K sum, at T and T/2;
    # direction 0 (rhythm) has no ids past rhythm_dims: those rows of its
    # dW_emb must be exactly 0
    rc = train_kernel_phase(
        "train_subdecoder_kernels", ("embed_seq", "embed_seq_bwd"),
        (csrc + "gru_fwd_chain.cu", csrc + "embed_gru_bwd.cu"),
        (pg + "779", pg + "888"), cuda_gru.stacked_gru_embed_seq,
        cuda_gru.stacked_gru_embed_seq_plain, cls_lt,
        [w_emb, prez, s_whh, s_bhh, s_h0], s_cot,
        {"L": 2, "T": A, "B": TB, "H": H, "C": C},
        (sub_f, 2 * sub_f), lib=(cudnn_sub, sub_leaves, s_cot), split=True,
        pad_rows=(0, cfg.rhythm_dims, 0), max_bwd_launches=4,
        raw_fwd=lambda: cuda_gru._launch_train_fwd(
            cls_lt, w_emb, prez, s_whh, s_bhh, s_h0, True),
        half=(cuda_gru.stacked_gru_embed_seq, cls_lt[:, :A // 2].contiguous(),
              [w_emb, prez, s_whh, s_bhh, s_h0]),
        bwd_half=(cls_lt[:, :A // 2].contiguous(),
                  [w_emb, prez, s_whh, s_bhh, s_h0],
                  s_cot[:, :A // 2].contiguous()))
    if rc:
        return rc
    if cuda_gru.LAST_TRAIN_PATH != "kernel":
        return fail("train_subdecoder_kernels: the sub-decoders' call took "
                    f"the {cuda_gru.LAST_TRAIN_PATH} path")
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
    d_rec = [d_wtok, d_prez, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
             g2["w_hh"], g2["b_hh"], d_h10]
    d_head = [d_wout, d_bout]
    Th = T // 2
    rc = train_kernel_phase(
        "train_decoder_ce_kernels", ("decoder_ce", "decoder_ce_bwd"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1482", pg + "1627"),
        with_tgt(cuda_decoder.decoder_teacher_nll),
        with_tgt(cuda_decoder.decoder_teacher_nll_plain), d_tok,
        d_rec + d_head, d_cot,
        {"T": T, "B": TB, "H": H, "Vp": Vp},
        (dec_f, 2.0 * T * TB * (6 * H * G + 3 * H * Vp)), split=True,
        raw_fwd=lambda: cuda_decoder._launch_fwd(
            d_tok, d_tgt, *d_rec, *d_head, stash=True),
        half=(lambda ids, *fl: cuda_decoder.decoder_teacher_nll(
            ids, d_tgt[:Th].contiguous(), *fl), d_tok[:Th].contiguous(),
            d_rec + d_head))
    if rc:
        return rc

    # decoder without a head: the same recurrence, its output h2_seq and
    # the cotangent of h2_seq in place of the head's (kernels 7, 8)
    # (a generator of its own: the later phases keep their inputs)
    t_cot = (torch.randn((T, TB, H), generator=torch.Generator().manual_seed(
        SEED + 4)) * 0.01).to(dev)
    tea_f = 2.0 * T * TB * 3 * H * G
    rc = train_kernel_phase(
        "train_decoder_teacher_kernels",
        ("decoder_teacher", "decoder_teacher_bwd"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1110", pg + "1304"), cuda_decoder.decoder_teacher,
        cuda_decoder.decoder_teacher_plain, d_tok, d_rec, t_cot,
        {"T": T, "B": TB, "H": H, "Vp": Vp}, (tea_f, 2 * tea_f), split=True,
        raw_fwd=lambda: cuda_decoder._launch_teacher_fwd(d_tok, *d_rec,
                                                         stash=True),
        half=(cuda_decoder.decoder_teacher, d_tok[:Th].contiguous(), d_rec))
    if rc:
        return rc
    del t_cot

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

    # row 1 against its library call in one call, in turns: the kernel's
    # training forward over the einsum's projections, and cuDNN's
    # bidirectional nn.GRU over x_in (its own projection included)
    e_rest = [t.detach().clone().requires_grad_(True)
              for t in (e_whh, e_bhh, e_h0)]
    turns = {"kernel_plus_einsum_ms": [], "cudnn_ms": []}
    for _ in range(2):
        turns["kernel_plus_einsum_ms"].append(time_ms(
            lambda: cuda_stacked.stacked_gru(project(), *e_rest), 5))
        turns["cudnn_ms"].append(time_ms(cudnn_stacked, 5))
    del e_rest
    st_f = 2.0 * 2 * T * TB * H * G
    rc = train_kernel_phase(
        "train_stacked_gru_kernels", ("stacked_gru", "stacked_gru_bwd"),
        (csrc + "gru_fwd_chain.cu", csrc + "stacked_gru.cu"),
        (pg + "147", pg + "238"), skip_ids(cuda_stacked.stacked_gru),
        skip_ids(cuda_stacked.stacked_gru_plain), no_ids,
        [e_pre, e_whh, e_bhh, e_h0], e_cot,
        {"L": 2, "T": T, "B": TB, "H": H, "I": I},
        (st_f, 2 * st_f), lib=(cudnn_stacked, e_leaves, e_cot), split=True,
        raw_fwd=lambda: cuda_stacked._launch_fwd(e_pre, e_whh, e_bhh, e_h0,
                                                 True),
        half=(skip_ids(cuda_stacked.stacked_gru), no_ids,
              [e_pre[:, :Th].contiguous(), e_whh, e_bhh, e_h0]),
        extra={"einsum_ms": einsum_ms, "same_call_turns": turns,
               "library_note": "cuDNN bidirectional nn.GRU over x_in "
                               "includes the input projection: compare "
                               "it with einsum_ms + ms (same_call_turns: "
                               "both timed in turns, 5 calls each)"})
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

    m_floats = [d_wtok, m_prez, g1["w_hh"], g1["b_hh"], g2["w_ih"],
                g2["b_ih"], g2["w_hh"], g2["b_hh"], m_h10, d_wout, d_bout]
    rc = train_kernel_phase(
        "train_decoder_masses_kernels",
        ("decoder_masses", "decoder_masses_bwd"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1482", pg + "1627"),
        with_ranges(cuda_decoder.decoder_teacher_masses),
        with_ranges(cuda_decoder.decoder_teacher_masses_plain), d_tok,
        m_floats, m_cot,
        {"T": T, "B0": TB, "n_rep": n_rep, "rows": MB, "H": H, "Vp": Vp,
         "K": len(GLSR_MASK_RANGES)},
        (2.0 * T * MB * (3 * H * G + H * Vp),
         2.0 * T * MB * (6 * H * G + 3 * H * Vp)), split=True,
        raw_fwd=lambda: cuda_decoder._launch_masses_fwd(
            d_tok, *m_floats, GLSR_MASK_RANGES, n_rep, stash=True),
        half=(with_ranges(cuda_decoder.decoder_teacher_masses),
              d_tok[:Th].contiguous(), m_floats))
    if rc:
        return rc
    del m_prez, m_h10, m_cot, m_floats

    # the persistent backward chain, the split-K weight-gradient GEMM and
    # the decoder's NN GEMM at a ragged shape: B = 37 (a partial row tile,
    # the h0 | h_seq seam inside the GEMM's first k-slabs), T = 21 (T * B =
    # 777 rows: K splits, a partial last slab, a partial NN row tile), H =
    # 136 (an 8-unit column tile, partial GEMM tiles), the three GRU
    # backward entries (the sub-decoders' with ids outside its class table)
    # and the three decoder backward entries (the CE head and no
    # head at B = 37, the masses head at n_rep = 4 copies of 9 token rows)
    # against autograd of their plain versions
    rL, rT, rB, rH = 2, 21, 37, 136
    r_gen = torch.Generator().manual_seed(SEED + 7)
    r_wih, r_bih, r_whh, r_bhh = (t.to(dev) for t in stack_directions(
        [gru_init(r_gen, V, rH) for _ in range(rL)]))
    r_tok = direction_tokens(torch.randint(
        0, V, (rB, rT), generator=r_gen).to(dev), [False, True])
    r_h0 = (torch.randn((rL, rB, rH), generator=r_gen) * 0.5).to(dev)
    r_pre = (torch.randn((rL, rT, rB, 3 * rH), generator=r_gen) * 0.5).to(dev)

    def r_rand(shape, scale):
        return (torch.randn(shape, generator=r_gen) * scale).to(dev)

    def r_rec(rows):
        """w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0."""
        G_ = 3 * rH
        return [r_rand((Vp, G_), 0.05), r_rand((rows, G_), 0.5),
                r_rand((rH, G_), 0.05), r_rand((G_,), 0.05),
                r_rand((rH, G_), 0.05), r_rand((G_,), 0.05),
                r_rand((rH, G_), 0.05), r_rand((G_,), 0.05),
                r_rand((rows, rH), 0.5)]

    r_tgt = torch.randint(0, V, (rT, rB), generator=r_gen,
                          dtype=torch.int32).to(dev)
    r_dtok = torch.cat([torch.full((1, rB), V - 1, dtype=torch.int32,
                                   device=dev), r_tgt[:-1]])
    r_head = [torch.nn.functional.pad(r_rand((rH, V), 0.05), (0, Vp - V)),
              torch.nn.functional.pad(r_rand((V,), 0.05), (0, Vp - V),
                                      value=cuda_decoder.PAD_LOGIT)]
    rB0, r_rep = 9, 4
    r_ranges = (lambda f: lambda ids, *fl: f(ids, *fl, GLSR_MASK_RANGES,
                                             r_rep))
    # the sub-decoders: a 16-row class table, direction 0's ids in [0, 3),
    # direction 1's in [-2, 18) (ids outside the table add nothing)
    r_cls = torch.stack([
        torch.randint(0, 3, (rT, rB), generator=r_gen),
        torch.randint(-2, 18, (rT, rB), generator=r_gen)]).to(
            torch.int32).to(dev)
    r_seq = [r_rand((rL, 16, 3 * rH), 0.2), r_rand((rL, rB, 3 * rH), 0.2),
             r_whh, r_bhh, r_h0]
    ragged = {}
    for name, fn, plain, ids, floats, cot in (
            ("embed_gru_bwd", cuda_gru.stacked_gru_embed_finals,
             cuda_gru.stacked_gru_embed_finals_plain, r_tok,
             [r_wih, r_bih, r_whh, r_bhh, r_h0], r_rand((rL, rB, rH), 1.0)),
            ("embed_seq_bwd", cuda_gru.stacked_gru_embed_seq,
             cuda_gru.stacked_gru_embed_seq_plain, r_cls, r_seq,
             r_rand((rL, rT, rB, rH), 1.0)),
            ("stacked_gru_bwd", skip_ids(cuda_stacked.stacked_gru),
             skip_ids(cuda_stacked.stacked_gru_plain), no_ids,
             [r_pre, r_whh, r_bhh, r_h0], r_rand((rL, rT, rB, rH), 1.0)),
            ("decoder_ce_bwd",
             lambda ids, *fl: cuda_decoder.decoder_teacher_nll(
                 ids, r_tgt, *fl),
             lambda ids, *fl: cuda_decoder.decoder_teacher_nll_plain(
                 ids, r_tgt, *fl), r_dtok, r_rec(rB) + r_head,
             r_rand((rT, rB), 1.0 / (rT * rB))),
            ("decoder_teacher_bwd", cuda_decoder.decoder_teacher,
             cuda_decoder.decoder_teacher_plain, r_dtok, r_rec(rB),
             r_rand((rT, rB, rH), 0.01)),
            ("decoder_masses_bwd",
             r_ranges(cuda_decoder.decoder_teacher_masses),
             r_ranges(cuda_decoder.decoder_teacher_masses_plain),
             r_dtok[:, :rB0], r_rec(r_rep * rB0) + r_head,
             r_rand((rT, len(GLSR_MASK_RANGES), r_rep * rB0),
                    1.0 / (rT * rB0)))):
        _, r_out, r_grads = fwd_bwd(fn, ids, floats, cot)
        _, r_out_p, r_grads_p = fwd_bwd(plain, ids, floats, cot)
        torch.cuda.synchronize()
        r_abs, r_rel = grad_errors(r_grads, r_grads_p)
        ragged[name] = {
            "out_max_abs_err": float((r_out - r_out_p).detach().abs().max()),
            "grad_max_abs_err": r_abs, "grad_max_rel_err": r_rel}
    emit({"phase": "ragged_backward",
          "shape": {"L": rL, "T": rT, "B": rB, "H": rH, "Vp": Vp,
                    "masses_rows": f"{r_rep} x {rB0}"},
          "tol_out": TOL_TRAIN_OUT, "tol_grad_rel": TOL_TRAIN_GRAD_REL,
          **ragged})
    for name, e in ragged.items():
        if not (e["out_max_abs_err"] <= TOL_TRAIN_OUT
                and e["grad_max_rel_err"] <= TOL_TRAIN_GRAD_REL):
            return fail(f"ragged_backward, {name}: {e}")
    del r_wih, r_pre, r_grads, r_grads_p, r_head, r_seq

    # the four forward entries (the persistent forward chain, its partial
    # 16-row tiles, one step, an 8-unit column tile, a ragged k) without a
    # gradient against their plain versions, and bit-equal on a repeat
    fr_gen = torch.Generator().manual_seed(SEED + 8)
    guard.start("ragged_forward")
    ragged_fwd = []
    for fB, fT, fH in ((37, 1, 136), (130, 3, 136), (37, 9, 30),
                       (130, 5, 80)):
        def f_rand(shape, scale):
            return (torch.randn(shape, generator=fr_gen) * scale).to(dev)

        fG = 3 * fH
        f_rec = [f_rand((Vp, fG), 0.05), f_rand((fB, fG), 0.5)] + [
            f_rand(s_, 0.05) for s_ in ((fH, fG), (fG,), (fH, fG), (fG,),
                                        (fH, fG), (fG,))] + [
            f_rand((fB, fH), 0.5)]
        f_head = [torch.nn.functional.pad(f_rand((fH, V), 0.05),
                                          (0, Vp - V)),
                  torch.nn.functional.pad(f_rand((V,), 0.05), (0, Vp - V),
                                          value=cuda_decoder.PAD_LOGIT)]
        f_tgt = torch.randint(0, V, (fT, fB), generator=fr_gen,
                              dtype=torch.int32).to(dev)
        f_pre = f_rand((2, fT, fB, fG), 0.5)
        f_st = [f_rand((2, fH, fG), 0.05), f_rand((2, fG), 0.05),
                f_rand((2, fB, fH), 0.5)]
        row = {"B": fB, "T": fT, "H": fH}
        with torch.no_grad():
            for name, fn, plain in (
                    ("decoder_ce",
                     lambda: cuda_decoder.decoder_teacher_nll(
                         f_tgt, f_tgt, *f_rec, *f_head),
                     lambda: cuda_decoder.decoder_teacher_nll_plain(
                         f_tgt, f_tgt, *f_rec, *f_head)),
                    ("decoder_masses",
                     lambda: cuda_decoder.decoder_teacher_masses(
                         f_tgt, *f_rec, *f_head, GLSR_MASK_RANGES, 1),
                     lambda: cuda_decoder.decoder_teacher_masses_plain(
                         f_tgt, *f_rec, *f_head, GLSR_MASK_RANGES, 1)),
                    ("decoder_teacher",
                     lambda: cuda_decoder.decoder_teacher(f_tgt, *f_rec),
                     lambda: cuda_decoder.decoder_teacher_plain(f_tgt,
                                                                *f_rec)),
                    ("stacked_gru",
                     lambda: cuda_stacked.stacked_gru(f_pre, *f_st),
                     lambda: cuda_stacked.stacked_gru_plain(f_pre, *f_st))):
                got, again = fn(), fn()
                row[name] = {"max_abs_err": float((got - plain()).abs()
                                                  .max()),
                             "repeat_equal": bool(torch.equal(got, again))}
        # the encoder's two entries at L=4 (serving finals; the training
        # forward, its leaves wanting a gradient)
        e_w = list(stack_directions([gru_init(fr_gen, V, fH)
                                     for _ in range(4)]))
        e_w = [t.to(dev) for t in e_w] + [f_rand((4, fB, fH), 0.5)]
        e_tok = torch.randint(0, V, (4, fT, fB), generator=fr_gen,
                              dtype=torch.int32).to(dev)
        e_train = [e_w[0].clone().requires_grad_(True)] + e_w[1:]
        for name, fn in (
                ("embed_gru",
                 lambda: cuda_gru.stacked_gru_embed_finals(e_tok, *e_w)),
                ("embed_gru_train",
                 lambda: cuda_gru.stacked_gru_embed_finals(e_tok,
                                                           *e_train))):
            got, again = fn(), fn()
            with torch.no_grad():
                want = cuda_gru.stacked_gru_embed_finals_plain(e_tok, *e_w)
            err = float((got - want).detach().abs().max())
            row[name] = {"max_abs_err": err,
                         "repeat_equal": bool(torch.equal(got, again))}
        ragged_fwd.append(row)
    # the decode at B = 1, 37, 64 (8-row and partial and full 64-row
    # tiles), 1, 2 and 17 steps, H = 136 (34 blocks, a padded k) and 512,
    # greedy and sampling, an unsharpened head: tokens against the plain
    # decode under the near-tie rule, bit-equal on a repeat, in [0, V)
    dr_gen = torch.Generator().manual_seed(SEED + 9)
    ragged_dec = []
    with torch.inference_mode():
        for dH in (136, 512):
            d_view = tree_to(global_decoder_init(dr_gen, Zt, V, dH), dev)
            for dB in (1, 37, 64):
                d_z = torch.randn((dB, Zt), generator=dr_gen).to(dev)
                d_args, _, _ = cuda_decode._prep_decode_args(d_view, d_z)
                for d_steps in (1, 2, 17):
                    d_noise = -torch.log(-torch.log(torch.rand(
                        (d_steps, dB, Vp), generator=dr_gen).clamp_min(
                        1e-30))).to(dev)
                    d_inv = torch.full((dB,), 1 / 0.9, device=dev)
                    case = {"B": dB, "steps": d_steps, "H": dH}
                    for mode, run, ref, extra in (
                            ("greedy", lambda: cuda_decode.cuda_greedy_decode(
                                d_view, d_z, d_steps),
                             lambda: cuda_decode.plain_decode_tokens(
                                 d_view, d_z, d_steps), ()),
                            ("sample", lambda: cuda_decode.cuda_sample_decode(
                                d_view, d_z, d_noise, d_inv, d_steps),
                             lambda: cuda_decode.plain_sample_tokens(
                                 d_view, d_z, d_noise, d_inv, d_steps),
                             (d_noise, d_inv))):
                        got, again = run(), run()
                        try:
                            parted, gap = cuda_decode.near_tie_partings(
                                d_args, V, got, ref(), *extra,
                                tol=TOL_NEAR_TIE)
                        except AssertionError as e:
                            return fail(f"ragged decode {mode} {case}: {e}")
                        case[mode] = {"near_tie_rows": parted,
                                      "largest_gap": gap,
                                      "repeat_equal": bool(
                                          torch.equal(got, again))}
                    ragged_dec.append(case)
    emit({"phase": "ragged_forward", "tol_out": TOL_TRAIN_OUT,
          "cases": ragged_fwd, "decode_tol_near_tie": TOL_NEAR_TIE,
          "decode_cases": ragged_dec, "token_checks": guard.checked})
    for row in ragged_fwd:
        for name, e in row.items():
            if isinstance(e, dict) and not (
                    e["max_abs_err"] <= TOL_TRAIN_OUT and e["repeat_equal"]):
                return fail(f"ragged_forward, {name} at {row}")
    for case in ragged_dec:
        if not (case["greedy"]["repeat_equal"]
                and case["sample"]["repeat_equal"]):
            return fail(f"ragged_forward, decode repeat differs at {case}")

    # the decoder CE forward + backward at the long geometry (T=250,
    # B=128): the cooperative launches and the scratch sizes hold there
    LT = 250
    l_tgt = torch.from_numpy(
        rng.integers(0, V, size=(LT, TB)).astype(np.int32)).to(dev)
    l_tok = torch.cat([torch.full((1, TB), V - 1, dtype=torch.int32,
                                  device=dev), l_tgt[:-1]])
    l_cot = torch.full((LT, TB), 1.0 / (LT * TB), device=dev)
    l_fn = (lambda ids, *fl: cuda_decoder.decoder_teacher_nll(ids, l_tgt,
                                                              *fl))
    l_ts, l_out, l_grads = fwd_bwd(l_fn, l_tok, d_rec + d_head, l_cot)
    _, l_out_p, l_grads_p = fwd_bwd(
        lambda ids, *fl: cuda_decoder.decoder_teacher_nll_plain(
            ids, l_tgt, *fl), l_tok, d_rec + d_head, l_cot)
    l_again = torch.autograd.grad(l_out, l_ts, l_cot, retain_graph=True)
    torch.cuda.synchronize()
    l_same = (torch.equal(l_out, l_fn(l_tok, *l_ts))
              and all(torch.equal(a, b) for a, b in zip(l_grads, l_again)))
    l_err = float((l_out - l_out_p).detach().abs().max())
    l_abs, l_rel = grad_errors(l_grads, l_grads_p)
    l_f, l_b = time_fwd_bwd(l_fn, l_tok, l_ts, l_cot, 5)
    del l_ts, l_out, l_grads, l_out_p, l_grads_p, l_again
    # and the encoder (L=4) forward + backward at T=250, B=128: values,
    # gradients, a bit-equal repeat, and its forward's launches at T=250
    # and 125 (one kernel each)
    le_tok = direction_tokens(torch.from_numpy(rng.integers(
        0, V, size=(TB, LT)).astype(np.int32)).to(dev),
        [False, True, False, True])
    le_fl = [w_ih_p, b_ih, w_hh, b_hh, h0]
    le_cot = torch.randn((L, TB, H), generator=gen).to(dev)
    with EmbedCalls(cuda_gru) as le_calls:
        le_ts, le_out, le_grads = fwd_bwd(cuda_gru.stacked_gru_embed_finals,
                                          le_tok, le_fl, le_cot)
    _, le_out_p, le_grads_p = fwd_bwd(cuda_gru.stacked_gru_embed_finals_plain,
                                      le_tok, le_fl, le_cot)
    le_again = torch.autograd.grad(le_out, le_ts, le_cot, retain_graph=True)
    torch.cuda.synchronize()
    le_same = (torch.equal(le_out, cuda_gru.stacked_gru_embed_finals(
        le_tok, *le_ts)) and all(torch.equal(a, b)
                                 for a, b in zip(le_grads, le_again)))
    le_err = float((le_out - le_out_p).detach().abs().max())
    le_abs, le_rel = grad_errors(le_grads, le_grads_p)
    le_launches = le_calls.replay(dev)
    del le_ts, le_out, le_grads, le_out_p, le_grads_p, le_again
    emit({"phase": "long_geometry", "kernel": "decoder_ce",
          "shape": {"T": LT, "B": TB, "H": H, "Vp": Vp},
          "out_max_abs_err": l_err, "grad_max_abs_err": l_abs,
          "grad_max_rel_err": l_rel, "tol_out": TOL_TRAIN_OUT,
          "tol_grad_rel": TOL_TRAIN_GRAD_REL, "determinism": l_same,
          "fwd_ms": l_f, "bwd_ms": l_b,
          "encoder": {"L": L, "T": LT, "B": TB, "out_max_abs_err": le_err,
                      "grad_max_abs_err": le_abs, "grad_max_rel_err": le_rel,
                      "determinism": le_same,
                      "forward_launches": le_launches}})
    if not (l_err <= TOL_TRAIN_OUT and l_rel <= TOL_TRAIN_GRAD_REL
            and l_same):
        return fail(f"long_geometry: output {l_err}, gradients {l_rel}, "
                    f"repeat equal {l_same}")
    if not (le_err <= TOL_TRAIN_OUT and le_rel <= TOL_TRAIN_GRAD_REL
            and le_same) or embed_launch_faults(le_launches):
        return fail(f"long_geometry encoder: output {le_err}, gradients "
                    f"{le_rel}, repeat equal {le_same}, launches "
                    f"{le_launches}")

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
    # the warm-up steps run profiled: no per-step kernel may run, and the
    # encoder's and sub-decoders' forward entries they call are replayed
    # at T and T/2 (one kernel each)
    step_calls, step_old = EmbedCalls(cuda_gru), set()
    for name, arrays, bs, variant in (("unsupervised", yam, TB, "default"),
                                      ("supervised", vg, SB, "supervised")):
        with step_calls, DeviceWatch() as w:
            warm = tr.run_epoch(take(arrays, 0, 2 * bs), variant,
                                batch_size=bs, seed=1)
        step_old.update(w.per_step_kernels)
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
    step_fwd = step_calls.replay(dev)
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
          "embed_forward_launches": step_fwd,
          "per_step_kernels": sorted(step_old),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if step_old or embed_launch_faults(step_fwd):
        return fail(f"train_step: per-step kernels {sorted(step_old)}, "
                    f"encoder / sub-decoder launches {step_fwd}")
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
        with EmbedCalls(cuda_gru) as f_calls, DeviceWatch() as f_watch:
            f_warm = ftr.run_epoch(take(fam_corpus, 0, 2 * TB),
                                   batch_size=TB, seed=1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        f_timed = ftr.run_epoch(take(fam_corpus, 2 * TB, 5 * TB),
                                batch_size=TB, seed=2)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        f_launches = {k: v for counts in all_counts for k, v in
                      counts.items() if v}
        family_launches[fam] = f_launches
        f_fwd = f_calls.replay(dev)
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
              "embed_forward_launches": f_fwd,
              "per_step_kernels": f_watch.per_step_kernels,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if f_watch.per_step_kernels or embed_launch_faults(f_fwd):
            return fail(f"{fam}: per-step kernels "
                        f"{f_watch.per_step_kernels}, encoder / sub-decoder "
                        f"launches {f_fwd}")
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

    # -------------------------------------------------- single GM-VAE
    # `single_gmvae_forward(train=True, tokens=...)` at ModelConfig()
    # widths, B=128, fast layout: forward and backward of a fixed scalar
    # (the mean NLL of `out` at the targets + the mean of `log_logit`)
    # through the encoder kernels (L=2) and the fused teacher decoder
    # (kernels 7/8), against the plain path on this card and a float64
    # plain witness; then 3 timed forward + backward runs with the counts
    # set to 0 just before.
    sg_fast = tree_to(split_fast(init_single_gmvae(
        torch.Generator().manual_seed(SEED), cfg))[0], dev)
    sg_names, sg_leaves = zip(*[
        (n, t.requires_grad_(True)) for n, t in named_leaves(sg_fast)
        if n != "logvar_lookup"])
    sg_tok = fam_first["x"]
    sg_eps = torch.randn((TB, Z), generator=torch.Generator().manual_seed(
        SEED + 5)).to(dev)

    def sg_loss_grads(params=sg_fast, eps=sg_eps, leaves=sg_leaves):
        fwd = single_gmvae_forward(params, eps, None, cfg, train=True,
                                   tokens=sg_tok)
        nll = -fwd["out"].gather(-1, sg_tok.long()[..., None]).mean()
        loss = nll + fwd["log_logit"].mean()
        return loss.detach(), torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)

    for m in (cuda_gru, cuda_decoder, cuda_stacked):
        m.LAST_TRAIN_PATH = None
    sg_loss_k, sg_grads_k = sg_loss_grads()
    sg_paths = sorted({m.LAST_TRAIN_PATH for m in (
        cuda_gru, cuda_decoder, cuda_stacked)} - {None})
    copies = {}

    def sg_to64(t):
        c = t.detach().double().requires_grad_(t.requires_grad)
        copies[id(t)] = c
        return c

    sg_64 = tree_map(sg_to64, sg_fast)
    with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
        sg_loss_p, sg_grads_p = sg_loss_grads()
        sg_loss_64, sg_grads_64 = sg_loss_grads(
            sg_64, sg_eps.double(), [copies[id(t)] for t in sg_leaves])
    torch.cuda.synchronize()
    sg_loss_err = abs(float(sg_loss_k) - float(sg_loss_p))
    sg_worst = worst_leaf(sg_grads_k, sg_grads_p, sg_names)
    sg_witness = {
        key: {**worst_leaf(g, sg_grads_64, sg_names),
              "loss_abs_err": abs(float(loss) - float(sg_loss_64))}
        for key, loss, g in (("kernel", sg_loss_k, sg_grads_k),
                             ("plain", sg_loss_p, sg_grads_p))}
    del sg_grads_k, sg_grads_p, sg_grads_64, sg_64, copies
    with EmbedCalls(cuda_gru) as sg_calls, DeviceWatch() as sg_watch:
        sg_loss_grads()                                    # warm
    sg_fwd = sg_calls.replay(dev)
    for counts in all_counts:
        for k in counts:
            counts[k] = 0
    t0 = time.monotonic()
    for _ in range(3):
        sg_loss_grads()
    torch.cuda.synchronize()
    sg_ms = (time.monotonic() - t0) * 1e3 / 3
    sg_launches = {k: v for counts in all_counts for k, v in counts.items()
                   if v}
    # the GM-VAE's forward with tokens and no NLL targets takes the fused
    # teacher decoder too; its `out` against the route without tokens
    # (one-hot inputs through the generic stacked-GRU kernel)
    with torch.no_grad():
        oh = (lambda ids, n: torch.nn.functional.one_hot(ids.long(),
                                                         n).float())
        r_oh, n_oh = (oh(fam_first["r"], cfg.rhythm_dims),
                      oh(fam_first["n"], cfg.note_dims))
        e2 = torch.randn((2, TB, Z), generator=torch.Generator().manual_seed(
            SEED + 6)).to(dev)
        before = cuda_decoder.LAUNCHES["decoder_teacher"]
        with_tok = reg_gmvae_forward(p_dev, e2[0], e2[1], None, r_oh, n_oh,
                                     fam_first["c"], cfg, train=True,
                                     tokens=sg_tok)["out"]
        gm_teacher = cuda_decoder.LAUNCHES["decoder_teacher"] - before
        no_tok = reg_gmvae_forward(p_dev, e2[0], e2[1],
                                   oh(sg_tok, cfg.roll_dims), r_oh, n_oh,
                                   fam_first["c"], cfg, train=True)["out"]
        gm_out_err = float((with_tok - no_tok).abs().max())
        del with_tok, no_tok
    emit({"phase": "single_gmvae", "B": TB, "loss_kernel": float(sg_loss_k),
          "loss_plain": float(sg_loss_p), "loss_abs_err": sg_loss_err,
          "grad_max_abs_err": sg_worst["grad_max_abs_err"],
          "grad_max_rel_err": sg_worst["grad_max_rel_err"],
          "grad_worst_leaf": sg_worst["worst_leaf"],
          "tol_grad_rel": TOL_TRAIN_GRAD_REL, "kernel_paths": sg_paths,
          "float64_witness": sg_witness, "fwd_bwd_ms": sg_ms,
          "launches": sg_launches, "embed_forward_launches": sg_fwd,
          "per_step_kernels": sg_watch.per_step_kernels,
          "gmvae_tokens_no_nll": {"decoder_teacher_launches": gm_teacher,
                                  "out_max_abs_err": gm_out_err,
                                  "tol": TOL_TRAIN_OUT}})
    if sg_paths != ["kernel"]:
        return fail(f"single_gmvae ran {sg_paths}, not the kernels")
    if sg_watch.per_step_kernels or embed_launch_faults(sg_fwd):
        return fail(f"single_gmvae: per-step kernels "
                    f"{sg_watch.per_step_kernels}, encoder launches {sg_fwd}")
    if not (sg_loss_err <= TOL_TRAIN_OUT * max(1.0, abs(float(sg_loss_p)))
            and sg_worst["grad_max_rel_err"] <= TOL_TRAIN_GRAD_REL):
        return fail(f"single_gmvae kernel vs plain: loss {sg_loss_err}, "
                    f"gradients {sg_worst}")
    sg_kernels = ("embed_gru_train", "embed_gru_bwd", "decoder_teacher",
                  "decoder_teacher_bwd")
    if not all(sg_launches.get(k, 0) > 0 for k in sg_kernels):
        return fail(f"single_gmvae: a kernel never launched: {sg_launches}")
    if gm_teacher != 1 or not gm_out_err <= TOL_TRAIN_OUT:
        return fail(f"reg_gmvae_forward with tokens: {gm_teacher} fused "
                    f"decoder launches, out error {gm_out_err}")
    del sg_fast, sg_leaves

    # ------------------------------------------------------- evaluation
    # The evaluation path at full width on the port's synthetic corpus
    # (seed 0, 1,536 segments: 1,228 / 154 / 154), the GM-VAE at its random
    # init. (1) The entry point, as a user runs it. (2) The reconstruction
    # report on the test split at B=128, kernel path against plain path.
    # (3) The rhythm and note evaluators at the CLI's workload (2 epochs x
    # 20 samples x 8 values, 100 steps), every decoded row held against
    # the plain decode of the same z. (4) One epoch of the CVAE's
    # condition sweep, which decodes through the `global_decode` loop.
    n_seg = 1536
    guard.start("evaluation")
    for counts in all_counts + (cuda_decode.LAUNCHES,):
        for k in counts:
            counts[k] = 0
    cli_out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(cli_out):
        eval_cli.main(["gmm", "--synthetic-size", str(n_seg), "--seed",
                       str(SEED), "--save-dir", "build/no_checkpoints"])
    torch.cuda.synchronize()
    cli_s = time.monotonic() - t0
    cli_launches = {k: v for counts in all_counts + (cuda_decode.LAUNCHES,)
                    for k, v in counts.items() if v}
    cli_path = cuda_decode.LAST_DECODE_PATH
    cli_text = cli_out.getvalue()

    t0 = time.monotonic()
    corpus = synth_corpus(n_seg, cfg.seq_len, cfg.attr_len, seed=SEED)
    corpus_s = time.monotonic() - t0
    ev_train = YamahaDataset(*corpus, mode="train").arrays()
    ev_test = YamahaDataset(*corpus, mode="test").arrays()
    gm_fwd, gm_sub, gm_draw = _forward_for("gmm", cfg)

    def report():
        return reconstruction_report(p_dev, gm_fwd, ev_test, cfg,
                                     draw=gm_draw, batch_size=TB, seed=SEED,
                                     has_subdecoders=gm_sub)

    report()                                               # warm
    before = cuda_stacked.LAUNCHES["stacked_gru"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rep_k = report()
    torch.cuda.synchronize()
    report_s = time.monotonic() - t0
    rep_stacked = cuda_stacked.LAUNCHES["stacked_gru"] - before
    before = cuda_stacked.LAUNCHES["stacked_gru"]
    with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
        rep_p = report()
    if cuda_stacked.LAUNCHES["stacked_gru"] != before:
        return fail("the plain reconstruction report launched a kernel")
    rep_err = max(abs(rep_k[k] - rep_p[k]) for k in rep_k)
    rep_finite = all(np.isfinite(v) for v in rep_k.values())

    def encode_batched(batch, g):
        (mu_r, std_r), (mu_n, std_n) = models.reg_vae_encode(
            p_dev, None, tokens=batch["x"])
        draw = (lambda mu, std: mu + std * torch.randn(
            mu.shape, generator=g).to(dev))
        return draw(mu_r, std_r), draw(mu_n, std_n)

    stats = latent_stats(encode_batched, ev_train, cfg, seed=SEED)
    stats_te = latent_stats(encode_batched, ev_test, cfg, seed=SEED)
    gview_dev = _global_view(p_dev)
    evaluators = {}
    for target, lo, hi in (("rhythm", stats_te["z_r_min"],
                            stats_te["z_r_max"]),
                           ("note", stats_te["z_n_min"],
                            stats_te["z_n_max"])):
        ev = ControllabilityEvaluator(
            p_dev, cfg, models.reg_vae_encode, models.reg_vae_global_decode,
            target=target, epochs=2, num_of_samples=20, decode_steps=100,
            seed=SEED, verbose=False,
            decode_tokens=models.reg_vae_decode_tokens)
        waves = []
        inner = ev._decode_all

        def decode_all(z_full, inner=inner, waves=waves):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            toks = inner(z_full)
            torch.cuda.synchronize()
            waves.append((z_full.clone(), toks,
                          cuda_decode.LAST_DECODE_PATH,
                          time.monotonic() - t1))
            return toks

        ev._decode_all = decode_all
        before = cuda_decode.LAUNCHES["greedy_decode"]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        scores = ev.evaluate(ev_test, lo, hi, stats["r_std"], stats["n_std"])
        torch.cuda.synchronize()
        ev_s = time.monotonic() - t0
        n_greedy = cuda_decode.LAUNCHES["greedy_decode"] - before
        parted_rows, gap, rows = 0, 0.0, 0
        with torch.inference_mode():
            for z_full, toks, _, _ in waves:
                a, _, _ = cuda_decode._prep_decode_args(gview_dev, z_full)
                ref = cuda_decode.plain_decode_tokens(gview_dev, z_full, 100)
                try:
                    n_p, g_p = cuda_decode.near_tie_partings(
                        a, V, torch.from_numpy(toks).to(dev), ref,
                        tol=TOL_NEAR_TIE)
                except AssertionError as e:
                    return fail(f"evaluation, {target} evaluator's decode "
                                f"vs plain: {e}")
                parted_rows += n_p
                gap = max(gap, g_p)
                rows += len(toks)
        flat = [v for f in SCORE_FIELDS for v in getattr(scores, f)]
        evaluators[target] = {
            "seconds": ev_s, "decode_seconds": sum(w[3] for w in waves),
            "scores": dataclass_values(scores),
            "scores_are_floats": all(isinstance(v, float) for v in flat),
            "waves": len(waves), "decoded_rows": rows,
            "greedy_decode_launches": n_greedy,
            "decode_paths": sorted({w[2] for w in waves}),
            "plain_near_tie_rows": parted_rows, "largest_gap": gap}
    # CVAE: one epoch, 20 samples, through the argmax of global_decode
    cv_params = tree_to(models.init_cvae(
        torch.Generator().manual_seed(SEED), cfg), dev)
    cv = ConditionControllabilityEvaluator(
        cv_params, cfg, models.cvae_encode, models.cvae_global_decode,
        target="rhythm", epochs=1, num_of_samples=20, decode_steps=100,
        seed=SEED, verbose=False)
    cv_calls = []
    cv_inner = cv._decode_all

    def cv_decode_all(z_full):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        toks = cv_inner(z_full)
        torch.cuda.synchronize()
        cv_calls.append({"rows": int(z_full.shape[0]),
                         "ms": (time.monotonic() - t1) * 1e3})
        return toks

    cv._decode_all = cv_decode_all
    t0 = time.monotonic()
    cv_scores = cv.evaluate(ev_test, 0.0, 1.0, stats["r_std"],
                            stats["n_std"])
    torch.cuda.synchronize()
    cv_s = time.monotonic() - t0
    emit({"phase": "evaluation", "segments": n_seg, "corpus_seconds": corpus_s,
          "cli": {"seconds": cli_s, "launches": cli_launches,
                  "decode_path": cli_path,
                  "reports_printed": cli_text.count("Consistency:")},
          "reconstruction_report": {
              "rows": len(ev_test["x"]), "B": TB, "seconds": report_s,
              "report": rep_k, "vs_plain_max_abs_err": rep_err,
              "tol": TOL_TRAIN_OUT, "finite": rep_finite,
              "stacked_gru_launches": rep_stacked},
          "latent_stats": {"train": stats, "test": stats_te},
          "evaluators": evaluators,
          "cvae_condition_sweep": {
              "seconds": cv_s, "decode_calls": cv_calls,
              "scores": dataclass_values(cv_scores)},
          "token_checks": guard.checked})
    if guard.bad:
        return fail(f"decode kernel tokens out of range: {guard.bad}")
    if cli_text.count("Consistency:") != 2:
        return fail(f"eval CLI printed no two reports:\n{cli_text[-2000:]}")
    if not (cli_launches.get("greedy_decode", 0) > 0
            and cli_launches.get("embed_gru", 0) > 0
            and cli_path in ("kernel", "kernel-chunked")):
        return fail(f"eval CLI did not run the kernels: {cli_launches}, "
                    f"{cli_path}")
    if not (rep_finite and rep_err <= TOL_TRAIN_OUT and rep_stacked > 0):
        return fail(f"reconstruction report: finite {rep_finite}, vs plain "
                    f"{rep_err}, stacked_gru launches {rep_stacked}")
    for target, e in evaluators.items():
        if not (e["greedy_decode_launches"] > 0 and e["scores_are_floats"]
                and set(e["decode_paths"]) <= {"kernel", "kernel-chunked"}):
            return fail(f"{target} evaluator: {e}")
    del cv_params, cv

    # -------------------------------------------------------- train_cli
    # The user's path from training to use, at full width (the GM-VAE of
    # configs/gmm_model_config.json as the CLI loads it), in a temporary
    # directory: `run_training("gmm")` on the dual corpus (the synthetic
    # Yamaha corpus of 1,536 segments, seed 0, and the synthetic VGMIDI
    # corpus) for 2 epochs, the same command with --epochs 3 (resumes after
    # epoch 2), save -> restore bit-exactness, then the server, the eval
    # CLI and the transfer CLI (greedy and sampled) from the saved
    # directory, each against the plain path on this card.
    def train_cli_phase(tmp: str) -> int:
        repo = os.path.dirname(os.path.abspath(__file__))
        common = ["--config", os.path.join(repo, "configs",
                                           "gmm_model_config.json"),
                  "--synthetic-size", str(n_seg), "--seed", str(SEED),
                  "--save-dir", os.path.join(tmp, "params"),
                  "--log-dir", os.path.join(tmp, "log"),
                  "--data-dir", os.path.join(tmp, "no_cache"),
                  "--vgmidi-dir", os.path.join(tmp, "no_vgmidi")]
        args = train_cli.build_argparser("chip_smoke").parse_args(common)
        tcfg = train_cli.config_from_args("gmm", args)
        name = train_cli.MODEL_REGISTRY["gmm"]["name"]
        ck_dir = os.path.join(tmp, "params", name)
        counts = all_counts + (cuda_decode.LAUNCHES,)

        def run(fn, *a, **kw):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = fn(*a, **kw)
            torch.cuda.synchronize()
            return res, out.getvalue()

        # (1) two epochs
        zero_counts(*counts)
        t0 = time.monotonic()
        tr2, out2 = run(train_cli.run_training, "gmm", "chip_smoke",
                        dual_corpus=True, argv=common + ["--epochs", "2"])
        train_s = time.monotonic() - t0
        train_l = read_counts(*counts)
        with open(os.path.join(tmp, "log", f"{name}.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        finite = all(np.isfinite(v) for r in recs for k, v in r.items()
                     if isinstance(v, float) and k != "time")
        t_ep = [r["time"] for r in recs if r["split"] == "vgmidi_train"]
        stamped = [d for d in os.listdir(os.path.join(tmp, "params"))
                   if d.startswith(name + "_")]
        # (2) resume: the same command with --epochs 3
        resumed = train_cli.make_trainer("gmm", tcfg, args)
        t0 = time.monotonic()
        tr3, out3 = run(train_cli.run_training, "gmm", "chip_smoke",
                        dual_corpus=True, argv=common + ["--epochs", "3"])
        resume_s = time.monotonic() - t0
        per_epoch = (tr2.step // 2, tr2._host_step // 2)
        resume = {"printed": f"resumed at step {tr2.step}" in out3,
                  "host_step_at_resume": resumed._host_step,
                  "step_at_resume": resumed.step,
                  "steps_taken": tr3.step - tr2.step,
                  "host_steps_taken": tr3._host_step - resumed._host_step,
                  "steps_per_epoch": per_epoch[0], "seconds": resume_s}
        del resumed
        yam = train_cli.load_yamaha(args, tcfg)["train"].arrays()
        ms_step = tr3.compiled_step_time(yam, iters=10) * 1e3
        # (3) 3 steps + save + restore + 3 steps against 6 straight steps
        start = tr3.state
        part = {k: v[:3 * tcfg.batch_size] for k, v in yam.items()}
        part2 = {k: v[3 * tcfg.batch_size:6 * tcfg.batch_size]
                 for k, v in yam.items()}
        spec = train_cli.MODEL_REGISTRY["gmm"]

        def fresh():
            t = Trainer(tcfg, spec["init"], spec["losses"], seed=SEED,
                        params=start.params, device=dev)
            t.load_state(start)
            return t

        straight = fresh()
        straight.run_epoch(part, seed=1)
        straight.run_epoch(part2, seed=2)
        first = fresh()
        first.run_epoch(part, seed=1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = ckpt.save_checkpoint(os.path.join(tmp, "exact"), first.state)
        save_s = time.monotonic() - t0
        ck_mb = os.path.getsize(path) / 2**20
        t0 = time.monotonic()
        ck = ckpt.restore_checkpoint(os.path.join(tmp, "exact"))
        second = Trainer(tcfg, spec["init"], spec["losses"], seed=SEED,
                         device=dev)
        second.load_state(TrainState(ck["params"], ck["opt_state"],
                                     ck["step"]))
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        second.run_epoch(part2, seed=2)
        a, b = second.state, straight.state
        differ = [("params",) + k for k, v in ckpt.named_leaves(a.params)
                  if not torch.equal(v, dict(ckpt.named_leaves(
                      b.params))[k])]
        for m in ("mu", "nu"):
            want = dict(ckpt.named_leaves(b.opt_state[m]))
            differ += [(m,) + k for k, v in
                       ckpt.named_leaves(a.opt_state[m])
                       if not torch.equal(v, want[k])]
        exact = {"steps": [a.step, b.step],
                 "host_steps": [second._host_step, straight._host_step],
                 "count": [a.opt_state["count"], b.opt_state["count"]],
                 "leaves_differing": ["/".join(k) for k in differ][:8]}
        del straight, first, second, a, b, ck
        # (4) serving from the saved directory
        restored = tree_to(ckpt.restore_checkpoint(ck_dir)["params"], dev)
        served = {}

        class RecordingServer(TransferServer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                served["server"], served["pairs"] = self, []

            def submit(self, req):
                fut = super().submit(req)
                served["pairs"].append((req, fut))
                return fut

        guard.start("train_cli")
        zero_counts(*counts)
        serve_cli.TransferServer = RecordingServer
        try:
            _, out_s = run(serve_cli.run_server, common + ["--bench", "64"])
        finally:
            serve_cli.TransferServer = TransferServer
        serve_l = read_counts(*counts)
        bench = json.loads(out_s.strip().splitlines()[-1])
        leaf = ("linear_out_g", "w")
        srv_params = served["server"].params
        from_ckpt = torch.equal(srv_params[leaf[0]][leaf[1]],
                                restored[leaf[0]][leaf[1]])
        init_leaf = init_reg_gmvae(torch.Generator().manual_seed(SEED),
                                   tcfg)[leaf[0]][leaf[1]]
        not_init = not torch.equal(srv_params[leaf[0]][leaf[1]].cpu(),
                                   init_leaf)
        shifts = compute_shift_vectors(restored)
        gv = _global_view(restored)
        s_rows, s_parted = 0, 0
        with torch.inference_mode():
            for req, fut in served["pairs"][1:9]:
                resp = fut.result()
                tok = torch.tensor([req["tokens"]], device=dev)
                x = torch.nn.functional.one_hot(tok.long(), V).float()
                (mu_r, _), (mu_n, _) = reg_vae_encode(restored, x)
                d = req["direction"]
                z = torch.cat([
                    mu_r + torch.from_numpy(shifts[f"r_{d}"]).to(dev),
                    mu_n + torch.from_numpy(shifts[f"n_{d}"]).to(dev),
                    torch.zeros((1, tcfg.chroma_dims), device=dev)], -1)
                a_, _, _ = cuda_decode._prep_decode_args(gv, z)
                ref = cuda_decode.plain_decode_tokens(gv, z, steps)
                got = torch.tensor([resp["tokens"]], device=dev)
                try:
                    n_p, _ = cuda_decode.near_tie_partings(
                        a_, V, got, ref, tol=TOL_NEAR_TIE)
                except AssertionError as e:
                    return fail(f"train_cli: served row vs plain: {e}")
                s_parted += n_p
                s_rows += 1
        del served
        # (5) the eval CLI from the saved directory
        zero_counts(*counts)
        t0 = time.monotonic()
        _, out_e = run(eval_cli.main, ["gmm"] + common)
        eval_s = time.monotonic() - t0
        eval_l = read_counts(*counts)
        # (6) the transfer CLI, greedy and sampled, from the saved directory
        transfer = {}
        item = train_cli.load_vgmidi(args)["test"][0]
        for label, extra in (("greedy", []),
                             ("sampled", ["--temperature", "1.0"])):
            zero_counts(*counts)
            mid = os.path.join(tmp, f"{label}.mid")
            wav = os.path.join(tmp, f"{label}.wav")
            (toks, notes), _ = run(transfer_cli.main, common + extra + [
                "--out", mid, "--wav", wav])
            t_l = read_counts(*counts)
            with torch.inference_mode():
                z = transfer_latent(restored, item, seed=SEED, device=dev)
                a_, _, _ = cuda_decode._prep_decode_args(gv, z)
                got = torch.from_numpy(toks)[None].to(dev)
                if label == "greedy":
                    ref = cuda_decode.plain_decode_tokens(gv, z, steps)
                    noise = inv_t = None
                else:
                    noise = gumbel_rows([SEED], steps, Vp, dev)
                    inv_t = torch.ones(1, device=dev)
                    ref = cuda_decode.plain_sample_tokens(gv, z, noise,
                                                          inv_t, steps)
                try:
                    n_p, gap = cuda_decode.near_tie_partings(
                        a_, V, got, ref, noise, inv_t, tol=TOL_NEAR_TIE)
                except AssertionError as e:
                    return fail(f"train_cli: {label} transfer vs plain: {e}")
            ms = []
            with guard.pause():
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    arousal_transfer(restored, tcfg, item,
                                     temperature=1.0 if extra else 0.0,
                                     seed=SEED, device=dev)
                    torch.cuda.synchronize()
                    ms.append((time.monotonic() - t0) * 1e3)
            transfer[label] = {
                "tokens": len(toks), "notes": len(notes),
                "midi_bytes": os.path.getsize(mid),
                "wav_bytes": os.path.getsize(wav),
                "launches": t_l, "plain_near_tie_rows": n_p,
                "largest_gap": gap, "ms": statistics.median(ms)}
        emit({"phase": "train_cli", "config": "configs/gmm_model_config.json",
              "hidden_dims": tcfg.hidden_dims, "z_dims": tcfg.z_dims,
              "train": {"epochs": 2, "seconds": train_s,
                        "epoch_seconds": t_ep[1] - t_ep[0],
                        "steps": tr2.step, "host_steps": tr2._host_step,
                        "losses_finite": finite, "records": len(recs),
                        "train_path": tr2.train_path, "launches": train_l,
                        "timestamped_checkpoints": len(stamped)},
              "resume": resume, "ms_per_step": ms_step,
              "save_seconds": save_s, "restore_seconds": restore_s,
              "checkpoint_mb": ck_mb, "bit_exact": exact,
              "serving": {"req_per_s": bench["value"],
                          "serving_path": bench["serving_path"],
                          "latency_ms_p50": bench["latency_ms_p50"],
                          "launches": serve_l, "params_from_checkpoint":
                          from_ckpt, "not_the_random_init": not_init,
                          "plain_checked_rows": s_rows,
                          "plain_near_tie_rows": s_parted},
              "evaluation": {"seconds": eval_s, "launches": eval_l,
                             "restored": "restored full-state checkpoint "
                                         "layout" in out_e,
                             "reports": out_e.count("Consistency:")},
              "transfer": transfer, "token_checks": guard.checked})
        tr2_path = tr2.train_path
        del tr2, tr3, restored
        if guard.bad:
            return fail(f"decode kernel tokens out of range: {guard.bad}")
        printed = ("[vgmidi test]" in out2 and "[test]" in out2
                   and "Epoch 2 / 2" in out2)
        if not (finite and len(recs) == 8 and printed
                and tr2_path == "kernel"):
            return fail(f"train_cli: losses finite {finite}, {len(recs)} "
                        f"log records, train_path {tr2_path}, or the "
                        "reports were not printed")
        row_kernels = ("embed_gru_train", "embed_gru_bwd", "embed_seq",
                       "embed_seq_bwd", "decoder_ce", "decoder_ce_bwd",
                       "stacked_gru")
        if not all(train_l.get(k, 0) > 0 for k in row_kernels):
            return fail(f"train_cli: a kernel never launched: {train_l}")
        if not (os.path.isfile(os.path.join(ck_dir, "state.pt"))
                and len(stamped) == 1):
            return fail(f"train_cli: checkpoints {os.listdir(tmp)}")
        if not (resume["printed"] and resume["host_step_at_resume"]
                == resume["step_at_resume"] == per_epoch[0] * 2
                and resume["steps_taken"] == per_epoch[0]
                and resume["host_steps_taken"] == per_epoch[1]):
            return fail(f"train_cli: resume {resume}")
        if exact["leaves_differing"] or len(set(exact["steps"])) != 1 or \
                len(set(exact["host_steps"])) != 1:
            return fail(f"train_cli: save -> restore not bit-exact: {exact}")
        if not (bench["serving_path"] == "kernel" and from_ckpt and not_init
                and s_rows == 8 and serve_l.get("embed_gru", 0) > 0
                and serve_l.get("greedy_decode", 0) > 0):
            return fail(f"train_cli: serving {bench}, from checkpoint "
                        f"{from_ckpt}, launches {serve_l}")
        if not ("restored full-state checkpoint layout" in out_e
                and out_e.count("Consistency:") == 2
                and eval_l.get("embed_gru", 0) > 0
                and eval_l.get("greedy_decode", 0) > 0):
            return fail(f"train_cli: eval CLI {eval_l}:\n{out_e[-1500:]}")
        for label, want in (("greedy", "greedy_decode"),
                            ("sampled", "sample_decode")):
            t = transfer[label]
            if not (t["launches"].get(want, 0) > 0
                    and t["launches"].get("embed_gru", 0) > 0
                    and t["tokens"] == steps and t["midi_bytes"] > 0
                    and t["wav_bytes"] > 44):
                return fail(f"train_cli: {label} transfer {t}")
        return 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        rc = train_cli_phase(tmp)
    if rc:
        return rc

    # ------------------------------------------------------- primitives
    # The public GRU primitives (`ops.gru_scan` both ways,
    # `ops.bigru_final_state`, an encoder stream over T=100 one-hots, the
    # rhythm and note sub-decoders over T=attr_len) at full width, B=128:
    # forward and the gradient of every param (and z) on the kernel path
    # against the plain path on this card; kernels 1/2 launched, with the
    # counts zeroed just before and read just after, and one forward launch
    # a call (both bi-GRU directions in one); no per-step kernel. The
    # bi-GRU's forward is timed in turns against cuDNN's bidirectional
    # nn.GRU carrying the same weights (its projection included, as the
    # primitive's einsum is).
    from music_fader_nets_tpu_torch import ops as port_ops
    from music_fader_nets_tpu_torch.models.modules import (
        encoder_stream_apply, encoder_stream_init, sub_decoder_apply,
        sub_decoder_init,
    )
    from music_fader_nets_tpu_torch.ops.gru import bigru_init

    def one_hot(n_cls, *shape):
        ids = torch.from_numpy(rng.integers(0, n_cls, size=shape)).to(dev)
        return torch.nn.functional.one_hot(ids, n_cls).float()

    A = cfg.attr_len
    p_x = one_hot(V, TB, T)
    p_z = torch.randn((TB, Z), generator=gen).to(dev)
    faithful = cfg.faithful_subdecoder_softmax_axis

    def ce_cot(n_cls):
        """The cotangent of a sub-decoder's log-probs under its mean NLL
        (nll_mean) on random targets, -one_hot / (B * attr_len), as
        training gives it. (Under the time-axis log-softmax its output
        bias gets an exact-0 gradient, float32 noise on both paths that
        scales with the cotangent.)"""
        return -one_hot(n_cls, TB, A) / (TB * A)

    # name: (params, inputs (the first one wants no gradient), function,
    # output cotangent or None for a standard normal one)
    prim_cases = {
        "gru_scan": (gru_init(gen, V, H), (p_x,),
                     lambda p, x: port_ops.gru_scan(p, x)[0], None),
        "gru_scan_reverse": (gru_init(gen, V, H), (p_x,),
                             lambda p, x: port_ops.gru_scan(
                                 p, x, reverse=True)[0], None),
        "bigru_final_state": (bigru_init(gen, V, H), (p_x,),
                              lambda p, x: port_ops.bigru_final_state(
                                  p["fwd"], p["bwd"], x), None),
        "encoder_stream": (encoder_stream_init(gen, V, H, Z), (p_x,),
                           lambda p, x: torch.cat(
                               encoder_stream_apply(p, x), -1), None),
        "sub_decoder_r": (sub_decoder_init(gen, Z, cfg.rhythm_dims, H),
                          (one_hot(cfg.rhythm_dims, TB, A), p_z),
                          lambda p, a, z: sub_decoder_apply(p, a, z,
                                                            faithful),
                          ce_cot(cfg.rhythm_dims)),
        "sub_decoder_n": (sub_decoder_init(gen, Z, cfg.note_dims, H),
                          (one_hot(cfg.note_dims, TB, A), p_z),
                          lambda p, a, z: sub_decoder_apply(p, a, z,
                                                            faithful),
                          ce_cot(cfg.note_dims)),
    }

    def prim_grads(fn, p, ins, cot):
        """(output, gradients of every param leaf and of z) of one call."""
        pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        xs = [t if i == 0 else t.detach().clone().requires_grad_(True)
              for i, t in enumerate(ins)]
        leaves = [t for _, t in named_leaves(pp)] + xs[1:]
        out = fn(pp, *xs)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    prim = {}
    for name, (p_cpu, ins, fn, cot) in prim_cases.items():
        p = tree_to(p_cpu, dev)
        with torch.no_grad():
            shape = fn(p, *ins).shape
        if cot is None:
            cot = torch.randn(shape, generator=gen).to(dev)
        zero_counts(cuda_stacked.LAUNCHES)
        with DeviceWatch() as w:
            out_k, g_k = prim_grads(fn, p, ins, cot)
        fb_launches = read_counts(cuda_stacked.LAUNCHES)
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            out_p, g_p = prim_grads(fn, p, ins, cot)
        zero_counts(cuda_stacked.LAUNCHES)
        with torch.no_grad():
            fn(p, *ins)
            torch.cuda.synchronize()
        f_launches = read_counts(cuda_stacked.LAUNCHES)
        out_err = float((out_k - out_p).abs().max())
        g_worst = worst_leaf(g_k, g_p, [k for k, _ in named_leaves(p)]
                             + ["z"] * (len(ins) - 1))
        with torch.no_grad():
            k_ms = time_ms(lambda: fn(p, *ins), 10)
            with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
                p_ms = time_ms(lambda: fn(p, *ins), 2, warm=1)
        kfb_ms = time_ms(lambda: prim_grads(fn, p, ins, cot), 5)
        prim[name] = {"out_shape": list(shape), "out_max_abs_err": out_err,
                      **g_worst, "fwd_bwd_launches": fb_launches,
                      "fwd_launches": f_launches,
                      "per_step_kernels": w.per_step_kernels,
                      "fwd_ms": k_ms, "plain_fwd_ms": p_ms,
                      "fwd_bwd_ms": kfb_ms}
        if name == "bigru_final_state":
            g = torch.nn.GRU(V, H, batch_first=True,
                             bidirectional=True).to(dev)
            with torch.no_grad():
                for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                    getattr(g, "weight_ih_l0" + suf).copy_(p[d]["w_ih"].t())
                    getattr(g, "weight_hh_l0" + suf).copy_(p[d]["w_hh"].t())
                    getattr(g, "bias_ih_l0" + suf).copy_(p[d]["b_ih"])
                    getattr(g, "bias_hh_l0" + suf).copy_(p[d]["b_hh"])

                def cudnn_bigru():
                    h_n = g(p_x)[1]
                    return torch.cat([h_n[0], h_n[1]], -1)

                turns = {"kernel_ms": [], "cudnn_ms": []}
                for order in (("kernel_ms", "cudnn_ms"),
                              ("cudnn_ms", "kernel_ms")):
                    for key in order:
                        turns[key].append(time_ms(
                            cudnn_bigru if key == "cudnn_ms"
                            else (lambda: fn(p, *ins)), 10))
                prim[name]["cudnn_turns"] = turns
                prim[name]["cudnn_max_abs_err"] = float(
                    (cudnn_bigru() - out_k).abs().max())
            del g
        del p, out_k, out_p, g_k, g_p
    emit({"phase": "primitives", "B": TB, "H": H, "Z": Z, "V": V, "T": T,
          "attr_len": A, "tol_out": TOL_TRAIN_OUT,
          "tol_grad_rel": TOL_TRAIN_GRAD_REL, "cases": prim})
    for name, r in prim.items():
        if not (r["out_max_abs_err"] <= TOL_TRAIN_OUT
                and r["grad_max_rel_err"] <= TOL_TRAIN_GRAD_REL):
            return fail(f"primitives {name}: kernel vs plain output "
                        f"{r['out_max_abs_err']}, gradients "
                        f"{r['grad_max_rel_err']} (relative)")
        if not (r["fwd_bwd_launches"].get("stacked_gru", 0) >= 1
                and r["fwd_bwd_launches"].get("stacked_gru_bwd", 0) >= 1
                and r["fwd_launches"] == {"stacked_gru": 1}
                and not r["per_step_kernels"]):
            return fail(f"primitives {name}: launches {r}")

    # ----------------------------------------------------------- parity
    # The port's parity harness (`music_fader_nets_tpu_torch.parity`) on
    # stand-ins for the six released checkpoints, made at full width by the
    # port's own `params_to_torch_state_dict` from seeded inits: section 1
    # (converter round trip), section 2 (the port on this card against the
    # torch replica on the CPU, atol 1e-4: the encoders on dense inputs
    # through kernel 1 and on one-hots with their token ids through kernel
    # 3, the sub-decoders through kernel 1, the teacher decode through
    # kernel 1 and, with token ids, kernel 7), section 3 (the Table-1 eval)
    # for gmm, and section 4 (token re-encode) on 64 rows of the port's
    # own codec. Each kind's launches are read with the counts zeroed just
    # before its section 2.
    from music_fader_nets_tpu_torch import parity as port_parity
    from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote
    from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
        performance_decode, performance_encode,
    )

    def parity_phase(tmp: str) -> int:
        pcfg = ModelConfig()
        rows = []
        for _ in range(64):
            t = np.cumsum(rng.random(24) * 0.3)
            notes = [MidiNote(int(rng.integers(21, 109)),
                              int(rng.integers(1, 128)), float(s),
                              float(s + rng.random() + 0.01)) for s in t]
            # a stream the codec wrote from quantized notes, as the
            # released token arrays are
            rows.append(performance_encode(performance_decode(
                performance_encode(notes)), add_eos=True))
        width = max(len(r) for r in rows)
        tok_path = os.path.join(tmp, "song_tokens.npy")
        np.save(tok_path, np.stack([np.pad(r, (0, width - len(r)))
                                    for r in rows]))
        guard.start("parity")
        res = {}
        for i, (fname, kind) in enumerate(port_parity.RELEASED_CKPTS):
            path = os.path.join(tmp, fname)
            torch.save(ckpt.params_to_torch_state_dict(
                train_cli.MODEL_REGISTRY[kind]["init"](
                    torch.Generator().manual_seed(SEED + i), pcfg)), path)
            sd = port_parity.load_state_dict(path)
            r, secs, diffs = {}, {}, {}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                t0 = time.monotonic()
                r["roundtrip"] = port_parity.check_roundtrip(sd)
                secs["roundtrip"] = time.monotonic() - t0
                zero_counts(*all_counts, cuda_decode.LAUNCHES)
                t0 = time.monotonic()
                r["forward"] = port_parity.check_forward(sd, kind, "cuda",
                                                         diffs=diffs)
                torch.cuda.synchronize()
                secs["forward"] = time.monotonic() - t0
                fwd_l = read_counts(*all_counts, cuda_decode.LAUNCHES)
                if kind == "gmm":
                    args = port_parity.build_argparser().parse_args([
                        "--from-pt", path, "--device", "cuda",
                        "--config", os.path.join(repo_root, "configs",
                                                 "gmm_model_config.json"),
                        "--synthetic-size", str(n_seg), "--samples", "4",
                        "--eval-epochs", "1"])
                    zero_counts(*all_counts, cuda_decode.LAUNCHES)
                    t0 = time.monotonic()
                    r["table1"] = port_parity.run_table1_eval(kind, args)
                    torch.cuda.synchronize()
                    secs["table1"] = time.monotonic() - t0
                    eval_l = read_counts(*all_counts, cuda_decode.LAUNCHES)
                t0 = time.monotonic()
                r["tokens"] = port_parity.check_token_stream(tok_path, 0)
                secs["tokens"] = time.monotonic() - t0
            os.remove(path)
            res[kind] = {"pass": r, "seconds": secs, "max_abs_d": diffs,
                         "forward_launches": fwd_l}
            if kind == "gmm":
                res[kind]["table1_launches"] = eval_l
            if not all(r.values()):
                emit({"phase": "parity", "results": res})
                return fail(f"parity {kind}: {r}:\n{out.getvalue()[-3000:]}")
            want = {"stacked_gru", "decoder_teacher"} | (
                set() if kind == "cvae" else {"embed_gru"})
            if not want <= set(fwd_l):
                return fail(f"parity {kind}: section 2 launched {fwd_l}, "
                            f"not all of {sorted(want)}")
            if kind == "gmm" and not {"embed_gru", "greedy_decode"} <= set(
                    eval_l):
                return fail(f"parity gmm: the eval launched {eval_l}")
        emit({"phase": "parity", "tol": 1e-4, "token_rows": len(rows),
              "token_checks": guard.checked, "results": res})
        if guard.bad:
            return fail(f"decode kernel tokens out of range: {guard.bad}")
        return 0

    repo_root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as tmp:
        rc = parity_phase(tmp)
    if rc:
        return rc

    # ----------------------------------------------------------- native
    # The port's native tokenizer (`native/fadertok.cc`, built with g++ at
    # its first use in this process) against its pure-Python path on a
    # synthetic corpus: 512 note lists encoded, their tokens decoded, 128
    # pianorolls encoded to events; every output equal, and the host ms of
    # both paths on this machine's CPU.
    from music_fader_nets_tpu_torch import native
    from music_fader_nets_tpu_torch.tokenizer import (
        event_codec, performance_codec,
    )
    note_lists = []
    for _ in range(512):
        t = np.cumsum(rng.random(64) * 0.3)
        note_lists.append([MidiNote(int(rng.integers(21, 109)),
                                    int(rng.integers(1, 128)), float(s),
                                    float(s + rng.random() * 1.5 + 0.01))
                           for s in t])
    rolls = []
    for _ in range(128):
        pr = np.zeros((64, 128), np.int64)
        for t in range(64):
            for pitch in rng.choice(np.arange(1, 128),
                                    size=rng.integers(0, 5), replace=False):
                pr[t: t + int(rng.integers(1, 4)), pitch] = int(
                    rng.integers(1, 128))
        rolls.append(pr)
    t0 = time.monotonic()
    native.fadertok()
    load_s = time.monotonic() - t0

    def codec_run():
        """(outputs, host ms of each part, the paths that served)."""
        paths, ms, outs = set(), {}, {}
        t0 = time.perf_counter()
        outs["tokens"] = [performance_codec.performance_encode(n, True)
                          for n in note_lists]
        paths.add(native.PATH)
        ms["encode"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        outs["notes"] = [[(n.pitch, n.velocity, n.start, n.end)
                          for n in performance_codec.performance_decode(t)]
                         for t in outs["tokens"]]
        paths.add(native.PATH)
        ms["decode"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        outs["events"] = [event_codec.encode_pianoroll(pr)[0] for pr in rolls]
        paths.add(native.PATH)
        ms["pianoroll_events"] = (time.perf_counter() - t0) * 1e3
        return outs, ms, sorted(paths)

    was = native.HAVE_NATIVE
    try:
        native.HAVE_NATIVE = True
        n_out, n_ms, n_paths = codec_run()
        native.HAVE_NATIVE = False
        p_out, p_ms, p_paths = codec_run()
    finally:
        native.HAVE_NATIVE = was
    same = {k: n_out[k] == p_out[k] for k in n_out}
    with open("/proc/cpuinfo") as f:
        cpu_model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")),
                         platform.processor() or platform.machine())
    emit({"phase": "native", "paths": {"native": n_paths,
                                       "python": p_paths},
          "bit_identical": same, "build_seconds": native.BUILD_SECONDS,
          "load_seconds": load_s, "module": native.fadertok().__file__,
          "note_lists": len(note_lists), "pianorolls": len(rolls),
          "tokens": sum(len(t) for t in n_out["tokens"]),
          "native_ms": n_ms, "python_ms": p_ms,
          "host": {"cpu": cpu_model, "cpu_count": os.cpu_count()}})
    if not (n_paths == ["native"] and p_paths == ["python"]
            and all(same.values())):
        return fail(f"native tokenizer: paths {n_paths} / {p_paths}, "
                    f"identical {same}")

    # ------------------------------------------------------------ entry
    # The port's graft entry (`music_fader_nets_tpu_torch.entry.entry()`):
    # the GM-VAE forward + gmm_loss at full width, B=8, on this card (the
    # token encoder, the class-embedded sub-decoders and the decoder with
    # its CE head: kernels 3, 5 and 9, counted from zero), held against
    # the plain path on the same card: the loss and every metric within
    # 1e-4 of max(1, |plain value|).
    from music_fader_nets_tpu_torch.entry import entry as port_entry
    zero_counts(*all_counts, cuda_decode.LAUNCHES)
    e_fn, e_args = port_entry()
    with torch.no_grad():
        e_loss, e_metrics = e_fn(*e_args)
        torch.cuda.synchronize()
        e_launches = read_counts(*all_counts, cuda_decode.LAUNCHES)
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            ep_loss, ep_metrics = e_fn(*e_args)

        def host_ms(f, reps):
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        e_ms = host_ms(lambda: e_fn(*e_args), 5)
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            ep_ms = host_ms(lambda: e_fn(*e_args), 2)
    e_err = {k: abs(float(e_metrics[k]) - float(v)) / max(1.0, abs(float(v)))
             for k, v in ep_metrics.items()}
    emit({"phase": "entry", "B": int(e_args[2]["x"].shape[0]),
          "loss": float(e_loss), "plain_loss": float(ep_loss),
          "rel_err": e_err, "tol": 1e-4, "launches": e_launches,
          "ms": e_ms, "plain_ms": ep_ms})
    if not (np.isfinite(float(e_loss)) and max(e_err.values()) <= 1e-4):
        return fail(f"entry: kernel vs plain {e_err}")
    if not {"embed_gru", "embed_seq", "decoder_ce"} <= set(e_launches):
        return fail(f"entry: launches {e_launches}")

    # ---------------------------------------------------- data parallel
    # The GM-VAE Trainer on a data-parallel mesh (parallel/, the port's
    # counterpart of the JAX mesh and its six `_dp` wrappers): (a) world
    # size 1 over NCCL in this process, params bit-equal to the Trainer
    # without a mesh; (b) two ranks sharing this card over gloo (NCCL
    # refuses two ranks on one device), 64 + 64 rows (16 + 16 supervised)
    # against one process at 128 (32): first-step loss within 1e-5
    # relative and gradients within 1e-4 of each tensor's largest entry,
    # params bit-equal across ranks; (c) two ranks over NCCL when there
    # are two cards. Each run's training-kernel counts are set to 0 just
    # before its steps and read just after.
    import torch.distributed as dist
    from music_fader_nets_tpu_torch.parallel.launch import (
        init_from_env, run_ranks,
    )
    from music_fader_nets_tpu_torch.parallel.mesh import make_mesh
    t_dp = time.monotonic()
    dp_ref = dp_drive(None)
    init_from_env("cuda")               # no torchrun: a world of one
    try:
        dp_a = dp_drive(make_mesh(1, 1))
    finally:
        dist.destroy_process_group()

    def dp_compare(run):
        """First-step loss (relative) and gradient (relative to each
        tensor's largest entry) errors of a run against the reference."""
        errs = {}
        for name, want in dp_ref["first"].items():
            got = run["first"][name]
            lo = want["metrics"]["loss"]
            errs[name] = {
                "loss_rel_err": abs(got["metrics"]["loss"] - lo) / abs(lo),
                "grad_max_rel_err": grad_errors(got["grads"],
                                                want["grads"])[1]}
        return errs

    def dp_equal(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    dp_kernels = ("embed_gru_train", "embed_gru_bwd", "embed_seq",
                  "embed_seq_bwd", "decoder_ce", "decoder_ce_bwd")
    a_line = {"backend": dp_a["backend"], "device": dp_a["device"],
              "params_equal_no_mesh": dp_equal(dp_a["params"],
                                               dp_ref["params"]),
              "train_path": dp_a["train_path"], "launches": dp_a["launches"],
              "ms_per_step": dp_a["ms_per_step"],
              "no_mesh_ms_per_step": dp_ref["ms_per_step"],
              "allreduce_ms": dp_a["allreduce_ms"],
              "allreduce_bytes": dp_a["allreduce_bytes"]}
    dp_b = run_ranks(dp_rank, 2, args=("cuda:0",), device="cuda:0",
                     timeout=600.0)
    b_line = {"ranks": 2, "backend": [r["backend"] for r in dp_b],
              "devices": [r["device"] for r in dp_b],
              "rows_per_rank": {"unsupervised": TB // 2, "supervised": 16},
              "first_step": dp_compare(dp_b[0]),
              "params_equal_across_ranks": dp_equal(dp_b[0]["params"],
                                                    dp_b[1]["params"]),
              "train_path": [r["train_path"] for r in dp_b],
              "launches": [r["launches"] for r in dp_b],
              "ms_per_step": [r["ms_per_step"] for r in dp_b],
              "allreduce_ms": [r["allreduce_ms"] for r in dp_b],
              "allreduce_bytes": dp_b[0]["allreduce_bytes"]}
    if torch.cuda.device_count() >= 2:
        dp_c = run_ranks(dp_rank, 2, args=("cuda",), device="cuda",
                         timeout=600.0)
        c_line = {"backend": [r["backend"] for r in dp_c],
                  "devices": [r["device"] for r in dp_c],
                  "first_step": dp_compare(dp_c[0]),
                  "params_equal_across_ranks": dp_equal(
                      dp_c[0]["params"], dp_c[1]["params"]),
                  "ms_per_step": [r["ms_per_step"] for r in dp_c],
                  "allreduce_ms": [r["allreduce_ms"] for r in dp_c]}
        dp_runs = dp_b + dp_c
    else:
        c_line, dp_c = "not run: 1 device", []
        dp_runs = dp_b
    emit({"phase": "data_parallel", "B": TB, "supervised_B": 32,
          "steps_per_branch": DP_STEPS, "tol_loss_rel": 1e-5,
          "tol_grad_rel": TOL_TRAIN_GRAD_REL, "world_1_nccl": a_line,
          "gloo_two_ranks_one_card": b_line, "nccl_two_rank": c_line,
          "seconds": time.monotonic() - t_dp})
    if not (a_line["params_equal_no_mesh"] and a_line["backend"] == "nccl"):
        return fail(f"data_parallel (a): {a_line}")
    for run in [dp_a] + dp_runs:
        if run["train_path"] != "kernel" or not all(
                run["launches"].get(k, 0) > 0 for k in dp_kernels):
            return fail(f"data_parallel: path {run['train_path']}, "
                        f"launches {run['launches']}")
        if not all(np.isfinite(v) for m in run["epochs"].values()
                   for v in m.values()):
            return fail(f"data_parallel: a loss is not finite "
                        f"{run['epochs']}")
    for line in [b_line] + ([c_line] if dp_c else []):
        worst = line["first_step"]
        if not (line["params_equal_across_ranks"] and all(
                e["loss_rel_err"] <= 1e-5
                and e["grad_max_rel_err"] <= TOL_TRAIN_GRAD_REL
                for e in worst.values())):
            return fail(f"data_parallel: {line}")

    # -------------------------------------------------- tensor parallel
    # The GM-VAE Trainer on a mesh with a model axis: each rank stores,
    # and steps Adam on, its half of the GRU leaves along 3H, and the model
    # group gathers the halves before each forward (one all-reduce of a
    # zeroed buffer); the kernels run unchanged on the whole weights.
    # (a) two ranks sharing this card over gloo on a 1 x 2 mesh, each
    # feeding all 128 (32) rows, against one process (`dp_ref` above):
    # first-step loss within 1e-5 relative and gradients within 1e-4 of
    # each tensor's largest entry, the params after DP_STEPS steps of each
    # branch within 2e-5 (the sub-decoders' output biases, whose gradient
    # is float32 noise, within 2 * lr a step), whether each is bit-equal
    # (expected: nothing is summed in another order), the params bit-equal
    # across the ranks, every training kernel launched on each rank
    # (counts set to 0 just before the steps, read just after), each
    # rank's Adam bytes against one process's, ms a step a rank, the
    # gather's ms and bytes; (c) two ranks over NCCL when there are two
    # cards.
    t_tp = time.monotonic()
    tp_a = run_ranks(dp_rank, 2, args=("cuda:0", 2), device="cuda:0",
                     timeout=600.0)
    n_steps = 2 * DP_STEPS

    def tp_line(runs):
        ref = dp_ref
        first_equal = all(
            r["first"][b]["metrics"]["loss"] == ref["first"][b]["metrics"][
                "loss"] and dp_equal(r["first"][b]["grads"],
                                     ref["first"][b]["grads"])
            for r in runs for b in ref["first"])
        p_err, p_worst = 0.0, None
        for name, got, want in zip(ref["param_names"], runs[0]["params"],
                                   ref["params"]):
            err = float((got - want).abs().max()) if got.numel() else 0.0
            bound = (2 * 1e-3 * n_steps if name in NOISE_ONLY_PARAMS
                     else 2e-5)
            if err > bound and (p_worst is None or err > p_worst[1]):
                p_worst = (name, err)
            if name not in NOISE_ONLY_PARAMS:
                p_err = max(p_err, err)
        return {
            "ranks": 2, "mesh": "1x2",
            "backend": [r["backend"] for r in runs],
            "devices": [r["device"] for r in runs],
            "first_step": dp_compare(runs[0]),
            "first_step_bit_equal_to_one_process": first_equal,
            "first_step_grads_equal_across_ranks": all(
                dp_equal(runs[0]["first"][b]["grads"],
                         runs[1]["first"][b]["grads"])
                for b in ref["first"]),
            "params_bit_equal_to_one_process": all(
                dp_equal(r["params"], ref["params"]) for r in runs),
            "params_max_abs_err": p_err,
            "params_over_bound": p_worst,
            "params_equal_across_ranks": dp_equal(runs[0]["params"],
                                                  runs[1]["params"]),
            "train_path": [r["train_path"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "adam_bytes_per_rank": [r["adam_bytes"] for r in runs],
            "adam_bytes_one_process": ref["adam_bytes"],
            "adam_share": runs[0]["adam_bytes"] / ref["adam_bytes"],
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "one_process_ms_per_step": ref["ms_per_step"],
            "gather_ms": [r["gather_ms"] for r in runs],
            "gather_bytes": runs[0]["gather_bytes"],
            "sharded_bytes": runs[0]["sharded_bytes"],
            "allreduce_ms": [r["allreduce_ms"] for r in runs]}

    tp_a_line = tp_line(tp_a)
    if torch.cuda.device_count() >= 2:
        tp_c = run_ranks(dp_rank, 2, args=("cuda", 2), device="cuda",
                         timeout=600.0)
        tp_c_line = tp_line(tp_c)
    else:
        tp_c_line, tp_c = "not run: 1 device", []
    emit({"phase": "tensor_parallel", "B": TB, "supervised_B": 32,
          "steps_per_branch": DP_STEPS, "tol_loss_rel": 1e-5,
          "tol_grad_rel": TOL_TRAIN_GRAD_REL, "tol_params_abs": 2e-5,
          "gloo_two_ranks_one_card": tp_a_line, "nccl_two_rank": tp_c_line,
          "seconds": time.monotonic() - t_tp})
    for run in tp_a + tp_c:
        if run["train_path"] != "kernel" or not all(
                run["launches"].get(k, 0) > 0 for k in dp_kernels):
            return fail(f"tensor_parallel: path {run['train_path']}, "
                        f"launches {run['launches']}")
        if not all(np.isfinite(v) for m in run["epochs"].values()
                   for v in m.values()):
            return fail(f"tensor_parallel: a loss is not finite "
                        f"{run['epochs']}")
    for line in [tp_a_line] + ([tp_c_line] if tp_c else []):
        if not (line["params_equal_across_ranks"]
                and line["params_over_bound"] is None
                and line["adam_share"] < 1.0
                and all(e["loss_rel_err"] <= 1e-5
                        and e["grad_max_rel_err"] <= TOL_TRAIN_GRAD_REL
                        for e in line["first_step"].values())):
            return fail(f"tensor_parallel: {line}")

    # ------------------------------------------------ dryrun_multichip
    # `entry.dryrun_multichip(2)` as a user calls it, on the card: two
    # ranks placed by `launch.placement` (sharing this card over gloo, or
    # a card each over NCCL), one step of each GM-VAE branch at the JAX
    # dryrun's shapes (H=64, z=16, T=24, B=2 n_data) on its 1 x 2 mesh,
    # then on its 2 x 1 mesh. It raises unless on each mesh every rank's
    # losses are finite and equal; each rank must have trained on a card,
    # through the kernels, on both meshes.
    from music_fader_nets_tpu_torch.entry import dryrun_multichip
    t_dry = time.monotonic()
    dry = dryrun_multichip(2)
    emit({"phase": "dryrun_multichip", "ranks": 2,
          "devices": [r["device"] for r in dry],
          "meshes": [{"mesh": m["mesh"], "losses": m["losses"],
                      "train_path": [r["meshes"][i]["train_path"]
                                     for r in dry]}
                     for i, m in enumerate(dry[0]["meshes"])],
          "seconds": time.monotonic() - t_dry})
    if [m["mesh"] for m in dry[0]["meshes"]] != [
            {"data": 1, "model": 2}, {"data": 2, "model": 1}] or any(
            not r["device"].startswith("cuda")
            or any(m["train_path"] != "kernel" for m in r["meshes"])
            for r in dry):
        return fail(f"dryrun_multichip: {dry}")

    # -------------------------------------------------- mixed precision
    # ModelConfig(dtype="bfloat16") at full width (H=512, z=128, T=100,
    # attr_len=16), random weights from seed 0: (a) each bf16 instantiation
    # (rows 3 finals, 3t/4, 5/6, 1/2 at the CVAE encoder's shape, 9/10 CE)
    # against the bf16 plain version on this card, output and every
    # gradient, two calls bit-equal, timed beside its plain version and,
    # where one exists, cuDNN's bf16 GRU; (b) the GM-VAE `gmm_loss` first
    # step (unsupervised B=128, supervised B=32) on the kernels against
    # the plain path, then 3 + 3 steps with the counts set to 0 just
    # before (every bf16 row of the path must launch; master params and
    # Adam moments float32; train_path "kernel"), and the ms a step of a
    # bf16 and a float32 Trainer in turns (f32, bf16, bf16, f32); (c) the
    # first step of vanilla, CVAE (rows 1/2), FaderNets and SingleVAE in
    # bf16, kernel against plain; (d) GLSR at step 21 under the bf16
    # config bit-equal to the float32 config; (e) the training CLI with
    # --dtype bfloat16 for one epoch with its validation pass (row 3's
    # finals in bf16), then save -> restore bit-exact, float32 tensors.
    BF = torch.bfloat16
    mp_cfg = ModelConfig(dtype="bfloat16")
    # the float32 forward entries keep the bits of the build before the
    # bf16 chain's redesign
    f32_bits = f32_forward_sha1(dev)
    emit({"phase": "mixed_precision", "part": "f32_forward_bits",
          "sha1": f32_bits,
          "equal": {k: f32_bits.get(k) == v for k, v in
                    F32_FWD_SHA1.items()}})
    if f32_bits != F32_FWD_SHA1:
        return fail(f"mixed_precision f32_forward_bits: {f32_bits}")
    mp_src = {"fwd": csrc + "gru_fwd_chain.cu", "bwd": csrc +
              "embed_gru_bwd.cu"}
    mp_launches = {}

    def mp_bound(flops, nbytes_):
        """max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s dense bf16): the
        least time for bf16 operands with float32 accumulation."""
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes_ / PEAK_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def mp_kernel(phase, names, srcs, replaces, fn, plain, ids, floats, cot,
                  shape, flops, lib=None):
        """One bf16 kernel pair against its bf16 plain version (see
        train_kernel_phase): values to MP_TOL_OUT, gradients to
        MP_TOL_GRAD_REL of each tensor's largest entry, two calls of the
        forward and of the backward bit-equal; timed in turns with the
        float32 kernels on the same inputs widened (bf16, float32, float32,
        bf16)."""
        ts, out, grads = fwd_bwd(fn, ids, floats, cot)
        _, out_p, grads_p = fwd_bwd(plain, ids, floats, cot)
        again = fn(ids, *ts)
        grads_2 = torch.autograd.grad(out, ts, cot, retain_graph=True)
        torch.cuda.synchronize()
        same = torch.equal(out, again) and all(
            torch.equal(a, b) for a, b in zip(grads, grads_2))
        dtypes = sorted({str(g.dtype) for g in grads} | {str(out.dtype)})
        out_err = float((out.float() - out_p.float()).abs().max())
        g_abs, g_rel = grad_errors([g.float() for g in grads],
                                   [g.float() for g in grads_p])
        k_f, k_b = time_fwd_bwd(fn, ids, ts, cot, 10)
        ts32 = [t.detach().float().requires_grad_(True) for t in floats]
        cot32 = cot.float()
        turns = [("bfloat16", k_f, k_b)]
        for dt_, ts_, cot_ in (("float32", ts32, cot32),
                               ("float32", ts32, cot32),
                               ("bfloat16", ts, cot)):
            turns.append((dt_,) + time_fwd_bwd(fn, ids, ts_, cot_, 10))
        del ts32
        p_ts = [t.detach().clone().requires_grad_(True) for t in floats]
        p_f, p_b = time_fwd_bwd(plain, ids, p_ts, cot, 3, warm=1)
        l_f = l_b = None
        if lib is not None:
            lib_fn, lib_leaves, lib_cot = lib
            l_f = time_ms(lib_fn, 10)
            lib_out = lib_fn()
            l_b = time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, lib_cot, retain_graph=True), 10)
        in_bytes = nbytes(ids, *floats)
        f_bound, f_by = mp_bound(flops[0], in_bytes + nbytes(out))
        b_bound, b_by = mp_bound(flops[1], in_bytes + nbytes(cot, *grads))
        emit({"phase": "mixed_precision", "part": phase, "shape": shape,
              "dtypes": dtypes, "out_max_abs_err": out_err,
              "tol_out": MP_TOL_OUT, "grad_max_abs_err": g_abs,
              "grad_max_rel_err": g_rel, "tol_grad_rel": MP_TOL_GRAD_REL,
              "fwd_ms": k_f, "bwd_ms": k_b, "plain_fwd_ms": p_f,
              "plain_bwd_ms": p_b, "library_fwd_ms": l_f,
              "library_bwd_ms": l_b, "bound_fwd_ms": f_bound,
              "bound_bwd_ms": b_bound, "determinism": same,
              "in_turns_with_float32": [
                  {"dtype": d_, "fwd_ms": f_, "bwd_ms": b_}
                  for d_, f_, b_ in turns]})
        if dtypes != ["torch.bfloat16"] and not (
                names[0] == "decoder_ce_bf16"
                and dtypes == ["torch.bfloat16", "torch.float32"]):
            return fail(f"mixed_precision {phase}: dtypes {dtypes}")
        if not (out_err <= MP_TOL_OUT and g_rel <= MP_TOL_GRAD_REL):
            return fail(f"mixed_precision {phase}: kernel vs plain output "
                        f"{out_err}, gradients {g_rel} (relative)")
        if not same:
            return fail(f"mixed_precision {phase}: two calls differ in a "
                        "bit")
        for nm, src, rep, err, ms_, pms, lms, bd, by in (
                (names[0], srcs[0], replaces[0], out_err, k_f, p_f, l_f,
                 f_bound, f_by),
                (names[1], srcs[1], replaces[1], g_abs, k_b, p_b, l_b,
                 b_bound, b_by)):
            kernels[nm] = {
                "name": nm, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": err, "ms": ms_,
                "plain_ms": pms, "bound_ms": bd, "bound_by": by,
                "library_ms": lms}
        return 0

    def bf(*ts):
        return [t.to(dev, BF) for t in ts]

    # (a) rows 3t/4: the encoder, L=4, T=100, B=128, Vp=384
    mp_dirs = [gru_init(gen, V, H) for _ in range(L)]
    e_w = bf(*stack_directions(mp_dirs))
    e_tok = direction_tokens(torch.from_numpy(
        rng.integers(0, V, size=(TB, T)).astype(np.int32)).to(dev),
        [False, True, False, True])
    e_h0 = torch.zeros((L, TB, H), device=dev, dtype=BF)
    e_cot = torch.randn((L, TB, H), generator=gen).to(dev, BF)
    e_grus = []
    for s_ in range(2):
        g_ = torch.nn.GRU(V, H, batch_first=True,
                          bidirectional=True).to(dev)
        with torch.no_grad():
            for d, suf in ((2 * s_, ""), (2 * s_ + 1, "_reverse")):
                getattr(g_, "weight_ih_l0" + suf).copy_(e_w[0][d, :V].t())
                getattr(g_, "weight_hh_l0" + suf).copy_(e_w[2][d].t())
                getattr(g_, "bias_ih_l0" + suf).copy_(e_w[1][d])
                getattr(g_, "bias_hh_l0" + suf).copy_(e_w[3][d])
        e_grus.append(g_.to(BF))
    e_x = torch.nn.functional.one_hot(
        e_tok[0].t().long(), V).to(BF)            # direction 0's tokens
    e_h0_lib = e_h0.clone().requires_grad_(True)

    def cudnn_enc_bf16():
        return torch.cat([g_(e_x, e_h0_lib[2 * i:2 * i + 2])[1]
                          for i, g_ in enumerate(e_grus)])

    # cuDNN's GRU in bf16 is the yardstick where this build runs it
    try:
        cudnn_enc_bf16()
        e_lib = (cudnn_enc_bf16, [p_ for g_ in e_grus
                                  for p_ in g_.parameters()] + [e_h0_lib],
                 e_cot)
        lib_note = "cuDNN bf16 nn.GRU"
    except RuntimeError as e:
        e_lib, lib_note = None, f"no bf16 cuDNN GRU: {e}"[:200]
    emit({"phase": "mixed_precision", "part": "library", "note": lib_note})
    e_f = 2.0 * L * T * TB * H * G
    rc = mp_kernel(
        "encoder", ("embed_gru_train_bf16", "embed_gru_bwd_bf16"),
        (mp_src["fwd"], mp_src["bwd"]), (pg + "428", pg + "536"),
        cuda_gru.stacked_gru_embed_finals,
        cuda_gru.stacked_gru_embed_finals_plain, e_tok,
        [*e_w, e_h0], e_cot, {"L": L, "T": T, "B": TB, "H": H, "Vp": Vp},
        (e_f, 2 * e_f), lib=e_lib)
    if rc:
        return rc
    # row 3, finals (the validation pass's variant): no gradient, B=128
    with torch.no_grad():
        fin_k = cuda_gru.stacked_gru_embed_finals(e_tok, *e_w, e_h0)
        fin_p = cuda_gru.stacked_gru_embed_finals_plain(e_tok, *e_w, e_h0)
        fin_again = cuda_gru.stacked_gru_embed_finals(e_tok, *e_w, e_h0)
        torch.cuda.synchronize()
        fin_err = float((fin_k.float() - fin_p.float()).abs().max())
        fin_ms = time_ms(lambda: cuda_gru.stacked_gru_embed_finals(
            e_tok, *e_w, e_h0), 10)
        fin_pms = time_ms(lambda: cuda_gru.stacked_gru_embed_finals_plain(
            e_tok, *e_w, e_h0), 3, warm=1)
        fin_lms = time_ms(cudnn_enc_bf16, 10) if e_lib else None
    fin_bound, fin_by = mp_bound(e_f, nbytes(e_tok, *e_w, e_h0, fin_k))
    kernels["embed_gru_bf16"] = {
        "name": "embed_gru_bf16", "route": "cuda", "source": mp_src["fwd"],
        "replaces": pg + "428", "max_abs_err": fin_err, "ms": fin_ms,
        "plain_ms": fin_pms, "bound_ms": fin_bound, "bound_by": fin_by,
        "library_ms": fin_lms}
    emit({"phase": "mixed_precision", "part": "encoder_finals",
          "dtype": str(fin_k.dtype), "out_max_abs_err": fin_err,
          "tol_out": MP_TOL_OUT, "ms": fin_ms, "plain_ms": fin_pms,
          "library_ms": fin_lms, "bound_ms": fin_bound,
          "determinism": torch.equal(fin_k, fin_again)})
    if fin_k.dtype != BF or fin_err > MP_TOL_OUT or not torch.equal(
            fin_k, fin_again):
        return fail(f"mixed_precision encoder_finals: {fin_err}")
    del e_grus, e_x, fin_k, fin_p, fin_again

    # rows 5/6: the sub-decoders, L=2, T=16, B=128, 16 class rows
    A_, C_ = cfg.attr_len, max(cfg.rhythm_dims, cfg.note_dims)
    sd = [gru_init(gen, C_ + Z, H) for _ in range(2)]
    s_emb, s_z, s_bih, s_whh, s_bhh = bf(
        torch.stack([p_["w_ih"][:C_] for p_ in sd]),
        torch.stack([p_["w_ih"][C_:] for p_ in sd]),
        torch.stack([p_["b_ih"] for p_ in sd]),
        torch.stack([p_["w_hh"] for p_ in sd]),
        torch.stack([p_["b_hh"] for p_ in sd]))
    s_zs = torch.randn((2, TB, Z), generator=gen).to(dev, BF)
    s_prez = torch.bmm(s_zs, s_z) + s_bih[:, None, :]
    s_h0_ = (torch.randn((2, TB, H), generator=gen) * 0.5).to(dev, BF)
    s_w = [s_emb, s_prez, s_whh, s_bhh, s_h0_]
    s_cls = torch.from_numpy(np.stack([
        rng.integers(0, cfg.rhythm_dims, (A_, TB)),
        rng.integers(0, cfg.note_dims, (A_, TB))]).astype(np.int32)).to(dev)
    s_cot_ = torch.randn((2, A_, TB, H), generator=gen).to(dev, BF)
    s_lib = []
    for i in range(2):
        g_ = torch.nn.GRU(C_ + Z, H, batch_first=True).to(dev, BF)
        with torch.no_grad():
            g_.weight_ih_l0.copy_(torch.cat([s_emb[i], s_z[i]]).t())
            g_.weight_hh_l0.copy_(s_whh[i].t())
            g_.bias_ih_l0.copy_(s_bih[i])
            g_.bias_hh_l0.copy_(s_bhh[i])
        s_lib.append(g_)
    s_x = [torch.cat([torch.nn.functional.one_hot(
        s_cls[i].t().long(), C_).to(BF),
        s_zs[i][:, None, :].expand(TB, A_, Z)], dim=-1) for i in range(2)]
    s_h0_lib = s_h0_.clone().requires_grad_(True)

    def cudnn_sub_bf16():
        return torch.stack([g_(s_x[i], s_h0_lib[i:i + 1])[0].transpose(
            0, 1) for i, g_ in enumerate(s_lib)])

    s_f = 2.0 * 2 * A_ * TB * H * G
    rc = mp_kernel(
        "subdecoders", ("embed_seq_bf16", "embed_seq_bwd_bf16"),
        (mp_src["fwd"], mp_src["bwd"]), (pg + "779", pg + "888"),
        cuda_gru.stacked_gru_embed_seq, cuda_gru.stacked_gru_embed_seq_plain,
        s_cls, s_w, s_cot_, {"L": 2, "T": A_, "B": TB, "H": H, "C": C_},
        (s_f, 2 * s_f), lib=e_lib and (
            cudnn_sub_bf16, [p_ for g_ in s_lib for p_ in g_.parameters()]
            + [s_h0_lib], s_cot_))
    if rc:
        return rc
    del s_lib, s_x

    # rows 1/2: the CVAE encoder's stacked GRU, L=2, T=100, B=128, I=344
    c_dirs = [gru_init(gen, V + 2, H) for _ in range(2)]
    c_wih, c_bih, c_whh, c_bhh = bf(*stack_directions(c_dirs))
    c_x = torch.cat([torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, V, size=(TB, T))).long(), V).float(),
        torch.rand((TB, 1, 2), generator=gen).expand(TB, T, 2)],
        dim=-1).to(dev, BF)
    c_dir = torch.stack([c_x, c_x.flip(1)])
    c_pre = (torch.einsum("lbti,lig->ltbg", c_dir, c_wih[:, :V + 2])
             + c_bih[:, None, None, :])
    c_h0 = torch.zeros((2, TB, H), device=dev, dtype=BF)
    c_cot = torch.randn((2, T, TB, H), generator=gen).to(dev, BF)
    c_f = 2.0 * 2 * T * TB * H * G
    # cuDNN's bidirectional bf16 GRU over x_in, its input projection
    # included (the f32 row's yardstick)
    c_gru = torch.nn.GRU(V + 2, H, batch_first=True,
                         bidirectional=True).to(dev, BF)
    with torch.no_grad():
        for d, suf in ((0, ""), (1, "_reverse")):
            getattr(c_gru, "weight_ih_l0" + suf).copy_(c_wih[d, :V + 2].t())
            getattr(c_gru, "weight_hh_l0" + suf).copy_(c_whh[d].t())
            getattr(c_gru, "bias_ih_l0" + suf).copy_(c_bih[d])
            getattr(c_gru, "bias_hh_l0" + suf).copy_(c_bhh[d])
    c_cot_lib = torch.randn((TB, T, 2 * H), generator=gen).to(dev, BF)

    def cudnn_stacked_bf16():
        return c_gru(c_x)[0]

    def stacked(_ids, *fl):
        return cuda_stacked.stacked_gru(*fl)

    def stacked_plain(_ids, *fl):
        return cuda_stacked.stacked_gru_plain(*fl)

    rc = mp_kernel(
        "stacked_gru", ("stacked_gru_bf16", "stacked_gru_bwd_bf16"),
        (csrc + "stacked_gru.cu", csrc + "stacked_gru.cu"),
        (pg + "147", pg + "238"), stacked, stacked_plain,
        torch.empty(0, device=dev), [c_pre, c_whh, c_bhh, c_h0], c_cot,
        {"L": 2, "T": T, "B": TB, "H": H, "I": V + 2}, (c_f, 2 * c_f),
        lib=e_lib and (cudnn_stacked_bf16, list(c_gru.parameters()),
                       c_cot_lib))
    if rc:
        return rc
    del c_x, c_dir, c_pre, c_gru

    # rows 9/10 CE: the teacher decode with the CE head, T=100, B=128
    gd = global_decoder_init(gen, 2 * Z + cfg.chroma_dims, V, H)
    gd = tree_map(lambda t: t.to(dev, BF), gd)
    d_z = torch.randn((TB, 2 * Z + cfg.chroma_dims), generator=gen).to(
        dev, BF)
    d_tokens = torch.from_numpy(
        rng.integers(0, V, size=(TB, T)).astype(np.int32)).to(dev)
    d_tok_t, d_w = cuda_decoder._fused_args(gd, d_z, d_tokens, V)
    d_tgt = d_tokens.t().contiguous()
    d_cot = torch.randn((T, TB), generator=gen).to(dev)
    d_f = 2.0 * T * TB * (3 * H * G + H * Vp)

    def dec(ids, *fl):
        return cuda_decoder.decoder_teacher_nll(ids, d_tgt, *fl)

    def dec_plain(ids, *fl):
        return cuda_decoder.decoder_teacher_nll_plain(ids, d_tgt, *fl)

    rc = mp_kernel(
        "decoder_ce", ("decoder_ce_bf16", "decoder_ce_bwd_bf16"),
        (csrc + "decoder_ce.cu", csrc + "decoder_ce_bwd.cu"),
        (pg + "1482", pg + "1627"), dec, dec_plain, d_tok_t,
        [t.contiguous() for t in d_w], d_cot,
        {"T": T, "B": TB, "H": H, "Vp": Vp}, (d_f, 2 * d_f))
    if rc:
        return rc
    del gd, d_w

    # ragged bf16 backward: rows 2, 4, 6 and 10 at B = 37 (no multiple of
    # the MMA tiles' 16 rows), T odd, T*B no multiple of the GEMMs'
    # 128-row tile, H = 136 (a partial 32-unit column tile) and H = 30 (no
    # multiple of 8: the GEMMs' element-load paths), against their bf16
    # plain versions, two backward calls bit-equal
    mr_gen = torch.Generator().manual_seed(SEED + 15)

    def mr_rand(shape, scale):
        return (torch.randn(shape, generator=mr_gen) * scale).to(dev, BF)

    def tuple_of(out):
        return out if isinstance(out, tuple) else (out,)

    def bf16_train_fwd_plain(ids, w_in, add, w_hh, b_hh, h0):
        """The bf16 training forward's h_seq and gate stash by the plain
        float32 chain (`cuda_gru.chain_fwd32`), rounded to bf16 where the
        kernel stores them."""
        h_seq, stash = cuda_gru.chain_fwd32(
            cuda_gru._table_xpre(ids, w_in.float(), add.float(),
                                 add.dim() == 3),
            w_hh.float(), b_hh.float(), h0.float(), ids.shape[1])
        return h_seq.to(BF), stash.to(BF)

    ragged_bf16, ragged_fwd = {}, {}
    for mT, mB, mH in ((21, 37, 136), (9, 37, 30)):
        mG = 3 * mH
        m_w = bf(*stack_directions([gru_init(mr_gen, V, mH)
                                    for _ in range(2)]))
        m_h0 = mr_rand((2, mB, mH), 0.5)
        m_tok = direction_tokens(torch.randint(
            0, V, (mB, mT), generator=mr_gen).to(dev), [False, True])
        m_cls = torch.randint(0, 16, (2, mT, mB), generator=mr_gen,
                              dtype=torch.int32).to(dev)
        m_tgt = torch.randint(0, V, (mT, mB), generator=mr_gen,
                              dtype=torch.int32).to(dev)
        m_dtok = torch.cat([torch.full((1, mB), V - 1, dtype=torch.int32,
                                       device=dev), m_tgt[:-1]])
        m_dec = [mr_rand((Vp, mG), 0.05), mr_rand((mB, mG), 0.5)]
        for _ in range(3):
            m_dec += [mr_rand((mH, mG), 0.05), mr_rand((mG,), 0.05)]
        m_dec += [mr_rand((mB, mH), 0.5),
                  torch.nn.functional.pad(mr_rand((mH, V), 0.05),
                                          (0, Vp - V)),
                  torch.nn.functional.pad(
                      mr_rand((V,), 0.05), (0, Vp - V),
                      value=cuda_decoder.PAD_LOGIT).to(BF)]
        cases = (
            ("stacked_gru_bwd_bf16", skip_ids(cuda_stacked.stacked_gru),
             skip_ids(cuda_stacked.stacked_gru_plain), no_ids,
             [mr_rand((2, mT, mB, mG), 0.5), m_w[2], m_w[3], m_h0],
             mr_rand((2, mT, mB, mH), 1.0)),
            ("embed_gru_bwd_bf16", cuda_gru.stacked_gru_embed_finals,
             cuda_gru.stacked_gru_embed_finals_plain, m_tok,
             [*m_w, m_h0], mr_rand((2, mB, mH), 1.0)),
            ("embed_seq_bwd_bf16", cuda_gru.stacked_gru_embed_seq,
             cuda_gru.stacked_gru_embed_seq_plain, m_cls,
             [mr_rand((2, 16, mG), 0.2), mr_rand((2, mB, mG), 0.2), m_w[2],
              m_w[3], m_h0], mr_rand((2, mT, mB, mH), 1.0)),
            ("decoder_ce_bwd_bf16",
             lambda ids, *fl: cuda_decoder.decoder_teacher_nll(
                 ids, m_tgt, *fl),
             lambda ids, *fl: cuda_decoder.decoder_teacher_nll_plain(
                 ids, m_tgt, *fl), m_dtok, m_dec,
             (torch.randn((mT, mB), generator=mr_gen) / (mT * mB)).to(dev)))
        for name, fn, plain, ids, floats, cot in cases:
            ts, m_out, m_grads = fwd_bwd(fn, ids, floats, cot)
            m_again = torch.autograd.grad(m_out, ts, cot)
            _, m_out_p, m_grads_p = fwd_bwd(plain, ids, floats, cot)
            torch.cuda.synchronize()
            m_abs, m_rel = grad_errors([g.float() for g in m_grads],
                                       [g.float() for g in m_grads_p])
            ragged_bf16[f"{name}@T{mT}_B{mB}_H{mH}"] = {
                "out_max_abs_err": float(
                    (m_out.float() - m_out_p.float()).detach().abs().max()),
                "grad_max_abs_err": m_abs, "grad_max_rel_err": m_rel,
                "determinism": all(torch.equal(a, b_)
                                   for a, b_ in zip(m_grads, m_again))}
        # the bf16 forward chain (its product on the tensor cores) at the
        # same shapes: every buffer each forward entry writes against its
        # bf16 plain version, two calls bit-equal
        m_pre = mr_rand((2, mT, mB, mG), 0.5)
        m_seq = [mr_rand((2, 16, mG), 0.2), mr_rand((2, mB, mG), 0.2),
                 m_w[2], m_w[3], m_h0]
        with torch.no_grad():
            fwd_cases = (
                ("stacked_gru_bf16",
                 lambda: cuda_stacked.stacked_gru(m_pre, *m_w[2:], m_h0),
                 lambda: cuda_stacked.stacked_gru_plain(m_pre, *m_w[2:],
                                                        m_h0)),
                ("embed_gru_bf16",
                 lambda: cuda_gru.stacked_gru_embed_finals(m_tok, *m_w,
                                                           m_h0),
                 lambda: cuda_gru.stacked_gru_embed_finals_plain(
                     m_tok, *m_w, m_h0)),
                ("embed_gru_train_bf16",
                 lambda: cuda_gru._launch_train_fwd(m_tok, *m_w, m_h0,
                                                    True),
                 lambda: bf16_train_fwd_plain(m_tok, *m_w, m_h0)),
                ("embed_seq_bf16",
                 lambda: cuda_gru._launch_train_fwd(m_cls, *m_seq, True),
                 lambda: bf16_train_fwd_plain(m_cls, *m_seq)),
                ("decoder_ce_bf16",
                 lambda: cuda_decoder.decoder_teacher_nll(m_dtok, m_tgt,
                                                          *m_dec),
                 lambda: cuda_decoder.decoder_teacher_nll_plain(
                     m_dtok, m_tgt, *m_dec)))
            for name, fn, plain in fwd_cases:
                outs, again, want = (tuple_of(f()) for f in (fn, fn, plain))
                torch.cuda.synchronize()
                ragged_fwd[f"{name}@T{mT}_B{mB}_H{mH}"] = {
                    "dtypes": sorted({str(o.dtype) for o in outs}),
                    "out_max_abs_err": max(
                        float((o.float() - w_.float()).abs().max())
                        for o, w_ in zip(outs, want)),
                    "determinism": all(torch.equal(a, b_)
                                       for a, b_ in zip(outs, again))}
    emit({"phase": "mixed_precision", "part": "ragged_backward",
          "tol_out": MP_TOL_OUT, "tol_grad_rel": MP_TOL_GRAD_REL,
          **ragged_bf16})
    for name, e in ragged_bf16.items():
        if not (e["out_max_abs_err"] <= MP_TOL_OUT
                and e["grad_max_rel_err"] <= MP_TOL_GRAD_REL
                and e["determinism"]):
            return fail(f"mixed_precision ragged_backward, {name}: {e}")
    emit({"phase": "mixed_precision", "part": "ragged_forward",
          "tol_out": MP_TOL_OUT, **ragged_fwd})
    for name, e in ragged_fwd.items():
        if not (e["out_max_abs_err"] <= MP_TOL_OUT and e["determinism"]):
            return fail(f"mixed_precision ragged_forward, {name}: {e}")
    del m_w, m_dec, cases, fwd_cases

    # (b) the GM-VAE in bf16: the first step against the plain path, then
    # 3 + 3 steps on the kernels
    gmm_losses = {"default": gmm_loss,
                  "supervised": functools.partial(gmm_loss,
                                                  is_supervised=True)}
    mtr = Trainer(mp_cfg, init_reg_gmvae, gmm_losses, seed=SEED,
                  device="cuda")
    m_yam = YamahaDataset(*random_corpus(cfg, 7 * TB, SEED + 3),
                          mode="train").arrays()             # 5 batches
    m_vg = VGMIDIDataset(*random_corpus(cfg, 6 * 32, SEED + 4,
                                        supervised=True),
                         mode="train").arrays()              # 4 batches
    m_leaves = mtr.optimizer.param_groups[0]["params"]
    m_names = {id(t): name for name, t in named_leaves(mtr.fast_params)}
    first_steps = {}
    for variant, arrays, bs in (("default", m_yam, TB),
                                ("supervised", m_vg, 32)):
        loss_fn = gmm_losses[variant]
        batch = {k: torch.from_numpy(v[:bs]).to(dev)
                 for k, v in arrays.items()}
        m_eps = tuple(e.to(dev) for e in mtr.noise_fn(0, bs, loss_fn))

        def m_loss_grads(loss_fn=loss_fn, batch=batch, m_eps=m_eps):
            loss, _ = loss_fn(mtr.fast_params, m_eps, batch, 0, mp_cfg)
            return loss.detach(), torch.autograd.grad(loss, m_leaves,
                                                      allow_unused=True)

        m_loss_k, m_grads_k = m_loss_grads()
        m_paths = (cuda_gru.LAST_TRAIN_PATH, cuda_decoder.LAST_TRAIN_PATH)
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            m_loss_p, m_grads_p = m_loss_grads()
        torch.cuda.synchronize()
        first_steps[variant] = {
            "B": bs, "loss_kernel": float(m_loss_k),
            "loss_plain": float(m_loss_p),
            "loss_rel_err": abs(float(m_loss_k) - float(m_loss_p))
            / max(abs(float(m_loss_p)), 1e-6),
            "grad_dtypes": sorted({str(g.dtype) for g in m_grads_k
                                   if g is not None}),
            **worst_leaf(m_grads_k, m_grads_p,
                         [m_names[id(t)] for t in m_leaves]),
            "kernel_paths": m_paths}
        del m_grads_k, m_grads_p
    zero_counts(*all_counts)
    m_runs = {}
    for variant, arrays, bs in (("default", m_yam, TB),
                                ("supervised", m_vg, 32)):
        m_runs[variant] = mtr.run_epoch(take(arrays, 0, 3 * bs), variant,
                                        batch_size=bs, seed=1)
    torch.cuda.synchronize()
    gmm_bf16_launches = read_counts(*all_counts)
    m_path = mtr.train_path
    opt_dtypes = sorted({str(v.dtype) for st in mtr.optimizer.state.values()
                         for k, v in st.items() if k != "step"})
    param_dtypes = sorted({str(t.dtype) for t in m_leaves})
    m_finite = all(np.isfinite(v) for m in m_runs.values()
                   for v in m.values())
    # ms a step, float32 and bf16 Trainers in turns (f32, bf16, bf16, f32),
    # 2 warm-up and 3 timed B=128 steps each
    f32_tr = Trainer(cfg, init_reg_gmvae, gmm_losses, seed=SEED,
                     device="cuda")
    turns = []
    for label, t_ in (("float32", f32_tr), ("bfloat16", mtr),
                      ("bfloat16", mtr), ("float32", f32_tr)):
        t_.run_epoch(take(m_yam, 3 * TB, 5 * TB), batch_size=TB, seed=3)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        t_.run_epoch(take(m_yam, 0, 3 * TB), batch_size=TB, seed=4)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        turns.append({"dtype": label, "ms_per_step": wall * 1e3 / 3,
                      "seq_per_s": 3 * TB / wall})
    del f32_tr
    want_rows = ("embed_gru_train_bf16", "embed_gru_bwd_bf16",
                 "embed_seq_bf16", "embed_seq_bwd_bf16", "decoder_ce_bf16",
                 "decoder_ce_bwd_bf16")
    emit({"phase": "mixed_precision", "part": "gmm_trainer",
          "first_step": first_steps, "tol_loss_rel": MP_TOL_LOSS_REL,
          "tol_grad_rel": MP_TOL_STEP_GRAD_REL, "runs": m_runs,
          "finite": m_finite, "train_path": m_path,
          "launches": gmm_bf16_launches, "param_dtypes": param_dtypes,
          "adam_dtypes": opt_dtypes, "ms_per_step_in_turns": turns})
    for variant, fs in first_steps.items():
        if fs["kernel_paths"] != ("kernel", "kernel") or fs[
                "grad_dtypes"] != ["torch.float32"]:
            return fail(f"mixed_precision gmm {variant}: {fs}")
        if not (fs["loss_rel_err"] <= MP_TOL_LOSS_REL
                and fs["grad_max_rel_err"] <= MP_TOL_STEP_GRAD_REL):
            return fail(f"mixed_precision gmm {variant}: first step kernel "
                        f"vs plain {fs}")
    if not m_finite or m_path != "kernel" or param_dtypes != [
            "torch.float32"] or opt_dtypes != ["torch.float32"]:
        return fail(f"mixed_precision gmm: finite {m_finite}, path "
                    f"{m_path}, params {param_dtypes}, Adam {opt_dtypes}")
    if not all(gmm_bf16_launches.get(k, 0) > 0 for k in want_rows) or any(
            k in gmm_bf16_launches for k in ("embed_gru_train",
                                             "decoder_ce")):
        return fail(f"mixed_precision gmm launches {gmm_bf16_launches}")
    mp_launches.update({k: gmm_bf16_launches[k] for k in want_rows})

    # (c) the other casting families' first step in bf16; (d) GLSR
    for fam in ("vanilla", "cvae", "fader", "singlevae", "glsr"):
        init_fn, loss_fn, profile_step = FAMILIES[fam]
        first_step = profile_step or 1000
        ftr = Trainer(mp_cfg, init_fn, {"default": loss_fn}, seed=SEED,
                      device="cuda")
        f_eps = tuple(e.to(dev) for e in ftr.noise_fn(0, TB, loss_fn))
        f_leaves = ftr.optimizer.param_groups[0]["params"]
        f_names = {id(t): n for n, t in named_leaves(ftr.fast_params)}

        def f_loss_grads(c=mp_cfg, ftr=ftr, f_eps=f_eps, f_leaves=f_leaves,
                         loss_fn=loss_fn, first_step=first_step):
            loss, _ = loss_fn(ftr.fast_params, f_eps, fam_first, first_step,
                              c)
            return loss.detach(), torch.autograd.grad(loss, f_leaves,
                                                      allow_unused=True)

        for m in (cuda_gru, cuda_decoder, cuda_stacked):
            m.LAST_TRAIN_PATH = None
        zero_counts(*all_counts)
        f_loss_k, f_grads_k = f_loss_grads()
        torch.cuda.synchronize()
        f_launches = read_counts(*all_counts)
        f_paths = sorted({m.LAST_TRAIN_PATH for m in (
            cuda_gru, cuda_decoder, cuda_stacked)} - {None})
        if fam == "glsr":
            # GLSR ignores the dtype: the float32 config's step, bit for bit
            f_loss_32, f_grads_32 = f_loss_grads(cfg)
            torch.cuda.synchronize()
            equal = torch.equal(f_loss_k, f_loss_32) and all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(f_grads_k, f_grads_32))
            emit({"phase": "mixed_precision", "part": "glsr_f32",
                  "step": first_step, "bit_equal_to_float32": equal,
                  "launches": f_launches})
            if not equal or any(k.endswith("_bf16") for k in f_launches):
                return fail(f"mixed_precision glsr: bit-equal {equal}, "
                            f"launches {f_launches}")
            continue
        with plain_path(cuda_gru, cuda_decoder, cuda_stacked):
            f_loss_p, f_grads_p = f_loss_grads()
        torch.cuda.synchronize()
        f_line = {"loss_kernel": float(f_loss_k),
                  "loss_plain": float(f_loss_p),
                  "loss_rel_err": abs(float(f_loss_k) - float(f_loss_p))
                  / max(abs(float(f_loss_p)), 1e-6),
                  **worst_leaf(f_grads_k, f_grads_p,
                               [f_names[id(t)] for t in f_leaves]),
                  "kernel_paths": f_paths, "launches": f_launches}
        emit({"phase": "mixed_precision", "part": "family", "family": fam,
              "B": TB, "step": first_step, "first_step": f_line})
        if f_paths != ["kernel"] or not (
                f_line["loss_rel_err"] <= MP_TOL_LOSS_REL
                and f_line["grad_max_rel_err"] <= MP_TOL_STEP_GRAD_REL):
            return fail(f"mixed_precision {fam}: {f_line}")
        if fam == "cvae":
            if not (f_launches.get("stacked_gru_bf16", 0) > 0
                    and f_launches.get("stacked_gru_bwd_bf16", 0) > 0):
                return fail(f"mixed_precision cvae launches {f_launches}")
            mp_launches.update({k: f_launches[k] for k in (
                "stacked_gru_bf16", "stacked_gru_bwd_bf16")})
        del ftr, f_grads_k, f_grads_p

    # (e) the training CLI in bf16: one epoch with its validation pass, then
    # save -> restore
    with tempfile.TemporaryDirectory(dir="build") as mp_tmp:
        repo = os.path.dirname(os.path.abspath(__file__))
        mp_common = ["--config", os.path.join(repo, "configs",
                                              "gmm_model_config.json"),
                     "--synthetic-size", "512", "--seed", str(SEED),
                     "--dtype", "bfloat16",
                     "--save-dir", os.path.join(mp_tmp, "params"),
                     "--log-dir", os.path.join(mp_tmp, "log"),
                     "--data-dir", os.path.join(mp_tmp, "no_cache"),
                     "--vgmidi-dir", os.path.join(mp_tmp, "no_vgmidi")]
        zero_counts(*all_counts)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            ctr = train_cli.run_training("gmm", "chip_smoke",
                                         dual_corpus=True,
                                         argv=mp_common + ["--epochs", "1"])
        torch.cuda.synchronize()
        cli_s = time.monotonic() - t0
        cli_l = read_counts(*all_counts)
        name = train_cli.MODEL_REGISTRY["gmm"]["name"]
        with open(os.path.join(mp_tmp, "log", f"{name}.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        cli_finite = all(np.isfinite(r["loss"]) for r in recs)
        back = ckpt.restore_checkpoint(os.path.join(mp_tmp, "params", name))
        st = ctr.state
        pairs = [(a, b) for tree_a, tree_b in (
            (back["params"], st.params),
            (back["opt_state"]["mu"], st.opt_state["mu"]),
            (back["opt_state"]["nu"], st.opt_state["nu"]))
            for (_, a), (_, b) in zip(named_leaves(tree_a),
                                      named_leaves(tree_b))]
        exact = all(torch.equal(a.cpu(), b.cpu()) for a, b in pairs)
        ck_dtypes = sorted({str(a.dtype) for a, _ in pairs})
    emit({"phase": "mixed_precision", "part": "train_cli",
          "dtype": ctr.cfg.dtype, "seconds": cli_s, "steps": ctr.step,
          "finite": cli_finite, "splits": sorted({r["split"] for r in recs}),
          "launches": cli_l, "restore_bit_exact": exact,
          "checkpoint_dtypes": ck_dtypes})
    if not (cli_finite and exact and ck_dtypes == ["torch.float32"]
            and ctr.cfg.dtype == "bfloat16"
            and cli_l.get("embed_gru_bf16", 0) > 0
            and "yamaha_val" in {r["split"] for r in recs}):
        return fail(f"mixed_precision train_cli: finite {cli_finite}, "
                    f"exact {exact}, dtypes {ck_dtypes}, launches {cli_l}")
    mp_launches["embed_gru_bf16"] = cli_l["embed_gru_bf16"]
    del ctr, mtr

    launches = {**serving_launches,
                **{k: train_launches[k] for k in train_kernels},
                **{k: sg_launches[k] for k in ("decoder_teacher",
                                               "decoder_teacher_bwd")},
                **{k: family_launches[fam][k]
                   for fam, ks in family_kernels.items() for k in ks},
                **mp_launches}
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
