"""Whole-decode greedy and Gumbel-max sampling kernels (`csrc/decode.cu`)
and their plain PyTorch versions.

Counterpart of `music_fader_nets_tpu/ops/pallas_decode.py`. Per step: the
token row of `w_tok` plus the precomputed z projection, both GRUCell layers
(with the reference's step-0 rule), the logits head with pad lanes biased
to -1e30, and the argmax feedback — `argmax(logits)` for greedy rows,
`argmax(logits * inv_t + noise[i])` for sampled rows. Only int32 tokens
come back.

The wrappers run the plain version for tensors on the CPU and the CUDA
kernel for tensors on a GPU; there is no fallback between the two. The
products around the kernel (`pre_z`, `h1_0`, padding) stay torch ops, as
the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.ops import _build
from music_fader_nets_tpu_torch.ops.gru import _gates, pad_vocab, vocab_pad
from music_fader_nets_tpu_torch.ops.sampling import gumbel_rows
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

# wrapper calls that launched each kernel (one call = 3 x steps + 1
# device launches)
LAUNCHES = {"greedy_decode": 0, "sample_decode": 0}
# which path served the last greedy/sample_decode_tokens call: "kernel",
# "kernel-chunked" (more than _CHUNK rows, one kernel call per _CHUNK-row
# chunk, the last one zero-padded) or "plain-cpu"
LAST_DECODE_PATH = None

# rows per kernel call; larger batches are chunked as the reference does
_CHUNK = 64

# sampling temperature bounds: below 1e-6, 1/T overflows float32 headroom;
# above 1e6 the -1e30 * inv_t pad-lane bias can tie with real lanes.
# temperature 0 means greedy.
TEMPERATURE_MIN = 1e-6
TEMPERATURE_MAX = 1e6

DecodeArgs = Tuple[torch.Tensor, ...]


def _pad_last(x: torch.Tensor, size: int, value: float = 0.0):
    pad = size - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), value)], dim=-1)


def _prep_decode_args(gview: Dict, z: torch.Tensor):
    """The kernel arguments: weights padded to the vocab lane boundary, the
    z projection and layer-1 initial state precomputed. Returns
    ((w_tok, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2, b_hh2, w_out, b_out,
    pre_z, h1_0), V, Vp); biases are 1-D."""
    V = gview["linear_out_g"]["w"].shape[-1]
    Vp = vocab_pad(V)
    g1, g2 = gview["grucell_g"], gview["grucell_g_2"]
    w_ih = g1["w_ih"]                                          # (V + Z, 3H)
    w_tok = pad_vocab(w_ih[:V])
    pre_z = z @ w_ih[V:] + g1["b_ih"]                          # (B, 3H)
    init = gview["linear_init_global"]
    h1_0 = z @ init["w"] + init["b"]
    w_out = _pad_last(gview["linear_out_g"]["w"], Vp)
    # pad lanes can never win the argmax
    b_out = _pad_last(gview["linear_out_g"]["b"], Vp, value=-1e30)
    args = (w_tok, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
            g2["w_hh"], g2["b_hh"], w_out, b_out, pre_z, h1_0)
    return args, V, Vp


def decode_scores_plain(args: DecodeArgs, V: int, steps: int,
                        noise: Optional[torch.Tensor] = None,
                        inv_t: Optional[torch.Tensor] = None,
                        feed: Optional[torch.Tensor] = None):
    """Plain PyTorch decode loop. Yields (tokens, scores) per step, where
    scores (B, Vp) are the raw logits (greedy) or `logits * inv_t +
    noise[i]` (sampling) and tokens their argmax (lowest index on ties).
    With `feed` (steps, B), the next step consumes feed[i] instead of the
    argmax — teacher forcing, used to examine where two decodes part."""
    (w_tok, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2, b_hh2,
     w_out, b_out, pre_z, h1_0) = args
    B = pre_z.shape[0]
    tok = torch.full((B,), V - 1, dtype=torch.long, device=pre_z.device)
    h1, h2 = h1_0, torch.zeros_like(h1_0)
    for i in range(steps):
        pre1 = w_tok[tok] + pre_z
        h1 = _gates(pre1, h1 @ w_hh1 + b_hh1, h1)
        h2_prev = h1 if i == 0 else h2
        h2 = _gates(h1 @ w_ih2 + b_ih2, h2_prev @ w_hh2 + b_hh2, h2_prev)
        scores = h2 @ w_out + b_out
        if noise is not None:
            scores = scores * inv_t[:, None] + noise[i]
        out = torch.argmax(scores, dim=-1)
        yield out, scores
        tok = out if feed is None else feed[i].long()


def near_tie_partings(args: DecodeArgs, V: int, got: torch.Tensor,
                      ref: torch.Tensor, noise=None, inv_t=None,
                      tol: float = 1e-4):
    """Where kernel tokens `got` part from plain tokens `ref` (both
    (B, steps)), check that each parting is a legitimate near-tie: feeding
    the kernel's tokens through the plain version, at each row's first
    differing step the plain scores must hold the kernel's token within
    `tol` of their maximum. Returns (rows parted, largest gap); raises
    AssertionError at a parting that is not a near-tie."""
    diff = got != ref
    rows = diff.any(dim=1).nonzero().flatten().tolist()
    if not rows:
        return 0, 0.0
    first = diff.float().argmax(dim=1)           # first True per row
    need = {int(first[b]) for b in rows}
    at = {}
    for i, (_, sc) in enumerate(decode_scores_plain(
            args, V, got.shape[1], noise, inv_t, feed=got.t())):
        if i in need:
            at[i] = sc
        if i >= max(need):
            break
    worst = 0.0
    for b in rows:
        i = int(first[b])
        sc = at[i][b]
        gap = float(sc.max() - sc[got[b, i].long()])
        worst = max(worst, gap)
        if not gap <= tol:
            raise AssertionError(
                f"row {b} step {i}: token {int(got[b, i])} scores {gap} "
                f"below the plain maximum (tolerance {tol})")
    return len(rows), worst


def _plain_tokens(args, V, steps, noise=None, inv_t=None) -> torch.Tensor:
    toks = [t for t, _ in decode_scores_plain(args, V, steps, noise, inv_t)]
    B = args[-1].shape[0]
    if not toks:
        return torch.empty((B, 0), dtype=torch.int32,
                           device=args[-1].device)
    return torch.stack(toks, dim=1).to(torch.int32)            # (B, steps)


def plain_decode_tokens(gview: Dict, z: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """Plain greedy decode -> (B, steps) int32."""
    args, V, _ = _prep_decode_args(gview, z)
    return _plain_tokens(args, V, steps)


def plain_sample_tokens(gview: Dict, z: torch.Tensor, noise: torch.Tensor,
                        inv_t: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain Gumbel-max decode -> (B, steps) int32; noise (steps, B, Vp),
    inv_t (B,) or (B, 1)."""
    args, V, _ = _prep_decode_args(gview, z)
    return _plain_tokens(args, V, steps, noise, inv_t.reshape(-1))


def _launch(args: DecodeArgs, V: int, Vp: int, steps: int,
            noise=None, inv_t=None) -> torch.Tensor:
    """One kernel call on CUDA tensors -> (B, steps) int32."""
    dev = args[-1].device
    args = tuple(a.contiguous() for a in args)
    for a in args:
        if a.device != dev or a.dtype != torch.float32:
            raise ValueError("decode kernel arguments must be float32 "
                             f"tensors on {dev}")
    B, H = args[-1].shape
    G = 3 * H
    want = [(Vp, G), (H, G), (G,), (H, G), (G,), (H, G), (G,), (H, Vp),
            (Vp,), (B, G), (B, H)]
    if [tuple(a.shape) for a in args] != want:
        raise ValueError(f"decode kernel argument shapes "
                         f"{[tuple(a.shape) for a in args]}, expected {want}")
    tokens = torch.empty((steps, B), dtype=torch.int32, device=dev)
    if B == 0 or steps == 0:
        return tokens.t()
    lib = _build.load_library()
    h1_buf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h2_buf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    keys = torch.empty((B,), dtype=torch.int64, device=dev)
    ptrs = [a.data_ptr() for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if noise is None:
            err = lib.fader_greedy_decode(
                B, H, V, Vp, steps, *ptrs, h1_buf.data_ptr(),
                h2_buf.data_ptr(), keys.data_ptr(), tokens.data_ptr(),
                stream)
            name = "greedy_decode"
        else:
            noise = noise.contiguous()
            inv_t = inv_t.reshape(-1).contiguous()
            if (noise.shape != (steps, B, Vp) or inv_t.shape != (B,)
                    or noise.dtype != torch.float32
                    or inv_t.dtype != torch.float32
                    or noise.device != dev or inv_t.device != dev):
                raise ValueError("noise must be (steps, B, Vp) and inv_t "
                                 f"(B,) float32 on {dev}")
            err = lib.fader_sample_decode(
                B, H, V, Vp, steps, *ptrs, noise.data_ptr(),
                inv_t.data_ptr(), h1_buf.data_ptr(), h2_buf.data_ptr(),
                keys.data_ptr(), tokens.data_ptr(), stream)
            name = "sample_decode"
    _build.check(err, f"fader_{name}")
    LAUNCHES[name] += 1
    return tokens.t()


def _device_of(gview: Dict, z: torch.Tensor) -> torch.device:
    dev = z.device
    w = gview["grucell_g"]["w_hh"]
    if w.device != dev:
        raise ValueError(f"z on {dev} but decoder weights on {w.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_greedy_decode(gview: Dict, z: torch.Tensor,
                       steps: int) -> torch.Tensor:
    """One greedy decode call (counterpart of `pallas_greedy_decode`):
    (B, steps) int32. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    dev = _device_of(gview, z)
    args, V, Vp = _prep_decode_args(gview, z)
    if dev.type == "cpu":
        return _plain_tokens(args, V, steps)
    return _launch(args, V, Vp, steps)


def cuda_sample_decode(gview: Dict, z: torch.Tensor, noise: torch.Tensor,
                       inv_t: torch.Tensor, steps: int) -> torch.Tensor:
    """One Gumbel-max decode call (counterpart of `pallas_sample_decode`):
    noise (steps, B, Vp), inv_t (B,) or (B, 1) -> (B, steps) int32. Rows
    with inv_t = 1 and zero noise decode greedily, exactly."""
    dev = _device_of(gview, z)
    args, V, Vp = _prep_decode_args(gview, z)
    inv_t = inv_t.reshape(-1)
    if dev.type == "cpu":
        return _plain_tokens(args, V, steps, noise, inv_t)
    return _launch(args, V, Vp, steps, noise, inv_t)


def _chunked(gview, z, steps, noise=None, inv_t=None) -> torch.Tensor:
    """Decode any number of rows as calls of at most _CHUNK rows; above
    _CHUNK every chunk has exactly _CHUNK rows (the tail zero-padded, with
    zero noise and inv_t = 1), as the reference chunks its kernel."""
    global LAST_DECODE_PATH
    B = z.shape[0]
    sampled = noise is not None

    def call(zc, nc=None, tc=None):
        if sampled:
            return cuda_sample_decode(gview, zc, nc, tc, steps)
        return cuda_greedy_decode(gview, zc, steps)

    cpu = z.device.type == "cpu"
    if B <= _CHUNK:
        LAST_DECODE_PATH = "plain-cpu" if cpu else "kernel"
        return call(z, noise, inv_t)
    pad = (-B) % _CHUNK
    if pad:
        z = torch.cat([z, z.new_zeros((pad, z.shape[1]))])
        if sampled:
            noise = torch.cat([noise, noise.new_zeros(
                (noise.shape[0], pad, noise.shape[2]))], dim=1)
            inv_t = torch.cat([inv_t, inv_t.new_ones((pad,))])
    outs = [call(z[s:s + _CHUNK],
                 noise[:, s:s + _CHUNK] if sampled else None,
                 inv_t[s:s + _CHUNK] if sampled else None)
            for s in range(0, B + pad, _CHUNK)]
    LAST_DECODE_PATH = "plain-cpu" if cpu else "kernel-chunked"
    return torch.cat(outs)[:B]


def greedy_decode_tokens(gview: Dict, z: torch.Tensor, steps: int,
                         device=None) -> torch.Tensor:
    """Token-level greedy decode, (B, steps) int32, on `device` (default
    CUDA; raises RuntimeError without one unless device='cpu')."""
    dev = resolve_device(device)
    return _chunked(tree_to(gview, dev), z.to(dev, torch.float32), steps)


def check_temperature(temperature: float) -> None:
    if temperature != 0.0 and not (
            TEMPERATURE_MIN <= temperature <= TEMPERATURE_MAX):
        raise ValueError(
            f"temperature must be 0 (greedy) or within "
            f"[{TEMPERATURE_MIN:g}, {TEMPERATURE_MAX:g}] (float32 1/T "
            f"bounds), got {temperature!r}")


def sample_decode_tokens(gview: Dict, z: torch.Tensor, steps: int,
                         seeds: Sequence[int], temperature: float = 1.0,
                         device=None) -> torch.Tensor:
    """Gumbel-max sampling decode from softmax(logits / temperature),
    (B, steps) int32. Row b's noise comes from a generator seeded with
    seeds[b]; temperature <= 0 is the greedy decode."""
    if temperature <= 0:
        return greedy_decode_tokens(gview, z, steps, device)
    check_temperature(temperature)
    dev = resolve_device(device)
    B = z.shape[0]
    if len(seeds) != B:
        raise ValueError(f"need one seed per row ({B}), got {len(seeds)}")
    V = gview["linear_out_g"]["w"].shape[-1]
    noise = gumbel_rows(seeds, steps, vocab_pad(V), dev)
    inv_t = torch.full((B,), 1.0 / temperature, dtype=torch.float32,
                       device=dev)
    return _chunked(tree_to(gview, dev), z.to(dev, torch.float32), steps,
                    noise, inv_t)
