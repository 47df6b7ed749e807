"""The least time the card could take for the required work, counted from
shapes, whatever kernels implement it.

An operation is (name, FLOPs, bytes); its bound is max(FLOPs / peak FLOP/s,
bytes / peak bytes/s). Every matmul that `flops.py` counts is listed, at
the granularity a dependent chain forces: a recurrence is one operation a
step, forward and backward (dX), since step t+1 needs step t; its weight
gradient is one GEMM over all steps. Bytes count each input read once and
each output written once. Gathered input rows and elementwise work are
left out, as in `flops.py`. Adam and the global-norm clip are counted by
their bytes: Adam reads the parameter, gradient and both moments and
writes the parameter and both moments; the clip reads the gradients for
the norm, then reads and writes them once to scale.

The sum of the operations' FLOPs equals `flops.train_step_flops` and
`flops.serve_batch_flops` (a test holds them to it).
"""
from __future__ import annotations

from typing import List, Tuple

from h100bench.yardstick.flops import dims

Op = Tuple[str, float, float]


def _mm(name: str, M: int, K: int, N: int, e: int) -> Op:
    return (name, 2.0 * M * K * N, float(e * (M * K + K * N + M * N)))


def _dense(name: str, M: int, K: int, N: int, e: int) -> List[Op]:
    """A dense layer's forward, and its backward dX and dW."""
    return [_mm(name, M, K, N, e), _mm(name + ".dx", M, N, K, e),
            _mm(name + ".dw", K, M, N, e)]


def _recurrence(name: str, B: int, T: int, H: int, e: int) -> List[Op]:
    """T dependent steps of (B,H)@(H,3H) forward and backward, and the
    weight gradient as one GEMM over the T*B rows."""
    step = _mm(name, B, H, 3 * H, e)
    back = _mm(name + ".dx", B, 3 * H, H, e)
    return [step] * T + [back] * T + [_mm(name + ".dw", H, T * B, 3 * H, e)]


def train_step_ops(cfg: dict, family: str, trainable_floats: int,
                   batch: int = None, elem_bytes: int = 4) -> List[Op]:
    """The required operations of one training step of `family` ("gmm" or
    "cvae"), with `trainable_floats` parameters stepped by Adam."""
    d = dims(cfg)
    B = batch or d["B"]
    T, Ta, H, Z, V, C, e = d["T"], d["Ta"], d["H"], d["Z"], d["V"], \
        d["C"], elem_bytes
    ops: List[Op] = []
    if family == "gmm":
        for k in range(4):
            ops += _recurrence(f"encoder{k}", B, T, H, e)
        for k in range(4):
            ops += _dense(f"enc_head{k}", B, 2 * H, Z, e)
        for s, width in (("r", d["R"]), ("n", d["N"])):
            ops += _recurrence(f"sub_{s}", B, Ta, H, e)
            ops += _dense(f"sub_{s}.z", B, Z, 3 * H, e)
            ops += _dense(f"sub_{s}.init", B, Z, H, e)
            ops += _dense(f"sub_{s}.out", B * Ta, H, width, e)
        z_total = 2 * Z + C
    elif family == "cvae":
        for k in range(2):
            ops += _recurrence(f"encoder{k}", B, T, H, e)
            ops += _dense(f"encoder{k}.in", B * T, V + 2, 3 * H, e)
            ops += _dense(f"enc_head{k}", B, 2 * H, Z, e)
        z_total = Z + 2
    else:
        raise ValueError(f"no operation list for family {family!r}")
    ops += _dense("dec.init", B, z_total, H, e)
    ops += _dense("dec.z", B, z_total, 3 * H, e)
    ops += _recurrence("dec.layer1", B, T, H, e)
    ops += _dense("dec.layer2_in", B * T, H, 3 * H, e)
    ops += _recurrence("dec.layer2", B, T, H, e)
    ops += _dense("dec.logits", B * T, H, V, e)
    p = float(trainable_floats)
    ops.append(("clip", 0.0, 4.0 * 3 * p))
    ops.append(("adam", 0.0, 4.0 * 7 * p))
    return ops


def serve_batch_ops(cfg: dict, rows: int, steps: int,
                    elem_bytes: int = 4) -> List[Op]:
    """The required operations of one served GM-VAE batch (inference: no
    backward): the encoder's four directions over the prompt, its heads,
    the decoder's h0 and z projections and `steps` dependent decode steps
    (layer 1, layer 2's input, layer 2, the logits head)."""
    d = dims(cfg)
    B, T, H, Z, V, C, e = rows, d["T"], d["H"], d["Z"], d["V"], d["C"], \
        elem_bytes
    z_total = 2 * Z + C
    ops = [_mm(f"encoder{k}", B, H, 3 * H, e) for k in range(4)] * T
    ops += [_mm(f"enc_head{k}", B, 2 * H, Z, e) for k in range(4)]
    ops += [_mm("dec.init", B, z_total, H, e),
            _mm("dec.z", B, z_total, 3 * H, e)]
    ops += [_mm("dec.layer1", B, H, 3 * H, e),
            _mm("dec.layer2_in", B, H, 3 * H, e),
            _mm("dec.layer2", B, H, 3 * H, e),
            _mm("dec.logits", B, H, V, e)] * steps
    return ops


def bound_seconds(ops: List[Op], peak_flops: float,
                  peak_bytes_per_s: float) -> float:
    """The sum over `ops` of max(FLOPs / peak, bytes / bandwidth)."""
    return sum(max(f / peak_flops, b / peak_bytes_per_s) for _, f, b in ops)
