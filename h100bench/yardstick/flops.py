"""Analytic matmul FLOPs of one training step, per model family: a frozen
copy of `benchmarks/flops.py`, rewritten to read the harness's own
configuration files (`h100bench/configs/*.json`) instead of importing any
package. Later changes to the program do not move this yardstick.

Counting rules (unchanged from the original):
  * Only matmul FLOPs are counted, at 2*M*N*K per (M,K)@(K,N).
    Elementwise work (gate math, softmax) and reductions are excluded.
  * One-hot input projections that run as row gathers are excluded: the
    embedded-token encoder, the class-embedded sub-decoders and the
    decoder's teacher-token rows. The CVAE encoder is the exception: its
    input is [one-hot, 2 densities], a dense (B*T, V+2)@(V+2, 3H) matmul.
  * Backward = 2x forward for every counted matmul (dX and dW).
  * Small heads (mu/var, sub-decoder outputs, h0 inits) are counted.

At B=128, T=100, Ta=16, H=512, Z=128, V=342, chroma 24 a GM-VAE step is
456.9 GFLOP and a CVAE step 397.0 GFLOP.
"""
from __future__ import annotations


def dims(cfg: dict) -> dict:
    """The sizes a count reads, from a configuration file's dict (the
    published keys `hidden_dim` / `z_dim`, or the long names)."""
    return {
        "B": int(cfg["batch_size"]), "T": int(cfg["seq_len"]),
        "Ta": int(cfg["attr_len"]),
        "H": int(cfg.get("hidden_dim", cfg.get("hidden_dims"))),
        "Z": int(cfg.get("z_dim", cfg.get("z_dims"))),
        "V": int(cfg["roll_dims"]), "C": int(cfg["chroma_dims"]),
        "R": int(cfg["rhythm_dims"]), "N": int(cfg["note_dims"]),
    }


def _gru_recurrence(B: int, T: int, H: int) -> float:
    """T sequential steps of h@w_hh: (B,H)@(H,3H)."""
    return T * 2.0 * B * H * 3 * H


def _dense_inproj(B: int, T: int, I: int, H: int) -> float:
    """Hoisted full-sequence input projection (B*T, I)@(I, 3H)."""
    return 2.0 * B * T * I * 3 * H


def _global_decoder(B: int, T: int, H: int, V: int) -> float:
    """Per step: layer-1 recurrence, layer-2 input projection, layer-2
    recurrence (3 of (B,H)@(H,3H)) and the logits head (B,H)@(H,V)."""
    return T * (3 * 2.0 * B * H * 3 * H + 2.0 * B * H * V)


def train_step_flops(cfg: dict, family: str, batch: int = None) -> float:
    """Forward + backward matmul FLOPs of one optimizer step of `family`
    ("gmm", "vanilla", "glsr", "cvae", "fader", "singlevae") at `cfg`'s
    sizes; `batch` overrides the configuration's batch size."""
    d = dims(cfg)
    B = batch or d["B"]
    T, Ta, H, Z, V, C = d["T"], d["Ta"], d["H"], d["Z"], d["V"], d["C"]

    fwd = 0.0
    if family in ("vanilla", "glsr", "gmm"):
        fwd += 4 * _gru_recurrence(B, T, H)          # 2 streams x 2 dirs
        fwd += 4 * 2.0 * B * 2 * H * Z               # mu / var heads
        fwd += 2 * (_gru_recurrence(B, Ta, H) + 2.0 * B * Z * 3 * H
                    + 2.0 * B * Z * H)               # sub-decoders
        fwd += 2.0 * B * Ta * H * d["R"] + 2.0 * B * Ta * H * d["N"]
        z_total = 2 * Z + C
    elif family == "singlevae":
        fwd += 2 * _gru_recurrence(B, T, H)
        fwd += 2 * 2.0 * B * 2 * H * (2 * Z)
        z_total = 2 * Z + C
    elif family in ("cvae", "fader"):
        fwd += 2 * _gru_recurrence(B, T, H)
        if family == "cvae":
            fwd += 2 * _dense_inproj(B, T, V + 2, H)
        fwd += 2 * 2.0 * B * 2 * H * Z
        fwd += 2 * 2.0 * B * Z * 1 if family == "fader" else 0.0
        z_total = Z + 2
    else:
        raise ValueError(f"unknown family {family!r}")

    fwd += 2.0 * B * z_total * H                     # linear_init_global
    fwd += 2.0 * B * z_total * 3 * H                 # z @ w_z
    fwd += _global_decoder(B, T, H, V)

    if family == "glsr":
        z4 = 4 * B
        fwd += 2.0 * z4 * z_total * H + 2.0 * z4 * z_total * 3 * H
        fwd += _global_decoder(z4, T, H, V)

    return 3.0 * fwd


def serve_batch_flops(cfg: dict, rows: int, steps: int) -> float:
    """Matmul FLOPs of one served GM-VAE batch of `rows` rows (padded rows
    included, as the server runs them): the two-stream token encoder over
    the prompt (gathered input rows), the mu / var heads, the decoder's
    h0 and z projections, and `steps` greedy decode steps (the logits head
    included; the fed-back token's row is a gather)."""
    d = dims(cfg)
    B, T, H, Z, V, C = rows, d["T"], d["H"], d["Z"], d["V"], d["C"]
    z_total = 2 * Z + C
    f = 4 * _gru_recurrence(B, T, H) + 4 * 2.0 * B * 2 * H * Z
    f += 2.0 * B * z_total * H + 2.0 * B * z_total * 3 * H
    return f + _global_decoder(B, steps, H, V)
