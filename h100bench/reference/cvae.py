"""Plain PyTorch reference of the CVAE baseline (Music FaderNets'
MusicAttrCVAE, reference `model_v2.py:288-423` and `trainer_cvae.py`):
its parameter tree and its training loss.

Independent of the program: written from the reference's definitions,
float32, every matmul through `Arith` so the control can run it in TF32.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from h100bench.reference import common as C


def param_spec(cfg: dict) -> List:
    """The canonical tree's leaves as (path, shape, init, used), as in
    `gmvae.param_spec`: one bi-GRU encoder over [one-hot, r_density,
    n_density], the mu / var heads, two unused classifier layers and the
    global decoder conditioned on [z, r_density, n_density]."""
    H, Z, V = cfg["hidden_dim"], cfg["z_dim"], cfg["roll_dims"]
    spec = []
    for d in ("fwd", "bwd"):
        spec += C.gru_spec(f"gru_e/{d}", V + 2, H)
    spec += C.linear_spec("mu", 2 * H, Z)
    spec += C.linear_spec("var", 2 * H, Z)
    spec += C.linear_spec("c_r", Z, 3, used=False)
    spec += C.linear_spec("c_n", Z, 3, used=False)
    spec += C.decoder_spec(Z + 2, V, H)
    return spec


def loss(ar: C.Arith, p: Dict, eps, batch: Dict, step: int, cfg: dict):
    """CE_X + beta(step) KLD (trainer_cvae.py:84-102): the encoder reads
    the one-hot tokens with both densities repeated along time
    (model_v2.py:342-354); the decoder reads [z, r_density, n_density].
    eps = (eps,) (B, Z)."""
    V = cfg["roll_dims"]
    x = torch.nn.functional.one_hot(batch["x"].long(), V).float()
    B, T, _ = x.shape
    cond = torch.stack([batch["r_density"], batch["n_density"]], -1)
    x_in = torch.cat([x, cond[:, None, :].expand(B, T, 2)], dim=-1)
    (h,) = C.bigru_finals(ar, [p["gru_e"]], x_in)
    mu, std = C.encoder_heads(ar, p["mu"], p["var"], h)
    z = mu + std * eps[0]
    ce_x = C.decoder_teacher_nll(ar, p, torch.cat([z, cond], -1), batch["x"])
    return ce_x + C.anneal_beta(step, cfg["beta"]) * C.kl_std_normal(mu, std)
