"""The RegVAE pieces the GM-VAE serving path uses (counterpart of
`music_fader_nets_tpu/models/vae.py`): the parameter tree under the
reference's attribute names and the fused rhythm/note encoder.

`init_reg_vae` builds the whole reference tree — sub-decoders and the
unused chroma/classifier layers included — so a tree carries across from
the JAX package key for key; only the encoders and the global decoder run
in this slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.modules import (
    encode_streams_fused,
    global_decoder_init,
)
from music_fader_nets_tpu_torch.ops.gru import bigru_init, gru_init, linear_init

Params = Dict


def _enc_view(params, suffix: str):
    """Encoder-stream view from the flat reference-named leaves."""
    return {
        "gru": params[f"gru_{suffix}"],
        "mu": params[f"mu_{suffix}"],
        "var": params[f"var_{suffix}"],
    }


def _global_view(params):
    return {
        "linear_init_global": params["linear_init_global"],
        "grucell_g": params["grucell_g"],
        "grucell_g_2": params["grucell_g_2"],
        "linear_out_g": params["linear_out_g"],
    }


def init_reg_vae(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """MusicAttrRegVAE parameters (reference model_v2.py:26-60), drawn from
    the same distributions as the JAX init (torch.nn defaults)."""
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    p = {}
    for s in ("r", "n", "c"):
        p[f"gru_{s}"] = bigru_init(gen, V, H)
        p[f"mu_{s}"] = linear_init(gen, 2 * H, Z)
        p[f"var_{s}"] = linear_init(gen, 2 * H, Z)
    p["gru_d_r"] = gru_init(gen, Z + cfg.rhythm_dims, H)
    p["gru_d_n"] = gru_init(gen, Z + cfg.note_dims, H)
    p["gru_d_c"] = gru_init(gen, Z + cfg.chroma_dims, H)
    p["linear_init_r"] = linear_init(gen, Z, H)
    p["linear_init_n"] = linear_init(gen, Z, H)
    p["linear_init_c"] = linear_init(gen, Z, H)
    p["linear_out_r"] = linear_init(gen, H, cfg.rhythm_dims)
    p["linear_out_n"] = linear_init(gen, H, cfg.note_dims)
    p["linear_out_c"] = linear_init(gen, Z, cfg.chroma_dims)
    p["c_r"] = linear_init(gen, Z, 3)
    p["c_n"] = linear_init(gen, Z, 3)
    p.update(global_decoder_init(gen, 2 * Z + cfg.chroma_dims, V, H))
    return p


def reg_vae_encode(params, x_oh: Optional[torch.Tensor],
                   tokens: Optional[torch.Tensor] = None):
    """((mu_r, std_r), (mu_n, std_n)), reference model_v2.py:81-97. Both
    streams' bi-GRU directions run together; with `tokens` (B, T) the
    embedded-token encoder kernel runs (plain version on the CPU) and x_oh
    may be None. Runs where its tensors lie."""
    (mu_r, std_r), (mu_n, std_n) = encode_streams_fused(
        [_enc_view(params, "r"), _enc_view(params, "n")], x_oh,
        tokens=tokens)
    return (mu_r, std_r), (mu_n, std_n)
