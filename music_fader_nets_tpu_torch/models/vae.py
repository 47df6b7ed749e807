"""The RegVAE pieces the GM-VAE uses (counterpart of
`music_fader_nets_tpu/models/vae.py`): the parameter tree under the
reference's attribute names, the fused rhythm/note encoder and the paired
sub-decoders, over the canonical tree or the fast layout
(`models/fast.py`).

`init_reg_vae` builds the whole reference tree, the unused
chroma/classifier layers included, so a tree carries across from the JAX
package key for key.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.modules import (
    encode_streams_fused,
    encode_streams_fused_packed,
    global_decoder_init,
    sub_decoder_pair_apply,
    sub_decoder_pair_apply_packed,
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


def _sub_view(params, suffix: str):
    return {
        "gru": params[f"gru_d_{suffix}"],
        "init": params[f"linear_init_{suffix}"],
        "out": params[f"linear_out_{suffix}"],
    }


def _sub_pair_apply(params, r_oh, n_oh, z_r, z_n, faithful_axis: bool,
                    track_ids=None):
    """Both attribute sub-decoders, by the layout of `params` (canonical or
    fast). track_ids: optional ((B,T) rhythm ids, (B,T) note ids) for the
    class-embedded kernel on the fast layout."""
    if "sub_rn" in params:
        return sub_decoder_pair_apply_packed(
            params["sub_rn"],
            params["linear_init_r"], params["linear_init_n"],
            params["linear_out_r"], params["linear_out_n"],
            r_oh, n_oh, z_r, z_n, faithful_axis, track_ids=track_ids)
    return sub_decoder_pair_apply(_sub_view(params, "r"),
                                  _sub_view(params, "n"), r_oh, n_oh, z_r,
                                  z_n, faithful_axis)


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
    may be None. Runs where its tensors lie. Takes the canonical tree or
    the fast layout (`enc_rn`)."""
    if "enc_rn" in params:
        (mu_r, std_r), (mu_n, std_n) = encode_streams_fused_packed(
            params["enc_rn"],
            [(params["mu_r"], params["var_r"]),
             (params["mu_n"], params["var_n"])], x_oh, tokens=tokens)
        return (mu_r, std_r), (mu_n, std_n)
    (mu_r, std_r), (mu_n, std_n) = encode_streams_fused(
        [_enc_view(params, "r"), _enc_view(params, "n")], x_oh,
        tokens=tokens)
    return (mu_r, std_r), (mu_n, std_n)
