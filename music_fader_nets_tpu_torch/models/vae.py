"""The four Gaussian-prior model families of Music FaderNets (counterpart
of `music_fader_nets_tpu/models/vae.py`): RegVAE (the vanilla and GLSR
objectives, and the base of the GM-VAE), SingleVAE, CVAE and FaderNets.
Each has its parameter tree under the reference's attribute names, its
encoder, its training forward and its greedy decode, over the canonical
tree or the fast layout (`models/fast.py`).

The inits build the whole reference tree, the unused chroma/classifier
layers included, so a tree carries across from the JAX package key for
key. The forwards take their noise as arguments: `eps`, the N(0, 1) draws
of each reparameterisation (z = mu + std * eps), and FaderNets' dropout
keep-masks; the JAX package draws them inside from its rng.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.modules import (
    encode_streams_fused,
    encode_streams_fused_packed,
    global_decoder_greedy,
    global_decoder_init,
    global_decoder_teacher,
    global_decoder_teacher_nll,
    sub_decoder_pair_apply,
    sub_decoder_pair_apply_packed,
)
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.ops.gru import (
    bigru_init,
    gru_init,
    linear_apply,
    linear_init,
)
from music_fader_nets_tpu_torch.ops.sampling import grad_reverse

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


def _decode(params, z, x_oh, tokens, nll_targets, train: bool) -> Dict:
    """The global decoder's part of a training forward: the fused NLL
    (B, T) with `nll_targets`, else teacher log-probs when `train`, else
    the greedy decode's log-probs."""
    out = nll_x = None
    gview = _global_view(params)
    if train and nll_targets is not None:
        nll_x = global_decoder_teacher_nll(gview, z, x_oh, tokens,
                                           nll_targets)
    elif train:
        out = global_decoder_teacher(gview, z, x_oh)
    else:
        T = tokens.shape[1] if tokens is not None else x_oh.shape[1]
        out = global_decoder_greedy(gview, z, T)
    return {"out": out, "nll_x": nll_x}


def reg_vae_forward(params, eps_r: torch.Tensor, eps_n: torch.Tensor, x_oh,
                    r_oh, n_oh, chroma, cfg: ModelConfig, train: bool = True,
                    tokens=None, nll_targets=None, track_ids=None) -> Dict:
    """The training-path forward (reference model_v2.py:145-171): teacher-
    forced when `train` (the reference's eps=100 makes scheduled sampling
    a no-op), greedy otherwise. `tokens` (x_oh = one_hot(tokens)) routes
    the encoder and the decoder + CE to their kernels, `track_ids` the
    sub-decoders (fast layout); x_oh may then be None."""
    (mu_r, std_r), (mu_n, std_n) = reg_vae_encode(params, x_oh,
                                                  tokens=tokens)
    z_r = mu_r + std_r * eps_r
    z_n = mu_n + std_n * eps_n
    r_out, n_out = _sub_pair_apply(
        params, r_oh, n_oh, z_r, z_n, cfg.faithful_subdecoder_softmax_axis,
        track_ids=track_ids)
    z = torch.cat([z_r, z_n, chroma], dim=-1)
    return {**_decode(params, z, x_oh, tokens, nll_targets, train),
            "r_out": r_out, "n_out": n_out, "mu_r": mu_r, "std_r": std_r,
            "mu_n": mu_n, "std_n": std_n, "z_r": z_r, "z_n": z_n, "z": z}


def global_decode(params, z_full: torch.Tensor, steps: int):
    """Greedy decode's per-step log-probs (B, steps, V), for any of the four
    families: z_full is the decoder's input, [z_r, z_n, chroma] (RegVAE),
    [z, chroma] (SingleVAE) or [z, r_density, n_density] (CVAE,
    FaderNets)."""
    return global_decoder_greedy(_global_view(params), z_full, steps)


def reg_vae_decode_tokens(params, z: torch.Tensor, steps: int, device=None):
    """Greedy token decode (B, steps) int32 through the decode kernel
    (`ops/cuda_decode.py`), on CUDA unless device='cpu'."""
    return cuda_decode.greedy_decode_tokens(_global_view(params), z, steps,
                                            device)


# ---------------------------------------------------------------------------
# MusicAttrSingleVAE: one encoder, a 2z latent (reference model_v2.py:174-285)


def init_single_vae(gen: torch.Generator, cfg: ModelConfig) -> Params:
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    p = {"gru": bigru_init(gen, V, H),
         # a 2z latent, the disentangled models' capacity (model_v2.py:198)
         "mu": linear_init(gen, 2 * H, 2 * Z),
         "var": linear_init(gen, 2 * H, 2 * Z)}
    p.update(global_decoder_init(gen, 2 * Z + cfg.chroma_dims, V, H))
    return p


def single_vae_encode(params, x_oh, tokens=None):
    """(mu, std) of the one stream, (B, 2z)."""
    if "enc_1" in params:
        return encode_streams_fused_packed(
            params["enc_1"], [(params["mu"], params["var"])], x_oh,
            tokens=tokens)[0]
    view = {"gru": params["gru"], "mu": params["mu"], "var": params["var"]}
    return encode_streams_fused([view], x_oh, tokens=tokens)[0]


def single_vae_forward(params, eps: torch.Tensor, x_oh, chroma,
                       cfg: ModelConfig, train: bool = True, tokens=None,
                       nll_targets=None) -> Dict:
    """reference model_v2.py:264-285; eps (B, 2z)."""
    mu, std = single_vae_encode(params, x_oh, tokens=tokens)
    z = mu + std * eps
    z_full = torch.cat([z, chroma], dim=-1)
    return {**_decode(params, z_full, x_oh, tokens, nll_targets, train),
            "mu": mu, "std": std, "z": z, "z_full": z_full}


# ---------------------------------------------------------------------------
# MusicAttrCVAE: one encoder over [x, r_density, n_density], the decoder
# conditioned on the densities (reference model_v2.py:288-423)


def init_cvae(gen: torch.Generator, cfg: ModelConfig) -> Params:
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    cdtl = 2                  # (r_density, n_density), model_v2.py:315
    p = {"gru_e": bigru_init(gen, V + cdtl, H),
         "mu": linear_init(gen, 2 * H, Z),
         "var": linear_init(gen, 2 * H, Z),
         "c_r": linear_init(gen, Z, 3),           # unused (model_v2.py:307)
         "c_n": linear_init(gen, Z, 3)}
    p.update(global_decoder_init(gen, Z + cdtl, V, H))
    return p


def cvae_encode(params, x_oh: torch.Tensor, r_density: torch.Tensor,
                n_density: torch.Tensor):
    """The densities (B, 1) repeated along time and appended to the
    one-hot tokens (reference model_v2.py:342-354). The input is not a
    pure one-hot, so the embedded-token kernel cannot serve it: the
    projection is hoisted and the generic stacked-GRU kernels run
    (`ops/cuda_stacked.py`)."""
    B, T, _ = x_oh.shape
    cond = torch.cat([r_density, n_density], dim=-1).to(x_oh.dtype)
    x_in = torch.cat([x_oh, cond[:, None, :].expand(B, T, 2)], dim=-1)
    if "enc_e" in params:
        return encode_streams_fused_packed(
            params["enc_e"], [(params["mu"], params["var"])], x_in)[0]
    view = {"gru": params["gru_e"], "mu": params["mu"], "var": params["var"]}
    return encode_streams_fused([view], x_in)[0]


def cvae_forward(params, eps: torch.Tensor, x_oh, chroma, r_density,
                 n_density, cfg: ModelConfig, train: bool = True,
                 tokens=None, nll_targets=None) -> Dict:
    """reference model_v2.py:399-423. Only the decoder takes the token
    ids: the encoder's input is [one-hot, conditions]. `chroma` is unused,
    as in the reference."""
    mu, std = cvae_encode(params, x_oh, r_density, n_density)
    z = mu + std * eps
    z_full = torch.cat([z, r_density.to(z.dtype), n_density.to(z.dtype)],
                       dim=-1)
    return {**_decode(params, z_full, x_oh, tokens, nll_targets, train),
            "mu": mu, "std": std, "z": z, "z_full": z_full}


# ---------------------------------------------------------------------------
# MusicAttrFaderNets: a CVAE whose latent feeds gradient-reversed
# discriminators (reference model_v2.py:438-586)

FADER_KEEP = 0.7              # dropout(0.3) on the discriminators' outputs


def init_fader(gen: torch.Generator, cfg: ModelConfig) -> Params:
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    cdtl = 2
    p = {"gru_e": bigru_init(gen, V, H),      # the encoder sees no condition
         "mu": linear_init(gen, 2 * H, Z),
         "var": linear_init(gen, 2 * H, Z),
         "discriminator_r": linear_init(gen, Z, 1),
         "discriminator_n": linear_init(gen, Z, 1),
         "c_r": linear_init(gen, Z, 3),       # unused
         "c_n": linear_init(gen, Z, 3)}
    p.update(global_decoder_init(gen, Z + cdtl, V, H))
    return p


def fader_encode(params, x_oh, tokens=None):
    if "enc_e" in params:
        return encode_streams_fused_packed(
            params["enc_e"], [(params["mu"], params["var"])], x_oh,
            tokens=tokens)[0]
    view = {"gru": params["gru_e"], "mu": params["mu"], "var": params["var"]}
    return encode_streams_fused([view], x_oh, tokens=tokens)[0]


def fader_forward(params, eps: torch.Tensor, keep_r: torch.Tensor,
                  keep_n: torch.Tensor, x_oh, chroma, r_density, n_density,
                  cfg: ModelConfig, train: bool = True, tokens=None,
                  nll_targets=None) -> Dict:
    """reference model_v2.py:559-586. The discriminators see a gradient-
    reversed z through ReLU and, when `train`, dropout: keep_r / keep_n
    (B, 1) are its Bernoulli(0.7) keep-masks of 0s and 1s, and a kept unit
    is scaled by 1 / 0.7 (`x * mask / keep`, as the JAX package does). The
    encoder's input is the pure one-hot, so `tokens` routes both the
    encoder and the decoder + CE to their kernels."""
    mu, std = fader_encode(params, x_oh, tokens=tokens)
    z = mu + std * eps
    r_z = grad_reverse(z)
    disc_r = torch.relu(linear_apply(params["discriminator_r"], r_z))
    disc_n = torch.relu(linear_apply(params["discriminator_n"], r_z))
    if train:
        disc_r = disc_r * keep_r / FADER_KEEP
        disc_n = disc_n * keep_n / FADER_KEEP
    z_full = torch.cat([z, r_density.to(z.dtype), n_density.to(z.dtype)],
                       dim=-1)
    return {**_decode(params, z_full, x_oh, tokens, nll_targets, train),
            "disc_r": disc_r, "disc_n": disc_n, "mu": mu, "std": std,
            "z": z, "z_full": z_full}
