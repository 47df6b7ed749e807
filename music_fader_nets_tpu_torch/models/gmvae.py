"""The GM-VAE (counterpart of `music_fader_nets_tpu/models/gmvae.py`): the
RegVAE tree plus the Gaussian-mixture tables, the mixture posterior, the
training forward, encode, and the greedy / sampling token decodes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.vae import (
    _global_view,
    init_reg_vae,
    reg_vae_encode,
    reg_vae_forward,
)
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to


LOG_2PI = math.log(2.0 * math.pi)


def _xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _mixture_tables(gen: torch.Generator, n_component: int, z_dims: int,
                    pow_exp: float) -> Dict:
    """mu: Xavier-uniform; logvar: constant 2 * pow_exp (reference
    gmm_model.py:151-184)."""
    init_logvar = 2.0 * pow_exp
    return {
        "mu_r_lookup": _xavier_uniform(gen, (n_component, z_dims)),
        "mu_n_lookup": _xavier_uniform(gen, (n_component, z_dims)),
        "logvar_r_lookup": torch.full((n_component, z_dims), init_logvar),
        "logvar_n_lookup": torch.full((n_component, z_dims), init_logvar),
    }


def init_reg_gmvae(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    p = init_reg_vae(gen, cfg)
    # pow_exp = -2 (reference gmm_model.py:71)
    p.update(_mixture_tables(gen, cfg.num_clusters, cfg.z_dims, -2.0))
    return p


def approx_qy_x(z: torch.Tensor, mu_lookup: torch.Tensor,
                logvar_lookup: torch.Tensor):
    """q(y|x) ~= p(y|z) over the mixture components (reference
    gmm_model.py:194-218), over all K at once. z (B, D); lookups (K, D).
    The logvar table is frozen: no gradient reaches it. Returns
    (log_logit (B, K), qy_x (B, K))."""
    logvar = logvar_lookup.detach()
    diff2 = (z[:, None, :] - mu_lookup[None]) ** 2                 # (B, K, D)
    llh = -0.5 * (diff2 / torch.exp(logvar)[None] + logvar[None] + LOG_2PI)
    log_logit = llh.sum(-1) + math.log(1.0 / mu_lookup.shape[0])
    return log_logit, torch.softmax(log_logit, dim=-1)


def reg_gmvae_forward(params, eps_r: torch.Tensor, eps_n: torch.Tensor,
                      x_oh, r_oh, n_oh, chroma, cfg: ModelConfig,
                      train: bool = True, tokens=None, nll_targets=None,
                      track_ids=None) -> Dict:
    """The training-path forward (reference gmm_model.py:220-259): the
    RegVAE forward (`models/vae.py::reg_vae_forward`, same arguments) and
    the mixture posterior of both latents."""
    fwd = reg_vae_forward(params, eps_r, eps_n, x_oh, r_oh, n_oh, chroma,
                          cfg, train=train, tokens=tokens,
                          nll_targets=nll_targets, track_ids=track_ids)
    log_logit_r, qy_x_r = approx_qy_x(fwd["z_r"], params["mu_r_lookup"],
                                      params["logvar_r_lookup"])
    log_logit_n, qy_x_n = approx_qy_x(fwd["z_n"], params["mu_n_lookup"],
                                      params["logvar_n_lookup"])
    return {**fwd, "log_logit_r": log_logit_r, "qy_x_r": qy_x_r,
            "log_logit_n": log_logit_n, "qy_x_n": qy_x_n,
            "y_r": torch.argmax(qy_x_r, dim=-1),
            "y_n": torch.argmax(qy_x_n, dim=-1)}


def reg_gmvae_encode(params, tokens: torch.Tensor, device=None):
    """Encode (B, T) token ids -> ((mu_r, std_r), (mu_n, std_n)) on
    `device` (default CUDA; RuntimeError without one unless
    device='cpu'), through the embedded-token encoder."""
    dev = resolve_device(device)
    tokens = tokens.to(dev)
    V = params["gru_r"]["fwd"]["w_ih"].shape[0]
    if tokens.numel() and (tokens.min() < 0 or tokens.max() >= V):
        raise ValueError(f"token ids must be in [0, {V})")
    return reg_vae_encode(tree_to(params, dev), None, tokens=tokens)


def reg_gmvae_decode_tokens(params, z: torch.Tensor, steps: int,
                            device=None) -> torch.Tensor:
    """Greedy token decode, (B, steps) int32."""
    return cuda_decode.greedy_decode_tokens(_global_view(params), z, steps,
                                            device)


def reg_gmvae_sample_tokens(params, z: torch.Tensor, steps: int,
                            seeds: Sequence[int],
                            temperature: float = 1.0,
                            device: Optional[str] = None) -> torch.Tensor:
    """Gumbel-max sampling decode (a serving addition; the reference only
    decodes greedily). temperature <= 0 is greedy."""
    return cuda_decode.sample_decode_tokens(_global_view(params), z, steps,
                                            seeds, temperature, device)
