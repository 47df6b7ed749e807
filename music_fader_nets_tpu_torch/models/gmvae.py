"""The GM-VAE (counterpart of `music_fader_nets_tpu/models/gmvae.py`): the
RegVAE tree plus the Gaussian-mixture tables, the mixture posterior, the
training forward, encode, and the greedy / sampling token decodes; and the
single-encoder GM-VAE, which the reference defines and never trains.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.modules import (
    global_decoder_greedy,
    global_decoder_init,
    global_decoder_teacher,
)
from music_fader_nets_tpu_torch.models.vae import (
    _global_view,
    global_decode,
    init_reg_vae,
    reg_vae_encode,
    reg_vae_forward,
    single_vae_encode,
)
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.ops.gru import bigru_init, linear_init
from music_fader_nets_tpu_torch.ops.sampling import reparameterize
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


class _SoftmaxBf16(torch.autograd.Function):
    """softmax over the last axis of a bf16 tensor with the JAX package's
    rounding points (its softmax differentiated by JAX): s = exp(x - max)
    and the quotient s / w rounded to bf16, w = the float32 sum of s
    rounded once; the backward (g / w - sum(g * w^-2 * s)) * s, every
    operation rounded, the sum accumulated in bf16 in order, as XLA
    reduces bf16 on the CPU. torch.softmax rounds elsewhere, and under
    mixed precision a one-ulp move of q(y|x) swings the GM-VAE KL's
    gradients."""

    @staticmethod
    def forward(ctx, x):
        s = torch.exp(x - x.max(dim=-1, keepdim=True).values)
        w = s.float().sum(dim=-1, keepdim=True).to(x.dtype)
        ctx.save_for_backward(s, w)
        return s / w

    @staticmethod
    def backward(ctx, g):
        s, w = ctx.saved_tensors
        z = (g * (1.0 / (w * w))) * s
        acc = z[..., :1]
        for k in range(1, z.shape[-1]):
            acc = acc + z[..., k:k + 1]
        return (g / w - acc) * s


def softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis; bf16 with the JAX package's rounding
    (`_SoftmaxBf16`)."""
    if x.dtype == torch.bfloat16:
        return _SoftmaxBf16.apply(x)
    return torch.softmax(x, dim=-1)


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
    return log_logit, softmax(log_logit)


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


# greedy decode's per-step log-probs (B, steps, V)
reg_gmvae_global_decode = global_decode


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


# ---------------------------------------------------------------------------
# MusicAttrSingleGMVAE: one encoder, one mixture table, the decoder on z
# only (reference gmm_model.py:262-442)


def init_single_gmvae(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    H, Z, V = cfg.hidden_dims, cfg.z_dims, cfg.roll_dims
    p = {"gru": bigru_init(gen, V, H),
         "mu": linear_init(gen, 2 * H, Z),
         "var": linear_init(gen, 2 * H, Z),
         "linear_init": linear_init(gen, Z, H)}     # unused, as the reference
    p.update(global_decoder_init(gen, Z, V, H))
    # one mu / logvar table, pow_exp = -1 (reference gmm_model.py:352-372)
    tables = _mixture_tables(gen, cfg.num_clusters, cfg.z_dims, -1.0)
    p["mu_lookup"] = tables["mu_r_lookup"]
    p["logvar_lookup"] = tables["logvar_r_lookup"]
    return p


def single_gmvae_forward(params, eps: torch.Tensor, x_oh, cfg: ModelConfig,
                         train: bool = True, tokens=None) -> Dict:
    """The single GM-VAE's forward (JAX models/gmvae.py:181-202) over the
    canonical tree or the fast layout (`enc_1`); eps (B, z) is the N(0, 1)
    draw of the reparameterisation. Teacher-forced when `train`, through
    the embedded-token encoder and the fused teacher decoder with `tokens`
    (x_oh may then be None); greedy otherwise."""
    mu, std = single_vae_encode(params, x_oh, tokens=tokens)
    z = reparameterize(mu, std, eps)
    log_logit, qy_x = approx_qy_x(z, params["mu_lookup"],
                                  params["logvar_lookup"])
    gview = _global_view(params)
    if train:
        out = global_decoder_teacher(gview, z, x_oh, tokens=tokens)
    else:
        T = tokens.shape[1] if tokens is not None else x_oh.shape[1]
        out = global_decoder_greedy(gview, z, T)
    return {"out": out, "mu": mu, "std": std, "z": z,
            "log_logit": log_logit, "qy_x": qy_x,
            "y": torch.argmax(qy_x, dim=-1)}
