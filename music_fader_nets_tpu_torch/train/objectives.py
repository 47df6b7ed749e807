"""The GM-VAE objective (counterpart of
`music_fader_nets_tpu/train/objectives.py::gmm_loss` and its helpers).

    loss_fn(params, eps, batch, step, cfg) -> (loss, metrics)

`eps` is the pair of N(0, 1) draws (eps_r, eps_n), each (B, z_dims), of
the two reparameterisations; the JAX package draws them inside from its
rng (`jax.random.split(rng)`), the port takes them from the caller.
`batch` holds tensors on one device: x (B, T) tokens, r / n (B, attr_len)
track ids, c (B, 24) chroma, r_density / n_density (B,), and `a` (B,)
arousal labels for the supervised branch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.losses.elbo import anneal_beta, nll_mean
from music_fader_nets_tpu_torch.losses.regularizers import (
    gmm_supervised_kl,
    gmm_unsupervised_kl,
    pati_regularizer,
)
from music_fader_nets_tpu_torch.models import gmvae

Metrics = Dict[str, torch.Tensor]


def _one_hots(batch, cfg: ModelConfig):
    oh = (lambda ids, n: F.one_hot(ids.long(), n).to(torch.float32))
    return (oh(batch["x"], cfg.roll_dims), oh(batch["r"], cfg.rhythm_dims),
            oh(batch["n"], cfg.note_dims))


def _ce_x(fwd, batch):
    """Token-stream CE: the mean of the fused kernel's per-position NLL
    when present (padding included either way, the nll_mean semantics)."""
    if fwd.get("nll_x") is not None:
        return fwd["nll_x"].mean()
    return nll_mean(fwd["out"], batch["x"])


def _recon_ce(fwd, batch):
    return (_ce_x(fwd, batch), nll_mean(fwd["r_out"], batch["r"]),
            nll_mean(fwd["n_out"], batch["n"]))


def gmm_loss(params, eps, batch, step: int, cfg: ModelConfig,
             is_supervised: bool = False, train: bool = True
             ) -> Tuple[torch.Tensor, Metrics]:
    """GM-VAE loss, unsupervised (Yamaha) or supervised (VGMIDI arousal)
    branch (reference trainer_gmm.py:109-196), plus the Pati
    regularization."""
    x_oh, r_oh, n_oh = _one_hots(batch, cfg)
    fwd = gmvae.reg_gmvae_forward(
        params, eps[0], eps[1], x_oh, r_oh, n_oh, batch["c"], cfg,
        train=train, tokens=batch["x"], nll_targets=batch["x"],
        track_ids=(batch["r"], batch["n"]))
    ce_x, ce_r, ce_n = _recon_ce(fwd, batch)
    ce = cfg.ce_x_weight * ce_x + ce_r + ce_n
    beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                        cfg.kl_warmup_steps)
    zero = ce.new_zeros(())
    if not is_supervised:
        kld_lat_r, kld_cls_r = gmm_unsupervised_kl(
            fwd["mu_r"], fwd["std_r"], fwd["qy_x_r"], fwd["log_logit_r"],
            params["mu_r_lookup"], params["logvar_r_lookup"],
            cfg.free_bits)
        kld_lat_n, kld_cls_n = gmm_unsupervised_kl(
            fwd["mu_n"], fwd["std_n"], fwd["qy_x_n"], fwd["log_logit_n"],
            params["mu_n_lookup"], params["logvar_n_lookup"],
            cfg.free_bits)
        loss = ce + beta0 * (kld_lat_r + kld_lat_n + kld_cls_r + kld_cls_n)
        clf = zero
    else:
        y = batch["a"]
        kld_lat_r, clf_r = gmm_supervised_kl(
            fwd["mu_r"], fwd["std_r"], y, fwd["qy_x_r"],
            params["mu_r_lookup"], params["logvar_r_lookup"],
            cfg.free_bits)
        kld_lat_n, clf_n = gmm_supervised_kl(
            fwd["mu_n"], fwd["std_n"], y, fwd["qy_x_n"],
            params["mu_n_lookup"], params["logvar_n_lookup"],
            cfg.free_bits)
        kld_cls_r = kld_cls_n = zero
        clf = clf_r + clf_n
        loss = ce + beta0 * (kld_lat_r + kld_lat_n) + clf
    l_r = pati_regularizer(fwd["z_r"][:, 0], batch["r_density"])
    l_n = pati_regularizer(fwd["z_n"][:, 0], batch["n_density"])
    loss = loss + l_r + l_n
    return loss, {"loss": loss, "CE_X": ce_x, "CE_R": ce_r, "CE_N": ce_n,
                  "l_r": l_r, "l_n": l_n,
                  "kld_latent": kld_lat_r + kld_lat_n,
                  "kld_class": kld_cls_r + kld_cls_n, "clf": clf}
