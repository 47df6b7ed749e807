"""The six families' objectives (counterpart of
`music_fader_nets_tpu/train/objectives.py`), one per reference trainer
script: vanilla (trainer.py), gmm (trainer_gmm.py), glsr (trainer_glsr.py),
cvae (trainer_cvae.py), fader (trainer_fader.py), singlevae
(trainer_singlevae.py).

    loss_fn(params, eps, batch, step, cfg) -> (loss, metrics)

`eps` is the tuple of the objective's random draws, which the JAX package
draws inside from its rng and the port takes from the caller
(`draw_noise` makes them for the Trainer):

    vanilla, gmm  (eps_r, eps_n), N(0, 1) of (B, z)
    glsr          (eps_r, eps_n, u_r, u_n), u ~ U[0, 1) of (B,)
    cvae          (eps,), N(0, 1) of (B, z)
    fader         (eps, keep_r, keep_n), keep ~ Bernoulli(0.7) of (B, 1)
    singlevae     (eps,), N(0, 1) of (B, 2z)

`batch` holds tensors on one device: x (B, T) tokens, r / n (B, attr_len)
track ids, c (B, 24) chroma, r_density / n_density (B,), and `a` (B,)
arousal labels for the supervised branch.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.losses.elbo import (
    anneal_beta,
    kl_std_normal,
    nll_mean,
)
from music_fader_nets_tpu_torch.losses.regularizers import (
    GLSR_MASK_RANGES,
    adversarial_fader_loss,
    glsr_regularizer,
    gmm_supervised_kl,
    gmm_unsupervised_kl,
    pati_regularizer,
)
from music_fader_nets_tpu_torch.models import gmvae, vae
from music_fader_nets_tpu_torch.models.modules import (
    global_decoder_teacher_masses,
)

Metrics = Dict[str, torch.Tensor]


def _one_hots(batch, cfg: ModelConfig):
    """One-hots in the batch's float dtype (chroma's): float32 in training,
    float64 for a float64 witness of the plain path."""
    oh = (lambda ids, n: F.one_hot(ids.long(), n).to(batch["c"].dtype))
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


def vanilla_loss(params, eps, batch, step: int, cfg: ModelConfig,
                 train: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """ELBO + Pati attribute regularization (reference trainer.py:87-132)."""
    x_oh, r_oh, n_oh = _one_hots(batch, cfg)
    fwd = vae.reg_vae_forward(
        params, eps[0], eps[1], x_oh, r_oh, n_oh, batch["c"], cfg,
        train=train, tokens=batch["x"], nll_targets=batch["x"],
        track_ids=(batch["r"], batch["n"]))
    ce_x, ce_r, ce_n = _recon_ce(fwd, batch)
    ce = cfg.ce_x_weight * ce_x + ce_r + ce_n
    kld = (kl_std_normal(fwd["mu_r"], fwd["std_r"], cfg.free_bits)
           + kl_std_normal(fwd["mu_n"], fwd["std_n"], cfg.free_bits))
    beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                        cfg.kl_warmup_steps)
    l_r = pati_regularizer(fwd["z_r"][:, 0], batch["r_density"])
    l_n = pati_regularizer(fwd["z_n"][:, 0], batch["n_density"])
    loss = ce + beta0 * kld + l_r + l_n
    return loss, {"loss": loss, "CE_X": ce_x, "CE_R": ce_r, "CE_N": ce_n,
                  "l_r": l_r, "l_n": l_n, "KLD": kld}


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


def glsr_loss(params, eps, batch, step: int, cfg: ModelConfig,
              train: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Vanilla ELBO + the GLSR finite-difference regularizer (reference
    trainer_glsr.py:87-229). The perturbation decodes are teacher-forced
    (the reference model is in training mode then), one batch of 4B rows
    through the fused decoder's masses head, and the regularizer counts
    only at step > 20 (trainer_glsr.py:253): before that it is computed and
    multiplied by 0, as the JAX package does."""
    x_oh, r_oh, n_oh = _one_hots(batch, cfg)
    fwd = vae.reg_vae_forward(
        params, eps[0], eps[1], x_oh, r_oh, n_oh, batch["c"], cfg,
        train=train, tokens=batch["x"], nll_targets=batch["x"],
        track_ids=(batch["r"], batch["n"]))
    ce_x, ce_r, ce_n = _recon_ce(fwd, batch)
    ce = cfg.ce_x_weight * ce_x + ce_r + ce_n
    kld = (kl_std_normal(fwd["mu_r"], fwd["std_r"], cfg.free_bits)
           + kl_std_normal(fwd["mu_n"], fwd["std_n"], cfg.free_bits))
    beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                        cfg.kl_warmup_steps)
    steps = min(cfg.eval_decode_steps, x_oh.shape[1])
    gview = vae._global_view(params)

    def masses_fn(z_full):
        # the 4 perturbation copies share their teacher tokens (n_rep)
        n_rep = z_full.shape[0] // x_oh.shape[0]
        return global_decoder_teacher_masses(
            gview, z_full, x_oh[:, :steps], batch["x"][:, :steps],
            GLSR_MASK_RANGES, n_rep=n_rep)

    l_r, l_n = glsr_regularizer(masses_fn, fwd["z_r"], fwd["z_n"],
                                batch["c"], eps[2], eps[3],
                                faithful_batch0=cfg.faithful_glsr_batch0)
    gate = 1.0 if step > 20 else 0.0
    loss = ce + beta0 * kld + gate * (l_r + l_n)
    return loss, {"loss": loss, "CE_X": ce_x, "CE_R": ce_r, "CE_N": ce_n,
                  "l_r": gate * l_r, "l_n": gate * l_n, "KLD": kld}


def _densities(batch):
    return batch["r_density"][:, None], batch["n_density"][:, None]


def cvae_loss(params, eps, batch, step: int, cfg: ModelConfig,
              train: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """CE_X + annealed KLD only (reference trainer_cvae.py:84-102)."""
    x_oh = _one_hots(batch, cfg)[0]
    rd, nd = _densities(batch)
    fwd = vae.cvae_forward(params, eps[0], x_oh, batch["c"], rd, nd, cfg,
                           train=train, tokens=batch["x"],
                           nll_targets=batch["x"])
    ce_x = _ce_x(fwd, batch)
    kld = kl_std_normal(fwd["mu"], fwd["std"], cfg.free_bits)
    beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                        cfg.kl_warmup_steps)
    loss = ce_x + beta0 * kld
    return loss, {"loss": loss, "CE_X": ce_x, "KLD": kld}


def fader_loss(params, eps, batch, step: int, cfg: ModelConfig,
               train: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """CVAE loss + the ramped adversarial MSE through the gradient-reversed
    discriminators (reference trainer_fader.py:84-135)."""
    x_oh = _one_hots(batch, cfg)[0]
    rd, nd = _densities(batch)
    fwd = vae.fader_forward(params, eps[0], eps[1], eps[2], x_oh,
                            batch["c"], rd, nd, cfg, train=train,
                            tokens=batch["x"], nll_targets=batch["x"])
    ce_x = _ce_x(fwd, batch)
    kld = kl_std_normal(fwd["mu"], fwd["std"], cfg.free_bits)
    beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                        cfg.kl_warmup_steps)
    l_adv_r = adversarial_fader_loss(step, fwd["disc_r"], rd)
    l_adv_n = adversarial_fader_loss(step, fwd["disc_n"], nd)
    loss = ce_x + beta0 * kld + l_adv_r + l_adv_n
    return loss, {"loss": loss, "CE_X": ce_x, "KLD": kld,
                  "l_adv_r": l_adv_r, "l_adv_n": l_adv_n}


def singlevae_loss(params, eps, batch, step: int, cfg: ModelConfig,
                   train: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """5 * CE_X + beta * KLD with the RAW beta, no annealing (reference
    trainer_singlevae.py:107), + Pati regularization of z[:, 0] (rhythm)
    and z[:, 1] (note) of the one latent (trainer_singlevae.py:110-123).
    kl_warmup_steps > 0 (an extension) still replaces that constant with
    the linear warmup, as in the JAX package."""
    x_oh = _one_hots(batch, cfg)[0]
    fwd = vae.single_vae_forward(params, eps[0], x_oh, batch["c"], cfg,
                                 train=train, tokens=batch["x"],
                                 nll_targets=batch["x"])
    ce_x = _ce_x(fwd, batch)
    kld = kl_std_normal(fwd["mu"], fwd["std"], cfg.free_bits)
    l_r = pati_regularizer(fwd["z"][:, 0], batch["r_density"])
    l_n = pati_regularizer(fwd["z"][:, 1], batch["n_density"])
    if cfg.kl_warmup_steps > 0:
        beta0 = anneal_beta(step, cfg.beta, cfg.faithful_negative_beta,
                            cfg.kl_warmup_steps)
    else:
        beta0 = cfg.beta
    loss = cfg.ce_x_weight * ce_x + beta0 * kld + l_r + l_n
    return loss, {"loss": loss, "CE_X": ce_x, "KLD": kld,
                  "l_r": l_r, "l_n": l_n}


# ---------------------------------------------------------------- noise

def _normal_pair(gen, B, cfg):
    eps = torch.randn((2, B, cfg.z_dims), generator=gen)
    return eps[0], eps[1]


def _glsr_draws(gen, B, cfg):
    return _normal_pair(gen, B, cfg) + tuple(torch.rand((2, B),
                                                        generator=gen))


def _fader_draws(gen, B, cfg):
    keep = (torch.rand((2, B, 1), generator=gen) < vae.FADER_KEEP).float()
    return torch.randn((B, cfg.z_dims), generator=gen), keep[0], keep[1]


# what each objective draws, as (generator, B, cfg) -> tuple of tensors
DRAWS = {
    vanilla_loss: _normal_pair,
    gmm_loss: _normal_pair,
    glsr_loss: _glsr_draws,
    cvae_loss: lambda gen, B, cfg: (torch.randn((B, cfg.z_dims),
                                                generator=gen),),
    fader_loss: _fader_draws,
    singlevae_loss: lambda gen, B, cfg: (torch.randn((B, 2 * cfg.z_dims),
                                                     generator=gen),),
}


def draw_noise(loss_fn, gen: torch.Generator, B: int,
               cfg: ModelConfig) -> tuple:
    """The random draws `eps` of one call of `loss_fn` (one of the six
    objectives, or a functools.partial of one) at batch size B, from
    `gen`."""
    while isinstance(loss_fn, functools.partial):
        loss_fn = loss_fn.func
    if loss_fn not in DRAWS:
        raise ValueError(f"no noise rule for {loss_fn!r}")
    return DRAWS[loss_fn](gen, B, cfg)
