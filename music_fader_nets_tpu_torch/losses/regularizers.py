"""The GM-VAE KL terms and the Pati attribute regularizer (counterpart of
`music_fader_nets_tpu/losses/regularizers.py:26-104`)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from music_fader_nets_tpu_torch.losses.elbo import kl_diag_gaussians


def pati_regularizer(z_dim0: torch.Tensor, attr: torch.Tensor
                     ) -> torch.Tensor:
    """MSE(tanh(pairwise delta of z[:, 0]), sign(pairwise delta of attr))
    (reference trainer.py:117-132). z_dim0, attr: (B,)."""
    d_z = z_dim0[:, None] - z_dim0[None, :]
    d_attr = attr[:, None] - attr[None, :]
    return ((torch.tanh(d_z) - torch.sign(d_attr)) ** 2).mean()


def gmm_unsupervised_kl(mu, std, qy_x, log_logit, mu_lookup, logvar_lookup,
                        free_bits: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_k qy_x[:, k] KL[q(z|x) || p(z|k)] and KL[q(y|x) || Uniform]
    (reference trainer_gmm.py:150-178), with its reductions: the latent KL
    is the per-sample mean over D, weighted, batch-meaned, summed over K;
    the class term takes a mean over K. The scale of component k is
    exp(logvar) (trainer_gmm.py:156); the logvar table gets no gradient."""
    std_p = torch.exp(logvar_lookup.detach())
    kl = kl_diag_gaussians(mu[:, None, :], std[:, None, :], mu_lookup[None],
                           std_p[None])                          # (B, K, D)
    if free_bits > 0.0:
        kl = torch.clamp(kl, min=free_bits)
    kld_lat = (kl.mean(-1) * qy_x).mean(0).sum()
    n_component = qy_x.shape[-1]
    h = (qy_x * torch.log_softmax(log_logit, dim=-1)).mean(-1)
    kld_cls = (h - math.log(1.0 / n_component)).mean()
    return kld_lat, kld_cls


def gmm_supervised_kl(mu, std, y_label, qy_x, mu_lookup, logvar_lookup,
                      free_bits: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL[q(z|x) || p(z|y)] and CE(qy_x, y) (reference
    trainer_gmm.py:180-194). The reference feeds the softmax PROBABILITIES
    qy_x to `nn.CrossEntropyLoss`, which applies a second log_softmax: kept
    on purpose."""
    y = y_label.long()
    std_p = torch.exp(logvar_lookup.detach())[y]
    kl = kl_diag_gaussians(mu, std, mu_lookup[y], std_p)
    if free_bits > 0.0:
        kl = torch.clamp(kl, min=free_bits)
    kld_lat = kl.mean(-1).mean()
    log_q = torch.log_softmax(qy_x, dim=-1)              # double softmax
    return kld_lat, -log_q.gather(1, y[:, None]).mean()
