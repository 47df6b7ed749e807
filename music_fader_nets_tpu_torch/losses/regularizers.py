"""The families' regularizers: Pati, the FaderNets adversarial loss, the
GM-VAE KL terms and GLSR (counterpart of
`music_fader_nets_tpu/losses/regularizers.py`)."""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from music_fader_nets_tpu_torch.losses.elbo import kl_diag_gaussians


def pati_regularizer(z_dim0: torch.Tensor, attr: torch.Tensor
                     ) -> torch.Tensor:
    """MSE(tanh(pairwise delta of z[:, 0]), sign(pairwise delta of attr))
    (reference trainer.py:117-132). z_dim0, attr: (B,)."""
    d_z = z_dim0[:, None] - z_dim0[None, :]
    d_attr = attr[:, None] - attr[None, :]
    return ((torch.tanh(d_z) - torch.sign(d_attr)) ** 2).mean()


def adversarial_fader_loss(step: int, disc_out: torch.Tensor,
                           density: torch.Tensor,
                           lmbda_max: float = 1e-4) -> torch.Tensor:
    """lambda(step) * MSE(discriminator, density), lambda ramping to
    lmbda_max over 2000 steps (reference trainer_fader.py:105-110); the
    gradient-reversal layer in the model makes it adversarial for the
    encoder."""
    lmbda = min(step / 2000.0 * lmbda_max, lmbda_max)
    return lmbda * ((disc_out.squeeze() - density.squeeze()) ** 2).mean()


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


# ---------------------------------------------------------------------------
# GLSR (Hadjeres et al.), reference trainer_glsr.py:118-229

LOG_2PI = math.log(2.0 * math.pi)

# token roles in the 342-token vocabulary (reference trainer_glsr.py:125,
# 133): 2..89 are note-on, 180..277 the time shifts taken as step
# separators; the two masses GLSR reads, as [lo, hi) ranges for the fused
# decoder's masses head (order: played, separators)
GLSR_MASK_RANGES = ((2, 90), (180, 278))


def _masked_mass(log_probs: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(B, T) probability mass of tokens [lo, hi): softmax of the
    log-probs is the probabilities, as in the reference."""
    probs = torch.softmax(log_probs, dim=-1)
    mask = torch.zeros(log_probs.shape[-1], dtype=probs.dtype,
                       device=probs.device)
    mask[lo:hi] = 1.0
    return probs @ mask


def approx_played_notes(log_probs: torch.Tensor) -> torch.Tensor:
    """Soft count of note-on mass per step, (B, T)."""
    return _masked_mass(log_probs, *GLSR_MASK_RANGES[0])


def approx_time_separators(log_probs: torch.Tensor) -> torch.Tensor:
    return _masked_mass(log_probs, *GLSR_MASK_RANGES[1])


def approx_note_density(log_probs: torch.Tensor) -> torch.Tensor:
    """(B,) soft note count: the note-on mass summed over time (reference
    trainer_glsr.py:137-139)."""
    return approx_played_notes(log_probs).sum(-1)


def rhythm_density_from_masses(played: torch.Tensor, sep: torch.Tensor,
                               faithful_batch0: bool = True
                               ) -> torch.Tensor:
    """Soft rhythm density (B,) from (B, T) note-on and separator masses
    (reference trainer_glsr.py:141-171): note-on mass accumulates until a
    separator step (sep >= 0.9, a threshold without gradient, as the
    reference's `.item()` compare), which adds f(cur) = 1 with zero
    gradient when cur > 1e-2, else cur, and resets; the total is divided by
    the sample's separator mass. Stepped in time order, as the JAX
    package's scan. faithful_batch0 keeps the reference's indexing bug:
    every sample accumulates batch element 0's note-on masses
    (trainer_glsr.py:154)."""
    if faithful_batch0:
        played = played[0:1].expand_as(played)
    boundary = sep >= 0.9
    cur = played.new_zeros(played.shape[0])
    total = played.new_zeros(played.shape[0])
    for t in range(played.shape[1]):
        b_t = boundary[:, t]
        cur = cur + torch.where(b_t, 0.0, played[:, t])
        total = total + torch.where(
            b_t, torch.where(cur > 1e-2, torch.ones_like(cur), cur), 0.0)
        cur = torch.where(b_t, 0.0, cur)
    return total / sep.sum(-1)


def approx_rhythm_density(log_probs: torch.Tensor,
                          faithful_batch0: bool = True) -> torch.Tensor:
    return rhythm_density_from_masses(approx_played_notes(log_probs),
                                      approx_time_separators(log_probs),
                                      faithful_batch0)


def glsr_regularizer(masses_fn: Callable, z_r: torch.Tensor,
                     z_n: torch.Tensor, chroma: torch.Tensor,
                     u_r: torch.Tensor, u_n: torch.Tensor,
                     epsilon: float = 1e-2, faithful_batch0: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GLSR finite-difference latent supervision (reference
    trainer_glsr.py:173-229): dim 0 of each stream's z is moved by +-delta,
    delta = (1 + u) * epsilon with u ~ U[0, 1) of shape (B,) given by the
    caller (u_r, u_n), the four perturbed latents are decoded as ONE batch
    of 4B rows [r+, r-, n+, n-], d(attribute)/dz is estimated by central
    difference, and -log N(grad; 0, 1) is the penalty. Returns (l_r, l_n).

    `masses_fn(z_full) -> (played (4B, T), sep (4B, T))`: the attributes
    read only note-on and separator masses, which the fused decoder's
    masses head gives without the (4B, T, V) log-probs."""
    d_r = (1.0 + u_r) * epsilon
    d_n = (1.0 + u_n) * epsilon

    def moved(z, d):
        return torch.cat([z[:, :1] + d[:, None], z[:, 1:]], dim=-1)

    z_all = torch.cat([
        torch.cat([moved(z_r, d_r), z_n, chroma], dim=-1),
        torch.cat([moved(z_r, -d_r), z_n, chroma], dim=-1),
        torch.cat([z_r, moved(z_n, d_n), chroma], dim=-1),
        torch.cat([z_r, moved(z_n, -d_n), chroma], dim=-1)], dim=0)
    played, sep = masses_fn(z_all)
    pl_rp, pl_rm, pl_np, pl_nm = played.chunk(4, dim=0)
    sp_rp, sp_rm = sep[:2 * z_r.shape[0]].chunk(2, dim=0)
    rd_p = rhythm_density_from_masses(pl_rp, sp_rp, faithful_batch0)
    rd_m = rhythm_density_from_masses(pl_rm, sp_rm, faithful_batch0)
    nd_p, nd_m = pl_np.sum(-1), pl_nm.sum(-1)

    def loss_of(a_p, a_m, deltas):
        grad_attr = (a_p - a_m).squeeze() / (2.0 * deltas)
        return (0.5 * grad_attr ** 2 + 0.5 * LOG_2PI).mean()

    return loss_of(rd_p, rd_m, d_r), loss_of(nd_p, nd_m, d_n)
