"""ELBO terms (counterpart of `music_fader_nets_tpu/losses/elbo.py`,
reference trainer.py:87-114)."""
from __future__ import annotations

import torch


def anneal_beta(step: int, beta: float, faithful: bool = True,
                warmup_steps: int = 0) -> float:
    """KL annealing schedule (reference trainer.py:93-96). faithful=True
    keeps the reference's quirk that `min((step - 10000) / 10000 * beta,
    beta)` is NEGATIVE for steps in (1000, 10000); faithful=False clamps it
    at 0. warmup_steps > 0 (an extension) replaces the schedule with a
    linear 0 -> beta warmup. `step` is the host's step count."""
    if warmup_steps > 0:
        return beta * min(max(step / float(warmup_steps), 0.0), 1.0)
    if step < 1000:
        return 0.0
    ramp = min((step - 10000.0) / 10000.0 * beta, beta)
    return ramp if faithful else max(ramp, 0.0)


def nll_mean(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """`F.nll_loss(logp.view(-1, C), t.view(-1))`: the mean over ALL
    positions, padding included, as the reference (trainer.py:98-103)."""
    lp = log_probs.reshape(-1, log_probs.shape[-1])
    t = targets.reshape(-1).long()
    return -lp.gather(1, t[:, None])[:, 0].mean()


def kl_std_normal(mu: torch.Tensor, std: torch.Tensor,
                  free_bits: float = 0.0) -> torch.Tensor:
    """Mean KL(N(mu, std) || N(0, 1)) over every element (reference
    trainer.py:107-112); free_bits > 0 floors each element's KL first."""
    kl = -torch.log(std) + 0.5 * (std ** 2 + mu ** 2) - 0.5
    if free_bits > 0.0:
        kl = torch.clamp(kl, min=free_bits)
    return kl.mean()


def kl_diag_gaussians(mu_q, std_q, mu_p, std_p) -> torch.Tensor:
    """Elementwise KL(N(mu_q, std_q) || N(mu_p, std_p)); the caller
    reduces."""
    return (torch.log(std_p / std_q)
            + (std_q ** 2 + (mu_q - mu_p) ** 2) / (2.0 * std_p ** 2) - 0.5)
