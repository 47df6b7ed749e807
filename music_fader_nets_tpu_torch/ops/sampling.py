"""Sampling ops: greedy one-hot feedback, the reparameterised latent,
per-row Gumbel noise and the gradient reversal layer.

JAX's PRNG streams cannot be reproduced in PyTorch, so `reparameterize`
takes its standard-normal noise explicitly and the Gumbel noise comes from
one `torch.Generator` per row, seeded by that row's request seed."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def argmax_one_hot(logits: torch.Tensor) -> torch.Tensor:
    """Greedy feedback (reference model_v2.py:72-79 `_sampling`): the
    one-hot of the argmax class, in the logits' dtype. Ties take the first
    maximal index, as `jnp.argmax` does."""
    idx = torch.argmax(logits, dim=-1)
    return torch.nn.functional.one_hot(idx, logits.shape[-1]).to(
        logits.dtype)


def reparameterize(mu: torch.Tensor, std: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + std * eps (reference model_v2.py:152-158); `std` is
    exp(logsig), eps ~ N(0, 1) supplied by the caller."""
    return mu + std * eps


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Gradient reversal layer (reference model_v2.py:426-435
    `ReverseLayerF`): identity forward, `-alpha * g` backward; drives the
    FaderNets discriminators adversarially without a second optimizer."""
    return _GradReverse.apply(x, alpha)


def gumbel_rows(seeds: Sequence[Optional[int]], steps: int, width: int,
                device: torch.device) -> torch.Tensor:
    """(steps, len(seeds), width) float32 Gumbel(0, 1) noise; column b is
    drawn from its own generator seeded with seeds[b], so a row's noise
    depends only on its seed, never on its batch position. A None seed
    gives a zero column (a greedy row)."""
    tiny = torch.finfo(torch.float32).tiny
    out = torch.zeros((steps, len(seeds), width), dtype=torch.float32,
                      device=device)
    for b, seed in enumerate(seeds):
        if seed is None:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        u = torch.rand((steps, width), generator=gen, dtype=torch.float32,
                       device=device).clamp_(min=tiny)
        out[:, b] = -torch.log(-torch.log(u))
    return out
