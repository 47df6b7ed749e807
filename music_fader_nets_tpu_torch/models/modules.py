"""Building blocks of the serving path: the fused bi-GRU encoder streams
and the 2-layer GRUCell global decoder (counterpart of
`music_fader_nets_tpu/models/modules.py`, same parameter names).

The decoder's per-step input is `[one_hot(token), z]`; the z half is
constant across steps, so its projection is computed once, and the one-hot
half's projection is the row `w_tok[token]`.
"""
from __future__ import annotations

from typing import Optional

import torch

from music_fader_nets_tpu_torch.ops.gru import (
    gru_cell_from_pre,
    gru_init,
    linear_apply,
    linear_init,
    multi_gru_final_states,
    multi_gru_final_states_packed,
)


def _heads(finals: torch.Tensor, heads: list):
    out = []
    for i, (mu_p, var_p) in enumerate(heads):
        h = torch.cat([finals[2 * i], finals[2 * i + 1]], dim=-1)
        out.append((linear_apply(mu_p, h), torch.exp(linear_apply(var_p, h))))
    return out


def encode_streams_fused_packed(enc: dict, heads: list,
                                x_oh: Optional[torch.Tensor],
                                tokens: Optional[torch.Tensor] = None):
    """`encode_streams_fused` over pre-stacked encoder weights (`enc` with
    `w_ih_p` (2S, Vp, 3H), `b_ih`, `w_hh`, `b_hh`; directions [s0.fwd,
    s0.bwd, s1.fwd, ...]). heads: [(mu_params, var_params)] per stream."""
    reverse = [False, True] * len(heads)
    finals = multi_gru_final_states_packed(
        enc["w_ih_p"], enc["b_ih"], enc["w_hh"], enc["b_hh"], x_oh, reverse,
        tokens=tokens)                                      # (2S, B, H)
    return _heads(finals, heads)


def encode_streams_fused(views: list, x_oh: Optional[torch.Tensor],
                         tokens: Optional[torch.Tensor] = None):
    """All encoder streams' bi-GRU directions stepped together. Returns a
    list of (mu, stddev) per stream; stddev = exp(logsig), as the
    reference's `var` head predicts log-sigma (model_v2.py:85).
    tokens: (B, T) ids when x_oh is exactly one_hot(tokens) — routes to the
    embedded-token kernel (x_oh may then be None)."""
    params, reverse = [], []
    for v in views:
        params += [v["gru"]["fwd"], v["gru"]["bwd"]]
        reverse += [False, True]
    finals = multi_gru_final_states(params, x_oh, reverse, tokens=tokens)
    return _heads(finals, [(v["mu"], v["var"]) for v in views])


def global_decoder_init(gen: torch.Generator, z_total: int, roll_dims: int,
                        hidden: int) -> dict:
    """2-layer GRUCell decoder (reference model_v2.py:44-49); per-step input
    is `[token_onehot (roll_dims), z (z_total)]`, token first."""
    return {
        "linear_init_global": linear_init(gen, z_total, hidden),
        "grucell_g": gru_init(gen, roll_dims + z_total, hidden),
        "grucell_g_2": gru_init(gen, hidden, hidden),
        "linear_out_g": linear_init(gen, hidden, roll_dims),
    }


def _split_w_ih(p: dict, roll_dims: int):
    w_ih = p["grucell_g"]["w_ih"]                          # (V + Z, 3H)
    return w_ih[:roll_dims], w_ih[roll_dims:]


def _decoder_step(p: dict, pre_x: torch.Tensor, h1: torch.Tensor,
                  h2: torch.Tensor, is_first: bool):
    """One decoder step given the layer-1 input projection. At step 0,
    layer 2's previous hidden is layer 1's NEW state (model_v2.py:130-132).
    Returns (h1', h2', log-probs (B, V))."""
    h1_new = gru_cell_from_pre(p["grucell_g"], pre_x, h1)
    h2_prev = h1_new if is_first else h2
    g2 = p["grucell_g_2"]
    pre2 = h1_new @ g2["w_ih"] + g2["b_ih"]
    h2_new = gru_cell_from_pre(g2, pre2, h2_prev)
    logp = torch.log_softmax(linear_apply(p["linear_out_g"], h2_new), dim=-1)
    return h1_new, h2_new, logp


def global_decoder_greedy(p: dict, z: torch.Tensor, steps: int,
                          feed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Autoregressive greedy decode; returns per-step LOG-PROBS
    (B, steps, V). The next token is the argmax of the log-probs, or
    feed[:, i] when `feed` (B, steps) is given."""
    B = z.shape[0]
    V = p["linear_out_g"]["w"].shape[-1]
    w_tok, w_z = _split_w_ih(p, V)
    pre_z = z @ w_z + p["grucell_g"]["b_ih"]
    h1 = linear_apply(p["linear_init_global"], z)
    h2 = torch.zeros_like(h1)
    tok = torch.full((B,), V - 1, dtype=torch.long, device=z.device)
    logps = []
    for i in range(steps):
        h1, h2, logp = _decoder_step(p, w_tok[tok] + pre_z, h1, h2, i == 0)
        logps.append(logp)
        tok = (torch.argmax(logp, dim=-1) if feed is None
               else feed[:, i].long())
    if not logps:
        return z.new_zeros((B, 0, V))
    return torch.stack(logps, dim=1)
