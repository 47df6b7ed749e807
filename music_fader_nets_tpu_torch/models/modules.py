"""Building blocks of the model families: the bi-GRU encoder streams
(one, or all of a model's fused), the teacher-forced attribute
sub-decoders (one, or a model's pair fused) and the 2-layer GRUCell
global decoder (counterpart of `music_fader_nets_tpu/models/modules.py`,
same parameter names).

The decoder's per-step input is `[one_hot(token), z]`; the z half is
constant across steps, so its projection is computed once, and the one-hot
half's projection is the row `w_tok[token]`.
"""
from __future__ import annotations

from typing import Optional

import torch

from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import (
    bigru_apply,
    bigru_init,
    gru_cell_from_pre,
    gru_init,
    gru_scan,
    linear_apply,
    linear_init,
    multi_gru_final_states,
    multi_gru_final_states_packed,
    stacked_gru_seq,
)


def encoder_stream_init(gen: torch.Generator, in_dim: int, hidden: int,
                        z_dims: int) -> dict:
    """One encoder stream: a bi-GRU and the mu / logsig heads."""
    return {"gru": bigru_init(gen, in_dim, hidden),
            "mu": linear_init(gen, 2 * hidden, z_dims),
            "var": linear_init(gen, 2 * hidden, z_dims)}


def encoder_stream_apply(p: dict, x_oh: torch.Tensor):
    """x_oh (B, T, V) -> (mu, stddev), stddev = exp(logsig) (the
    reference's `var` head predicts log-sigma, model_v2.py:85). The bi-GRU
    is one L=2 recurrence over the hoisted projection (`bigru_apply`):
    kernel 1 on CUDA tensors, kernel 2 under autograd."""
    h = bigru_apply(p["gru"], x_oh)                         # (B, 2H)
    return linear_apply(p["mu"], h), torch.exp(linear_apply(p["var"], h))


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


def _sub_heads(outs, out_r, out_n, faithful_softmax_axis: bool):
    """Log-probs of both tracks from h_seq (2, T, B, H). With
    `faithful_softmax_axis` the log-softmax runs over the TIME axis (dim 1
    of (B, T, C)), the reference's `F.log_softmax(..., 1)` quirk
    (model_v2.py:109,114), kept on purpose."""
    dim = 1 if faithful_softmax_axis else -1
    r_logits = linear_apply(out_r, outs[0].transpose(0, 1))
    n_logits = linear_apply(out_n, outs[1].transpose(0, 1))
    return (torch.log_softmax(r_logits, dim=dim),
            torch.log_softmax(n_logits, dim=dim))


def sub_decoder_init(gen: torch.Generator, z_dims: int, track_dims: int,
                     hidden: int) -> dict:
    return {"gru": gru_init(gen, z_dims + track_dims, hidden),
            "init": linear_init(gen, z_dims, hidden),
            "out": linear_init(gen, hidden, track_dims)}


def sub_decoder_apply(p: dict, track_oh: torch.Tensor, z: torch.Tensor,
                      faithful_softmax_axis: bool = True) -> torch.Tensor:
    """One teacher-forced attribute sub-decoder (reference
    model_v2.py:99-116): step input [track_onehot_t, z], h0 =
    linear_init(z), the recurrence through `gru_scan` (kernel 1 on CUDA
    tensors, kernel 2 under autograd). Log-probs (B, T, C), taken in
    float32 over the TIME axis with `faithful_softmax_axis` (the
    reference's `F.log_softmax(..., 1)` quirk), else over the classes."""
    B, T, _ = track_oh.shape
    z_rep = z[:, None, :].expand(B, T, z.shape[-1])
    outs, _ = gru_scan(p["gru"], torch.cat([track_oh, z_rep], dim=-1),
                       linear_apply(p["init"], z))
    logits = linear_apply(p["out"], outs).to(torch.float32)
    return torch.log_softmax(logits, dim=1 if faithful_softmax_axis else -1)


def sub_decoder_pair_apply(p_r: dict, p_n: dict, r_oh, n_oh, z_r, z_n,
                           faithful_softmax_axis: bool = True):
    """Both teacher-forced attribute sub-decoders over the canonical layout
    (views with `gru`, `init`, `out`; reference model_v2.py:99-116): step
    input [track_onehot_t, z], h0 = linear_init(z), the two recurrences
    stepped together through the generic stacked-GRU wrapper (kernels 1/2
    on CUDA tensors, their plain version on the CPU)."""
    B, T, _ = r_oh.shape

    def pre_of(p, track_oh, z):
        z_rep = z[:, None, :].expand(B, T, z.shape[-1])
        pre = torch.cat([track_oh, z_rep], dim=-1) @ p["gru"]["w_ih"]
        return (pre + p["gru"]["b_ih"]).transpose(0, 1)      # (T, B, 3H)

    pre = torch.stack([pre_of(p_r, r_oh, z_r), pre_of(p_n, n_oh, z_n)])
    w_hh = torch.stack([p_r["gru"]["w_hh"], p_n["gru"]["w_hh"]])
    b_hh = torch.stack([p_r["gru"]["b_hh"], p_n["gru"]["b_hh"]])
    h0 = torch.stack([linear_apply(p_r["init"], z_r),
                      linear_apply(p_n["init"], z_n)])
    outs = stacked_gru_seq(pre, w_hh, b_hh, h0)              # (2, T, B, H)
    return _sub_heads(outs, p_r["out"], p_n["out"], faithful_softmax_axis)


def sub_decoder_pair_apply_packed(sub: dict, init_r, init_n, out_r, out_n,
                                  r_oh, n_oh, z_r, z_n,
                                  faithful_softmax_axis: bool = True,
                                  track_ids=None):
    """`sub_decoder_pair_apply` over the fast-layout `sub_rn` group
    (models/fast.py: w_ih (2, Dm+Z, 3H), input rows [track padded to Dm,
    z]).

    track_ids: optional ((B,T) rhythm ids, (B,T) note ids) with
    r_oh/n_oh = one_hot(ids): routes to the class-embedded kernel
    (`ops/cuda_gru.py::stacked_gru_embed_seq`), whose input projection is
    the row w_ih[class] plus the per-sequence prez = z @ w_z + b_ih."""
    B, T, _ = r_oh.shape
    Z = z_r.shape[-1]
    dm = sub["w_ih"].shape[1] - Z
    h0 = torch.stack([linear_apply(init_r, z_r), linear_apply(init_n, z_n)])
    if track_ids is not None:
        w_emb = sub["w_ih"][:, :dm]                            # (2, Dm, 3H)
        w_z = sub["w_ih"][:, dm:]                              # (2, Z, 3H)
        prez = (torch.bmm(torch.stack([z_r, z_n]), w_z)
                + sub["b_ih"][:, None, :])                     # (2, B, 3H)
        cls_lt = torch.stack([ids.to(torch.int32).t()
                              for ids in track_ids])           # (2, T, B)
        outs = cuda_gru.stacked_gru_embed_seq(cls_lt, w_emb, prez,
                                              sub["w_hh"], sub["b_hh"], h0)
        return _sub_heads(outs, out_r, out_n, faithful_softmax_axis)

    def inp(track_oh, z):
        pad = dm - track_oh.shape[-1]
        if pad:
            track_oh = torch.cat(
                [track_oh, track_oh.new_zeros((B, T, pad))], dim=-1)
        return torch.cat([track_oh, z[:, None, :].expand(B, T, Z)], dim=-1)

    x = torch.stack([inp(r_oh, z_r), inp(n_oh, z_n)])         # (2,B,T,Dm+Z)
    pre = (torch.einsum("lbti,lig->ltbg", x, sub["w_ih"])
           + sub["b_ih"][:, None, None, :])
    outs = stacked_gru_seq(pre, sub["w_hh"], sub["b_hh"], h0)
    return _sub_heads(outs, out_r, out_n, faithful_softmax_axis)


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
    g = p["grucell_g"]
    if "w_tok_p" in g:                  # fast layout: split and padded
        return g["w_tok_p"][:roll_dims], g["w_z"]
    w_ih = g["w_ih"]                                       # (V + Z, 3H)
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


def global_decoder_teacher(p: dict, z: torch.Tensor,
                           x_oh: Optional[torch.Tensor],
                           tokens: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Teacher-forced decode over the whole sequence: inputs [start, x_0,
    ..., x_{T-2}] with the start one-hot at the LAST vocab index, outputs
    predict [x_0, ..., x_{T-1}] (reference model_v2.py:127-142 with
    eps=100). Returns log-probs (B, T, V).

    With `tokens` (B, T) ids (x_oh = one_hot(tokens), and may then be
    None) both layers advance in the fused teacher decoder
    (`ops/cuda_decoder.py::decoder_teacher_fused`: kernels 7/8 on CUDA
    tensors, their plain version on the CPU), the token row gathered
    instead of multiplied, and the logits head is one product over all
    T*B rows, as the JAX package's TPU path does (models/modules.py:
    317-324).

    Without `tokens`, teacher forcing decouples the two layers into two
    consecutive recurrences over hoisted projections, each one generic
    stacked-GRU call (kernels 1/2 on CUDA tensors, their plain version on
    the CPU; JAX models/modules.py:336-347); layer 2 starts from layer 1's
    first state (the reference's step-0 rule)."""
    if tokens is not None:
        V = p["linear_out_g"]["w"].shape[-1]
        h2_bt = cuda_decoder.decoder_teacher_fused(p, z, tokens, V)
        return torch.log_softmax(linear_apply(p["linear_out_g"], h2_bt),
                                 dim=-1)
    B, T, V = x_oh.shape
    w_tok, w_z = _split_w_ih(p, V)
    start = x_oh.new_zeros((B, 1, V))
    start[:, 0, V - 1] = 1.0
    inputs = torch.cat([start, x_oh[:, :-1]], dim=1)
    pre_z = z @ w_z + p["grucell_g"]["b_ih"]
    pre = (inputs @ w_tok + pre_z[:, None, :]).transpose(0, 1)   # (T,B,3H)
    cell1, cell2 = p["grucell_g"], p["grucell_g_2"]
    h1_0 = linear_apply(p["linear_init_global"], z)
    h1_seq = stacked_gru_seq(pre[None], cell1["w_hh"][None],
                             cell1["b_hh"][None], h1_0[None])[0]  # (T,B,H)
    pre2 = h1_seq @ cell2["w_ih"] + cell2["b_ih"]
    h2_seq = stacked_gru_seq(pre2[None], cell2["w_hh"][None],
                             cell2["b_hh"][None], h1_seq[:1])[0]
    logits = linear_apply(p["linear_out_g"], h2_seq.transpose(0, 1))
    return torch.log_softmax(logits, dim=-1)


def global_decoder_scheduled(p: dict, z: torch.Tensor, x_oh: torch.Tensor,
                             coins: torch.Tensor) -> torch.Tensor:
    """Scheduled-sampling decode (reference model_v2.py:135-140; JAX
    models/modules.py:425-457): at step t the coin for the whole batch,
    coins[t], picks the teacher's input (True) or the model's own argmax
    of the previous step (False). coins is a (T,) bool tensor, drawn by
    the caller as `torch.rand(T, generator=gen) < eps` (the JAX package
    draws `uniform(rng, (T,)) < eps` inside). All-True coins reproduce
    `global_decoder_teacher`, all-False the greedy decode. No kernel in
    either package: a loop over `_decoder_step`. Returns log-probs
    (B, T, V)."""
    B, T, V = x_oh.shape
    w_tok, w_z = _split_w_ih(p, V)
    pre_z = z @ w_z + p["grucell_g"]["b_ih"]
    start = x_oh.new_zeros((B, 1, V))
    start[:, 0, V - 1] = 1.0
    teacher = torch.cat([start, x_oh[:, :-1]], dim=1)
    teacher_pre = (teacher @ w_tok + pre_z[:, None, :]).transpose(0, 1)
    h1 = linear_apply(p["linear_init_global"], z)
    h2 = torch.zeros_like(h1)
    tok = torch.full((B,), V - 1, dtype=torch.long, device=z.device)
    coins = coins.tolist()
    logps = []
    for t in range(T):
        pre_t = teacher_pre[t] if coins[t] else w_tok[tok] + pre_z
        h1, h2, logp = _decoder_step(p, pre_t, h1, h2, t == 0)
        logps.append(logp)
        tok = torch.argmax(logp, dim=-1)
    if not logps:
        return z.new_zeros((B, 0, V))
    return torch.stack(logps, dim=1)


def global_decoder_teacher_nll(p: dict, z: torch.Tensor, x_oh, tokens,
                               targets) -> torch.Tensor:
    """Per-position NLL (B, T) of the teacher-forced decode, padding
    included (`nll_mean` before the mean). With `tokens` (x_oh =
    one_hot(tokens)) it runs the fused decoder + CE kernel
    (`ops/cuda_decoder.py`; its plain version on the CPU), and the
    (B, T, V) log-probs never exist; otherwise the plain teacher decode and
    a gather."""
    if tokens is not None:
        V = p["linear_out_g"]["w"].shape[-1]
        return cuda_decoder.decoder_teacher_fused_nll(p, z, tokens, V)
    logp = global_decoder_teacher(p, z, x_oh)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def global_decoder_teacher_masses(p: dict, z: torch.Tensor, x_oh, tokens,
                                  ranges, n_rep: int = 1):
    """Per-step softmax masses of the teacher-forced decode over vocabulary
    ranges: a tuple of (B, T) tensors, out_k[b, t] = sum over [lo_k, hi_k)
    of softmax(logits[b, t]), what the GLSR regularizer reads of its
    perturbation decodes (reference trainer_glsr.py:123-139). z has B =
    n_rep * B0 rows, n_rep copies sharing the B0 teacher sequences of x_oh
    / tokens. With `tokens` (x_oh = one_hot(tokens)) it runs the fused
    decoder with the masses head (`ops/cuda_decoder.py`; its plain version
    on the CPU); otherwise the teacher decode and masked sums of its
    softmax, the tokens tiled n_rep-fold."""
    if tokens is not None:
        V = p["linear_out_g"]["w"].shape[-1]
        return cuda_decoder.decoder_teacher_fused_masses(p, z, tokens, V,
                                                         ranges, n_rep)
    if n_rep > 1:
        x_oh = x_oh.repeat(n_rep, 1, 1)
    probs = torch.softmax(global_decoder_teacher(p, z, x_oh), dim=-1)
    return tuple(probs[..., lo:hi].sum(-1) for lo, hi in ranges)
