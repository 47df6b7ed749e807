"""GRU primitives in PyTorch, with the JAX package's layouts.

Weights are input-major (`w_ih (I, 3H)`, `w_hh (H, 3H)`), gate order is
(r, z, n), and the forward is `x @ w` with no transposes — the layout of
`music_fader_nets_tpu/ops/gru.py`, so parameters carry across unchanged.

Cell math (identical to `torch.nn.GRUCell`):
    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

GRU_GATES = 3
LANE = 128


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def gru_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    """One GRU direction / cell; every tensor ~ U(-k, k), k = 1/sqrt(H)
    (the `torch.nn.GRU` init)."""
    bound = 1.0 / math.sqrt(hidden)
    return {
        "w_ih": _uniform(gen, (in_dim, GRU_GATES * hidden), bound),
        "w_hh": _uniform(gen, (hidden, GRU_GATES * hidden), bound),
        "b_ih": _uniform(gen, (GRU_GATES * hidden,), bound),
        "b_hh": _uniform(gen, (GRU_GATES * hidden,), bound),
    }


def bigru_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    return {"fwd": gru_init(gen, in_dim, hidden),
            "bwd": gru_init(gen, in_dim, hidden)}


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> dict:
    """Dense layer; weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (the `torch.nn.Linear` init)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (in_dim, out_dim), bound),
            "b": _uniform(gen, (out_dim,), bound)}


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# the JAX package's alias of `linear_apply`
linear = linear_apply


def _gates(pre_x: torch.Tensor, pre_h: torch.Tensor,
           h: torch.Tensor) -> torch.Tensor:
    """Gate math given precomputed input and hidden projections
    (`pre_x = x @ w_ih + b_ih`, `pre_h = h @ w_hh + b_hh`, both (..., 3H))."""
    xr, xz, xn = pre_x.chunk(3, dim=-1)
    hr, hz, hn = pre_h.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step: x (B, I), h (B, H) -> h' (B, H). Plain torch ops on
    any device, as the JAX package computes it outside any kernel."""
    return gru_cell_from_pre(p, x @ p["w_ih"] + p["b_ih"], h)


def gru_cell_from_pre(p: dict, pre_x: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """GRU step when the input projection was already computed."""
    pre_h = h @ p["w_hh"] + p["b_hh"]
    return _gates(pre_x, pre_h, h)


def stacked_gru_seq(pre: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """L independent GRUs of equal length, stepped together.
    pre (L, T, B, 3H) hoisted input projections (reversed directions
    already time-flipped); w_hh (L, H, 3H); b_hh (L, 3H); h0 (L, B, H).
    Returns every step's state, h_seq (L, T, B, H): the generic stacked-GRU
    kernels on CUDA tensors, their plain version on CPU tensors
    (`ops/cuda_stacked.py`)."""
    from music_fader_nets_tpu_torch.ops import cuda_stacked
    return cuda_stacked.stacked_gru(pre, w_hh, b_hh, h0)


def stacked_gru_scan(pre: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """`stacked_gru_seq`'s final states (L, B, H)."""
    if pre.shape[1] == 0:
        return h0
    return stacked_gru_seq(pre, w_hh, b_hh, h0)[:, -1]


def gru_scan(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
             reverse: bool = False):
    """One GRU over a whole sequence: x (B, T, I) -> (outs (B, T, H),
    h_final (B, H)); h0 None means zeros of x's dtype.

    The input projection x @ w_ih + b_ih of all T steps is one matmul; the
    recurrence is one `stacked_gru_seq` call at L=1 (kernel 1 on CUDA
    tensors, `StackedGRU` with kernel 2 when a float input wants a
    gradient; the plain version on the CPU). With `reverse` the GRU
    consumes x right to left, as `lax.scan(reverse=True)` does in the JAX
    package: outs[:, t] is the state after the step that consumed x[:, t]
    (input order), and h_final the state after t = 0."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[0]
    if h0 is None:
        h0 = x.new_zeros((B, H))
    if T == 0:
        return x.new_zeros((B, 0, H)), h0
    pre = (torch.matmul(x, p["w_ih"]) + p["b_ih"]).transpose(0, 1)  # T,B,3H
    if reverse:
        pre = pre.flip(0)
    h_seq = stacked_gru_seq(pre[None], p["w_hh"][None], p["b_hh"][None],
                            h0[None])[0]                         # (T, B, H)
    h_final = h_seq[-1]
    if reverse:
        h_seq = h_seq.flip(0)
    return h_seq.transpose(0, 1), h_final


def bigru_final_state(p_fwd: dict, p_bwd: dict,
                      x: torch.Tensor) -> torch.Tensor:
    """Bidirectional GRU, the concatenated final states (B, 2H):
    `nn.GRU(bidirectional=True)(x)[-1]` as the reference reshapes it
    (model_v2.py:83-85), the forward direction's state after the last
    step, then the backward direction's after consuming x right to left.
    Both directions are one L=2 recurrence (the backward one over the
    time-flipped input): one kernel-1 launch on CUDA tensors."""
    finals = multi_gru_final_states([p_fwd, p_bwd], x, [False, True])
    return torch.cat([finals[0], finals[1]], dim=-1)


def bigru_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return bigru_final_state(p["fwd"], p["bwd"], x)


def vocab_pad(V: int) -> int:
    """Vp = ceil128(V), the kernels' padded vocabulary width."""
    return ((V + LANE - 1) // LANE) * LANE


def pad_vocab(w_ih: torch.Tensor) -> torch.Tensor:
    """(..., V, G) -> (..., Vp, G); pad rows are zero and never selected
    (tokens are < V)."""
    V = w_ih.shape[-2]
    Vp = vocab_pad(V)
    if Vp == V:
        return w_ih
    pad = w_ih.new_zeros(w_ih.shape[:-2] + (Vp - V, w_ih.shape[-1]))
    return torch.cat([w_ih, pad], dim=-2)


def direction_tokens(tokens: torch.Tensor, reverse: List[bool]) -> torch.Tensor:
    """(B, T) token ids -> (L, T, B) int32, time-flipped for every reversed
    direction (the contract of the embedded-token kernel)."""
    tok_t = tokens.to(torch.int32).transpose(0, 1)                 # (T, B)
    return torch.stack([tok_t.flip(0) if r else tok_t
                        for r in reverse]).contiguous()


def multi_gru_final_states_packed(w_ih_p: torch.Tensor, b_ih: torch.Tensor,
                                  w_hh: torch.Tensor, b_hh: torch.Tensor,
                                  x: Optional[torch.Tensor], reverse: list,
                                  tokens: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Final hidden states of L same-shaped GRUs over the SAME input
    sequence, taking pre-stacked weights.

    w_ih_p: (L, Vp, 3H), input dim padded to Vp = ceil128(V), pad rows zero.
    b_ih/b_hh: (L, 3H); w_hh: (L, H, 3H); reverse: L bools (True = consume
    the input right-to-left).
    tokens: optional (B, T) ids when `x` is exactly one_hot(tokens); routes
    to the embedded-token kernel (`ops/cuda_gru.py`), which gathers the
    input projection row `w_ih[tok]` itself — `x` may then be None.
    Returns (L, B, H); for reversed directions, the state after consuming
    the whole sequence (the torch `h_n` entry)."""
    L, H = w_hh.shape[0], w_hh.shape[1]
    if tokens is not None:
        from music_fader_nets_tpu_torch.ops import cuda_gru
        tok_lt = direction_tokens(tokens, reverse)
        h0 = w_hh.new_zeros((L, tokens.shape[0], H))
        return cuda_gru.stacked_gru_embed_finals(
            tok_lt, w_ih_p, b_ih, w_hh, b_hh, h0)

    B, T, V = x.shape
    w_ih = w_ih_p[:, :V]
    x_dir = torch.stack([x.flip(1) if r else x for r in reverse])
    pre = torch.einsum("lbti,lig->ltbg", x_dir, w_ih) + b_ih[:, None, None, :]
    h0 = x.new_zeros((L, B, H))
    return stacked_gru_scan(pre, w_hh, b_hh, h0)


def stack_directions(params: list):
    """List of L per-direction GRU dicts -> (w_ih_p, b_ih, w_hh, b_hh)
    stacked, with w_ih padded to Vp."""
    w_ih_p = pad_vocab(torch.stack([p["w_ih"] for p in params]))
    b_ih = torch.stack([p["b_ih"] for p in params])
    w_hh = torch.stack([p["w_hh"] for p in params])
    b_hh = torch.stack([p["b_hh"] for p in params])
    return w_ih_p, b_ih, w_hh, b_hh


def multi_gru_final_states(params: list, x: Optional[torch.Tensor],
                           reverse: list,
                           tokens: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`multi_gru_final_states_packed` over a list of per-direction GRU
    param dicts: stacks and pads them, then delegates."""
    return multi_gru_final_states_packed(*stack_directions(params), x,
                                         reverse, tokens=tokens)
