"""Plain PyTorch pieces shared by the configurations' references: the
arithmetic mode, the GRU cell and recurrences, the 2-layer teacher-forced
decoder, the losses' terms, and the optimizer (global-norm clip and Adam).

Written from the model's definition (Music FaderNets, reference
`model_v2.py` / `gmm_model.py` and the trainers), in float32, with no
kernel, no cache and no batching of the program's. Imports nothing but
torch: never JAX, the JAX package or the port.

Layouts are the canonical tree's: weights input-major (`w_ih (I, 3H)`,
`w_hh (H, 3H)`), gate order r, z, n; a linear layer is {"w" (in, out),
"b" (out,)}.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

Tree = Dict


class Arith:
    """How the reference multiplies: float32 with TF32 off (the
    configurations' precision), or TF32 (`tf32=True`, the control: the
    nearest precision below). On CUDA the TF32 mode is cuBLAS's own,
    switched on while the object is entered; on the CPU, where there is
    none, every matmul operand is rounded to TF32's 10-bit mantissa
    first (the forward only; the backward passes the gradient straight
    through)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = bool(tf32)
        self._saved = None

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self._saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
        m.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self._saved

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32 and a.device.type == "cpu":
            a, b = _round_tf32(a), _round_tf32(b)
        return torch.matmul(a, b)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to 10 bits (TF32), gradient
    passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach()


def linear(ar: Arith, p: Tree, x: torch.Tensor) -> torch.Tensor:
    return ar.mm(x, p["w"]) + p["b"]


def gru_gates(pre_x: torch.Tensor, pre_h: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """h' from the input and hidden projections (torch.nn.GRUCell's
    equations): r, z = sigmoid(x + h parts), n = tanh(x_n + r * h_n),
    h' = (1 - z) * n + z * h."""
    xr, xz, xn = pre_x.chunk(3, dim=-1)
    hr, hz, hn = pre_h.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def recurrence(ar: Arith, pre: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """GRUs stepped over time: pre (..., T, B, 3H) input projections,
    w_hh (..., H, 3H), b_hh (..., 3H), h0 (..., B, H). Returns every
    step's state (..., T, B, H)."""
    h, out = h0, []
    b = b_hh.unsqueeze(-2)
    for t in range(pre.shape[-3]):
        h = gru_gates(pre[..., t, :, :], ar.mm(h, w_hh) + b, h)
        out.append(h)
    return torch.stack(out, dim=-3)


def bigru_finals(ar: Arith, grus: List[Tree], x: torch.Tensor
                 ) -> List[torch.Tensor]:
    """Bidirectional GRUs over one input x (B, T, I), stepped together:
    for each {"fwd", "bwd"} in `grus`, the concatenated final states
    (B, 2H) of the forward direction after x[:, T-1] and of the backward
    one after consuming x right to left (`nn.GRU(bidirectional=True)`'s
    h_n)."""
    dirs = [g[d] for g in grus for d in ("fwd", "bwd")]
    w_ih = torch.stack([d["w_ih"] for d in dirs])             # (L, I, 3H)
    pre = ar.mm(x.unsqueeze(0), w_ih.unsqueeze(1))            # (L, B, T, 3H)
    pre = pre + torch.stack([d["b_ih"] for d in dirs])[:, None, None, :]
    pre = torch.stack([p.flip(1) if i % 2 else p
                       for i, p in enumerate(pre)]).transpose(1, 2)
    B, H = x.shape[0], dirs[0]["w_hh"].shape[0]
    h0 = x.new_zeros((len(dirs), B, H))
    finals = recurrence(ar, pre, torch.stack([d["w_hh"] for d in dirs]),
                        torch.stack([d["b_hh"] for d in dirs]), h0)[:, -1]
    return [torch.cat([finals[2 * i], finals[2 * i + 1]], dim=-1)
            for i in range(len(grus))]


def encoder_heads(ar: Arith, mu_p: Tree, var_p: Tree, h: torch.Tensor):
    """(mu, std): the `var` head predicts log-sigma (model_v2.py:85)."""
    return linear(ar, mu_p, h), torch.exp(linear(ar, var_p, h))


def sub_decoder(ar: Arith, gru: Tree, init: Tree, out: Tree,
                track_ids: torch.Tensor, n_classes: int, z: torch.Tensor
                ) -> torch.Tensor:
    """A teacher-forced attribute sub-decoder (model_v2.py:99-116): step
    input [one_hot(track), z], h0 = init(z); log-softmax over the TIME
    axis, the reference's `F.log_softmax(out, 1)`. Returns (B, Ta, C)."""
    B, Ta = track_ids.shape
    oh = F.one_hot(track_ids.long(), n_classes).to(z.dtype)
    x = torch.cat([oh, z[:, None, :].expand(B, Ta, z.shape[-1])], dim=-1)
    pre = (ar.mm(x, gru["w_ih"]) + gru["b_ih"]).transpose(0, 1)
    h_seq = recurrence(ar, pre, gru["w_hh"], gru["b_hh"],
                       linear(ar, init, z)).transpose(0, 1)
    return torch.log_softmax(linear(ar, out, h_seq), dim=1)


def nll_mean(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """F.nll_loss over all positions, padding included."""
    lp = log_probs.reshape(-1, log_probs.shape[-1])
    return -lp.gather(1, targets.reshape(-1, 1).long()).mean()


def _decoder_inputs(ar: Arith, p: Tree, z: torch.Tensor, V: int):
    """The decoder's per-sequence parts: the token rows' weight, the z
    half of layer 1's input projection with its bias, and h1's start."""
    w_ih = p["grucell_g"]["w_ih"]                              # (V + Zt, 3H)
    pre_z = ar.mm(z, w_ih[V:]) + p["grucell_g"]["b_ih"]
    return w_ih[:V], pre_z, linear(ar, p["linear_init_global"], z)


def decoder_teacher_nll(ar: Arith, p: Tree, z: torch.Tensor,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the 2-layer GRUCell decoder teacher-forced on `tokens`
    (B, T) (model_v2.py:119-142 with eps=100): inputs [start, x_0, ...,
    x_{T-2}], the start token the last vocabulary index; at step 0 layer
    2's previous state is layer 1's new one."""
    B, T = tokens.shape
    V = p["linear_out_g"]["w"].shape[1]
    w_tok, pre_z, h1 = _decoder_inputs(ar, p, z, V)
    start = tokens.new_full((B, 1), V - 1)
    inp = F.one_hot(torch.cat([start, tokens[:, :-1]], 1).long(), V)
    pre1 = ar.mm(inp.to(z.dtype), w_tok) + pre_z[:, None, :]   # (B, T, 3H)
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    h1_seq = recurrence(ar, pre1.transpose(0, 1), g1["w_hh"], g1["b_hh"], h1)
    pre2 = ar.mm(h1_seq, g2["w_ih"]) + g2["b_ih"]
    h2_seq = recurrence(ar, pre2, g2["w_hh"], g2["b_hh"], h1_seq[0])
    logits = linear(ar, p["linear_out_g"], h2_seq.transpose(0, 1))
    return nll_mean(torch.log_softmax(logits, dim=-1), tokens)


def decoder_fed_logits(ar: Arith, p: Tree, z: torch.Tensor,
                       feed: torch.Tensor) -> Iterator[torch.Tensor]:
    """The decoder's logits (B, V) at each step, the token fed back at
    step i being feed[:, i-1] (the start token at step 0): what a greedy
    decode that emitted `feed` saw at each step."""
    B, S = feed.shape
    V = p["linear_out_g"]["w"].shape[1]
    w_tok, pre_z, h1 = _decoder_inputs(ar, p, z, V)
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    tok = feed.new_full((B,), V - 1).long()
    h2 = None
    for i in range(S):
        h1 = gru_gates(w_tok[tok] + pre_z, ar.mm(h1, g1["w_hh"]) + g1["b_hh"],
                       h1)
        h2_prev = h1 if i == 0 else h2
        h2 = gru_gates(ar.mm(h1, g2["w_ih"]) + g2["b_ih"],
                       ar.mm(h2_prev, g2["w_hh"]) + g2["b_hh"], h2_prev)
        yield linear(ar, p["linear_out_g"], h2)
        tok = feed[:, i].long()


def kl_std_normal(mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Mean over every element of KL(N(mu, std) || N(0, 1))."""
    return (-torch.log(std) + 0.5 * (std ** 2 + mu ** 2) - 0.5).mean()


def anneal_beta(step: int, beta: float) -> float:
    """The reference's KL weight at `step` (trainer.py:93-96): 0 before
    step 1000, then min((step - 10000) / 10000 * beta, beta), negative
    between steps 1000 and 10000, as the reference has it."""
    if step < 1000:
        return 0.0
    return min((step - 10000.0) / 10000.0 * beta, beta)


def pati(z_dim0: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """MSE(tanh(pairwise delta of z[:, 0]), sign(pairwise delta of the
    attribute)) (trainer.py:117-132)."""
    d_z = z_dim0[:, None] - z_dim0[None, :]
    d_a = attr[:, None] - attr[None, :]
    return ((torch.tanh(d_z) - torch.sign(d_a)) ** 2).mean()


# ------------------------------------------------------------ parameters

def leaves(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, tensor) of every leaf, in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_leaves(pairs) -> Tree:
    tree: Tree = {}
    for path, t in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def gru_spec(name: str, in_dim: int, H: int, used: bool = True):
    """A GRU direction's leaves, each U(-1/sqrt(H), 1/sqrt(H))."""
    b = 1.0 / math.sqrt(H)
    return [((*name.split("/"), k), shape, ("uniform", b), used)
            for k, shape in (("w_ih", (in_dim, 3 * H)),
                             ("w_hh", (H, 3 * H)), ("b_ih", (3 * H,)),
                             ("b_hh", (3 * H,)))]


def linear_spec(name: str, in_dim: int, out_dim: int, used: bool = True):
    """A linear layer's leaves, U(-1/sqrt(in), 1/sqrt(in))."""
    b = 1.0 / math.sqrt(in_dim)
    return [((name, "w"), (in_dim, out_dim), ("uniform", b), used),
            ((name, "b"), (out_dim,), ("uniform", b), used)]


def decoder_spec(z_total: int, V: int, H: int):
    """The global decoder's leaves (model_v2.py:44-49)."""
    return (linear_spec("linear_init_global", z_total, H)
            + gru_spec("grucell_g", V + z_total, H)
            + gru_spec("grucell_g_2", H, H)
            + linear_spec("linear_out_g", H, V))


# ------------------------------------------------------------- optimizer

def clip_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm: g * max_norm / norm when norm >=
    max_norm."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class Adam:
    """Adam as optax.adam: m, v the biased moments, the update lr * m_hat
    / (sqrt(v_hat) + eps)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: Dict = {}
        self.v: Dict = {}

    def step(self, params: Dict, grads: Dict) -> Dict:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            v = (self.b2 * self.v.get(k, torch.zeros_like(g))
                 + (1 - self.b2) * g * g)
            self.m[k], self.v[k] = m, v
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out
