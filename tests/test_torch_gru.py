"""PyTorch port, GRU primitives and the embedded-token encoder: the port's
functions against the JAX package's on the same numpy inputs (CPU; the
JAX encoder kernel runs in Pallas interpret mode).

Tolerance 1e-5: float32 gate maths whose exp/tanh implementations and
matmul summation orders differ between XLA and PyTorch by a few ulps per
step, over at most 12 steps of a contracting recurrence."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.ops import gru as jgru
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.ops import cuda_gru
from music_fader_nets_tpu_torch.ops import gru as tgru

ATOL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run pallas_call through the interpreter, as tests/test_pallas_gru.py
    does."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _dirs(rng, L, V, H):
    """L per-direction GRU param dicts as numpy (U(-k, k), k=1/sqrt(H))."""
    k = 1.0 / np.sqrt(H)
    return [{n: rng.uniform(-k, k, s).astype(np.float32)
             for n, s in (("w_ih", (V, 3 * H)), ("w_hh", (H, 3 * H)),
                          ("b_ih", (3 * H,)), ("b_hh", (3 * H,)))}
            for _ in range(L)]


def _to_t(tree):
    return [{k: torch.from_numpy(v) for k, v in d.items()} for d in tree]


def test_gate_maths_matches_jax():
    rng = np.random.default_rng(0)
    H = 16
    pre_x, pre_h = (rng.standard_normal((5, 3 * H)).astype(np.float32) * 2
                    for _ in range(2))
    h = rng.standard_normal((5, H)).astype(np.float32)
    want = np.asarray(jgru._gates(pre_x, pre_h, h, H))
    got = tgru._gates(*(torch.from_numpy(a) for a in (pre_x, pre_h, h)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)

    p = _dirs(rng, 1, 7, H)[0]
    x = rng.standard_normal((5, 7)).astype(np.float32)
    pre = x @ p["w_ih"] + p["b_ih"]
    want = np.asarray(jgru.gru_cell_from_pre(p, pre, h))
    got = tgru.gru_cell_from_pre(_to_t([p])[0], torch.from_numpy(pre),
                                 torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("via_tokens", [False, True],
                         ids=["one-hot-scan", "token-embed"])
def test_multi_gru_final_states_matches_jax(via_tokens):
    """4 directions (two reversed) over one one-hot sequence: the port's
    scan path and its token path both equal the JAX scan."""
    rng = np.random.default_rng(1)
    L, B, T, V, H = 4, 3, 9, 342, 32
    params = _dirs(rng, L, V, H)
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    x = np.eye(V, dtype=np.float32)[tokens]
    reverse = [False, True, False, True]
    want = np.asarray(jgru.multi_gru_final_states(params, x, reverse))
    got = tgru.multi_gru_final_states(
        _to_t(params), None if via_tokens else torch.from_numpy(x), reverse,
        tokens=torch.from_numpy(tokens) if via_tokens else None)
    assert got.shape == (L, B, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("oob", [False, True], ids=["in-vocab", "oob-token"])
def test_embed_finals_plain_matches_pallas_kernel(pallas_interpret, oob):
    """cuda_gru.stacked_gru_embed_finals on CPU tensors (the plain version)
    against the JAX Pallas kernel in interpret mode, with a reversed
    direction. An id past the padded table selects no row in both (a
    one-hot of an out-of-range id is all zeros)."""
    rng = np.random.default_rng(2)
    L, B, T, V, H = 2, 4, 12, 342, 32
    params = _dirs(rng, L, V, H)
    w_ih_p, b_ih, w_hh, b_hh = (t.numpy() for t in
                                tgru.stack_directions(_to_t(params)))
    assert w_ih_p.shape == (L, 384, 3 * H)
    assert not w_ih_p[:, V:].any()                 # zero pad rows
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    if oob:
        tokens[1, 3] = 384 + 7
    tok_lt = tgru.direction_tokens(torch.from_numpy(tokens), [False, True])
    h0 = rng.standard_normal((L, B, H)).astype(np.float32) * 0.5
    want = np.asarray(pallas_gru.stacked_gru_embed_finals(
        jnp.asarray(tok_lt.numpy()), w_ih_p, b_ih, w_hh, b_hh, h0))
    got = cuda_gru.stacked_gru_embed_finals(
        tok_lt, *(torch.from_numpy(a) for a in (w_ih_p, b_ih, w_hh, b_hh,
                                                h0)))
    assert cuda_gru.LAST_ENCODE_PATH == "plain-cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_direction_tokens_flip_contract():
    """Reversed directions consume the sequence right-to-left: their (T, B)
    slab is the time-flipped token matrix (ops/gru.py:220-222)."""
    tokens = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    tok_lt = tgru.direction_tokens(tokens, [False, True])
    assert tok_lt.dtype == torch.int32 and tok_lt.shape == (2, 3, 2)
    assert tok_lt[0].tolist() == [[0, 3], [1, 4], [2, 5]]
    assert tok_lt[1].tolist() == [[2, 5], [1, 4], [0, 3]]


def test_embed_wrapper_refuses_non_cpu_tensors():
    """The plain version is taken only for CPU tensors: any other device
    must launch the kernel or raise, never fall back."""
    L, T, B, H = 1, 2, 1, 4
    meta = dict(device="meta")
    args = (torch.zeros((L, T, B), dtype=torch.int32, **meta),
            torch.zeros((L, 128, 3 * H), **meta),
            torch.zeros((L, 3 * H), **meta),
            torch.zeros((L, H, 3 * H), **meta),
            torch.zeros((L, 3 * H), **meta),
            torch.zeros((L, B, H), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gru.stacked_gru_embed_finals(*args)
    mixed = (torch.zeros((L, T, B), dtype=torch.int32),) + args[1:]
    with pytest.raises(ValueError, match="several devices"):
        cuda_gru.stacked_gru_embed_finals(*mixed)


def test_init_distributions_match_torch_defaults():
    """gru_init / linear_init draw U(-1/sqrt(fan), 1/sqrt(fan)) in the
    input-major layout of the JAX package."""
    gen = torch.Generator().manual_seed(0)
    p = tgru.gru_init(gen, 20, 64)
    assert p["w_ih"].shape == (20, 192) and p["w_hh"].shape == (64, 192)
    assert p["b_ih"].shape == (192,) and p["b_hh"].shape == (192,)
    bound = 1.0 / np.sqrt(64)
    for t in p.values():
        assert t.dtype == torch.float32
        assert float(t.abs().max()) <= bound
    lin = tgru.linear_init(gen, 100, 7)
    assert lin["w"].shape == (100, 7)
    assert float(lin["w"].abs().max()) <= 0.1
    x = torch.randn(3, 100, generator=gen)
    np.testing.assert_allclose(tgru.linear_apply(lin, x).numpy(),
                               (x @ lin["w"] + lin["b"]).numpy())
