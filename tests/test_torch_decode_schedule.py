"""PyTorch port, the schedule of the persistent decode kernel
(`csrc/decode.cu::decode_chain`) written out in plain PyTorch and held
against the JAX package's Pallas decode kernels in interpret mode
(`music_fader_nets_tpu/ops/pallas_decode.py::_decode_kernel` :83 and
`::_sample_kernel` :116), at a small size (H=32, 16 steps).

The reference runs a step as layer 1, layer 2, logits. The kernel moves
two hidden products: layer 1's h1 @ w_hh1 does not depend on the token, so
the kernel computes it from h1' in the same pass as layer 2's input
product h1' @ w_ih2 (one read of h1'), keeps it for the next step, and
starts the call with h1_0 @ w_hh1; layer 2's h2p @ w_hh2 needs only the
previous step's h2, so from step 1 on the kernel computes it in phase A,
while the grid meets at the barrier. A step is then three phases between
grid barriers:

A. layer 1's gates: w_tok[token] + pre_z, and the kept h1 @ w_hh1 + b_hh1;
   from step 1 on, h2 @ w_hh2 (h2 of the previous step);
B. h1' @ w_ih2 and h1' @ w_hh1 for the next step, and at step 0, where the
   reference's step-0 rule makes h2p = h1', h1' @ w_hh2; layer 2's gates;
C. the logits, their sampling epilogue and argmax (lowest index on ties).

Tokens must match EXACTLY: the head is sharpened (as tests/test_pallas_
decode.py does) so no step is a near-tie; sampled tokens with the same
numpy Gumbel noise and per-row 1/T on both sides. The scores hold to the
plain loop's (`cuda_decode.decode_scores_plain`) at 1e-5 (float32, the
same products taken at another time). Starting the kept product from zeros
instead of h1_0 @ w_hh1 misses the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.models.modules import (
    global_decoder_init as j_decoder_init,
)
from music_fader_nets_tpu.ops import pallas_decode as jpd
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.ops.gru import _gates
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

V, H, Z = 342, 32, 2 * 8 + 24
VP = 384
STEPS = 16


@pytest.fixture(scope="module")
def gview():
    p = j_decoder_init(jax.random.PRNGKey(3), Z, V, H)
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 8.0
    return jax.tree.map(np.asarray, p)


def _schedule(args, steps, noise=None, inv_t=None, start="h1_0"):
    """The kernel's phases A, B, C a step: (tokens (B, steps), scores
    (steps, B, Vp)). `start` is what the kept h1 @ w_hh1 of step 0 is
    taken from."""
    (w_tok, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2, b_hh2,
     w_out, b_out, pre_z, h1_0) = args
    B = pre_z.shape[0]
    h1, h2 = h1_0, torch.zeros_like(h1_0)
    ph1 = (h1_0 if start == "h1_0" else torch.zeros_like(h1_0)) @ w_hh1
    tok = torch.full((B,), V - 1, dtype=torch.long)
    toks, scores = [], []
    for i in range(steps):
        # A: layer 1's gates; then layer 2's hidden product of the previous
        # step's h2
        h1 = _gates(w_tok[tok] + pre_z, ph1 + b_hh1, h1)
        if i > 0:
            ph2 = h2 @ w_hh2
        # B: the products over h1' (at step 0 also h2p = h1' @ w_hh2);
        # layer 2's gates
        if i == 0:
            ph2 = h1 @ w_hh2
        px2, ph1 = h1 @ w_ih2, h1 @ w_hh1
        h2 = _gates(px2 + b_ih2, ph2 + b_hh2, h1 if i == 0 else h2)
        # C: logits, sampling epilogue, argmax
        sc = h2 @ w_out + b_out
        if noise is not None:
            sc = sc * inv_t[:, None] + noise[i]
        tok = torch.argmax(sc, dim=-1)
        toks.append(tok)
        scores.append(sc)
    return torch.stack(toks, dim=1).to(torch.int32), torch.stack(scores)


def _z(B, seed):
    return np.random.default_rng(seed).standard_normal((B, Z)).astype(
        np.float32)


@pytest.mark.parametrize("B", [1, 5, 64])
def test_greedy_schedule_matches_pallas_interpret(gview, B):
    z = _z(B, 30 + B)
    want = np.asarray(jpd.pallas_greedy_decode(gview, jnp.asarray(z), STEPS,
                                               interpret=True))
    args, v, _ = cuda_decode._prep_decode_args(params_from_numpy(gview),
                                               torch.from_numpy(z))
    assert v == V
    got, scores = _schedule(args, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = torch.stack([sc for _, sc in cuda_decode.decode_scores_plain(
        args, V, STEPS)])
    torch.testing.assert_close(scores, plain, rtol=0, atol=1e-5)


def test_sample_schedule_matches_pallas_interpret(gview):
    """Same numpy Gumbel noise and per-row 1/T on both sides; rows 1 and 3
    are greedy rows (inv_t = 1, zero noise) inside a sampled batch and
    decode as the greedy schedule does."""
    B = 5
    rng = np.random.default_rng(17)
    z = _z(B, 19)
    noise = rng.gumbel(size=(STEPS, B, VP)).astype(np.float32)
    inv_t = np.array([1 / 0.9, 1.0, 1 / 1.5, 1.0, 1 / 0.5], np.float32)
    noise[:, [1, 3]] = 0.0
    want = np.asarray(jpd.pallas_sample_decode(
        gview, jnp.asarray(z), jnp.asarray(noise), jnp.asarray(inv_t[:, None]),
        STEPS, interpret=True))
    args, _, _ = cuda_decode._prep_decode_args(params_from_numpy(gview),
                                               torch.from_numpy(z))
    got, _ = _schedule(args, STEPS, torch.from_numpy(noise),
                       torch.from_numpy(inv_t))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy, _ = _schedule(args, STEPS)
    np.testing.assert_array_equal(got.numpy()[[1, 3]],
                                  greedy.numpy()[[1, 3]])


def test_schedule_from_a_zero_product_misses(gview):
    """The kept h1 @ w_hh1 of step 0 must come from h1_0: from zeros the
    first step's layer 1 already differs from the reference."""
    z = _z(4, 5)
    want = np.asarray(jpd.pallas_greedy_decode(gview, jnp.asarray(z), STEPS,
                                               interpret=True))
    args, _, _ = cuda_decode._prep_decode_args(params_from_numpy(gview),
                                               torch.from_numpy(z))
    got, scores = _schedule(args, STEPS, start="zeros")
    plain = torch.stack([sc for _, sc in cuda_decode.decode_scores_plain(
        args, V, STEPS)])
    assert float((scores[0] - plain[0]).abs().max()) > 1e-3
    assert not np.array_equal(got.numpy(), want)
