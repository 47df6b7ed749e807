"""PyTorch port, decode: the plain versions behind `cuda_decode`'s
wrappers (CPU tensors) against the JAX Pallas decode kernels in interpret
mode, on the same numpy weights, z and noise.

Tokens must match EXACTLY: the head is sharpened (as
tests/test_pallas_decode.py does) so no step is a near-tie that float32
reduction-order noise between XLA and PyTorch could flip. Log-probs hold
to 1e-4, the repo's float32 forward bound (parity.py::check_forward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.models.modules import (
    global_decoder_greedy as j_greedy_logp,
    global_decoder_init as j_decoder_init,
)
from music_fader_nets_tpu.ops import pallas_decode as jpd
from music_fader_nets_tpu_torch.models.modules import global_decoder_greedy
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

V, H, Z = 342, 32, 2 * 8 + 24
VP = 384
STEPS = 16


@pytest.fixture(scope="module")
def gview():
    p = j_decoder_init(jax.random.PRNGKey(0), Z, V, H)
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 8.0
    return jax.tree.map(np.asarray, p)


def _z(B, seed):
    return np.random.default_rng(seed).standard_normal((B, Z)).astype(
        np.float32)


@pytest.mark.parametrize("B", [3, 70], ids=["B3", "B70-chunked"])
def test_greedy_matches_pallas_interpret(gview, B):
    z = _z(B, B)
    want = np.asarray(jpd.greedy_decode_tokens(gview, jnp.asarray(z), STEPS,
                                               interpret=True))
    assert jpd.LAST_DECODE_PATH == ("kernel" if B <= 64 else
                                    "kernel-chunked")
    got = cuda_decode.greedy_decode_tokens(
        params_from_numpy(gview), torch.from_numpy(z), STEPS, device="cpu")
    assert cuda_decode.LAST_DECODE_PATH == "plain-cpu"
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_matches_pallas_interpret(gview):
    """Same numpy Gumbel noise and per-row 1/T on both sides; rows 1 and 3
    are greedy rows (inv_t = 1, zero noise) inside a sampled batch."""
    B = 5
    rng = np.random.default_rng(7)
    z = _z(B, 11)
    noise = rng.gumbel(size=(STEPS, B, VP)).astype(np.float32)
    inv_t = np.array([1 / 0.9, 1.0, 1 / 1.5, 1.0, 1 / 0.5], np.float32)
    noise[:, [1, 3]] = 0.0
    want = np.asarray(jpd.pallas_sample_decode(
        gview, jnp.asarray(z), jnp.asarray(noise), jnp.asarray(inv_t[:, None]),
        STEPS, interpret=True))
    tv = params_from_numpy(gview)
    got = cuda_decode.cuda_sample_decode(
        tv, torch.from_numpy(z), torch.from_numpy(noise),
        torch.from_numpy(inv_t), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = cuda_decode.cuda_greedy_decode(tv, torch.from_numpy(z), STEPS)
    np.testing.assert_array_equal(got.numpy()[[1, 3]],
                                  greedy.numpy()[[1, 3]])


def test_unit_temperature_zero_noise_is_greedy(gview):
    B = 4
    tv = params_from_numpy(gview)
    z = torch.from_numpy(_z(B, 3))
    greedy = cuda_decode.cuda_greedy_decode(tv, z, STEPS)
    sampled = cuda_decode.cuda_sample_decode(
        tv, z, torch.zeros((STEPS, B, VP)), torch.ones(B), STEPS)
    assert torch.equal(sampled, greedy)
    # and the plain versions agree with the wrappers on CPU tensors
    assert torch.equal(cuda_decode.plain_decode_tokens(tv, z, STEPS), greedy)


@pytest.mark.parametrize("temperature",
                         [1e-7, 1e7, float("inf"), float("nan")])
def test_temperature_bounds_raise(gview, temperature):
    tv = params_from_numpy(gview)
    with pytest.raises(ValueError, match="temperature"):
        cuda_decode.sample_decode_tokens(tv, torch.zeros((2, Z)), STEPS,
                                         [1, 2], temperature, device="cpu")


def test_sample_decode_tokens_seeded_rows(gview):
    """Per-row generators: a row's tokens depend only on its seed (not its
    batch position), repeat per seed, differ across seeds, stay in-vocab;
    temperature 0 is the greedy decode."""
    tv = params_from_numpy(gview)
    z1 = torch.from_numpy(_z(1, 5))
    z = torch.cat([z1, z1, z1])
    a = cuda_decode.sample_decode_tokens(tv, z, STEPS, [9, 9, 10], 1.0,
                                         device="cpu")
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    b = cuda_decode.sample_decode_tokens(tv, z[1:], STEPS, [10, 9], 1.0,
                                         device="cpu")
    assert torch.equal(b[1], a[0]) and torch.equal(b[0], a[2])
    assert int(a.min()) >= 0 and int(a.max()) < V
    g = cuda_decode.sample_decode_tokens(tv, z, STEPS, [1, 2, 3], 0.0,
                                         device="cpu")
    assert torch.equal(g, cuda_decode.greedy_decode_tokens(tv, z, STEPS,
                                                           device="cpu"))


def test_global_decoder_greedy_logp_matches_jax(gview):
    """Log-probs of the port's module-level decoder with the JAX tokens as
    feedback, and its own greedy tokens, against JAX's scan decoder."""
    z = _z(3, 21)
    want = np.asarray(j_greedy_logp(gview, jnp.asarray(z), STEPS))
    want_tok = want.argmax(-1)
    tv = params_from_numpy(gview)
    got = global_decoder_greedy(tv, torch.from_numpy(z), STEPS,
                                feed=torch.from_numpy(want_tok))
    assert got.shape == (3, STEPS, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    own = global_decoder_greedy(tv, torch.from_numpy(z), STEPS)
    np.testing.assert_array_equal(own.argmax(-1).numpy(), want_tok)
    np.testing.assert_allclose(torch.logsumexp(own, -1).numpy(), 0.0,
                               atol=1e-5)


def test_near_tie_partings(gview):
    """The near-tie rule of chip_smoke.py: identical tokens pass; a parting
    passes only when the plain scores hold the other token within tol."""
    tv = params_from_numpy(gview)
    z = torch.from_numpy(_z(3, 12))
    args, v, _ = cuda_decode._prep_decode_args(tv, z)
    ref = cuda_decode.plain_decode_tokens(tv, z, STEPS)
    assert cuda_decode.near_tie_partings(args, v, ref, ref) == (0, 0.0)
    got = ref.clone()
    got[1, 5] = (int(ref[1, 5]) + 1) % v          # a different token
    got[1, 6:] = 0                                 # its own continuation
    with pytest.raises(AssertionError, match="row 1 step 5"):
        cuda_decode.near_tie_partings(args, v, got, ref)
    scores = list(cuda_decode.decode_scores_plain(args, v, 6))[5][1][1]
    gap = float(scores.max() - scores[got[1, 5].long()])
    assert cuda_decode.near_tie_partings(args, v, got, ref,
                                         tol=gap) == (1, gap)


def test_decode_scores_feed_reproduces_tokens(gview):
    """Teacher-forcing the plain loop with its own tokens reproduces them,
    and the scores' argmax is the emitted token (the near-tie check of
    chip_smoke.py relies on both)."""
    tv = params_from_numpy(gview)
    z = torch.from_numpy(_z(2, 8))
    args, v, _ = cuda_decode._prep_decode_args(tv, z)
    toks = cuda_decode.plain_decode_tokens(tv, z, STEPS)
    fed = list(cuda_decode.decode_scores_plain(args, v, STEPS,
                                               feed=toks.t()))
    for i, (tok, scores) in enumerate(fed):
        assert torch.equal(tok.int(), toks[:, i])
        assert scores.shape == (2, VP)
        assert float(scores[:, v:].max()) < -1e29      # pad lanes
