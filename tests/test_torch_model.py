"""PyTorch port, model level: the GM-VAE encoder and parameter trees
against the JAX package, on a small config with JAX's params carried
across by `params_from_numpy`.

Tolerance 1e-4 on mu/std: the repo's float32 forward bound
(parity.py::check_forward)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.models.vae import reg_vae_encode as j_encode
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu.transfer.arousal import (
    compute_shift_vectors as j_shifts,
)
from music_fader_nets_tpu_torch import load_config
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.gmvae import (
    init_reg_gmvae, reg_gmvae_decode_tokens, reg_gmvae_encode,
    reg_gmvae_sample_tokens,
)
from music_fader_nets_tpu_torch.models.modules import (
    encode_streams_fused, encode_streams_fused_packed,
)
from music_fader_nets_tpu_torch.models.vae import (
    _enc_view, _global_view, reg_vae_encode,
)
from music_fader_nets_tpu_torch.ops.gru import stack_directions
from music_fader_nets_tpu_torch.ops import cuda_decode, cuda_gru
from music_fader_nets_tpu_torch.transfer.arousal import compute_shift_vectors
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=12)
ATOL = 1e-4


@pytest.fixture(scope="module")
def np_params():
    p = j_init(jax.random.PRNGKey(0), JConfig(**SMALL))
    return jax.tree.map(np.asarray, p)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def _tokens(B=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 342, size=(B, SMALL["seq_len"])).astype(np.int32)


@pytest.mark.parametrize("path", ["kernel", "scan"])
def test_reg_vae_encode_matches_jax(np_params, pallas_interpret, path):
    """JAX: the embedded-token Pallas kernel (interpreted) or the one-hot
    scan. Port: the token path (encoder wrapper, plain on CPU) or the
    one-hot scan."""
    tok = _tokens()
    x = jax.nn.one_hot(tok, 342, dtype=jnp.float32)
    if path == "kernel":
        want = j_encode(np_params, x, use_pallas=True, tokens=tok)
    else:
        want = j_encode(np_params, x)
    tp = params_from_numpy(np_params)
    if path == "kernel":
        got = reg_vae_encode(tp, None, tokens=torch.from_numpy(tok))
        assert cuda_gru.LAST_ENCODE_PATH == "plain-cpu"
    else:
        got = reg_vae_encode(tp, torch.from_numpy(np.array(x)))
    for (gm, gs), (wm, ws) in zip(got, want):
        assert gm.shape == (3, SMALL["z_dims"])
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0,
                                   atol=ATOL)


def test_packed_encoder_equals_canonical(np_params):
    """The pre-stacked weight layout ([r.fwd, r.bwd, n.fwd, n.bwd], w_ih
    padded to Vp) gives the canonical encoder's numbers exactly."""
    tp = params_from_numpy(np_params)
    views = [_enc_view(tp, "r"), _enc_view(tp, "n")]
    dirs = [d for v in views for d in (v["gru"]["fwd"], v["gru"]["bwd"])]
    w_ih_p, b_ih, w_hh, b_hh = stack_directions(dirs)
    enc = {"w_ih_p": w_ih_p, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh}
    tok = torch.from_numpy(_tokens(2, 9))
    got = encode_streams_fused_packed(
        enc, [(v["mu"], v["var"]) for v in views], None, tokens=tok)
    want = encode_streams_fused(views, None, tokens=tok)
    for (gm, gs), (wm, ws) in zip(got, want):
        assert torch.equal(gm, wm) and torch.equal(gs, ws)


def test_params_round_trip_and_layout(np_params):
    tp = params_from_numpy(np_params)
    back = params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree: names, shapes, dtypes
    own = params_to_numpy(init_reg_gmvae(torch.Generator().manual_seed(0),
                                         ModelConfig(**SMALL)))
    own_flat = jax.tree_util.tree_leaves_with_path(own)
    assert [k for k, _ in own_flat] == [k for k, _ in flat_a]
    for (_, a), (_, b) in zip(flat_a, own_flat):
        assert a.shape == b.shape and b.dtype == np.float32
    np.testing.assert_array_equal(own["logvar_r_lookup"], -4.0)


def test_shift_vectors_match_jax(np_params):
    want = j_shifts(np_params)
    got = compute_shift_vectors(params_from_numpy(np_params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_gmvae_entry_points_on_cpu(np_params):
    """The GM-VAE entry points with device='cpu' equal the building blocks
    they route to."""
    tp = params_from_numpy(np_params)
    tok = torch.from_numpy(_tokens(2, 4))
    (mu_r, std_r), (mu_n, _) = reg_gmvae_encode(tp, tok, device="cpu")
    (wr, ws), (wn, _) = reg_vae_encode(tp, None, tokens=tok)
    assert torch.equal(mu_r, wr) and torch.equal(std_r, ws)
    z = torch.cat([mu_r, mu_n, torch.zeros((2, 24))], dim=-1)
    toks = reg_gmvae_decode_tokens(tp, z, 6, device="cpu")
    assert torch.equal(toks, cuda_decode.plain_decode_tokens(
        _global_view(tp), z, 6))
    s = reg_gmvae_sample_tokens(tp, z, 6, [3, 4], 0.8, device="cpu")
    assert s.shape == (2, 6) and int(s.max()) < 342
    with pytest.raises(ValueError, match="token ids"):
        reg_gmvae_encode(tp, tok + 400, device="cpu")


def test_load_config_reads_reference_json(tmp_path):
    path = tmp_path / "gmm.json"
    path.write_text('{"hidden_dim": 64, "z_dim": 16, "num_clusters": 2, '
                    '"unknown": 1}')
    cfg = load_config(str(path), seq_len=20)
    assert (cfg.hidden_dims, cfg.z_dims, cfg.seq_len) == (64, 16, 20)
    d = ModelConfig()
    assert (d.hidden_dims, d.z_dims, d.roll_dims, d.seq_len,
            d.transfer_decode_steps) == (512, 128, 342, 100, 300)
