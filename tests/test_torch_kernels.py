"""PyTorch port, CUDA kernels against their plain PyTorch versions on the
card, at small ragged shapes (partial tiles in every dimension). These
need a CUDA device and skip without one; run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda

Encoder finals to 1e-5 (float32, two summation orders, 7 steps); decode
tokens exactly, the head sharpened 8x so no step is a near-tie."""
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.models.modules import global_decoder_init
from music_fader_nets_tpu_torch.ops import cuda_decode, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import (
    direction_tokens, gru_init, stack_directions,
)
from music_fader_nets_tpu_torch.serve.server import TransferServer
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_embed_gru_kernel_matches_plain(dev):
    gen = torch.Generator().manual_seed(0)
    L, T, B, V, H = 4, 7, 37, 342, 80
    w_ih_p, b_ih, w_hh, b_hh = (t.to(dev) for t in stack_directions(
        [gru_init(gen, V, H) for _ in range(L)]))
    tokens = torch.randint(0, V, (B, T), generator=gen).to(dev)
    tok_lt = direction_tokens(tokens, [False, True] * 2)
    h0 = (torch.randn((L, B, H), generator=gen) * 0.5).to(dev)
    args = (tok_lt, w_ih_p, b_ih, w_hh, b_hh, h0)
    before = cuda_gru.LAUNCHES["embed_gru"]
    got = cuda_gru.stacked_gru_embed_finals(*args)
    assert cuda_gru.LAUNCHES["embed_gru"] == before + 1
    assert cuda_gru.LAST_ENCODE_PATH == "kernel"
    want = cuda_gru.stacked_gru_embed_finals_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [1, 19, 70])
def test_decode_kernels_match_plain(dev, B):
    gen = torch.Generator().manual_seed(B)
    V, H, Z, steps = 342, 48, 40, 24
    gview = global_decoder_init(gen, Z, V, H)
    gview["linear_out_g"]["w"] *= 8.0
    gview = tree_to(gview, dev)
    z = torch.randn((B, Z), generator=gen).to(dev)
    got = cuda_decode.greedy_decode_tokens(gview, z, steps, device="cuda")
    assert cuda_decode.LAST_DECODE_PATH == ("kernel" if B <= 64
                                            else "kernel-chunked")
    want = cuda_decode.plain_decode_tokens(gview, z, steps)
    assert torch.equal(got, want)

    seeds = [s if s % 3 else None for s in range(B)]
    noise = torch.zeros((steps, B, 384), device=dev)
    for b, s in enumerate(seeds):
        if s is not None:
            g = torch.Generator(device=dev).manual_seed(s)
            u = torch.rand((steps, 384), generator=g, device=dev)
            noise[:, b] = -torch.log(-torch.log(u.clamp_min(1e-30)))
    inv_t = torch.tensor([1.0 if s is None else 1.25 for s in seeds],
                         device=dev)
    got_s = cuda_decode.cuda_sample_decode(gview, z, noise, inv_t, steps)
    want_s = cuda_decode.plain_sample_tokens(gview, z, noise, inv_t, steps)
    assert torch.equal(got_s, want_s)
    greedy_rows = [b for b, s in enumerate(seeds) if s is None]
    assert torch.equal(got_s[greedy_rows], got[greedy_rows])


def test_server_runs_the_kernels(dev):
    cfg = ModelConfig(hidden_dims=64, z_dims=16, seq_len=20)
    params = init_reg_gmvae(torch.Generator().manual_seed(1), cfg)
    with TransferServer(params, cfg, steps=12, max_batch=8,
                        device="cuda") as srv:
        counts = (dict(cuda_gru.LAUNCHES), dict(cuda_decode.LAUNCHES))
        resps = [f.result(timeout=120) for f in [
            srv.submit({"tokens": list(range(2, 22)), "direction": d,
                        "temperature": t, "seed": 3})
            for d in ("none", "low_to_high") for t in (0.0, 0.8)]]
        stats = srv.stats()
    assert all("error" not in r and len(r["tokens"]) == 12 for r in resps)
    assert stats["serving_path"] == "kernel"
    assert cuda_gru.LAUNCHES["embed_gru"] > counts[0]["embed_gru"]
    assert (sum(cuda_decode.LAUNCHES.values())
            > sum(counts[1].values()))
