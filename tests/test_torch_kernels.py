"""PyTorch port, CUDA kernels against their plain PyTorch versions on the
card, at small ragged shapes (partial tiles in every dimension). These
need a CUDA device and skip without one; run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda

Encoder finals to 1e-5 (float32, two summation orders, 7 steps); decode
tokens exactly, the head sharpened 8x so no step is a near-tie. The
training kernels (autograd Functions of `ops/cuda_gru.py`,
`ops/cuda_stacked.py` and `ops/cuda_decoder.py`, the last with both its
heads) against autograd of their plain versions: values to
1e-5, gradients to atol=rtol=1e-4 (float32; the weight gradients sum up to
T*B products in another order than cuBLAS does). Their reductions use no
atomics, so two runs give bitwise the same gradients."""
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.models.modules import (
    global_decoder_init, global_decoder_teacher,
)
from music_fader_nets_tpu_torch.ops import (
    cuda_decode, cuda_decoder, cuda_gru, cuda_stacked,
)
from music_fader_nets_tpu_torch.ops.gru import (
    direction_tokens, gru_init, stack_directions, vocab_pad,
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


GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _grad_check(fn, plain, ids, floats, dev, seed):
    """Values and every float input's gradient of `fn` (kernels) against
    autograd of `plain`, under a random projection of the output; and the
    kernel's gradients twice, bitwise equal."""
    def run(f):
        ts = [t.detach().clone().to(dev).requires_grad_(True)
              for t in floats]
        out = f(ids, *ts)
        gen = torch.Generator().manual_seed(seed)
        proj = torch.randn(out.shape, generator=gen).to(dev)
        grads = torch.autograd.grad((out * proj).sum(), ts)
        return out.detach(), grads

    got, g_got = run(fn)
    want, g_want = run(plain)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        torch.testing.assert_close(a, b, msg=f"input {i}", **GRAD_TOL)
    _, g_again = run(fn)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_again))


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_embed_finals_training_kernels_match_plain(dev, B, T):
    gen = torch.Generator().manual_seed(B * 10 + T)
    L, V, H = 4, 342, 80
    w_ih_p, b_ih, w_hh, b_hh = stack_directions(
        [gru_init(gen, V, H) for _ in range(L)])
    tokens = torch.randint(0, V, (B, T), generator=gen)
    tok_lt = direction_tokens(tokens, [False, True] * 2).to(dev)
    h0 = torch.randn((L, B, H), generator=gen) * 0.5
    before = dict(cuda_gru.LAUNCHES)
    _grad_check(cuda_gru.stacked_gru_embed_finals,
                cuda_gru.stacked_gru_embed_finals_plain, tok_lt,
                [w_ih_p, b_ih, w_hh, b_hh, h0], dev, B + T)
    assert cuda_gru.LAST_TRAIN_PATH == "kernel"
    assert cuda_gru.LAUNCHES["embed_gru_train"] == before[
        "embed_gru_train"] + 2
    assert cuda_gru.LAUNCHES["embed_gru_bwd"] == before["embed_gru_bwd"] + 2
    assert cuda_gru.LAUNCHES["embed_gru"] == before["embed_gru"]


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_embed_seq_training_kernels_match_plain(dev, B, T):
    gen = torch.Generator().manual_seed(B * 10 + T + 1)
    L, C, H = 2, 16, 80
    G = 3 * H
    w_emb = torch.zeros((L, 128, G))
    w_emb[:, :C] = torch.randn((L, C, G), generator=gen) * 0.2
    prez = torch.randn((L, B, G), generator=gen) * 0.2
    w_hh = torch.randn((L, H, G), generator=gen) * 0.1
    b_hh = torch.randn((L, G), generator=gen) * 0.1
    h0 = torch.randn((L, B, H), generator=gen) * 0.5
    cls_lt = torch.randint(0, C, (L, T, B), generator=gen,
                           dtype=torch.int32).to(dev)
    before = dict(cuda_gru.LAUNCHES)
    _grad_check(cuda_gru.stacked_gru_embed_seq,
                cuda_gru.stacked_gru_embed_seq_plain, cls_lt,
                [w_emb, prez, w_hh, b_hh, h0], dev, B + T)
    assert cuda_gru.LAUNCHES["embed_seq_bwd"] == before["embed_seq_bwd"] + 2


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_decoder_ce_kernels_match_plain(dev, B, T):
    gen = torch.Generator().manual_seed(B * 10 + T + 2)
    V, H, Z = 342, 80, 40
    Vp, G = vocab_pad(V), 3 * H
    p = global_decoder_init(gen, Z, V, H)
    w_tok = torch.zeros((Vp, G))
    w_tok[:V] = p["grucell_g"]["w_ih"][:V]
    pre_z = torch.randn((B, G), generator=gen) * 0.3
    h1_0 = torch.randn((B, H), generator=gen) * 0.5
    w_out = torch.zeros((H, Vp))
    w_out[:, :V] = p["linear_out_g"]["w"]
    b_out = torch.full((Vp,), cuda_decoder.PAD_LOGIT)
    b_out[:V] = p["linear_out_g"]["b"]
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    tgt = torch.randint(0, V, (T, B), generator=gen, dtype=torch.int32)
    tok = torch.cat([torch.full((1, B), V - 1, dtype=torch.int32),
                     tgt[:-1]]).to(dev)
    tgt = tgt.to(dev)
    floats = [w_tok, pre_z, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
              g2["w_hh"], g2["b_hh"], h1_0, w_out, b_out]

    def with_tgt(f):
        return lambda ids, *fl: f(ids, tgt, *fl)

    before = dict(cuda_decoder.LAUNCHES)
    _grad_check(with_tgt(cuda_decoder.decoder_teacher_nll),
                with_tgt(cuda_decoder.decoder_teacher_nll_plain), tok,
                floats, dev, B + T)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"
    assert cuda_decoder.LAUNCHES["decoder_ce_bwd"] == before[
        "decoder_ce_bwd"] + 2


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_stacked_gru_kernels_match_plain(dev, B, T):
    gen = torch.Generator().manual_seed(B * 10 + T + 3)
    L, H = 2, 80
    G = 3 * H
    pre = torch.randn((L, T, B, G), generator=gen) * 0.5
    w_hh = torch.randn((L, H, G), generator=gen) * 0.1
    b_hh = torch.randn((L, G), generator=gen) * 0.1
    h0 = torch.randn((L, B, H), generator=gen) * 0.5
    before = dict(cuda_stacked.LAUNCHES)
    _grad_check(lambda _, *fl: cuda_stacked.stacked_gru(*fl),
                lambda _, *fl: cuda_stacked.stacked_gru_plain(*fl), None,
                [pre, w_hh, b_hh, h0], dev, B + T)
    assert cuda_stacked.LAST_TRAIN_PATH == "kernel"
    assert cuda_stacked.LAUNCHES["stacked_gru"] == before["stacked_gru"] + 2
    assert cuda_stacked.LAUNCHES["stacked_gru_bwd"] == before[
        "stacked_gru_bwd"] + 2
    # without a gradient: the forward alone, the same values
    with torch.no_grad():
        args = [t.to(dev) for t in (pre, w_hh, b_hh, h0)]
        torch.testing.assert_close(cuda_stacked.stacked_gru(*args),
                                   cuda_stacked.stacked_gru_plain(*args),
                                   rtol=0, atol=1e-5)
    assert cuda_stacked.LAUNCHES["stacked_gru_bwd"] == before[
        "stacked_gru_bwd"] + 2


@pytest.mark.parametrize("n_rep", [1, 3])
@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_decoder_masses_kernels_match_plain(dev, B, T, n_rep):
    """B token rows, n_rep * B decoded rows; with n_rep = 3, three ranges,
    one of them reaching into the pad lanes (where p is exactly 0)."""
    gen = torch.Generator().manual_seed(B * 10 + T + n_rep)
    V, H, Z = 342, 80, 40
    Vp, G, R = vocab_pad(V), 3 * H, n_rep * B
    p = global_decoder_init(gen, Z, V, H)
    w_tok = torch.zeros((Vp, G))
    w_tok[:V] = p["grucell_g"]["w_ih"][:V]
    pre_z = torch.randn((R, G), generator=gen) * 0.3
    h1_0 = torch.randn((R, H), generator=gen) * 0.5
    w_out = torch.zeros((H, Vp))
    w_out[:, :V] = p["linear_out_g"]["w"] * 4.0
    b_out = torch.full((Vp,), cuda_decoder.PAD_LOGIT)
    b_out[:V] = p["linear_out_g"]["b"]
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    tok = torch.randint(0, V, (T, B), generator=gen, dtype=torch.int32)
    ranges = (((2, 90), (180, 278)) if n_rep == 1
              else ((2, 90), (180, 278), (300, Vp)))
    floats = [w_tok, pre_z, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
              g2["w_hh"], g2["b_hh"], h1_0, w_out, b_out]

    def with_ranges(f):
        return lambda ids, *fl: f(ids, *fl, ranges, n_rep)

    before = dict(cuda_decoder.LAUNCHES)
    _grad_check(with_ranges(cuda_decoder.decoder_teacher_masses),
                with_ranges(cuda_decoder.decoder_teacher_masses_plain),
                tok.to(dev), floats, dev, B + T + n_rep)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"
    assert cuda_decoder.LAUNCHES["decoder_masses_bwd"] == before[
        "decoder_masses_bwd"] + 2


def test_teacher_decode_without_tokens_runs_stacked_kernels(dev):
    """`global_decoder_teacher` (one-hot input, no token ids) runs its two
    recurrences through the generic stacked-GRU kernel on the card and
    matches its plain run on the CPU."""
    gen = torch.Generator().manual_seed(11)
    V, H, Z, B, T = 342, 80, 40, 5, 9
    p = global_decoder_init(gen, Z, V, H)
    z = torch.randn((B, Z), generator=gen)
    x_oh = torch.nn.functional.one_hot(
        torch.randint(0, V, (B, T), generator=gen), V).float()
    want = global_decoder_teacher(p, z, x_oh)
    before = cuda_stacked.LAUNCHES["stacked_gru"]
    with torch.no_grad():
        got = global_decoder_teacher(tree_to(p, dev), z.to(dev),
                                     x_oh.to(dev))
    assert cuda_stacked.LAUNCHES["stacked_gru"] == before + 2
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=0, atol=1e-4)
