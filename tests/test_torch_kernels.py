"""PyTorch port, CUDA kernels against their plain PyTorch versions on the
card, at small ragged shapes (partial tiles in every dimension). These
need a CUDA device and skip without one; run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda

Encoder finals to 1e-5 (float32, two summation orders, 7 steps); decode
tokens exactly, the head sharpened 8x so no step is a near-tie. The
training kernels (autograd Functions of `ops/cuda_gru.py`,
`ops/cuda_stacked.py` and `ops/cuda_decoder.py`, the last without a head
and with both its heads) against autograd of their plain versions: values to
1e-5, gradients to atol=rtol=1e-4 (float32; the weight gradients sum up to
T*B products in another order than cuBLAS does). Their reductions use no
atomics, so two runs give bitwise the same gradients. The embedded and the
generic stacked GRU run at shapes that cross the tiles of the persistent
backward chain and of the split-K weight-gradient GEMM (`RAGGED`); the
three decoder entries at shapes that cross the persistent forward chain's
row and column tiles (`FWD_RAGGED`), their forward outputs bitwise equal
on a repeat, as are the encoder's and the sub-decoders' entries on the same
chain. The persistent decode kernel holds to the plain decode under the
near-tie rule at ragged rows, steps and widths (`DECODE_RAGGED`)."""
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


# (B, T, L, H): partial tiles in every dimension; B = 130 crosses the
# chain's 32- and 64-row tiles and the GEMM's 128-row slabs' seam, T * B >=
# 512 splits K (the h0 | h_seq seam at row B lies inside the first part),
# H = 136 leaves an 8-unit column tile, H = 30 takes the 4-byte copy paths
RAGGED = [(1, 1, 4, 80), (1, 7, 4, 80), (37, 1, 4, 80), (37, 7, 4, 80),
          (130, 3, 4, 80), (130, 9, 2, 136), (37, 101, 2, 136),
          (70, 5, 1, 136), (5, 3, 2, 30), (33, 40, 4, 30)]


@pytest.mark.parametrize("B,T,L,H", RAGGED)
def test_embed_finals_training_kernels_match_plain(dev, B, T, L, H):
    gen = torch.Generator().manual_seed(B * 10 + T)
    V = 342
    w_ih_p, b_ih, w_hh, b_hh = stack_directions(
        [gru_init(gen, V, H) for _ in range(L)])
    tokens = torch.randint(0, V, (B, T), generator=gen)
    tok_lt = direction_tokens(tokens, ([False, True] * 2)[:L]).to(dev)
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


# (B, T, L, class-table rows, ids): with the JAX path's padded 128-row
# table the generic backward entry (dpre_x stash, class scatter after the
# chain); with the model's 16 rows the chain's sub-decoders' mode, which
# sums the classes, dprez and db_hh itself: ids of the rhythm direction in
# [0, 3), all ids in one class, ids outside [0, 16) (negative and >= 16:
# no row), one direction, B = 130 (a ragged row tile)
SEQ_CASES = [(1, 1, 2, 128, "all"), (1, 7, 2, 128, "all"),
             (37, 1, 2, 128, "all"), (37, 7, 2, 128, "all"),
             (1, 1, 2, 16, "all"), (37, 7, 2, 16, "all"),
             (37, 7, 2, 16, "skewed"), (37, 7, 2, 16, "one_class"),
             (37, 7, 2, 16, "outside"), (37, 7, 1, 16, "all"),
             (130, 5, 2, 16, "all")]


@pytest.mark.parametrize("B,T,L,rows,ids", SEQ_CASES)
def test_embed_seq_training_kernels_match_plain(dev, B, T, L, rows, ids):
    gen = torch.Generator().manual_seed(B * 10 + T + 1)
    C, H = 16, 80
    G = 3 * H
    w_emb = torch.zeros((L, rows, G))
    w_emb[:, :C] = torch.randn((L, C, G), generator=gen) * 0.2
    prez = torch.randn((L, B, G), generator=gen) * 0.2
    w_hh = torch.randn((L, H, G), generator=gen) * 0.1
    b_hh = torch.randn((L, G), generator=gen) * 0.1
    h0 = torch.randn((L, B, H), generator=gen) * 0.5
    lo, hi = (-3, C + 4) if ids == "outside" else (0, C)
    cls_lt = torch.randint(lo, hi, (L, T, B), generator=gen,
                           dtype=torch.int32)
    if ids == "skewed":
        cls_lt[0] %= 3
    elif ids == "one_class":
        cls_lt.fill_(5)
    cls_lt = cls_lt.to(dev)
    before = dict(cuda_gru.LAUNCHES)
    _grad_check(cuda_gru.stacked_gru_embed_seq,
                cuda_gru.stacked_gru_embed_seq_plain, cls_lt,
                [w_emb, prez, w_hh, b_hh, h0], dev, B + T)
    assert cuda_gru.LAUNCHES["embed_seq_bwd"] == before["embed_seq_bwd"] + 2


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7),
                                 (37, 31)])
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


@pytest.mark.parametrize("B,T,L,H", RAGGED)
def test_stacked_gru_kernels_match_plain(dev, B, T, L, H):
    gen = torch.Generator().manual_seed(B * 10 + T + 3)
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


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (37, 1), (37, 7)])
def test_decoder_teacher_kernels_match_plain(dev, B, T):
    """Kernels 7/8: h2_seq (T, B, H) and every gradient from its
    cotangent; without a gradient the forward alone, no stash."""
    gen = torch.Generator().manual_seed(B * 10 + T + 5)
    V, H, Z = 342, 80, 40
    Vp, G = vocab_pad(V), 3 * H
    p = global_decoder_init(gen, Z, V, H)
    w_tok = torch.zeros((Vp, G))
    w_tok[:V] = p["grucell_g"]["w_ih"][:V]
    pre_z = torch.randn((B, G), generator=gen) * 0.3
    h1_0 = torch.randn((B, H), generator=gen) * 0.5
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    tok = torch.randint(0, V, (T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    floats = [w_tok, pre_z, g1["w_hh"], g1["b_hh"], g2["w_ih"], g2["b_ih"],
              g2["w_hh"], g2["b_hh"], h1_0]
    before = dict(cuda_decoder.LAUNCHES)
    _grad_check(cuda_decoder.decoder_teacher,
                cuda_decoder.decoder_teacher_plain, tok, floats, dev, B + T)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"
    assert cuda_decoder.LAUNCHES["decoder_teacher"] == before[
        "decoder_teacher"] + 2
    assert cuda_decoder.LAUNCHES["decoder_teacher_bwd"] == before[
        "decoder_teacher_bwd"] + 2
    with torch.no_grad():
        args = [t.to(dev) for t in floats]
        torch.testing.assert_close(
            cuda_decoder.decoder_teacher(tok, *args),
            cuda_decoder.decoder_teacher_plain(tok, *args), rtol=0,
            atol=1e-5)
    assert cuda_decoder.LAUNCHES["decoder_teacher_bwd"] == before[
        "decoder_teacher_bwd"] + 2


def _decoder_floats(gen, B, H, rows, head):
    """Decoder inputs at width H over `rows` decoded rows (B token rows):
    w_tok, pre_z, whh1, bhh1, wih2, bih2, whh2, bhh2, h1_0 and, with a
    head, the padded w_out, b_out."""
    V, Z = 342, 40
    Vp, G = vocab_pad(V), 3 * H
    p = global_decoder_init(gen, Z, V, H)
    w_tok = torch.zeros((Vp, G))
    w_tok[:V] = p["grucell_g"]["w_ih"][:V]
    g1, g2 = p["grucell_g"], p["grucell_g_2"]
    fl = [w_tok, torch.randn((rows, G), generator=gen) * 0.3, g1["w_hh"],
          g1["b_hh"], g2["w_ih"], g2["b_ih"], g2["w_hh"], g2["b_hh"],
          torch.randn((rows, H), generator=gen) * 0.5]
    if head != "none":
        w_out = torch.zeros((H, Vp))
        w_out[:, :V] = p["linear_out_g"]["w"] * 4.0
        b_out = torch.full((Vp,), cuda_decoder.PAD_LOGIT)
        b_out[:V] = p["linear_out_g"]["b"]
        fl += [w_out, b_out]
    return fl


# (B, T, H): the forward chain's partial 16-row tiles (B = 37, 130), one
# step, an 8-unit column tile (H = 136) and a ragged k (H = 30)
FWD_RAGGED = [(37, 1, 136), (130, 3, 136), (37, 9, 30), (130, 6, 80),
              (1, 5, 30)]


@pytest.mark.parametrize("head", ["ce", "masses", "none"])
@pytest.mark.parametrize("B,T,H", FWD_RAGGED)
def test_decoder_forward_chain_matches_plain(dev, B, T, H, head):
    """The three decoder forward entries (two `gru_fwd_chain` launches
    around the layer-2 input GEMM): values with and without the gate stash
    against the plain version, bit-equal on a repeat, and every gradient
    from the stash against autograd of the plain version; the masses head
    over n_rep = 2 copies."""
    gen = torch.Generator().manual_seed(B * 10 + T + H)
    V, n_rep = 342, (2 if head == "masses" else 1)
    floats = _decoder_floats(gen, B, H, n_rep * B, head)
    tgt = torch.randint(0, V, (T, B), generator=gen, dtype=torch.int32)
    tok = torch.cat([torch.full((1, B), V - 1, dtype=torch.int32),
                     tgt[:-1]]).to(dev)
    tgt = tgt.to(dev)
    fn, plain = {
        "ce": (lambda ids, *fl: cuda_decoder.decoder_teacher_nll(
                   ids, tgt, *fl),
               lambda ids, *fl: cuda_decoder.decoder_teacher_nll_plain(
                   ids, tgt, *fl)),
        "masses": (lambda ids, *fl: cuda_decoder.decoder_teacher_masses(
                       ids, *fl, ((2, 90), (180, 278)), n_rep),
                   lambda ids, *fl: cuda_decoder.decoder_teacher_masses_plain(
                       ids, *fl, ((2, 90), (180, 278)), n_rep)),
        "none": (cuda_decoder.decoder_teacher,
                 cuda_decoder.decoder_teacher_plain)}[head]
    with torch.no_grad():
        args = [t.to(dev) for t in floats]
        got, again = fn(tok, *args), fn(tok, *args)
        torch.testing.assert_close(got, plain(tok, *args), rtol=0,
                                   atol=1e-5)
        assert torch.equal(got, again)
    _grad_check(fn, plain, tok, floats, dev, B + T + H)
    assert cuda_decoder.LAST_TRAIN_PATH == "kernel"


@pytest.mark.parametrize("entry", ["finals", "train", "seq"])
@pytest.mark.parametrize("B,T,H", FWD_RAGGED)
def test_embed_forward_chain_matches_plain(dev, B, T, H, entry):
    """The encoder's two entries (L=4: serving finals, and the training
    forward with its gate stash through `EmbedFinals`) and the
    sub-decoders' (L=2, a per-sequence add), each one cooperative launch
    of `gru_fwd_chain`: values against the plain version, bit-equal on a
    repeat, one wrapper launch a call."""
    gen = torch.Generator().manual_seed(B * 7 + T + H)
    L, V = (2, 16) if entry == "seq" else (4, 342)
    w_in, b_ih, w_hh, b_hh = (t.to(dev) for t in stack_directions(
        [gru_init(gen, V, H) for _ in range(L)]))
    ids = torch.randint(0, V, (L, T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    h0 = (torch.randn((L, B, H), generator=gen) * 0.5).to(dev)
    if entry == "seq":
        add = (torch.randn((L, B, 3 * H), generator=gen) * 0.5).to(dev)
        fn, plain, count = (cuda_gru.stacked_gru_embed_seq,
                            cuda_gru.stacked_gru_embed_seq_plain, "embed_seq")
    else:
        add = b_ih
        fn, plain = (cuda_gru.stacked_gru_embed_finals,
                     cuda_gru.stacked_gru_embed_finals_plain)
        count = "embed_gru" if entry == "finals" else "embed_gru_train"
    args = [ids, w_in, add, w_hh, b_hh, h0]
    if entry == "train":
        args[1] = w_in.clone().requires_grad_(True)
    before = cuda_gru.LAUNCHES[count]
    got, again = fn(*args), fn(*args)
    assert cuda_gru.LAUNCHES[count] == before + 2
    with torch.no_grad():
        torch.testing.assert_close(got, plain(ids, w_in, add, w_hh, b_hh,
                                              h0), rtol=0, atol=1e-5)
    assert torch.equal(got, again)


# (B, steps, H) of the persistent decode: one row (the 8-row tile), a
# partial 64-row tile, a full one; one, two and 17 steps; a ragged width
# (34 blocks, Kp padded) and the model's
DECODE_RAGGED = [(1, 17, 136), (37, 2, 136), (64, 1, 136), (1, 1, 512),
                 (37, 17, 512), (64, 2, 512)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sample"])
@pytest.mark.parametrize("B,steps,H", DECODE_RAGGED)
def test_decode_kernel_near_ties(dev, B, steps, H, sampled):
    """The decode kernel with an unsharpened head against the plain decode
    under chip_smoke.py's near-tie rule (a parting only where the plain
    scores hold the kernel's token within 1e-4 of their maximum), bit-equal
    on a repeat, tokens in [0, V)."""
    gen = torch.Generator().manual_seed(B + steps + H)
    V, Z = 342, 40
    gview = tree_to(global_decoder_init(gen, Z, V, H), dev)
    z = torch.randn((B, Z), generator=gen).to(dev)
    args, _, Vp = cuda_decode._prep_decode_args(gview, z)
    noise = inv_t = None
    if sampled:
        noise = -torch.log(-torch.log(torch.rand(
            (steps, B, Vp), generator=gen).clamp_min(1e-30))).to(dev)
        inv_t = torch.full((B,), 1 / 0.9, device=dev)
        got = cuda_decode.cuda_sample_decode(gview, z, noise, inv_t, steps)
        again = cuda_decode.cuda_sample_decode(gview, z, noise, inv_t, steps)
        ref = cuda_decode.plain_sample_tokens(gview, z, noise, inv_t, steps)
    else:
        got = cuda_decode.cuda_greedy_decode(gview, z, steps)
        again = cuda_decode.cuda_greedy_decode(gview, z, steps)
        ref = cuda_decode.plain_decode_tokens(gview, z, steps)
    assert got.shape == (B, steps)
    assert torch.equal(got, again)
    assert int(got.min()) >= 0 and int(got.max()) < V
    cuda_decode.near_tie_partings(args, V, got, ref, noise, inv_t, 1e-4)


def test_teacher_decode_with_tokens_runs_the_fused_decoder(dev):
    """`global_decoder_teacher` with token ids runs kernels 7/8 on the
    card, not the generic stacked-GRU kernels, and its log-probs and the
    gradients of z and the weights match its plain run on the CPU; the
    cotangent reaches kernel 8 through the (B, T, H) transpose."""
    gen = torch.Generator().manual_seed(12)
    V, H, Z, B, T = 342, 80, 40, 5, 9
    p = global_decoder_init(gen, Z, V, H)
    z = torch.randn((B, Z), generator=gen)
    tok = torch.randint(0, V, (B, T), generator=gen)
    proj = torch.randn((B, T, V), generator=gen)

    def run(device):
        pd = {k: {n: t.detach().clone().to(device).requires_grad_(True)
                  for n, t in v.items()} for k, v in p.items()}
        zd = z.clone().to(device).requires_grad_(True)
        out = global_decoder_teacher(pd, zd, None, tokens=tok.to(device))
        (out * proj.to(device)).sum().backward()
        return out.detach().cpu(), [zd.grad.cpu()] + [
            t.grad.cpu() for v in pd.values() for t in v.values()]

    want, g_want = run("cpu")
    before = (dict(cuda_decoder.LAUNCHES), dict(cuda_stacked.LAUNCHES))
    got, g_got = run(dev)
    assert cuda_decoder.LAUNCHES["decoder_teacher"] == before[0][
        "decoder_teacher"] + 1
    assert cuda_decoder.LAUNCHES["decoder_teacher_bwd"] == before[0][
        "decoder_teacher_bwd"] + 1
    assert cuda_stacked.LAUNCHES == before[1]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        torch.testing.assert_close(a, b, msg=f"leaf {i}", atol=1e-3,
                                   rtol=1e-3)


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


# ---------------------------------------------------------------- bf16
# The bf16 instantiations of the training kernels against the bf16
# branches of their plain versions at ragged shapes: outputs to 1e-2 and
# each gradient to 2e-2 of its tensor's largest entry (the rounding points
# are the same; a float32 sum in another order can move a value across a
# bf16 rounding, 2^-8 relative, and that propagates), the gradients bf16,
# two backward calls bit-equal, the bf16 launch counts moving and the
# float32 ones not. Since the bf16 backward runs on the tensor cores
# (16-row MMA tiles, 128-row GEMM tiles), the ragged cases also take an
# odd T with T*B no multiple of 128 and an H no multiple of 8 (the GEMMs'
# element-load paths, a partial 32-unit column tile).
BF16 = torch.bfloat16
BF16_RAGGED = [(37, 9, 2, 136), (128, 5, 4, 512), (37, 21, 2, 30)]


def _bf16_check(fn, plain, ids, floats, dev, seed, counts, keys):
    gen = torch.Generator().manual_seed(seed)
    floats = [t.to(dev, BF16) for t in floats]
    ids = ids.to(dev)
    before = dict(counts)

    def run(f):
        ts = [t.detach().clone().requires_grad_(True) for t in floats]
        out = f(ids, *ts)
        return ts, out

    ts, out = run(fn)
    cot = torch.randn(out.shape, generator=gen).to(dev, out.dtype)
    g1 = torch.autograd.grad(out, ts, cot, retain_graph=True)
    g2 = torch.autograd.grad(out, ts, cot)
    pts, pout = run(plain)
    gp = torch.autograd.grad(pout, pts, cot)
    torch.cuda.synchronize()
    assert all(g.dtype == BF16 for g in g1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert float((out.float() - pout.float()).abs().max()) <= 1e-2
    for a, b in zip(g1, gp):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * max(float(b.float().abs().max()), 1e-3)
    for k in keys:
        assert counts[k + "_bf16"] > before[k + "_bf16"]
        assert counts[k] == before[k]


@pytest.mark.parametrize("B,T,L,H", BF16_RAGGED)
def test_bf16_embed_kernels_match_plain(dev, B, T, L, H):
    gen = torch.Generator().manual_seed(B + T)
    V, G = 342, 3 * H
    w = stack_directions([gru_init(gen, V, H) for _ in range(L)])
    tok = direction_tokens(torch.randint(0, V, (B, T), generator=gen),
                           [False, True] * (L // 2))
    h0 = torch.randn((L, B, H), generator=gen) * 0.5
    _bf16_check(cuda_gru.stacked_gru_embed_finals,
                cuda_gru.stacked_gru_embed_finals_plain, tok, [*w, h0], dev,
                1, cuda_gru.LAUNCHES, ("embed_gru_train", "embed_gru_bwd"))
    cls = torch.randint(0, 16, (L, T, B), generator=gen, dtype=torch.int32)
    seq = [torch.randn((L, 16, G), generator=gen) * 0.1,
           torch.randn((L, B, G), generator=gen) * 0.3, w[2], w[3], h0]
    _bf16_check(cuda_gru.stacked_gru_embed_seq,
                cuda_gru.stacked_gru_embed_seq_plain, cls, seq, dev, 2,
                cuda_gru.LAUNCHES, ("embed_seq", "embed_seq_bwd"))
    with torch.no_grad():
        args = [t.to(dev, BF16) for t in (*w, h0)]
        before = cuda_gru.LAUNCHES["embed_gru_bf16"]
        got = cuda_gru.stacked_gru_embed_finals(tok.to(dev), *args)
        want = cuda_gru.stacked_gru_embed_finals_plain(tok.to(dev), *args)
        assert got.dtype == BF16
        assert float((got.float() - want.float()).abs().max()) <= 1e-2
        assert cuda_gru.LAUNCHES["embed_gru_bf16"] == before + 1


@pytest.mark.parametrize("B,T,L,H", BF16_RAGGED)
def test_bf16_stacked_gru_kernels_match_plain(dev, B, T, L, H):
    gen = torch.Generator().manual_seed(B * 3 + T)
    G = 3 * H
    floats = [torch.randn((L, T, B, G), generator=gen) * 0.5,
              torch.randn((L, H, G), generator=gen) * 0.1,
              torch.randn((L, G), generator=gen) * 0.1,
              torch.randn((L, B, H), generator=gen) * 0.5]
    _bf16_check(lambda _, *fl: cuda_stacked.stacked_gru(*fl),
                lambda _, *fl: cuda_stacked.stacked_gru_plain(*fl),
                torch.empty(0), floats, dev, 3, cuda_stacked.LAUNCHES,
                ("stacked_gru", "stacked_gru_bwd"))


@pytest.mark.parametrize("B,T,H", [(37, 7, 136), (128, 6, 512),
                                   (37, 21, 30)])
def test_bf16_decoder_ce_kernels_match_plain(dev, B, T, H):
    gen = torch.Generator().manual_seed(B + 7 * T)
    V = 342
    gd = global_decoder_init(gen, 24, V, H)
    z = torch.randn((B, 24), generator=gen)
    tokens = torch.randint(0, V, (B, T), generator=gen, dtype=torch.int32)
    gd = {k: {n: t.to(BF16) for n, t in v.items()} for k, v in gd.items()}
    tok_t, w = cuda_decoder._fused_args(gd, z.to(BF16), tokens, V)
    tgt = tokens.t().contiguous().to(dev)
    _bf16_check(lambda i, *fl: cuda_decoder.decoder_teacher_nll(i, tgt, *fl),
                lambda i, *fl: cuda_decoder.decoder_teacher_nll_plain(
                    i, tgt, *fl), tok_t, [t.float() for t in w], dev, 4,
                cuda_decoder.LAUNCHES, ("decoder_ce", "decoder_ce_bwd"))
