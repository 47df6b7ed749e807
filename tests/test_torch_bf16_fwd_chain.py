"""PyTorch port, bf16 mixed precision: the bf16 forward chain's product on
the tensor cores (`csrc/gru_fwd_chain.cu`, `gru_fwd_chain<RB, bf16, bf16>`
and `<RB, float, bf16>`) emulated in plain PyTorch, and its schedule's tile
and shared-memory arithmetic, read from the kernel's own constants. No
card needed.

The chain splits each float32 value of h[t-1] into three bf16 pieces and
takes three MMAs a 16-deep k-step (lo, mid, hi) into one float32
accumulator; warp (set, mw) takes the k-steps sl * KT + set * 16 of the
slabs sl in order (KT = kSets * 16, kSets = 8 / (RB / 16)), and the sets'
partial tiles are added in set order. `tc_product` forms the product so,
each k-step's partial products exact (formed in float64) and added to a
float32 accumulator (`tests/test_torch_bf16_split.py` bounds that
arithmetic). A GRU recurrence on that product, with the port's float32
gate maths, is held to the JAX package's bf16 `_fwd_embed_pallas`
(interpret mode) at ragged shapes: h_seq, finals and the gate stash to
the bound of `tests/test_torch_mixed_precision_kernels.py` (atol 1e-2);
the decoder's layer 2 (`<float, bf16>`: float32 input rows and first
state) to the port's plain bf16 decoder, which that file holds to JAX.

Then the schedule: every k row below H is taken by exactly one (slab,
set) for every row of the tile, the rings, partial tiles and transpose
share one buffer, the block's shared memory fits and is less than the
float32 chain's at H = 512, the swizzled weight slabs and padded rows put
ldmatrix's and the fragments' addresses on distinct banks, and the row
tile the launcher picks at the main path's shapes is co-resident on a
132-SM card."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru
from music_fader_nets_tpu_torch.ops.gru import vocab_pad
from music_fader_nets_tpu_torch.train import fwd_ablate
from test_torch_mixed_precision_kernels import VAL_ATOL, _bf16_np
from test_torch_mixed_precision_kernels import _embed_inputs, _normal

CSRC = (Path(__file__).resolve().parents[1] / "music_fader_nets_tpu_torch"
        / "csrc")
SMEM_BLOCK = 232448           # bytes of shared memory a block may use
SMEM_SM = 233472              # of an SM (228 KB)
V = 342
BF = torch.bfloat16


def _constants(*files):
    """name -> value of every `constexpr int kName = <int>;` in `files`."""
    out = {}
    for f in files:
        for name, val in re.findall(r"constexpr int (k\w+) = (\d+);",
                                    (CSRC / f).read_text()):
            out[name] = int(val)
    return out


C = _constants("gru_tile.cuh", "gru_fwd_chain.cu")
WARPS = C["kThreads"] // 32
COLS = C["kFwdCols"]
N = 3 * COLS                                    # kFwdN
MMA_K = C["kFwdTcK"]
BUF_TC = 128 * C["kFwdTcRed"]                   # kFwdBufTc


def sets_of(RB):
    """(M tiles side by side, k sets, k rows of a slab) at row tile RB."""
    mw = RB // 16
    sets = WARPS // mw
    return mw, sets, sets * MMA_K


def kp(H, bf16):
    """fwd_kp<S>(H): the weight slab's k rows."""
    pad = C["kFwdTcKPad"] if bf16 else C["kFwdKPad"]
    return -(-H // pad) * pad


def fwd_smem(H, bf16):
    """fwd_smem_bytes<S>(H)."""
    if bf16:
        return kp(H, True) * N * 2 + BUF_TC * 4
    f32_buf = (WARPS * C["kFwdStages"] * C["kFwdWarpK"]
               * C["kFwdWarpRows"])
    return (kp(H, False) * N + f32_buf) * 4


# ------------------------------------------------------------- emulation

def split3(x):
    """The three bf16 pieces of float32 x (hi, mid, lo), as float32."""
    hi = x.to(BF).float()
    r = x - hi
    mid = r.to(BF).float()
    return hi, mid, (r - mid).to(BF).float()


def tc_product(h, w, RB):
    """h (B, H) float32 @ w (H, 3H) (bf16 values) as the bf16 chain forms
    it at row tile RB: each set's k-steps in slab order, each k-step's
    pieces lo, mid, hi into a float32 accumulator, the sets added in set
    order."""
    B, H = h.shape
    _, sets, KT = sets_of(RB)
    slabs = -(-H // KT)
    hp = F.pad(h, (0, slabs * KT - H))
    wp = F.pad(w, (0, 0, 0, slabs * KT - H)).double()
    hi, mid, lo = split3(hp)
    out = None
    for st in range(sets):
        acc = torch.zeros((B, w.shape[1]), dtype=torch.float32)
        for sl in range(slabs):
            k0 = sl * KT + st * MMA_K
            for pc in (lo, mid, hi):
                acc = (acc.double() + pc[:, k0:k0 + MMA_K].double()
                       @ wp[k0:k0 + MMA_K]).float()
        out = acc if out is None else out + acc
    return out


def tc_chain(xpre, w_hh, b_hh, h0, T, RB):
    """The bf16 chain's float32 recurrence over L chains on tc_product:
    xpre(t) -> (L, B, 3H) float32; w_hh (L, H, 3H) with bf16 values;
    returns (h_seq, stash) float32, (L, T, B, H) and (L, T, B, 4H)."""
    h, hs, sts = h0, [], []
    for t in range(T):
        ph = torch.stack([tc_product(h[l], w_hh[l], RB)
                          for l in range(h.shape[0])])
        h, st = cuda_gru.gates_stash(xpre(t), ph + b_hh[:, None, :], h)
        hs.append(h)
        sts.append(st)
    return torch.stack(hs, dim=1), torch.stack(sts, dim=1)


@functools.lru_cache(maxsize=None)
def _embed_case(H):
    """(ids, bf16-valued float inputs, JAX's bf16 (h_seq, stash) as
    float32) at L=2, T=8, B=5, two ids outside the table."""
    L, T, B = 2, 8, 5
    ids, floats, _ = _embed_inputs(L, T, B, H, V, vocab_pad(V), H, False)
    ids[0, 0, 0], ids[1, 3, 2] = -1, vocab_pad(V) + 5
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    pallas_gru.INTERPRET = True
    try:
        want = pallas_gru._fwd_embed_pallas(
            jnp.asarray(ids), *[jnp.asarray(f, jnp.bfloat16) for f in floats],
            stash_gates=True)
    finally:
        pl.pallas_call = orig
        pallas_gru.INTERPRET = False
    return ids, floats, [np.asarray(w.astype(jnp.float32)) for w in want]


@pytest.mark.parametrize("RB", [16, 32, 64])
@pytest.mark.parametrize("H", [30, 40])
def test_tc_chain_matches_jax_bf16_embed(H, RB):
    """The `<bf16, bf16>` chain (rows 1, 3, 3t, 5, 9's layer 1): h_seq,
    finals and the gate stash, each rounded to bf16 where the kernel
    stores it, against the Pallas kernel's bf16 outputs."""
    ids, floats, (want_seq, want_stash) = _embed_case(H)
    w_in, b_ih, w_hh, b_hh, h0 = [torch.from_numpy(f) for f in floats]
    T = ids.shape[1]
    xpre = cuda_gru._table_xpre(torch.from_numpy(ids), w_in, b_ih, False)
    h_seq, stash = tc_chain(xpre, w_hh, b_hh, h0, T, RB)
    got_seq = h_seq.to(BF).float().numpy()
    np.testing.assert_allclose(got_seq, want_seq, rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(got_seq[:, -1], want_seq[:, -1], rtol=0,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(stash.to(BF).float().numpy(), want_stash,
                               rtol=0, atol=VAL_ATOL)


@pytest.mark.parametrize("RB", [16, 64])
@pytest.mark.parametrize("H", [30, 40])
def test_tc_chain_matches_plain_bf16_decoder_layer2(H, RB):
    """The `<float, bf16>` chain (the decoder's layer 2: float32 input
    rows h1_32 @ w_ih2, float32 first state h1_32[0]) against layer 2 of
    the port's plain bf16 decoder: h2 and its stash rounded to bf16 at
    atol 1e-2, the float32 h2 (h32, what the head reads) at 1e-5."""
    T, B, G, Vp = 8, 5, 3 * H, vocab_pad(V)
    rng = np.random.default_rng(H + RB)
    tok = torch.from_numpy(rng.integers(0, V, (T, B)).astype(np.int32))
    shapes = ((Vp, G, 0.3), (B, G, 0.1), (H, G, 0.3), (G, 1, 0.1),
              (H, G, 0.3), (G, 1, 0.1), (H, G, 0.3), (G, 1, 0.1),
              (B, H, 0.5))
    f32 = [torch.from_numpy(_bf16_np(_normal(rng, (r, c), s))).reshape(
        (r, c) if c > 1 else (r,)) for r, c, s in shapes]
    h1, h2, _, g42 = cuda_decoder._teacher_states32(tok, *f32)
    wih2, bih2, whh2, bhh2 = f32[4:8]
    pre2x = h1 @ wih2
    got_h2, got_g42 = tc_chain(lambda t: (pre2x[t] + bih2)[None],
                               whh2[None], bhh2[None], h1[:1], T, RB)
    np.testing.assert_allclose(got_h2[0].to(BF).float().numpy(),
                               h2.to(BF).float().numpy(), rtol=0,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(got_g42[0].to(BF).float().numpy(),
                               g42.to(BF).float().numpy(), rtol=0,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(got_h2[0].numpy(), h2.numpy(), rtol=0,
                               atol=1e-5)


# -------------------------------------------------------------- schedule

@pytest.mark.parametrize("RB", [16, 32, 64])
@pytest.mark.parametrize("H", [30, 136, 512])
def test_bf16_fwd_chain_covers_every_k_and_row_once(RB, H):
    mw_n, sets, KT = sets_of(RB)
    slabs = -(-H // KT)
    assert C["kFwdTcKPad"] % KT == 0 and slabs * KT <= kp(H, True)
    hits = np.zeros((kp(H, True), RB), int)
    for w in range(WARPS):
        mw, st = w % mw_n, w // mw_n
        for sl in range(slabs):
            k0 = sl * KT + st * MMA_K
            hits[k0:k0 + MMA_K, 16 * mw:16 * mw + 16] += 1
    assert (hits[:H] == 1).all() and hits.max() == 1
    # the warps' rings, the sets' partial tiles and the transpose share
    # the block's buffer
    ring = C["kFwdTcStages"] * MMA_K * C["kFwdTcRow"]
    assert WARPS * ring <= BUF_TC
    assert sets * RB * C["kFwdTcRed"] <= BUF_TC
    assert (RB // 4) * (COLS + 1) * 4 <= BUF_TC


def test_bf16_fwd_chain_shared_memory_fits():
    assert fwd_smem(512, True) == 151552
    assert fwd_smem(512, False) == 229376
    assert fwd_smem(512, True) < fwd_smem(512, False) <= SMEM_BLOCK
    # gate slabs and the buffer after them start on 128-byte lines
    assert all(kp(H, True) * COLS * 2 % 128 == 0 for H in (30, 136, 512))


def _swz(k, c):
    """mma_bf16.cuh::swz: a 32-column bf16 slab's element offset."""
    return k * 32 + ((((c >> 3) ^ (k >> 1)) & 3) << 3) + (c & 7)


def test_bf16_fwd_chain_reads_fall_on_distinct_banks():
    # ldmatrix of a gate's slab: 8 consecutive k rows, one 16-byte chunk
    for k0 in range(0, 64, 8):
        for c in range(0, COLS, 8):
            assert len({(2 * _swz(k0 + r, c)) % 128 // 16
                        for r in range(8)}) == 8
    for k in range(16):
        assert sorted(_swz(k, c) for c in range(32)) == list(
            range(32 * k, 32 * k + 32))
    g, q = np.arange(32) // 4, np.arange(32) % 4
    # the A fragment reads ring[2q + e][g], rows of kFwdTcRow floats,
    # 16-byte aligned for cp.async
    row = C["kFwdTcRow"]
    assert row * 4 % 16 == 0 and row >= 16
    for e in (0, 1, 8, 9):
        assert len(set(((2 * q + e) * row + g) % 32)) == 32
    # the partial tiles' float2 stores at [g][8 nt + 2q], a half-warp a
    # phase, rows of kFwdTcRed floats
    red = C["kFwdTcRed"]
    assert red >= N
    for half in (0, 16):
        lanes = np.arange(half, half + 16)
        words = [(l // 4) * red + 2 * (l % 4) + w for l in lanes
                 for w in (0, 1)]
        assert len({w % 32 for w in words}) == 32


@pytest.mark.parametrize("L,B,RB", [(4, 128, 64), (1, 128, 16),
                                    (2, 128, 32), (4, 64, 32)])
def test_bf16_fwd_chain_row_tile_at_the_main_path_shapes(L, B, RB):
    """launch_gru_fwd_chain takes the smallest row tile whose grid (H/32
    column blocks x row tiles x L) a 132-SM card holds at once, one block
    an SM (two blocks' shared memory would not fit): row 3t's encoder at
    64 rows, row 9's decoder chains at 16."""
    H, sms = 512, 132
    assert 2 * fwd_smem(H, True) > SMEM_SM
    cols = -(-H // COLS)
    fits = [rb for rb in (16, 32, 64) if cols * -(-B // rb) * L <= sms]
    assert fits and fits[0] == RB


@pytest.mark.parametrize("variant", [
    *(("float32", v) for v in fwd_ablate.EDITS),
    *(("bf16", v) for v in fwd_ablate.TC_EDITS)])
def test_fwd_ablate_edits_apply_once(variant):
    """Each ablation of the forward chain (`train/fwd_ablate.py`, its
    float32 variants and its `--bf16-chain` ones) finds every text it
    edits exactly once in the kernel source, so that the source and its
    ablations do not drift apart."""
    edits = fwd_ablate.EDITS if variant[0] == "float32" else \
        fwd_ablate.TC_EDITS
    text = (CSRC / "gru_fwd_chain.cu").read_text()
    for old, new in edits[variant[1]]:
        assert text.count(old) == 1
        text = text.replace(old, new)
