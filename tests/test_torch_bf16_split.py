"""PyTorch port, bf16 mixed precision: the arithmetic of the bf16 training
kernels' tensor-core products (`csrc/mma_bf16.cuh`) emulated in plain
PyTorch, and the tile and shared-memory arithmetic of their schedules,
read from the kernels' own constants. No card needed.

Every product of the Pallas kernels in bf16 pairs a float32 operand that
JAX keeps unrounded with a bf16 one. The kernels split the float32 operand
into three bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
- mid), and take three bf16 MMAs into one float32 accumulator, lo, mid,
then hi, a 16-deep k-step at a time. `split3` and `mma_emulated` do the
same here: each k-step's products are exact (bf16 x bf16 fits float32's
24 bits), formed in float64, and added to a float32 accumulator. At the
chain's depth (K = 3H = 1536) and the dW GEMM's (K = T*B = 12,800):

- hi + mid + lo equals x to within 2^-24 |x| (float32's unit roundoff);
- the emulated product lies within (3 K / 16 + 1) 2^-24 (|A| @ |B|) of the
  exact one, elementwise: one float32 rounding per piece and k-step, and
  the split's residue (the float32 product's own kind of bound);
- rounding the float32 operand once to bf16 instead errs by more than a
  hundred times the three-piece split's largest error: what the split
  keeps the kernels from computing.

Then the schedules: every k row of the bf16 chain's product is taken by
exactly one (slab, warp set) at each row tile and width, its warps cover
the row tile, its shared memory fits a block at H = 512 and is less than
the float32 chain's, its weight swizzle and padded ring rows put
ldmatrix's and the fragment reads' addresses on distinct banks, the GEMMs'
warp tiles cover their 128 x 128 block tile once, two GEMM blocks fit an
SM, and at the main path's shapes the chain's row tile is the one whose
grid a 132-SM card holds at once."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

CSRC = (Path(__file__).resolve().parents[1] / "music_fader_nets_tpu_torch"
        / "csrc")
U32 = 2.0 ** -24              # float32's unit roundoff
SMEM_BLOCK = 232448           # bytes of shared memory a block may use
SMEM_SM = 233472              # of an SM (228 KB)


def split3(x):
    """The three bf16 pieces of float32 x, as float32 tensors."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def mma_emulated(pieces, b):
    """sum over k of (pieces of A)(M, K) b (K, N) as the kernels form it:
    a float32 accumulator, 16-deep k-steps, each piece's exact partial
    product added in the order given (lo, mid, hi)."""
    M, K = pieces[0].shape
    bb = b.double().reshape(K // 16, 16, -1)
    prods = [torch.einsum("msk,skn->smn", p.double().reshape(M, K // 16, 16),
                          bb) for p in pieces]
    acc = torch.zeros(M, b.shape[1], dtype=torch.float32)
    for s in range(K // 16):
        for pr in prods:
            acc = (acc.double() + pr[s]).float()
    return acc


@pytest.mark.parametrize("K", [1536, 12800])
def test_three_piece_split_keeps_the_float32_product(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((32, K)).astype(np.float32))
    a[0, :8] *= 1e-30                      # tiny values split as well
    b = torch.from_numpy(rng.standard_normal((K, 24)).astype(
        np.float32)).to(torch.bfloat16).float()   # the bf16 operand
    hi, mid, lo = split3(a)
    for p in (hi, mid, lo):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    resid = (a.double() - (hi.double() + mid.double() + lo.double())).abs()
    assert bool((resid <= U32 * a.double().abs()).all())
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = (mma_emulated([lo, mid, hi], b).double() - exact).abs()
    assert bool((err3 <= (3 * K / 16 + 1) * U32 * scale).all())
    err1 = (mma_emulated([hi], b).double() - exact).abs()
    assert float(err1.max()) > 100 * float(err3.max())


# ---------------------------------------------------------------- schedules

def _constants(*files):
    """name -> value of every `constexpr int kName = <int>;` in `files`."""
    out = {}
    for f in files:
        for name, val in re.findall(r"constexpr int (k\w+) = (\d+);",
                                    (CSRC / f).read_text()):
            out[name] = int(val)
    return out


C = _constants("gru_tile.cuh", "embed_gru_bwd.cu", "grad_reduce.cu")
WARPS = C["kThreads"] // 32
TC_ROW = C["kWarpRows"] + 4                        # kTcRow
TC_BUF = WARPS * C["kChainStages"] * C["kTcK"] * TC_ROW   # kChainBufTc


def chain_tiles(RB):
    """(WR, kHalves, kSets, KT, MT) of gru_bwd_chain<RB, *, bf16>."""
    WR = min(RB, C["kWarpRows"])
    halves = RB // WR
    sets = WARPS // halves
    return WR, halves, sets, sets * C["kTcK"], WR // 16


def chain_gp(H, pad):
    return (3 * H + pad - 1) // pad * pad


def chain_smem(H, bf16):
    """chain_smem_bytes<S>(H)."""
    if bf16:
        return chain_gp(H, C["kTcGPad"]) * C["kChainCols"] * 2 + TC_BUF * 4
    f32_buf = WARPS * C["kChainStages"] * C["kWarpK"] * C["kWarpRows"]
    return (chain_gp(H, C["kChainGPad"]) * C["kChainCols"] + f32_buf) * 4


@pytest.mark.parametrize("RB", [16, 32, 64])
@pytest.mark.parametrize("H", [30, 136, 512])
def test_bf16_chain_covers_every_k_and_row_once(RB, H):
    WR, halves, sets, KT, MT = chain_tiles(RB)
    Gp = chain_gp(H, C["kTcGPad"])
    assert Gp % KT == 0 and MT * 16 == WR and halves * WR == RB
    # warp (set, half) takes k rows sl*KT + set*kTcK .. +kTcK of each slab
    # and rows half*WR .. +WR: each (k, row) once
    hits = np.zeros((Gp, RB), int)
    for w in range(WARPS):
        st, half = w // halves, w % halves
        for sl in range(Gp // KT):
            k0 = sl * KT + st * C["kTcK"]
            hits[k0:k0 + C["kTcK"], half * WR:half * WR + WR] += 1
    assert (hits == 1).all()
    # the sets' partial tiles and the transpose buffer fit the ring's
    assert sets * RB * C["kChainCols"] <= TC_BUF
    assert (RB // 4) * (3 * C["kChainCols"] + 1) * 4 <= TC_BUF
    # a warp's ring: kChainStages slabs of kTcK rows of WR + 4 floats
    assert C["kChainStages"] * C["kTcK"] * (WR + 4) <= TC_BUF // WARPS


def test_bf16_chain_shared_memory_fits():
    assert chain_smem(512, True) == 172032
    assert chain_smem(512, True) <= SMEM_BLOCK
    assert chain_smem(512, True) < chain_smem(512, False) <= SMEM_BLOCK


def _swz(k, c):
    """embed_gru_bwd.cu::swz: the bf16 weight slab's element offset."""
    return k * C["kChainCols"] + ((((c >> 3) ^ (k >> 1)) & 3) << 3) + (c & 7)


def test_shared_memory_reads_fall_on_distinct_banks():
    # ldmatrix of the weight slab: 8 consecutive k rows, one 16-byte chunk
    for k0 in range(0, 64, 8):
        for c in range(0, C["kChainCols"], 8):
            slots = {(2 * _swz(k0 + r, c)) % 128 // 16 for r in range(8)}
            assert len(slots) == 8
    # the slab stays a permutation of each row's 32 columns
    for k in range(16):
        assert sorted(_swz(k, c) for c in range(32)) == list(
            range(32 * k, 32 * k + 32))
    g, q = np.arange(32) // 4, np.arange(32) % 4
    # the chain's A fragment reads ring[2q + e][g] (rows of WR + 4 floats)
    # and gemm_tn_tc's B fragment reads B[2q + e][g] (rows of kBN + 4)
    for stride in (16 + 4, 32 + 4, C["kBN"] + 4):
        for e in (0, 1, 8, 9):
            assert len(set(((2 * q + e) * stride + g) % 32)) == 32
    # gemm_tn_tc's A rows (kBM + 8 bf16) and gemm_nn_tc's bf16 A rows
    # (kBK + 8 bf16): ldmatrix's 8 rows on distinct 16-byte slots
    for row_bytes in (2 * (C["kBM"] + 8), 2 * (C["kBK"] + 8)):
        assert len({r * row_bytes % 128 // 16 for r in range(8)}) == 8
    # gemm_nn_tc's float32 A fragment: float2 at [g][2q] of 24-float rows,
    # a half-warp a phase
    for half in (0, 16):
        lanes = np.arange(half, half + 16)
        words = [(l // 4) * (C["kBK"] + 8) + 2 * (l % 4) + w
                 for l in lanes for w in (0, 1)]
        assert len({w % 32 for w in words}) == 32


@pytest.mark.parametrize("wm,wn", [(64, 32), (32, 64)])
def test_gemm_warp_tiles_cover_the_block_tile(wm, wn):
    """gemm_tn_tc (warps of 64 x 32) and gemm_nn_tc (32 x 64): 8 warps,
    16 x 8 MMA tiles, every output of the 128 x 128 tile once."""
    hits = np.zeros((C["kBM"], C["kBN"]), int)
    per_row = C["kBN"] // wn
    for w in range(WARPS):
        r0, c0 = (w // per_row) * wm, (w % per_row) * wn
        for i in range(wm // 16):
            for j in range(wn // 8):
                hits[r0 + 16 * i:r0 + 16 * i + 16,
                     c0 + 8 * j:c0 + 8 * j + 8] += 1
    assert (hits == 1).all()


def test_gemm_shared_memory_takes_two_blocks_an_sm():
    st, bk, bm = C["kStages"], C["kBK"], C["kBM"]
    tn = st * bk * ((bm + 8) * 2 + (C["kBN"] + 4) * 4)   # kGemmTcSmem
    nn32 = st * (bm * (bk + 8) * 4 + bk * (C["kBN"] + 8) * 2)
    nn16 = st * (bm * (bk + 8) * 2 + bk * (C["kBN"] + 8) * 2)
    assert (tn, nn32, nn16) == (51200, 66560, 41984)
    assert 2 * max(tn, nn32, nn16) <= SMEM_SM


@pytest.mark.parametrize("L,B,RB", [(4, 128, 64), (2, 128, 32),
                                    (1, 128, 16), (2, 37, 16)])
def test_bf16_chain_row_tile_at_the_main_path_shapes(L, B, RB):
    """launch_chain takes the smallest row tile whose grid (H/32 column
    blocks x row tiles x L) a 132-SM card holds at once, one block an SM
    (a block's 172 KB leave no room for a second)."""
    H, sms = 512, 132
    assert 2 * chain_smem(H, True) > SMEM_SM
    cols = (H + C["kChainCols"] - 1) // C["kChainCols"]
    fits = [rb for rb in (16, 32, 64) if cols * -(-B // rb) * L <= sms]
    assert fits and fits[0] == RB
