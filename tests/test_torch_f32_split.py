"""PyTorch port, float32 training: the arithmetic of the float32 dW GEMM
on the tensor cores (`csrc/grad_reduce.cu::gemm_tn_wg_kernel`) emulated in
plain PyTorch, and its tile and shared-memory layout, read from the
kernel's own constants. No card needed.

dW = A^T B sums T*B = 12,800 products of two float32 operands (h_prev and
the gate cotangents), and the training cells hold it to float32. The
kernel splits both operands into three bf16 pieces, x = hi + mid + lo
(`mma_bf16.cuh::split3`), and takes six of the nine piece products for
each 16-deep k-step, lowest order first: mid.mid, hi.lo, lo.hi (order
2^-16), hi.mid, mid.hi (2^-8), hi.hi, into a float32 step accumulator
that is then added into the float32 sum. `split_gemm_emulated` does the
same here (each piece product exact, formed in float64; every addition
rounded to float32). Left out are mid.lo, lo.mid and lo.lo, of order
2^-24 of a product and below. At the chain's depth (K = 1,536) and the dW
GEMM's (K = 12,800):

- the emulated product lies within (K / 16 + 9) 2^-24 (|A|^T |B|) of the
  exact one, elementwise: one float32 rounding of the sum a k-step (K /
  16), six roundings of the step's own products, the three products left
  out (2 x 2^-24 and less) and the split's residue;
- plain TF32 (each operand's 13 low significand bits cleared, products
  summed exactly) errs by more than a hundred times the split's largest
  error: what the split keeps the kernel from computing;
- leaving out the 2^-16 terms (hi.hi, hi.mid, mid.hi alone) errs by more
  than three times as much (five to seventeen times on these inputs): a
  split that drops them is not float32.

Then the layout: the two multiplying warpgroups' m64n128 accumulators
cover the 128 x 128 block tile once, the splitting threads' reads of the
float32 slab and their 8-byte stores fill each piece's swizzled MN-major
atoms once on distinct banks, and the rings and registers fit the one
block an SM holds; and every float32 dW GEMM of the training cells meets
the rule by which the tensor cores take a call."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.train import dw_gemm

CSRC = (Path(__file__).resolve().parents[1] / "music_fader_nets_tpu_torch"
        / "csrc")
U32 = 2.0 ** -24              # float32's unit roundoff
SMEM_BLOCK = 232448           # bytes of shared memory a block may use
STEP = 16                     # k of one wgmma k-step


def split3(x):
    """The three bf16 pieces of float32 x, as float32 tensors."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


# (A piece, B piece) in the kernel's order: 0 hi, 1 mid, 2 lo
SIX = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
THREE = ((0, 1), (1, 0), (0, 0))


def split_gemm_emulated(a, b, products=SIX):
    """A^T B for A (K, M), B (K, N) as the kernel forms it: per 16-deep
    k-step the given piece products, each exact, added in order into a
    float32 step sum, which is then added into the float32 sum."""
    K, M = a.shape
    pa = [p.double().reshape(K // STEP, STEP, M) for p in split3(a)]
    pb = [p.double().reshape(K // STEP, STEP, -1) for p in split3(b)]
    prods = [torch.einsum("skm,skn->smn", pa[i], pb[j]) for i, j in products]
    acc = torch.zeros(M, b.shape[1], dtype=torch.float32)
    for s in range(K // STEP):
        step = prods[0][s].float()
        for pr in prods[1:]:
            step = (step.double() + pr[s]).float()
        acc = (acc.double() + step.double()).float()
    return acc


def tf32(x):
    """x with its 13 low significand bits cleared (TF32's 10 + 1 bits)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("K", [1536, 12800])
def test_split_of_both_operands_keeps_the_float32_product(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.uniform(-1, 1, (K, 24)).astype(np.float32))
    b = torch.from_numpy(
        (rng.standard_normal((K, 16)) * 1e-3).astype(np.float32))
    a[:8, 0] *= 1e-30                      # tiny values split as well
    for x in (a, b):
        hi, mid, lo = split3(x)
        resid = (x.double() - (hi.double() + mid.double() + lo.double()))
        assert bool((resid.abs() <= U32 * x.double().abs()).all())
    exact = a.double().T @ b.double()
    scale = a.double().abs().T @ b.double().abs()
    err6 = (split_gemm_emulated(a, b).double() - exact).abs()
    assert bool((err6 <= (K / STEP + 9) * U32 * scale).all())
    err_tf32 = (tf32(a).double().T @ tf32(b).double() - exact).abs()
    assert float((err_tf32 / scale).max()) > 100 * float(
        (err6 / scale).max())
    err3 = (split_gemm_emulated(a, b, THREE).double() - exact).abs()
    assert float((err3 / scale).max()) > 3 * float((err6 / scale).max())


# ---------------------------------------------------------------- layout

def _constants(*files):
    """name -> value of every `constexpr int kName = <int>;` in `files`."""
    out = {}
    for f in files:
        for name, val in re.findall(r"constexpr int (k\w+) = (\d+);",
                                    (CSRC / f).read_text()):
            out[name] = int(val)
    return out


C = _constants("grad_reduce.cu")
SPLIT = C["kWgSplit"]                        # splitting threads, first
WARPGROUPS = (C["kWgThreads"] - SPLIT) // 128   # multiplying
PIECE = C["kBM"] * C["kBK"] * 2              # kWgPiece, bytes


def piece_offset(r, k):
    """grad_reduce.cu::piece_offset: byte of (row r, k) in a piece, MN-major
    128-byte-swizzled atoms of 8 k x 64 rows (the 16-byte chunk c of atom
    row k at chunk c ^ k), two along the rows 1024 bytes apart (the
    descriptor's LBO), two along k 2048 bytes apart (its SBO)."""
    return ((k >> 3) * 2048 + (r >> 6) * 1024 + (k & 7) * 128
            + ((((r >> 3) & 7) ^ (k & 7)) << 4) + (r & 7) * 2)


def split_jobs(t):
    """(row, k) of the four-float groups splitting thread t takes of A's
    and of B's 16 x 128 slab: rows 4 (t % 32) .. +4, k = t / 32 + 8 j."""
    return [(4 * (t % 32), t // 32 + 8 * j) for j in range(2)]


def test_wgmma_accumulators_cover_the_block_tile_once():
    """Multiplying warpgroup wg (threads kWgSplit + 128 wg ..), warp w,
    lane 4 g + q: d[4 j + 2 h + e] is row 64 wg + 16 w + g + 8 h, column
    8 j + 2 q + e of the tile (the m64nNk16 accumulator), j < kBN / 8."""
    assert WARPGROUPS * C["kWgRows"] == C["kBM"] and C["kWgRows"] == 64
    hits = np.zeros((C["kBM"], C["kBN"]), int)
    for tid in range(SPLIT, C["kWgThreads"]):
        wg, w, lane = (tid - SPLIT) // 128, (tid // 32) % 4, tid % 32
        g, q = lane // 4, lane % 4
        for j in range(C["kBN"] // 8):
            for h in range(2):
                for e in range(2):
                    hits[64 * wg + 16 * w + g + 8 * h, 8 * j + 2 * q + e] += 1
    assert (hits == 1).all()


def test_split_stores_fill_each_piece_once_on_distinct_banks():
    assert C["kBM"] == C["kBN"] == 128 and C["kBK"] == 16 and SPLIT == 256
    offs = sorted(piece_offset(r, k) // 2 for r in range(C["kBM"])
                  for k in range(C["kBK"]))
    assert offs == list(range(PIECE // 2))
    # each thread's four rows are contiguous: one 8-byte store a group
    seen = []
    for t in range(SPLIT):
        for r, k in split_jobs(t):
            o = piece_offset(r, k)
            assert [piece_offset(r + e, k) for e in range(4)] == [
                o, o + 2, o + 4, o + 6]
            seen.append(o)
    assert sorted(seen) == list(range(0, PIECE, 8))
    # an 8-byte store is served 16 lanes at a time: distinct banks; the
    # 16-byte reads of the float32 slab (k rows of 128 floats, as the TMA
    # lands a 128 x 16 box) 8 lanes at a time, one 128-byte row
    for j in range(2):
        for t0 in range(0, SPLIT, 16):
            words = {(piece_offset(*split_jobs(t)[j]) // 4 + w) % 32
                     for t in range(t0, t0 + 16) for w in (0, 1)}
            assert len(words) == 32
        for t0 in range(0, SPLIT, 8):
            reads = sorted((k * 128 + r) * 4 for r, k in
                           (split_jobs(t)[j] for t in range(t0, t0 + 8)))
            assert reads == list(range(reads[0], reads[0] + 128, 16))


def test_wgmma_rings_fit_one_block_an_sm():
    st, nb = C["kWgStages"], C["kWgBufs"]
    slab = C["kBK"] * C["kBM"] * 4
    smem = 1024 + nb * 6 * PIECE + st * 2 * slab + (2 * nb + st) * 8
    assert smem <= SMEM_BLOCK                               # kGemmWgSmem
    # a block's threads take every register of an SM: one block an SM;
    # setmaxnreg gives a multiplying thread its two 64-float accumulators
    # and room besides
    assert C["kWgThreads"] * 128 == 65536
    split_regs, mul_regs = C["kWgSplitRegs"], C["kWgMulRegs"]
    assert split_regs % 8 == 0 and mul_regs % 8 == 0 and split_regs >= 24
    assert mul_regs >= 2 * 64 + 32
    assert SPLIT * split_regs + (C["kWgThreads"] - SPLIT) * mul_regs <= 65536
    # the products of one split slab run while the next ones are split
    assert nb >= 3 and st >= 3 and C["kWgPromote"] >= 1


@pytest.mark.parametrize("name", sorted(dw_gemm.shapes(ModelConfig())))
def test_every_training_dw_gemm_takes_the_tensor_cores(name):
    """The float32 gemm_tn calls of the training cells' backward (h_prev's
    seam after B = 128 rows of h0, or none) all meet the tensor-core
    kernel's rule; a seam off a 16-row slab or rows of 130 floats keep the
    CUDA-core kernel."""
    L, M, N, K, n0 = dw_gemm.shapes(ModelConfig())[name]
    assert n0 in (0, ModelConfig().batch_size)
    assert dw_gemm.tensor_cores_take(M, N, K, n0)
    assert not dw_gemm.tensor_cores_take(M, N, K, 37)
    assert not dw_gemm.tensor_cores_take(130, N, K, n0)
