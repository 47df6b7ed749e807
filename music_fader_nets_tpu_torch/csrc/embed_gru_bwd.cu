// Embedded-id GRU kernels, backward: the gradient of L stacked GRU
// directions from their gate stash.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_bwd_embed_kernel
// (backward of stacked_gru_embed_finals, the encoder: cotangent on the
// final states only) and ::_bwd_embed_seq_kernel (backward of
// stacked_gru_embed_seq, the sub-decoders: a cotangent on every step).
// fader_embed_gru_bwd takes either cotangent form (`seq_grad`);
// fader_embed_seq_bwd is the sub-decoders' own entry for class tables of at
// most kSeqClasses (16) rows, the model's. The chain also serves
// stacked_gru.cu's backward (kernel 2) and, once a layer, the
// teacher-forced decoder's (decoder_ce_bwd.cu, kernels 8 and 10).
//
// What it computes, walking t from T-1 down to 0 with dh = 0:
//   dh      += g_t                      (g_fin at t = T-1, or g_seq[t])
//   dpre_x, dpre_h = gate_bwd(dh, stash[t], h_prev(t))   (_gate_bwd :1205)
//   dh       = dh * z + dpre_h @ w_hh^T
// then, from the dpre rows of all steps:
//   dW_in[v] = sum of dpre_x over the (t, b) whose id is v (by row id)
//   db_in    = sum of dpre_x      (encoder)  | dprez[b] = sum_t dpre_x[t, b]
//   dW_hh    = h_prev^T dpre_h,  db_hh = sum of dpre_h,  dh0 = dh.
//
// What bounds it on an H100: float32 FMA. Encoder, B=128: the chain is
// 4 x 100 x 2 x 128 x 1536 x 512 = 80.5 GFLOP and dW_hh as much again,
// 2.4 ms at 67 TFLOP/s; the dpre stashes (2 x 315 MB) are written once and
// read once.
//
// Design: the chain is ONE persistent, cooperatively launched kernel for
// all T steps (gru_bwd_chain), for both cotangent forms. A block owns 32
// hidden units of a 32- or 64-row tile of one direction for the whole call
// and keeps its 32 columns of w_hh^T (3H x 32 floats, 196 KB at H = 512) in
// shared memory, so the weights leave L2 once a call, and its dh tile in
// registers, so dh never touches device memory. A step is: the gate
// backward of the block's own units only (inputs loaded a step ahead),
// written, transposed through shared memory, to a small k-major scratch
// (3H x B, double-buffered over t); an arrive on the barrier of the H/32
// blocks that share the row tile (a counter in device memory; the
// cooperative launch guarantees they are all resident); the stores of
// dpx[t] / dph[t] for the weight gradients and the next step's loads while
// the others arrive; then the 3H-deep product: each warp copies the k rows
// it multiplies itself (8 of every slab, for 32 rows of the tile) through a
// cp.async ring of its own, so the product loop has no block-wide barrier,
// with an 8 x 4 register tile a lane (4 x 4 in a 16-row tile, where all 8
// warps split k); the warps' partial tiles are added in a fixed order
// through shared memory. The row tile is the smallest of 16, 32 and 64 rows
// whose grid is co-resident, so that the grid fills the card (128 blocks at
// H=512, B=128: 64 rows at L=4, 32 at L=2, 16 for the decoder's L=1 chains;
// 64 rows for those at the masses head's 512 rows); if none is, or the
// weights do not fit, the launch fails and the error is returned. The
// product loop is bound by shared-memory bandwidth, not by FMAs: a lane
// reads 12 words for 32 FMAs (8 for 16 in a 16-row tile), and the slabs
// landing in shared memory take their share of the same port. The weight
// gradients are grad_reduce.cu's deterministic GEMM, scatter and sums.
//
// The sub-decoders' mode (gru_bwd_chain<RB, true>, fader_embed_seq_bwd;
// L=2, T=16, B=128, H=512, 16 class rows): at T=16 a call's fixed costs
// weigh (the parent design's 7 kernels, a transpose and 100 MB of stash
// round trips), so the cheap reductions move into the chain and dpre_x
// never reaches device memory. The recurrence is the other mode's, sum for
// sum. A block reads w_hh itself (no transposed copy), staged through a
// cp.async ring; each thread keeps, over all steps, its rows' dprez (a
// block owns those rows and units, so they are stored once at the end),
// its unit's db_hh over its rows and its unit's dW_emb row of each class
// (16 x 3 registers, a predicated add for each class: branches on the
// warp-uniform class cost more, summing after the loop from the stash more
// still). At the end the 8 warps' sums are added in warp order through
// shared memory into a partial per row tile, and the last row tile of a
// unit block to arrive (an atomic counter) adds the tiles' partials in
// tile order: every sum has a fixed order, no float atomics. dW_hh stays
// the split-K GEMM over the dph stash: 3 kernels and 1 memset a call.
//
// bf16 storage (mixed-precision training): the chain is instantiated on S,
// the type of what it reads from the forward (stash, h_seq, h0) and of
// w_hh. Loads widen to float; dh, the gate backward and every sum stay
// float32 and dpx / dph / dh0 / dprez / dW_emb / db_hh are written in
// float32, as the Pallas kernels keep dpre_x, dpre_h and their
// accumulators in f32 scratch (pallas_gru.py:596-603); the caller rounds
// what the Pallas kernels return in the input's dtype. The backward thus
// recomputes from the bf16-rounded h_seq and gate stash, as the Pallas
// backward does (:566-570), while the forward ran on the float32 carry.
// The product dh += dph @ w_hh^T pairs the float32 dph with the bf16
// weight, as the Pallas kernels' dot does (:589, preferred f32): in bf16 it
// runs on the tensor cores. The block keeps its 32 columns of w_hh^T as
// bf16 (3H x 32, 96 KB at H = 512, rows zero-padded to a multiple of 128;
// 16-byte chunks XOR-swizzled by row so that ldmatrix's 8 rows fall on
// distinct banks); warp (set, half) takes 16 k rows of each slab (KT =
// kSets * 16 rows) and rows half*WR .. +WR of the tile, copies its dph rows
// through its own cp.async ring (rows padded to WR + 4 floats: its
// fragment reads fall on distinct banks), splits them into three bf16
// pieces and runs mma.sync.m16n8k16 (three a product, mma_bf16.cuh) over
// its WR x 32 outputs; the sets' partial tiles are added in set order as
// in the float path. The gate phase, the barrier and the epilogue are the
// float path's. Kernel 2's bf16 backward (stacked_gru.cu) reads no stash:
// with pre_h given, the chain rebuilds r, z, n and hn from pre and pre_h =
// h_prev @ w_hh + b_hh, as pallas_gru.py::_bwd_kernel does (:254-263).
#include <type_traits>

#include "gru_tile.cuh"
#include "mma_bf16.cuh"
#include "train_ops.cuh"

namespace fader {

// ----------------------------------------------------------------------
// The persistent chain.

constexpr int kChainCols = 32;    // hidden units (dh columns) a block owns
constexpr int kChainStages = 4;   // slabs in a warp's ring
constexpr int kWarpK = 8;         // k rows of a slab that one warp multiplies
constexpr int kWarpRows = 32;     // most rows of the tile one warp multiplies
constexpr int kChainGPad = 64;    // the weights' k is zero-padded to this
// ring | transpose buffer | partial tiles share these floats of a block
constexpr int kChainBuf = kWarps * kChainStages * kWarpK * kWarpRows;
// the bf16 chain's product (tensor cores): k rows of a slab one warp
// multiplies (an MMA's depth), the weights' k padding, and a warp's ring
// rows (floats), whose buffer the transpose and partial tiles share
constexpr int kTcK = 16;
constexpr int kTcGPad = 128;
constexpr int kTcRow = kWarpRows + 4;
constexpr int kChainBufTc = kWarps * kChainStages * kTcK * kTcRow;

template <typename S>
struct ChainParams {
  int L, T, B, H, Bp;
  const float* g;
  long long g_ls, g_ts;
  int g_every_step;
  const S* stash;
  const S* h_seq;
  const S* h0;
  const S* w_hhT;
  float* dpx;
  float* dph;
  float* dh0;
  float* dphT;          // (2, L, 3H, Bp): dph[t] of step parity t & 1, k-major
  unsigned* counters;   // one per (direction, row tile), kCtrStride apart
  const S* pre;         // bf16 with pre_h: (L, T, B, 3H) read in place of
  const float* pre_h;   // the stash (kernel 2's recompute), else null
};

// ----------------------------------------------------------------------
// The sub-decoders' mode of the chain (gru_bwd_chain<RB, true>): what it
// adds to the chain's steps, kept apart so that the other mode compiles as
// it did.

constexpr int kSeqClasses = 16;   // most class rows it sums in registers
// k columns of w_hh a block stages at a time, in a ring of kStageBufs
// [32][kStageK + 1] tiles (a row stride of 1 modulo 32 banks)
constexpr int kStageK = 64;
constexpr int kStageBufs = 3;

template <typename S>
struct SeqChainParams : ChainParams<S> {
  const int* ids;       // (L, T, B) class ids; rows outside [0, V) add nothing
  int V;                // class rows, at most kSeqClasses
  const S* w_hh;        // (L, H, 3H), read in place of w_hhT
  float* dprez;         // (L, B, 3H)
  float* dw_emb;        // (L, V, 3H)
  float* db_hh;         // (L, 3H)
  float* part;          // (L, row tiles, V + 1, 3H): the tiles' class and
                        // bias partials
  unsigned* done;       // one per (direction, unit block), kCtrStride apart
};

template <bool kSeq, typename S>
using ChainParamsOf =
    typename std::conditional<kSeq, SeqChainParams<S>, ChainParams<S>>::type;

// What a thread keeps over all steps: the classes of its rows at the step
// to come, its rows' dprez, and its unit's db_hh and dW_emb rows over its
// rows. The other mode keeps nothing (NoSums).
template <int RT>
struct SeqSums {
  int id[RT];
  float x[RT][3] = {};
  float b[3] = {};
  float c[kSeqClasses][3] = {};
};
struct NoSums {};

// s[0..2] += (x, y, z) where `take`: predicated adds, so that the caller's
// register arrays keep static indices
__device__ __forceinline__ void add_if(bool take, float (&s)[3], float x,
                                       float y, float z) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ne.s32 p, %3, 0;\n\t"
      "@p add.rn.f32 %0, %0, %4;\n\t"
      "@p add.rn.f32 %1, %1, %5;\n\t"
      "@p add.rn.f32 %2, %2, %6;\n\t}"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2])
      : "r"((int)take), "f"(x), "f"(y), "f"(z));
}

// sW[k][c] = w_hh[l][c0 + c][k] (zero past G or H): w_hh's rows c0 ..
// c0+31 transposed through a ring of staging tiles in `buf`, cp.async
// copies of the rows, coalesced, two tiles ahead; both shared-memory passes
// free of bank conflicts.
__device__ __forceinline__ void seq_stage_w_hh(
    const SeqChainParams<float>& p, float* sW, float* buf, int l, int c0,
    int Gp) {
  constexpr int kRow = kStageK + 1;
  constexpr int kPer = kChainCols * kStageK / kThreads;
  static_assert(kStageBufs * kChainCols * kRow <= kChainBuf, "ring fits");
  const int H = p.H, G = 3 * H, tid = threadIdx.x;
  const float* wl = p.w_hh + (size_t)l * H * G;
  const int nch = (Gp + kStageK - 1) / kStageK;
  auto stage = [&](int ch) {
    if (ch < nch) {
      float* stg = buf + (ch % kStageBufs) * kChainCols * kRow;
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int idx = tid + n * kThreads;
        const int c = idx / kStageK, kk = idx % kStageK;
        const int k = ch * kStageK + kk;
        const bool ok = k < G && c0 + c < H;
        cp_async<4>(stg + c * kRow + kk,
                    ok ? wl + (size_t)(c0 + c) * G + k : wl, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < kStageBufs - 1; ++ch) stage(ch);
  for (int ch = 0; ch < nch; ++ch) {
    // the tile refilled here was read at ch - 1, which every thread left
    stage(ch + kStageBufs - 1);
    cp_async_wait<kStageBufs - 1>();
    __syncthreads();
    const float* stg = buf + (ch % kStageBufs) * kChainCols * kRow;
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int idx = tid + n * kThreads;
      const int kk = idx / kChainCols, c = idx % kChainCols;
      const int k = ch * kStageK + kk;
      if (k < Gp) sW[(size_t)k * kChainCols + c] = stg[c * kRow + kk];
    }
    __syncthreads();
  }
}

// sWb[k][c] = w_hh[l][c0 + c][k] (zero past G or H), bf16 as stored: from
// w_hhT (k-major, `k_major`; reads coalesced over c) or w_hh (the
// sub-decoders' mode; reads coalesced over k).
__device__ __forceinline__ void stage_w_bf16(const bf16* wl, bool k_major,
                                             bf16* sWb, int H, int c0,
                                             int Gp) {
  const int G = 3 * H;
  for (int idx = threadIdx.x; idx < kChainCols * Gp; idx += kThreads) {
    const int k = k_major ? idx / kChainCols : idx % Gp;
    const int c = k_major ? idx % kChainCols : idx / Gp;
    bf16 v = __float2bfloat16_rn(0.f);
    if (k < G && c0 + c < H)
      v = k_major ? wl[(size_t)k * H + c0 + c] : wl[(size_t)(c0 + c) * G + k];
    sWb[swz(k, c)] = v;
  }
  __syncthreads();
}

// s.id = the classes of the thread's rows at step t (-1 for a pad row or
// an id outside [0, V)); a row's class is the same for every lane.
template <int RB, typename S>
__device__ __forceinline__ void seq_load_ids(const SeqChainParams<S>& p,
                                             SeqSums<RB / 8>& s, int l,
                                             int t, int b0, int warp) {
#pragma unroll
  for (int i = 0; i < RB / 8; ++i) {
    const int b = b0 + chain_row<RB>(warp, i);
    int id = -1;
    if (b < p.B) id = p.ids[((size_t)l * p.T + t) * p.B + b];
    s.id[i] = (id >= 0 && id < p.V) ? id : -1;
  }
}

// One step's dpre values of the thread's rows into its sums, in t order
// T-1 .. 0 and, within a step, in row order (pad rows and columns hold
// zeros and class -1); the class by a predicated add for each class.
template <int RT>
__device__ __forceinline__ void seq_add(SeqSums<RT>& s, const float (&dar)[RT],
                                        const float (&daz)[RT],
                                        const float (&dan)[RT],
                                        const float (&dhn)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    s.x[i][0] += dar[i];
    s.x[i][1] += daz[i];
    s.x[i][2] += dan[i];
    s.b[0] += dar[i];
    s.b[1] += daz[i];
    s.b[2] += dhn[i];
    const int id = s.id[i];
#pragma unroll
    for (int v = 0; v < kSeqClasses; ++v)
      add_if(id == v, s.c[v], dar[i], daz[i], dan[i]);
  }
}

// After the last step: the thread's dprez rows, stored once (the block
// owns them); the tile's class and bias partials, the warps' sums added in
// warp order through `buf` (free since the loop's last barrier), one gate
// at a time, row V of a tile's partials being the bias; then the last of
// the unit block's row tiles to arrive adds the tiles' partials in tile
// order: the same bits whichever block is last.
template <int RB, typename S>
__device__ __forceinline__ void seq_finish(const SeqChainParams<S>& p,
                                           const SeqSums<RB / 8>& s,
                                           float* buf, int l, int b0,
                                           int c0) {
  const int B = p.B, H = p.H, G = 3 * H, V = p.V, ntile = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = c0 + lane;
#pragma unroll
  for (int i = 0; i < RB / 8; ++i) {
    const int b = b0 + chain_row<RB>(warp, i);
    if (j < H && b < B) {
      float* pz = p.dprez + ((size_t)l * B + b) * G;
      pz[j] = s.x[i][0];
      pz[H + j] = s.x[i][1];
      pz[2 * H + j] = s.x[i][2];
    }
  }
  constexpr int kRows = kSeqClasses + 1;
  float* part = p.part + (size_t)l * ntile * (V + 1) * G;
  // (selects by gate keep the register arrays' indices static)
  auto pick = [](const float (&x)[3], int gate) {
    return gate == 0 ? x[0] : gate == 1 ? x[1] : x[2];
  };
  for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
    for (int v = 0; v < kSeqClasses; ++v)
      buf[(warp * kRows + v) * kChainCols + lane] = pick(s.c[v], gate);
    buf[(warp * kRows + kSeqClasses) * kChainCols + lane] = pick(s.b, gate);
    __syncthreads();
    for (int idx = tid; idx < (V + 1) * kChainCols; idx += kThreads) {
      const int v = idx / kChainCols, c = idx % kChainCols;
      const int row = v == V ? kSeqClasses : v;
      float sum = buf[row * kChainCols + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        sum += buf[(w * kRows + row) * kChainCols + c];
      if (c0 + c < H)
        part[((size_t)blockIdx.y * (V + 1) + v) * G + gate * H + c0 + c] =
            sum;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(buf);
  if (tid == 0) {
    const unsigned n =
        atomicAdd(p.done + (l * gridDim.x + blockIdx.x) * kCtrStride, 1u);
    *last = n == (unsigned)ntile - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int idx = tid; idx < (V + 1) * 3 * kChainCols; idx += kThreads) {
    const int v = idx / (3 * kChainCols), gc = idx % (3 * kChainCols);
    const int c = c0 + gc % kChainCols;
    if (c >= H) continue;
    const size_t col = (size_t)v * G + (gc / kChainCols) * H + c;
    float sum = __ldcg(part + col);
    for (int y = 1; y < ntile; ++y)
      sum += __ldcg(part + (size_t)y * (V + 1) * G + col);
    if (v < V)
      p.dw_emb[(size_t)l * V * G + col] = sum;
    else
      p.db_hh[(size_t)l * G + (col - (size_t)V * G)] = sum;
  }
}

// k rows of the block's weight slab (3H zero-padded)
template <typename S>
__host__ __device__ inline int chain_gp(int H) {
  constexpr int pad = is_f32<S> ? kChainGPad : kTcGPad;
  return (3 * H + pad - 1) / pad * pad;
}

template <typename S>
inline size_t chain_smem_bytes(int H) {
  const size_t Gp = chain_gp<S>(H);
  if constexpr (is_f32<S>)
    return (Gp * kChainCols + kChainBuf) * sizeof(float);
  else
    return Gp * kChainCols * sizeof(bf16) + kChainBufTc * sizeof(float);
}

template <int RB, bool kSeq, typename S>
__global__ void __launch_bounds__(kThreads, 1)
    gru_bwd_chain(ChainParamsOf<kSeq, S> p) {
  static_assert(RB == 16 || RB == 32 || RB == 64, "row tiles of 16-64");
  constexpr int RT = RB / 8;      // rows a thread owns (gate phase, epilogue)
  constexpr int NQ = RB / 4;      // row quads of the tile
  constexpr int WR = RB < kWarpRows ? RB : kWarpRows;   // a warp's rows
  constexpr int LR = WR / 4;      // a lane's register tile: LR rows x 4 cols
  constexpr int kHalves = RB / WR;            // warps side by side over rows
  constexpr int kSets = kWarps / kHalves;     // warps that split a slab's k
  constexpr int KK = kSets * kWarpK;          // k rows of a slab
  constexpr int kTStride = 3 * kChainCols + 1;   // float4s a quad of sT
  constexpr int kBuf = is_f32<S> ? kChainBuf : kChainBufTc;
  static_assert(NQ * kTStride * 4 <= kBuf, "transpose buffer fits");
  static_assert(kSets * RB * kChainCols <= kBuf, "partial tiles fit");
  extern __shared__ float4 smem4[];
  const int T = p.T, B = p.B, H = p.H, G = 3 * H, Bp = p.Bp;
  const int Gp = chain_gp<S>(H);
  float* sW = reinterpret_cast<float*>(smem4);       // [Gp][32] (float)
  bf16* sWb = reinterpret_cast<bf16*>(smem4);        // [Gp][32] (bf16)
  float* buf;                                        // ring | sT | red
  if constexpr (is_f32<S>)
    buf = sW + (size_t)Gp * kChainCols;
  else
    buf = reinterpret_cast<float*>(sWb + (size_t)Gp * kChainCols);
  const int l = blockIdx.z, b0 = blockIdx.y * RB, c0 = blockIdx.x * kChainCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = c0 + lane;
  const bool col_ok = j < H;
  const size_t BH = (size_t)B * H;

  const S* wl = p.w_hhT + (size_t)l * G * H;
  if constexpr (!is_f32<S>) {
    if constexpr (kSeq)
      stage_w_bf16(p.w_hh + (size_t)l * H * G, false, sWb, H, c0, Gp);
    else
      stage_w_bf16(wl, true, sWb, H, c0, Gp);
  } else if constexpr (kSeq) {
    seq_stage_w_hh(p, sW, buf, l, c0, Gp);
  } else {
    for (int idx = tid; idx < Gp * kChainCols; idx += kThreads) {
      const int k = idx / kChainCols, c = idx % kChainCols;
      sW[idx] =
          (k < G && c0 + c < H) ? to_f32(wl[(size_t)k * H + c0 + c]) : 0.f;
    }
  }

  // gate inputs of the step to come, loaded a step ahead
  float in_r[RT], in_z[RT], in_n[RT], in_hn[RT], in_hp[RT], in_g[RT];
  auto prefetch = [&](int t) {
    const S* hp =
        t == 0 ? p.h0 + l * BH : p.h_seq + ((size_t)l * T + t - 1) * BH;
    const bool add_g = p.g_every_step || t == T - 1;
    const float* gt = p.g + l * p.g_ls + (p.g_every_step ? t * p.g_ts : 0);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + chain_row<RB>(warp, i);
      in_r[i] = in_z[i] = in_n[i] = in_hn[i] = in_hp[i] = in_g[i] = 0.f;
      if (col_ok && b < B) {
        bool stashed = true;
        if constexpr (!is_f32<S>) {
          if (p.pre_h != nullptr) {   // kernel 2: r, z, n from pre, pre_h
            const size_t at = (((size_t)l * T + t) * B + b) * G;
            const S* px = p.pre + at;
            const float* ph = p.pre_h + at;
            gru_gates(to_f32(px[j]), to_f32(px[H + j]), to_f32(px[2 * H + j]),
                      ph[j], ph[H + j], ph[2 * H + j], 0.f, in_r[i],
                      in_z[i], in_n[i]);
            in_hn[i] = ph[2 * H + j];
            stashed = false;
          }
        }
        if (stashed) {
          const S* st = p.stash + (((size_t)l * T + t) * B + b) * 4 * H;
          in_r[i] = to_f32(st[j]);
          in_z[i] = to_f32(st[H + j]);
          in_n[i] = to_f32(st[2 * H + j]);
          in_hn[i] = to_f32(st[3 * H + j]);
        }
        in_hp[i] = to_f32(hp[(size_t)b * H + j]);
        if (add_g) in_g[i] = gt[(size_t)b * H + j];
      }
    }
  };

  unsigned* ctr = p.counters + (l * gridDim.y + blockIdx.y) * kCtrStride;
  const unsigned group = gridDim.x;     // blocks that share this row tile
  // product phase: warp (set, half) multiplies k = set*8 .. set*8+7 of each
  // slab (bf16: set*16 .. set*16+15) with rows half*WR .. +WR of the tile,
  // which it alone loads into a ring of its own; lane (ry, cx) holds rows
  // ry*LR .. +LR of those and columns cx*4 .. +4 (bf16: MMA fragments)
  const int set = warp / kHalves, half = warp % kHalves;
  const int ry = lane >> 3, cx = lane & 7;
  float* ring = buf + warp * (is_f32<S> ? kChainStages * kWarpK * WR
                                        : kChainStages * kTcK * kTcRow);

  float dh[RT] = {};
  typename std::conditional<kSeq, SeqSums<RT>, NoSums>::type seq;
  prefetch(T - 1);
  if constexpr (kSeq) seq_load_ids<RB, S>(p, seq, l, T - 1, b0, warp);
  __syncthreads();
  for (int t = T - 1, step = 1; t >= 0; --t, ++step) {
    // ---- gate backward of the block's own units
    float dhz[RT], dar[RT], daz[RT], dan[RT], dhn[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      dhz[i] = dar[i] = daz[i] = dan[i] = dhn[i] = 0.f;
      if (col_ok && b0 + chain_row<RB>(warp, i) < B) {
        const float d = dh[i] + in_g[i];
        gate_bwd(d, in_r[i], in_z[i], in_n[i], in_hn[i], in_hp[i], dar[i],
                 daz[i], dan[i], dhn[i]);
        dhz[i] = d * in_z[i];
      }
    }
    // transpose through shared memory: sT[quad][gate*32 + c] holds the
    // dpre_h of 4 consecutive rows at unit c (pad rows and columns: 0)
    float4* sT = reinterpret_cast<float4*>(buf);
    if constexpr (RB == 16) {
      // two warps fill a quad: float2 halves of its float4s
      float2* dst = reinterpret_cast<float2*>(
                        sT + (size_t)(warp / 2) * kTStride + lane) + (warp & 1);
      dst[0] = make_float2(dar[0], dar[1]);
      dst[2 * kChainCols] = make_float2(daz[0], daz[1]);
      dst[4 * kChainCols] = make_float2(dhn[0], dhn[1]);
    } else {
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        float4* dst = sT + (size_t)(q * 8 + warp) * kTStride + lane;
        dst[0] = make_float4(dar[4 * q], dar[4 * q + 1], dar[4 * q + 2],
                             dar[4 * q + 3]);
        dst[kChainCols] = make_float4(daz[4 * q], daz[4 * q + 1],
                                      daz[4 * q + 2], daz[4 * q + 3]);
        dst[2 * kChainCols] = make_float4(dhn[4 * q], dhn[4 * q + 1],
                                          dhn[4 * q + 2], dhn[4 * q + 3]);
      }
    }
    __syncthreads();
    float* dT = p.dphT + ((size_t)(t & 1) * p.L + l) * G * Bp + b0;
    constexpr int kCopies = 3 * kChainCols * NQ;
#pragma unroll
    for (int n = 0; n < (kCopies + kThreads - 1) / kThreads; ++n) {
      const int idx = tid + n * kThreads;
      const int quad = idx % NQ, gc = idx / NQ;
      const int c = gc % kChainCols;
      if (idx < kCopies && c0 + c < H) {
        const int k = (gc / kChainCols) * H + c0 + c;
        *reinterpret_cast<float4*>(dT + (size_t)k * Bp + 4 * quad) =
            sT[(size_t)quad * kTStride + gc];
      }
    }
    // ---- barrier among the blocks of this row tile: arrive; while
    // waiting, store dpx[t] / dph[t] for the weight gradients (no block
    // reads them in this kernel) and load the next step's gate inputs; wait
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(ctr, 1u);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + chain_row<RB>(warp, i);
      if (col_ok && b < B) {
        const size_t lt = ((size_t)l * T + t) * B + b;
        float* px = p.dpx + lt * G;
        float* pq = p.dph + lt * G;
        if constexpr (!kSeq) {   // the sub-decoders' mode sums dpre_x
          px[j] = dar[i];
          px[H + j] = daz[i];
          px[2 * H + j] = dan[i];
        }
        pq[j] = dar[i];
        pq[H + j] = daz[i];
        pq[2 * H + j] = dhn[i];
      }
    }
    if constexpr (kSeq) {
      seq_add(seq, dar, daz, dan, dhn);
      if (t > 0) seq_load_ids<RB, S>(p, seq, l, t - 1, b0, warp);
    }
    if (t > 0) prefetch(t - 1);
    if (tid == 0) {
      while (*reinterpret_cast<volatile unsigned*>(ctr) < group * step) {
      }
      __threadfence();
    }
    __syncthreads();

    // ---- acc = dph[t] (rows of the tile) @ w_hh^T (the block's columns);
    // the sets' partial tiles into red [set][RB][32]
    float* red = buf;
    if constexpr (is_f32<S>) {
      const float* src = dT + half * WR;
      auto fill_slab = [&](int sl) {
        float* dst = ring + (sl % kChainStages) * (kWarpK * WR);
#pragma unroll
        for (int n = 0; n < kWarpK * WR / 4 / 32; ++n) {
          const int idx = lane + n * 32;
          const int kk = idx / (WR / 4), quad = idx % (WR / 4);
          const int k = sl * KK + set * kWarpK + kk;
          cp_async<16>(dst + kk * WR + 4 * quad,
                       k < G ? src + (size_t)k * Bp + 4 * quad : src,
                       k < G ? 16 : 0);
        }
      };
      const int nslab = Gp / KK;
      float acc[LR][4] = {};
#pragma unroll
      for (int sl = 0; sl < kChainStages - 1; ++sl) {
        if (sl < nslab) fill_slab(sl);
        cp_async_commit();
      }
      for (int sl = 0; sl < nslab; ++sl) {
        cp_async_wait<kChainStages - 2>();
        // the warp's own copies have landed and its lanes have left the
        // stage that is refilled next
        __syncwarp();
        if (sl + kChainStages - 1 < nslab) fill_slab(sl + kChainStages - 1);
        cp_async_commit();
        const float* as =
            ring + (sl % kChainStages) * (kWarpK * WR) + ry * LR;
        const float* ws =
            sW + ((size_t)sl * KK + set * kWarpK) * kChainCols + cx * 4;
#pragma unroll
        for (int kk = 0; kk < kWarpK; ++kk) {
          float a[LR];
#pragma unroll
          for (int q = 0; q < LR / 4; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(as + kk * WR + 4 * q);
            a[4 * q] = v.x;
            a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z;
            a[4 * q + 3] = v.w;
          }
          const float4 w =
              *reinterpret_cast<const float4*>(ws + kk * kChainCols);
#pragma unroll
          for (int i = 0; i < LR; ++i) {
            acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
            acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
            acc[i][2] = fmaf(a[i], w.z, acc[i][2]);
            acc[i][3] = fmaf(a[i], w.w, acc[i][3]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < LR; ++i)
        *reinterpret_cast<float4*>(
            red + ((size_t)set * RB + half * WR + ry * LR + i) * kChainCols +
            cx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      constexpr int KT = kSets * kTcK;       // k rows of a slab
      constexpr int RS = WR + 4;             // floats a k-row of the ring
      constexpr int MT = WR / 16;            // the warp's 16-row MMA tiles
      const float* src = dT + half * WR;
      auto fill_slab = [&](int sl) {
        float* dst = ring + (sl % kChainStages) * (kTcK * RS);
#pragma unroll
        for (int n = 0; n < kTcK * WR / 4 / 32; ++n) {
          const int idx = lane + n * 32;
          const int kk = idx / (WR / 4), quad = idx % (WR / 4);
          const int k = sl * KT + set * kTcK + kk;
          cp_async<16>(dst + kk * RS + 4 * quad,
                       k < G ? src + (size_t)k * Bp + 4 * quad : src,
                       k < G ? 16 : 0);
        }
      };
      const int nslab = Gp / KT;
      float acc[MT][4][4] = {};
#pragma unroll
      for (int sl = 0; sl < kChainStages - 1; ++sl) {
        if (sl < nslab) fill_slab(sl);
        cp_async_commit();
      }
      const int g = lane >> 2, q = lane & 3;
      // lane's ldmatrix.trans row of the weights: k (lane % 8) + ((lane /
      // 8) % 2) * 8, columns (lane / 16) * 8 (+ 16 for columns 16 .. 31)
      const int bk = (lane & 7) + ((lane >> 3) & 1) * 8, bc = (lane >> 4) * 8;
      for (int sl = 0; sl < nslab; ++sl) {
        cp_async_wait<kChainStages - 2>();
        __syncwarp();
        if (sl + kChainStages - 1 < nslab) fill_slab(sl + kChainStages - 1);
        cp_async_commit();
        const int k0 = sl * KT + set * kTcK;
        uint32_t bw[8];       // B fragments of the 4 column tiles
        {
          uint32_t r[4];
          ldsm_x4_trans(r, sWb + swz(k0 + bk, bc));
          bw[0] = r[0], bw[1] = r[1], bw[2] = r[2], bw[3] = r[3];
          ldsm_x4_trans(r, sWb + swz(k0 + bk, bc + 16));
          bw[4] = r[0], bw[5] = r[1], bw[6] = r[2], bw[7] = r[3];
        }
        // the A fragment of rows g (+8), k 2q (+1, +8, +9): ring[k][row]
        const float* as =
            ring + (sl % kChainStages) * (kTcK * RS) + 2 * q * RS + g;
        uint32_t ap[3][MT][4];    // pieces hi, mid, lo of each row tile
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* a = as + 16 * mt;
          split3(a[0], a[RS], ap[0][mt][0], ap[1][mt][0], ap[2][mt][0]);
          split3(a[8], a[RS + 8], ap[0][mt][1], ap[1][mt][1], ap[2][mt][1]);
          split3(a[8 * RS], a[9 * RS], ap[0][mt][2], ap[1][mt][2],
                 ap[2][mt][2]);
          split3(a[8 * RS + 8], a[9 * RS + 8], ap[0][mt][3], ap[1][mt][3],
                 ap[2][mt][3]);
        }
        // piece-major (lo, mid, hi): 4 * MT independent MMAs between two
        // into one accumulator
#pragma unroll
        for (int pc = 2; pc >= 0; --pc)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], ap[pc][mt], bw[2 * nt], bw[2 * nt + 1]);
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* rp = red + ((size_t)set * RB + half * WR + 16 * mt + g) *
                                kChainCols + 8 * nt + 2 * q;
          *reinterpret_cast<float2*>(rp) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(rp + 8 * kChainCols) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float* rp = red + (size_t)chain_row<RB>(warp, i) * kChainCols + lane;
      float s = rp[0];
#pragma unroll
      for (int q = 1; q < kSets; ++q)
        s = __fadd_rn(s, rp[(size_t)q * RB * kChainCols]);
      dh[i] = dhz[i] + s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int b = b0 + chain_row<RB>(warp, i);
    if (col_ok && b < B) p.dh0[l * BH + (size_t)b * H + j] = dh[i];
  }
  if constexpr (kSeq) seq_finish<RB, S>(p, seq, buf, l, b0, c0);
}

namespace {

template <int RB, bool kSeq, typename S>
cudaError_t try_chain(const ChainParamsOf<kSeq, S>& p, bool* fits,
                      cudaStream_t s) {
  const dim3 grid((p.H + kChainCols - 1) / kChainCols, (p.B + RB - 1) / RB,
                  p.L);
  return try_cooperative(gru_bwd_chain<RB, kSeq, S>, grid,
                         chain_smem_bytes<S>(p.H), p, fits, s);
}

// the smallest row tile whose whole grid is resident at once
template <bool kSeq, typename S>
cudaError_t launch_chain(const ChainParamsOf<kSeq, S>& p, cudaStream_t s) {
  bool fits = false;
  cudaError_t err;
  if ((err = try_chain<16, kSeq, S>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  if ((err = try_chain<32, kSeq, S>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  if ((err = try_chain<64, kSeq, S>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

// The sub-decoders' scratch: the step barriers' counters, then the unit
// blocks' arrival counters, the k-major dpre_h buffers, the dph stash (L,
// T, B, 3H), the row tiles' class and bias partials (sized for 16-row
// tiles), and the dW_hh GEMM's split-K partial tiles.
long long seq_done_floats(int L, int H) {
  return (long long)L * ((H + kChainCols - 1) / kChainCols) * kCtrStride;
}

long long seq_part_floats(int L, int B, int H) {
  return (long long)L * ((B + 15) / 16) * (kSeqClasses + 1) * 3 * H;
}

}  // namespace

long long chain_scratch_floats(int L, int B, int H) {
  return chain_counter_floats(L, B) + 2LL * L * 3 * H * chain_bp(B);
}

template <typename S>
cudaError_t launch_gru_bwd_chain(int L, int T, int B, int H, const float* g,
                                 long long g_ls, long long g_ts,
                                 int g_every_step, const S* stash,
                                 const S* h_seq, const S* h0,
                                 const S* w_hhT, float* dpx, float* dph,
                                 float* dh0, float* scratch, cudaStream_t s,
                                 const S* pre, const float* pre_h) {
  const long long nctr = chain_counter_floats(L, B);
  cudaError_t err = cudaMemsetAsync(scratch, 0, nctr * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const ChainParams<S> p{L,     T,     B,     H,   chain_bp(B),
                         g,     g_ls,  g_ts,  g_every_step,
                         stash, h_seq, h0,    w_hhT,
                         dpx,   dph,   dh0,   scratch + nctr,
                         reinterpret_cast<unsigned*>(scratch),
                         pre,   pre_h};
  return launch_chain<false, S>(p, s);
}

template cudaError_t launch_gru_bwd_chain<float>(
    int, int, int, int, const float*, long long, long long, int,
    const float*, const float*, const float*, const float*, float*, float*,
    float*, float*, cudaStream_t, const float*, const float*);
template cudaError_t launch_gru_bwd_chain<bf16>(
    int, int, int, int, const float*, long long, long long, int, const bf16*,
    const bf16*, const bf16*, const bf16*, float*, float*, float*, float*,
    cudaStream_t, const bf16*, const float*);

}  // namespace fader

// Floats of scratch fader_embed_gru_bwd and fader_stacked_gru_bwd need at
// these sizes on the current device: the chain's barrier counters and
// k-major dpre_h buffers, then the split-K partial tiles of the dW_hh GEMM
// (shared with the column sums' partials).
extern "C" long long fader_gru_bwd_scratch_floats(int L, int T, int B,
                                                  int H) {
  return fader::chain_scratch_floats(L, B, H) +
         fader::reduce_scratch_floats(L, H, 3 * H, T * B);
}

namespace fader {
namespace {

template <typename S>
cudaError_t embed_gru_bwd_impl(int L, int T, int B, int H, int V,
                               int seq_grad, const int* ids, const float* g,
                               const S* stash, const S* h_seq, const S* h0,
                               const S* w_hhT, float* dpx, float* dph,
                               float* dw_in, float* db_in, float* dprez,
                               float* dw_hh, float* db_hh, float* dh0,
                               float* scratch, cudaStream_t s) {
  const long long BH = (long long)B * H, G = 3LL * H;
  cudaError_t err = launch_gru_bwd_chain<S>(
      L, T, B, H, g, seq_grad ? T * BH : BH, BH, seq_grad, stash, h_seq, h0,
      w_hhT, dpx, dph, dh0, scratch, s);
  if (err != cudaSuccess) return err;
  float* red = scratch + chain_scratch_floats(L, B, H);
  const int R = T * B;
  if ((err = segment_rows(L, R, (int)G, V, ids, dpx, dw_in, s)) != cudaSuccess)
    return err;
  if (db_in && (err = colsum(L, R, (int)G, dpx, db_in, red, s)) != cudaSuccess)
    return err;
  if (dprez &&
      (err = sum_over_t(L, T, (int)(BH * 3), dpx, dprez, s)) != cudaSuccess)
    return err;
  SplitRowsT<S> hp{h0, BH, B, h_seq, T * BH, H};
  if ((err = gemm_tn(L, H, (int)G, R, hp, dph, R * G, dw_hh, H * G, red,
                     s)) != cudaSuccess)
    return err;
  return colsum(L, R, (int)G, dph, db_hh, red, s);
}

template <typename S>
cudaError_t embed_seq_bwd_impl(int L, int T, int B, int H, int V,
                               const int* ids, const float* g,
                               const S* stash, const S* h_seq, const S* h0,
                               const S* w_hh, float* dw_emb, float* dprez,
                               float* dw_hh, float* db_hh, float* dh0,
                               float* scratch, cudaStream_t s) {
  const long long BH = (long long)B * H, G = 3LL * H, R = (long long)T * B;
  const long long nctr = chain_counter_floats(L, B);
  const long long ndone = seq_done_floats(L, H);
  float* dphT = scratch + nctr + ndone;
  float* dph = dphT + (chain_scratch_floats(L, B, H) - nctr);
  float* part = dph + L * R * G;
  float* red = part + seq_part_floats(L, B, H);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (nctr + ndone) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  SeqChainParams<S> p;
  static_cast<ChainParams<S>&>(p) = ChainParams<S>{
      L,       T,       B,   H,  chain_bp(B), g,   T * BH, BH,  1,
      stash,   h_seq,   h0,  nullptr, nullptr, dph, dh0,   dphT,
      reinterpret_cast<unsigned*>(scratch)};
  p.ids = ids;
  p.V = V;
  p.w_hh = w_hh;
  p.dprez = dprez;
  p.dw_emb = dw_emb;
  p.db_hh = db_hh;
  p.part = part;
  p.done = reinterpret_cast<unsigned*>(scratch + nctr);
  if ((err = launch_chain<true, S>(p, s)) != cudaSuccess) return err;
  SplitRowsT<S> hp{h0, BH, B, h_seq, T * BH, H};
  return gemm_tn(L, H, (int)G, (int)R, hp, dph, R * G, dw_hh, H * G, red, s);
}

}  // namespace
}  // namespace fader

// ids (L,T,B) int32; g: (L,B,H) final-state cotangent (seq_grad = 0) or
// (L,T,B,H) per-step cotangent (seq_grad = 1); stash (L,T,B,4H), h_seq
// (L,T,B,H), h0 (L,B,H) from the forward; w_hhT (L,3H,H) = w_hh
// transposed. Scratch: dpx / dph (L,T,B,3H); scratch, scratch_floats >=
// fader_gru_bwd_scratch_floats(L,T,B,H) floats. Outputs: dw_in (L,V,3H);
// db_in (L,3H) or null; dprez (L,B,3H) or null; dw_hh (L,H,3H); db_hh
// (L,3H); dh0 (L,B,H). T >= 1. One cooperative launch for the chain, then
// the reductions.
extern "C" int fader_embed_gru_bwd(int L, int T, int B, int H, int V,
                                   int seq_grad, const int* ids,
                                   const float* g, const float* stash,
                                   const float* h_seq, const float* h0,
                                   const float* w_hhT, float* dpx, float* dph,
                                   float* dw_in, float* db_in, float* dprez,
                                   float* dw_hh, float* db_hh, float* dh0,
                                   float* scratch, long long scratch_floats,
                                   void* stream) {
  if (scratch_floats < fader_gru_bwd_scratch_floats(L, T, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::embed_gru_bwd_impl<float>(
      L, T, B, H, V, seq_grad, ids, g, stash, h_seq, h0, w_hhT, dpx, dph,
      dw_in, db_in, dprez, dw_hh, db_hh, dh0, scratch,
      static_cast<cudaStream_t>(stream));
}

// As fader_embed_gru_bwd with bf16 stash, h_seq, h0 and w_hhT; g, the
// scratch and every output stay float32 (the caller rounds the gradients
// to bf16, as the Pallas backward's wrapper does, pallas_gru.py:654-658).
extern "C" int fader_embed_gru_bwd_bf16(
    int L, int T, int B, int H, int V, int seq_grad, const int* ids,
    const float* g, const fader::bf16* stash, const fader::bf16* h_seq,
    const fader::bf16* h0, const fader::bf16* w_hhT, float* dpx, float* dph,
    float* dw_in, float* db_in, float* dprez, float* dw_hh, float* db_hh,
    float* dh0, float* scratch, long long scratch_floats, void* stream) {
  if (scratch_floats < fader_gru_bwd_scratch_floats(L, T, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::embed_gru_bwd_impl<fader::bf16>(
      L, T, B, H, V, seq_grad, ids, g, stash, h_seq, h0, w_hhT, dpx, dph,
      dw_in, db_in, dprez, dw_hh, db_hh, dh0, scratch,
      static_cast<cudaStream_t>(stream));
}

// Floats of scratch fader_embed_seq_bwd needs at these sizes on the current
// device.
extern "C" long long fader_embed_seq_bwd_scratch_floats(int L, int T, int B,
                                                        int H) {
  using namespace fader;
  const long long G = 3LL * H;
  return chain_scratch_floats(L, B, H) + seq_done_floats(L, H) +
         (long long)L * T * B * G + seq_part_floats(L, B, H) +
         reduce_scratch_floats(L, H, (int)G, T * B);
}

// The sub-decoders' backward (kernel 6) from the per-step cotangent g (L, T,
// B, H), with at most kSeqClasses class rows (V): ids (L, T, B) int32;
// stash (L, T, B, 4H), h_seq (L, T, B, H), h0 (L, B, H) from the forward;
// w_hh (L, H, 3H) as the model holds it. Outputs: dw_emb (L, V, 3H), dprez
// (L, B, 3H), dw_hh (L, H, 3H), db_hh (L, 3H), dh0 (L, B, H). T >= 1.
// One memset of the counters, one cooperative launch of the chain in its
// sub-decoders' mode, which also sums dprez, db_hh and dW_emb, then the
// dW_hh GEMM over the dph stash (two kernels): whatever T is.
extern "C" int fader_embed_seq_bwd(int L, int T, int B, int H, int V,
                                   const int* ids, const float* g,
                                   const float* stash, const float* h_seq,
                                   const float* h0, const float* w_hh,
                                   float* dw_emb, float* dprez, float* dw_hh,
                                   float* db_hh, float* dh0, float* scratch,
                                   long long scratch_floats, void* stream) {
  if (V < 0 || V > fader::kSeqClasses ||
      scratch_floats < fader_embed_seq_bwd_scratch_floats(L, T, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::embed_seq_bwd_impl<float>(
      L, T, B, H, V, ids, g, stash, h_seq, h0, w_hh, dw_emb, dprez, dw_hh,
      db_hh, dh0, scratch, static_cast<cudaStream_t>(stream));
}

// As fader_embed_seq_bwd with bf16 stash, h_seq, h0 and w_hh; g, the
// scratch and every output stay float32.
extern "C" int fader_embed_seq_bwd_bf16(
    int L, int T, int B, int H, int V, const int* ids, const float* g,
    const fader::bf16* stash, const fader::bf16* h_seq, const fader::bf16* h0,
    const fader::bf16* w_hh, float* dw_emb, float* dprez, float* dw_hh,
    float* db_hh, float* dh0, float* scratch, long long scratch_floats,
    void* stream) {
  if (V < 0 || V > fader::kSeqClasses ||
      scratch_floats < fader_embed_seq_bwd_scratch_floats(L, T, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::embed_seq_bwd_impl<fader::bf16>(
      L, T, B, H, V, ids, g, stash, h_seq, h0, w_hh, dw_emb, dprez, dw_hh,
      db_hh, dh0, scratch, static_cast<cudaStream_t>(stream));
}
