// The GRU forward recurrence as one persistent kernel: L independent
// chains over T steps in one cooperative launch.
//
// Replaces the per-step recurrences of music_fader_nets_tpu/ops/
// pallas_gru.py::_fwd_kernel :147 (kernel 1, the generic stacked GRU over
// precomputed projections; stacked_gru.cu), of ::_fwd_embed_kernel :428
// and ::_fwd_embed_seq_kernel :779 (kernels 3 and 5, the encoder and the
// sub-decoders over embedded ids; embed_gru.cu) and of ::_dec_fwd_kernel
// :1110 and ::_dec_fwd_ce_kernel :1482 (kernels 7 and 9, the
// teacher-forced decoder's two GRUCell layers, one chain each;
// decoder_ce.cu).
//
// What it computes, for each chain l < L and step t < T, from h = h0[l]:
//   xpre = x[l, t, b, :] (+ add)                          (rows in memory)
//        | w_in[l, ids[l, t, b], :] + add[l, b, :]         (gathered; an id
//          outside [0, V) selects no row, as its one-hot is all zeros)
//   h'   = gates(xpre, h @ w_hh[l] + b_hh[l], h)   (r, z, n as ops/gru.py)
// writing h_seq[l, t] (L, T, B, H) unless h_seq is null, h[T-1] to finals
// (L, B, H) unless finals is null (the serving encoder wants only these),
// and, unless stash is null, the gate stash [r, z, n, hn_h] (L, T, B, 4H)
// the backward chains read.
//
// What bounds it on an H100: float32 FMA. The recurrence is 2 L T B H 3H:
// 40.3 GFLOP for the CVAE encoder (L=2, T=100, B=128, H=512), 0.60 ms at
// 67 TFLOP/s; a decoder layer 20.1 GFLOP at B=128, 80.5 at 512 rows; the
// encoder (L=4, T=100) 80.5 GFLOP at B=128, 40.3 at the serving B=64. In
// bf16 the same products run on the tensor cores (989 TFLOP/s dense), and
// the chain is bound by its T dependent steps, not by either peak.
//
// Design (the forward twin of embed_gru_bwd.cu::gru_bwd_chain): ONE
// cooperative launch for all T steps. A block owns (chain, 32 hidden units,
// a row tile) for the whole call and keeps the r, z and n columns of its
// units of w_hh (H x 96 floats, 196 KB at H = 512) in shared memory, so the
// weights leave L2 once a call, and its units' h in registers for the
// z-blend. A step: the product h[t-1] (the tile's rows, all H) by the
// block's 96 columns, whose A operand the other blocks of the row tile
// wrote, in passes of at most 32 rows; each warp streams the k rows it
// multiplies (every 8th) through a cp.async ring of its own from a k-major
// copy of h[t-1] in device memory (double-buffered over t; the weights
// leave no room to stage a whole tile beside them), an LR x 12 register
// tile a lane (LR rows, 4 units of each gate), the next step's xpre loaded
// while it multiplies; the warps' partial tiles added gate by gate in warp
// order through shared memory (no float atomics: a repeated call gives the
// same bits; each sum in the order of the per-step kernels it replaces,
// gru_tile.cuh's split-K); the gates of the block's own units; h' written
// k-major through a
// shared-memory transpose; an arrive on the counter barrier of the row
// tile's H/32 blocks; the stores of h_seq[t] and the stash while the others
// arrive; the wait. The row tile is the smallest of 16, 32 and 64 rows whose
// grid is co-resident (128 blocks at H = 512: 16 rows at L=1, B=128 and at
// L=4, B=32; 32 at L=2, B=128 and at L=4, B=64; 64 at L=1 with 512 rows
// and at L=4, B=128). If none is, or the weights do not fit, the
// launch fails and the error is returned: there is no other path.
//
// bf16 storage (the mixed-precision training of the JAX package, where the
// Pallas kernels get bf16 operands): the chain is instantiated on XT, the
// type of x and h0, and S, that of add, w_hh, b_hh and of what it writes.
// Loads widen to float; the carry h, the k-major rows hT the blocks
// exchange, the products and the gates stay float32, as the kernels' f32
// scratch does (pallas_gru.py:162); h_seq, finals and the stash are rounded
// to S where they are stored (:163, :455). With S = bf16 the chain can also
// write the float h of every step (h32), for a caller that reads it on in
// float32 as the Pallas decoder does inside its kernel (layer 2's input and
// the CE head, :1518-1535). XT = float, S = bf16 is the decoder's layer 2,
// whose x is its float32 input product and whose h0 is layer 1's float32
// first state.
//
// The bf16 product (S = bf16) runs on the tensor cores. The Pallas kernels'
// dot pairs the float32 carry with the bf16 w_hh, preferred f32 (:157-160,
// :443-446), so the chain splits each float32 h[t-1] value into three bf16
// pieces (mma_bf16.cuh::split3) and takes three mma.sync.m16n8k16 into one
// float32 accumulator, lo, mid, hi: the float32 product to float32
// rounding; h is never rounded once to bf16, nor fed to TF32. The block's
// r, z and n columns of w_hh stay bf16 in shared memory, a 32-column slab
// a gate (3 x Kp x 32, 96 KB at H = 512, k zero-padded to a multiple of
// 128), its 16-byte chunks XOR-swizzled by row and read by ldmatrix.trans.
// Warp (set, mw) takes the tile's rows 16 mw .. +16 (one M tile; RB / 16 of
// them side by side) and, of each slab of KT = kSets * 16 k rows, the
// 16-deep k-step set * 16 .. +16 (kSets = 8 / (RB / 16) sets: 8 at RB = 16,
// 2 at RB = 64), all 96 columns (12 N tiles, 48 accumulators a lane). It
// copies its own A rows, k-major from hT, through a cp.async ring of its
// own (16 k rows of 16 + 4 floats a stage: its fragment reads fall on
// distinct banks), splits them and runs 36 MMAs a k-step, 12 independent
// between two that share an accumulator. The sets' partial tiles are added
// in set order through shared memory (rows of 96 + 8 floats); no float
// atomics, so a repeated call gives the same bits. The block's shared
// memory is 148 KB at H = 512 (the float slab's chain: 224 KB), one block
// an SM as before, so the row tile is chosen as in float32. Of what the
// bf16 slab frees, a whole 64-row tile of h[t-1] would need 128 KB; rings
// of 8 k-steps and h[t] published as its three pieces (the consumers'
// split moved to the producer, 1.5x the bytes from L2) were tried
// (train/fwd_ablate.py --bf16-chain) and left out: neither was faster at
// both 16- and 64-row tiles. The float32 instance keeps the float slab and
// FMA product above, sum for sum.
#include "gru_tile.cuh"
#include "mma_bf16.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kFwdCols = 32;               // hidden units a block owns
constexpr int kFwdN = 3 * kFwdCols;        // their r, z, n weight columns
constexpr int kFwdStages = 4;              // slabs in a warp's ring
constexpr int kFwdWarpK = 8;               // k rows of a slab one warp takes
constexpr int kFwdWarpRows = 32;           // most tile rows a pass multiplies
constexpr int kFwdKPad = 64;               // the weights' k is padded to this
// ring | transpose buffer | partial tiles share these floats of a block
constexpr int kFwdBuf = kWarps * kFwdStages * kFwdWarpK * kFwdWarpRows;
// the bf16 chain's product (tensor cores): an MMA's depth (the k rows of a
// warp's k-step), the bf16 weights' k padding, the stages of a warp's ring
// and the floats of one of its k rows (an M tile's 16 rows + 4), the floats
// of a partial tile's row (96 + 8), and the buffer the rings, the partial
// tiles (kSets x RB = 128 rows at any row tile) and the transpose share
constexpr int kFwdTcK = 16;
constexpr int kFwdTcKPad = 128;
constexpr int kFwdTcStages = 4;
constexpr int kFwdTcRow = 20;
constexpr int kFwdTcRed = 104;
constexpr int kFwdBufTc = 128 * kFwdTcRed;

template <typename XT, typename S>
struct FwdChainParams {
  int L, T, B, H, Bp, V;
  const int* ids;        // (L, T, B) rows of x, or null: x holds the rows
  const XT* x;           // (L, V, 3H) with ids, else (L, T, B, 3H)
  const S* add;          // null, or add + l*add_ls + b*add_bs (3H values)
  long long add_ls;
  int add_bs;
  const S* w_hh;         // (L, H, 3H)
  const S* b_hh;         // (L, 3H)
  const XT* h0;          // (L, B, H)
  S* h_seq;              // (L, T, B, H) or null
  S* finals;             // (L, B, H) h[T-1], or null
  S* stash;              // (L, T, B, 4H) or null
  float* hT;             // (2, L, H, Bp): h of step parity t & 1, k-major
  unsigned* counters;    // one per (chain, row tile), kCtrStride apart
  float* h32;            // (L, T, B, H) float h, or null; read if S is bf16
};

// k rows of the block's weight slab (H zero-padded)
template <typename S>
__host__ __device__ inline int fwd_kp(int H) {
  constexpr int pad = is_f32<S> ? kFwdKPad : kFwdTcKPad;
  return (H + pad - 1) / pad * pad;
}

template <typename S>
inline size_t fwd_smem_bytes(int H) {
  if constexpr (is_f32<S>)
    return ((size_t)fwd_kp<S>(H) * kFwdN + kFwdBuf) * sizeof(float);
  else
    return (size_t)fwd_kp<S>(H) * kFwdN * sizeof(bf16) +
           kFwdBufTc * sizeof(float);
}

template <int RB, typename XT, typename S>
__global__ void __launch_bounds__(kThreads, 1)
    gru_fwd_chain(FwdChainParams<XT, S> p) {
  static_assert(RB == 16 || RB == 32 || RB == 64, "row tiles of 16-64");
  constexpr int RT = RB / 8;      // rows a thread owns (gates, epilogue)
  constexpr int NQ = RB / 4;      // row quads of the tile
  constexpr int WR = RB < kFwdWarpRows ? RB : kFwdWarpRows;  // rows a pass
  constexpr int LR = WR / 4;      // a lane's register tile: LR rows x 12
  constexpr int kPasses = RB / WR;            // passes over the tile's rows
  constexpr int KK = kWarps * kFwdWarpK;      // k rows of a slab
  constexpr int kTStride = kFwdCols + 1;      // float4s a quad of sT
  static_assert(NQ * kTStride * 4 <= kFwdBuf, "transpose buffer fits");
  static_assert(kWarps * WR * kFwdCols <= kFwdBuf, "partial tiles fit");
  static_assert(NQ * kTStride * 4 <= kFwdBufTc, "transpose buffer fits");
  extern __shared__ float4 smem4[];
  const int T = p.T, B = p.B, H = p.H, G = 3 * H, Bp = p.Bp;
  const int Kp = fwd_kp<S>(H);
  float* sW = reinterpret_cast<float*>(smem4);       // [Kp][96] (float)
  bf16* sWb = reinterpret_cast<bf16*>(smem4);        // [3][Kp][32] (bf16)
  float* buf;                                        // ring | sT | red
  if constexpr (is_f32<S>)
    buf = sW + (size_t)Kp * kFwdN;
  else
    buf = reinterpret_cast<float*>(sWb + (size_t)Kp * kFwdN);
  const int l = blockIdx.z, b0 = blockIdx.y * RB, c0 = blockIdx.x * kFwdCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = c0 + lane;
  const bool col_ok = j < H;
  const size_t BH = (size_t)B * H;

  // sW[k][g*32 + c] = w_hh[l][k][g*H + c0 + c]; bf16: gate g's slab
  // sWb[g][swz(k, c)], the weights as stored
  const S* wl = p.w_hh + (size_t)l * H * G;
  for (int idx = tid; idx < Kp * kFwdN; idx += kThreads) {
    const int k = idx / kFwdN, n = idx % kFwdN;
    const int g = n / kFwdCols, c = n % kFwdCols;
    if constexpr (is_f32<S>) {
      sW[idx] = (k < H && c0 + c < H)
                    ? to_f32(wl[(size_t)k * G + g * H + c0 + c])
                    : 0.f;
    } else {
      sWb[(size_t)g * Kp * kFwdCols + swz(k, c)] =
          (k < H && c0 + c < H) ? wl[(size_t)k * G + g * H + c0 + c]
                                : __float2bfloat16_rn(0.f);
    }
  }
  const S* bl = p.b_hh + (size_t)l * G;
  const float bhr = col_ok ? to_f32(bl[j]) : 0.f;
  const float bhz = col_ok ? to_f32(bl[H + j]) : 0.f;
  const float bhn = col_ok ? to_f32(bl[2 * H + j]) : 0.f;

  // xpre of a step for the thread's rows at unit j
  auto load_x = [&](int t, float (&xr)[RT], float (&xz)[RT],
                    float (&xn)[RT]) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + chain_row<RB>(warp, i);
      xr[i] = xz[i] = xn[i] = 0.f;
      if (!(col_ok && b < B)) continue;
      const size_t lt = ((size_t)l * T + t) * B + b;
      const XT* row = nullptr;
      if (p.ids == nullptr) {
        row = p.x + lt * G;
      } else {
        const int id = p.ids[lt];
        if (id >= 0 && id < p.V) row = p.x + ((size_t)l * p.V + id) * G;
      }
      if (p.add != nullptr) {
        const S* ad = p.add + l * p.add_ls + (size_t)b * p.add_bs;
        xr[i] = to_f32(ad[j]);
        xz[i] = to_f32(ad[H + j]);
        xn[i] = to_f32(ad[2 * H + j]);
        if (row != nullptr) {
          xr[i] = __fadd_rn(to_f32(row[j]), xr[i]);
          xz[i] = __fadd_rn(to_f32(row[H + j]), xz[i]);
          xn[i] = __fadd_rn(to_f32(row[2 * H + j]), xn[i]);
        }
      } else if (row != nullptr) {
        xr[i] = to_f32(row[j]);
        xz[i] = to_f32(row[H + j]);
        xn[i] = to_f32(row[2 * H + j]);
      }
    }
  };

  // write the thread's rows of v (pad rows and units: 0) k-major into
  // hT[parity], through a transpose in shared memory: sT[quad][c] holds
  // rows 4*quad .. +3 of unit c0 + c
  auto publish = [&](const float (&v)[RT], int parity) {
    float4* sT = reinterpret_cast<float4*>(buf);
    if constexpr (RB == 16) {
      // two warps fill a quad: float2 halves of its float4s
      *(reinterpret_cast<float2*>(sT + (size_t)(warp / 2) * kTStride +
                                  lane) + (warp & 1)) =
          make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int q = 0; q < RT / 4; ++q)
        sT[(size_t)(q * 8 + warp) * kTStride + lane] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
    float* dT = p.hT + ((size_t)parity * p.L + l) * H * Bp + b0;
    constexpr int kCopies = kFwdCols * NQ;
#pragma unroll
    for (int n = 0; n < (kCopies + kThreads - 1) / kThreads; ++n) {
      const int idx = tid + n * kThreads;
      const int quad = idx % NQ, c = idx / NQ;
      if (idx < kCopies && c0 + c < H)
        *reinterpret_cast<float4*>(dT + (size_t)(c0 + c) * Bp + 4 * quad) =
            sT[(size_t)quad * kTStride + c];
    }
  };

  // the barrier among the blocks of this row tile: arrive, then wait until
  // all of them have arrived `phase` times
  unsigned* ctr = p.counters + (l * gridDim.y + blockIdx.y) * kCtrStride;
  const unsigned group = gridDim.x;
  auto arrive = [&]() {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(ctr, 1u);
    }
  };
  auto wait = [&](unsigned phase) {
    if (tid == 0) {
      while (*reinterpret_cast<volatile unsigned*>(ctr) < group * phase) {
      }
      __threadfence();
    }
    __syncthreads();
  };

  float h[RT], xr[RT], xz[RT], xn[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int b = b0 + chain_row<RB>(warp, i);
    h[i] = (col_ok && b < B) ? to_f32(p.h0[l * BH + (size_t)b * H + j])
                             : 0.f;
  }
  load_x(0, xr, xz, xn);
  publish(h, 1);            // h[-1] = h0 in parity (-1) & 1
  arrive();
  wait(1);

  // product phase, in kPasses passes of WR rows: warp w multiplies the k
  // rows w, w + 8, w + 16, ... (k = sl*64 + w + 8*kk in slab sl) with the
  // pass's rows, which it alone loads into a ring of its own; lane (ry, cx)
  // holds rows ry*LR .. +LR of those and units cx*4 .. +4 of each gate. A
  // sum is thus the per-step kernels' (embed_gru.cu, gru_tile.cuh): each
  // warp's k in order, the 8 warps' partial sums added in warp order.
  const int ry = lane >> 3, cx = lane & 7;
  float* ring = buf + warp * (kFwdStages * kFwdWarpK * WR);
  const int nslab = Kp / KK;

  // the bf16 product of step t, into ph (see the header): warp (set, mw)
  // multiplies k = sl*KT + set*16 .. +16 of each slab sl with the tile's
  // rows 16 mw .. +16, which it alone copies into a ring of its own, by
  // all 96 columns; the sets' partial tiles added in set order
  auto tc_product = [&](int t, float (&ph)[3][RT]) {
    constexpr int MW = RB / 16;              // M tiles, warps side by side
    constexpr int kSets = kWarps / MW;       // warps that split a slab's k
    constexpr int KT = kSets * kFwdTcK;      // k rows of a slab
    constexpr int RS = kFwdTcRow;
    static_assert(kFwdTcKPad % KT == 0, "slabs tile the weights' k");
    static_assert(kSets * RB * kFwdTcRed <= kFwdBufTc, "partial tiles fit");
    static_assert(kWarps * kFwdTcStages * kFwdTcK * RS <= kFwdBufTc,
                  "rings fit");
    const int mw = warp % MW, set = warp / MW;
    const float* src = p.hT + ((size_t)((t + 1) & 1) * p.L + l) * H * Bp +
                       b0 + 16 * mw;
    float* tring = buf + warp * (kFwdTcStages * kFwdTcK * RS);
    auto fill = [&](int sl) {
      float* dst = tring + (sl % kFwdTcStages) * (kFwdTcK * RS);
#pragma unroll
      for (int n = 0; n < kFwdTcK * 4 / 32; ++n) {
        const int idx = lane + n * 32;
        const int kk = idx >> 2, quad = idx & 3;
        const int k = sl * KT + set * kFwdTcK + kk;
        cp_async<16>(dst + kk * RS + 4 * quad,
                     k < H ? src + (size_t)k * Bp + 4 * quad : src,
                     k < H ? 16 : 0);
      }
    };
    const int tslabs = (H + KT - 1) / KT;
    float acc[12][4] = {};
#pragma unroll
    for (int sl = 0; sl < kFwdTcStages - 1; ++sl) {
      if (sl < tslabs) fill(sl);
      cp_async_commit();
    }
    const int g = lane >> 2, q = lane & 3;
    // lane's ldmatrix.trans row of a gate's slab: k (lane % 8) + ((lane /
    // 8) % 2) * 8, columns (lane / 16) * 8 (+ 16 for columns 16 .. 31)
    const int bk = (lane & 7) + ((lane >> 3) & 1) * 8, bc = (lane >> 4) * 8;
    for (int sl = 0; sl < tslabs; ++sl) {
      cp_async_wait<kFwdTcStages - 2>();
      // the warp's own copies have landed and its lanes have left the
      // stage that is refilled next
      __syncwarp();
      if (sl + kFwdTcStages - 1 < tslabs) fill(sl + kFwdTcStages - 1);
      cp_async_commit();
      const int k0 = sl * KT + set * kFwdTcK;
      uint32_t bw[24];        // B fragments of the 12 column tiles
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const bf16* wg = sWb + (size_t)gt * Kp * kFwdCols;
        uint32_t r[4];
        ldsm_x4_trans(r, wg + swz(k0 + bk, bc));
        bw[8 * gt] = r[0], bw[8 * gt + 1] = r[1];
        bw[8 * gt + 2] = r[2], bw[8 * gt + 3] = r[3];
        ldsm_x4_trans(r, wg + swz(k0 + bk, bc + 16));
        bw[8 * gt + 4] = r[0], bw[8 * gt + 5] = r[1];
        bw[8 * gt + 6] = r[2], bw[8 * gt + 7] = r[3];
      }
      // the A fragment of rows g (+8), k 2q (+1, +8, +9): ring[k][row]
      const float* a =
          tring + (sl % kFwdTcStages) * (kFwdTcK * RS) + 2 * q * RS + g;
      uint32_t ap[3][4];      // pieces hi, mid, lo
      split3(a[0], a[RS], ap[0][0], ap[1][0], ap[2][0]);
      split3(a[8], a[RS + 8], ap[0][1], ap[1][1], ap[2][1]);
      split3(a[8 * RS], a[9 * RS], ap[0][2], ap[1][2], ap[2][2]);
      split3(a[8 * RS + 8], a[9 * RS + 8], ap[0][3], ap[1][3], ap[2][3]);
      // piece-major (lo, mid, hi): 12 independent MMAs between two into
      // one accumulator
#pragma unroll
      for (int pc = 2; pc >= 0; --pc)
#pragma unroll
        for (int nt = 0; nt < 12; ++nt)
          mma_bf16(acc[nt], ap[pc], bw[2 * nt], bw[2 * nt + 1]);
    }
    cp_async_wait<0>();
    __syncthreads();
    // the sets' partial tiles, red[set][row][gate*32 + unit], then each
    // thread's rows and unit, the sets in order
    float* red = buf;
#pragma unroll
    for (int nt = 0; nt < 12; ++nt) {
      float* rp = red + ((size_t)set * RB + 16 * mw + g) * kFwdTcRed +
                  8 * nt + 2 * q;
      *reinterpret_cast<float2*>(rp) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(rp + 8 * kFwdTcRed) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float* rp =
          red + (size_t)chain_row<RB>(warp, i) * kFwdTcRed + lane;
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        float s = rp[gt * kFwdCols];
#pragma unroll
        for (int st = 1; st < kSets; ++st)
          s = __fadd_rn(s, rp[(size_t)st * RB * kFwdTcRed + gt * kFwdCols]);
        ph[gt][i] = s;
      }
    }
    __syncthreads();
  };

  for (int t = 0; t < T; ++t) {
    const bool last = t == T - 1;
    // ---- the next step's xpre, in flight while this step multiplies
    float nr[RT], nz[RT], nn[RT];
    if (!last) load_x(t + 1, nr, nz, nn);

    float ph[3][RT];
    if constexpr (!is_f32<S>) {
      tc_product(t, ph);
    } else {
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        // ---- acc = h[t-1] (the pass's rows) @ w_hh (the block's columns)
        const float* src = p.hT +
                           ((size_t)((t + 1) & 1) * p.L + l) * H * Bp + b0 +
                           pass * WR;
        auto fill_slab = [&](int sl) {
          float* dst = ring + (sl % kFwdStages) * (kFwdWarpK * WR);
#pragma unroll
          for (int n = 0; n < kFwdWarpK * WR / 4 / 32; ++n) {
            const int idx = lane + n * 32;
            const int kk = idx / (WR / 4), quad = idx % (WR / 4);
            const int k = sl * KK + warp + kWarps * kk;
            cp_async<16>(dst + kk * WR + 4 * quad,
                         k < H ? src + (size_t)k * Bp + 4 * quad : src,
                         k < H ? 16 : 0);
          }
        };
        float acc[LR][12] = {};
#pragma unroll
        for (int sl = 0; sl < kFwdStages - 1; ++sl) {
          if (sl < nslab) fill_slab(sl);
          cp_async_commit();
        }
        for (int sl = 0; sl < nslab; ++sl) {
          cp_async_wait<kFwdStages - 2>();
          // the warp's own copies have landed and its lanes have left the
          // stage that is refilled next
          __syncwarp();
          if (sl + kFwdStages - 1 < nslab) fill_slab(sl + kFwdStages - 1);
          cp_async_commit();
          const float* as =
              ring + (sl % kFwdStages) * (kFwdWarpK * WR) + ry * LR;
          const float* ws = sW + ((size_t)sl * KK + warp) * kFwdN + cx * 4;
#pragma unroll
          for (int kk = 0; kk < kFwdWarpK; ++kk) {
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
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const float4 w = *reinterpret_cast<const float4*>(
                  ws + (size_t)kk * kWarps * kFwdN + g * kFwdCols);
#pragma unroll
              for (int i = 0; i < LR; ++i) {
                acc[i][4 * g] = fmaf(a[i], w.x, acc[i][4 * g]);
                acc[i][4 * g + 1] = fmaf(a[i], w.y, acc[i][4 * g + 1]);
                acc[i][4 * g + 2] = fmaf(a[i], w.z, acc[i][4 * g + 2]);
                acc[i][4 * g + 3] = fmaf(a[i], w.w, acc[i][4 * g + 3]);
              }
            }
          }
        }
        cp_async_wait<0>();
        __syncthreads();
        // ---- add the warps' partial tiles in warp order, a gate at a time,
        // into ph for the thread's rows in this pass (row quad i / 4 lies in
        // pass (i / 4) * 32 / WR)
        float* red = buf;                              // [warp][WR][32]
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int i = 0; i < LR; ++i)
            *reinterpret_cast<float4*>(
                red + ((size_t)warp * WR + ry * LR + i) * kFwdCols + cx * 4) =
                make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                            acc[i][4 * g + 2], acc[i][4 * g + 3]);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            if ((i / 4) * 32 / WR != pass) continue;
            const float* rp =
                red + (size_t)(chain_row<RB>(warp, i) - pass * WR) * kFwdCols +
                lane;
            float s = rp[0];
#pragma unroll
            for (int q = 1; q < kWarps; ++q)
              s = __fadd_rn(s, rp[(size_t)q * WR * kFwdCols]);
            ph[g][i] = s;
          }
          __syncthreads();
        }
      }
    }
    // ---- the gates of the block's own units
    float rg[RT], zg[RT], ng[RT], hn[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      rg[i] = zg[i] = ng[i] = hn[i] = 0.f;
      if (col_ok && b0 + chain_row<RB>(warp, i) < B) {
        hn[i] = __fadd_rn(ph[2][i], bhn);
        h[i] = gru_gates(xr[i], xz[i], xn[i], __fadd_rn(ph[0][i], bhr),
                         __fadd_rn(ph[1][i], bhz), hn[i], h[i], rg[i],
                         zg[i], ng[i]);
      }
    }
    // ---- h[t] to the other blocks: publish, arrive; store h_seq[t] and
    // the stash while they arrive; wait
    if (!last) {
      publish(h, t & 1);
      arrive();
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + chain_row<RB>(warp, i);
      if (!(col_ok && b < B)) continue;
      const size_t lt = ((size_t)l * T + t) * B + b;
      if (p.h_seq != nullptr) p.h_seq[lt * H + j] = from_f32<S>(h[i]);
      if constexpr (!is_f32<S>) {
        if (p.h32 != nullptr) p.h32[lt * H + j] = h[i];
      }
      if (last && p.finals != nullptr)
        p.finals[l * BH + (size_t)b * H + j] = from_f32<S>(h[i]);
      if (p.stash != nullptr) {
        S* st = p.stash + lt * 4 * H;
        st[j] = from_f32<S>(rg[i]);
        st[H + j] = from_f32<S>(zg[i]);
        st[2 * H + j] = from_f32<S>(ng[i]);
        st[3 * H + j] = from_f32<S>(hn[i]);
      }
    }
    if (!last) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        xr[i] = nr[i];
        xz[i] = nz[i];
        xn[i] = nn[i];
      }
      wait(t + 2);
    }
  }
}

namespace {

template <int RB, typename XT, typename S>
cudaError_t try_fwd_chain(const FwdChainParams<XT, S>& p, bool* fits,
                          cudaStream_t s) {
  const dim3 grid((p.H + kFwdCols - 1) / kFwdCols, (p.B + RB - 1) / RB,
                  p.L);
  return try_cooperative(gru_fwd_chain<RB, XT, S>, grid,
                         fwd_smem_bytes<S>(p.H), p, fits, s);
}

}  // namespace

long long fwd_chain_scratch_floats(int L, int B, int H) {
  return chain_counter_floats(L, B) + 2LL * L * H * chain_bp(B);
}

template <typename XT, typename S>
cudaError_t launch_gru_fwd_chain(int L, int T, int B, int H, const int* ids,
                                 const XT* x, int V, const S* add,
                                 long long add_ls, int add_bs,
                                 const S* w_hh, const S* b_hh, const XT* h0,
                                 S* h_seq, S* finals, S* stash,
                                 float* scratch, cudaStream_t s,
                                 float* h32) {
  const long long nctr = chain_counter_floats(L, B);
  cudaError_t err = cudaMemsetAsync(scratch, 0, nctr * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const FwdChainParams<XT, S> p{L,      T,      B,     H,     chain_bp(B),
                                V,      ids,    x,     add,   add_ls,
                                add_bs, w_hh,   b_hh,  h0,    h_seq,
                                finals, stash,  scratch + nctr,
                                reinterpret_cast<unsigned*>(scratch), h32};
  // the smallest row tile whose whole grid is resident at once
  bool fits = false;
  if ((err = try_fwd_chain<16>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  if ((err = try_fwd_chain<32>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  if ((err = try_fwd_chain<64>(p, &fits, s)) != cudaSuccess || fits)
    return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

template cudaError_t launch_gru_fwd_chain<float, float>(
    int, int, int, int, const int*, const float*, int, const float*,
    long long, int, const float*, const float*, const float*, float*,
    float*, float*, float*, cudaStream_t, float*);
template cudaError_t launch_gru_fwd_chain<bf16, bf16>(
    int, int, int, int, const int*, const bf16*, int, const bf16*, long long,
    int, const bf16*, const bf16*, const bf16*, bf16*, bf16*, bf16*, float*,
    cudaStream_t, float*);
template cudaError_t launch_gru_fwd_chain<float, bf16>(
    int, int, int, int, const int*, const float*, int, const bf16*,
    long long, int, const bf16*, const bf16*, const float*, bf16*, bf16*,
    bf16*, float*, cudaStream_t, float*);

}  // namespace fader

// Floats of scratch fader_stacked_gru needs at these sizes: the chain's
// barrier counters and the k-major copies of h.
extern "C" long long fader_gru_fwd_scratch_floats(int L, int B, int H) {
  return fader::fwd_chain_scratch_floats(L, B, H);
}
