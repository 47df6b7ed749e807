// Teacher-forced 2-layer GRU decoder, forward: without a head, with the
// cross-entropy head and with the masses head.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_dec_fwd_kernel :1110
// (the forward of decoder_teacher_fused :2269, which returns h2_seq and
// leaves the logits head to the caller; entry fader_decoder_teacher) and
// ::_dec_fwd_ce_kernel with head="ce" (the forward of decoder_teacher_fused_nll, through
// _dec_nll_core; entry fader_decoder_ce) and with head = vocabulary ranges
// (the forward of decoder_teacher_fused_masses :2131, through
// _dec_mask_core :1842; entry fader_decoder_masses).
//
// What it computes, for t < T (h2 = 0, h1 = h1_0):
//   layer 1: pre1 = w_tok[tok[t]] + pre_z ; h1' = gates(pre1, h1 @ w_hh1
//            + b_hh1, h1)
//   layer 2: h2p = h1' at t = 0 (the reference's step-0 rule,
//            pallas_gru.py:1520), else h2 ; h2' = gates(h1' @ w_ih2 + b_ih2,
//            h2p @ w_hh2 + b_hh2, h2p)
//   head   : logits = h2' @ w_out + b_out over Vp lanes (pads -1e30), then
//            CE:     nll[t, b] = logsumexp(logits) - logits[tgt[t, b]]
//            masses: out[t, k, b] = sum over range k of softmax(logits)
//                    (pallas_gru.py::_mask_masses :1470)
// and writes h1_seq, h2_seq and the stashes [r, z, n, hn_h] of both layers
// (g41, g42) for the backward. The (T, B, V) log-probs never exist. With
// the masses head the B rows may be n_rep copies of B/n_rep sequences that
// share their tokens (GLSR's four perturbations of z): the caller passes
// the tokens tiled to B rows, as the gather costs the same either way.
//
// What bounds it on an H100: float32 FMA. CE at T=100, B=128, H=512,
// Vp=384: 2 x 100 x 128 x (3 x 512 x 1536 + 512 x 384) = 65 GFLOP,
// 0.97 ms at 67 TFLOP/s; masses at B = 4 x 128 = 512 rows: 262 GFLOP,
// 3.9 ms; without a head the three products a step, 60.4 GFLOP, 0.90 ms.
//
// Design: a fixed number of launches, whatever T is. The reference
// advances both layers in one step loop, but teacher forcing fixes every
// layer-1 input in advance, so layer 1's recurrence never reads layer 2;
// layer 2's input product h1'[t] @ w_ih2 is off its recurrence once h1_seq
// exists; and the step-0 rule means only that layer 2's recurrence starts
// from h1_seq[0]. So the decode is four parts (launch_decoder_recurrence):
// (1) layer 1's chain, the persistent cooperative kernel of
// gru_fwd_chain.cu with its input rows gathered from w_tok by token plus
// pre_z; (2) pre2x = h1_seq @ w_ih2 over all T*B rows, one product
// (grad_reduce.cu's gemm_nn); (3) layer 2's chain over pre2x + b_ih2 from
// h1_seq[0]; (4) the head, one launch over all T*B rows, 16 rows a block,
// which computes each row's Vp logits (split-K tile, 32 lanes at a time)
// into shared memory and reduces them to the row's NLL or K masses there;
// only those reach device memory. The ranges are runtime values, at most
// kMaxRanges of them, passed by value. Each chain holds its layer's w_hh
// columns resident in shared memory for all T steps: two layers' weights
// would not fit one block.
//
// bf16 storage (the CE entry only, fader_decoder_ce_bf16: the JAX
// package's bf16 objectives reach kernel 9 with its CE head; the masses
// head serves GLSR, which stays float32): the same four parts with bf16
// weights and outputs. As in the Pallas kernel, whose layer-2 input and
// head read the float32 h1' and h2' it holds (pallas_gru.py:1518-1535),
// layer 1's chain also writes its float32 h (h1_32), from which the GEMM
// takes layer 2's input product (float32) and layer 2 its first state;
// layer 2 writes its float32 h (h2_32) for the head. h1_seq, h2_seq and
// the stashes are bf16, the NLL float32 (:1576).
#include "gru_tile.cuh"
#include "mma_bf16.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kHeadTB = 16;
constexpr int kHeadNT = 6;   // ce_head_tc: 8-column tiles a warp a pass

// The CE head's reduction of TB rows of logits sL (TB, Vp) in shared
// memory (bias added): warp w takes rows w, w + 8, ... Forward (g null):
// nll[row] = lse - logit[tgt]. Backward: dlogits[row, :] = (softmax -
// onehot(tgt)) * g[row] (pad lanes give exactly 0: exp(-1e30 - max) is 0).
template <int TB>
__device__ __forceinline__ void ce_rows(const float* sL, int R, int Vp,
                                        int r0, const int* __restrict__ tgt,
                                        const float* __restrict__ g,
                                        float* __restrict__ nll,
                                        float* __restrict__ dlogits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int row = r0 + r;
    if (row >= R) continue;
    const float* lg = sL + (size_t)r * Vp;
    float m = -3.4028235e38f;  // lowest float
    for (int c = lane; c < Vp; c += 32) m = fmaxf(m, lg[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    float sum = 0.f;
    for (int c = lane; c < Vp; c += 32) sum += expf(lg[c] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    const float lse = m + logf(sum);
    const int tg = tgt[row];
    if (g == nullptr) {
      if (lane == 0)
        nll[row] = lse - ((tg >= 0 && tg < Vp) ? lg[tg] : 0.f);
    } else {
      const float gr = g[row];
      float* dl = dlogits + (size_t)row * Vp;
      for (int c = lane; c < Vp; c += 32)
        dl[c] = (expf(lg[c] - lse) - (c == tg ? 1.f : 0.f)) * gr;
    }
  }
}

// The CE head over R rows of float32 h2 (16 a block): the logits by the
// split-K tile (float32 FMA), then ce_rows.
template <int TB, typename WT>
__global__ void __launch_bounds__(kThreads)
    ce_head(int R, int H, int Vp, const float* __restrict__ h2,
            const WT* __restrict__ w_out, const WT* __restrict__ b_out,
            const int* __restrict__ tgt, const float* __restrict__ g,
            float* __restrict__ nll, float* __restrict__ dlogits) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  float* sL = red + (size_t)kWarps * TB * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * TB;

  load_a_tile<TB>(sA, h2, H, R, r0, H);
  __syncthreads();
  for (int c0 = 0; c0 < Vp; c0 += kTileN) {
    const int j = c0 + lane;
    float out[TB / kWarps][1];
    {
      float acc[TB][1] = {};
      splitk_gemm<TB, 1, WT>(acc, sA, H, w_out, Vp, 0, j < Vp, j);
      splitk_reduce<TB, 1>(acc, out, red);
    }
    if (j < Vp) {
#pragma unroll
      for (int i = 0; i < TB / kWarps; ++i)
        sL[(size_t)(warp + kWarps * i) * Vp + j] =
            __fadd_rn(out[i][0], to_f32(b_out[j]));
    }
  }
  __syncthreads();
  ce_rows<TB>(sL, R, Vp, r0, tgt, g, nll, dlogits);
}

// The CE head with bf16 h2 and weights (the bf16 backward's, from the
// stored h2_seq): the logits on the tensor cores, one bf16 MMA a product
// (both operands bf16: exact products, float32 accumulation, as the Pallas
// kernel's dot at pallas_gru.py:1664), then ce_rows. The block's 16 rows
// sit in shared memory row-major (H zero-padded to a multiple of 16, rows
// of HP + 8 bf16: ldmatrix reads); warp w takes the 8-column tiles w, w +
// 8, ... of the Vp logits (kHeadNT of them at once: 48 tiles at Vp = 384
// are one pass), its B fragments two bf16 of a row of w_outT (Vp, H) a
// load, from L2.
__global__ void __launch_bounds__(kThreads)
    ce_head_tc(int R, int H, int Vp, const bf16* __restrict__ h2,
               const bf16* __restrict__ w_outT,
               const bf16* __restrict__ b_out, const int* __restrict__ tgt,
               const float* __restrict__ g, float* __restrict__ nll,
               float* __restrict__ dlogits) {
  extern __shared__ float4 smem4[];
  const int HP = (H + 15) / 16 * 16, SA = HP + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem4);                  // [16][SA]
  float* sL = reinterpret_cast<float*>(sA + kHeadTB * SA);    // [16][Vp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * kHeadTB;
  for (int idx = threadIdx.x; idx < kHeadTB * HP; idx += kThreads) {
    const int r = idx / HP, k = idx % HP;
    sA[r * SA + k] = (r0 + r < R && k < H) ? h2[(size_t)(r0 + r) * H + k]
                                           : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const bf16* a_row = sA + (lane & 15) * SA + (lane >> 4) * 8;
  const bool pairs = (H & 1) == 0;     // 4-byte loads of two k
  // two bf16 of the lane's B column n (a row of w_outT) at k, k + 1
  auto pair = [&](int n, int k) -> uint32_t {
    if (n >= Vp || k >= H) return 0u;
    const bf16* wr = w_outT + (size_t)n * H;
    if (pairs) return __ldg(reinterpret_cast<const unsigned*>(wr + k));
    const unsigned lo = __bfloat16_as_ushort(wr[k]);
    const unsigned hi = k + 1 < H ? __bfloat16_as_ushort(wr[k + 1]) : 0u;
    return lo | (hi << 16);
  };
  // warp w takes the 8-column tiles w + 8u, u < kHeadNT, of each pass:
  // kHeadNT independent accumulators a k-step
  const int ntiles = (Vp + 7) / 8;
  for (int base = warp; base < ntiles; base += kWarps * kHeadNT) {
    float c[kHeadNT][4] = {};
    for (int k0 = 0; k0 < HP; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_row + k0);
#pragma unroll
      for (int u = 0; u < kHeadNT; ++u) {
        const int n = (base + kWarps * u) * 8 + gq;   // the lane's B column
        mma_bf16(c[u], a, pair(n, k0 + 2 * q), pair(n, k0 + 2 * q + 8));
      }
    }
#pragma unroll
    for (int u = 0; u < kHeadNT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (base + kWarps * u) * 8 + 2 * q + (e & 1);
        if (col < Vp)
          sL[(size_t)(gq + 8 * (e >> 1)) * Vp + col] =
              __fadd_rn(c[u][e], to_f32(b_out[col]));
      }
  }
  __syncthreads();
  ce_rows<kHeadTB>(sL, R, Vp, r0, tgt, g, nll, dlogits);
}

template <typename AT, typename WT>
cudaError_t launch_ce_head(int R, int H, int Vp, const AT* h2,
                           const WT* w_out, const WT* b_out, const int* tgt,
                           const float* g, float* nll, float* dlogits,
                           cudaStream_t s, const WT* w_outT) {
  if constexpr (!is_f32<AT> && !is_f32<WT>) {
    if (w_outT == nullptr) return cudaErrorInvalidValue;
    const size_t HP = (H + 15) / 16 * 16;
    const size_t smem = kHeadTB * ((HP + 8) * sizeof(bf16) +
                                   (size_t)Vp * sizeof(float));
    cudaError_t err = allow_smem(ce_head_tc, smem);
    if (err != cudaSuccess) return err;
    ce_head_tc<<<(R + kHeadTB - 1) / kHeadTB, kThreads, smem, s>>>(
        R, H, Vp, h2, w_outT, b_out, tgt, g, nll, dlogits);
    return cudaGetLastError();
  } else {
    const size_t smem =
        smem_bytes<kHeadTB>(1, H) + (size_t)kHeadTB * Vp * sizeof(float);
    cudaError_t err = allow_smem(ce_head<kHeadTB, WT>, smem);
    if (err != cudaSuccess) return err;
    ce_head<kHeadTB, WT>
        <<<(R + kHeadTB - 1) / kHeadTB, kThreads, smem, s>>>(
            R, H, Vp, h2, w_out, b_out, tgt, g, nll, dlogits);
    return cudaGetLastError();
  }
}

template cudaError_t launch_ce_head<float, float>(int, int, int,
                                                  const float*, const float*,
                                                  const float*, const int*,
                                                  const float*, float*,
                                                  float*, cudaStream_t,
                                                  const float*);
template cudaError_t launch_ce_head<float, bf16>(int, int, int, const float*,
                                                 const bf16*, const bf16*,
                                                 const int*, const float*,
                                                 float*, float*, cudaStream_t,
                                                 const bf16*);
template cudaError_t launch_ce_head<bf16, bf16>(int, int, int, const bf16*,
                                                const bf16*, const bf16*,
                                                const int*, const float*,
                                                float*, float*, cudaStream_t,
                                                const bf16*);

// The masses head over R = T*B rows of h2 (16 a block), row t*B + b.
// Forward (g null): masses[t, k, b] = sum over range k of p. Backward (g
// given, (T, K, B)): dlogits[row, c] = p_c * sum_k g_k (1[c in k] - m_k),
// the order of pallas_gru.py:1676-1681. Pad lanes: p = 0 exactly.
template <int TB>
__global__ void __launch_bounds__(kThreads)
    mass_head(int R, int B, int H, int Vp, MassRanges rg,
              const float* __restrict__ h2, const float* __restrict__ w_out,
              const float* __restrict__ b_out, const float* __restrict__ g,
              float* __restrict__ masses, float* __restrict__ dlogits) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  float* sL = red + (size_t)kWarps * TB * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * TB;

  load_a_tile<TB>(sA, h2, H, R, r0, H);
  __syncthreads();
  for (int c0 = 0; c0 < Vp; c0 += kTileN) {
    const int j = c0 + lane;
    float out[TB / kWarps][1];
    {
      float acc[TB][1] = {};
      splitk_gemm<TB, 1>(acc, sA, H, w_out, Vp, 0, j < Vp, j);
      splitk_reduce<TB, 1>(acc, out, red);
    }
    if (j < Vp) {
#pragma unroll
      for (int i = 0; i < TB / kWarps; ++i)
        sL[(size_t)(warp + kWarps * i) * Vp + j] =
            __fadd_rn(out[i][0], b_out[j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int row = r0 + r;
    if (row >= R) continue;
    const int t = row / B, b = row - t * B;
    float* lg = sL + (size_t)r * Vp;
    float m = -3.4028235e38f;  // lowest float
    for (int c = lane; c < Vp; c += 32) m = fmaxf(m, lg[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    float sum = 0.f;
    for (int c = lane; c < Vp; c += 32) {
      const float e = expf(lg[c] - m);
      lg[c] = e;  // each lane rewrites only its own lanes
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    for (int c = lane; c < Vp; c += 32) lg[c] = lg[c] / sum;  // p
    float mk[kMaxRanges];
#pragma unroll
    for (int k = 0; k < kMaxRanges; ++k) {
      float part = 0.f;
      if (k < rg.k)
        for (int c = lane; c < Vp; c += 32)
          if (c >= rg.lo[k] && c < rg.hi[k]) part += lg[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xFFFFFFFFu, part, off);
      mk[k] = part;
    }
    if (g == nullptr) {
      if (lane == 0)
        for (int k = 0; k < rg.k; ++k)
          masses[((size_t)t * rg.k + k) * B + b] = mk[k];
    } else {
      float gk[kMaxRanges];
#pragma unroll
      for (int k = 0; k < kMaxRanges; ++k)
        gk[k] = k < rg.k ? g[((size_t)t * rg.k + k) * B + b] : 0.f;
      float* dl = dlogits + (size_t)row * Vp;
      for (int c = lane; c < Vp; c += 32) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxRanges; ++k)
          if (k < rg.k) {
            const float ind = (c >= rg.lo[k] && c < rg.hi[k]) ? 1.f : 0.f;
            acc = acc + gk[k] * (ind - mk[k]);
          }
        dl[c] = lg[c] * acc;
      }
    }
  }
}

cudaError_t launch_mass_head(int R, int B, int H, int Vp, MassRanges rg,
                             const float* h2, const float* w_out,
                             const float* b_out, const float* g,
                             float* masses, float* dlogits, cudaStream_t s) {
  const size_t smem =
      smem_bytes<kHeadTB>(1, H) + (size_t)kHeadTB * Vp * sizeof(float);
  cudaError_t err = allow_smem(mass_head<kHeadTB>, smem);
  if (err != cudaSuccess) return err;
  mass_head<kHeadTB><<<(R + kHeadTB - 1) / kHeadTB, kThreads, smem, s>>>(
      R, B, H, Vp, rg, h2, w_out, b_out, g, masses, dlogits);
  return cudaGetLastError();
}

namespace {

// The scratch of a forward call, in floats: the chains' barrier counters
// and k-major rows (used by both chains in turn), then pre2x (T, B, 3H),
// 16-byte aligned.
long long pre2x_at(int B, int H) {
  return (fwd_chain_scratch_floats(1, B, H) + 3) / 4 * 4;
}

}  // namespace

long long decoder_fwd_scratch_floats(int T, int B, int H) {
  return pre2x_at(B, H) + 3LL * T * B * H;
}

cudaError_t launch_decoder_recurrence(
    int T, int B, int H, int Vp, const int* tok, const float* w_tok,
    const float* pre_z, const float* w_hh1, const float* b_hh1,
    const float* w_ih2, const float* b_ih2, const float* w_hh2,
    const float* b_hh2, const float* h1_0, float* h1_seq, float* h2_seq,
    float* g41, float* g42, float* scratch, cudaStream_t s) {
  const int G = 3 * H;
  float* pre2x = scratch + pre2x_at(B, H);
  cudaError_t err;
  // (1) layer 1: xpre = w_tok[tok] + pre_z, from h1_0
  if ((err = launch_gru_fwd_chain<float, float>(
           1, T, B, H, tok, w_tok, Vp, pre_z, (long long)B * G, G, w_hh1,
           b_hh1, h1_0, h1_seq, nullptr, g41, scratch, s)) != cudaSuccess ||
      // (2) layer 2's input product over all steps
      (err = gemm_nn(T * B, G, H, h1_seq, w_ih2, pre2x, nullptr, 0, s)) !=
          cudaSuccess)
    return err;
  // (3) layer 2: xpre = pre2x + b_ih2, from h1_seq[0] (the step-0 rule)
  return launch_gru_fwd_chain<float, float>(1, T, B, H, nullptr, pre2x, 0,
                                            b_ih2, 0, 0, w_hh2, b_hh2,
                                            h1_seq, h2_seq, nullptr, g42,
                                            scratch, s);
}

cudaError_t launch_decoder_recurrence_bf16(
    int T, int B, int H, int Vp, const int* tok, const bf16* w_tok,
    const bf16* pre_z, const bf16* w_hh1, const bf16* b_hh1,
    const bf16* w_ih2, const bf16* b_ih2, const bf16* w_hh2,
    const bf16* b_hh2, const bf16* h1_0, bf16* h1_seq, bf16* h2_seq,
    bf16* g41, bf16* g42, float* h1_32, float* h2_32, float* scratch,
    cudaStream_t s) {
  const int G = 3 * H;
  float* pre2x = scratch + pre2x_at(B, H);
  cudaError_t err;
  // (1) layer 1: xpre = w_tok[tok] + pre_z, from h1_0; h1 also in float32
  if ((err = launch_gru_fwd_chain<bf16, bf16>(
           1, T, B, H, tok, w_tok, Vp, pre_z, (long long)B * G, G, w_hh1,
           b_hh1, h1_0, h1_seq, nullptr, g41, scratch, s, h1_32)) !=
          cudaSuccess ||
      // (2) layer 2's input product over all steps, from the float32 h1
      (err = gemm_nn(T * B, G, H, h1_32, w_ih2, pre2x, nullptr, 0, s)) !=
          cudaSuccess)
    return err;
  // (3) layer 2: xpre = pre2x + b_ih2, from the float32 h1[0]; h2 also in
  // float32, for the head
  return launch_gru_fwd_chain<float, bf16>(1, T, B, H, nullptr, pre2x, 0,
                                           b_ih2, 0, 0, w_hh2, b_hh2, h1_32,
                                           h2_seq, nullptr, g42, scratch, s,
                                           h2_32);
}

bool make_ranges(int K, const int* ranges, MassRanges* rg) {
  if (K < 1 || K > kMaxRanges) return false;
  rg->k = K;
  for (int k = 0; k < kMaxRanges; ++k) {
    rg->lo[k] = k < K ? ranges[2 * k] : 0;
    rg->hi[k] = k < K ? ranges[2 * k + 1] : 0;
  }
  return true;
}

}  // namespace fader

// Floats of scratch the three forward entries need at these sizes: the
// chains' barrier counters and k-major rows, then layer 2's input
// projection (T, B, 3H).
extern "C" long long fader_decoder_fwd_scratch_floats(int T, int B, int H) {
  return fader::decoder_fwd_scratch_floats(T, B, H);
}

// tok, tgt (T,B) int32 (tok[0] = the start id V-1); w_tok (Vp,3H); pre_z
// (B,3H) = z @ w_z + b_ih; w_hh1, w_ih2, w_hh2 (H,3H); b_hh1, b_ih2, b_hh2
// (3H); h1_0 (B,H); w_out (H,Vp); b_out (Vp), pad lanes -1e30. Outputs:
// h1_seq, h2_seq (T,B,H); g41, g42 (T,B,4H) or both null (no gradient);
// nll (T,B). Scratch: scratch_floats >= fader_decoder_fwd_scratch_floats(
// T,B,H) floats. Two cooperative launches, a GEMM and the head, whatever
// T is; a cooperative launch the device refuses returns its error. T >= 1.
extern "C" int fader_decoder_ce(int T, int B, int H, int Vp, const int* tok,
                                const int* tgt, const float* w_tok,
                                const float* pre_z, const float* w_hh1,
                                const float* b_hh1, const float* w_ih2,
                                const float* b_ih2, const float* w_hh2,
                                const float* b_hh2, const float* h1_0,
                                const float* w_out, const float* b_out,
                                float* h1_seq, float* h2_seq, float* g41,
                                float* g42, float* nll, float* scratch,
                                long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < decoder_fwd_scratch_floats(T, B, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_decoder_recurrence(
      T, B, H, Vp, tok, w_tok, pre_z, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2,
      b_hh2, h1_0, h1_seq, h2_seq, g41, g42, scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ce_head(T * B, H, Vp, h2_seq, w_out, b_out, tgt,
                             nullptr, nll, nullptr, s);
}

// As fader_decoder_ce with bf16 weights, pre_z, h1_0 and outputs h1_seq,
// h2_seq, g41, g42 (the NLL float32). h1_32, h2_32 (T,B,H) float32
// scratch: layer 1's and layer 2's float32 states, from which layer 2 and
// the head read.
extern "C" int fader_decoder_ce_bf16(
    int T, int B, int H, int Vp, const int* tok, const int* tgt,
    const fader::bf16* w_tok, const fader::bf16* pre_z,
    const fader::bf16* w_hh1, const fader::bf16* b_hh1,
    const fader::bf16* w_ih2, const fader::bf16* b_ih2,
    const fader::bf16* w_hh2, const fader::bf16* b_hh2,
    const fader::bf16* h1_0, const fader::bf16* w_out,
    const fader::bf16* b_out, fader::bf16* h1_seq, fader::bf16* h2_seq,
    fader::bf16* g41, fader::bf16* g42, float* nll, float* h1_32,
    float* h2_32, float* scratch, long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < decoder_fwd_scratch_floats(T, B, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_decoder_recurrence_bf16(
      T, B, H, Vp, tok, w_tok, pre_z, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2,
      b_hh2, h1_0, h1_seq, h2_seq, g41, g42, h1_32, h2_32, scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ce_head(T * B, H, Vp, h2_32, w_out, b_out, tgt,
                             nullptr, nll, nullptr, s);
}

// As fader_decoder_ce with the masses head: tok (T,B) the input ids (the
// n_rep copies' tokens already tiled to B rows); ranges 2K ints in host
// memory, 1 <= K <= kMaxRanges. Output masses (T,K,B) in place of nll.
extern "C" int fader_decoder_masses(
    int T, int B, int H, int Vp, int K, const int* ranges, const int* tok,
    const float* w_tok, const float* pre_z, const float* w_hh1,
    const float* b_hh1, const float* w_ih2, const float* b_ih2,
    const float* w_hh2, const float* b_hh2, const float* h1_0,
    const float* w_out, const float* b_out, float* h1_seq, float* h2_seq,
    float* g41, float* g42, float* masses, float* scratch,
    long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MassRanges rg;
  if (!make_ranges(K, ranges, &rg) ||
      scratch_floats < decoder_fwd_scratch_floats(T, B, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_decoder_recurrence(
      T, B, H, Vp, tok, w_tok, pre_z, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2,
      b_hh2, h1_0, h1_seq, h2_seq, g41, g42, scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_mass_head(T * B, B, H, Vp, rg, h2_seq, w_out, b_out,
                               nullptr, masses, nullptr, s);
}

// The recurrence alone (kernel 7): as fader_decoder_ce without w_out,
// b_out, tgt and nll. Outputs h1_seq, h2_seq (T,B,H); g41, g42 (T,B,4H) or
// both null (no gradient). T >= 1.
extern "C" int fader_decoder_teacher(
    int T, int B, int H, int Vp, const int* tok, const float* w_tok,
    const float* pre_z, const float* w_hh1, const float* b_hh1,
    const float* w_ih2, const float* b_ih2, const float* w_hh2,
    const float* b_hh2, const float* h1_0, float* h1_seq, float* h2_seq,
    float* g41, float* g42, float* scratch, long long scratch_floats,
    void* stream) {
  using namespace fader;
  if (scratch_floats < decoder_fwd_scratch_floats(T, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)launch_decoder_recurrence(
      T, B, H, Vp, tok, w_tok, pre_z, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2,
      b_hh2, h1_0, h1_seq, h2_seq, g41, g42, scratch,
      static_cast<cudaStream_t>(stream));
}
