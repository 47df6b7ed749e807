// Embedded-id GRU kernels, forward: L stacked GRU directions over integer
// ids whose input projection is a row gather.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_fwd_embed_kernel
// (stacked_gru_embed_finals: the serving variant, finals only, entry
// fader_embed_gru_finals; and the training variant with the gate stash,
// entry fader_embed_gru_train) and ::_fwd_embed_seq_kernel
// (stacked_gru_embed_seq, the sub-decoders: entry fader_embed_gru_train
// with a per-sequence `prez` in place of b_ih).
//
// What it computes, for each direction l < L and step t < T:
//   pre_x = w_ih[l, tok[l, t, b]] + b_ih[l]   (the one-hot matmul of the TPU
//                                             kernel is exactly this gather)
//   pre_h = h @ w_hh[l] + b_hh[l]
//   h'    = gates(pre_x, pre_h, h)            (r, z, n as ops/gru.py)
// Reversed directions arrive with their tokens already time-flipped in
// tok (L, T, B). Out-of-range tokens select no row (pre_x = b_ih), as a
// one-hot of an out-of-range id is all zeros.
//
// What bounds it on an H100: float32 FMA on the CUDA cores. At the serving
// shape (L=4, T=100, B=64, H=512) the recurrence is 40.3 GFLOP, 0.60 ms at
// the 67 TFLOP/s float32 peak; the weights (4 x 2.4 MB w_ih + 4 x 3.1 MB
// w_hh) sit in the 50 MB L2 after the first step. Every h_{t+1} unit needs
// all of h_t, a device-wide dependency each step.
//
// Design: one launch per step, all T launches issued by one host call
// (fader_embed_gru_finals) so Python is not in the loop, with h ping-ponged
// between two device buffers. A block owns (direction, 32 hidden units with
// their r/z/n columns, 16 batch rows): the split-K tile of gru_tile.cuh,
// with h_t in shared memory and w_hh read from L2 into registers, each read
// feeding 16 rows. At B=64 the grid is 16 x 4 x 4 = 256 blocks, two
// resident per SM (one wave). Only the finals are written (the TPU kernel wrote
// h_seq and its caller kept [:, -1]). Tensor cores, TMA and a persistent
// kernel that keeps w_hh on chip across steps are later work.
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kEncTB = 16;

// two blocks per SM: 256 blocks at B=64 then run in one wave
template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
    embed_gru_step(int T, int B, int H, int Vp, int t,
                   const int* __restrict__ tok,
                   const float* __restrict__ w_ih,
                   const float* __restrict__ b_ih,
                   const float* __restrict__ w_hh,
                   const float* __restrict__ b_hh,
                   const float* __restrict__ h_in,
                   float* __restrict__ h_out) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  const int l = blockIdx.z;
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sA, h_in + (size_t)l * B * H, H, B, b0, H);
  __syncthreads();
  float acc[TB][3] = {};
  splitk_gemm<TB, 3>(acc, sA, H, w_hh + (size_t)l * H * G, G, H, j < H, j);
  float ph[TB / kWarps][3];
  splitk_reduce<TB, 3>(acc, ph, red);

  if (j >= H) return;
  const float* bi = b_ih + (size_t)l * G;
  const float* bh = b_hh + (size_t)l * G;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const int tk = tok[((size_t)l * T + t) * B + b];
    float xr = bi[j], xz = bi[H + j], xn = bi[2 * H + j];
    if (tk >= 0 && tk < Vp) {
      const float* row = w_ih + ((size_t)l * Vp + tk) * G;
      xr = __fadd_rn(row[j], xr);
      xz = __fadd_rn(row[H + j], xz);
      xn = __fadd_rn(row[2 * H + j], xn);
    }
    const float hr = __fadd_rn(ph[i][0], bh[j]);
    const float hz = __fadd_rn(ph[i][1], bh[H + j]);
    const float hn = __fadd_rn(ph[i][2], bh[2 * H + j]);
    h_out[(size_t)l * B * H + (size_t)b * H + j] =
        gru_combine(xr, xz, xn, hr, hz, hn, sA[j * (TB + 4) + r]);
  }
}

// The training variant of one step (encoder and sub-decoders): the input
// row is w_in[l, id] + add[l, b] (b_ih with add_bs = 0, or the
// per-sequence prez with add_bs = 3H), h_prev is read at h_in + l*h_in_ls
// (h0 at t = 0, else h_seq[l, t-1]), and the step writes h_seq[l, t] and,
// unless stash is null (no gradient wanted), the backward's gate stash
// [r, z, n, hn_h] (L, T, B, 4H) at step t.
template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
    embed_gru_train_step(int T, int B, int H, int V, int t,
                         const int* __restrict__ ids,
                         const float* __restrict__ w_in,
                         const float* __restrict__ add, long long add_ls,
                         int add_bs, const float* __restrict__ w_hh,
                         const float* __restrict__ b_hh,
                         const float* __restrict__ h_in, long long h_in_ls,
                         float* __restrict__ h_seq,
                         float* __restrict__ stash) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  const int l = blockIdx.z;
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sA, h_in + l * h_in_ls, H, B, b0, H);
  __syncthreads();
  float acc[TB][3] = {};
  splitk_gemm<TB, 3>(acc, sA, H, w_hh + (size_t)l * H * G, G, H, j < H, j);
  float ph[TB / kWarps][3];
  splitk_reduce<TB, 3>(acc, ph, red);

  if (j >= H) return;
  const float* bh = b_hh + (size_t)l * G;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const size_t lt = ((size_t)l * T + t) * B + b;
    const int id = ids[lt];
    const float* ad = add + l * add_ls + (size_t)b * add_bs;
    float xr = ad[j], xz = ad[H + j], xn = ad[2 * H + j];
    if (id >= 0 && id < V) {
      const float* row = w_in + ((size_t)l * V + id) * G;
      xr = __fadd_rn(row[j], xr);
      xz = __fadd_rn(row[H + j], xz);
      xn = __fadd_rn(row[2 * H + j], xn);
    }
    const float hr = __fadd_rn(ph[i][0], bh[j]);
    const float hz = __fadd_rn(ph[i][1], bh[H + j]);
    const float hn = __fadd_rn(ph[i][2], bh[2 * H + j]);
    float rg, zg, ng;
    h_seq[lt * H + j] = gru_gates(xr, xz, xn, hr, hz, hn,
                                  sA[j * (TB + 4) + r], rg, zg, ng);
    if (stash != nullptr) {
      float* st = stash + lt * 4 * H;
      st[j] = rg;
      st[H + j] = zg;
      st[2 * H + j] = ng;
      st[3 * H + j] = hn;
    }
  }
}

// One launch of embed_gru_train_step for step t: h_prev is read at h_in +
// l*h_in_ls (h0 at t = 0, else h_seq[l, t-1]).
cudaError_t launch_embed_train_step(int L, int T, int B, int H, int V, int t,
                                    const int* ids, const float* w_in,
                                    const float* add, long long add_ls,
                                    int add_bs, const float* w_hh,
                                    const float* b_hh, const float* h_in,
                                    long long h_in_ls, float* h_seq,
                                    float* stash, cudaStream_t s) {
  const size_t smem = smem_bytes<kEncTB>(1, H);
  cudaError_t err = allow_smem(embed_gru_train_step<kEncTB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kTileN - 1) / kTileN, (B + kEncTB - 1) / kEncTB, L);
  embed_gru_train_step<kEncTB><<<grid, kThreads, smem, s>>>(
      T, B, H, V, t, ids, w_in, add, add_ls, add_bs, w_hh, b_hh, h_in,
      h_in_ls, h_seq, stash);
  return cudaGetLastError();
}

}  // namespace fader

extern "C" const char* fader_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// tok (L,T,B) int32; w_ih (L,Vp,3H); b_ih (L,3H); w_hh (L,H,3H); b_hh (L,3H);
// h0 (L,B,H); h_buf (2,L,B,H) scratch; finals (L,B,H). All contiguous,
// float32, on one device. Enqueues T launches on `stream`; returns the
// first launch error (0 = cudaSuccess).
extern "C" int fader_embed_gru_finals(int L, int T, int B, int H, int Vp,
                                      const int* tok, const float* w_ih,
                                      const float* b_ih, const float* w_hh,
                                      const float* b_hh, const float* h0,
                                      float* h_buf, float* finals,
                                      void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)L * B * H;
  if (T == 0) {
    cudaMemcpyAsync(finals, h0, n * sizeof(float), cudaMemcpyDeviceToDevice,
                    s);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes<kEncTB>(1, H);
  cudaError_t err = allow_smem(embed_gru_step<kEncTB>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kTileN - 1) / kTileN, (B + kEncTB - 1) / kEncTB, L);
  const float* h_in = h0;
  for (int t = 0; t < T; ++t) {
    float* h_out = (t == T - 1) ? finals : h_buf + (size_t)(t % 2) * n;
    embed_gru_step<kEncTB><<<grid, kThreads, smem, s>>>(
        T, B, H, Vp, t, tok, w_ih, b_ih, w_hh, b_hh, h_in, h_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    h_in = h_out;
  }
  return (int)cudaSuccess;
}

// The training forward (and the sub-decoders' forward, with or without a
// gradient): ids (L,T,B) int32; w_in (L,V,3H); add (L,3H) with add_bs = 0
// or (L,B,3H) with add_bs = 3H; w_hh (L,H,3H); b_hh (L,3H); h0 (L,B,H);
// h_seq (L,T,B,H) out; stash (L,T,B,4H) out, or null. T launches.
extern "C" int fader_embed_gru_train(int L, int T, int B, int H, int V,
                                     int add_bs, const int* ids,
                                     const float* w_in, const float* add,
                                     const float* w_hh, const float* b_hh,
                                     const float* h0, float* h_seq,
                                     float* stash, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long G = 3LL * H;
  const long long add_ls = add_bs ? (long long)B * G : G;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : h_seq + (size_t)(t - 1) * B * H;
    const long long h_in_ls = t == 0 ? (long long)B * H : (long long)T * B * H;
    cudaError_t err = launch_embed_train_step(
        L, T, B, H, V, t, ids, w_in, add, add_ls, add_bs, w_hh, b_hh, h_in,
        h_in_ls, h_seq, stash, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
