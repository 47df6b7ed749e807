// Decode kernels: the whole autoregressive greedy / Gumbel-max decode of
// the 2-layer GRUCell global decoder, emitting only int32 tokens.
//
// Replaces: music_fader_nets_tpu/ops/pallas_decode.py::_decode_kernel
// (greedy, entry fader_greedy_decode) and ::_sample_kernel (sampling,
// entry fader_sample_decode). One source, two entry points.
//
// Per step i (start token V-1, h2 = 0, h1 = h1_0):
//   layer 1: pre1 = w_tok[tok] + pre_z ; pre_h1 = h1 @ w_hh1 + b_hh1
//   layer 2: pre2 = h1' @ w_ih2 + b_ih2 ; pre_h2 = h2p @ w_hh2 + b_hh2,
//            with h2p = h1' at i == 0 (the reference's step-0 rule,
//            model_v2.py:130-132) and h2 otherwise
//   logits : h2' @ w_out + b_out (pad lanes of b_out carry -1e30)
//   token  : argmax(logits)                      (greedy)
//            argmax(logits * inv_t[b] + noise[i]) (sampling)
//   ties go to the LOWEST index, as jnp.argmax.
//
// What bounds it on an H100: at B=64 it is float32 FMA work,
// 300 x 2 x 64 x (3 x 512 x 1536 + 512 x 342) = 97 GFLOP, 1.45 ms at the
// 67 TFLOP/s float32 peak. At B=1 it is latency: three dependent phases a
// step, each reading its slice of the ~13 MB of weights from L2.
//
// Design: three launches a step (layer 1, layer 2, logits + argmax), all
// 3 x steps + 1 issued by one host call, so Python is not in the loop and
// the token never leaves the device. The weights (~13 MB) do not fit one
// SM's 227 KB of shared memory, so every block streams its slice from the
// 50 MB L2, where the weights stay after the first step (the TPU kernel's
// VMEM residency is not copied). Each phase is the split-K tile of
// gru_tile.cuh over 8 batch rows: a GRU block owns 32 hidden units with
// their r/z/n columns (128 blocks at B=64), a logits block 32 vocab lanes
// (96 blocks); each weight read from L2 feeds 8 rows. A logits block folds
// its lanes into a per-row 64-bit key (order-preserving float bits << 32 |
// ~lane) with atomicMax, which yields the row's argmax with lowest-index
// ties. The next step's layer-1 blocks read the token from that key;
// layer 2 writes it out and clears the key. The sampling epilogue is
// __fmul_rn then __fadd_rn, so a row with inv_t = 1 and zero noise
// reproduces the greedy token bit for bit.
#include "gru_tile.cuh"

namespace fader {

constexpr int kDecTB = 8;

__device__ __forceinline__ unsigned long long argmax_key(float v, int lane) {
  if (v == 0.0f) v = 0.0f;  // -0 ties +0, as in a float compare
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)lane);
}

__device__ __forceinline__ int key_token(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

template <int TB>
__global__ void __launch_bounds__(kThreads)
    dec_layer1(int B, int H, int V, int step,
               const unsigned long long* __restrict__ keys,
               const float* __restrict__ w_tok,
               const float* __restrict__ pre_z,
               const float* __restrict__ w_hh1,
               const float* __restrict__ b_hh1,
               const float* __restrict__ h_in, float* __restrict__ h_out) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sA, h_in, H, B, b0, H);
  __syncthreads();
  float acc[TB][3] = {};
  splitk_gemm<TB, 3>(acc, sA, H, w_hh1, G, H, j < H, j);
  float ph[TB / kWarps][3];
  splitk_reduce<TB, 3>(acc, ph, red);

  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const int tk = (step == 0) ? V - 1 : key_token(keys[b]);
    const float* row = w_tok + (size_t)tk * G;
    const float* pz = pre_z + (size_t)b * G;
    const float xr = __fadd_rn(row[j], pz[j]);
    const float xz = __fadd_rn(row[H + j], pz[H + j]);
    const float xn = __fadd_rn(row[2 * H + j], pz[2 * H + j]);
    const float hr = __fadd_rn(ph[i][0], b_hh1[j]);
    const float hz = __fadd_rn(ph[i][1], b_hh1[H + j]);
    const float hn = __fadd_rn(ph[i][2], b_hh1[2 * H + j]);
    h_out[(size_t)b * H + j] =
        gru_combine(xr, xz, xn, hr, hz, hn, sA[j * (TB + 4) + r]);
  }
}

template <int TB>
__global__ void __launch_bounds__(kThreads)
    dec_layer2(int B, int H, int step, const float* __restrict__ h1,
               const float* __restrict__ h2_prev,
               const float* __restrict__ w_ih2,
               const float* __restrict__ b_ih2,
               const float* __restrict__ w_hh2,
               const float* __restrict__ b_hh2, float* __restrict__ h_out,
               unsigned long long* __restrict__ keys,
               int* __restrict__ tokens_out) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);
  float* sH = sX + (size_t)H * (TB + 4);
  float* red = sH + (size_t)H * (TB + 4);
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  // the previous step's tokens: every layer-1 block has read them
  if (blockIdx.x == 0 && step > 0 && threadIdx.x < TB) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      tokens_out[(size_t)(step - 1) * B + b] = key_token(keys[b]);
      keys[b] = 0ull;
    }
  }

  load_a_tile<TB>(sX, h1, H, B, b0, H);
  load_a_tile<TB>(sH, h2_prev, H, B, b0, H);
  __syncthreads();
  float px[TB / kWarps][3], ph[TB / kWarps][3];
  {
    float acc[TB][3] = {};
    splitk_gemm<TB, 3>(acc, sX, H, w_ih2, G, H, j < H, j);
    splitk_reduce<TB, 3>(acc, px, red);
  }
  {
    float acc[TB][3] = {};
    splitk_gemm<TB, 3>(acc, sH, H, w_hh2, G, H, j < H, j);
    splitk_reduce<TB, 3>(acc, ph, red);
  }

  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const float xr = __fadd_rn(px[i][0], b_ih2[j]);
    const float xz = __fadd_rn(px[i][1], b_ih2[H + j]);
    const float xn = __fadd_rn(px[i][2], b_ih2[2 * H + j]);
    const float hr = __fadd_rn(ph[i][0], b_hh2[j]);
    const float hz = __fadd_rn(ph[i][1], b_hh2[H + j]);
    const float hn = __fadd_rn(ph[i][2], b_hh2[2 * H + j]);
    h_out[(size_t)b * H + j] =
        gru_combine(xr, xz, xn, hr, hz, hn, sH[j * (TB + 4) + r]);
  }
}

// TB = 8: after the reduction warp w holds row w across the block's 32
// lanes, so the row's argmax over them is one warp shuffle.
__global__ void __launch_bounds__(kThreads)
    dec_logits(int B, int H, int Vp, int step, const float* __restrict__ h2,
               const float* __restrict__ w_out,
               const float* __restrict__ b_out,
               const float* __restrict__ noise,
               const float* __restrict__ inv_t,
               unsigned long long* __restrict__ keys) {
  constexpr int TB = kDecTB;
  static_assert(TB == kWarps, "one row per warp");
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kTileN + lane;
  const int b = blockIdx.y * TB + (threadIdx.x >> 5);

  load_a_tile<TB>(sA, h2, H, B, blockIdx.y * TB, H);
  __syncthreads();
  float out[1][1];
  {
    float acc[TB][1] = {};
    splitk_gemm<TB, 1>(acc, sA, H, w_out, Vp, 0, j < Vp, j);
    splitk_reduce<TB, 1>(acc, out, red);
  }
  unsigned long long key = 0ull;
  if (b < B && j < Vp) {
    float v = __fadd_rn(out[0][0], b_out[j]);
    if (noise != nullptr) {
      v = __fadd_rn(__fmul_rn(v, inv_t[b]),
                    noise[((size_t)step * B + b) * Vp + j]);
    }
    key = argmax_key(v, j);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, key, off);
    key = o > key ? o : key;
  }
  if (lane == 0 && b < B) atomicMax(&keys[b], key);
}

__global__ void dec_finish(int B, int step,
                           const unsigned long long* __restrict__ keys,
                           int* __restrict__ tokens_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) tokens_out[(size_t)step * B + b] = key_token(keys[b]);
}

static int decode(int B, int H, int V, int Vp, int steps, const float* w_tok,
                  const float* w_hh1, const float* b_hh1, const float* w_ih2,
                  const float* b_ih2, const float* w_hh2, const float* b_hh2,
                  const float* w_out, const float* b_out, const float* pre_z,
                  const float* h1_0, const float* noise, const float* inv_t,
                  float* h1_buf, float* h2_buf, unsigned long long* keys,
                  int* tokens_out, cudaStream_t s) {
  if (steps <= 0) return (int)cudaSuccess;
  const size_t smem1 = smem_bytes<kDecTB>(1, H);
  const size_t smem2 = smem_bytes<kDecTB>(2, H);
  cudaError_t err;
  if ((err = allow_smem(dec_layer1<kDecTB>, smem1)) != cudaSuccess ||
      (err = allow_smem(dec_layer2<kDecTB>, smem2)) != cudaSuccess ||
      (err = allow_smem(dec_logits, smem1)) != cudaSuccess)
    return (int)err;
  cudaMemsetAsync(keys, 0, (size_t)B * sizeof(unsigned long long), s);
  const dim3 grid_h((H + kTileN - 1) / kTileN, (B + kDecTB - 1) / kDecTB);
  const dim3 grid_v((Vp + kTileN - 1) / kTileN, (B + kDecTB - 1) / kDecTB);
  const size_t n = (size_t)B * H;
  const float* h1_prev = h1_0;
  const float* h2_prev = nullptr;
  for (int i = 0; i < steps; ++i) {
    float* h1_new = h1_buf + (size_t)(i % 2) * n;
    float* h2_new = h2_buf + (size_t)(i % 2) * n;
    dec_layer1<kDecTB><<<grid_h, kThreads, smem1, s>>>(
        B, H, V, i, keys, w_tok, pre_z, w_hh1, b_hh1, h1_prev, h1_new);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dec_layer2<kDecTB><<<grid_h, kThreads, smem2, s>>>(
        B, H, i, h1_new, i == 0 ? h1_new : h2_prev, w_ih2, b_ih2, w_hh2,
        b_hh2, h2_new, keys, tokens_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dec_logits<<<grid_v, kThreads, smem1, s>>>(B, H, Vp, i, h2_new, w_out,
                                               b_out, noise, inv_t, keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    h1_prev = h1_new;
    h2_prev = h2_new;
  }
  dec_finish<<<(B + 127) / 128, 128, 0, s>>>(B, steps - 1, keys, tokens_out);
  return (int)cudaGetLastError();
}

}  // namespace fader

// Shapes (all contiguous, float32 unless noted, on one device):
//   w_tok (Vp,3H); w_hh1, w_ih2, w_hh2 (H,3H); b_hh1, b_ih2, b_hh2 (3H);
//   w_out (H,Vp); b_out (Vp) with pad lanes -1e30; pre_z (B,3H) =
//   z @ w_z + b_ih; h1_0 (B,H); scratch h1_buf, h2_buf (2,B,H) and
//   keys (B) uint64; tokens_out (steps,B) int32.
// Enqueue 3 x steps + 1 launches on `stream`; return the first launch
// error (0 = cudaSuccess).
extern "C" int fader_greedy_decode(int B, int H, int V, int Vp, int steps,
                                   const float* w_tok, const float* w_hh1,
                                   const float* b_hh1, const float* w_ih2,
                                   const float* b_ih2, const float* w_hh2,
                                   const float* b_hh2, const float* w_out,
                                   const float* b_out, const float* pre_z,
                                   const float* h1_0, float* h1_buf,
                                   float* h2_buf, void* keys, int* tokens_out,
                                   void* stream) {
  return fader::decode(B, H, V, Vp, steps, w_tok, w_hh1, b_hh1, w_ih2, b_ih2,
                       w_hh2, b_hh2, w_out, b_out, pre_z, h1_0, nullptr,
                       nullptr, h1_buf, h2_buf,
                       static_cast<unsigned long long*>(keys), tokens_out,
                       static_cast<cudaStream_t>(stream));
}

// As fader_greedy_decode, plus noise (steps,B,Vp) Gumbel noise and
// inv_t (B) per-row inverse temperature.
extern "C" int fader_sample_decode(int B, int H, int V, int Vp, int steps,
                                   const float* w_tok, const float* w_hh1,
                                   const float* b_hh1, const float* w_ih2,
                                   const float* b_ih2, const float* w_hh2,
                                   const float* b_hh2, const float* w_out,
                                   const float* b_out, const float* pre_z,
                                   const float* h1_0, const float* noise,
                                   const float* inv_t, float* h1_buf,
                                   float* h2_buf, void* keys, int* tokens_out,
                                   void* stream) {
  return fader::decode(B, H, V, Vp, steps, w_tok, w_hh1, b_hh1, w_ih2, b_ih2,
                       w_hh2, b_hh2, w_out, b_out, pre_z, h1_0, noise, inv_t,
                       h1_buf, h2_buf, static_cast<unsigned long long*>(keys),
                       tokens_out, static_cast<cudaStream_t>(stream));
}
