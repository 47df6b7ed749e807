// The training step's global-norm clip (optax.clip_by_global_norm) over
// every gradient leaf in two launches.
//
// Replaces no TPU kernel: the JAX package's clip is XLA's fusion of optax's
// rule inside the compiled step. The port ran it as about eight torch ops a
// leaf (43 leaves in the GM-VAE, 21 in the CVAE), so the host's launches
// paced the step while the card's work behind them is one read of the
// gradients and, when the norm is at or above max_norm, one read and one
// write more.
//
// What bounds it on an H100: bytes. The GM-VAE's 12,172,905 floats are
// 48.7 MB read (14.5 us at 3.35 TB/s) for the norm, and 97.4 MB more (29 us)
// when they are scaled.
//
// Design: a table of (base pointer, element count, float4 flag) for every
// leaf with the prefix offsets of the leaves padded to 4 floats is a
// kernel parameter (`__grid_constant__`, 3.1 KB of the 4 KB parameter
// space for 96 leaves): nothing is copied to the device and nothing waits.
// The wrapper builds it anew every call (autograd allocates the gradients
// anew every step) and splits a tree of more leaves into more tables, each
// taking one launch of each kernel. Each block of `clip_sumsq` takes a
// fixed range of the padded concatenation (a multiple of 4 floats), reads
// it with float4 loads where the leaf's base is 16-byte aligned and scalar
// loads for a leaf's tail and for unaligned bases, keeps a thread's sum of
// squares in float32, reduces the block in a fixed tree order and writes
// one partial. Each block of `clip_scale` sums every partial in double in
// one fixed order (warp 0: lane i the partials i, i + 32, ...; then a
// butterfly), takes the square root and rounds it to float32, as the
// reference does (h100bench/reference/common.py::clip_global_norm). Block 0
// of the first table stores the norm. Below max_norm every block returns
// without touching a gradient (optax leaves them unchanged); otherwise each
// element becomes g / norm * max_norm in place, a divide and then a
// multiply, so given the same norm its bits are those of the torch ops'
// `where` branch. The grid, 8 blocks of 256 threads an SM at most, depends
// on the tree's sizes only: repeats give the same bits.

#include <cuda_runtime.h>

namespace fader {

constexpr int kClipLeaves = 96;
constexpr int kClipThreads = 256;

// The wrapper's table (music_fader_nets_tpu_torch/ops/cuda_clip.py::
// leaf_tables), 64-bit words only, in this order.
struct ClipTable {
  long long n;          // leaves in this table
  long long blocks;     // blocks of each launch
  long long chunk;      // padded floats a block takes, a multiple of 4
  long long part_base;  // this table's first partial
  long long offset[kClipLeaves + 1];  // prefix of the leaves' padded sizes
  long long numel[kClipLeaves];
  long long ptr[kClipLeaves];         // device addresses
  long long vec[kClipLeaves];         // 1: base 16-byte aligned
};
static_assert(sizeof(ClipTable) == 8 * (5 + 4 * kClipLeaves),
              "ClipTable must be 64-bit words without padding");
static_assert(sizeof(ClipTable) + 64 <= 4096,
              "ClipTable and the other arguments must fit the parameters");

// The first leaf whose padded range ends after `pos` (n >= 1).
__device__ __forceinline__ int first_leaf(const ClipTable& t, long long pos) {
  int lo = 0, hi = static_cast<int>(t.n) - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (t.offset[mid + 1] <= pos) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Calls op.vec4(float4*) or op.one(float*) on every float of this block's
// range of the table, a thread taking every blockDim-th group of 4.
template <class Op>
__device__ __forceinline__ void walk(const ClipTable& t, Op& op) {
  const long long total = t.offset[t.n];
  const long long start = static_cast<long long>(blockIdx.x) * t.chunk;
  const long long stop = start + t.chunk < total ? start + t.chunk : total;
  if (t.n == 0 || start >= stop) return;
  for (int l = first_leaf(t, start); l < t.n && t.offset[l] < stop; ++l) {
    const long long base = t.offset[l];
    const long long lo = (start > base ? start : base) - base;
    const long long hi =
        (stop < t.offset[l + 1] ? stop : t.offset[l + 1]) - base;
    float* p = reinterpret_cast<float*>(t.ptr[l]);
    const long long numel = t.numel[l];
    const bool vec = t.vec[l] != 0;
    for (long long i = lo + 4LL * threadIdx.x; i < hi;
         i += 4LL * blockDim.x) {
      if (vec && i + 4 <= numel) {
        op.vec4(reinterpret_cast<float4*>(p + i));
      } else {
        for (int k = 0; k < 4 && i + k < numel; ++k) op.one(p + i + k);
      }
    }
  }
}

struct SumSq {
  float acc = 0.f;
  __device__ __forceinline__ void vec4(const float4* q) {
    const float4 v = *q;
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
  __device__ __forceinline__ void one(const float* q) {
    const float v = *q;
    acc = fmaf(v, v, acc);
  }
};

struct Scale {
  float norm, max_norm;
  __device__ __forceinline__ float f(float g) const {
    return g / norm * max_norm;
  }
  __device__ __forceinline__ void vec4(float4* q) {
    float4 v = *q;
    v.x = f(v.x);
    v.y = f(v.y);
    v.z = f(v.z);
    v.w = f(v.w);
    *q = v;
  }
  __device__ __forceinline__ void one(float* q) { *q = f(*q); }
};

__global__ void __launch_bounds__(kClipThreads)
    clip_sumsq_kernel(const __grid_constant__ ClipTable t,
                      float* __restrict__ partials) {
  __shared__ float warp_sums[kClipThreads / 32];
  SumSq op;
  walk(t, op);
  float s = op.acc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kClipThreads / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) partials[t.part_base + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kClipThreads)
    clip_scale_kernel(const __grid_constant__ ClipTable t,
                      const float* __restrict__ partials, int n_partials,
                      float max_norm, float* __restrict__ norm_out) {
  __shared__ float norm_s;
  if (threadIdx.x < 32) {
    double s = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += 32)
      s += static_cast<double>(partials[i]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) {
      norm_s = static_cast<float>(sqrt(s));
      if (t.part_base == 0 && blockIdx.x == 0) *norm_out = norm_s;
    }
  }
  __syncthreads();
  const float norm = norm_s;
  if (norm < max_norm) return;  // optax: unchanged below max_norm
  Scale op{norm, max_norm};
  walk(t, op);
}

}  // namespace fader

// The clip of the leaves of `n_tables` consecutive ClipTables (`words`
// 64-bit words each, checked against this build's layout): the partials
// of every table, then the norm and the scale of every table. `partials`
// holds the tables' blocks, `n_partials` of them.
extern "C" int fader_clip_global_norm(int n_tables, const long long* tables,
                                      int words, float* partials,
                                      int n_partials, float max_norm,
                                      float* norm, void* stream) {
  if (words != static_cast<int>(sizeof(fader::ClipTable) / 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tb = reinterpret_cast<const fader::ClipTable*>(tables);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_tables; ++i) {
    fader::clip_sumsq_kernel<<<static_cast<unsigned>(tb[i].blocks),
                               fader::kClipThreads, 0, s>>>(tb[i], partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = 0; i < n_tables; ++i) {
    fader::clip_scale_kernel<<<static_cast<unsigned>(tb[i].blocks),
                               fader::kClipThreads, 0, s>>>(
        tb[i], partials, n_partials, max_norm, norm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
