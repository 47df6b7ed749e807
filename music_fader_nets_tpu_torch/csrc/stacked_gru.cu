// Generic stacked GRU over precomputed input projections, forward and
// backward.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_fwd_kernel (:147, the
// forward of stacked_gru_pallas :333; entry fader_stacked_gru) and
// ::_bwd_kernel (:238, its backward; entry fader_stacked_gru_bwd).
//
// What it computes, for each direction l < L and step t < T:
//   h' = gates(pre[l, t], h @ w_hh[l] + b_hh[l], h)   (r, z, n as ops/gru.py)
// writing h_seq[l, t] and, when a gradient is wanted, the gate stash
// [r, z, n, hn_h] (L, T, B, 4H). The backward walks t from T-1 down to 0
// with dh = 0:
//   dh += g_seq[l, t] ; (dpre[l, t], dpre_h) = gate_bwd(dh, stash, h_prev)
//   dh  = dh * z + dpre_h @ w_hh[l]^T
// then dW_hh = h_prev^T dpre_h and db_hh = sum of dpre_h over all T*B rows,
// and dh0 = dh.
//
// What bounds it on an H100: float32 FMA. At the CVAE encoder's shape (L=2,
// T=100, B=128, H=512) the forward is 2 L T B H 3H = 40.3 GFLOP, 0.60 ms at
// 67 TFLOP/s; the backward twice that, 1.20 ms (the dh chain's
// dpre_h @ w_hh^T and the dW_hh GEMM; the gate stash spares it the
// h @ w_hh recompute).
// pre and dpre (157 MB each there) are read and written once.
//
// Design: the forward is gru_fwd_chain.cu's persistent kernel with its
// input rows read from pre in place of a gather: one cooperative launch
// for all T steps, a block owning (direction, 32 hidden units, a row tile)
// with its units' r/z/n columns of w_hh resident in shared memory, a
// barrier a step among the blocks of a row tile. The backward chain is
// embed_gru_bwd.cu's persistent kernel (one cooperative launch for all T
// steps, the block's w_hh^T columns resident in shared memory), taking the
// cotangent g_seq[l, t] on every step; its input-projection cotangent is
// the output dpre. dW_hh and db_hh are grad_reduce.cu's split-K GEMM and
// chunked column sums (deterministic, no float atomics).
//
// The _bf16 entries are the mixed-precision variants (the JAX package's
// bf16 objectives hand kernels 1/2 bf16 operands): pre, w_hh, b_hh, h0, the
// h_seq output and the stash in bf16, the carry and every product and sum
// float32 (gru_fwd_chain.cu, embed_gru_bwd.cu); the backward's g, dpre and
// gradients are float32, rounded to bf16 by the caller where the Pallas
// kernel returns the input's dtype.
#include "gru_tile.cuh"
#include "train_ops.cuh"

extern "C" long long fader_gru_fwd_scratch_floats(int L, int B, int H);
extern "C" long long fader_gru_bwd_scratch_floats(int L, int T, int B, int H);

namespace {

template <typename S>
int stacked_gru_impl(int L, int T, int B, int H, const S* pre, const S* w_hh,
                     const S* b_hh, const S* h0, S* h_seq, S* stash,
                     float* scratch, long long scratch_floats,
                     void* stream) {
  if (scratch_floats < fader_gru_fwd_scratch_floats(L, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::launch_gru_fwd_chain<S, S>(
      L, T, B, H, nullptr, pre, 0, nullptr, 0, 0, w_hh, b_hh, h0, h_seq,
      nullptr, stash, scratch, static_cast<cudaStream_t>(stream));
}

template <typename S>
int stacked_gru_bwd_impl(int L, int T, int B, int H, const float* g,
                         const S* stash, const S* h_seq, const S* h0,
                         const S* w_hhT, float* dph, float* dpre,
                         float* dw_hh, float* db_hh, float* dh0,
                         float* scratch, long long scratch_floats,
                         void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < fader_gru_bwd_scratch_floats(L, T, B, H))
    return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H, G = 3LL * H;
  cudaError_t err =
      launch_gru_bwd_chain<S>(L, T, B, H, g, T * BH, BH, 1, stash, h_seq, h0,
                              w_hhT, dpre, dph, dh0, scratch, s);
  if (err != cudaSuccess) return (int)err;
  float* red = scratch + chain_scratch_floats(L, B, H);
  const int R = T * B;
  const SplitRowsT<S> h_prev{h0, BH, B, h_seq, T * BH, H};
  if ((err = gemm_tn(L, H, (int)G, R, h_prev, dph, R * G, dw_hh, H * G, red,
                     s)) != cudaSuccess)
    return (int)err;
  return (int)colsum(L, R, (int)G, dph, db_hh, red, s);
}

}  // namespace

// pre (L,T,B,3H) the input projections (b_ih included, reversed directions
// already time-flipped); w_hh (L,H,3H); b_hh (L,3H); h0 (L,B,H). Outputs:
// h_seq (L,T,B,H); stash (L,T,B,4H) or null (no gradient wanted). Scratch:
// scratch_floats >= fader_gru_fwd_scratch_floats(L,B,H) floats. All
// contiguous float32 on one device. One cooperative launch whatever T is;
// a launch the device refuses returns its error. T >= 1.
extern "C" int fader_stacked_gru(int L, int T, int B, int H, const float* pre,
                                 const float* w_hh, const float* b_hh,
                                 const float* h0, float* h_seq, float* stash,
                                 float* scratch, long long scratch_floats,
                                 void* stream) {
  return stacked_gru_impl<float>(L, T, B, H, pre, w_hh, b_hh, h0, h_seq,
                                 stash, scratch, scratch_floats, stream);
}

// As fader_stacked_gru with every tensor bf16 (the scratch float32).
extern "C" int fader_stacked_gru_bf16(
    int L, int T, int B, int H, const fader::bf16* pre,
    const fader::bf16* w_hh, const fader::bf16* b_hh, const fader::bf16* h0,
    fader::bf16* h_seq, fader::bf16* stash, float* scratch,
    long long scratch_floats, void* stream) {
  return stacked_gru_impl<fader::bf16>(L, T, B, H, pre, w_hh, b_hh, h0,
                                       h_seq, stash, scratch, scratch_floats,
                                       stream);
}

// g (L,T,B,H) the cotangent of h_seq; stash, h_seq from the forward; h0
// (L,B,H); w_hhT (L,3H,H). Scratch: dph (L,T,B,3H); scratch_floats >=
// fader_gru_bwd_scratch_floats(L,T,B,H). Outputs: dpre (L,T,B,3H), dw_hh
// (L,H,3H), db_hh (L,3H), dh0 (L,B,H). T >= 1.
extern "C" int fader_stacked_gru_bwd(int L, int T, int B, int H,
                                     const float* g, const float* stash,
                                     const float* h_seq, const float* h0,
                                     const float* w_hhT, float* dph,
                                     float* dpre, float* dw_hh, float* db_hh,
                                     float* dh0, float* scratch,
                                     long long scratch_floats, void* stream) {
  return stacked_gru_bwd_impl<float>(L, T, B, H, g, stash, h_seq, h0, w_hhT,
                                     dph, dpre, dw_hh, db_hh, dh0, scratch,
                                     scratch_floats, stream);
}

// As fader_stacked_gru_bwd with bf16 stash, h_seq, h0 and w_hhT; g, the
// scratch and every output float32.
extern "C" int fader_stacked_gru_bwd_bf16(
    int L, int T, int B, int H, const float* g, const fader::bf16* stash,
    const fader::bf16* h_seq, const fader::bf16* h0,
    const fader::bf16* w_hhT, float* dph, float* dpre, float* dw_hh,
    float* db_hh, float* dh0, float* scratch, long long scratch_floats,
    void* stream) {
  return stacked_gru_bwd_impl<fader::bf16>(L, T, B, H, g, stash, h_seq, h0,
                                           w_hhT, dph, dpre, dw_hh, db_hh,
                                           dh0, scratch, scratch_floats,
                                           stream);
}
