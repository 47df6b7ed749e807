// Embedded-id GRU, forward: L stacked GRU directions over integer ids whose
// input projection is a row gather, as entries of the persistent forward
// chain (gru_fwd_chain.cu).
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_fwd_embed_kernel :428
// (stacked_gru_embed_finals: the serving variant, finals only, entry
// fader_embed_gru_finals; and the training variant with the gate stash,
// entry fader_embed_gru_train) and ::_fwd_embed_seq_kernel :779
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
// the 67 TFLOP/s float32 peak; training at B=128 twice that. Every h_{t+1}
// unit needs all of h_t, a device-wide dependency each step.
//
// Design: each entry is one cooperative launch of gru_fwd_chain for all T
// steps (plus the memset that zeroes its barrier counters), in the chain's
// gathered mode: ids + the table w_in (L, V, 3H) + `add` (b_ih, or the
// sub-decoders' per-sequence prez with add_bs = 3H). A block keeps its 32
// units' r/z/n columns of w_hh in shared memory for the whole call and
// meets the other blocks of its row tile at a counter barrier a step. The
// serving entry writes only the finals (the TPU kernel wrote h_seq and its
// caller kept [:, -1]); the training entry h_seq and, when a gradient is
// wanted, the gate stash the backward chain reads.
//
// The _bf16 entries take every tensor but the ids and the scratch in bf16
// (the mixed-precision objectives of the JAX package): the chain widens on
// load, runs the carry and the gates in float32 and rounds the finals,
// h_seq and the stash where it stores them (gru_fwd_chain.cu). The gather
// adds the widened table row and the widened b_ih (or prez) in float32,
// never rounded, as the one-hot product plus bias of the Pallas kernel
// does (pallas_gru.py:416-425).
#include "gru_tile.cuh"
#include "train_ops.cuh"

extern "C" long long fader_gru_fwd_scratch_floats(int L, int B, int H);

extern "C" const char* fader_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

template <typename S>
int embed_gru_finals_impl(int L, int T, int B, int H, int Vp, const int* tok,
                          const S* w_ih, const S* b_ih, const S* w_hh,
                          const S* b_hh, const S* h0, S* finals,
                          float* scratch, long long scratch_floats,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0)
    return (int)cudaMemcpyAsync(finals, h0, (size_t)L * B * H * sizeof(S),
                                cudaMemcpyDeviceToDevice, s);
  if (scratch_floats < fader_gru_fwd_scratch_floats(L, B, H))
    return (int)cudaErrorInvalidValue;
  return (int)fader::launch_gru_fwd_chain<S, S>(
      L, T, B, H, tok, w_ih, Vp, b_ih, 3LL * H, 0, w_hh, b_hh, h0, nullptr,
      finals, nullptr, scratch, s);
}

template <typename S>
int embed_gru_train_impl(int L, int T, int B, int H, int V, int add_bs,
                         const int* ids, const S* w_in, const S* add,
                         const S* w_hh, const S* b_hh, const S* h0, S* h_seq,
                         S* stash, float* scratch, long long scratch_floats,
                         void* stream) {
  if (scratch_floats < fader_gru_fwd_scratch_floats(L, B, H))
    return (int)cudaErrorInvalidValue;
  const long long G = 3LL * H;
  return (int)fader::launch_gru_fwd_chain<S, S>(
      L, T, B, H, ids, w_in, V, add, add_bs ? (long long)B * G : G, add_bs,
      w_hh, b_hh, h0, h_seq, nullptr, stash, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// tok (L,T,B) int32; w_ih (L,Vp,3H); b_ih (L,3H); w_hh (L,H,3H); b_hh (L,3H);
// h0 (L,B,H); finals (L,B,H) out. Scratch: scratch_floats >=
// fader_gru_fwd_scratch_floats(L,B,H) floats. All contiguous, float32, on
// one device. One cooperative launch whatever T is (T = 0 copies h0); a
// launch the device refuses returns its error (0 = cudaSuccess).
extern "C" int fader_embed_gru_finals(int L, int T, int B, int H, int Vp,
                                      const int* tok, const float* w_ih,
                                      const float* b_ih, const float* w_hh,
                                      const float* b_hh, const float* h0,
                                      float* finals, float* scratch,
                                      long long scratch_floats,
                                      void* stream) {
  return embed_gru_finals_impl<float>(L, T, B, H, Vp, tok, w_ih, b_ih, w_hh,
                                      b_hh, h0, finals, scratch,
                                      scratch_floats, stream);
}

// As fader_embed_gru_finals with bf16 tensors (finals rounded to bf16).
extern "C" int fader_embed_gru_finals_bf16(
    int L, int T, int B, int H, int Vp, const int* tok,
    const fader::bf16* w_ih, const fader::bf16* b_ih,
    const fader::bf16* w_hh, const fader::bf16* b_hh, const fader::bf16* h0,
    fader::bf16* finals, float* scratch, long long scratch_floats,
    void* stream) {
  return embed_gru_finals_impl<fader::bf16>(L, T, B, H, Vp, tok, w_ih, b_ih,
                                            w_hh, b_hh, h0, finals, scratch,
                                            scratch_floats, stream);
}

// The training forward (and the sub-decoders' forward, with or without a
// gradient): ids (L,T,B) int32; w_in (L,V,3H); add (L,3H) with add_bs = 0
// or (L,B,3H) with add_bs = 3H; w_hh (L,H,3H); b_hh (L,3H); h0 (L,B,H);
// h_seq (L,T,B,H) out; stash (L,T,B,4H) out, or null. Scratch as
// fader_embed_gru_finals. One cooperative launch whatever T is; T >= 1.
extern "C" int fader_embed_gru_train(int L, int T, int B, int H, int V,
                                     int add_bs, const int* ids,
                                     const float* w_in, const float* add,
                                     const float* w_hh, const float* b_hh,
                                     const float* h0, float* h_seq,
                                     float* stash, float* scratch,
                                     long long scratch_floats, void* stream) {
  return embed_gru_train_impl<float>(L, T, B, H, V, add_bs, ids, w_in, add,
                                     w_hh, b_hh, h0, h_seq, stash, scratch,
                                     scratch_floats, stream);
}

// As fader_embed_gru_train with bf16 tensors (h_seq and stash bf16).
extern "C" int fader_embed_gru_train_bf16(
    int L, int T, int B, int H, int V, int add_bs, const int* ids,
    const fader::bf16* w_in, const fader::bf16* add,
    const fader::bf16* w_hh, const fader::bf16* b_hh, const fader::bf16* h0,
    fader::bf16* h_seq, fader::bf16* stash, float* scratch,
    long long scratch_floats, void* stream) {
  return embed_gru_train_impl<fader::bf16>(L, T, B, H, V, add_bs, ids, w_in,
                                           add, w_hh, b_hh, h0, h_seq, stash,
                                           scratch, scratch_floats, stream);
}
