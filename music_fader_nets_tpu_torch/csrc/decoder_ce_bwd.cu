// Teacher-forced 2-layer GRU decoder, backward: without a head, with the
// cross-entropy head and with the masses head.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_dec_bwd_kernel :1304
// (the backward of decoder_teacher_fused :2269, from the cotangent of
// h2_seq, through the shared chain _dec_bwd_chain :1222; entry
// fader_decoder_teacher_bwd) and ::_dec_bwd_ce_kernel :1627 with head="ce"
// (the backward of decoder_teacher_fused_nll, through _dec_nll_core and the
// same chain; entry fader_decoder_ce_bwd) and with head = vocabulary ranges
// (the backward of decoder_teacher_fused_masses, through _dec_mask_core;
// entry fader_decoder_masses_bwd).
//
// What it computes, from the head's cotangent g (NLL: (T, B); masses:
// (T, K, B); no head: dh2_head = g (T, B, H) itself) and the forward's
// h1_seq, h2_seq and gate stashes g41, g42:
//   head   : CE:     dlogits = (softmax(h2 @ w_out + b_out) - onehot(tgt)) g
//            masses: dlogits = p * sum_k g_k (1[j in range k] - m_k)
//                    (pallas_gru.py:1672-1681)
//            dh2_head = dlogits @ w_out^T ; dW_out, db_out from dlogits
//   chains, t from T-1 down to 0 (dh1 = dh2 = 0):
//     layer 2: dh2 += dh2_head[t] ; (dpre2x, dpre2h) = gate_bwd(dh2, g42[t],
//              h2p(t)) ; dh2 = dh2 * z2 + dpre2h @ w_hh2^T
//     dh1 += dpre2x @ w_ih2^T, and at t = 0 also the layer-2 dh2 (its
//              h2p(0) was h1' : the reference's step-0 rule)
//     layer 1: (dpre1x, dpre1h) = gate_bwd(dh1, g41[t], h1_prev(t)) ;
//              dh1 = dh1 * z1 + dpre1h @ w_hh1^T
//   weights: dW_tok[v] = sum of dpre1x over rows whose input token is v
//            (with n_rep copies sharing B0 = B/n_rep token rows, dpre1x is
//            first folded over the copies, pallas_gru.py:1692-1701: each
//            token row's sum is then the same terms in another order);
//            dpre_z[b] = sum_t dpre1x[t, b]; dW_hh1 = h1_prev^T dpre1h;
//            dW_ih2 = h1_seq^T dpre2x; dW_hh2 = h2p^T dpre2h; the biases
//            are the column sums; dh1_0 = dh1.
//
// What bounds it on an H100: float32 FMA, ~2x the forward's 65 GFLOP
// (the chains' dh products, the weight-gradient GEMMs and the head's logits
// and dh2_head), ~2 ms at 67 TFLOP/s at T=100, B=128; the masses head at
// 512 rows 544 GFLOP, 8.1 ms; without a head 2 x 60.4 GFLOP, 1.8 ms.
//
// Design: a fixed number of launches, whatever T is. The reference's chain
// interleaves the layers a step at a time, but layer 2's recurrence never
// reads layer 1, and layer 1 takes layer 2 only through an additive
// cotangent a step, inject[t] = dpre2x[t] @ w_ih2^T (+ the dh2 that leaves
// step 0, at t = 0). So the backward is three parts (decoder_bwd_from_dh2):
// (1) layer 2's chain alone, the persistent cooperative kernel of
// embed_gru_bwd.cu (gru_bwd_chain) at L = 1 with dh2_head as its cotangent
// every step; (2) inject for all T steps as one (T*B) x 3H by 3H x H
// product (grad_reduce.cu's gemm_nn, the step-0 term added in its
// epilogue); (3) layer 1's chain, the same kernel with inject as its
// cotangent every step. Each chain keeps its layer's w_hh^T columns resident
// in shared memory for all T steps, so no block holds two layers' weights.
// The head runs first and batched over all T*B rows (ce_head or mass_head
// in decoder_ce.cu writes dlogits, then gemm_nn gives dh2_head for every
// step; decoder_bwd_from_dlogits); without a head the cotangent of h2_seq
// is dh2_head as it stands. The chains stash their dpre rows, and
// grad_reduce.cu turns them into the weight gradients with deterministic
// GEMMs (split-K through scratch), scatter and sums.
//
// bf16 storage (the CE entry, fader_decoder_ce_bwd_bf16): h1_seq, h2_seq,
// the stashes, h1_0 and the weights are bf16 and widened where they are
// read; the head recomputes its logits from the bf16 h2_seq (as the Pallas
// backward does from its h2 residual, pallas_gru.py:1652-1664), and
// dlogits, dh2_head, inject, the dpre rows, the chains' dh and every
// gradient stay float32; the caller rounds the gradients to bf16
// (:1822-1828). Every product runs on the tensor cores (mma_bf16.cuh): the
// logits of two bf16 operands on one MMA (ce_head_tc), and the products of
// a float32 operand with a bf16 one on three, the float32 one split into
// three bf16 pieces: dh2_head = dlogits w_out^T and inject = dpre2x
// w_ih2^T (gemm_nn), the chains' dh products (gru_bwd_chain) and the
// weight gradients (gemm_tn), as the Pallas kernel's dots keep that
// operand float32 (:1682-1684).
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

namespace {

// The scratch of a backward call, in floats, each part 16-byte aligned: the
// chain's barrier counters and k-major rows (used by both chains in turn),
// dh2_0 (B, H), inject (T, B, H), then the reductions' partials.
long long up4(long long n) { return (n + 3) / 4 * 4; }

long long dh2_0_at(int B, int H) { return up4(chain_scratch_floats(1, B, H)); }

long long inject_at(int B, int H) {
  return dh2_0_at(B, H) + up4((long long)B * H);
}

long long red_at(int T, int B, int H) {
  return inject_at(B, H) + up4((long long)T * B * H);
}

}  // namespace

// The two chains and the recurrence's weight gradients, from dh2_head
// (T, B, H), the cotangent of h2_seq. tok (T, B/n_rep) are the input ids of
// the B/n_rep distinct sequences; fold (T, B/n_rep, 3H) is scratch when
// n_rep > 1 (else unused); scratch as laid out above. S: the storage type
// of the forward's outputs, h1_0 and the weights.
template <typename S>
cudaError_t decoder_bwd_from_dh2(
    int T, int B, int H, int Vp, int n_rep, const int* tok, const S* h1_seq,
    const S* h2_seq, const S* g41, const S* g42, const S* h1_0,
    const S* w_hh1T, const S* w_ih2T, const S* w_hh2T, const float* dh2_head,
    float* s1x, float* s1h, float* s2x, float* s2h, float* fold,
    float* dw_tok, float* dpre_z, float* dw_hh1, float* db_hh1,
    float* dw_ih2, float* db_ih2, float* dw_hh2, float* db_hh2,
    float* dh1_0, float* scratch, cudaStream_t s) {
  const long long BH = (long long)B * H, G = 3LL * H;
  const int R = T * B;
  float* chain = scratch;
  float* dh2_0 = scratch + dh2_0_at(B, H);
  float* inject = scratch + inject_at(B, H);
  float* red = scratch + red_at(T, B, H);
  cudaError_t err;
  // (1) layer 2, h2p(0) = h1_seq[0]; dh2_0 is the dh2 that leaves step 0
  if ((err = launch_gru_bwd_chain<S>(1, T, B, H, dh2_head, 0, BH, 1, g42,
                                     h2_seq, h1_seq, w_hh2T, s2x, s2h, dh2_0,
                                     chain, s)) != cudaSuccess ||
      // (2) inject = dpre2x @ w_ih2^T, + dh2_0 on step 0's B rows
      (err = gemm_nn(R, H, (int)G, s2x, w_ih2T, inject, dh2_0, B, s)) !=
          cudaSuccess ||
      // (3) layer 1, h1p(0) = h1_0
      (err = launch_gru_bwd_chain<S>(1, T, B, H, inject, 0, BH, 1, g41,
                                     h1_seq, h1_0, w_hh1T, s1x, s1h, dh1_0,
                                     chain, s)) != cudaSuccess)
    return err;
  // dW_tok: with n_rep copies, fold dpre1x over them first (sum_over_t
  // over the copy axis of s1x viewed as (T, n_rep, B0 * 3H)), then scatter
  // the T * B0 folded rows by their token
  const int B0 = B / n_rep;
  const float* tok_rows = s1x;
  if (n_rep > 1) {
    if ((err = sum_over_t(T, n_rep, (int)(B0 * G), s1x, fold, s)) !=
        cudaSuccess)
      return err;
    tok_rows = fold;
  }
  const SplitRowsT<S> h1prev{h1_0, 0, B, h1_seq, 0, H};
  const SplitRowsT<S> h1cur{nullptr, 0, 0, h1_seq, 0, H};
  const SplitRowsT<S> h2prev{h1_seq, 0, B, h2_seq, 0, H};
  if ((err = segment_rows(1, T * B0, (int)G, Vp, tok, tok_rows, dw_tok, s)) ||
      (err = sum_over_t(1, T, (int)(B * G), s1x, dpre_z, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1prev, s1h, 0, dw_hh1, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s1h, db_hh1, red, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1cur, s2x, 0, dw_ih2, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s2x, db_ih2, red, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h2prev, s2h, 0, dw_hh2, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s2h, db_hh2, red, s)))
    return err;
  return cudaSuccess;
}

// Everything after a head, from its dlogits (T*B, Vp): dh2_head = dlogits @
// w_out^T, the shared chains and gradients, and the head's own dW_out,
// db_out.
template <typename S>
cudaError_t decoder_bwd_from_dlogits(
    int T, int B, int H, int Vp, int n_rep, const int* tok, const S* h1_seq,
    const S* h2_seq, const S* g41, const S* g42, const S* h1_0,
    const S* w_hh1T, const S* w_ih2T, const S* w_hh2T, const S* w_outT,
    float* dlogits, float* dh2_head, float* s1x, float* s1h, float* s2x,
    float* s2h, float* fold, float* dw_tok, float* dpre_z, float* dw_hh1,
    float* db_hh1, float* dw_ih2, float* db_ih2, float* dw_hh2,
    float* db_hh2, float* dh1_0, float* dw_out, float* db_out,
    float* scratch, cudaStream_t s) {
  const int R = T * B;
  cudaError_t err;
  if ((err = gemm_nn(R, H, Vp, dlogits, w_outT, dh2_head, nullptr, 0, s)) !=
      cudaSuccess)
    return err;
  err = decoder_bwd_from_dh2(T, B, H, Vp, n_rep, tok, h1_seq, h2_seq, g41,
                             g42, h1_0, w_hh1T, w_ih2T, w_hh2T, dh2_head,
                             s1x, s1h, s2x, s2h, fold, dw_tok, dpre_z,
                             dw_hh1, db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2,
                             dh1_0, scratch, s);
  if (err != cudaSuccess) return err;
  float* red = scratch + red_at(T, B, H);
  const SplitRowsT<S> h2cur{nullptr, 0, 0, h2_seq, 0, H};
  if ((err = gemm_tn(1, H, Vp, R, h2cur, dlogits, 0, dw_out, 0, red, s)) ||
      (err = colsum(1, R, Vp, dlogits, db_out, red, s)))
    return err;
  return cudaSuccess;
}

}  // namespace fader

// Floats of scratch the three backward entries need at these sizes on the
// current device: the chains' barrier counters and k-major rows, dh2_0, the
// cross-layer cotangent inject (T, B, H), then the split-K partial tiles of
// the weight-gradient GEMMs ((H, 3H) and, with a head, (H, Vp), over T*B
// rows) and the column sums' partials, one after the other through the
// same buffer.
extern "C" long long fader_decoder_bwd_scratch_floats(int T, int B, int H,
                                                      int Vp) {
  const long long a = fader::reduce_scratch_floats(1, H, 3 * H, T * B);
  const long long b = fader::reduce_scratch_floats(1, H, Vp, T * B);
  return fader::red_at(T, B, H) + (a > b ? a : b);
}

// The arguments common to the entries, after their head's own: h1_seq,
// h2_seq (T,B,H), g41, g42 (T,B,4H) from the forward; h1_0 (B,H); w_hh1T,
// w_ih2T, w_hh2T (3H,H) the transposed weights; w_out (H,Vp), b_out (Vp),
// w_outT (Vp,H). Scratch: dlogits (T,B,Vp); dh2_head (T,B,H); s1x, s1h,
// s2x, s2h (T,B,3H); after the outputs, scratch with scratch_floats >=
// fader_decoder_bwd_scratch_floats(T,B,H,Vp) floats. Outputs:
// dw_tok (Vp,3H); dpre_z (B,3H); dw_hh1, dw_ih2, dw_hh2 (H,3H); db_hh1,
// db_ih2, db_hh2 (3H); dh1_0 (B,H); dw_out (H,Vp); db_out (Vp). T >= 1.
// A fixed number of launches whatever T is; a cooperative
// launch the device refuses returns its error.
//
// CE head: tok, tgt (T,B) int32; g (T,B) the NLL cotangent.
extern "C" int fader_decoder_ce_bwd(
    int T, int B, int H, int Vp, const int* tok, const int* tgt,
    const float* g, const float* h1_seq, const float* h2_seq,
    const float* g41, const float* g42, const float* h1_0,
    const float* w_hh1T, const float* w_ih2T, const float* w_hh2T,
    const float* w_out, const float* b_out, const float* w_outT,
    float* dlogits, float* dh2_head, float* s1x, float* s1h, float* s2x,
    float* s2h, float* dw_tok, float* dpre_z, float* dw_hh1, float* db_hh1,
    float* dw_ih2, float* db_ih2, float* dw_hh2, float* db_hh2,
    float* dh1_0, float* dw_out, float* db_out, float* scratch,
    long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ce_head(T * B, H, Vp, h2_seq, w_out, b_out, tgt,
                                   g, nullptr, dlogits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)decoder_bwd_from_dlogits(
      T, B, H, Vp, 1, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T, w_ih2T,
      w_hh2T, w_outT, dlogits, dh2_head, s1x, s1h, s2x, s2h, nullptr, dw_tok,
      dpre_z, dw_hh1, db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0, dw_out,
      db_out, scratch, s);
}

// As fader_decoder_ce_bwd with bf16 h1_seq, h2_seq, g41, g42, h1_0 and
// weights (w_hh1T, w_ih2T, w_hh2T, w_out, b_out, w_outT); g, the scratch and
// every output float32.
extern "C" int fader_decoder_ce_bwd_bf16(
    int T, int B, int H, int Vp, const int* tok, const int* tgt,
    const float* g, const fader::bf16* h1_seq, const fader::bf16* h2_seq,
    const fader::bf16* g41, const fader::bf16* g42, const fader::bf16* h1_0,
    const fader::bf16* w_hh1T, const fader::bf16* w_ih2T,
    const fader::bf16* w_hh2T, const fader::bf16* w_out,
    const fader::bf16* b_out, const fader::bf16* w_outT, float* dlogits,
    float* dh2_head, float* s1x, float* s1h, float* s2x, float* s2h,
    float* dw_tok, float* dpre_z, float* dw_hh1, float* db_hh1,
    float* dw_ih2, float* db_ih2, float* dw_hh2, float* db_hh2,
    float* dh1_0, float* dw_out, float* db_out, float* scratch,
    long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ce_head(T * B, H, Vp, h2_seq, w_out, b_out, tgt,
                                   g, nullptr, dlogits, s, w_outT);
  if (err != cudaSuccess) return (int)err;
  return (int)decoder_bwd_from_dlogits<bf16>(
      T, B, H, Vp, 1, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T, w_ih2T,
      w_hh2T, w_outT, dlogits, dh2_head, s1x, s1h, s2x, s2h, nullptr, dw_tok,
      dpre_z, dw_hh1, db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0, dw_out,
      db_out, scratch, s);
}

// Masses head: K ranges as 2K ints in host memory; n_rep copies (B =
// n_rep * B0 rows); tok (T,B0) int32, the input ids of the B0 distinct
// sequences; g (T,K,B) the masses' cotangent; scratch fold (T,B0,3H) when
// n_rep > 1, else null.
extern "C" int fader_decoder_masses_bwd(
    int T, int B, int H, int Vp, int n_rep, int K, const int* ranges,
    const int* tok, const float* g, const float* h1_seq, const float* h2_seq,
    const float* g41, const float* g42, const float* h1_0,
    const float* w_hh1T, const float* w_ih2T, const float* w_hh2T,
    const float* w_out, const float* b_out, const float* w_outT,
    float* dlogits, float* dh2_head, float* s1x, float* s1h, float* s2x,
    float* s2h, float* fold, float* dw_tok, float* dpre_z, float* dw_hh1,
    float* db_hh1, float* dw_ih2, float* db_ih2, float* dw_hh2,
    float* db_hh2, float* dh1_0, float* dw_out, float* db_out,
    float* scratch, long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MassRanges rg;
  if (!make_ranges(K, ranges, &rg) || n_rep < 1 || B % n_rep != 0 ||
      (n_rep > 1 && fold == nullptr) ||
      scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_mass_head(T * B, B, H, Vp, rg, h2_seq, w_out,
                                     b_out, g, nullptr, dlogits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)decoder_bwd_from_dlogits(
      T, B, H, Vp, n_rep, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T,
      w_ih2T, w_hh2T, w_outT, dlogits, dh2_head, s1x, s1h, s2x, s2h, fold,
      dw_tok, dpre_z, dw_hh1, db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0,
      dw_out, db_out, scratch, s);
}

// No head (kernel 8): g2 (T,B,H) is the cotangent of h2_seq, read as
// dh2_head; tok (T,B) int32. No dlogits, dh2_head scratch, w_out or its
// gradients.
extern "C" int fader_decoder_teacher_bwd(
    int T, int B, int H, int Vp, const int* tok, const float* g2,
    const float* h1_seq, const float* h2_seq, const float* g41,
    const float* g42, const float* h1_0, const float* w_hh1T,
    const float* w_ih2T, const float* w_hh2T, float* s1x, float* s1h,
    float* s2x, float* s2h, float* dw_tok, float* dpre_z, float* dw_hh1,
    float* db_hh1, float* dw_ih2, float* db_ih2, float* dw_hh2,
    float* db_hh2, float* dh1_0, float* scratch, long long scratch_floats,
    void* stream) {
  using namespace fader;
  if (scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  return (int)decoder_bwd_from_dh2(
      T, B, H, Vp, 1, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T, w_ih2T,
      w_hh2T, g2, s1x, s1h, s2x, s2h, nullptr, dw_tok, dpre_z, dw_hh1,
      db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0, scratch,
      static_cast<cudaStream_t>(stream));
}
