// Host launchers shared by the training kernels (embed_gru.cu,
// embed_gru_bwd.cu, decoder_ce.cu, decoder_ce_bwd.cu, grad_reduce.cu).
// Each enqueues its launches on `s`, allocates nothing, and returns the
// first launch error (cudaSuccess = 0).
#pragma once

#include <cuda_runtime.h>

namespace fader {

// A (K, M) row-major operand whose first n0 rows lie in one tensor and the
// rest in another: row k is a0 + l*a0_ls + k*lda for k < n0, else
// a1 + l*a1_ls + (k - n0)*lda. This is how "h_prev" of a recurrence is
// read without building it: rows of step 0 come from h0, the others from
// h_seq shifted by one step.
struct SplitRows {
  const float* a0;
  long long a0_ls;
  int n0;
  const float* a1;
  long long a1_ls;
  int lda;
};

// One training-forward step of L stacked GRU directions whose input
// projection is a row gather: pre_x = w_in[l, id[l, t, b]] + add[l, b]
// (add_bs = 0 broadcasts add[l] over b). Reads h_prev at h_in + l*h_in_ls
// (B, H); writes h_seq[l, t] and, when stash is not null, the gate stash
// [r, z, n, hn] at stash[l, t]. Ids outside [0, V) select no row.
cudaError_t launch_embed_train_step(int L, int T, int B, int H, int V, int t,
                                    const int* ids, const float* w_in,
                                    const float* add, long long add_ls,
                                    int add_bs, const float* w_hh,
                                    const float* b_hh, const float* h_in,
                                    long long h_in_ls, float* h_seq,
                                    float* stash, cudaStream_t s);

// One reversed step of the GRU backward chain for L directions: with
// dh = dh_in[l] + g (g at g + l*g_ls, may be null), the gate backward from
// the stash at step t and h_prev (at h_prev + l*hp_ls), writes
// dpx[l, t] / dph[l, t] (the input / hidden projection cotangents) and
// dh_out[l] = dh * z + dph[l, t] @ w_hh[l]^T, with w_hhT (L, 3H, H).
cudaError_t launch_gru_bwd_step(int L, int T, int B, int H, int t,
                                const float* g, long long g_ls,
                                const float* stash, const float* h_prev,
                                long long hp_ls, const float* w_hhT,
                                const float* dh_in, float* dh_out,
                                float* dpx, float* dph, cudaStream_t s);

// The cross-entropy head over R rows of h2 (R, H): logits = h2 @ w_out +
// b_out over Vp lanes. With g null it writes nll[r] = logsumexp(logits[r])
// - logits[r, tgt[r]]; with g (R) it writes dlogits (R, Vp) =
// (softmax(logits) - onehot(tgt)) * g.
cudaError_t launch_ce_head(int R, int H, int Vp, const float* h2,
                           const float* w_out, const float* b_out,
                           const int* tgt, const float* g, float* nll,
                           float* dlogits, cudaStream_t s);

// Vocabulary ranges [lo, hi) of the masses head, at most kMaxRanges.
constexpr int kMaxRanges = 4;
struct MassRanges {
  int k;
  int lo[kMaxRanges];
  int hi[kMaxRanges];
};

// The masses head over R = T*B rows of h2 (row t*B + b): p = softmax(h2 @
// w_out + b_out) over Vp lanes, m_k = sum of p over range k. With g null
// it writes masses (T, K, B); with g (T, K, B) it writes dlogits (R, Vp) =
// p * sum_k g_k (1[j in range k] - m_k).
cudaError_t launch_mass_head(int R, int B, int H, int Vp, MassRanges rg,
                             const float* h2, const float* w_out,
                             const float* b_out, const float* g,
                             float* masses, float* dlogits, cudaStream_t s);

// MassRanges from K pairs [lo, hi) given as 2K ints in host memory; false
// when K is not in [1, kMaxRanges].
bool make_ranges(int K, const int* ranges, MassRanges* rg);

// The teacher decode's two GRUCell layers over T steps (2T launches): tok
// (T,B) input ids, w_tok (Vp,3H), pre_z (B,3H), the layers' weights, h1_0
// (B,H); writes h1_seq, h2_seq (T,B,H) and, unless null, the gate stashes
// g41, g42 (T,B,4H).
cudaError_t launch_decoder_recurrence(
    int T, int B, int H, int Vp, const int* tok, const float* w_tok,
    const float* pre_z, const float* w_hh1, const float* b_hh1,
    const float* w_ih2, const float* b_ih2, const float* w_hh2,
    const float* b_hh2, const float* h1_0, float* h1_seq, float* h2_seq,
    float* g41, float* g42, cudaStream_t s);

// C[l] (M, N) = sum over k < K of A(k, m) B[l](k, n); A a SplitRows (K, M)
// operand, B row-major (K, N) at b + l*b_ls, C row-major at c + l*c_ls.
cudaError_t gemm_tn(int L, int M, int N, int K, SplitRows a, const float* b,
                    long long b_ls, float* c, long long c_ls, cudaStream_t s);

// C (M, N) = A (M, K) @ B (K, N), all row-major and contiguous.
cudaError_t gemm_nn(int M, int N, int K, const float* a, const float* b,
                    float* c, cudaStream_t s);

// out[l, v, :] = sum over rows r with ids[l, r] == v of x[l, r, :], for
// v < V, rows in increasing r (deterministic; no atomics). x rows are N
// floats; ids (L, R), x (L, R, N), out (L, V, N), all contiguous.
cudaError_t segment_rows(int L, int R, int N, int V, const int* ids,
                         const float* x, float* out, cudaStream_t s);

// out[l, :] = sum over r < R of x[l, r, :]; x (L, R, N) contiguous.
cudaError_t colsum(int L, int R, int N, const float* x, float* out,
                   cudaStream_t s);

// out[l, i] = sum over t < T of x[l, t, i] for i < n; x (L, T, n).
cudaError_t sum_over_t(int L, int T, int n, const float* x, float* out,
                       cudaStream_t s);

}  // namespace fader
