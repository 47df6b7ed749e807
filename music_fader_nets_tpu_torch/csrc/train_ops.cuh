// Host launchers shared by the GRU kernels (embed_gru.cu,
// embed_gru_bwd.cu, gru_fwd_chain.cu, stacked_gru.cu, decoder_ce.cu,
// decoder_ce_bwd.cu, grad_reduce.cu).
// Each enqueues its launches on `s`, allocates nothing, and returns the
// first launch error (cudaSuccess = 0).
//
// Most take a storage type (float, or bf16 = __nv_bfloat16 with float32
// arithmetic; gru_tile.cuh) and are instantiated for both; the float
// instantiations are the kernels as they were before bf16 storage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fader {

using bf16 = __nv_bfloat16;

// A (K, M) row-major operand whose first n0 rows lie in one tensor and the
// rest in another: row k is a0 + l*a0_ls + k*lda for k < n0, else
// a1 + l*a1_ls + (k - n0)*lda. This is how "h_prev" of a recurrence is
// read without building it: rows of step 0 come from h0, the others from
// h_seq shifted by one step.
template <typename T>
struct SplitRowsT {
  const T* a0;
  long long a0_ls;
  int n0;
  const T* a1;
  long long a1_ls;
  int lda;
};
using SplitRows = SplitRowsT<float>;

// The whole reversed GRU backward chain of L directions in one persistent,
// cooperatively launched kernel: for t = T-1 .. 0, dh += g_t (g at g +
// l*g_ls + t*g_ts on every step when g_every_step, else g + l*g_ls on step
// T-1 only), (dpx[l, t], dph[l, t]) = gate_bwd(dh, stash[l, t], h_prev(t))
// with h_prev(0) = h0[l] and h_prev(t) = h_seq[l, t-1], dh = dh * z +
// dph[l, t] @ w_hh[l]^T (w_hhT (L, 3H, H)); dh0[l] = the last dh. `scratch`
// holds chain_scratch_floats(L, B, H) floats. Fails (no other path is
// taken) when the grid cannot be co-resident on the device or the weights
// of a block do not fit its shared memory. S is the type of stash, h_seq,
// h0 and w_hhT; g and what it writes are float32 (S = float or bf16). With
// S = bf16 the product dph @ w_hh^T runs on the tensor cores (the float32
// dph split into three bf16 pieces, mma_bf16.cuh), and with pre_h not null
// the chain reads no stash: it rebuilds r, z, n and hn from pre (L, T, B,
// 3H) and the float32 pre_h = h_prev @ w_hh + b_hh (L, T, B, 3H), as the
// Pallas kernel 2 does (pallas_gru.py:254-263).
long long chain_scratch_floats(int L, int B, int H);
template <typename S>
cudaError_t launch_gru_bwd_chain(int L, int T, int B, int H, const float* g,
                                 long long g_ls, long long g_ts,
                                 int g_every_step, const S* stash,
                                 const S* h_seq, const S* h0,
                                 const S* w_hhT, float* dpx, float* dph,
                                 float* dh0, float* scratch, cudaStream_t s,
                                 const S* pre = nullptr,
                                 const float* pre_h = nullptr);

// The whole GRU forward recurrence of L chains in one persistent,
// cooperatively launched kernel (gru_fwd_chain.cu): for t = 0 .. T-1, from
// h = h0[l] (B, H rows at h0 + l*B*H),
//   xpre = x[l, t, b] (x (L, T, B, 3H), ids null)
//        | x[l, ids[l, t, b]] (x (L, V, 3H) a table; no row outside [0, V))
//          (+ add[l, b] at add + l*add_ls + b*add_bs, when add is not null)
//   h    = gates(xpre, h @ w_hh[l] + b_hh[l], h)   (w_hh (L, H, 3H))
// writing, unless null, h_seq (L, T, B, H), the last step's h to finals
// (L, B, H) and the gate stash [r, z, n, hn_h] (L, T, B, 4H). `scratch`
// holds fwd_chain_scratch_floats(L, B, H) floats. T >= 1. Fails as
// launch_gru_bwd_chain does. x and h0 are XT, the rest S; instantiated for
// (float, float), (bf16, bf16) and (float, bf16). With S = bf16, h32
// (L, T, B, H), unless null, receives the float32 h of every step.
long long fwd_chain_scratch_floats(int L, int B, int H);
template <typename XT, typename S>
cudaError_t launch_gru_fwd_chain(int L, int T, int B, int H, const int* ids,
                                 const XT* x, int V, const S* add,
                                 long long add_ls, int add_bs,
                                 const S* w_hh, const S* b_hh, const XT* h0,
                                 S* h_seq, S* finals, S* stash,
                                 float* scratch, cudaStream_t s,
                                 float* h32 = nullptr);

// The cross-entropy head over R rows of h2 (R, H): logits = h2 @ w_out +
// b_out over Vp lanes. With g null it writes nll[r] = logsumexp(logits[r])
// - logits[r, tgt[r]]; with g (R) it writes dlogits (R, Vp) =
// (softmax(logits) - onehot(tgt)) * g. h2 is AT, w_out and b_out WT:
// (float, float), and with bf16 weights (float, bf16) for the forward,
// whose h2 is the chain's float32 state, and (bf16, bf16) for the
// backward, which reads the stored h2_seq. The (bf16, bf16) head computes
// its logits on the tensor cores from w_outT (Vp, H), w_out transposed,
// which it requires; the others read w_out.
template <typename AT, typename WT>
cudaError_t launch_ce_head(int R, int H, int Vp, const AT* h2,
                           const WT* w_out, const WT* b_out, const int* tgt,
                           const float* g, float* nll, float* dlogits,
                           cudaStream_t s, const WT* w_outT = nullptr);

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

// The teacher decode's two GRUCell layers over T steps, a fixed number of
// launches: tok (T,B) input ids, w_tok (Vp,3H), pre_z (B,3H), the layers'
// weights, h1_0 (B,H); writes h1_seq, h2_seq (T,B,H) and, unless null, the
// gate stashes g41, g42 (T,B,4H). `scratch` holds
// decoder_fwd_scratch_floats(T, B, H) floats.
long long decoder_fwd_scratch_floats(int T, int B, int H);
cudaError_t launch_decoder_recurrence(
    int T, int B, int H, int Vp, const int* tok, const float* w_tok,
    const float* pre_z, const float* w_hh1, const float* b_hh1,
    const float* w_ih2, const float* b_ih2, const float* w_hh2,
    const float* b_hh2, const float* h1_0, float* h1_seq, float* h2_seq,
    float* g41, float* g42, float* scratch, cudaStream_t s);

// The same decode with bf16 operands and outputs: float32 carries, layer
// 2's input product and h1 / h2 kept in float32 as well (h1_32, h2_32 (T,
// B, H), which the CE head then reads); `scratch` holds
// decoder_fwd_scratch_floats(T, B, H) floats.
cudaError_t launch_decoder_recurrence_bf16(
    int T, int B, int H, int Vp, const int* tok, const bf16* w_tok,
    const bf16* pre_z, const bf16* w_hh1, const bf16* b_hh1,
    const bf16* w_ih2, const bf16* b_ih2, const bf16* w_hh2,
    const bf16* b_hh2, const bf16* h1_0, bf16* h1_seq, bf16* h2_seq,
    bf16* g41, bf16* g42, float* h1_32, float* h2_32, float* scratch,
    cudaStream_t s);

// Floats of scratch that gemm_tn(L, M, N, K) and colsum(L, K, N) need (the
// larger of the two: they run one after the other on a stream and share
// it). Depends on the current device's SM count.
long long reduce_scratch_floats(int L, int M, int N, int K);

// C[l] (M, N) = sum over k < K of A(k, m) B[l](k, n); A a SplitRows (K, M)
// operand of AT, B row-major (K, N) at b + l*b_ls, C row-major at c +
// l*c_ls, both float32. K is split into parts whose partial products go
// through `scratch` (reduce_scratch_floats) and are added in a fixed
// order. AT = float: the tensor cores, both operands split into three
// bf16 pieces, where the TMA can describe the call (rows of 16-byte
// multiples, the seam on a 16-row slab), else float32 FMA; AT = bf16: the
// tensor cores, B split into three bf16 pieces (grad_reduce.cu).
template <typename AT>
cudaError_t gemm_tn(int L, int M, int N, int K, SplitRowsT<AT> a,
                    const float* b, long long b_ls, float* c, long long c_ls,
                    float* scratch, cudaStream_t s);

// C (M, N) = A (M, K) @ B (K, N), all row-major and contiguous, and
// C[m, :] += add[m, :] for m < add_rows when `add` is not null (the same
// row-major (add_rows, N) layout). No atomics, no split of K. B is BT; A,
// C and add are float32. BT = float: float32 FMA; BT = bf16: the tensor
// cores, A split into three bf16 pieces (grad_reduce.cu).
template <typename BT>
cudaError_t gemm_nn(int M, int N, int K, const float* a, const BT* b,
                    float* c, const float* add, int add_rows,
                    cudaStream_t s);

// C[l] (M, N) = A[l] (M, K) @ B[l] (K, N) + bias[l] (N), for l < L: A a
// SplitRows of bf16 rows (row m at a0 + l*a0_ls + m*lda for m < n0, else
// a1 + l*a1_ls + (m - n0)*lda), B bf16 row-major at b + l*b_ls, bias bf16
// at bias + l*bias_ls (or null), C float32 row-major at c + l*c_ls. One
// bf16 MMA a product, float32 accumulation: the exact products of two bf16
// operands.
cudaError_t gemm_nn_bf16(int L, int M, int N, int K, SplitRowsT<bf16> a,
                         const bf16* b, long long b_ls, const bf16* bias,
                         long long bias_ls, float* c, long long c_ls,
                         cudaStream_t s);

// out[l, v, :] = sum over rows r with ids[l, r] == v of x[l, r, :], for
// v < V, rows in increasing r (deterministic; no atomics). x rows are N
// floats; ids (L, R), x (L, R, N), out (L, V, N), all contiguous.
cudaError_t segment_rows(int L, int R, int N, int V, const int* ids,
                         const float* x, float* out, cudaStream_t s);

// out[l, :] = sum over r < R of x[l, r, :]; x (L, R, N) contiguous. Rows
// are summed in 256-row chunks whose partial sums go through `scratch`
// (reduce_scratch_floats with K = R) and are added in chunk order.
cudaError_t colsum(int L, int R, int N, const float* x, float* out,
                   float* scratch, cudaStream_t s);

// out[l, i] = sum over t < T of x[l, t, i] for i < n; x (L, T, n).
cudaError_t sum_over_t(int L, int T, int n, const float* x, float* out,
                       cudaStream_t s);

}  // namespace fader
