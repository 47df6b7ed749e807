// Decode kernel: the whole autoregressive greedy / Gumbel-max decode of the
// 2-layer GRUCell global decoder in one persistent cooperative launch,
// emitting only int32 tokens.
//
// Replaces: music_fader_nets_tpu/ops/pallas_decode.py::_decode_kernel :83
// (greedy, entry fader_greedy_decode) and ::_sample_kernel :116 (sampling,
// entry fader_sample_decode). One kernel, the sampling epilogue switched on
// by a non-null noise pointer.
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
// step, each ending at a grid-wide barrier.
//
// Design: ONE cooperative launch for all steps (plus the memset that zeroes
// its scratch). The recurrent and head weights fit the grid's shared
// memory: a block owns 4 hidden units and keeps their 12 columns (r, z, n
// of each unit) of w_hh1, w_ih2 and w_hh2, of w_tok (the token gather) and
// the 12 vocab lanes of its logits task(s), ~222 KB at H = 512 and B = 64
// over 128 blocks, so the weights leave L2 once a call. A step is three
// phases, each ending at a barrier on one counter (a release add to arrive,
// acquire loads to wait):
//   A. layer 1's gates: the token from the previous step's argmax key, its
//      w_tok row from shared memory, pre_h1 from phase B of the previous
//      step (or the prologue's h1_0 @ w_hh1); h1' written k-major; then,
//      between arriving and waiting, h2p @ w_hh2 with h2p = h2 of the
//      previous step (complete since its phase B), so that this product
//      overlaps the barrier;
//   B. h1' @ [w_ih2 | w_hh1] in one pass over h1' (at step 0, where the
//      step-0 rule makes h2p = h1', h1' @ w_hh2 too): layer 2's gates give
//      h2' (k-major, double-buffered over the step's parity); the w_hh1
//      product is the NEXT step's pre_h1, kept in registers by the threads
//      that own those units (it does not depend on the token, so phase A
//      has no product on its way to the barrier);
//   C. logits in tasks of 12 vocab lanes x 16 rows (128 tasks at B = 64
//      and H = 512, one a block; a narrow H with fewer blocks than that
//      takes tasks of the whole row tile), each lane's score as a 64-bit
//      key (order-preserving float bits << 32 | ~lane), a row's 12 keys
//      folded by warp shuffles and then with one atomicMax a row and task
//      into device memory: a row's argmax with lowest-index ties. One key
//      buffer per step parity: block 0 clears the previous step's buffer
//      in phase B, after every block has read it, and writes its tokens
//      out in phase A.
// A product streams the k-major operand of its rows from L2 through a
// cp.async ring per warp; warp w takes k = w, w + 8, ... and each lane a
// tile of rows x 3 columns, its weights one float4 of a 16-float panel row;
// the warps' partial tiles are added in warp order through shared memory
// (no float atomics: a repeated call gives the same bits). The row tile is
// the smallest of 8, 16, 32 and 64 rows that holds B (the wrapper passes
// at most 64 rows a call). The sampling epilogue is __fmul_rn then
// __fadd_rn, so a row with inv_t = 1 and zero noise reproduces the greedy
// token bit for bit. A grid that cannot be co-resident (another kernel
// holding SMs, or H > 528) is refused: the launch returns its error and
// there is no other path.
#include "gru_tile.cuh"

namespace fader {

constexpr int kDecUnits = 4;                 // hidden units a block owns
constexpr int kDecCols = 3 * kDecUnits;      // columns of a product tile
constexpr int kDecLd = 16;                   // a weight panel's row: lane
                                             // group g at 4g .. 4g + 2
constexpr int kDecStages = 4;                // slabs in a warp's ring
constexpr int kDecSlab = 256;                // floats of an operand's slab
constexpr int kDecMaxB = 64;                 // rows of one call at most
constexpr int kDecHead = 32 + 4 * kDecMaxB;  // counter | keys (2, 64) u64

__host__ __device__ inline int dec_rb(int B) {
  return B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
}

// rows of a logits task: the row tile in chunks of 16 when the grid has a
// block for every (vocab group, chunk), else the whole tile (a narrow H:
// few blocks, each holding the panels of several tasks)
inline int dec_rc(int rb, int H, int Vp) {
  const int nb = (H + kDecUnits - 1) / kDecUnits;
  const int nvg = (Vp + kDecCols - 1) / kDecCols;
  return rb > 16 && nb >= nvg * (rb / 16) ? 16 : rb;
}

// H padded to a whole slab of every product: k rows of a slab are
// 8 warps x 256 / R for R rows, the fewest R the logits' RC
inline int dec_kp(int H, int rc) {
  const int kc = kWarps * kDecSlab / rc;
  return (H + kc - 1) / kc * kc;
}

template <int N>
struct Rows {
  static constexpr int value = N;
};

// a warp's partial tile of R rows x 12 columns in shared memory: rows of
// 12 floats, 4 floats of skew after every 8 rows, so that the 32 lanes'
// stores (lane 4 rg + cg: rows rg * R/8 + i, columns 3 cg + c) fall in 32
// banks (unskewed, the 8 row groups of R = 64 hit one bank)
__host__ __device__ constexpr int dec_tile(int R) {
  return R * kDecCols + R / 2;
}

__device__ __forceinline__ int dec_at(int r, int c) {
  return r * kDecCols + (r / 8) * 4 + c;
}

// floats of a block's ring or of three products' partial tiles, whichever
// is larger: they share the same shared memory
__host__ __device__ inline int dec_buf_floats(int rb) {
  const int ring = kWarps * kDecStages * kDecSlab;
  const int red = 3 * kWarps * dec_tile(rb);
  return ring > red ? ring : red;
}

// the panel index of tile column c (lane group c / 3 reads a float4)
__host__ __device__ inline int dec_pc(int c) { return (c / 3) * 4 + c % 3; }

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

struct DecodeParams {
  int B, H, V, Vp, steps, Kp, nvg;  // nvg: 12-lane groups of the vocab
  int rc;                           // rows of a logits task: 16 or RB
  const float *w_tok, *w_hh1, *b_hh1, *w_ih2, *b_ih2, *w_hh2, *b_hh2;
  const float *w_out, *b_out, *pre_z, *h1_0;
  const float* noise;               // (steps, B, Vp), null: greedy
  const float* inv_t;               // (B)
  int* tokens;                      // (steps, B)
  unsigned* counter;
  unsigned long long* keys;         // (2, kDecMaxB): a buffer per parity
  float* h1;                        // (Kp, RB) k-major h1'
  float* h2;                        // (2, Kp, RB) k-major h2' per parity
};

// acc[p][i][c] += the warp's share of sum_k src[k*ld + rg*LR + i] *
// w[p][k][c] (lane = 4 rg + cg holds tile columns 3cg .. 3cg + 2, LR = R/8
// rows), src k-major in device memory (R rows of a k row read, ld apart),
// w[p] a (Kp, 16) panel in shared memory. Warp w takes k = w, w + 8, ...
// in increasing order, streaming its rows of src through a ring of its own
// in `ring`. Ends with the ring drained; the caller syncs before reusing
// it.
template <int R, int NP>
__device__ __forceinline__ void dec_product(float (&acc)[NP][R / 8][3],
                                            const float* src, int ld,
                                            const float* const (&w)[NP],
                                            int Kp, float* ring) {
  constexpr int LR = R / 8;
  constexpr int KW = kDecSlab / R;      // k rows of a warp's slab
  constexpr int KC = kWarps * KW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 2, cg = lane & 3;
  float* my = ring + warp * (kDecStages * kDecSlab);
  const int nslab = Kp / KC;
  auto fill = [&](int sl) {
    float* dst = my + (sl % kDecStages) * kDecSlab;
#pragma unroll
    for (int n = 0; n < kDecSlab / 4 / 32; ++n) {
      const int idx = lane + 32 * n;
      const int kk = idx / (R / 4), q = idx % (R / 4);
      const int k = sl * KC + warp + kWarps * kk;
      cp_async<16>(dst + kk * R + 4 * q, src + (size_t)k * ld + 4 * q, 16);
    }
  };
#pragma unroll
  for (int sl = 0; sl < kDecStages - 1; ++sl) {
    if (sl < nslab) fill(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kDecStages - 2>();
    // the warp's own copies have landed and its lanes have left the stage
    // that is refilled next
    __syncwarp();
    if (sl + kDecStages - 1 < nslab) fill(sl + kDecStages - 1);
    cp_async_commit();
    const float* as = my + (sl % kDecStages) * kDecSlab + rg * LR;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int k = sl * KC + warp + kWarps * kk;
      const float* ap = as + kk * R;
      float a[LR];
      if constexpr (LR % 4 == 0) {
#pragma unroll
        for (int q = 0; q < LR / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(ap + 4 * q);
          a[4 * q] = v.x;
          a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z;
          a[4 * q + 3] = v.w;
        }
      } else if constexpr (LR == 2) {
        const float2 v = *reinterpret_cast<const float2*>(ap);
        a[0] = v.x;
        a[1] = v.y;
      } else {
        a[0] = ap[0];
      }
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w[pr] + k * kDecLd + cg * 4);
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          acc[pr][i][0] = fmaf(a[i], wv.x, acc[pr][i][0]);
          acc[pr][i][1] = fmaf(a[i], wv.y, acc[pr][i][1]);
          acc[pr][i][2] = fmaf(a[i], wv.z, acc[pr][i][2]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// the warps' partial tiles of NP products into red [NP][warp] (tiles of
// dec_tile(R) floats; after every warp has left the ring that red
// overlays), then a sync
template <int R, int NP>
__device__ __forceinline__ void dec_partials(
    const float (&acc)[NP][R / 8][3], float* red) {
  constexpr int LR = R / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 2, cg = lane & 3;
  __syncthreads();
#pragma unroll
  for (int pr = 0; pr < NP; ++pr)
#pragma unroll
    for (int i = 0; i < LR; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        red[(pr * kWarps + warp) * dec_tile(R) +
            dec_at(rg * LR + i, cg * 3 + c)] = acc[pr][i][c];
  __syncthreads();
}

// product pr's sum at (row r, tile column c): the 8 warps' partials in
// order
template <int R>
__device__ __forceinline__ float dec_sum(const float* red, int pr, int r,
                                         int c) {
  const float* p = red + pr * kWarps * dec_tile(R) + dec_at(r, c);
  float s = p[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, p[w * dec_tile(R)]);
  return s;
}

template <int RB>
__global__ void __launch_bounds__(kThreads, 1) decode_chain(DecodeParams p) {
  extern __shared__ float4 smem4[];
  const int B = p.B, H = p.H, G = 3 * H, Kp = p.Kp, Vp = p.Vp;
  const int NB = gridDim.x, tid = threadIdx.x;
  const int c0 = blockIdx.x * kDecUnits;
  const int ntask = p.nvg * (RB / p.rc);      // (vocab group, row chunk)
  const int ntb = (ntask + NB - 1) / NB;      // logits tasks a block takes
  const size_t KP = (size_t)Kp * kDecLd;      // floats of a weight panel
  float* sW = reinterpret_cast<float*>(smem4);  // [3][Kp][16]
  float* sWo = sW + 3 * KP;                     // [ntb][Kp][16]
  float* sTok = sWo + ntb * KP;                 // [Vp][12]
  float* buf = sTok + (size_t)Vp * kDecCols;    // ring | partial tiles

  // tile column c of a GRU panel: gate c / 4 of unit c0 + c % 4; of a
  // logits panel: vocab lane 12 vg + c
  const float* mats[3] = {p.w_hh1, p.w_ih2, p.w_hh2};
  for (int idx = tid; idx < 3 * Kp * kDecCols; idx += kThreads) {
    const int m = idx / (Kp * kDecCols), rem = idx % (Kp * kDecCols);
    const int k = rem / kDecCols, c = rem % kDecCols;
    const int u = c0 + c % kDecUnits;
    sW[m * KP + k * kDecLd + dec_pc(c)] =
        (k < H && u < H) ? mats[m][(size_t)k * G + (c / 4) * H + u] : 0.f;
  }
  for (int idx = tid; idx < ntb * Kp * kDecCols; idx += kThreads) {
    const int q = idx / (Kp * kDecCols), rem = idx % (Kp * kDecCols);
    const int k = rem / kDecCols, c = rem % kDecCols;
    const int j = ((blockIdx.x + q * NB) % p.nvg) * kDecCols + c;
    sWo[q * KP + k * kDecLd + dec_pc(c)] =
        (k < H && j < Vp) ? p.w_out[(size_t)k * Vp + j] : 0.f;
  }
  for (int idx = tid; idx < Vp * kDecCols; idx += kThreads) {
    const int v = idx / kDecCols, c = idx % kDecCols;
    const int u = c0 + c % kDecUnits;
    sTok[idx] = u < H ? p.w_tok[(size_t)v * G + (c / 4) * H + u] : 0.f;
  }

  // the thread's (row, unit) of the gate phases, with its h1, h2, pre_z,
  // biases and the hidden products of its gates (ph1 = h1 @ w_hh1 for the
  // next step, ph2 = h2p @ w_hh2) in registers for the whole call
  const int gr = tid >> 2, gu = tid & 3, gj = c0 + gu;
  const bool g_on = gr < RB && gj < H;     // a k row of the operands
  const bool g_ok = g_on && gr < B;
  float h1 = 0.f, h2 = 0.f, pz[3], b1[3], b2i[3], b2h[3], ph1[3], ph2[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    pz[g] = g_ok ? p.pre_z[(size_t)gr * G + g * H + gj] : 0.f;
    b1[g] = g_on ? p.b_hh1[g * H + gj] : 0.f;
    b2i[g] = g_on ? p.b_ih2[g * H + gj] : 0.f;
    b2h[g] = g_on ? p.b_hh2[g * H + gj] : 0.f;
  }
  if (g_ok) h1 = p.h1_0[(size_t)gr * H + gj];
  if (g_on) p.h1[(size_t)gj * RB + gr] = h1;

  // the grid-wide barrier: every block arrives once per phase, with a
  // release add (the block's writes, ordered before it by __syncthreads,
  // are visible to whoever acquires the count) and waits with acquire
  // loads (no separate fences: 0.5 ms less a 300-step call than
  // __threadfence + atomicAdd + volatile spin + __threadfence,
  // serve/decode_ablate.py)
  unsigned phase = 0;
  auto arrive = [&]() {
    ++phase;
    __syncthreads();
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :: "l"(p.counter) : "memory");
  };
  auto wait = [&]() {
    if (tid == 0) {
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen) : "l"(p.counter) : "memory");
      } while (seen < (unsigned)NB * phase);
    }
    __syncthreads();
  };
  auto grid_sync = [&]() {
    arrive();
    wait();
  };
  auto load_key = [&](int parity, int b) {
    return *reinterpret_cast<volatile unsigned long long*>(
        p.keys + parity * kDecMaxB + b);
  };

  // prologue: step 0's pre_h1 = h1_0 @ w_hh1
  grid_sync();
  {
    const float* w[1] = {sW};
    float acc[1][RB / 8][3] = {};
    dec_product<RB, 1>(acc, p.h1, RB, w, Kp, buf);
    dec_partials<RB, 1>(acc, buf);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ph1[g] = gr < RB ? dec_sum<RB>(buf, 0, gr, g * 4 + gu) : 0.f;
  }
  grid_sync();   // every block has read h1_0 before step 0 overwrites it

  const size_t hsz = (size_t)Kp * RB;
  for (int i = 0; i < p.steps; ++i) {
    // ---- A: layer 1's gates; after the arrival, while the others arrive,
    // ph2 = h2 @ w_hh2 (from step 1 on h2p = h2 of the previous step,
    // complete since its phase B)
    if (g_ok) {
      int tk = p.V - 1;
      if (i > 0) {
        tk = key_token(load_key((i - 1) & 1, gr));
        if (blockIdx.x == 0 && gu == 0)
          p.tokens[(size_t)(i - 1) * B + gr] = tk;
        tk = min(max(tk, 0), Vp - 1);
      }
      const float* wt = sTok + (size_t)tk * kDecCols + gu;
      h1 = gru_combine(__fadd_rn(wt[0], pz[0]), __fadd_rn(wt[4], pz[1]),
                       __fadd_rn(wt[8], pz[2]), __fadd_rn(ph1[0], b1[0]),
                       __fadd_rn(ph1[1], b1[1]), __fadd_rn(ph1[2], b1[2]),
                       h1);
    }
    if (g_on) p.h1[(size_t)gj * RB + gr] = h1;
    arrive();
    if (i > 0) {
      const float* w[1] = {sW + 2 * KP};
      float acc[1][RB / 8][3] = {};
      dec_product<RB, 1>(acc, p.h2 + ((i - 1) & 1) * hsz, RB, w, Kp, buf);
      dec_partials<RB, 1>(acc, buf);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        ph2[g] = gr < RB ? dec_sum<RB>(buf, 0, gr, g * 4 + gu) : 0.f;
    }
    wait();

    // ---- B: h1' @ [w_ih2 | w_hh1] (and at step 0, where h2p = h1',
    // h1' @ w_hh2); layer 2's gates
    if (blockIdx.x == 0 && i > 0 && tid < B)
      p.keys[((i - 1) & 1) * kDecMaxB + tid] = 0ull;
    float x[3];
    if (i == 0) {
      const float* w[3] = {sW + KP, sW, sW + 2 * KP};
      float acc[3][RB / 8][3] = {};
      dec_product<RB, 3>(acc, p.h1, RB, w, Kp, buf);
      dec_partials<RB, 3>(acc, buf);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        ph2[g] = gr < RB ? dec_sum<RB>(buf, 2, gr, g * 4 + gu) : 0.f;
    } else {
      const float* w[2] = {sW + KP, sW};
      float acc[2][RB / 8][3] = {};
      dec_product<RB, 2>(acc, p.h1, RB, w, Kp, buf);
      dec_partials<RB, 2>(acc, buf);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int c = g * 4 + gu;
      x[g] = gr < RB ? dec_sum<RB>(buf, 0, gr, c) : 0.f;
      ph1[g] = gr < RB ? dec_sum<RB>(buf, 1, gr, c) : 0.f;
    }
    if (g_ok)
      h2 = gru_combine(__fadd_rn(x[0], b2i[0]), __fadd_rn(x[1], b2i[1]),
                       __fadd_rn(x[2], b2i[2]), __fadd_rn(ph2[0], b2h[0]),
                       __fadd_rn(ph2[1], b2h[1]), __fadd_rn(ph2[2], b2h[2]),
                       i == 0 ? h1 : h2);
    if (g_on) p.h2[(i & 1) * hsz + (size_t)gj * RB + gr] = h2;
    grid_sync();

    // ---- C: logits tasks (12 vocab lanes x RC rows), argmax keys: a
    // row's lanes sit in 16 consecutive threads (12 of them live), folded
    // by shuffles, then one atomicMax a row and task into device memory
    auto logits = [&](auto rows) {
      constexpr int RC = decltype(rows)::value;
      constexpr int kPasses = RC * 16 / kThreads + (RC * 16 < kThreads);
      for (int q = 0; q < ntb; ++q) {
        const int t = blockIdx.x + q * NB;
        if (t >= ntask) break;
        const int vg = t % p.nvg, row0 = (t / p.nvg) * RC;
        float nz[kPasses];
#pragma unroll
        for (int n = 0; n < kPasses; ++n) {
          const int idx = tid + n * kThreads, c = idx % 16;
          const int b = row0 + idx / 16, j = vg * kDecCols + c;
          nz[n] = (p.noise != nullptr && idx < RC * 16 && c < kDecCols &&
                   b < B && j < Vp) ? p.noise[((size_t)i * B + b) * Vp + j]
                                    : 0.f;
        }
        {
          const float* w[1] = {sWo + q * KP};
          float acc[1][RC / 8][3] = {};
          dec_product<RC, 1>(acc, p.h2 + (i & 1) * hsz + row0, RB, w, Kp,
                             buf);
          dec_partials<RC, 1>(acc, buf);
        }
#pragma unroll
        for (int n = 0; n < kPasses; ++n) {
          const int idx = tid + n * kThreads, c = idx % 16;
          const int r = idx / 16, b = row0 + r, j = vg * kDecCols + c;
          unsigned long long key = 0ull;
          if (idx < RC * 16 && c < kDecCols && b < B && j < Vp) {
            float v = __fadd_rn(dec_sum<RC>(buf, 0, r, c), p.b_out[j]);
            if (p.noise != nullptr)
              v = __fadd_rn(__fmul_rn(v, p.inv_t[b]), nz[n]);
            key = argmax_key(v, j);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            const unsigned long long o =
                __shfl_xor_sync(0xFFFFFFFFu, key, off);
            key = o > key ? o : key;
          }
          if (c == 0 && key != 0ull)
            atomicMax(&p.keys[(i & 1) * kDecMaxB + b], key);
        }
        __syncthreads();
      }
    };
    if constexpr (RB > 16) {
      if (p.rc == 16)
        logits(Rows<16>{});
      else
        logits(Rows<RB>{});
    } else {
      logits(Rows<RB>{});
    }
    grid_sync();
  }
  if (blockIdx.x == 0 && tid < B)
    p.tokens[(size_t)(p.steps - 1) * B + tid] =
        key_token(load_key((p.steps - 1) & 1, tid));
}

// k rows are padded to at most a multiple of 256 (the 8-row slab)
long long decode_scratch_floats(int B, int H) {
  return kDecHead + 3LL * dec_kp(H, 8) * dec_rb(B);
}

template <int RB>
cudaError_t try_decode(const DecodeParams& p, bool* fits, cudaStream_t s) {
  const int NB = (p.H + kDecUnits - 1) / kDecUnits;
  const size_t KP = (size_t)p.Kp * kDecLd;
  const int ntb = (p.nvg * (RB / p.rc) + NB - 1) / NB;
  const size_t smem =
      (3 * KP + ntb * KP + (size_t)p.Vp * kDecCols + dec_buf_floats(RB)) *
      sizeof(float);
  return try_cooperative(decode_chain<RB>, dim3(NB), smem, p, fits, s);
}

static int decode(int B, int H, int V, int Vp, int steps, const float* w_tok,
                  const float* w_hh1, const float* b_hh1, const float* w_ih2,
                  const float* b_ih2, const float* w_hh2, const float* b_hh2,
                  const float* w_out, const float* b_out, const float* pre_z,
                  const float* h1_0, const float* noise, const float* inv_t,
                  int* tokens_out, float* scratch, long long scratch_floats,
                  cudaStream_t s) {
  if (steps <= 0) return (int)cudaSuccess;
  if (B < 1 || B > kDecMaxB || scratch_floats < decode_scratch_floats(B, H))
    return (int)cudaErrorInvalidValue;
  const int rb = dec_rb(B), rc = dec_rc(rb, H, Vp), Kp = dec_kp(H, rc);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, decode_scratch_floats(B, H) * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const DecodeParams p{
      B, H, V, Vp, steps, Kp, (Vp + kDecCols - 1) / kDecCols, rc,
      w_tok, w_hh1, b_hh1, w_ih2, b_ih2, w_hh2, b_hh2, w_out, b_out, pre_z,
      h1_0, noise, inv_t, tokens_out, reinterpret_cast<unsigned*>(scratch),
      reinterpret_cast<unsigned long long*>(scratch + 32),
      scratch + kDecHead, scratch + kDecHead + (size_t)Kp * rb};
  bool fits = false;
  switch (rb) {
    case 8: err = try_decode<8>(p, &fits, s); break;
    case 16: err = try_decode<16>(p, &fits, s); break;
    case 32: err = try_decode<32>(p, &fits, s); break;
    default: err = try_decode<64>(p, &fits, s); break;
  }
  if (err == cudaSuccess && !fits) err = cudaErrorCooperativeLaunchTooLarge;
  return (int)err;
}

}  // namespace fader

// Floats of scratch a decode call of B rows (at most 64) and width H
// needs: the barrier counter, the two argmax key buffers and the k-major
// h1' and h2' rows.
extern "C" long long fader_decode_scratch_floats(int B, int H) {
  return fader::decode_scratch_floats(B, H);
}

// Shapes (all contiguous, float32 unless noted, on one device):
//   w_tok (Vp,3H); w_hh1, w_ih2, w_hh2 (H,3H); b_hh1, b_ih2, b_hh2 (3H);
//   w_out (H,Vp); b_out (Vp) with pad lanes -1e30; pre_z (B,3H) =
//   z @ w_z + b_ih; h1_0 (B,H); tokens_out (steps,B) int32. 1 <= B <= 64.
//   Scratch: scratch_floats >= fader_decode_scratch_floats(B,H) floats.
// Enqueue one memset and one cooperative launch on `stream`; return the
// first error (0 = cudaSuccess).
extern "C" int fader_greedy_decode(int B, int H, int V, int Vp, int steps,
                                   const float* w_tok, const float* w_hh1,
                                   const float* b_hh1, const float* w_ih2,
                                   const float* b_ih2, const float* w_hh2,
                                   const float* b_hh2, const float* w_out,
                                   const float* b_out, const float* pre_z,
                                   const float* h1_0, int* tokens_out,
                                   float* scratch, long long scratch_floats,
                                   void* stream) {
  return fader::decode(B, H, V, Vp, steps, w_tok, w_hh1, b_hh1, w_ih2, b_ih2,
                       w_hh2, b_hh2, w_out, b_out, pre_z, h1_0, nullptr,
                       nullptr, tokens_out, scratch, scratch_floats,
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
                                   const float* inv_t, int* tokens_out,
                                   float* scratch, long long scratch_floats,
                                   void* stream) {
  return fader::decode(B, H, V, Vp, steps, w_tok, w_hh1, b_hh1, w_ih2, b_ih2,
                       w_hh2, b_hh2, w_out, b_out, pre_z, h1_0, noise, inv_t,
                       tokens_out, scratch, scratch_floats,
                       static_cast<cudaStream_t>(stream));
}

namespace fader {

__global__ void launch_probe(int) {}

}  // namespace fader

// Enqueue n launches of an empty 128-block kernel on `stream`: through the
// cooperative path the persistent kernels take (try_cooperative: the
// occupancy query, then cudaLaunchCooperativeKernel) when `cooperative`,
// else as ordinary launches. Measures what a cooperative launch costs the
// host (serve/launch_cost.py). Returns the first error.
extern "C" int fader_launch_probe(int cooperative, int n, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    cudaError_t err;
    if (cooperative) {
      bool fits = false;
      err = try_cooperative(launch_probe, dim3(128), 0, 0, &fits, s);
      if (err == cudaSuccess && !fits) err = cudaErrorCooperativeLaunchTooLarge;
    } else {
      launch_probe<<<128, kThreads, 0, s>>>(0);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
