// Kernel B: fused OnehotCNN-ensemble fitness + input gradient, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// ppde_tpu/ops/cnn_pallas.py:ensemble_fit_and_patch_grad (_kernel; its
// member-grid twin _kernel_m has the same contract). Per sample b and member
// m, with patches P[t] = x[b, t:t+K].flatten() (t < T = L-K+1):
//
//   H1  = rnd(relu(P @ enc_w + enc_b))               [T, C]
//   H2  = rnd(relu(H1 @ emb_w + emb_b))              [T, C2]
//   mx  = max_t H2 (compared after rounding)         [C2]
//   pred_m = sum_c mx * dec_w + dec_b
//   G2  = route(H2 == mx) * rnd(mx > 0 ? dec_w / (split ? count : 1) : 0)
//   G1  = rnd((G2 @ emb_w^T) * [H1 > 0])
//   dx += col2im(G1 @ enc_w^T)
//   fit = mean_m pred_m,  dx /= M   (d sum(fit) / dx)
//
// rnd() rounds to the compute type (float32: identity; bfloat16: RNE);
// every product sums in float32, biases add in float32. "split" routes the
// gradient equally over tied rows; "first" to the first tied row only
// (torch.max semantics).
//
// What bounds it on the H100: the tensor-core operations of the products
// (about 2*B*T*M*(K*V*C + C*C2) for the forward pass); the bytes moved (x,
// dx and the weights) are small.
//
// Design. The TPU kernel keeps all of a batch tile's activations on chip.
// At GFP width one sample's H1 is 233x237 and its H2 233x474 values, more
// than a block's 227 KB of shared memory in float32. One block handles one
// (sample, member):
//   * the max-pool's statistics come first: per channel the max, and a
//     bitmask over t of the rows that route the gradient (the tied rows for
//     "split", the first for "first");
//   * G2 has one nonzero per (channel, routed row), so G1 is gathered from
//     rows of emb_w^T instead of a dense G2 @ emb_w^T; then dP = G1 @ enc_w^T
//     and its col2im accumulate in shared memory.
// The conv is an implicit GEMM: patch row t is x_flat[t*V : t*V + K*V], so
// the im2col matrix is the one-hot row itself read with a stride of V.
// Blocks of different members write separate [M, B, L*V] partials, and a
// second kernel adds them in member order: no atomics on values, and the
// result is deterministic.
//
// Two schedules, chosen by the type:
//   bfloat16 (tc::): tensor cores (mma.sync m16n8k16, float32 accumulate).
//     All T <= 256 rows of a sample are one tile: H1 stays in shared memory
//     as bf16, each staged weight tile serves 256 rows, and H2 is reduced
//     to its column maxima straight from the accumulators.
//   float32 (simt::): FMAs from shared memory over 64-row tiles in two
//     passes (pass 1: H1, H2 and the max statistics; pass 2: H1 again).
// wgmma/TMA pipelines and the member-per-block schedule of _kernel_m are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int NB = 128;   // output columns per GEMM chunk
constexpr int CPL = 8;    // G1 columns per lane: C <= 32 * CPL
constexpr int MAXT = 256; // rows of the routed-row bitmask: T <= MAXT
constexpr int MW = MAXT / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, __nv_bfloat16 v) {
  *p = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // exact: v is already rounded to bf16
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

struct Args {
  const void* x;     // [B, L, V]  compute type
  const void* encw;  // [M, K*V, C]
  const float* encb; // [M, C]
  const void* embw;  // [M, C, C2]
  const void* embwT; // [M, C2, C]  (emb_w transposed, for the backward)
  const float* embb; // [M, C2]
  const void* decw;  // [M, C2]
  const float* decb; // [M]
  float* pred;       // [M, B]      scratch
  float* dxm;        // [M, B, L*V] scratch
  int B, L, V, K, C, C2, M, pool_first;
};

// Stage DEPTH x NB weights Bm(k0 + kk, n0 + n) = Bg[k*bsk + n*bsn] (zero
// beyond kvalid / nvalid) into dst[n*ld + kk] (TRANSPOSED) or dst[kk*ld + n].
// Consecutive threads walk the operand's contiguous axis, and every load of
// the stage is issued before the first store: one memory latency per stage.
template <int DEPTH, bool TRANSPOSED, int NTHREADS, typename T, typename D>
__device__ __forceinline__ void stage_weights(D* dst, int ld,
                                              const T* __restrict__ Bg,
                                              long bsk, long bsn, int k0,
                                              int kvalid, int n0,
                                              int nvalid) {
  constexpr int NJ = DEPTH * NB / NTHREADS;
  static_assert(DEPTH * NB % NTHREADS == 0, "stage must split evenly");
  const bool along_n = bsn == 1;
  T v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int kk = along_n ? i / NB : i % DEPTH;
    const int n = along_n ? i % NB : i / DEPTH;
    const int k = k0 + kk, nn = n0 + n;
    v[j] = (k < kvalid && nn < nvalid) ? Bg[k * bsk + nn * bsn]
                                       : zero_of<T>();
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int kk = along_n ? i / NB : i % DEPTH;
    const int n = along_n ? i % NB : i / DEPTH;
    put(dst + (TRANSPOSED ? n * ld + kk : kk * ld + n), v[j]);
  }
}

// G1[r] = rnd([H1[r] > 0] * sum_{c routed to t0 + r} scale[c] * emb_w^T[c])
// for rows r < rows (zero for t >= n_t), columns < round_up(C, 16). One warp
// per row; channels in ascending order (deterministic). g1 may alias h1:
// each lane reads and writes only its own columns.
template <int NTHREADS, typename T, typename E>
__device__ void gather_g1(const E* h1, E* g1, int ld, int rows, int t0,
                          int n_t, int C, int C2, const unsigned* mask,
                          const float* scale, const T* __restrict__ embwT) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldc = round_up(C, 16);
  for (int r = warp; r < rows; r += NTHREADS / 32) {
    const int t = t0 + r;
    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
    if (t < n_t) {
      const unsigned bit = 1u << (t & 31);
      for (int cb = 0; cb < C2; cb += 32) {
        const int c = cb + lane;
        const bool on = c < C2 && (mask[c * MW + (t >> 5)] & bit) &&
                        scale[c] != 0.f;
        unsigned bal = __ballot_sync(0xffffffffu, on);
        while (bal) {
          const int cc = cb + __ffs(bal) - 1;
          bal &= bal - 1;
          const float sc = scale[cc];
          const T* row = embwT + (size_t)cc * C;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int j = lane + 32 * q;
            if (j < C) acc[q] = fmaf(sc, to_f(row[j]), acc[q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int j = lane + 32 * q;
      if (j < ldc) {
        const bool live = j < C && to_f(h1[r * ld + j]) > 0.f;
        put(g1 + r * ld + j, live ? rnd<T>(acc[q]) : 0.f);
      }
    }
  }
}

// col2im of one row tile: dx_flat[t*V + j] += dP[t - t0, j] for t0 <= t <
// t_end, rows added in order (deterministic)
template <int NTHREADS>
__device__ void col2im_rows(float* dxs, const float* dp, int ldp, int t0,
                            int t_end, int V, int KV) {
  const int f_lo = t0 * V, f_hi = (t_end - 1) * V + KV;
  for (int f = f_lo + threadIdx.x; f < f_hi; f += NTHREADS) {
    float acc = 0.f;
    for (int t = t0; t < t_end; ++t) {
      const int j = f - t * V;
      if (j >= 0 && j < KV) acc += dp[(t - t0) * ldp + j];
    }
    dxs[f] += acc;
  }
}

// pred_m = sum_c mx * dec_w + dec_b (fixed-order block reduction) and the
// routed gradient per channel (relu' of H2 folds in as mx > 0). Expects the
// routed-row bitmask complete; for "first" it becomes the first row only.
template <int NTHREADS, typename T>
__device__ void finish_pool(const Args a, int b, int m, const float* mx,
                            const int* first, unsigned* mask, float* scale,
                            float* red) {
  const T* decw = static_cast<const T*>(a.decw) + (size_t)m * a.C2;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int c = tid; c < a.C2; c += NTHREADS) {
    const float d = to_f(decw[c]);
    s += mx[c] * d;
    int cnt = 0;
    if (a.pool_first) {
      for (int w = 0; w < MW; ++w) mask[c * MW + w] = 0u;
      mask[c * MW + (first[c] >> 5)] = 1u << (first[c] & 31);
      cnt = 1;
    } else {
      for (int w = 0; w < MW; ++w) cnt += __popc(mask[c * MW + w]);
    }
    scale[c] = mx[c] > 0.f ? rnd<T>(d / (float)cnt) : 0.f;
  }
  red[tid] = s;
  __syncthreads();
  for (int w = NTHREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) a.pred[(size_t)m * a.B + b] = red[0] + a.decb[m];
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, one 256-row tile per sample
// ---------------------------------------------------------------------------
namespace tc {

constexpr int THREADS = 512;  // 16 warps
constexpr int BKS = 32;       // depth of one weight stage
constexpr int KPS = BKS + 8;  // bf16 row stride of the staged weights
constexpr int DPR = 64;       // rows of one dP tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = A[rows, :kpad] @ Bm(:, n0 : n0 + NB): warp w owns rows
// (w / WN) * MT * 16 + [0, MT * 16) and columns
// (w % WN) * NT * 8 + [0, NT * 8) of the output tile. A is bf16 in shared
// memory (row stride lda, even); Bm(k, n) = Bg[k*bsk + n*bsn] (zero beyond
// kvalid / nvalid) is staged BKS deep into ws.
template <int MT, int NT, int WN>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4],
                                     const __nv_bfloat16* A, int lda,
                                     int kpad,
                                     const __nv_bfloat16* __restrict__ Bg,
                                     long bsk, long bsn, int kvalid, int n0,
                                     int nvalid, __nv_bfloat16* ws) {
  static_assert(WN * NT * 8 == NB, "a tile spans NB columns");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int k0 = 0; k0 < kpad; k0 += BKS) {
    stage_weights<BKS, true, THREADS>(ws, KPS, Bg, bsk, bsn, k0, kvalid, n0,
                                      nvalid);
    __syncthreads();
    const int ks_end = min(BKS, kpad - k0);  // kpad is a multiple of 16
    for (int ks = 0; ks < ks_end; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const __nv_bfloat16* p =
            A + (wm * MT * 16 + mi * 16 + g) * lda + k0 + ks + tig * 2;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * lda);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * lda + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const __nv_bfloat16* q =
            ws + (wn * NT * 8 + ni * 8 + g) * KPS + ks + tig * 2;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }
}

// Shared-memory layout in bytes (16-byte aligned pieces).
struct Layout {
  int xs_len, ldh, xs, h1, ws, dxs, dp, mx, scale, first, mask, pmax, red,
      total;
  __host__ __device__ Layout(int L, int V, int K, int C, int C2) {
    const int KVp = round_up(K * V, 16);
    ldh = round_up(C, 16) + 8;  // conflict-free fragment loads
    xs_len = round_up((MAXT - 1) * V + KVp, 8);
    xs = 0;                                        // x (bf16), zero-padded
    h1 = xs + xs_len * 2;                          // H1, then G1 [MAXT, ldh]
    ws = h1 + MAXT * ldh * 2;                      // weights [NB, KPS]
    dxs = ws + NB * KPS * 2;                       // dx (f32) [L*V]
    dp = dxs + round_up(L * V, 4) * 4;             // dP tile [DPR, K*V]
    mx = dp + DPR * round_up(K * V, 4) * 4;        // per channel: max,
    scale = mx + round_up(C2, 4) * 4;              //   routed gradient,
    first = scale + round_up(C2, 4) * 4;           //   first row,
    mask = first + round_up(C2, 4) * 4;            //   routed-row bitmask
    pmax = mask + C2 * MW * 4;                     // per-warp column maxima
    red = pmax + (THREADS / 32 / 2) * NB * 4;      // block reduction
    total = red + THREADS * 4;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
fit_grad_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a.L, a.V, a.K, a.C, a.C2);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  bf16* h1 = reinterpret_cast<bf16*>(smem + lay.h1);
  bf16* ws = reinterpret_cast<bf16*>(smem + lay.ws);
  float* dxs = reinterpret_cast<float*>(smem + lay.dxs);
  float* dp = reinterpret_cast<float*>(smem + lay.dp);
  float* mx = reinterpret_cast<float*>(smem + lay.mx);
  float* scale = reinterpret_cast<float*>(smem + lay.scale);
  int* first = reinterpret_cast<int*>(smem + lay.first);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + lay.mask);
  float* pmax = reinterpret_cast<float*>(smem + lay.pmax);
  float* red = reinterpret_cast<float*>(smem + lay.red);

  const int b = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane >> 2, tig = lane & 3;
  const int n_t = a.L - a.K + 1, LV = a.L * a.V, KV = a.K * a.V;
  const int ldc = round_up(a.C, 16), ldh = lay.ldh;
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)b * LV;
  const bf16* encw = static_cast<const bf16*>(a.encw) + (size_t)m * KV * a.C;
  const bf16* embw = static_cast<const bf16*>(a.embw) + (size_t)m * a.C * a.C2;
  const bf16* embwT =
      static_cast<const bf16*>(a.embwT) + (size_t)m * a.C2 * a.C;
  const float* encb = a.encb + (size_t)m * a.C;
  const float* embb = a.embb + (size_t)m * a.C2;

  for (int i = tid; i < lay.xs_len; i += THREADS)
    xs[i] = i < LV ? x[i] : zero_of<bf16>();
  for (int i = tid; i < LV; i += THREADS) dxs[i] = 0.f;
  for (int c = tid; c < a.C2; c += THREADS) first[c] = INT_MAX;
  for (int i = tid; i < a.C2 * MW; i += THREADS) mask[i] = 0u;
  __syncthreads();

  // H1 for all MAXT rows (rows t >= T read zero patches; never pooled)
  constexpr int WN = 2, MT = 2, NT = 8;  // 8 x 2 warps of 32 x 64
  const int wm = warp / WN, wn = warp % WN;
  for (int n0 = 0; n0 < ldc; n0 += NB) {
    float acc[MT][NT][4];
    gemm<MT, NT, WN>(acc, xs, a.V, round_up(KV, 16), encw, a.C, 1, KV, n0,
                     a.C, ws);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 32 + mi * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn * 64 + ni * 8 + tig * 2 + (e & 1);
          if (c < ldh) {
            const float v =
                c < a.C ? rnd<bf16>(fmaxf(acc[mi][ni][e] + encb[c], 0.f))
                        : 0.f;
            h1[r * ldh + c] = __float2bfloat16(v);
          }
        }
  }
  __syncthreads();

  // H2 in column chunks, reduced to column maxima from the accumulators;
  // then every row that reaches its column's max marks the bitmask
  for (int c0 = 0; c0 < a.C2; c0 += NB) {
    float acc[MT][NT][4];
    gemm<MT, NT, WN>(acc, h1, ldh, ldc, embw, a.C2, 1, a.C, c0, a.C2, ws);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 64 + ni * 8 + tig * 2 + j, c = c0 + col;
        float best = -1.f;  // below every relu output
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = wm * 32 + mi * 16 + g + hf * 8;
            float v = -1.f;
            if (r < n_t && c < a.C2)
              v = rnd<bf16>(fmaxf(acc[mi][ni][hf * 2 + j] + embb[c], 0.f));
            acc[mi][ni][hf * 2 + j] = v;
            best = fmaxf(best, v);
          }
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 4));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 8));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
        if (g == 0) pmax[wm * NB + col] = best;
      }
    __syncthreads();
    if (tid < NB && c0 + tid < a.C2) {
      float best = -1.f;
      for (int w = 0; w < THREADS / 32 / WN; ++w)
        best = fmaxf(best, pmax[w * NB + tid]);
      mx[c0 + tid] = best;
    }
    __syncthreads();
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + wn * 64 + ni * 8 + tig * 2 + j;
        if (c >= a.C2) continue;
        const float best = mx[c];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = wm * 32 + mi * 16 + g + hf * 8;
            if (acc[mi][ni][hf * 2 + j] == best) {  // invalid rows hold -1
              atomicOr(&mask[c * MW + (r >> 5)], 1u << (r & 31));
              atomicMin(&first[c], r);
            }
          }
      }
    __syncthreads();
  }

  finish_pool<THREADS, bf16>(a, b, m, mx, first, mask, scale, red);
  __syncthreads();

  // G1 over H1, in place
  gather_g1<THREADS>(h1, h1, ldh, MAXT, 0, n_t, a.C, a.C2, mask, scale,
                     embwT);
  __syncthreads();

  // dP = G1 @ enc_w^T (enc_w^T(k = c, n = j) = enc_w[j*C + c]) and col2im,
  // DPR rows at a time; 4 x 4 warps of 16 x 32
  const int ldp = round_up(KV, 4);
  for (int r0 = 0; r0 < n_t; r0 += DPR) {
    float acc[1][4][4];
    gemm<1, 4, 4>(acc, h1 + r0 * ldh, ldh, ldc, encw, 1, a.C, a.C, 0, KV,
                  ws);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (warp / 4) * 16 + g + (e >> 1) * 8;
        const int j = (warp % 4) * 32 + ni * 8 + tig * 2 + (e & 1);
        if (j < KV) dp[r * ldp + j] = acc[0][ni][e];
      }
    __syncthreads();
    col2im_rows<THREADS>(dxs, dp, ldp, r0, min(r0 + DPR, n_t), a.V, KV);
    __syncthreads();
  }
  float* out = a.dxm + ((size_t)m * a.B + b) * LV;
  for (int i = tid; i < LV; i += THREADS) out[i] = dxs[i];
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: FMAs over 64-row tiles, two passes
// ---------------------------------------------------------------------------
namespace simt {

constexpr int R = 64;        // rows (window positions t) per tile
constexpr int TM = R / 16;   // rows per thread
constexpr int TN = NB / 16;  // columns per thread
constexpr int BK = 16;       // depth of one weight stage
constexpr int THREADS = 256;

// Shared-memory layout (float32 words).
struct Layout {
  int xs, dxs, h1, g1, buf, ws, stats, mask, red, total;
  __host__ __device__ Layout(int L, int V, int K, int C, int C2) {
    const int T = L - K + 1, Tp = round_up(T, R), KVp = round_up(K * V, BK);
    const int ldc = round_up(C, BK);
    xs = 0;                                   // x, zero-padded
    dxs = xs + round_up((Tp - 1) * V + KVp, 4);
    h1 = dxs + round_up(L * V, 4);            // H1 tile   [R, ldc]
    g1 = h1 + R * ldc;                        // G1 tile   [R, ldc]
    buf = g1 + R * ldc;                       // H2/dP     [R, NB]
    ws = buf + R * NB;                        // weights   [BK, NB]
    stats = ws + BK * NB;                     // mx, scale, first
    mask = stats + 3 * round_up(C2, 4);       // routed-row bitmask
    red = mask + C2 * MW;                     // block reduction [THREADS]
    total = red + THREADS;
  }
};

// out[r, n] (+)= sum_k A[r*lda + k] * Bm(k, n0 + n), r < R, n < ncols.
// Bm(k, n) = Bg[k*bsk + n*bsn] for k < kvalid and n < nvalid, else 0.
// A must be readable (and finite) for k < kpad (a multiple of BK).
__device__ void gemm_tile(float* out, int ldo, int ncols, bool accumulate,
                          const float* A, int lda, int kpad,
                          const float* __restrict__ Bg, long bsk, long bsn,
                          int kvalid, int n0, int nvalid, float* Ws) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kpad; k0 += BK) {
    stage_weights<BK, false, THREADS>(Ws, NB, Bg, bsk, bsn, k0, kvalid, n0,
                                      nvalid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk * NB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (n < ncols) {
        float* o = out + (ty + 16 * i) * ldo + n;
        *o = accumulate ? *o + acc[i][j] : acc[i][j];
      }
    }
  __syncthreads();
}

// H1 tile for rows t0 .. t0+R-1: h1[r, c] = relu(P[t0+r] @ enc_w + b)
__device__ void h1_tile(float* sm, const Layout lay, const Args a, int m,
                        int t0) {
  const int KV = a.K * a.V, ldc = round_up(a.C, BK);
  const float* encw = static_cast<const float*>(a.encw) + (size_t)m * KV * a.C;
  float* h1 = sm + lay.h1;
  for (int n0 = 0; n0 < ldc; n0 += NB)
    gemm_tile(h1 + n0, ldc, min(NB, ldc - n0), false,
              sm + lay.xs + t0 * a.V, a.V, round_up(KV, BK), encw, a.C, 1,
              KV, n0, a.C, sm + lay.ws);
  const float* b = a.encb + (size_t)m * a.C;
  for (int i = threadIdx.x; i < R * ldc; i += THREADS) {
    const int c = i % ldc;
    h1[i] = c < a.C ? fmaxf(h1[i] + b[c], 0.f) : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
fit_grad_kernel(const Args a) {
  extern __shared__ float sm[];
  const Layout lay(a.L, a.V, a.K, a.C, a.C2);
  const int b = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int n_t = a.L - a.K + 1, LV = a.L * a.V, KV = a.K * a.V;
  const int ldc = round_up(a.C, BK);
  const float* x = static_cast<const float*>(a.x) + (size_t)b * LV;
  const float* embw =
      static_cast<const float*>(a.embw) + (size_t)m * a.C * a.C2;
  const float* embwT =
      static_cast<const float*>(a.embwT) + (size_t)m * a.C2 * a.C;
  const float* encw = static_cast<const float*>(a.encw) + (size_t)m * KV * a.C;
  const float* embb = a.embb + (size_t)m * a.C2;

  float* xs = sm + lay.xs;
  float* dxs = sm + lay.dxs;
  float* buf = sm + lay.buf;
  float* g1 = sm + lay.g1;
  float* h1 = sm + lay.h1;
  float* mx = sm + lay.stats;
  float* scale = mx + round_up(a.C2, 4);
  int* first = reinterpret_cast<int*>(scale + round_up(a.C2, 4));
  unsigned* mask = reinterpret_cast<unsigned*>(sm + lay.mask);

  for (int i = tid; i < lay.dxs - lay.xs; i += THREADS)
    xs[i] = i < LV ? x[i] : 0.f;
  for (int i = tid; i < LV; i += THREADS) dxs[i] = 0.f;
  for (int c = tid; c < a.C2; c += THREADS) {
    mx[c] = -1.f;  // below every relu output
    first[c] = 0;
  }
  for (int i = tid; i < a.C2 * MW; i += THREADS) mask[i] = 0u;
  __syncthreads();

  // ---- pass 1: per-channel max over t < T, first argmax and the tied
  // rows, kept as a bitmask over t ----
  for (int t0 = 0; t0 < n_t; t0 += R) {
    h1_tile(sm, lay, a, m, t0);
    for (int c0 = 0; c0 < a.C2; c0 += NB) {
      gemm_tile(buf, NB, NB, false, h1, ldc, ldc, embw, a.C2, 1, a.C, c0,
                a.C2, sm + lay.ws);
      for (int i = tid; i < R * NB; i += THREADS) {
        const int c = c0 + i % NB;
        buf[i] = c < a.C2 ? fmaxf(buf[i] + embb[c], 0.f) : 0.f;
      }
      __syncthreads();
      const int c = c0 + tid;
      if (tid < NB && c < a.C2) {
        float best = mx[c];
        int fr = first[c];
        unsigned* mc = mask + c * MW;
        for (int r = 0; r < R && t0 + r < n_t; ++r) {
          const int t = t0 + r;
          const float v = buf[r * NB + tid];
          if (v > best) {
            best = v;
            fr = t;
            for (int w = 0; w < MW; ++w) mc[w] = 0u;
            mc[t >> 5] = 1u << (t & 31);
          } else if (v == best) {
            mc[t >> 5] |= 1u << (t & 31);
          }
        }
        mx[c] = best;
        first[c] = fr;
      }
      __syncthreads();
    }
  }

  finish_pool<THREADS, float>(a, b, m, mx, first, mask, scale,
                              sm + lay.red);
  __syncthreads();

  // ---- pass 2: H1 again, then the input gradient ----
  for (int t0 = 0; t0 < n_t; t0 += R) {
    h1_tile(sm, lay, a, m, t0);
    gather_g1<THREADS>(h1, g1, ldc, R, t0, n_t, a.C, a.C2, mask, scale,
                       embwT);
    __syncthreads();
    // dP = G1 @ enc_w^T  (enc_w^T(k = c, n = j) = enc_w[j*C + c]) into buf
    gemm_tile(buf, NB, KV, false, g1, ldc, ldc, encw, 1, a.C, a.C, 0, KV,
              sm + lay.ws);
    col2im_rows<THREADS>(dxs, buf, NB, t0, min(t0 + R, n_t), a.V, KV);
    __syncthreads();
  }
  float* out = a.dxm + ((size_t)m * a.B + b) * LV;
  for (int i = tid; i < LV; i += THREADS) out[i] = dxs[i];
}

}  // namespace simt

// fit = mean_m pred, dx = sum_m dxm / M, members added in order
__global__ void cnn_member_reduce(const float* __restrict__ pred,
                                  const float* __restrict__ dxm,
                                  float* __restrict__ fit,
                                  float* __restrict__ dx, int M, int B,
                                  long n) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const float inv_m = 1.f / (float)M;
  if (i < n) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += dxm[m * n + i] * inv_m;
    dx[i] = s;
  }
  if (i < B) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += pred[(size_t)m * B + i] * inv_m;
    fit[i] = s;
  }
}

size_t smem_bytes(int L, int V, int K, int C, int C2, int dtype) {
  if (dtype == 1) return (size_t)tc::Layout(L, V, K, C, C2).total;
  return (size_t)simt::Layout(L, V, K, C, C2).total * sizeof(float);
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, Args a, float* fit,
           float* dx, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.B, a.M), threads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n = (long)a.B * a.L * a.V;
  const long work = n > a.B ? n : a.B;
  cnn_member_reduce<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      a.pred, a.dxm, fit, dx, a.M, a.B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for dtype (0 = float32,
// 1 = bfloat16); the wrapper checks it against the card's 227 KB.
long cnn_smem_bytes(int L, int V, int K, int C, int C2, int dtype) {
  return (long)smem_bytes(L, V, K, C, C2, dtype);
}

// Limits: K*V (the dP tile's width), C (conv channels), T = L-K+1.
int cnn_max_kv() { return NB; }
int cnn_max_c() { return 32 * CPL; }
int cnn_max_t() { return MAXT; }

// dtype: 0 = float32, 1 = bfloat16 (x, enc_w, emb_w, emb_w^T, dec_w);
// biases float32. Returns a cudaError_t.
int cnn_ensemble_fit_and_grad(const void* x, const void* encw,
                              const void* encb, const void* embw,
                              const void* embwT, const void* embb,
                              const void* decw, const void* decb, void* pred,
                              void* dxm, void* fit, void* dx, int B, int L,
                              int V, int K, int C, int C2, int M,
                              int pool_first, int dtype, void* stream) {
  if (B <= 0 || M <= 0 || L < K || K * V > NB || C > 32 * CPL ||
      L - K + 1 > MAXT || V % 2 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,
         encw,
         static_cast<const float*>(encb),
         embw,
         embwT,
         static_cast<const float*>(embb),
         decw,
         static_cast<const float*>(decb),
         static_cast<float*>(pred),
         static_cast<float*>(dxm),
         B, L, V, K, C, C2, M, pool_first};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(fit);
  float* d = static_cast<float*>(dx);
  const size_t smem = smem_bytes(L, V, K, C, C2, dtype);
  if (dtype == 1)
    return launch(tc::fit_grad_kernel, tc::THREADS, smem, a, f, d, s);
  return launch(simt::fit_grad_kernel, simt::THREADS, smem, a, f, d, s);
}

}  // extern "C"
