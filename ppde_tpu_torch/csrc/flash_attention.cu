// Kernels C and C': attention forward and backward for the ESM2 experts, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels ppde_tpu/ops/attention_pallas.py:_fwd_call
// (_fwd_kernel) and :_bwd_call (_bwd_kernel). For q, k, v [Z, T, hd]
// (Z = batch * heads; q already scaled; no mask; float32 or bfloat16):
//
//     s   = q k^T                          [T, T]  float32
//     w32 = softmax(s) (row max subtracted, e * (1 / sum))   float32
//     o   = cast(w32) v                    [T, hd] input type
//
// and for dout [Z, T, hd], recomputing w32 from q and k:
//
//     dw = dout v^T,  delta = rowsum(w32 * dw),  ds = cast(w32 * (dw - delta))
//     dq = ds k,      dk = ds^T q,               dv = cast(w32)^T dout
//
// Every product sums in float32; "cast" rounds to the input type (bfloat16
// products run on mma.sync.m16n8k16, float32 products on FMAs in full
// float32).
//
// What bounds them on the H100: at ESM2's head widths (hd 24 to 64) and
// protein lengths (T of a few hundred) the bytes are small (4 Z T hd
// elements forward, 7 backward) and so are the operations (4 Z T^2 hd
// forward, 10 backward): at Z = 2560, T = 237, hd = 24 in bf16 the card
// could do the forward in about 35 us and the backward in 61 us, both set
// by the bytes. The [Z, T, T] scores, which a plain version writes and reads
// several times, never leave the chip.
//
// Design. The TPU kernel holds a whole [T, T] float32 score block on chip;
// 225 KB at T = 237 does not fit a block's 227 KB of shared memory. The thin
// side is small, so a block holds 64 rows of the scores against ALL T
// columns, [64, T] float32 (up to T = 512: 133 KB). That keeps the TPU
// kernel's arithmetic exactly (normalise in float32, then cast, then the
// product) with no online softmax. Thin operands are staged through shared
// memory, zero-padded to a head width of 16, 32 or 64 (hd must be a multiple
// of 8, so that every global load is 16 bytes) and to a multiple of 64 rows;
// padded key columns are left out of the row max and sum and get weight 0.
// Nothing is padded or transposed in device memory: the kernels read q, k,
// v, dout [Z, T, hd] as they are. A block waits on global memory, not on
// arithmetic (8 mma per warp and tile), so a round stages up to 256 rows in
// bf16 with all its loads in flight before the first store (T = 237 is one
// round per product), and delta and ds are formed on the accumulators of
// dout v^T, which never goes through shared memory.
//
// dk and dv sum over query rows and dq over key rows. Blocks run in no
// order and atomics would change the sum's order from run to run, so the
// backward is two kernels: attn_bwd_dq owns 64 query rows (softmax by rows,
// delta, ds, dq) and writes each row's max, sum and delta to a [Z, 3, T]
// scratch; attn_bwd_dkdv owns 64 key rows against all queries, i.e. a
// [64, T] block of the TRANSPOSED scores, rebuilds w32 and ds from that
// scratch, and writes dv and dk. Every output element is written once by one
// block with a fixed order of sums: results repeat bit for bit.
// wgmma, TMA and register-resident scores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // score rows per block
constexpr int BN = 64;        // score columns per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int T_MAX = 512;    // [64, T] float32 scores + tiles fit 227 KB

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
// elements of a 16-byte chunk, the unit of every global load
template <typename T>
constexpr int kVec = 16 / sizeof(T);
// rows of a thin operand staged per round (between two barriers)
template <typename T>
constexpr int kR = kBf16<T> ? 256 : 64;
// row stride of a staged [rows, HDP] thin tile: bf16 rows stay 16-byte
// aligned and conflict-free for the mma fragments, float32 rows get an odd
// stride
template <typename T, int HDP>
constexpr int kAP = kBf16<T> ? HDP + 8 : HDP + 1;
// row stride of a transposed bf16 tile [HDP, kR]
constexpr int BTP = kR<__nv_bfloat16> + 8;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two float32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// A block's shared memory: S [BM, SP] float32 scores / weights / ds; stat
// 3 * Tp floats (row or column max, sum, delta); red 2 * BM floats (partial
// row sums); two resident thin tiles A1, A2 [BM, kAP]; one staging buffer B
// of kR rows.
template <typename T, int HDP>
struct Tiles {
  float* S;
  float* stat;
  float* red;
  T* A1;
  T* A2;
  T* B;
  int Tp, SP;
  __device__ Tiles(unsigned char* base, int Tn) {
    Tp = (Tn + BN - 1) / BN * BN;
    SP = Tp + 8;
    S = reinterpret_cast<float*>(base);
    stat = S + BM * SP;
    red = stat + 3 * Tp;
    A1 = reinterpret_cast<T*>(red + 2 * BM);
    A2 = A1 + BM * kAP<T, HDP>;
    B = A2 + BM * kAP<T, HDP>;
  }
};

template <typename T, int HDP>
size_t smem_bytes(int Tn) {
  const int Tp = (Tn + BN - 1) / BN * BN;
  return (size_t)(BM * (Tp + 8) + 3 * Tp + 2 * BM) * sizeof(float) +
         (size_t)(2 * BM + kR<T>) * kAP<T, HDP> * sizeof(T);
}

// Stage ROWS rows t0 .. of src [Tn, hd] (hd a multiple of 8), zero beyond Tn
// and hd, by 16-byte loads: a batch of loads is started before its stores, so
// their latencies overlap. TRANSPOSED = false: dst [ROWS, STRIDE] as src
// lies; true (bf16): dst [HDP, STRIDE] with dst[d][t], the lanes along t so
// that neighbouring lanes store neighbouring halves of a word.
template <typename T, int HDP, int ROWS, int STRIDE, bool TRANSPOSED>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int t0, int Tn, int hd) {
  constexpr int V = kVec<T>;
  constexpr int CPR = HDP / V;  // chunks per padded row
  constexpr int TOTAL = ROWS * CPR;
  constexpr int PER = (TOTAL + THREADS - 1) / THREADS;
  constexpr int BATCH = PER < 4 ? PER : 4;
  static_assert(PER % BATCH == 0, "chunks per thread in whole batches");
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    uint4 regs[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (b0 + j) * THREADS;
      const int r = TRANSPOSED ? i % ROWS : i / CPR;
      const int c = TRANSPOSED ? i / ROWS : i % CPR;
      regs[j] = (i < TOTAL && t0 + r < Tn && c * V < hd)
                    ? *reinterpret_cast<const uint4*>(
                          src + (size_t)(t0 + r) * hd + c * V)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (b0 + j) * THREADS;
      if (i >= TOTAL) continue;
      const int r = TRANSPOSED ? i % ROWS : i / CPR;
      const int c = TRANSPOSED ? i / ROWS : i % CPR;
      const T* e = reinterpret_cast<const T*>(&regs[j]);
      if constexpr (TRANSPOSED) {
#pragma unroll
        for (int x = 0; x < V; ++x) dst[(c * V + x) * STRIDE + r] = e[x];
      } else if constexpr (kBf16<T>) {
        *reinterpret_cast<uint4*>(dst + r * STRIDE + c * V) = regs[j];
      } else {
#pragma unroll
        for (int x = 0; x < V; ++x) dst[r * STRIDE + c * V + x] = e[x];
      }
    }
  }
}

// One [64, 64] tile of A [64, HDP] * B [64, HDP]^T (both staged thin tiles,
// float32 sums); f(li, r, c, value) is called once per element by the thread
// that owns it, li counting the thread's own rows. The same thread owns the
// same element in every call, so an f that updates S in place needs no
// barrier between calls.
template <typename T, int HDP, typename F>
__device__ __forceinline__ void score_tile(const T* A, const T* B, F f) {
  constexpr int AP = kAP<T, HDP>;
  if constexpr (kBf16<T>) {
    // 8 warps as 4 (16-row blocks) x 2 (32-column halves)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3, wm = warp & 3, wn = warp >> 2;
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    const __nv_bfloat16* a_row = A + (wm * 16 + g) * AP + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < HDP; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(a_row + kk);
      a[1] = ld32(a_row + 8 * AP + kk);
      a[2] = ld32(a_row + kk + 8);
      a[3] = ld32(a_row + 8 * AP + kk + 8);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* b_row =
            B + (wn * 32 + ni * 8 + g) * AP + kk + 2 * tig;
        mma_bf16(acc[ni], a, ld32(b_row), ld32(b_row + 8));
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(e >> 1, wm * 16 + g + (e >> 1) * 8,
          wn * 32 + ni * 8 + 2 * tig + (e & 1), acc[ni][e]);
  } else {
    // 16 x 16 threads, each 4 x 4 outputs
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * AP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * AP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(i, ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
}

// Rows a thread owns in score_tile, and the sum over a row's columns of the
// threads' partial sums part[li], in a fixed order: lanes by an xor tree,
// then (bf16) the two column halves through red.
template <typename T>
constexpr int kOwnRows = kBf16<T> ? 2 : 4;

template <typename T>
__device__ __forceinline__ void reduce_rows(const float* part, float* red,
                                            float* out) {
  if constexpr (kBf16<T>) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3, wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int li = 0; li < 2; ++li) {
      float v = part[li];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) red[wn * BM + wm * 16 + g + 8 * li] = v;
    }
    __syncthreads();
    if (threadIdx.x < BM)
      out[threadIdx.x] = red[threadIdx.x] + red[BM + threadIdx.x];
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      float v = part[li];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tx == 0) out[ty + 16 * li] = v;
    }
  }
  __syncthreads();
}

// All column tiles of A [64, HDP] * cols [Tn, hd]^T: cols is staged kR rows
// per round, f(li, r, col, value) sees every element of the [64, Tp] block.
// staged = true: the call before this one staged the same cols and nothing
// has written B since, so a single round's rows are still there.
template <typename T, int HDP, typename F>
__device__ __forceinline__ void scores(const Tiles<T, HDP>& s, const T* A,
                                       const T* __restrict__ cols, int Tn,
                                       int hd, F f, bool staged = false) {
  constexpr int AP = kAP<T, HDP>;
  staged = staged && s.Tp <= kR<T>;
  for (int c0 = 0; c0 < s.Tp; c0 += kR<T>) {
    __syncthreads();
    if (!staged) stage<T, HDP, kR<T>, AP, false>(s.B, cols, c0, Tn, hd);
    __syncthreads();
    for (int t = 0; t < kR<T> && c0 + t < s.Tp; t += BN)
      score_tile<T, HDP>(A, s.B + t * AP,
                         [&](int li, int r, int c, float v) {
                           f(li, r, c0 + t + c, v);
                         });
  }
  __syncthreads();
}

// exp for the softmax: ex2.approx in bf16 (its error is far below the
// rounding of the weights to bf16), the accurate expf in float32
template <typename T>
__device__ __forceinline__ float exp_t(float x) {
  if constexpr (kBf16<T>)
    return __expf(x);
  else
    return expf(x);
}

// Rows of S [64, Tp] -> softmax over the first Tn columns, in float32 with
// the row max subtracted and e * (1 / sum); columns Tn .. Tp-1 become 0. A
// warp holds one row in registers (T_MAX / 32 values a lane): one read, one
// write. Optionally keeps each row's max in m_out[r] and sum in l_out[r].
template <typename T>
__device__ __forceinline__ void softmax_rows(float* S, int SP, int Tn, int Tp,
                                             float* m_out, float* l_out) {
  constexpr int PER = T_MAX / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BM; r += WARPS) {
    float* row = S + r * SP;
    float vals[PER];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = lane + 32 * i;
      vals[i] = j < Tn ? row[j] : -CUDART_INF_F;
      m = fmaxf(m, vals[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      vals[i] = lane + 32 * i < Tn ? exp_t<T>(vals[i] - m) : 0.f;
      sum += vals[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = lane + 32 * i;
      if (j < Tp) row[j] = vals[i] * inv;
    }
    if (m_out != nullptr && lane == 0) {
      m_out[r] = m;
      l_out[r] = sum;
    }
  }
  __syncthreads();
}

// dst rows row0 .. row0+63 of [Tn, hd] = cast(S [64, Tp]) * src [Tn, hd],
// float32 sums, the result cast to T. src is staged kR rows per round:
// transposed for the bf16 mma (its B fragment pairs values along the summed
// index), as it lies for the float32 FMAs.
template <typename T, int HDP>
__device__ __forceinline__ void out_product(const Tiles<T, HDP>& s,
                                            const T* __restrict__ src, int Tn,
                                            int hd, T* __restrict__ dst,
                                            int row0) {
  if constexpr (kBf16<T>) {
    constexpr int NT = HDP / 16;  // 8-column tiles per warp (two warps a row)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3, wm = warp & 3, wn = warp >> 2;
    float acc[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    for (int k0 = 0; k0 < s.Tp; k0 += kR<T>) {
      __syncthreads();
      stage<T, HDP, kR<T>, BTP, true>(s.B, src, k0, Tn, hd);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kR<T> && k0 + kk < s.Tp; kk += 16) {
        const float* s0 = s.S + (wm * 16 + g) * s.SP + k0 + kk + 2 * tig;
        const float2 v0 = *reinterpret_cast<const float2*>(s0);
        const float2 v1 = *reinterpret_cast<const float2*>(s0 + 8 * s.SP);
        const float2 v2 = *reinterpret_cast<const float2*>(s0 + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(s0 + 8 * s.SP + 8);
        uint32_t a[4];
        a[0] = pack_bf16(v0.x, v0.y);
        a[1] = pack_bf16(v1.x, v1.y);
        a[2] = pack_bf16(v2.x, v2.y);
        a[3] = pack_bf16(v3.x, v3.y);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const __nv_bfloat16* b_row =
              s.B + ((wn * NT + ni) * 8 + g) * BTP + kk + 2 * tig;
          mma_bf16(acc[ni], a, ld32(b_row), ld32(b_row + 8));
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 16 + g + (e >> 1) * 8;
        const int c = (wn * NT + ni) * 8 + 2 * tig + (e & 1);
        if (r < Tn && c < hd)
          dst[(size_t)r * hd + c] = __float2bfloat16_rn(acc[ni][e]);
      }
  } else {
    constexpr int NJ = HDP / 16;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < s.Tp; k0 += kR<T>) {
      __syncthreads();
      stage<T, HDP, kR<T>, HDP, false>(s.B, src, k0, Tn, hd);
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < kR<T>; ++t) {
        float a[4], b[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s.S[(ty + 16 * i) * s.SP + k0 + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = s.B[t * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = row0 + ty + 16 * i, c = tx + 16 * j;
        if (r < Tn && c < hd) dst[(size_t)r * hd + c] = acc[i][j];
      }
  }
}

// Kernel C. Block (query tile, z): o rows = cast(softmax(q k^T)) v.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int Tn, int hd,
                int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T, HDP> s(smem, Tn);
  constexpr int AP = kAP<T, HDP>;
  const int z = blockIdx.x / n_tiles, r0 = (blockIdx.x % n_tiles) * BM;
  const size_t off = (size_t)z * Tn * hd;
  stage<T, HDP, BM, AP, false>(s.A1, q + off, r0, Tn, hd);
  scores<T, HDP>(s, s.A1, k + off, Tn, hd,
                 [&](int, int r, int c, float v_) { s.S[r * s.SP + c] = v_; });
  softmax_rows<T>(s.S, s.SP, Tn, s.Tp, nullptr, nullptr);
  out_product<T, HDP>(s, v + off, Tn, hd, o + off, r0);
}

// Kernel C', first half. Block (query tile, z): w32 by rows, delta, ds, dq;
// each row's max, sum and delta go to stats [Z, 3, Tn].
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   T* __restrict__ dq, float* __restrict__ stats, int Tn,
                   int hd, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T, HDP> s(smem, Tn);
  constexpr int AP = kAP<T, HDP>;
  const int z = blockIdx.x / n_tiles, r0 = (blockIdx.x % n_tiles) * BM;
  const size_t off = (size_t)z * Tn * hd;
  float* m_s = s.stat;
  float* l_s = s.stat + BM;
  float* delta_s = s.stat + 2 * BM;
  stage<T, HDP, BM, AP, false>(s.A1, q + off, r0, Tn, hd);
  stage<T, HDP, BM, AP, false>(s.A2, dout + off, r0, Tn, hd);
  scores<T, HDP>(s, s.A1, k + off, Tn, hd,
                 [&](int, int r, int c, float v_) { s.S[r * s.SP + c] = v_; });
  softmax_rows<T>(s.S, s.SP, Tn, s.Tp, m_s, l_s);

  // delta = rowsum(w32 * dw), dw = dout v^T taken from the accumulators
  float part[kOwnRows<T>];
#pragma unroll
  for (int i = 0; i < kOwnRows<T>; ++i) part[i] = 0.f;
  scores<T, HDP>(s, s.A2, v + off, Tn, hd,
                 [&](int li, int r, int c, float dw) {
                   part[li] = fmaf(s.S[r * s.SP + c], dw, part[li]);
                 });
  reduce_rows<T>(part, s.red, delta_s);
  if (threadIdx.x < BM && r0 + threadIdx.x < Tn) {
    float* st = stats + (size_t)z * 3 * Tn + r0 + threadIdx.x;
    st[0] = m_s[threadIdx.x];
    st[Tn] = l_s[threadIdx.x];
    st[2 * Tn] = delta_s[threadIdx.x];
  }

  // ds = w32 * (dw - delta), written over w32 (dw is computed a second time:
  // it is cheaper than keeping a second [64, T] block)
  scores<T, HDP>(s, s.A2, v + off, Tn, hd,
                 [&](int, int r, int c, float dw) {
                   float* w = s.S + r * s.SP + c;
                   *w = *w * (dw - delta_s[r]);
                 },
                 /*staged=*/true);
  out_product<T, HDP>(s, k + off, Tn, hd, dq + off, r0);
}

// Kernel C', second half. Block (key tile, z): the [64 keys, T queries]
// block of the transposed scores; w32 and ds rebuilt from the query rows'
// max, sum and delta; dv = cast(w32)^T dout, dk = cast(ds)^T q.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ stats, int Tn, int hd,
                     int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T, HDP> s(smem, Tn);
  constexpr int AP = kAP<T, HDP>;
  const int z = blockIdx.x / n_tiles, k0 = (blockIdx.x % n_tiles) * BM;
  const size_t off = (size_t)z * Tn * hd;
  float* m_s = s.stat;
  float* inv_l_s = s.stat + s.Tp;
  float* delta_s = s.stat + 2 * s.Tp;
  for (int j = threadIdx.x; j < s.Tp; j += THREADS) {
    const float* st = stats + (size_t)z * 3 * Tn + j;
    m_s[j] = j < Tn ? st[0] : 0.f;
    inv_l_s[j] = j < Tn ? 1.f / st[Tn] : 1.f;
    delta_s[j] = j < Tn ? st[2 * Tn] : 0.f;
  }
  stage<T, HDP, BM, AP, false>(s.A1, k + off, k0, Tn, hd);
  stage<T, HDP, BM, AP, false>(s.A2, v + off, k0, Tn, hd);
  // w32[key, query] = exp(s - max[query]) * (1 / sum[query]); 0 on the
  // padding
  scores<T, HDP>(s, s.A1, q + off, Tn, hd,
                 [&](int, int r, int c, float v_) {
                   s.S[r * s.SP + c] = (c < Tn && k0 + r < Tn)
                                           ? exp_t<T>(v_ - m_s[c]) * inv_l_s[c]
                                           : 0.f;
                 });
  out_product<T, HDP>(s, dout + off, Tn, hd, dv + off, k0);
  // ds[key, query] = w32 * (dw - delta[query]), dw = v dout^T
  scores<T, HDP>(s, s.A2, dout + off, Tn, hd,
                 [&](int, int r, int c, float dw) {
                   float* w = s.S + r * s.SP + c;
                   *w = *w * (dw - delta_s[c]);
                 });
  out_product<T, HDP>(s, q + off, Tn, hd, dk + off, k0);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HDP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int Z,
               int Tn, int hd, cudaStream_t stream) {
  const int n_tiles = (Tn + BM - 1) / BM;
  const size_t bytes = smem_bytes<T, HDP>(Tn);
  cudaError_t err = allow_smem(attn_fwd_kernel<T, HDP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kernel<T, HDP><<<Z * n_tiles, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tn, hd, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* stats, int Z, int Tn,
               int hd, cudaStream_t stream) {
  const int n_tiles = (Tn + BM - 1) / BM;
  const size_t bytes = smem_bytes<T, HDP>(Tn);
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<T, HDP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(attn_bwd_dkdv_kernel<T, HDP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<T, HDP><<<Z * n_tiles, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(stats), Tn, hd, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<T, HDP><<<Z * n_tiles, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(stats), Tn, hd, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int Z, int Tn, int hd) {
  return Z < 1 || Tn < 1 || Tn > T_MAX || hd < 8 || hd > 64 || hd % 8 != 0;
}

}  // namespace

extern "C" {

// The largest T the kernels take.
int flash_attention_max_t() { return T_MAX; }

// o [Z, T, hd] = softmax(q k^T) v. dtype: 0 = float32, 1 = bfloat16 (q, k, v
// and o). Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int Z, int T, int hd, int dtype, void* stream) {
  if (bad_shape(Z, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 16) return launch_fwd<float, 16>(q, k, v, o, Z, T, hd, s);
    if (hd <= 32) return launch_fwd<float, 32>(q, k, v, o, Z, T, hd, s);
    return launch_fwd<float, 64>(q, k, v, o, Z, T, hd, s);
  }
  if (dtype == 1) {
    if (hd <= 16)
      return launch_fwd<__nv_bfloat16, 16>(q, k, v, o, Z, T, hd, s);
    if (hd <= 32)
      return launch_fwd<__nv_bfloat16, 32>(q, k, v, o, Z, T, hd, s);
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, Z, T, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq, dk, dv [Z, T, hd] from q, k, v, dout; stats is a [Z, 3, T] float32
// scratch. dtype as above. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* stats, int Z, int T, int hd, int dtype,
                        void* stream) {
  if (bad_shape(Z, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 16)
      return launch_bwd<float, 16>(q, k, v, dout, dq, dk, dv, stats, Z, T,
                                   hd, s);
    if (hd <= 32)
      return launch_bwd<float, 32>(q, k, v, dout, dq, dk, dv, stats, Z, T,
                                   hd, s);
    return launch_bwd<float, 64>(q, k, v, dout, dq, dk, dv, stats, Z, T, hd,
                                 s);
  }
  if (dtype == 1) {
    if (hd <= 16)
      return launch_bwd<__nv_bfloat16, 16>(q, k, v, dout, dq, dk, dv, stats,
                                           Z, T, hd, s);
    if (hd <= 32)
      return launch_bwd<__nv_bfloat16, 32>(q, k, v, dout, dq, dk, dv, stats,
                                           Z, T, hd, s);
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, dq, dk, dv, stats, Z,
                                         T, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
