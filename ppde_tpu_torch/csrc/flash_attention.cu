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
// Two designs, chosen by type and T in the launchers below.
//
// bf16 and T <= 256 (every ESM2 call on GFP: T = 237), kernels attn_*_rs:
// the scores live in registers. In the forward and the dq half a warp owns
// 16 score rows against all columns (T padded to 64): 128 float32
// accumulators a thread at T = 256. The row max and sum come from quad
// shuffles on them (only the last 64-column chunk holds columns past T, and
// only it is masked), and the second product takes its bf16 A fragment from
// two neighbouring n8 accumulator tiles packed in place (the m16n8k16
// layout identity), so the scores never touch shared memory and no barrier
// separates the phases. The dk/dv half needs no row of scores whole (its
// max, sum and delta come from the dq half), so a warp walks its 16 keys
// against 16 queries at a time and holds one 16 x 16 group: 123 registers
// at hd = 24, 4 blocks per SM. A block is one 64-row strip of one z (4
// warps), so the chunk-16 call (Z = 320) still has 1,280 blocks. Operands
// are staged once per block, as they lie in memory, by 16-byte cp.async
// (rows past T zero-filled; the forward and dq in two groups, so that the
// first product starts before the second operand pair has arrived); first
// products read them by ldmatrix, second products by ldmatrix.trans. hd is
// a template argument; an odd multiple of 8 (hd = 24) takes its last 8 by
// one m16n8k8 and keeps its rows unpadded in shared memory (48 bytes, no
// bank conflicts), so staging is one linear copy. exp is ex2.approx on
// s log2(e) - max log2(e) (one FFMA + one MUFU a score): the special
// function units, 16 results per clock per SM, are a floor of the same
// size as the bytes (chip_smoke.py reports it as exp_floor_ms), but the
// kernels are bound by instruction issue (about 1,450, 2,300 and 1,750 a
// warp at hd = 24 for the forward, dq and dk/dv). Why mma.sync and not
// wgmma: each kernel runs up to four products on different accumulators,
// and wgmma pins every accumulator array to fixed registers for the whole
// kernel, which spilled kernels A and B; mma.sync leaves the allocation to
// ptxas.
//
// float32 (any T <= 512) and bf16 with 256 < T <= 512, kernels attn_*
// without the suffix: the TPU kernel holds a whole [T, T] float32 score
// block on chip; 225 KB at T = 237 does not fit a block's 227 KB of shared
// memory. The thin side is small, so a block holds 64 rows of the scores
// against ALL T columns, [64, T] float32 (up to T = 512: 133 KB). That keeps
// the TPU kernel's arithmetic exactly (normalise in float32, then cast, then
// the product) with no online softmax. Thin operands are staged through shared
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
// block with a fixed order of sums: results repeat bit for bit. The _rs
// kernels split the backward the same way, a warp per 16 query rows (dq)
// and a warp per 16 key rows (dk, dv): 8 products and 2 passes of exp.
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

// ---------------------------------------------------------------------------
// bf16, T <= 256: scores in registers
// ---------------------------------------------------------------------------
namespace rs {

using bf16 = __nv_bfloat16;
constexpr int T_REG = 256;          // the largest T these kernels take
constexpr int NG = T_REG / 16;      // 16-column groups of a score row
constexpr int WARPS = 4;            // a block: one strip of 64 rows
constexpr int THREADS = 32 * WARPS;
constexpr int STRIP = 16 * WARPS;
constexpr float L2E = 1.4426950408889634f;  // log2(e)

// Row stride (elements) of a staged [rows, hd] operand. Rows stay 16-byte
// aligned and the 8 rows an ldmatrix reads fall on 8 different 16-byte bank
// groups: hd itself where hd is an odd multiple of 8 (rows of 16, 48, 80 or
// 112 bytes), hd + 8 where it is a multiple of 16 (rows of 32 to 128 bytes
// as they lie would put 2 to 8 of the 8 on one bank group). Columns past hd
// are neither written nor read.
template <int HD>
constexpr int kSP = (HD / 8) % 2 ? HD : HD + 8;
// k16 steps over hd, and one k8 step more where hd is an odd multiple of 8
template <int HD>
constexpr int kK16 = HD / 16;
template <int HD>
constexpr bool kTail = HD % 16 != 0;
// blocks of 4 warps an SM holds in the forward and the dq half: 3 (168
// registers a thread) up to hd 32; at 48 and 64 dq would spill at 168
template <int HD>
constexpr int kMinBlocks = HD <= 32 ? 3 : 2;
// bytes between two 16-row groups of a staged operand
template <int HD>
constexpr uint32_t kGroup = 16 * kSP<HD> * 2;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x8, row) * b (8x8, col): the last 8 of a summed index of 8, 24,
// 40 or 56
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// FOR_GROUPS(c, ng4) { ... }: the body for every 16-column group c of the
// first ng4 64-column chunks, unrolled, with one runtime test per chunk: the
// four groups of a chunk are one basic block, which ptxas schedules as a
// whole (a test per group cuts every product into pieces too small to
// overlap anything). A loop and not a function taking a lambda: through a
// lambda the score array went to local memory.
#define FOR_GROUPS(c, ng4)                                    \
  _Pragma("unroll") for (int c##_4 = 0; c##_4 < NG / 4; ++c##_4) \
    if (c##_4 < (ng4))                                        \
      _Pragma("unroll") for (int c = 4 * c##_4; c < 4 * c##_4 + 4; ++c)

// Rows t0 .. t0+rows-1 of src [Tn, HD] into dst [rows, kSP], rows from Tn on
// zero, by 16-byte cp.async (the caller commits the group). The rows lie
// back to back in memory, so chunk i of the copy is bytes 16 i .. of the
// source: where kSP = HD the copy is linear, else a row is HD / 8 chunks.
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      int t0, int rows, int Tn) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  const int n_in = (Tn - t0 < rows ? Tn - t0 : rows) * CPR;  // chunks to copy
  const uint4* from = reinterpret_cast<const uint4*>(src + (size_t)t0 * HD);
  const uint32_t base = saddr(dst);
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const uint32_t to =
        kSP<HD> == HD ? 16 * i : (i / CPR) * (kSP<HD> * 2) + (i % CPR) * 16;
    const bool in = i < n_in;
    cp_async16(base + to, in ? from + i : from, in ? 16 : 0);
  }
}

// The A fragments of a warp's 16 rows of a staged operand (all of hd; the
// k8 step's in the first two registers of the last entry).
template <int HD>
__device__ __forceinline__ void a_frags(
    uint32_t (&a)[kK16<HD> + kTail<HD>][4], const bf16* rows, int lane) {
  const bf16* row = rows + (lane & 15) * kSP<HD>;
  const uint32_t base = saddr(row + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < kK16<HD>; ++kk) ldsm4(a[kk], base + kk * 32);
  if constexpr (kTail<HD>) {
    uint32_t t[2];
    ldsm2(t, saddr(row + kK16<HD> * 16));
    a[kK16<HD>][0] = t[0];
    a[kK16<HD>][1] = t[1];
  }
}

// Lane addresses for the B operand of 16-column group c (add c * kGroup
// bytes): cols_addr reads 16 rows of a staged operand as the columns of a
// first product (B^T as it lies: ldmatrix), sum_addr reads 16 rows as the
// summed index of a second product (ldmatrix.trans).
template <int HD>
__device__ __forceinline__ uint32_t cols_addr(const bf16* B, int lane) {
  return saddr(B + ((lane & 7) + ((lane >> 4) << 3)) * kSP<HD> +
               ((lane >> 3) & 1) * 8);
}

template <int HD>
__device__ __forceinline__ uint32_t sum_addr(const bf16* B, int lane) {
  return saddr(B + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kSP<HD> +
               (lane >> 4) * 8);
}

// The two 8 x 8 matrices of a group's 16 rows at the last 8-column step of
// hd (where hd is an odd multiple of 8), for ldmatrix.x2 (.trans): rows 0-7
// from lanes 0-7, rows 8-15 from lanes 8-15.
template <int HD>
__device__ __forceinline__ uint32_t tail_addr(const bf16* B, int lane) {
  return saddr(B + (lane & 15) * kSP<HD> + kK16<HD> * 16);
}

// d0, d1 (the two n8 tiles of one 16-column group) = A * B^T over hd, B's
// 16 rows at b (cols_addr; bt: tail_addr): k16 steps, then one k8 step
// where hd is an odd multiple of 8.
template <int HD>
__device__ __forceinline__ void group_product(
    float (&d0)[4], float (&d1)[4],
    const uint32_t (&a)[kK16<HD> + kTail<HD>][4], uint32_t b, uint32_t bt) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d0[e] = d1[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK16<HD>; ++kk) {
    uint32_t f[4];
    ldsm4(f, b + kk * 32);
    mma_bf16(d0, a[kk], f[0], f[1]);
    mma_bf16(d1, a[kk], f[2], f[3]);
  }
  if constexpr (kTail<HD>) {
    uint32_t f[2];
    ldsm2(f, bt);
    mma_k8(d0, a[kK16<HD>][0], a[kK16<HD>][1], f[0]);
    mma_k8(d1, a[kK16<HD>][0], a[kK16<HD>][1], f[1]);
  }
}

// o += cast(x) * B over one 16-row step of the summed index: x0, x1 are the
// two n8 accumulator tiles of a 16-column group, packed in place into the
// bf16 A fragment; B's 16 rows at b (sum_addr; bt: tail_addr).
template <int HD>
__device__ __forceinline__ void step_product(float (&o)[HD / 8][4],
                                             const float (&x0)[4],
                                             const float (&x1)[4],
                                             uint32_t b, uint32_t bt) {
  const uint32_t a[4] = {pack_bf16(x0[0], x0[1]), pack_bf16(x0[2], x0[3]),
                         pack_bf16(x1[0], x1[1]), pack_bf16(x1[2], x1[3])};
#pragma unroll
  for (int n2 = 0; n2 < kK16<HD>; ++n2) {
    uint32_t f[4];
    ldsm4t(f, b + n2 * 32);
    mma_bf16(o[2 * n2], a, f[0], f[1]);
    mma_bf16(o[2 * n2 + 1], a, f[2], f[3]);
  }
  if constexpr (kTail<HD>) {
    uint32_t f[2];
    ldsm2t(f, bt);
    mma_bf16(o[HD / 8 - 1], a, f[0], f[1]);
  }
}

// A warp's 16 output rows (row0 ..) of dst [Tn, HD], cast to bf16.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&o)[HD / 8][4],
                                           int row0, int Tn, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= Tn) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * HD + nt * 8 + 2 * tig) =
          pack_bf16(o[nt][2 * h], o[nt][2 * h + 1]);
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&o)[HD / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
}

// Scores of a warp's 16 rows against all columns, s[j][e]: n8 tile j, row
// g (e < 2) or g + 8, column 8 j + 2 tig + (e & 1). Chunks c4 >= ng4 are
// neither computed nor read; columns between Tn and 64 ng4 hold the scores
// of zero rows.
using Scores = float[2 * NG][4];

// s = rows * cols^T over hd: a warp's 16 rows of one staged operand against
// all rows of another.
template <int HD>
__device__ __forceinline__ void scores(Scores& s, const bf16* rows,
                                       const bf16* cols, int ng4, int lane) {
  uint32_t a[kK16<HD> + kTail<HD>][4];
  a_frags<HD>(a, rows, lane);
  const uint32_t b = cols_addr<HD>(cols, lane), bt = tail_addr<HD>(cols, lane);
  FOR_GROUPS(c, ng4) {
    group_product<HD>(s[2 * c], s[2 * c + 1], a, b + c * kGroup<HD>,
                      bt + c * kGroup<HD>);
  }
}

// Softmax of s by rows, in place: float32, the row max subtracted, columns
// >= Tn left out and set to 0, e * (1 / sum); keeps the max and the sum of
// each of the thread's two rows.
__device__ __forceinline__ void softmax(Scores& s, int ng4, int Tn, int lane,
                                        float (&mx)[2], float (&sum)[2]) {
  // columns from Tn on, all in the last 64-column chunk, become -inf (a
  // select, not a branch)
  const int pad_from = Tn - 2 * (lane & 3);
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int c4 = 0; c4 < NG / 4; ++c4) {
    if (c4 + 1 < ng4) {
#pragma unroll
      for (int j = 8 * c4; j < 8 * c4 + 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    } else if (c4 + 1 == ng4) {
#pragma unroll
      for (int j = 8 * c4; j < 8 * c4 + 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 8 * j + (e & 1) < pad_from ? s[j][e] : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    }
  }
  float ml[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    ml[h] = mx[h] * L2E;
    sum[h] = 0.f;
  }
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int j = 2 * c; j < 2 * c + 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], L2E, -ml[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    inv[h] = 1.f / sum[h];
  }
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int j = 2 * c; j < 2 * c + 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
  }
}

// Kernel C. Block (64-row strip, z); warp w owns rows r0 + 16 w ...:
// o = cast(softmax(q k^T)) v.
template <int HD>
__global__ void __launch_bounds__(THREADS, kMinBlocks<HD>)
attn_fwd_rs(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, int Tn,
            int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (Tn + 63) & ~63, ng4 = Tp / 64;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [STRIP, kSP]
  bf16* sk = sq + STRIP * kSP<HD>;           // [Tp, kSP]
  bf16* sv = sk + Tp * kSP<HD>;              // [Tp, kSP]
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  stage<HD>(sq, q + off, r0, STRIP, Tn);
  stage<HD>(sk, k + off, 0, Tp, Tn);
  cp_async_commit();
  stage<HD>(sv, v + off, 0, Tp, Tn);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = r0 + 16 * warp;
  const bool active = row0 < Tn;  // warps past T only join the barriers
  Scores s;
  float mx[2], sum[2];
  cp_async_wait<1>();
  __syncthreads();
  if (active) {
    scores<HD>(s, sq + 16 * warp * kSP<HD>, sk, ng4, lane);
    softmax(s, ng4, Tn, lane, mx, sum);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  float acc[HD / 8][4];
  zero<HD>(acc);
  const uint32_t b = sum_addr<HD>(sv, lane), bt = tail_addr<HD>(sv, lane);
  FOR_GROUPS(c, ng4) {
    step_product<HD>(acc, s[2 * c], s[2 * c + 1], b + c * kGroup<HD>,
                     bt + c * kGroup<HD>);
  }
  store_rows<HD>(o + off, acc, row0, Tn, lane);
}

// Kernel C', first half. Block (64 query rows, z): w32 by rows (kept in
// registers), delta = rowsum(w32 * dw) with dw = dout v^T formed 16
// columns at a time, then again dw, ds = cast(w32 * (dw - delta)) and
// dq = ds k; each row's max, sum and delta go to stats [Z, 3, Tn].
template <int HD>
__global__ void __launch_bounds__(THREADS, kMinBlocks<HD>)
attn_bwd_dq_rs(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               bf16* __restrict__ dq, float* __restrict__ stats, int Tn,
               int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (Tn + 63) & ~63, ng4 = Tp / 64;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [STRIP, kSP]
  bf16* sdo = sq + STRIP * kSP<HD>;          // [STRIP, kSP]
  bf16* sk = sdo + STRIP * kSP<HD>;          // [Tp, kSP]
  bf16* sv = sk + Tp * kSP<HD>;              // [Tp, kSP]
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  stage<HD>(sq, q + off, r0, STRIP, Tn);
  stage<HD>(sk, k + off, 0, Tp, Tn);
  cp_async_commit();
  stage<HD>(sdo, dout + off, r0, STRIP, Tn);
  stage<HD>(sv, v + off, 0, Tp, Tn);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = r0 + 16 * warp;
  const bool active = row0 < Tn;
  Scores w;
  float mx[2], sum[2];
  cp_async_wait<1>();
  __syncthreads();
  if (active) {
    scores<HD>(w, sq + 16 * warp * kSP<HD>, sk, ng4, lane);
    softmax(w, ng4, Tn, lane, mx, sum);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  uint32_t a_do[kK16<HD> + kTail<HD>][4];
  a_frags<HD>(a_do, sdo + 16 * warp * kSP<HD>, lane);
  const uint32_t bv = cols_addr<HD>(sv, lane), bvt = tail_addr<HD>(sv, lane);
  // delta: columns beyond Tn have w32 = 0
  float delta[2] = {0.f, 0.f};
  FOR_GROUPS(c, ng4) {
    float dw[2][4];
    group_product<HD>(dw[0], dw[1], a_do, bv + c * kGroup<HD>,
                      bvt + c * kGroup<HD>);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        delta[e >> 1] = fmaf(w[2 * c + h][e], dw[h][e], delta[e >> 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 1);
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 2);
    const int r = row0 + g + 8 * h;
    if (tig == 0 && r < Tn) {
      float* st = stats + (size_t)z * 3 * Tn + r;
      st[0] = mx[h];
      st[Tn] = sum[h];
      st[2 * Tn] = delta[h];
    }
  }
  float acc[HD / 8][4];
  zero<HD>(acc);
  const uint32_t bk = sum_addr<HD>(sk, lane), bkt = tail_addr<HD>(sk, lane);
  FOR_GROUPS(c, ng4) {
    float dw[2][4];
    group_product<HD>(dw[0], dw[1], a_do, bv + c * kGroup<HD>,
                      bvt + c * kGroup<HD>);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dw[h][e] = w[2 * c + h][e] * (dw[h][e] - delta[e >> 1]);
    step_product<HD>(acc, dw[0], dw[1], bk + c * kGroup<HD>,
                     bkt + c * kGroup<HD>);
  }
  store_rows<HD>(dq + off, acc, row0, Tn, lane);
}

// Kernel C', second half. Block (64 key rows, z); warp w owns keys
// r0 + 16 w ... and walks the queries 16 at a time (group c): the
// transposed scores k q_c^T, w32 rebuilt from the query rows' max and sum,
// dv += cast(w32)^T dout_c, dw^T = v dout_c^T, ds^T = cast(w32 * (dw -
// delta)), dk += ds^T q_c. The query rows' max, sum and delta come from the
// dq half, so no step needs a whole row of scores: a warp holds one group's
// 16 x 16 scores at a time and the two accumulators, few enough registers
// for 4 blocks per SM. The groups are summed in a fixed order, so the
// results repeat bit for bit.
template <int HD>
__global__ void __launch_bounds__(THREADS, 4)
attn_bwd_dkdv_rs(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                 const float* __restrict__ stats, int Tn, int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ng = (Tn + 15) / 16, T16 = 16 * ng;
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [STRIP, kSP]
  bf16* sv = sk + STRIP * kSP<HD>;           // [STRIP, kSP]
  bf16* sq = sv + STRIP * kSP<HD>;           // [T16, kSP]
  bf16* sdo = sq + T16 * kSP<HD>;            // [T16, kSP]
  // per query column: -max log2(e), 1 / sum, delta (0, 0, 0 past Tn: the
  // zero query rows' scores are 0, so their weights come out 0)
  float* s_ml = reinterpret_cast<float*>(sdo + T16 * kSP<HD>);
  float* s_inv = s_ml + T16;
  float* s_delta = s_inv + T16;
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  stage<HD>(sk, k + off, r0, STRIP, Tn);
  stage<HD>(sv, v + off, r0, STRIP, Tn);
  stage<HD>(sq, q + off, 0, T16, Tn);
  stage<HD>(sdo, dout + off, 0, T16, Tn);
  // the stats by 4-byte cp.async; the thread that copied a value turns it
  // into -max log2(e), 1 / sum or delta after its wait
  const float* st = stats + (size_t)z * 3 * Tn;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    for (int j = threadIdx.x; j < Tn; j += THREADS)
      cp_async4(saddr(s_ml + r * T16 + j), st + r * Tn + j);
  cp_async_commit();
  cp_async_wait<0>();
  for (int j = threadIdx.x; j < T16; j += THREADS) {
    const bool in = j < Tn;
    s_ml[j] = in ? -(s_ml[j] * L2E) : 0.f;
    s_inv[j] = in ? 1.f / s_inv[j] : 0.f;
    s_delta[j] = in ? s_delta[j] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int row0 = r0 + 16 * warp;
  if (row0 >= Tn) return;  // no barrier follows
  uint32_t a_k[kK16<HD> + kTail<HD>][4], a_v[kK16<HD> + kTail<HD>][4];
  a_frags<HD>(a_k, sk + 16 * warp * kSP<HD>, lane);
  a_frags<HD>(a_v, sv + 16 * warp * kSP<HD>, lane);
  const uint32_t bq = cols_addr<HD>(sq, lane), bqs = sum_addr<HD>(sq, lane);
  const uint32_t bqt = tail_addr<HD>(sq, lane);
  const uint32_t bd = cols_addr<HD>(sdo, lane), bds = sum_addr<HD>(sdo, lane);
  const uint32_t bdt = tail_addr<HD>(sdo, lane);
  float acc_v[HD / 8][4], acc_k[HD / 8][4];
  zero<HD>(acc_v);
  zero<HD>(acc_k);
#pragma unroll 4
  for (int c = 0; c < ng; ++c) {
    const uint32_t gc = c * kGroup<HD>;
    float w[2][4], dw[2][4];
    group_product<HD>(w[0], w[1], a_k, bq + gc, bqt + gc);
    // w32[key, query] = exp(s - max[query]) * (1 / sum[query])
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * c + 8 * h + 2 * tig;
      const float2 ml = *reinterpret_cast<const float2*>(s_ml + col);
      const float2 inv = *reinterpret_cast<const float2*>(s_inv + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[h][e] = ex2(fmaf(w[h][e], L2E, (e & 1) ? ml.y : ml.x)) *
                  ((e & 1) ? inv.y : inv.x);
    }
    step_product<HD>(acc_v, w[0], w[1], bds + gc, bdt + gc);
    group_product<HD>(dw[0], dw[1], a_v, bd + gc, bdt + gc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 dl = *reinterpret_cast<const float2*>(
          s_delta + 16 * c + 8 * h + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dw[h][e] = w[h][e] * (dw[h][e] - ((e & 1) ? dl.y : dl.x));
    }
    step_product<HD>(acc_k, dw[0], dw[1], bqs + gc, bqt + gc);
  }
  store_rows<HD>(dv + off, acc_v, row0, Tn, lane);
  store_rows<HD>(dk + off, acc_k, row0, Tn, lane);
}

// Shared memory of a block: `strip` staged operands of STRIP rows, `whole`
// of all T rows (T padded to `pad`), and `stats` float32 rows of as many.
template <int HD>
size_t smem_bytes(int strip, int whole, int stats, int Tn, int pad = 64) {
  const int Tp = (Tn + pad - 1) / pad * pad;
  return (size_t)(strip * STRIP + whole * Tp) * kSP<HD> * sizeof(bf16) +
         (size_t)stats * Tp * sizeof(float);
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int Z,
               int Tn, cudaStream_t stream) {
  const int n_strips = (Tn + STRIP - 1) / STRIP;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(attn_fwd_rs<HD>, smem_bytes<HD>(1, 2, 0, Tn));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_rs<HD><<<Z * n_strips, THREADS, smem_bytes<HD>(1, 2, 0, Tn),
                    stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Tn, n_strips);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* stats, int Z, int Tn,
               cudaStream_t stream) {
  const int n_strips = (Tn + STRIP - 1) / STRIP;
  cudaError_t err = allow_smem(attn_bwd_dq_rs<HD>,
                               smem_bytes<HD>(2, 2, 0, Tn));
  if (err == cudaSuccess)
    err = allow_smem(attn_bwd_dkdv_rs<HD>, smem_bytes<HD>(2, 2, 3, Tn, 16));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_rs<HD><<<Z * n_strips, THREADS, smem_bytes<HD>(2, 2, 0, Tn),
                       stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<float*>(stats), Tn, n_strips);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_rs<HD><<<Z * n_strips, THREADS,
                         smem_bytes<HD>(2, 2, 3, Tn, 16), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), Tn, n_strips);
  return static_cast<int>(cudaGetLastError());
}

// hd (a multiple of 8 up to 64) as a template argument
template <typename F>
int by_hd(int hd, F f) {
  switch (hd) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 24: return f(std::integral_constant<int, 24>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 40: return f(std::integral_constant<int, 40>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 56: return f(std::integral_constant<int, 56>{});
    default: return f(std::integral_constant<int, 64>{});
  }
}

}  // namespace rs

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
// and o); bf16 with T <= 256 runs the register-resident kernels. Returns a
// cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int Z, int T, int hd, int dtype, void* stream) {
  if (bad_shape(Z, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 16) return launch_fwd<float, 16>(q, k, v, o, Z, T, hd, s);
    if (hd <= 32) return launch_fwd<float, 32>(q, k, v, o, Z, T, hd, s);
    return launch_fwd<float, 64>(q, k, v, o, Z, T, hd, s);
  }
  if (dtype == 1 && T <= rs::T_REG)
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_fwd<decltype(HD)::value>(q, k, v, o, Z, T, s);
    });
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
  if (dtype == 1 && T <= rs::T_REG)
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_bwd<decltype(HD)::value>(q, k, v, dout, dq, dk, dv,
                                                  stats, Z, T, s);
    });
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
