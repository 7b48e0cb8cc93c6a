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
// Every product sums in float32; "cast" rounds to the input type. bfloat16
// products run on mma.sync.m16n8k16. float32 first products (the scores q
// k^T and dw = dout v^T) run on FMAs in full float32 (exp turns the scores'
// absolute error into the weights' relative error, and ds = w32 (dw -
// delta) cancels); the second products (w v, ds k, w^T dout, ds^T q) on
// mma.sync.m16n8k8 in TF32 as three split products (3xTF32: x = big +
// small, both TF32, and a b = big_a big_b + big_a small_b + small_a big_b,
// about 2^-22 relative), each 16-key step's sum added in float32.
//
// What bounds them on the H100: at ESM2's head widths (hd 24 to 64) the
// bytes are small (4 Z T hd elements forward, 7 backward) and so are the
// operations (4 Z T^2 hd forward, 10 backward): at Z = 2560, T = 237, hd =
// 24 in bf16 the card could do the forward in about 35 us and the backward
// in 61 us, both set by the bytes; at T = 1024 the operations set it. The
// [Z, T, T] scores, which a plain version writes and reads several times,
// never leave the chip.
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
// float32 (any T) and bf16 with T > 256, kernels attn_*_kt: key-tiled, so
// that nothing in the design caps T. A block is again a 64-row strip of
// one z, a warp 16 rows, but the other operand is staged 64 rows (a tile)
// at a time, double-buffered by cp.async, and a warp holds the scores of
// one 16 x 16 group (or, for the max, one tile) at a time. The TPU
// kernel's arithmetic is kept: softmax normalised in float32 with the row's
// true max and sum, then cast, then the product, by passes over the tiles.
//   * Forward, bf16: pass 1 walks the key tiles for each row's max and sum
//     (the sum rescaled as the running max grows: float32 scalars only, the
//     weights are never formed with a partial max); pass 2 forms
//     cast(exp(s - max) / sum) and multiplies by v. Three products.
//     float32, where the cast is the identity: one pass, o and the sum
//     rescaled together, o / sum at the end (the same float32 arithmetic
//     in another order). Two products.
//   * dq half: pass 1 walks the (k, v) tiles for each row's max and sum
//     and, rescaled beside the sum, delta = rowsum(w32 * dw) (dw = dout
//     v^T); pass 2 dw again, ds = cast(w32 * (dw - delta)) and dq += ds k.
//     Five products. Each row's max, sum and delta go to the [Z, 3, T]
//     stats scratch.
//   * dk/dv half: a warp's 16 keys walk the query tiles with those tiles'
//     stats staged beside them (the rs kernel's loop): four products.
// float32's other products as 3xTF32: the m16n8k8 TF32 layouts differ from
// bf16's, so a second product takes its A fragment from an n8 accumulator
// tile by reading its summed index in the order the accumulator holds it
// (key 2 tig as k = tig, key 2 tig + 1 as k = tig + 4) and the B operand's
// rows in the same order; float32 rows are staged with a stride of hd + 4
// floats, so the fragment patterns (and the score FMAs' 16-byte loads) fall
// in different banks. exp is ex2.approx, as in the rs kernels (its error,
// about 2^-22, is below the 3xTF32 products').
//
// dk and dv sum over query rows and dq over key rows. Blocks run in no
// order and atomics would change the sum's order from run to run, so the
// backward is two kernels: the dq half owns query rows and writes each
// row's max, sum and delta to a [Z, 3, T] scratch; the dk/dv half owns key
// rows against all queries, rebuilds w32 and ds from that scratch, and
// writes dv and dk. Every output element is written once by one warp with
// a fixed order of sums: results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// ---------------------------------------------------------------------------
// float32 (any T) and bf16 with T > 256: key-tiled
// ---------------------------------------------------------------------------
namespace kt {

using rs::bf16;
using rs::cp_async16;
using rs::cp_async4;
using rs::cp_async_commit;
using rs::cp_async_wait;
using rs::ex2;
using rs::L2E;
using rs::saddr;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;  // rs::stage copies with as many
constexpr int STRIP = 16 * WARPS;    // rows (queries, or keys) of a block
constexpr int TILE = 64;             // rows of the other operand a step
static_assert(THREADS == rs::THREADS, "rs::stage's thread count");

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// Row stride (elements) of a staged [rows, hd] operand: bf16 as the rs
// kernels'; float32 hd + 4 (rows 16-byte aligned; hd + 4 is 4 times an odd
// number, so the rows g and columns tig of a first product's fragment, and
// the rows 2 tig, 2 tig + 1 and columns g of a second product's, fall in 32
// different banks)
template <typename T, int HD>
constexpr int kStride = kF32<T> ? HD + 4 : rs::kSP<HD>;

// Shared memory of a block: `strips` operands of STRIP rows, `tiles` of
// TILE rows (each double-buffered), `stats` float32 rows of two tiles.
template <typename T, int HD>
constexpr size_t smem_bytes(int strips, int tiles, int stats) {
  return (size_t)(strips * STRIP + 2 * tiles * TILE) * kStride<T, HD> *
             sizeof(T) +
         (size_t)stats * 2 * TILE * sizeof(float);
}

// Rows t0 .. t0+rows-1 of src [Tn, HD] into dst [rows, kStride], rows from
// Tn on zero, by 16-byte cp.async (the caller commits the group).
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int t0, int rows, int Tn) {
  if constexpr (kF32<T>) {
    constexpr int CPR = HD / 4;  // 16-byte chunks per row
    const int n_in = (Tn - t0 < rows ? Tn - t0 : rows) * CPR;
    const uint4* from = reinterpret_cast<const uint4*>(src + (size_t)t0 * HD);
    const uint32_t base = saddr(dst);
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
      const uint32_t to = (i / CPR) * (kStride<T, HD> * 4) + (i % CPR) * 16;
      const bool in = i < n_in;
      cp_async16(base + to, in ? from + i : from, in ? 16 : 0);
    }
  } else {
    rs::stage<HD>(dst, src, t0, rows, Tn);
  }
}

// TF32 (round to nearest, ties away) of x, in a 32-bit register
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in about float32 precision: a = ab + as and b = (b0, b1) split
// into TF32 parts, the two small products first, small * small left out
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// The A operand of a first product (the scores q k^T or k q^T, and dw =
// dout v^T or v dout^T) for a warp's 16 rows: bf16 fragments (all of hd),
// or in float32 the staged rows themselves. float32 first products are
// summed on FMAs in full float32: exp turns a score's absolute error into
// the weight's relative error, and ds = w32 (dw - delta) cancels; 3xTF32's
// error (about 2^-22 of |q| |k| a term) broke float32's tolerance there
// once scores reached +-100.
template <typename T, int HD>
struct ARows {
  uint32_t f[rs::kK16<HD> + rs::kTail<HD>][4];  // bf16
};
template <int HD>
struct ARows<float, HD> {
  const float* rows;
};

template <typename T, int HD>
__device__ __forceinline__ void load_rows(ARows<T, HD>& a, const T* rows,
                                          int lane) {
  if constexpr (kF32<T>)
    a.rows = rows;
  else
    rs::a_frags<HD>(a.f, rows, lane);
}

// d0, d1 (two n8 accumulator tiles) = the warp's 16 rows times B's rows
// c0 .. c0+15 of a staged operand, over hd
template <typename T, int HD>
__device__ __forceinline__ void scores16(float (&d0)[4], float (&d1)[4],
                                         const ARows<T, HD>& a, const T* B,
                                         int c0, int lane) {
  if constexpr (kF32<T>) {
    constexpr int SP = kStride<T, HD>;
    const int g = lane >> 2, tig = lane & 3;
    const float* q0 = a.rows + g * SP;
    const float* q1 = q0 + 8 * SP;
    const float* k0 = B + (c0 + 2 * tig) * SP;  // columns 2 tig, 2 tig + 1
    const float* k2 = k0 + 8 * SP;              // and 8 more
#pragma unroll
    for (int e = 0; e < 4; ++e) d0[e] = d1[e] = 0.f;
    // two steps unrolled: all of hd unrolled hoisted every step's six
    // 16-byte loads (to 384 registers at hd 64) and spilled
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(q0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(q1 + d);
      const float4 y[4] = {*reinterpret_cast<const float4*>(k0 + d),
                           *reinterpret_cast<const float4*>(k0 + SP + d),
                           *reinterpret_cast<const float4*>(k2 + d),
                           *reinterpret_cast<const float4*>(k2 + SP + d)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = j < 2 ? d0 : d1;
        const int col = j & 1;
        o[col] = fmaf(x0.x, y[j].x, o[col]);
        o[col] = fmaf(x0.y, y[j].y, o[col]);
        o[col] = fmaf(x0.z, y[j].z, o[col]);
        o[col] = fmaf(x0.w, y[j].w, o[col]);
        o[2 + col] = fmaf(x1.x, y[j].x, o[2 + col]);
        o[2 + col] = fmaf(x1.y, y[j].y, o[2 + col]);
        o[2 + col] = fmaf(x1.z, y[j].z, o[2 + col]);
        o[2 + col] = fmaf(x1.w, y[j].w, o[2 + col]);
      }
    }
  } else {
    const uint32_t g = (c0 / 16) * rs::kGroup<HD>;
    rs::group_product<HD>(d0, d1, a.f, rs::cols_addr<HD>(B, lane) + g,
                          rs::tail_addr<HD>(B, lane) + g);
  }
}

// o += cast(x) * B over the 16 rows c0 .. c0+15 of a staged operand (the
// summed index); x0, x1: the two n8 accumulator tiles of those 16 columns
template <typename T, int HD>
__device__ __forceinline__ void sum16(float (&o)[HD / 8][4],
                                      const float (&x0)[4],
                                      const float (&x1)[4], const T* B,
                                      int c0, int lane) {
  if constexpr (kF32<T>) {
    constexpr int SP = kStride<T, HD>;
    const int g = lane >> 2, tig = lane & 3;
    // k = tig is column 2 tig of an n8 tile, k = tig + 4 column 2 tig + 1
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float(&x)[4] = h ? x1 : x0;
      split(x[0], ab[h][0], as[h][0]);
      split(x[2], ab[h][1], as[h][1]);
      split(x[1], ab[h][2], as[h][2]);
      split(x[3], ab[h][3], as[h][3]);
    }
    const float* b = B + (c0 + 2 * tig) * SP + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      // the tensor cores sum the 16 keys' three products; o adds them in
      // float32 (round to nearest) over the whole of T
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma3(t, ab[h], as[h], b[8 * h * SP + 8 * n],
             b[(8 * h + 1) * SP + 8 * n]);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += t[e];
    }
  } else {
    const uint32_t g = (c0 / 16) * rs::kGroup<HD>;
    rs::step_product<HD>(o, x0, x1, rs::sum_addr<HD>(B, lane) + g,
                         rs::tail_addr<HD>(B, lane) + g);
  }
}

// A warp's 16 output rows (row0 ..) of dst [Tn, HD], cast to T.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&o)[HD / 8][4],
                                           int row0, int Tn, int lane) {
  if constexpr (kF32<T>) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r >= Tn) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dst + (size_t)r * HD + n * 8 + 2 * tig) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
  } else {
    rs::store_rows<HD>(dst, o, row0, Tn, lane);
  }
}

// One more 64-column tile of scores s for the thread's two rows: columns
// from lim on (in the last tile only) set to -inf, the running max mx
// (over the quad) and ml = mx log2(e) updated, and f the factor that sums
// taken so far are rescaled by: ex2 of the difference of the two ml (0
// from -inf on the first tile, 1 while the max stays), so that every term
// of a sum stays ex2(s log2(e) - ml) of the latest ml up to ex2's own error
// (rescaling by the max's difference before rounding to ml put 5e-6
// relative between the sum and the weights at scores of +-150).
template <int NJ>
__device__ __forceinline__ void tile_max(float (&s)[NJ][4], int lim,
                                         float (&mx)[2], float (&ml)[2],
                                         float (&f)[2]) {
  float tm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + (e & 1) < lim ? s[j][e] : -CUDART_INF_F;
      tm[e >> 1] = fmaxf(tm[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
    tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
    const float mn = fmaxf(mx[h], tm[h]), mln = mn * L2E;
    f[h] = mln == ml[h] ? 1.f : ex2(ml[h] - mln);
    mx[h] = mn;
    ml[h] = mln;
  }
}

// Pass 1 of the bf16 forward: each of the thread's two rows' max (mx, over
// the quad), ml = mx log2(e) as the later pass rounds it, and sum of exp(s
// - max) (this thread's columns only), over all key tiles (tile_max).
// Stages the key tiles into kb (two buffers); leaves no copy in flight and
// every warp past its last read.
template <typename T, int HD>
__device__ __forceinline__ void row_stats(const T* rows, T* kb,
                                          const T* __restrict__ kz, int Tn,
                                          int lane, float (&mx)[2],
                                          float (&ml)[2], float (&sum)[2]) {
  constexpr int SP = kStride<T, HD>;
  const int nt = (Tn + TILE - 1) / TILE;
  mx[0] = mx[1] = ml[0] = ml[1] = -CUDART_INF_F;
  sum[0] = sum[1] = 0.f;
  stage<T, HD>(kb, kz, 0, TILE, Tn);
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt)
      stage<T, HD>(kb + ((i + 1) & 1) * TILE * SP, kz, (i + 1) * TILE, TILE,
                   Tn);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = kb + (i & 1) * TILE * SP;
    ARows<T, HD> a;
    load_rows<T, HD>(a, rows, lane);
    float s[8][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      scores16<T, HD>(s[2 * c], s[2 * c + 1], a, tile, 16 * c, lane);
    float f[2];
    tile_max(s, Tn - i * TILE - 2 * (lane & 3), mx, ml, f);
    sum[0] *= f[0];
    sum[1] *= f[1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[e >> 1] += ex2(fmaf(s[j][e], L2E, -ml[e >> 1]));
    __syncthreads();  // the buffer is restaged two tiles on
  }
}

// the quad's sum of a per-thread partial (a fixed order)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// w32 of an n8 accumulator tile j of a 64-column tile (columns from lim on
// get 0): exp(s - max) * (1 / sum)
__device__ __forceinline__ void weights(float (&s)[4], int j, int lim,
                                        const float (&ml)[2],
                                        const float (&inv)[2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = 8 * j + (e & 1) < lim
               ? ex2(fmaf(s[e], L2E, -ml[e >> 1])) * inv[e >> 1]
               : 0.f;
}

// Kernel C in float32, where the cast is the identity: one pass over the
// key tiles, the weights' sum and o = sum of exp(s - max) v rescaled
// together as the max grows (tile_max), o / sum at the end: the same
// float32 arithmetic in another order, and half the score products of the
// two-pass form.
template <int HD>
__device__ __forceinline__ void fwd_online(const float* rows, float* sk,
                                           float* sv,
                                           const float* __restrict__ kz,
                                           const float* __restrict__ vz,
                                           float* __restrict__ oz, int row0,
                                           int Tn, int lane) {
  constexpr int SP = kStride<float, HD>;
  const int nt = (Tn + TILE - 1) / TILE;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float ml[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float sum[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  rs::zero<HD>(acc);
  stage<float, HD>(sk, kz, 0, TILE, Tn);
  stage<float, HD>(sv, vz, 0, TILE, Tn);
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {
      const int b = ((i + 1) & 1) * TILE * SP;
      stage<float, HD>(sk + b, kz, (i + 1) * TILE, TILE, Tn);
      stage<float, HD>(sv + b, vz, (i + 1) * TILE, TILE, Tn);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int b = (i & 1) * TILE * SP;
    if (row0 >= Tn) {  // a warp past T (the last strip's): barriers only
      __syncthreads();
      continue;
    }
    ARows<float, HD> a;
    load_rows<float, HD>(a, rows, lane);
    float s[8][4], f[2];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      scores16<float, HD>(s[2 * c], s[2 * c + 1], a, sk + b, 16 * c, lane);
    tile_max(s, Tn - i * TILE - 2 * (lane & 3), mx, ml, f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= f[e >> 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) sum[h] *= f[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], L2E, -ml[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sum16<float, HD>(acc, s[2 * c], s[2 * c + 1], sv + b, 16 * c, lane);
    __syncthreads();  // the buffers are restaged two tiles on
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(sum[h]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  store_rows<float, HD>(oz, acc, row0, Tn, lane);
}

// Kernel C. Block (64-row strip, z); warp w owns rows r0 + 16 w ...:
// o = cast(softmax(q k^T)) v, in two passes over the key tiles (float32:
// one, fwd_online).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, kF32<T> && HD > 32 ? 2 : 3)
attn_fwd_kt(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int Tn,
            int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SP = kStride<T, HD>;
  T* sq = reinterpret_cast<T*>(smem);  // [STRIP, SP]
  T* sk = sq + STRIP * SP;             // 2 x [TILE, SP]
  T* sv = sk + 2 * TILE * SP;          // 2 x [TILE, SP]
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (Tn + TILE - 1) / TILE;
  const T* rows = sq + 16 * warp * SP;
  stage<T, HD>(sq, q + off, r0, STRIP, Tn);  // waited for with tile 0
  if constexpr (kF32<T>) {
    fwd_online<HD>(rows, sk, sv, k + off, v + off, o + off, r0 + 16 * warp,
                   Tn, lane);
  } else {
    float mx[2], ml[2], sum[2], inv[2];
    row_stats<T, HD>(rows, sk, k + off, Tn, lane, mx, ml, sum);
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(sum[h]);
    float acc[HD / 8][4];
    rs::zero<HD>(acc);
    stage<T, HD>(sk, k + off, 0, TILE, Tn);
    stage<T, HD>(sv, v + off, 0, TILE, Tn);
    cp_async_commit();
    for (int i = 0; i < nt; ++i) {
      if (i + 1 < nt) {
        const int b = ((i + 1) & 1) * TILE * SP;
        stage<T, HD>(sk + b, k + off, (i + 1) * TILE, TILE, Tn);
        stage<T, HD>(sv + b, v + off, (i + 1) * TILE, TILE, Tn);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int b = (i & 1) * TILE * SP;
      const int lim = Tn - i * TILE - 2 * (lane & 3);
      ARows<T, HD> a;
      load_rows<T, HD>(a, rows, lane);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s[2][4];
        scores16<T, HD>(s[0], s[1], a, sk + b, 16 * c, lane);
        weights(s[0], 2 * c, lim, ml, inv);
        weights(s[1], 2 * c + 1, lim, ml, inv);
        sum16<T, HD>(acc, s[0], s[1], sv + b, 16 * c, lane);
      }
      __syncthreads();
    }
    store_rows<T, HD>(o + off, acc, r0 + 16 * warp, Tn, lane);
  }
}

// Kernel C', first half. Block (64 query rows, z). Pass 1 over the (k, v)
// tiles: each row's max and sum as row_stats takes them, and beside the sum
// delta's numerator, the sum of exp(s - max) dw with dw = dout v^T,
// rescaled with it; delta = rowsum(w32 * dw) = that numerator / sum. Pass
// 2: dw again, ds = cast(w32 * (dw - delta)) and dq = ds k. Each row's
// max, sum and delta go to stats [Z, 3, Tn].
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_kt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               T* __restrict__ dq, float* __restrict__ stats, int Tn,
               int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SP = kStride<T, HD>;
  T* sq = reinterpret_cast<T*>(smem);  // [STRIP, SP]
  T* sdo = sq + STRIP * SP;            // [STRIP, SP]
  T* sk = sdo + STRIP * SP;            // 2 x [TILE, SP]
  T* sv = sk + 2 * TILE * SP;          // 2 x [TILE, SP]
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nt = (Tn + TILE - 1) / TILE;
  const int row0 = r0 + 16 * warp;
  const T* rq = sq + 16 * warp * SP;
  const T* rdo = sdo + 16 * warp * SP;
  stage<T, HD>(sq, q + off, r0, STRIP, Tn);
  stage<T, HD>(sdo, dout + off, r0, STRIP, Tn);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float ml[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float sum[2] = {0.f, 0.f}, num[2] = {0.f, 0.f}, inv[2], delta[2];
  float acc[HD / 8][4];
  rs::zero<HD>(acc);
#pragma unroll
  for (int pass = 1; pass <= 2; ++pass) {
    stage<T, HD>(sk, k + off, 0, TILE, Tn);
    stage<T, HD>(sv, v + off, 0, TILE, Tn);
    cp_async_commit();
    for (int i = 0; i < nt; ++i) {
      if (i + 1 < nt) {
        const int b = ((i + 1) & 1) * TILE * SP;
        stage<T, HD>(sk + b, k + off, (i + 1) * TILE, TILE, Tn);
        stage<T, HD>(sv + b, v + off, (i + 1) * TILE, TILE, Tn);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int b = (i & 1) * TILE * SP;
      const int lim = Tn - i * TILE - 2 * tig;
      ARows<T, HD> aq, ado;
      load_rows<T, HD>(aq, rq, lane);
      load_rows<T, HD>(ado, rdo, lane);
      if (row0 >= Tn) {
        // a warp past T (the last strip's) only stages and waits
      } else if (pass == 1) {
        // half a tile (32 columns) at a time: half the registers
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s[4][4], dw[4][4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int c0 = 32 * half + 16 * c;
            scores16<T, HD>(s[2 * c], s[2 * c + 1], aq, sk + b, c0, lane);
            scores16<T, HD>(dw[2 * c], dw[2 * c + 1], ado, sv + b, c0, lane);
          }
          float f[2];
          tile_max(s, lim - 32 * half, mx, ml, f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] *= f[h];
            num[h] *= f[h];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = ex2(fmaf(s[j][e], L2E, -ml[e >> 1]));
              sum[e >> 1] += x;
              num[e >> 1] = fmaf(x, dw[j][e], num[e >> 1]);
            }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float w[2][4], dw[2][4];
          scores16<T, HD>(w[0], w[1], aq, sk + b, 16 * c, lane);
          scores16<T, HD>(dw[0], dw[1], ado, sv + b, 16 * c, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            weights(w[h], 2 * c + h, lim, ml, inv);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dw[h][e] = w[h][e] * (dw[h][e] - delta[e >> 1]);
          }
          sum16<T, HD>(acc, dw[0], dw[1], sk + b, 16 * c, lane);
        }
      }
      __syncthreads();  // the buffer is restaged two tiles on
    }
    if (pass == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = quad_sum(sum[h]);
        inv[h] = 1.f / sum[h];
        delta[h] = quad_sum(num[h]) * inv[h];
        const int r = row0 + g + 8 * h;
        if (tig == 0 && r < Tn) {
          float* st = stats + (size_t)z * 3 * Tn + r;
          st[0] = mx[h];
          st[Tn] = sum[h];
          st[2 * Tn] = delta[h];
        }
      }
    }
  }
  store_rows<T, HD>(dq + off, acc, row0, Tn, lane);
}

// Kernel C', second half. Block (64 key rows, z); warp w owns keys
// r0 + 16 w ... and walks the query tiles, each in groups of 16 (the rs
// kernel's loop): the transposed scores k q_c^T, w32 rebuilt from the query
// rows' max and sum, dv += cast(w32)^T dout_c, dw^T = v dout_c^T, ds^T =
// cast(w32 * (dw - delta)), dk += ds^T q_c. Tiles and groups are summed in
// a fixed order, so the results repeat bit for bit.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkdv_kt(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 T* __restrict__ dk, T* __restrict__ dv,
                 const float* __restrict__ stats, int Tn, int n_strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SP = kStride<T, HD>;
  T* sk = reinterpret_cast<T*>(smem);  // [STRIP, SP]
  T* sv = sk + STRIP * SP;             // [STRIP, SP]
  T* sq = sv + STRIP * SP;             // 2 x [TILE, SP]
  T* sdo = sq + 2 * TILE * SP;         // 2 x [TILE, SP]
  // per query column of a tile (two buffers): -max log2(e), 1 / sum, delta
  // (0, 0, 0 past Tn: the zero query rows' scores are 0, so their weights
  // come out 0)
  float* sst = reinterpret_cast<float*>(sdo + 2 * TILE * SP);  // 2 x [3, TILE]
  const int z = blockIdx.x / n_strips, r0 = (blockIdx.x % n_strips) * STRIP;
  const size_t off = (size_t)z * Tn * HD;
  const float* st = stats + (size_t)z * 3 * Tn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int nt = (Tn + TILE - 1) / TILE;
  const int row0 = r0 + 16 * warp;
  // a tile's queries and stats; this thread's stats entries by 4-byte
  // cp.async (entries past Tn are not copied: the thread writes them)
  auto stage_tile = [&](int i) {
    const int b = (i & 1) * TILE * SP;
    stage<T, HD>(sq + b, q + off, i * TILE, TILE, Tn);
    stage<T, HD>(sdo + b, dout + off, i * TILE, TILE, Tn);
    float* dst = sst + (i & 1) * 3 * TILE;
    for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
      const int r = e / TILE, j = i * TILE + e % TILE;
      if (j < Tn) cp_async4(saddr(dst + e), st + r * Tn + j);
    }
  };
  stage<T, HD>(sk, k + off, r0, STRIP, Tn);
  stage<T, HD>(sv, v + off, r0, STRIP, Tn);
  stage_tile(0);
  cp_async_commit();
  float acc_v[HD / 8][4], acc_k[HD / 8][4];
  rs::zero<HD>(acc_v);
  rs::zero<HD>(acc_k);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) stage_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    // the entries this thread copied (or owns past Tn) turned into -max
    // log2(e), 1 / sum, delta
    float* sti = sst + (i & 1) * 3 * TILE;
    for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
      const int r = e / TILE;
      const bool in = i * TILE + e % TILE < Tn;
      const float x = sti[e];
      sti[e] = !in ? 0.f : r == 0 ? -(x * L2E) : r == 1 ? 1.f / x : x;
    }
    __syncthreads();
    const int b = (i & 1) * TILE * SP;
    if (row0 < Tn) {  // warp-uniform; no barrier inside
      ARows<T, HD> ak, av;
      load_rows<T, HD>(ak, sk + 16 * warp * SP, lane);
      load_rows<T, HD>(av, sv + 16 * warp * SP, lane);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float w[2][4], dw[2][4];
        scores16<T, HD>(w[0], w[1], ak, sq + b, 16 * c, lane);
        // w32[key, query] = exp(s - max[query]) * (1 / sum[query])
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 16 * c + 8 * h + 2 * tig;
          const float2 ml = *reinterpret_cast<const float2*>(sti + col);
          const float2 iv =
              *reinterpret_cast<const float2*>(sti + TILE + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[h][e] = ex2(fmaf(w[h][e], L2E, (e & 1) ? ml.y : ml.x)) *
                      ((e & 1) ? iv.y : iv.x);
        }
        sum16<T, HD>(acc_v, w[0], w[1], sdo + b, 16 * c, lane);
        scores16<T, HD>(dw[0], dw[1], av, sdo + b, 16 * c, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 dl = *reinterpret_cast<const float2*>(
              sti + 2 * TILE + 16 * c + 8 * h + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dw[h][e] = w[h][e] * (dw[h][e] - ((e & 1) ? dl.y : dl.x));
        }
        sum16<T, HD>(acc_k, dw[0], dw[1], sq + b, 16 * c, lane);
      }
    }
    __syncthreads();
  }
  if (row0 < Tn) {
    store_rows<T, HD>(dv + off, acc_v, row0, Tn, lane);
    store_rows<T, HD>(dk + off, acc_k, row0, Tn, lane);
  }
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int Z,
               int Tn, cudaStream_t stream) {
  const int n_strips = (Tn + STRIP - 1) / STRIP;
  constexpr size_t bytes = smem_bytes<T, HD>(1, 2, 0);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(attn_fwd_kt<T, HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kt<T, HD><<<Z * n_strips, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tn, n_strips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* stats, int Z, int Tn,
               cudaStream_t stream) {
  const int n_strips = (Tn + STRIP - 1) / STRIP;
  constexpr size_t dq_bytes = smem_bytes<T, HD>(2, 2, 0);
  constexpr size_t dkdv_bytes = smem_bytes<T, HD>(2, 2, 3);
  cudaError_t err = allow_smem(attn_bwd_dq_kt<T, HD>, dq_bytes);
  if (err == cudaSuccess)
    err = allow_smem(attn_bwd_dkdv_kt<T, HD>, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kt<T, HD><<<Z * n_strips, THREADS, dq_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(stats), Tn, n_strips);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kt<T, HD><<<Z * n_strips, THREADS, dkdv_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(stats), Tn, n_strips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kt

bool bad_shape(int Z, int Tn, int hd) {
  return Z < 1 || Tn < 1 || hd < 8 || hd > 64 || hd % 8 != 0;
}

}  // namespace

extern "C" {

// Which kernels a call of dtype (0 = float32, 1 = bfloat16) at T runs: 0 the
// register-resident ones (bf16, T <= 256), 1 the key-tiled ones.
int flash_attention_key_tiled(int T, int dtype) {
  return dtype == 1 && T <= rs::T_REG ? 0 : 1;
}

// o [Z, T, hd] = softmax(q k^T) v. dtype: 0 = float32, 1 = bfloat16 (q, k, v
// and o); flash_attention_key_tiled says which kernels run. Returns a
// cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int Z, int T, int hd, int dtype, void* stream) {
  if (bad_shape(Z, T, hd) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash_attention_key_tiled(T, dtype))
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_fwd<decltype(HD)::value>(q, k, v, o, Z, T, s);
    });
  return rs::by_hd(hd, [&](auto HD) {
    constexpr int H = decltype(HD)::value;
    return dtype == 0 ? kt::launch_fwd<float, H>(q, k, v, o, Z, T, s)
                      : kt::launch_fwd<__nv_bfloat16, H>(q, k, v, o, Z, T, s);
  });
}

// dq, dk, dv [Z, T, hd] from q, k, v, dout; stats is a [Z, 3, T] float32
// scratch. dtype as above. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* stats, int Z, int T, int hd, int dtype,
                        void* stream) {
  if (bad_shape(Z, T, hd) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash_attention_key_tiled(T, dtype))
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_bwd<decltype(HD)::value>(q, k, v, dout, dq, dk, dv,
                                                  stats, Z, T, s);
    });
  return rs::by_hd(hd, [&](auto HD) {
    constexpr int H = decltype(HD)::value;
    return dtype == 0
               ? kt::launch_bwd<float, H>(q, k, v, dout, dq, dk, dv, stats,
                                          Z, T, s)
               : kt::launch_bwd<__nv_bfloat16, H>(q, k, v, dout, dq, dk, dv,
                                                  stats, Z, T, s);
  });
}

}  // extern "C"
