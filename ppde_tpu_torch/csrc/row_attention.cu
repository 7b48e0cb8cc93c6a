// Kernels T and T': the tied row attention of the MSA Transformer, forward
// and backward, for Hopper (sm_90a).
//
// Replace no Pallas TPU kernel: the JAX package writes tied row attention as
// two einsums (ppde_tpu/models/msa_transformer.py: _tied_row_attention),
// which XLA lays out itself. The port's plain composition copies q, k and v
// into [B, H, C, R*hd] (a head width of R*hd, 2,048 at msa-1b's 32 rows,
// which kernels C and C' do not take) and materialises the float32 scores.
// For q, k, v [N, R, C, H, hd] (row r, column c, head h of alignment n: the
// q, k, v projections' own layout, contiguous), one softmax per (n, h) over
// the column pairs, shared by every row:
//
//     s    = scale sum_r q_r k_r^T        [C, C] float32 (q_r: row r's [C, hd])
//     w32  = softmax(s) (row max subtracted)           float32
//     o_r  = cast(w32) v_r                [C, hd] in the input type
//
// and for dout [N, R, C, H, hd], recomputing w32 from q and k:
//
//     w    = cast(w32),  dw = sum_r dout_r v_r^T,  delta = rowsum(w dw)
//     ds   = cast(w (dw - delta))
//     dq_r = cast(scale ds k_r),  dk_r = cast(scale ds^T q_r),
//     dv_r = cast(w^T dout_r)
//
// Every product sums in float32; cast rounds to the input type. w is rounded
// before delta and ds as autograd's softmax backward reads a softmax held in
// the input type. The plain PyTorch versions with these rounding points are
// ops/row_attention_fused.py: tied_row_attention_plain and _bwd_plain.
//
// What bounds them on the H100: the bytes. Each of q, k, v and o is N R C H
// hd elements; the products are 4 N H C^2 R hd operations forward (two) and
// 10 backward (five), so at msa-1b's widths over GFP's alignment (R = 32, C
// = 238, H = 12, hd = 64, bf16) one alignment's layer moves 46.8 MB forward,
// 14.0 us at 3.35 TB/s, against 5.6 us of the tensor cores' 989 TFLOP/s.
// So the kernels read q, k, v and dout where the projections wrote them and
// write o, dq, dk, dv there, each once: no copy in another layout.
//
// bf16 with C <= 256 and hd a multiple of 16 (every msa-1b call on GFP),
// the register kernels (namespace rs): the design of kernel C's register
// kernels (csrc/flash_attention.cu, whose mma.sync / ldmatrix helpers are
// copied here: each source builds alone), with the summed index of the
// scores running over the R rows. A block is one 64-column strip of one
// (n, h), 4 warps of 16 rows; a warp holds its 16 score rows against all
// columns in registers (128 float32 a thread at C = 256). Forward: the
// strip of q_r and all of k_r are staged row after row (double-buffered
// cp.async, the next row's copy in flight while this row's products run)
// and their products summed into the scores; the softmax by quad shuffles
// with the scale folded into the exponent; the weights packed to bf16 A
// fragments (64 registers), then v_r staged row after row and o_r = w v_r
// written at once. The dq half (T' first kernel) does the same for w, then
// dw = sum_r dout_r v_r^T into the same registers, delta and ds in place of
// w, and dq_r = ds k_r row after row; it writes w and ds ([N H, C, C padded
// to 64], bf16, a tenth of the tensors' bytes) to a scratch. The dk/dv half
// owns a strip of 64 key columns: it stages the strip's slab of w (then of
// ds), all C query rows, takes its A fragments transposed by ldmatrix.trans
// (the keys' rows against the summed queries) and walks the rows: dv_r = w^T
// dout_r, then dk_r = ds^T q_r. Blocks of one (n, h) follow each other, so
// the 4 strips read k_r and v_r from L2 after the first. No atomics: the
// outputs repeat bit for bit.
//
// float32, C > 256, or hd not a multiple of 16 (namespace gen): SIMT
// kernels with the same rounding points, for the float32 type and the CPU
// tests' shapes on the card. The sums of products are tiled as in a plain
// SIMT matrix product (a block 64 x 64 outputs, a thread 4 x 4, slabs
// staged in shared memory): the scores s = sum_r q_r k_r^T (and dw = sum_r
// dout_r v_r^T) into a float32 scratch [N H, C, C]; a block per score row
// then takes its softmax (and delta, ds) in place by block reductions; the
// outputs, a block per 64 columns of one row r, sum the scratch's rows (or,
// transposed, its columns) against v, k, q or dout. They take any C up to
// 2,048.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// a float32 value rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// bf16, C <= 256, hd a multiple of 16: scores in registers
// ---------------------------------------------------------------------------
namespace rs {

constexpr int C_REG = 256;          // the largest C these kernels take
constexpr int NG = C_REG / 16;      // 16-column groups of a score row
constexpr int WARPS = 4;            // a block: one strip of 64 columns
constexpr int THREADS = 32 * WARPS;
constexpr int STRIP = 16 * WARPS;
constexpr int SS = STRIP + 8;       // row stride of a staged slab (elements)
constexpr float L2E = 1.4426950408889634f;  // log2(e)

// Row stride (elements) of a staged [rows, hd] operand: rows of 2 hd + 16
// bytes, an odd number of 16-byte bank groups at hd = 16, 32, 48, 64, so
// the 8 rows an ldmatrix reads fall on 8 different groups.
template <int HD>
constexpr int kSP = HD + 8;
template <int HD>
constexpr int kK16 = HD / 16;
// bytes between two 16-row groups of a staged operand
template <int HD>
constexpr uint32_t kGroup = 16 * kSP<HD> * 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float hi_of(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
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

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// FOR_GROUPS(c, ng4) { ... }: the body for every 16-column group c of the
// first ng4 64-column chunks, unrolled, with one runtime test per chunk (as
// in flash_attention.cu: every index into the score and fragment arrays a
// compile-time constant, so that they stay in registers).
#define FOR_GROUPS(c, ng4)                                         \
  _Pragma("unroll") for (int c##_4 = 0; c##_4 < NG / 4; ++c##_4) \
    if (c##_4 < (ng4))                                             \
      _Pragma("unroll") for (int c = 4 * c##_4; c < 4 * c##_4 + 4; ++c)

// Rows c0 .. c0+rows-1 of one (n, r, h) slice into dst [rows, kSP]; the
// slice's row c starts at src + c ld; rows from Cn on are zero. 16-byte
// cp.async (the caller commits the group).
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      size_t ld, int c0, int rows, int Cn) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  const uint32_t base = saddr(dst);
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int row = i / CPR, ch = i % CPR, c = c0 + row;
    const bool in = c < Cn;
    cp_async16(base + row * (kSP<HD> * 2) + ch * 16,
               src + (size_t)(in ? c : 0) * ld + ch * 8, in ? 16 : 0);
  }
}

// The [Cp, 64] slab of a scratch [Cn, Cp] (row stride Cp) whose first
// column is src, into dst [Cp, SS]; rows from Cn on are zero.
__device__ __forceinline__ void stage_slab(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int Cp, int Cn) {
  constexpr int CPR = STRIP / 8;
  const uint32_t base = saddr(dst);
  for (int i = threadIdx.x; i < Cp * CPR; i += THREADS) {
    const int row = i / CPR, ch = i % CPR;
    const bool in = row < Cn;
    cp_async16(base + row * (SS * 2) + ch * 16,
               src + (size_t)(in ? row : 0) * Cp + ch * 8, in ? 16 : 0);
  }
}

// Lane addresses for the B operand of 16-column group c (add c * kGroup
// bytes): cols_addr reads 16 staged rows as the columns of a first product
// (ldmatrix), sum_addr reads 16 staged rows as the summed index of a second
// product (ldmatrix.trans).
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

// Scores of a warp's 16 rows against all columns, s[j][e]: n8 tile j, row g
// (e < 2) or g + 8, column 8 j + 2 tig + (e & 1).
using Scores = float[2 * NG][4];
// The same, packed to bf16 as the A fragments of a second product: p[c] is
// group c's {tile 2c rows g, g + 8; tile 2c + 1 rows g, g + 8}.
using Packed = uint32_t[NG][4];

__device__ __forceinline__ void zero_scores(Scores& s, int ng4) {
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = 0.f;
  }
}

// s += rows * cols^T over hd: a warp's 16 staged rows against all staged
// rows of another operand.
template <int HD>
__device__ __forceinline__ void add_scores(Scores& s, const bf16* rows,
                                           const bf16* cols, int ng4,
                                           int lane) {
  uint32_t a[kK16<HD>][4];
  const uint32_t abase =
      saddr(rows + (lane & 15) * kSP<HD> + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < kK16<HD>; ++kk) ldsm4(a[kk], abase + kk * 32);
  const uint32_t b = cols_addr<HD>(cols, lane);
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int kk = 0; kk < kK16<HD>; ++kk) {
      uint32_t f[4];
      ldsm4(f, b + c * kGroup<HD> + kk * 32);
      mma_bf16(s[2 * c], a[kk], f[0], f[1]);
      mma_bf16(s[2 * c + 1], a[kk], f[2], f[3]);
    }
  }
}

// Softmax of scale * s by rows, in place: float32, the row max subtracted
// (sl2e = scale log2(e) folded into the exponent), columns >= Cn set to 0.
__device__ __forceinline__ void softmax(Scores& s, int ng4, int Cn, int lane,
                                        float sl2e) {
  const int pad_from = Cn - 2 * (lane & 3);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
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
  float ml[2], sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    ml[h] = mx[h] * sl2e;
    sum[h] = 0.f;
  }
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int j = 2 * c; j < 2 * c + 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], sl2e, -ml[e >> 1]));
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

__device__ __forceinline__ void pack(Packed& p, const Scores& s, int ng4) {
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        p[c][2 * t + h] =
            pack_bf16(s[2 * c + t][2 * h], s[2 * c + t][2 * h + 1]);
  }
}

// o += a * B over one 16-row step of the summed index: a is the packed A
// fragment of that step, B's 16 rows at b (sum_addr).
template <int HD>
__device__ __forceinline__ void step_product(float (&o)[HD / 8][4],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
#pragma unroll
  for (int n2 = 0; n2 < kK16<HD>; ++n2) {
    uint32_t f[4];
    ldsm4t(f, b + n2 * 32);
    mma_bf16(o[2 * n2], a, f[0], f[1]);
    mma_bf16(o[2 * n2 + 1], a, f[2], f[3]);
  }
}

// o = p * (all staged rows of B), the summed index over the groups.
template <int HD>
__device__ __forceinline__ void product(float (&o)[HD / 8][4], const Packed& p,
                                        const bf16* B, int ng4, int lane) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const uint32_t b = sum_addr<HD>(B, lane);
  FOR_GROUPS(c, ng4) { step_product<HD>(o, p[c], b + c * kGroup<HD>); }
}

// A warp's 16 output rows (row0 ..) of one (n, r, h) slice, row c at
// dst + c ld, times mul, cast to bf16.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t ld,
                                           const float (&o)[HD / 8][4],
                                           int row0, int Cn, int lane,
                                           float mul) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= Cn) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * ld + nt * 8 + 2 * tig) =
          pack_bf16(o[nt][2 * h] * mul, o[nt][2 * h + 1] * mul);
  }
}

// A warp's packed rows (row0 ..) into a scratch [Cn, Cp].
__device__ __forceinline__ void store_packed(bf16* __restrict__ dst, int Cp,
                                             const Packed& p, int row0,
                                             int Cn, int ng4, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  FOR_GROUPS(c, ng4) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + g + 8 * h;
        if (r < Cn)
          *reinterpret_cast<uint32_t*>(dst + (size_t)r * Cp + 16 * c + 8 * t +
                                       2 * tig) = p[c][2 * t + h];
      }
  }
}

// The block's place: the strip, and (n, h)'s element offset of (r = 0,
// c = 0) in the [N, R, C, H, hd] tensors.
struct Place {
  int strip, z;
  size_t base;
};

template <int HD>
__device__ __forceinline__ Place place(int R, int Cn, int H, int n_strips) {
  const int strip = blockIdx.x % n_strips, z = blockIdx.x / n_strips;
  const int h = z % H, n = z / H;
  return {strip, z,
          (size_t)n * R * Cn * H * HD + (size_t)h * HD};
}

// s = sum_r a_r b_r^T: a warp's rows of a's strip against all of b's rows,
// a_r and b_r staged row after row (double-buffered: the next row's copy in
// flight while this row's products run). smem: [2][STRIP][kSP] for a, then
// [2][Cp][kSP] for b.
template <int HD>
__device__ __forceinline__ void row_sum_scores(
    Scores& s, const bf16* __restrict__ a, const bf16* __restrict__ b,
    size_t base, size_t ld, size_t row_step, int R, int c0, int Cn, int Cp,
    int ng4, bool active, unsigned char* smem, int warp, int lane) {
  constexpr int SP = kSP<HD>;
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + 2 * STRIP * SP;
  zero_scores(s, ng4);
  stage<HD>(sa, a + base, ld, c0, STRIP, Cn);
  stage<HD>(sb, b + base, ld, 0, Cp, Cn);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int cur = r & 1;
    if (r + 1 < R) {
      stage<HD>(sa + (cur ^ 1) * STRIP * SP, a + base + (r + 1) * row_step,
                ld, c0, STRIP, Cn);
      stage<HD>(sb + (cur ^ 1) * Cp * SP, b + base + (r + 1) * row_step, ld,
                0, Cp, Cn);
      cp_async_commit();
    }
    if (active)
      add_scores<HD>(s, sa + cur * STRIP * SP + 16 * warp * SP,
                     sb + cur * Cp * SP, ng4, lane);
    if (r + 1 < R) cp_async_wait_all();
    __syncthreads();
  }
}

// out_r = mul * p x_r for every row r: x_r (all Cp rows) staged row after
// row into smem [2][Cp][kSP], a warp's 16 rows of out_r written at once.
template <int HD>
__device__ __forceinline__ void row_products(
    bf16* __restrict__ out, const Packed& p, const bf16* __restrict__ x,
    size_t base, size_t ld, size_t row_step, int R, int row0, int Cn, int Cp,
    int ng4, bool active, float mul, unsigned char* smem, int lane) {
  constexpr int SP = kSP<HD>;
  bf16* sx = reinterpret_cast<bf16*>(smem);
  stage<HD>(sx, x + base, ld, 0, Cp, Cn);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int cur = r & 1;
    if (r + 1 < R) {
      stage<HD>(sx + (cur ^ 1) * Cp * SP, x + base + (r + 1) * row_step, ld,
                0, Cp, Cn);
      cp_async_commit();
    }
    if (active) {
      float acc[HD / 8][4];
      product<HD>(acc, p, sx + cur * Cp * SP, ng4, lane);
      store_rows<HD>(out + base + r * row_step, ld, acc, row0, Cn, lane, mul);
    }
    if (r + 1 < R) cp_async_wait_all();
    __syncthreads();
  }
}

// Kernel T. Block (64-column strip, (n, h)); warp w owns columns c0 + 16 w
// ...: o_r = cast(softmax(scale sum_r q_r k_r^T)) v_r.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    row_fwd_rs(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int R,
               int Cn, int H, int n_strips, float sl2e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (Cn + 63) & ~63, ng4 = Cp / 64;
  const Place at = place<HD>(R, Cn, H, n_strips);
  const size_t ld = (size_t)H * HD, row_step = (size_t)Cn * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = at.strip * STRIP, row0 = c0 + 16 * warp;
  const bool active = row0 < Cn;  // warps past C only copy and wait
  Scores s;
  row_sum_scores<HD>(s, q, k, at.base, ld, row_step, R, c0, Cn, Cp, ng4,
                     active, smem, warp, lane);
  Packed p;
  if (active) {
    softmax(s, ng4, Cn, lane, sl2e);
    pack(p, s, ng4);
  }
  row_products<HD>(o, p, v, at.base, ld, row_step, R, row0, Cn, Cp, ng4,
                   active, 1.f, smem, lane);
}

// Kernel T', first half. Block (64 query columns, (n, h)): w as kernel T
// forms it, then dw = sum_r dout_r v_r^T in the same registers, delta and
// ds = cast(w (dw - delta)) in place of w, and dq_r = scale ds k_r. w and ds
// go to the scratches ws, dss [N H, Cn, Cp] for the second half.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    row_bwd_dq_rs(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, bf16* __restrict__ ws,
                  bf16* __restrict__ dss, int R, int Cn, int H, int n_strips,
                  float sl2e, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (Cn + 63) & ~63, ng4 = Cp / 64;
  const Place at = place<HD>(R, Cn, H, n_strips);
  const size_t ld = (size_t)H * HD, row_step = (size_t)Cn * ld;
  const size_t sc = (size_t)at.z * Cn * Cp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = at.strip * STRIP, row0 = c0 + 16 * warp;
  const bool active = row0 < Cn;
  Scores s;
  Packed p;
  row_sum_scores<HD>(s, q, k, at.base, ld, row_step, R, c0, Cn, Cp, ng4,
                     active, smem, warp, lane);
  if (active) {
    softmax(s, ng4, Cn, lane, sl2e);
    pack(p, s, ng4);
    store_packed(ws + sc, Cp, p, row0, Cn, ng4, lane);
  }
  row_sum_scores<HD>(s, dout, v, at.base, ld, row_step, R, c0, Cn, Cp, ng4,
                     active, smem, warp, lane);
  if (active) {
    float dl[2] = {0.f, 0.f};
    FOR_GROUPS(c, ng4) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = p[c][2 * t + h];
          dl[h] += lo_of(w) * s[2 * c + t][2 * h] +
                   hi_of(w) * s[2 * c + t][2 * h + 1];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
      dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
    }
    FOR_GROUPS(c, ng4) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = p[c][2 * t + h];
          p[c][2 * t + h] =
              pack_bf16(lo_of(w) * (s[2 * c + t][2 * h] - dl[h]),
                        hi_of(w) * (s[2 * c + t][2 * h + 1] - dl[h]));
        }
    }
    store_packed(dss + sc, Cp, p, row0, Cn, ng4, lane);
  }
  row_products<HD>(dq, p, k, at.base, ld, row_step, R, row0, Cn, Cp, ng4,
                   active, scale, smem, lane);
}

// One pass of the second half: out_r = mul * slab^T x_r for every row r,
// the slab (a strip of 64 key columns of w or ds, all query rows) taken
// transposed as a warp's A fragments (its 16 keys against the queries).
template <int HD>
__device__ __forceinline__ void transposed_products(
    bf16* __restrict__ out, const bf16* __restrict__ slab_src,
    const bf16* __restrict__ x, size_t base, size_t ld, size_t row_step,
    int R, int row0, int Cn, int Cp, int ng4, bool active, float mul,
    unsigned char* smem, int warp, int lane) {
  constexpr int SP = kSP<HD>;
  bf16* slab = reinterpret_cast<bf16*>(smem);  // [Cp, SS]
  bf16* sx = slab + C_REG * SS;                // [2][Cp][SP]
  stage_slab(slab, slab_src, Cp, Cn);
  stage<HD>(sx, x + base, ld, 0, Cp, Cn);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  Packed a;
  if (active) {
    // rows 16 c .. of the slab (queries) by the warp's 16 columns (keys),
    // transposed: ldmatrix.trans of the four 8 x 8 blocks
    const uint32_t base_a =
        saddr(slab + ((lane & 7) + ((lane >> 4) << 3)) * SS + 16 * warp +
              ((lane >> 3) & 1) * 8);
    FOR_GROUPS(c, ng4) { ldsm4t(a[c], base_a + c * 16 * SS * 2); }
  }
  __syncthreads();  // the slab's space is not reused, but keep phases apart
  for (int r = 0; r < R; ++r) {
    const int cur = r & 1;
    if (r + 1 < R) {
      stage<HD>(sx + (cur ^ 1) * Cp * SP, x + base + (r + 1) * row_step, ld,
                0, Cp, Cn);
      cp_async_commit();
    }
    if (active) {
      float acc[HD / 8][4];
      product<HD>(acc, a, sx + cur * Cp * SP, ng4, lane);
      store_rows<HD>(out + base + r * row_step, ld, acc, row0, Cn, lane, mul);
    }
    if (r + 1 < R) cp_async_wait_all();
    __syncthreads();
  }
}

// Kernel T', second half. Block (64 key columns, (n, h)): dv_r = w^T
// dout_r, then dk_r = scale ds^T q_r, from the first half's scratches.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    row_bwd_dkdv_rs(const bf16* __restrict__ q, const bf16* __restrict__ dout,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    const bf16* __restrict__ ws,
                    const bf16* __restrict__ dss, int R, int Cn, int H,
                    int n_strips, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (Cn + 63) & ~63, ng4 = Cp / 64;
  const Place at = place<HD>(R, Cn, H, n_strips);
  const size_t ld = (size_t)H * HD, row_step = (size_t)Cn * ld;
  const size_t sc = (size_t)at.z * Cn * Cp + at.strip * STRIP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = at.strip * STRIP + 16 * warp;
  const bool active = row0 < Cn;
  transposed_products<HD>(dv, ws + sc, dout, at.base, ld, row_step, R, row0,
                          Cn, Cp, ng4, active, 1.f, smem, warp, lane);
  transposed_products<HD>(dk, dss + sc, q, at.base, ld, row_step, R, row0,
                          Cn, Cp, ng4, active, scale, smem, warp, lane);
}

template <int HD>
size_t fwd_smem(int Cp) {
  return (size_t)2 * (STRIP + Cp) * kSP<HD> * sizeof(bf16);
}

template <int HD>
size_t dkdv_smem(int Cp) {
  return ((size_t)C_REG * SS + (size_t)2 * Cp * kSP<HD>) * sizeof(bf16);
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int N,
               int R, int Cn, int H, float scale, cudaStream_t stream) {
  const int Cp = (Cn + 63) & ~63, n_strips = Cp / STRIP;
  const size_t bytes = fwd_smem<HD>(Cp);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(row_fwd_rs<HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_fwd_rs<HD><<<N * H * n_strips, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), R, Cn, H, n_strips,
      scale * L2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* scratch, int N, int R,
               int Cn, int H, float scale, cudaStream_t stream) {
  const int Cp = (Cn + 63) & ~63, n_strips = Cp / STRIP;
  bf16* ws = static_cast<bf16*>(scratch);
  bf16* dss = ws + (size_t)N * H * Cn * Cp;
  const size_t dq_bytes = fwd_smem<HD>(Cp), dkdv_bytes = dkdv_smem<HD>(Cp);
  cudaError_t err = allow_smem(row_bwd_dq_rs<HD>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(row_bwd_dkdv_rs<HD>, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_bwd_dq_rs<HD><<<N * H * n_strips, THREADS, dq_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), ws, dss, R, Cn, H, n_strips, scale * L2E,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_bwd_dkdv_rs<HD><<<N * H * n_strips, THREADS, dkdv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, dss, R, Cn, H,
      n_strips, scale);
  return static_cast<int>(cudaGetLastError());
}

// hd (a multiple of 16 up to 64) as a template argument
template <typename F>
int by_hd(int hd, F f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    default: return f(std::integral_constant<int, 64>{});
  }
}

}  // namespace rs

// ---------------------------------------------------------------------------
// any type, any C up to 2,048: plain SIMT kernels over a float32 scratch
// ---------------------------------------------------------------------------
namespace gen {

constexpr int THREADS = 256;
constexpr int J = 8;  // score columns a thread holds: C <= THREADS * J
constexpr int C_MAX = THREADS * J;
constexpr int TILE = 64;  // a block's output tile: TILE x TILE
constexpr int KS = 16;    // summed elements staged at a time (scores)
constexpr int KA = 32;    // summed columns staged at a time (apply)
constexpr int TS = TILE + 4;  // row stride of a staged tile (floats)

// The block's sum (or max) of v; red holds 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < THREADS / 32; ++w)
    v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// Block (tile of 64 x 64 column pairs, (n, h)): s[z, c, e] = sum_r sum_d
// a[n, r, c, h, d] b[n, r, e, h, d] into the float32 scratch [N H, Cn, Cn].
// A thread sums 4 x 4 pairs (rows 4 ty + i, columns 4 tx + j; its operands
// read 16 bytes at a time) over staged slabs of 64 columns by KS head dims
// of one row r.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    scores(const T* __restrict__ a, const T* __restrict__ b,
           float* __restrict__ s, int R, int Cn, int H, int hd) {
  __shared__ __align__(16) float sa[KS][TS], sb[KS][TS];
  const int c0 = blockIdx.x * TILE, e0 = blockIdx.y * TILE, z = blockIdx.z;
  const int h = z % H, n = z / H, tx = threadIdx.x % 16,
            ty = threadIdx.x / 16;
  const size_t ld = (size_t)H * hd, row_step = (size_t)Cn * ld;
  const size_t base = (size_t)n * R * row_step + (size_t)h * hd;
  float acc[4][4] = {};
  for (int r = 0; r < R; ++r) {
    const size_t off = base + r * row_step;
    for (int d0 = 0; d0 < hd; d0 += KS) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < TILE * KS / THREADS; ++u) {
        const int i = threadIdx.x + THREADS * u, row = i / KS, d = i % KS;
        const bool in = d0 + d < hd;
        const int ca = c0 + row, cb = e0 + row;
        sa[d][row] = in && ca < Cn ? to_f(a[off + (size_t)ca * ld + d0 + d])
                                   : 0.f;
        sb[d][row] = in && cb < Cn ? to_f(b[off + (size_t)cb * ld + d0 + d])
                                   : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sa[kk][4 * ty]);
        const float4 y4 = *reinterpret_cast<const float4*>(&sb[kk][4 * tx]);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
  }
  float* sz = s + (size_t)z * Cn * Cn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c >= Cn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + 4 * tx + j;
      if (e < Cn) sz[(size_t)c * Cn + e] = acc[i][j];
    }
  }
}

// Block (row c, (n, h)): the scratch's row c of sums (of q_r k_r^T) in
// place by its softmax, softmax(scale * row).
__global__ void __launch_bounds__(THREADS)
    softmax_rows(float* __restrict__ w, int Cn, float scale) {
  __shared__ float red[32];
  float* row = w + ((size_t)blockIdx.y * Cn + blockIdx.x) * Cn;
  float acc[J], mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = threadIdx.x + THREADS * j;
    acc[j] = cc < Cn ? row[cc] * scale : 0.f;
    if (cc < Cn) mx = fmaxf(mx, acc[j]);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    acc[j] = threadIdx.x + THREADS * j < Cn ? expf(acc[j] - mx) : 0.f;
    sum += acc[j];
  }
  sum = block_reduce<false>(sum, red);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = threadIdx.x + THREADS * j;
    if (cc < Cn) row[cc] = acc[j] / sum;
  }
}

// Block (row c, (n, h)): with ds's row c holding dw = sum_r dout_r v_r^T's,
// w rounded to T in place, delta = rowsum(w dw), ds = rnd(w (dw - delta)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ds_rows(float* __restrict__ w, float* __restrict__ ds, int Cn) {
  __shared__ float red[32];
  const size_t at = ((size_t)blockIdx.y * Cn + blockIdx.x) * Cn;
  float* wrow = w + at;
  float* drow = ds + at;
  float wv[J], dw[J], delta = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = threadIdx.x + THREADS * j;
    wv[j] = cc < Cn ? rnd<T>(wrow[cc]) : 0.f;
    dw[j] = cc < Cn ? drow[cc] : 0.f;
    delta += wv[j] * dw[j];
  }
  delta = block_reduce<false>(delta, red);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = threadIdx.x + THREADS * j;
    if (cc >= Cn) continue;
    wrow[cc] = wv[j];
    drow[cc] = rnd<T>(wv[j] * (dw[j] - delta));
  }
}

// Block (tile of 64 columns c, row r, (n, h)): out[n, r, c, h, :] =
// rnd(mul sum_c' m[c, c'] x[n, r, c', h, :]), m = rnd(the scratch [Cn, Cn]
// of (n, h)), or its transpose where TRANS. A thread sums 4 x 4 outputs
// (columns 4 ty + i, head dims 4 tx + j) over staged slabs of KA c'.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
    apply(const float* __restrict__ m, const T* __restrict__ x,
          T* __restrict__ out, int Cn, int H, int hd, float mul) {
  __shared__ __align__(16) float sm[KA][TS], sx[KA][TS];
  const int c0 = blockIdx.x * TILE, r = blockIdx.y, z = blockIdx.z;
  const int h = z % H, n = z / H, tx = threadIdx.x % 16,
            ty = threadIdx.x / 16;
  const int R = gridDim.y;
  const size_t ld = (size_t)H * hd, row_step = (size_t)Cn * ld;
  const size_t off =
      (size_t)n * R * row_step + r * row_step + (size_t)h * hd;
  const float* mz = m + (size_t)z * Cn * Cn;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Cn; k0 += KA) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < TILE * KA / THREADS; ++u) {
      const int i = threadIdx.x + THREADS * u;
      // m's slab, read along its rows: c' fastest unless TRANS
      const int row = TRANS ? i % TILE : i / KA, kk = TRANS ? i / TILE
                                                            : i % KA;
      const int c = c0 + row, k = k0 + kk;
      sm[kk][row] = c < Cn && k < Cn
                        ? rnd<T>(TRANS ? mz[(size_t)k * Cn + c]
                                       : mz[(size_t)c * Cn + k])
                        : 0.f;
      const int xk = i / TILE, d = i % TILE;
      sx[xk][d] = k0 + xk < Cn && d < hd
                      ? to_f(x[off + (size_t)(k0 + xk) * ld + d])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KA; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sm[kk][4 * ty]);
      const float4 y4 = *reinterpret_cast<const float4*>(&sx[kk][4 * tx]);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], y[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c >= Cn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * tx + j;
      if (d < hd) out[off + (size_t)c * ld + d] = from_f<T>(acc[i][j] * mul);
    }
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* scratch, int N, int R, int Cn, int H, int hd,
               float scale, cudaStream_t s) {
  float* w = static_cast<float*>(scratch);
  const int tiles = (Cn + TILE - 1) / TILE;
  scores<T><<<dim3(tiles, tiles, N * H), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), w, R, Cn, H, hd);
  softmax_rows<<<dim3(Cn, N * H), THREADS, 0, s>>>(w, Cn, scale);
  apply<T, false><<<dim3(tiles, R, N * H), THREADS, 0, s>>>(
      w, static_cast<const T*>(v), static_cast<T*>(o), Cn, H, hd, 1.f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* scratch, int N, int R,
               int Cn, int H, int hd, float scale, cudaStream_t s) {
  float* w = static_cast<float*>(scratch);
  float* ds = w + (size_t)N * H * Cn * Cn;
  const int tiles = (Cn + TILE - 1) / TILE;
  const dim3 pairs(tiles, tiles, N * H), rows(Cn, N * H),
      outs(tiles, R, N * H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* dot = static_cast<const T*>(dout);
  scores<T><<<pairs, THREADS, 0, s>>>(qt, kt, w, R, Cn, H, hd);
  softmax_rows<<<rows, THREADS, 0, s>>>(w, Cn, scale);
  scores<T><<<pairs, THREADS, 0, s>>>(dot, static_cast<const T*>(v), ds, R,
                                      Cn, H, hd);
  ds_rows<T><<<rows, THREADS, 0, s>>>(w, ds, Cn);
  apply<T, false><<<outs, THREADS, 0, s>>>(ds, kt, static_cast<T*>(dq), Cn,
                                           H, hd, scale);
  apply<T, true><<<outs, THREADS, 0, s>>>(ds, qt, static_cast<T*>(dk), Cn, H,
                                          hd, scale);
  apply<T, true><<<outs, THREADS, 0, s>>>(w, dot, static_cast<T*>(dv), Cn, H,
                                          hd, 1.f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen

bool bad_shape(int N, int R, int C, int H, int hd, int dtype) {
  return N < 1 || R < 1 || C < 1 || C > gen::C_MAX || H < 1 || hd < 8 ||
         hd > 64 || hd % 8 != 0 || (long long)N * H > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Which kernels a call of dtype (0 = float32, 1 = bfloat16) at C columns and
// head width hd runs: 0 the register kernels (bf16, C <= 256, hd a multiple
// of 16), 1 the SIMT kernels.
int row_attention_generic(int C, int hd, int dtype) {
  return dtype == 1 && C <= rs::C_REG && hd % 16 == 0 ? 0 : 1;
}

// Bytes of the scratch a call needs (backward: 1, forward: 0).
long long row_attention_scratch_bytes(int N, int C, int H, int hd, int dtype,
                                      int backward) {
  const long long z = (long long)N * H;
  if (!row_attention_generic(C, hd, dtype)) {
    const long long Cp = (C + 63) / 64 * 64;
    return backward ? 2 * z * C * Cp * 2 : 0;
  }
  return (backward ? 2 : 1) * z * C * C * 4;
}

// o [N, R, C, H, hd] = tied row attention of q, k, v [N, R, C, H, hd]
// (contiguous); scratch holds row_attention_scratch_bytes(..., 0) bytes.
// Returns a cudaError_t.
int row_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      void* scratch, int N, int R, int C, int H, int hd,
                      float scale, int dtype, void* stream) {
  if (bad_shape(N, R, C, H, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!row_attention_generic(C, hd, dtype))
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_fwd<decltype(HD)::value>(q, k, v, o, N, R, C, H,
                                                 scale, s);
    });
  return dtype == 0 ? gen::launch_fwd<float>(q, k, v, o, scratch, N, R, C, H,
                                             hd, scale, s)
                    : gen::launch_fwd<bf16>(q, k, v, o, scratch, N, R, C, H,
                                            hd, scale, s);
}

// dq, dk, dv [N, R, C, H, hd] from q, k, v, dout; scratch holds
// row_attention_scratch_bytes(..., 1) bytes. Returns a cudaError_t.
int row_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      void* scratch, int N, int R, int C, int H, int hd,
                      float scale, int dtype, void* stream) {
  if (bad_shape(N, R, C, H, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!row_attention_generic(C, hd, dtype))
    return rs::by_hd(hd, [&](auto HD) {
      return rs::launch_bwd<decltype(HD)::value>(q, k, v, dout, dq, dk, dv,
                                                 scratch, N, R, C, H, scale,
                                                 s);
    });
  return dtype == 0
             ? gen::launch_bwd<float>(q, k, v, dout, dq, dk, dv, scratch, N,
                                      R, C, H, hd, scale, s)
             : gen::launch_bwd<bf16>(q, k, v, dout, dq, dk, dv, scratch, N, R,
                                     C, H, hd, scale, s);
}

}  // extern "C"
