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
// What bounds it on the H100: the operations of the embed product
// (2*B*M*T*C*C2; the conv on one-hot patches and the routed backward need
// far fewer): on the tensor cores in bf16, on the FMA units (67 TFLOP/s) in
// float32; the bytes moved (x, dx, the weights) are small. Both kernels run
// one persistent block per SM that stays on one member and walks samples
// b = blockIdx.x, blockIdx.x + gridDim.x, ... (the schedule of _kernel_m),
// so a member's weights are read from L2, not from device memory, and
// stream through a ring of shared-memory slots (cp.async.bulk, completion
// counted on mbarriers; a slot is refilled SLOTS tiles ahead as soon as
// every warp has released it, so the loads of the next tiles and of the
// next sample overlap the work).
//
// Design of the bfloat16 kernel (namespace tc).
//   * Grid (SMs / M) x M blocks of 512 threads (four warpgroups of 64 rows).
//   * Weights are prepared once on the host (ops/cnn_fused.prepare_ensemble)
//     as tiles in the layout wgmma reads (rows of 128 bytes, 128-byte
//     swizzle); the ring carries enc_w (conv), emb_w chunk by chunk, enc_w
//     again (dP).
//   * Conv: H1[t] = rnd(relu(b + sum over the nonzero letters of the patch
//     of a row of enc_w)): for a one-hot sample K rows of the tile in the
//     ring, 8 channels a lane, no product over the zeros.
//   * Embed: H1 (bf16, swizzled, all T <= 256 rows) is the shared-memory A
//     operand of wgmma m64n96k16; the column maxima come straight from the
//     accumulators (max, + bias, relu and rounding commute), and only the
//     warps that hold a column's maximum look for the rows that reach it:
//     per row a bitmask of routed channels.
//   * Backward: each lane lists the channels of one row; a quarter warp
//     gathers the rows of emb_w^T of one row of G1, every load started before
//     the first is used, and writes G1 over H1. dP = G1 @ enc_w^T runs on
//     wgmma m64n104k16, is staged as float32 over G1, and col2im is one sum
//     of K terms per entry of dx in a fixed order.
//   * One accumulator array serves both products: wgmma pins accumulators to
//     fixed registers, and a second array would cost its size in registers
//     for the whole kernel (the first cuts spilled for that reason).
//
// Design of the float32 kernel (namespace simt; the CLI's default
// --compute_dtype f32). Its arithmetic stays float32 FMAs (no TF32, no
// split-bf16 products). With 8 warps a SM (a block of 256 threads holds
// 255 registers each), every phase that is not a product is a chain of
// latencies unless its loads are issued together, so each is laid out with
// a lane (or a quarter warp) per item.
//   * Grid (SMs / M) x M blocks of 256 threads; the ring carries emb_w in
//     column chunks of 128 and enc_w^T, in 16-deep stages of 8 KB, laid out
//     once by prepare_ensemble so that each stage is one contiguous copy.
//   * A float32 H1 of 233 x 240 (224 KB) does not fit beside a ring, so the
//     rows t go in blocks of 128: H1 of a block is the shared-memory A
//     operand [128][C + pad] of the embed product.
//   * Conv: for one-hot positions a gather-add of K rows of enc_w (exact),
//     a float4 of 4 channels a thread, two of them at a time with all their
//     rows' loads issued first; positions that are not one-hot sum every
//     nonzero letter's row.
//   * Products (embed, dP): each thread holds an 8 x 8 register tile (rows
//     4 + 4 apart by 64, columns likewise) fed by 16-byte shared-memory
//     loads, 16 loads per 256 FMAs.
//   * Max-pool: the column maxima of a chunk come from the accumulators (a
//     max per thread, then over the 16 thread rows); each row block updates
//     the running maximum of a channel, and the threads whose sum reaches it
//     set their rows in the channel's tie mask (no serial scan over rows).
//   * Backward: no second conv. A bitmask of H1 > 0 (T x C bits) is kept
//     from the forward pass; each row lists its routed channels once (a
//     lane a row); a quarter warp gathers a row of G1 from the emb_w^T rows
//     of its channels, four rows a warp, every load of two channels issued
//     before the first is used (rows with more than 8 channels, wide ties,
//     fall back to a warp scanning the tie masks); dP = G1 @ enc_w^T is the
//     second product, staged over G1, and col2im sums K terms per entry of
//     dx in a fixed order, adding to what the previous row block left.
// Design of the wide kernel (namespace wide; both types, every shape the
// other two do not take: wild types longer than 256 residues, whose
// reference-width CNN has C = L, or wider ensembles). No length or
// channel limit; K*V <= 128.
//   * Grid B x M blocks of 256 threads, one per (sample, member); the
//     tokens of x (one-hot letter and value, else -1) from a first kernel.
//   * Products on FMAs in float32; bf16 runs on the bf16-rounded weights'
//     values (prepare_ensemble's wide layout, float32) with H1, H2, the
//     routed gradient and G1 rounded to bf16 where the other kernels round.
//   * Forward: T in strips of 32 rows, 2C in chunks of 512 columns. H1^T
//     of a strip, 1,024 channels at a time (rnd(relu(conv + b)), a lane a
//     channel), is the shared-memory A operand; emb_w streams from L2 in
//     16-row stages (cp.async, two buffers); each thread holds an 8 x 8
//     tile. A chunk's column maxima, the rows that reach them and the
//     first of them come from the accumulators by integer atomics in
//     shared memory (H2 >= 0: its bits order as its values); they fold
//     into running statistics in device memory (a larger max restarts
//     them), and each strip's rows at the running max go to device memory
//     as one word of bits a channel. A strip before the one that first
//     reached a channel's final max marked smaller values, so the
//     backward reads the words from that strip on: no T x 2C mask.
//   * Backward, strip by strip: each channel's routed rows of the strip (a
//     word), the strip's relu' bits recomputed from the conv, G1 gathered
//     a warp a row from the routed rows of emb_w^T, then dP = G1 enc_w^T
//     as a product and col2im, one thread per entry of dx in a fixed
//     order, added to what the strips before wrote.
// Blocks of different members write separate [M, B, L*V] partials, and a
// second kernel adds them in member order: no atomics on values (the integer
// atomics on the pool's masks and counts commute), so results repeat bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// Built with -DCNN_PHASE_CLOCKS (tools/profile_port_step.py --phases), thread
// 0 of block (0, 0) adds the clocks each phase of a sample took into
// g_phase_clocks; otherwise PHASE_TICK is empty. Both kernels tick the same
// eight phases.
#ifdef CNN_PHASE_CLOCKS
__device__ long long g_phase_clocks[8];
#define PHASE_TICK(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {    \
    const long long now_ = clock64();                              \
    g_phase_clocks[i] += now_ - phase_t0;                          \
    phase_t0 = now_;                                               \
  }
#else
#define PHASE_TICK(i)
#endif

// ---------------------------------------------------------------------------
// bfloat16: a persistent block per (member, stride of samples); weights
// stream through a ring of shared-memory slots; products on wgmma
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;             // four warpgroups
constexpr int ROWS = 256;                // rows t of a sample: T <= ROWS
constexpr int MB = ROWS / 64 / (THREADS / 128);  // 64-row blocks of each
constexpr int KB = 64;                   // depth of a tile: 128-byte rows
constexpr int MAX_C = 256;               // conv channels: 4 tiles deep
constexpr int MAX_C2 = 512;              // embed channels
constexpr int NCH = 96;                  // embed columns per chunk (wgmma n)
constexpr int NDP = 104;                 // K*V padded (wgmma n of dP)
constexpr int SLOTS = 4;                 // ring of weight tiles
constexpr int EMB_BYTES = NCH * KB * 2;       // an emb_w tile [96][64]
constexpr int ENC_BYTES = NDP * KB * 2;       // an enc_w tile [104][64]
constexpr int SLOT_BYTES = ENC_BYTES;         // the larger of the two
constexpr int H1_TILE = ROWS * KB * 2;        // an H1 tile [256][64]
constexpr int RMW = MAX_C2 / 32 + 1;     // words per row of the routed mask
                                         // (odd: rows fall in all banks)
constexpr int RPW = ROWS / (THREADS / 32);  // rows a warp gathers
constexpr int LISTCAP = 64;              // routed pairs a warp lists at once
constexpr int DPS = NDP + 4;             // row stride of the staged dP
constexpr int GB = 8;                    // rows of emb_w^T in flight per lane

struct TcArgs {
  const bf16* x;        // [B, L*V]
  const bf16* enc_blob; // [M, 4, 104, 64]   tiles of enc_w, [j][c]
  const bf16* emb_blob; // [M, nchunk, 4, 96, 64]  tiles of emb_w^T, [c2][c]
  const bf16* embwT;    // [M, C2, 256]      rows of emb_w^T, zero-padded
  const float* encb;    // [M, 256]
  const float* embb;    // [M, nchunk * 96]
  const bf16* decw;     // [M, C2]
  const float* decb;    // [M]
  float* pred;          // [M, B]      scratch
  float* dxm;           // [M, B, L*V] scratch
  int B, L, V, K, C, C2, M, pool_first, nchunk;
};

constexpr int MAX_LV = 5248;             // elements of one sample: L * V
constexpr int MAX_L = 320;               // positions of one sample

// Shared memory in bytes: fixed offsets from the block's (1024-aligned)
// dynamic shared memory, so that every access has a constant address.
namespace lay {
constexpr int h1 = 0;  // H1, then G1: 4 tiles [256][64]; then dP f32 [256][DPS]
constexpr int ring = h1 + 4 * H1_TILE;              // weight tiles
constexpr int rowmask = ring + SLOTS * SLOT_BYTES;  // routed channels by row
constexpr int mx = rowmask + ROWS * RMW * 4;        // per channel: max,
constexpr int scale = mx + (MAX_C2 + NCH) * 4;      //   routed gradient,
constexpr int first = scale + (MAX_C2 + NCH) * 4;   //   first row of the max,
constexpr int cnt = first + (MAX_C2 + NCH) * 4;     //   rows that reach it
constexpr int xr = cnt + (MAX_C2 + NCH) * 4;  // x (bf16); later maxima, lists
constexpr int nz = xr + MAX_LV * 2;                 // nonzero letters by position
constexpr int tok = nz + MAX_L * 4;           // (letter, value) of one-hot ones
constexpr int bars = tok + MAX_L * 8;               // 2 * SLOTS mbarriers
constexpr int red = bars + 2 * SLOTS * 8;           // partial sums of pred
constexpr int embb = red + THREADS / 32 * 4;        // embed biases,
constexpr int decw = embb + (MAX_C2 + NCH) * 4;     //   decoder weights (f32),
constexpr int encb = decw + MAX_C2 * 4;             //   conv biases
constexpr int relaxed = encb + MAX_C * 4;     // 1: a position is not one-hot
constexpr int hit = relaxed + 16;  // per warp: columns whose max it may hold
constexpr int total = hit + THREADS / 32 * (NCH / 32) * 4;
static_assert(MAX_LV * 2 >= THREADS / 32 * LISTCAP * 4 &&
                  MAX_LV * 2 >= THREADS / 32 * NCH * 4,
              "the x region also holds the column maxima and the pair lists");
static_assert(total <= 232448, "more than a block's shared memory");
}  // namespace lay

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// K-major bf16 tile with 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// d[64 x N] += a[64 x 16] * b[N x 16]^T from shared memory (wgmma96: N = 96,
// the first 48 of d; else N = 104); the _first form overwrites d and only
// writes it, so that the accumulators are dead between two chains
__device__ __forceinline__ void wgmma96_k16(float (&d)[52], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma96_k16_first(float (&d)[52], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_k16(float (&d)[52], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_k16_first(float (&d)[52], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// the two bf16 values of a 32-bit word, as float32
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
// byte offset of 16-byte chunk `chunk` of row r in a swizzled tile
__device__ __forceinline__ int sw(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}


__global__ void __launch_bounds__(THREADS, 1)
fit_grad_kernel(const TcArgs a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if (smem_u32(smem_raw) & 1023u) __trap();  // the swizzle needs this base
  unsigned char* h1 = smem + lay::h1;
  unsigned char* ring = smem + lay::ring;
  unsigned* rowmask = reinterpret_cast<unsigned*>(smem + lay::rowmask);
  float* mx = reinterpret_cast<float*>(smem + lay::mx);
  float* scale = reinterpret_cast<float*>(smem + lay::scale);
  int* first = reinterpret_cast<int*>(smem + lay::first);
  int* cntc = reinterpret_cast<int*>(smem + lay::cnt);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay::xr);
  float* pmax = reinterpret_cast<float*>(smem + lay::xr);
  unsigned* lists = reinterpret_cast<unsigned*>(smem + lay::xr);
  unsigned* nzm = reinterpret_cast<unsigned*>(smem + lay::nz);
  int2* tokv = reinterpret_cast<int2*>(smem + lay::tok);
  float* embb = reinterpret_cast<float*>(smem + lay::embb);
  float* decw = reinterpret_cast<float*>(smem + lay::decw);
  float* encb = reinterpret_cast<float*>(smem + lay::encb);
  int* relaxed = reinterpret_cast<int*>(smem + lay::relaxed);
  unsigned* hitm = reinterpret_cast<unsigned*>(smem + lay::hit);
  float* red = reinterpret_cast<float*>(smem + lay::red);
  const uint32_t full0 = smem_u32(smem + lay::bars), empty0 = full0 + SLOTS * 8;
  const uint32_t ring_u = smem_u32(ring), h1_u = smem_u32(h1);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m = blockIdx.y;
  const int n_t = a.L - a.K + 1, LV = a.L * a.V;
  const int nkb = (a.C + KB - 1) / KB, ksteps = (a.C + 15) / 16;

  const int g = lane >> 2, tig = lane & 3, wg = warp / 4, wq = warp & 3;
  // this thread's rows: r0 + mb * 64 + {0, 8}
  const int r0 = wg * 64 * MB + wq * 16 + g;
  const bf16* embwT = a.embwT + (size_t)m * a.C2 * MAX_C;

  // The weight tiles every sample needs, in the order they are used: nkb
  // tiles of enc_w (conv), nchunk * nkb of emb_w, nkb of enc_w again (dP).
  // Tile i lives in slot i % SLOTS. Thread 0 refills a slot with tile
  // i + SLOTS as soon as every warp has released tile i.
  const int per_sample = nkb * (2 + a.nchunk);
  const uint32_t n_tiles =
      (uint32_t)((a.B - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
      per_sample;
  auto slot_of = [](uint32_t i) { return i % SLOTS; };
  // Every thread computes the copy's operands; only `leader` starts it,
  // by predicated instructions: no branch diverges next to the wgmmas.
  auto refill = [&](uint32_t i, bool leader) {
    const int r = (int)(i % per_sample), e = r - nkb * (1 + a.nchunk);
    const bool is_enc = r < nkb || e >= 0;
    const int ch = (r - nkb) / nkb, kb = (r - nkb) % nkb;
    const char* src =
        is_enc ? reinterpret_cast<const char*>(a.enc_blob) +
                     ((size_t)m * 4 + (e >= 0 ? e : r)) * ENC_BYTES
               : reinterpret_cast<const char*>(a.emb_blob) +
                     (((size_t)m * a.nchunk + ch) * 4 + kb) * EMB_BYTES;
    const int bytes = is_enc ? ENC_BYTES : EMB_BYTES;
    const uint32_t bar = full0 + slot_of(i) * 8;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%2], [%3], %1, [%0];\n}\n" ::"r"(bar),
        "r"(bytes), "r"(ring_u + slot_of(i) * SLOT_BYTES), "l"(src),
        "r"((int)(leader && i < n_tiles))
        : "memory");
  };
  auto wait_full = [&](uint32_t i) {
    mbar_wait(full0 + slot_of(i) * 8, (i / SLOTS) & 1);
  };
  // This warp is done with tile i: lane 0 arrives. Warp 0 waits until all
  // warps have, then its lane 0 refills the slot with tile i + SLOTS.
  const bool refiller = __shfl_sync(0xffffffffu, warp, 0) == 0;
  auto done = [&](uint32_t i) {
    __syncwarp();
    const uint32_t bar = empty0 + slot_of(i) * 8;
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
        "r"(lane)
        : "memory");
    if (refiller) {
      mbar_wait(bar, (i / SLOTS) & 1);
      refill(i + SLOTS, lane == 0);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full0 + s * 8, 1);
      mbar_init(empty0 + s * 8, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (uint32_t i = 0; i < SLOTS; ++i) refill(i, tid == 0);
  for (int c = tid; c < a.nchunk * NCH; c += THREADS)
    embb[c] = a.embb[(size_t)m * a.nchunk * NCH + c];
  for (int c = tid; c < a.C2; c += THREADS)
    decw[c] = __bfloat162float(a.decw[(size_t)m * a.C2 + c]);
  for (int c = tid; c < MAX_C; c += THREADS) encb[c] = a.encb[m * MAX_C + c];
  auto fetch_x = [&](int b) {  // sample b into xs, asynchronously
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(a.x + (size_t)b * LV);
    const uint32_t dst = smem_u32(xs);
    for (int i = tid; i < LV / 2; i += THREADS)
      cp_async4(dst + i * 4, src + i);
  };
  fetch_x(blockIdx.x);
  __syncthreads();

  uint32_t n = 0;  // tiles consumed so far
  // One accumulator array for both products (embed: the first 48 of each
  // row block; dP: all 52): wgmma pins its accumulators to fixed registers,
  // and two arrays would hold twice as many for the whole kernel.
  float acc[MB][NDP / 2];
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    // -- the sample (fetched ahead); clear the pool's statistics --
    {
      for (int i = tid; i < ROWS * RMW; i += THREADS) rowmask[i] = 0u;
      for (int c = tid; c < MAX_C2; c += THREADS) {
        cntc[c] = 0;
        first[c] = INT_MAX;
      }
      if (tid == 0) *relaxed = 0;
      cp_async_wait_all();
    }
    __syncthreads();
    // each position's nonzero letters; one-hot positions get (letter, value)
    for (int l = warp; l < a.L; l += THREADS / 32) {
      const float xv =
          lane < a.V ? __bfloat162float(xs[l * a.V + lane]) : 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, xv != 0.f);
      const int v = __ffs(bal) - 1;
      const float val = __shfl_sync(0xffffffffu, xv, v < 0 ? 0 : v);
      if (lane == 0) {
        nzm[l] = bal;
        tokv[l] = make_int2(v, __float_as_int(val));
        if (__popc(bal) != 1) *relaxed = 1;
      }
    }
    __syncthreads();

    PHASE_TICK(0)  // sample fetched, statistics cleared, letters listed
    // -- H1 = rnd(relu(conv + b)), tile by tile of 64 channels: for every
    // nonzero letter of the patch one row of enc_w from the tile in the
    // ring. Four rows at a time per warp; a one-hot sample takes the
    // straight path, whose loads do not wait on each other --
    const bool onehot = *relaxed == 0;
    for (int kb = 0; kb < nkb; ++kb) {
      wait_full(n);
      const unsigned char* tile = ring + slot_of(n) * SLOT_BYTES;
      const int rsub = lane >> 3, ch8 = lane & 7;  // row of 4, chunk of 8
      const int c = kb * KB + ch8 * 8;             // this lane's 8 channels
      float bias[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) bias[q] = encb[c + q];
      for (int t = warp * 4 + rsub; t < ROWS; t += 4 * (THREADS / 32)) {
        float sacc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) sacc[q] = 0.f;
        auto add = [&](int j, float xv) {
          const uint4 w = *reinterpret_cast<const uint4*>(tile + sw(j, ch8));
          const unsigned ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sacc[2 * q] = fmaf(xv, bf_lo(ww[q]), sacc[2 * q]);
            sacc[2 * q + 1] = fmaf(xv, bf_hi(ww[q]), sacc[2 * q + 1]);
          }
        };
        if (t < n_t) {
          if (onehot) {
#pragma unroll 5
            for (int k = 0; k < a.K; ++k) {
              const int2 tv = tokv[t + k];
              add(k * a.V + tv.x, __int_as_float(tv.y));
            }
          } else {
            for (int k = 0; k < a.K; ++k) {
              unsigned mk = nzm[t + k];
              while (mk) {
                const int v = __ffs(mk) - 1;
                mk &= mk - 1;
                add(k * a.V + v, __bfloat162float(xs[(t + k) * a.V + v]));
              }
            }
          }
        }
        unsigned o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok0 = t < n_t && c + 2 * q < a.C;
          const bool ok1 = t < n_t && c + 2 * q + 1 < a.C;
          const __nv_bfloat162 r2 = __floats2bfloat162_rn(
              ok0 ? fmaxf(sacc[2 * q] + bias[2 * q], 0.f) : 0.f,
              ok1 ? fmaxf(sacc[2 * q + 1] + bias[2 * q + 1], 0.f) : 0.f);
          o[q] = (unsigned)__bfloat16_as_ushort(r2.x) |
                 ((unsigned)__bfloat16_as_ushort(r2.y) << 16);
        }
        *reinterpret_cast<uint4*>(h1 + kb * H1_TILE + sw(t, ch8)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
      done(n);
      ++n;
    }
    for (int kb = nkb; kb < 4; ++kb)  // tiles beyond C: zero (G1 reads them)
      for (int i = tid; i < H1_TILE / 16; i += THREADS)
        reinterpret_cast<uint4*>(h1 + kb * H1_TILE)[i] =
            make_uint4(0u, 0u, 0u, 0u);
    fence_async_proxy();
    __syncthreads();

    PHASE_TICK(1)  // conv
    // -- H2 = rnd(relu(H1 @ emb_w + b)) in chunks of 96 columns; column
    // maxima and routed rows straight from the accumulators --
    for (int ch = 0; ch < a.nchunk; ++ch) {
      for (int kb = 0; kb < nkb; ++kb) {
        wait_full(n);
        wgmma_fence();
        const uint64_t db = wgmma_desc(ring_u + slot_of(n) * SLOT_BYTES);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const uint64_t da = wgmma_desc(h1_u + kb * H1_TILE +
                                         (wg * MB + mb) * 64 * 128);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (kb * 4 + ks < ksteps) {
              if (kb == 0 && ks == 0) wgmma96_k16_first(acc[mb], da, db);
              else wgmma96_k16(acc[mb], da + 2 * ks, db + 2 * ks);
            }
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          done(n - 1);
        }
        ++n;
      }
      wgmma_wait<0>();
      done(n - 1);
      PHASE_TICK(2)  // embed product (all chunks)

      // the largest sum of each column: adding the bias, the relu and the
      // rounding are monotone, so they are applied to the maximum alone
      bool ok[MB][2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          ok[mb][hf] = r0 + mb * 64 + hf * 8 < n_t;
#pragma unroll
      for (int ni = 0; ni < NCH / 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float best = -INFINITY;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              best = fmaxf(best, ok[mb][hf] ? acc[mb][ni * 4 + hf * 2 + j]
                                            : -INFINITY);
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 4));
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 8));
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
          if (g == 0) pmax[warp * NCH + ni * 8 + tig * 2 + j] = best;
        }
      __syncthreads();
      // A sum x > 0 rounds (to nearest, ties to even) to the bf16 value with
      // bits b exactly when its own bits lie in [b - 0x8000 + odd,
      // b + 0x8000 - odd], odd the lowest kept bit of b. One thread per
      // column takes the maximum over the warps and notes which warps hold
      // a sum that rounds to it (columns past C2 have zero weights: max 0).
      if (tid < NCH) {
        const float bias = embb[ch * NCH + tid];
        float raw = -INFINITY;
        for (int w = 0; w < THREADS / 32; ++w)
          raw = fmaxf(raw, pmax[w * NCH + tid]);
        const float best = rb(fmaxf(raw + bias, 0.f));
        mx[ch * NCH + tid] = best;
        const unsigned bb = __float_as_uint(best), odd = (bb >> 16) & 1u;
        const unsigned lo = bb - 0x8000u + odd, span = 0x10000u - 2u * odd;
        for (int w = 0; w < THREADS / 32; ++w) {
          const bool hit =
              best > 0.f &&  // a dead channel routes nothing
              __float_as_uint(pmax[w * NCH + tid] + bias) - lo <= span;
          const unsigned bal = __ballot_sync(0xffffffffu, hit);
          if (lane == 0) hitm[w * (NCH / 32) + warp] = bal;
        }
      }
      __syncthreads();
      // the rows that reach the maximum after rounding, in the warps noted
#pragma unroll
      for (int wd = 0; wd < NCH / 32; ++wd) {
        const unsigned hits = hitm[warp * (NCH / 32) + wd];
        if (hits == 0u) continue;  // warp-uniform
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ni = wd * 4 + n4, col = ni * 8 + tig * 2 + j;
            if (!((hits >> (col & 31)) & 1u)) continue;
            const int c2 = ch * NCH + col;
            const float best = mx[c2], bias = embb[c2];
            const unsigned bb = __float_as_uint(best), odd = (bb >> 16) & 1u;
            const unsigned lo = bb - 0x8000u + odd, span = 0x10000u - 2u * odd;
#pragma unroll
            for (int mb = 0; mb < MB; ++mb)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const unsigned u =
                    __float_as_uint(acc[mb][ni * 4 + hf * 2 + j] + bias);
                if (ok[mb][hf] && u - lo <= span) {
                  const int r = r0 + mb * 64 + hf * 8;
                  if (a.pool_first) {
                    atomicMin(&first[c2], r);
                  } else {
                    atomicAdd(&cntc[c2], 1);
                    atomicOr(&rowmask[r * RMW + (c2 >> 5)], 1u << (c2 & 31));
                  }
                }
              }
          }
      }
      PHASE_TICK(3)  // pool: maxima and routed rows (all chunks)
    }
    __syncthreads();

    // -- pred_m and the routed gradient per channel --
    {
      float s = 0.f;
      for (int c = tid; c < a.C2; c += THREADS) {
        const float d = decw[c];
        const float best = mx[c];
        s += best * d;
        const int cn = a.pool_first ? 1 : cntc[c];
        scale[c] = best > 0.f ? rb(d / (float)cn) : 0.f;
        if (a.pool_first && best > 0.f)
          atomicOr(&rowmask[first[c] * RMW + (c >> 5)], 1u << (c & 31));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w];
      a.pred[(size_t)m * a.B + b] = s + a.decb[m];
    }

    PHASE_TICK(4)  // pred and routed gradients
    // -- G1 = rnd([H1 > 0] * sum_{c routed to t} scale[c] * emb_w^T[c]),
    // written over H1; a warp takes RPW consecutive rows. Each lane lists
    // the channels of one row. With at most four a row (no wide ties), a
    // quarter of the warp takes a row, four rows at a time, every row of
    // emb_w^T loaded before the first is used; channels ascending --
    {
      const int tbase = warp * RPW;
      int mine = 0;           // channels routed to row tbase + lane
      unsigned c01 = 0u, c23 = 0u;  // the first four, 16 bits each
      if (lane < RPW && tbase + lane < n_t)
        for (int w = 0; w < (a.C2 + 31) / 32; ++w) {
          unsigned bits = rowmask[(tbase + lane) * RMW + w];
          while (bits) {
            const unsigned c = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            if (mine < 2) c01 |= c << (16 * mine);
            else if (mine < 4) c23 |= c << (16 * (mine - 2));
            ++mine;
          }
        }
      if (!__any_sync(0xffffffffu, mine > 4)) {
        const int q = lane >> 3, l8 = lane & 7;  // row of four, chunk of 8
        for (int i = 0; i < RPW; i += 4) {
          const int cnt = __shfl_sync(0xffffffffu, mine, i + q);
          const unsigned p01 = __shfl_sync(0xffffffffu, c01, i + q);
          const unsigned p23 = __shfl_sync(0xffffffffu, c23, i + q);
          const int tt = tbase + i + q;
          float acc[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {  // pairs 0, 1 then 2, 3
            if (!__any_sync(0xffffffffu, cnt > 2 * jp)) break;
            const unsigned pp = jp ? p23 : p01;
            uint4 rows[2][4];
            float sc[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // past this row's last channel: channel 0 times zero
              const bool on = 2 * jp + j < cnt;
              const unsigned c = on ? (pp >> (16 * j)) & 0xffffu : 0u;
              sc[j] = on ? scale[c] : 0.f;
#pragma unroll
              for (int kb = 0; kb < 4; ++kb)
                rows[j][kb] = __ldg(reinterpret_cast<const uint4*>(
                    embwT + (size_t)c * MAX_C + kb * KB + l8 * 8));
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int kb = 0; kb < 4; ++kb) {
                const unsigned rw[4] = {rows[j][kb].x, rows[j][kb].y,
                                        rows[j][kb].z, rows[j][kb].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[kb * 8 + 2 * e] =
                      fmaf(sc[j], bf_lo(rw[e]), acc[kb * 8 + 2 * e]);
                  acc[kb * 8 + 2 * e + 1] =
                      fmaf(sc[j], bf_hi(rw[e]), acc[kb * 8 + 2 * e + 1]);
                }
              }
          }
#pragma unroll
          for (int kb = 0; kb < 4; ++kb) {
            unsigned char* p = h1 + kb * H1_TILE + sw(tt, l8);
            const uint4 hv = *reinterpret_cast<const uint4*>(p);
            const unsigned hw[4] = {hv.x, hv.y, hv.z, hv.w};
            unsigned o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 r2 = __floats2bfloat162_rn(
                  bf_lo(hw[e]) > 0.f ? acc[kb * 8 + 2 * e] : 0.f,
                  bf_hi(hw[e]) > 0.f ? acc[kb * 8 + 2 * e + 1] : 0.f);
              o[e] = (unsigned)__bfloat16_as_ushort(r2.x) |
                     ((unsigned)__bfloat16_as_ushort(r2.y) << 16);
            }
            *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
      } else {
      // wide ties: the warp lists its rows' (row, channel) pairs, rows and
      // channels ascending, then loads GB rows of emb_w^T at a time
      unsigned* list = lists + warp * LISTCAP;
      float acc[8];
      int cur_t = -1;
      auto flush = [&](int t) {  // this lane's columns lane*8 .. lane*8+7
        unsigned char* p = h1 + (lane >> 3) * H1_TILE + sw(t, lane & 7);
        const uint4 hv = *reinterpret_cast<const uint4*>(p);
        const unsigned hw[4] = {hv.x, hv.y, hv.z, hv.w};
        unsigned o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float lo = bf_lo(hw[q]) > 0.f ? acc[2 * q] : 0.f;
          const float hi = bf_hi(hw[q]) > 0.f ? acc[2 * q + 1] : 0.f;
          const __nv_bfloat162 r2 = __floats2bfloat162_rn(lo, hi);
          o[q] = (unsigned)__bfloat16_as_ushort(r2.x) |
                 ((unsigned)__bfloat16_as_ushort(r2.y) << 16);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
      };
      int t = tbase - 1;  // the row being enumerated
      unsigned word = 0u, nzw = 0u, bits = 0u;
      int w = 0;
      bool more = true;
      while (more) {
        int cnt = 0;
        while (cnt < LISTCAP) {  // warp-uniform enumeration
          if (bits) {
            const int c = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            if (lane == 0) list[cnt] = ((unsigned)t << 16) | (unsigned)c;
            ++cnt;
          } else if (nzw) {
            w = __ffs(nzw) - 1;
            nzw &= nzw - 1;
            bits = __shfl_sync(0xffffffffu, word, w);
          } else {
            ++t;
            if (t >= tbase + RPW) {
              more = false;
              break;
            }
            word = t < n_t && lane < RMW ? rowmask[t * RMW + lane] : 0u;
            nzw = __ballot_sync(0xffffffffu, word != 0u);
            if (nzw == 0u)  // nothing routed here: G1's row is zero
              *reinterpret_cast<uint4*>(h1 + (lane >> 3) * H1_TILE +
                                        sw(t, lane & 7)) =
                  make_uint4(0u, 0u, 0u, 0u);
          }
        }
        __syncwarp();
        for (int i0 = 0; i0 < cnt; i0 += GB) {
          uint4 rows[GB];
#pragma unroll
          for (int i = 0; i < GB; ++i)  // past the end: the last pair again
            rows[i] = __ldg(reinterpret_cast<const uint4*>(
                embwT +
                (size_t)(list[min(i0 + i, cnt - 1)] & 0xffffu) * MAX_C +
                lane * 8));
#pragma unroll
          for (int i = 0; i < GB; ++i)
            if (i0 + i < cnt) {
              const unsigned e = list[i0 + i];
              const int tt = (int)(e >> 16);
              if (tt != cur_t) {
                if (cur_t >= 0) flush(cur_t);
                cur_t = tt;
#pragma unroll
                for (int q = 0; q < 8; ++q) acc[q] = 0.f;
              }
              const float sc = scale[e & 0xffffu];
              const unsigned rw[4] = {rows[i].x, rows[i].y, rows[i].z,
                                      rows[i].w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[2 * q] = fmaf(sc, bf_lo(rw[q]), acc[2 * q]);
                acc[2 * q + 1] = fmaf(sc, bf_hi(rw[q]), acc[2 * q + 1]);
              }
            }
        }
        __syncwarp();
      }
      if (cur_t >= 0) flush(cur_t);
      }
    }
    fence_async_proxy();
    __syncthreads();

    PHASE_TICK(5)  // gather of G1
    // -- dP = G1 @ enc_w^T on the tensor cores, staged as float32 over G1;
    // then col2im: dx[pos, v] = sum_k dP[pos - k, k*V + v], k ascending,
    // one thread per entry (no two threads meet, every sum has one order) --
    {
      if (b + (int)gridDim.x < a.B) fetch_x(b + gridDim.x);  // xs is free
      for (int kb = 0; kb < nkb; ++kb) wait_full(n + kb);
      wgmma_fence();
      for (int kb = 0; kb < nkb; ++kb) {
        const uint64_t db = wgmma_desc(ring_u + slot_of(n + kb) * SLOT_BYTES);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const uint64_t da = wgmma_desc(h1_u + kb * H1_TILE +
                                         (wg * MB + mb) * 64 * 128);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (kb * 4 + ks < ksteps) {
              if (kb == 0 && ks == 0) wgmma_k16_first(acc[mb], da, db);
              else wgmma_k16(acc[mb], da + 2 * ks, db + 2 * ks);
            }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();  // every warpgroup has read G1: dP may overwrite it
      for (int kb = 0; kb < nkb; ++kb) done(n + kb);
      n += nkb;
      float* dps = reinterpret_cast<float*>(h1);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int ni = 0; ni < NDP / 8; ++ni)
            *reinterpret_cast<float2*>(dps + (r0 + mb * 64 + hf * 8) * DPS +
                                       ni * 8 + tig * 2) =
                make_float2(acc[mb][ni * 4 + hf * 2],
                            acc[mb][ni * 4 + hf * 2 + 1]);
      __syncthreads();
      PHASE_TICK(6)  // dP product and staging
      float* out = a.dxm + ((size_t)m * a.B + b) * LV;
      for (int f = tid; f < LV; f += THREADS) {
        const int pos = f / a.V, v = f - pos * a.V;
        float sum = 0.f;
        for (int k = 0; k < a.K; ++k) {
          const int t = pos - k;
          if (t >= 0 && t < n_t) sum += dps[t * DPS + k * a.V + v];
        }
        out[f] = sum;
      }
    }
    __syncthreads();  // dP is read before the next sample's conv writes H1
    PHASE_TICK(7)  // col2im and store
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: a persistent block per (member, stride of samples); weights
// stream through a ring of shared-memory slots; products on FMAs from 8 x 8
// register tiles; rows in blocks of 128
// ---------------------------------------------------------------------------
namespace simt {

using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;

constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int R = 128;              // rows t of a row block
constexpr int NT = 128;             // columns of a product: an embed chunk,
                                    // dP (8 x 8 a thread)
constexpr int KS = 16;              // depth of a weight stage
constexpr int SLOTS = 4;            // ring of weight stages
constexpr int STAGE_FLOATS = KS * NT;
constexpr int STAGE_BYTES = STAGE_FLOATS * 4;  // 8 KB
constexpr int MAX_C = 256;          // conv channels
constexpr int MAX_C2 = 512;         // embed channels: 4 chunks of NT
constexpr int MAX_T = 256;          // rows t: 2 row blocks
constexpr int MAX_L = 384;          // positions: T + K - 1 with K*V <= 128
constexpr int LDA = MAX_C + 4;      // row stride of the A operand (floats):
                                    // rows 4 apart fall in other banks
constexpr int LDP = NT + 4;         // row stride of the staged dP
constexpr int TW = MAX_T / 32 + 1;  // words per channel of the tie mask
                                    // (odd: channels fall in all banks)
constexpr int HW = MAX_C / 32;      // words per row of the H1 > 0 mask
constexpr int LCAP = 8;             // routed channels a row lists (more:
                                    // the row scans the tie masks)
constexpr int KFAST = 5;            // taps of the one-hot conv's fast path

struct F32Args {
  const float* x;      // [B, L*V]
  const float* encw;   // [M, K*V, Cp]          rows of enc_w (conv)
  const float* encT;   // [M, Cp, 128]          enc_w^T (dP's B operand)
  const float* emb;    // [M, nchunk, Cp, 128]  emb_w in column chunks
  const float* embwT;  // [M, C2, Cp]           rows of emb_w^T (G1)
  const float* encb;   // [M, Cp]
  const float* embb;   // [M, nchunk * 128]
  const float* decw;   // [M, C2]
  const float* decb;   // [M]
  float* pred;         // [M, B]      scratch
  float* dxm;          // [M, B, L*V] scratch
  int B, L, V, K, C, C2, M, pool_first, Cp, nchunk;
};

// Shared memory in bytes, fixed offsets from the block's (1024-aligned)
// dynamic shared memory.
namespace lay {
constexpr int a = 0;  // H1, then G1, of a row block [R][LDA]; then dP
constexpr int ring = a + R * LDA * 4;               // weight stages
constexpr int tie = ring + SLOTS * STAGE_BYTES;     // rows at each max
constexpr int pm = tie + MAX_C2 * TW * 4;           // column maxima [8][NT];
constexpr int rowlist = pm;                         //   backward: channels
constexpr int rowcnt = rowlist + MAX_T * LCAP * 2;  //   routed to each row
constexpr int bmx = rowcnt + MAX_T * 4;             // a chunk's block maxima
constexpr int mx = bmx + NT * 4;                    // per channel: max,
constexpr int scale = mx + MAX_C2 * 4;              //   routed gradient,
constexpr int embb = scale + MAX_C2 * 4;            //   embed bias,
constexpr int decw = embb + MAX_C2 * 4;             //   decoder weight
constexpr int encb = decw + MAX_C2 * 4;             // conv biases
constexpr int h1pos = encb + MAX_C * 4;             // H1 > 0, [T][HW] bits
constexpr int tok = h1pos + MAX_T * HW * 4;         // (letter, value) by pos
constexpr int bars = tok + MAX_L * 8;               // 2 * SLOTS mbarriers
constexpr int red = bars + 2 * SLOTS * 8;           // partial sums of pred
constexpr int onehot = red + THREADS / 32 * 4;      // 1: every position is
constexpr int total = onehot + 16;                  //   one-hot
static_assert(ring % 1024 == 0 && bars % 8 == 0, "alignment");
static_assert(THREADS / 32 * NT * 4 <= bmx - pm, "the maxima and lists");
static_assert(total <= 232448, "more than a block's shared memory");
}  // namespace lay

// acc[i][j] += sum over the 16 k of one stage of A[row_i][k0 + k] *
// Bs[k][col_j]; row_i = ty*4 + i (i < 4), 64 + ty*4 + i - 4 (i >= 4); col_j
// likewise with tx. Per 4 k: 16 loads of 16 bytes, 256 FMAs. The two ty of a
// warp read A rows 4 apart (other banks; every tx the same address), its 16
// tx 256 contiguous bytes of a row of Bs.
__device__ __forceinline__ void stage_product(float (&acc)[8][8],
                                              const float* A,
                                              const float* Bs, int k0,
                                              int tx, int ty) {
  const float* a0 = A + ty * 4 * LDA + k0;
  const float* a1 = a0 + 64 * LDA;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a0 + i * LDA + kk);
      av[4 + i] = *reinterpret_cast<const float4*>(a1 + i * LDA + kk);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(Bs + (kk + s) * NT + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + (kk + s) * NT + 64 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = s == 0 ? av[i].x
                        : s == 1 ? av[i].y
                        : s == 2 ? av[i].z
                                 : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void fma4(float4& s, float x, const float4 w) {
  s.x = fmaf(x, w.x, s.x);
  s.y = fmaf(x, w.y, s.y);
  s.z = fmaf(x, w.z, s.z);
  s.w = fmaf(x, w.w, s.w);
}

__global__ void __launch_bounds__(THREADS, 1)
fit_grad_kernel(const F32Args a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  float* A = reinterpret_cast<float*>(smem + lay::a);
  const float* ring = reinterpret_cast<const float*>(smem + lay::ring);
  unsigned* tie = reinterpret_cast<unsigned*>(smem + lay::tie);
  float* pm = reinterpret_cast<float*>(smem + lay::pm);
  float* bmx = reinterpret_cast<float*>(smem + lay::bmx);
  float* mx = reinterpret_cast<float*>(smem + lay::mx);
  float* scale = reinterpret_cast<float*>(smem + lay::scale);
  float* embb = reinterpret_cast<float*>(smem + lay::embb);
  float* decw = reinterpret_cast<float*>(smem + lay::decw);
  float* encb = reinterpret_cast<float*>(smem + lay::encb);
  unsigned* h1pos = reinterpret_cast<unsigned*>(smem + lay::h1pos);
  int2* tok = reinterpret_cast<int2*>(smem + lay::tok);
  float* red = reinterpret_cast<float*>(smem + lay::red);
  unsigned short* rowlist =
      reinterpret_cast<unsigned short*>(smem + lay::rowlist);
  int* rowcnt = reinterpret_cast<int*>(smem + lay::rowcnt);
  int* onehot = reinterpret_cast<int*>(smem + lay::onehot);
  const uint32_t full0 = smem_u32(smem + lay::bars), empty0 = full0 + SLOTS * 8;
  const uint32_t ring_u = smem_u32(smem + lay::ring);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m = blockIdx.y;
  const int V = a.V, K = a.K, C2 = a.C2, Cp = a.Cp;
  const int n_t = a.L - K + 1, LV = a.L * V, KV = K * V;
  const int nks = Cp / KS, nrb = (n_t + R - 1) / R;
  const float* encw = a.encw + (size_t)m * KV * Cp;
  const float* embwT = a.embwT + (size_t)m * C2 * Cp;
  const float nan = __int_as_float(0x7fffffff);

  // The weight stages every sample needs, in the order they are used: for
  // each row block nchunk * nks of emb_w (forward), then for each row block
  // nks of enc_w^T (dP). Stage i lives in slot i % SLOTS.
  const int fwd_tiles = nrb * a.nchunk * nks;
  const int per_sample = fwd_tiles + nrb * nks;
  const uint32_t n_tiles =
      (uint32_t)((a.B - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
      per_sample;
  auto slot_of = [](uint32_t i) { return i % SLOTS; };
  // Every thread computes the copy's operands; only `leader` starts it,
  // by predicated instructions.
  auto refill = [&](uint32_t i, bool leader) {
    const int r = (int)(i % per_sample);
    const float* src;
    if (r < fwd_tiles) {
      const int q = r % (a.nchunk * nks), ch = q / nks, ks = q % nks;
      src = a.emb + (((size_t)m * a.nchunk + ch) * Cp + ks * KS) * NT;
    } else {
      const int ks = (r - fwd_tiles) % nks;
      src = a.encT + ((size_t)m * Cp + ks * KS) * NT;
    }
    const uint32_t bar = full0 + slot_of(i) * 8;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%2], [%3], %1, [%0];\n}\n" ::"r"(bar),
        "r"(STAGE_BYTES), "r"(ring_u + slot_of(i) * STAGE_BYTES), "l"(src),
        "r"((int)(leader && i < n_tiles))
        : "memory");
  };
  auto wait_full = [&](uint32_t i) {
    mbar_wait(full0 + slot_of(i) * 8, (i / SLOTS) & 1);
  };
  // This warp is done with stage i: lane 0 arrives. Warp 0 waits until all
  // warps have, then its lane 0 refills the slot with stage i + SLOTS.
  const bool refiller = __shfl_sync(0xffffffffu, warp, 0) == 0;
  auto done = [&](uint32_t i) {
    __syncwarp();
    const uint32_t bar = empty0 + slot_of(i) * 8;
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
        "r"(lane)
        : "memory");
    if (refiller) {
      mbar_wait(bar, (i / SLOTS) & 1);
      refill(i + SLOTS, lane == 0);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full0 + s * 8, 1);
      mbar_init(empty0 + s * 8, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (uint32_t i = 0; i < SLOTS; ++i) refill(i, tid == 0);
  for (int c = tid; c < a.nchunk * NT; c += THREADS)
    embb[c] = a.embb[(size_t)m * a.nchunk * NT + c];
  for (int c = tid; c < C2; c += THREADS) decw[c] = a.decw[(size_t)m * C2 + c];
  for (int c = tid; c < Cp; c += THREADS) encb[c] = a.encb[(size_t)m * Cp + c];

  uint32_t n = 0;  // stages consumed so far
  float acc[8][8];  // one accumulator array for both products
  // this thread's rows and columns of a product tile
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); };
  auto col_of = [&](int j) { return 64 * (j >> 2) + tx * 4 + (j & 3); };

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* xb = a.x + (size_t)b * LV;
    // -- each position's letter and value if it is one-hot (else -1);
    // clear the pool's statistics --
    if (tid == 0) *onehot = 1;
    __syncthreads();
    for (int l = tid; l < a.L; l += THREADS) {  // a thread per position
      int cnt = 0, first = -1;
      float val = 0.f;
#pragma unroll 4
      for (int v = 0; v < V; ++v) {
        const float xv = xb[l * V + v];
        if (xv != 0.f) {
          if (first < 0) {
            first = v;
            val = xv;
          }
          ++cnt;
        }
      }
      tok[l] = make_int2(cnt == 1 ? first : -1, __float_as_int(val));
      if (cnt != 1) *onehot = 0;
    }
    for (int i = tid; i < C2 * TW; i += THREADS) tie[i] = 0u;
    for (int c = tid; c < C2; c += THREADS) mx[c] = -INFINITY;
    __syncthreads();
    PHASE_TICK(0)  // positions listed, statistics cleared

    for (int rb = 0; rb < nrb; ++rb) {
      const int t0 = rb * R;
      // -- H1 = relu(conv + b) of rows t0 .. t0 + 127 (zero past T and
      // past C): for a one-hot position one row of enc_w. A one-hot sample
      // takes the fast path, two entries a thread at a time, whose loads
      // (K rows each) do not wait on each other --
      const int c4n = Cp / 4, n_items = R * c4n;
      if (*onehot && K <= KFAST) {
        for (int i0 = tid; i0 < n_items; i0 += 2 * THREADS) {
          float4 w[2][KFAST];
          float xv[2][KFAST];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + e * THREADS, r = i / c4n, t = t0 + r;
#pragma unroll
            for (int k = 0; k < KFAST; ++k)
              if (i < n_items && t < n_t && k < K) {
                const int2 tv = tok[t + k];
                xv[e][k] = __int_as_float(tv.y);
                w[e][k] = __ldg(reinterpret_cast<const float4*>(
                                    encw + (size_t)(k * V + tv.x) * Cp) +
                                i - r * c4n);
              }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + e * THREADS, r = i / c4n, c4 = i - r * c4n;
            if (i >= n_items) break;
            float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t0 + r < n_t) {
#pragma unroll
              for (int k = 0; k < KFAST; ++k)
                if (k < K) fma4(acc4, xv[e][k], w[e][k]);
              const float4 bb =
                  *reinterpret_cast<const float4*>(encb + c4 * 4);
              acc4 = make_float4(
                  fmaxf(acc4.x + bb.x, 0.f), fmaxf(acc4.y + bb.y, 0.f),
                  fmaxf(acc4.z + bb.z, 0.f), fmaxf(acc4.w + bb.w, 0.f));
            }
            *reinterpret_cast<float4*>(A + r * LDA + c4 * 4) = acc4;
          }
        }
      } else {
        for (int i = tid; i < n_items; i += THREADS) {
          const int r = i / c4n, c4 = i - r * c4n, t = t0 + r;
          float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < n_t) {
            for (int k = 0; k < K; ++k) {
              const int2 tv = tok[t + k];
              if (tv.x >= 0) {
                fma4(acc4, __int_as_float(tv.y),
                     __ldg(reinterpret_cast<const float4*>(
                               encw + (size_t)(k * V + tv.x) * Cp) +
                           c4));
              } else {
                for (int v = 0; v < V; ++v) {
                  const float x = xb[(t + k) * V + v];
                  if (x != 0.f)
                    fma4(acc4, x,
                         __ldg(reinterpret_cast<const float4*>(
                                   encw + (size_t)(k * V + v) * Cp) +
                               c4));
                }
              }
            }
            const float4 bb = *reinterpret_cast<const float4*>(encb + c4 * 4);
            acc4 = make_float4(
                fmaxf(acc4.x + bb.x, 0.f), fmaxf(acc4.y + bb.y, 0.f),
                fmaxf(acc4.z + bb.z, 0.f), fmaxf(acc4.w + bb.w, 0.f));
          }
          *reinterpret_cast<float4*>(A + r * LDA + c4 * 4) = acc4;
        }
      }
      __syncthreads();
      // the bits of H1 > 0, kept for the backward pass (relu'): a thread
      // per (row, word of 32 channels)
      for (int i = tid; i < R * HW; i += THREADS) {
        const int w = i / R, r = i - w * R;  // rows fastest: other banks
        unsigned bits = 0u;
        if (w * 32 < Cp) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float4 v =
                *reinterpret_cast<const float4*>(A + r * LDA + w * 32 + 4 * e);
            bits |= (unsigned)(v.x > 0.f) << (4 * e) |
                    (unsigned)(v.y > 0.f) << (4 * e + 1) |
                    (unsigned)(v.z > 0.f) << (4 * e + 2) |
                    (unsigned)(v.w > 0.f) << (4 * e + 3);
          }
        }
        h1pos[(t0 + r) * HW + w] = bits;
      }
      PHASE_TICK(1)  // conv

      // -- H2 = relu(H1 @ emb_w + b), 128 columns at a time; the maxima and
      // the rows that reach them from the accumulators --
      for (int ch = 0; ch < a.nchunk; ++ch) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        for (int ks = 0; ks < nks; ++ks) {
          wait_full(n);
          stage_product(acc, A, ring + slot_of(n) * STAGE_FLOATS, ks * KS,
                        tx, ty);
          done(n);
          ++n;
        }
        PHASE_TICK(2)  // embed product
        const int cb = ch * NT;
        // a column's maximum over the thread's rows, then over the warp's
        // two ty (lanes 16 apart), then over the warps
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bias = embb[cb + col_of(j)];
          float best = -INFINITY;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaxf(acc[i][j] + bias, 0.f);
            if (t0 + row_of(i) < n_t) best = fmaxf(best, acc[i][j]);
          }
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
          if (lane < 16) pm[warp * NT + col_of(j)] = best;
        }
        __syncthreads();
        // a column's maximum over this row block against the running one:
        // a larger one drops the rows noted so far, an equal one adds rows
        {
          const int c2 = cb + tid;
          float keep = nan;
          if (tid < NT && c2 < C2) {
            float bm = -INFINITY;
            for (int w = 0; w < THREADS / 32; ++w)
              bm = fmaxf(bm, pm[w * NT + tid]);
            const float old = mx[c2];
            if (bm > old) {
              mx[c2] = bm;
              for (int w = 0; w < TW; ++w) tie[c2 * TW + w] = 0u;
            }
            if (bm >= old) keep = bm;
          }
          if (tid < NT) bmx[tid] = keep;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float best = bmx[col_of(j)];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = t0 + row_of(i);
            if (t < n_t && acc[i][j] == best)
              atomicOr(&tie[(cb + col_of(j)) * TW + (t >> 5)],
                       1u << (t & 31));
          }
        }
        PHASE_TICK(3)  // pool
      }
      // every warp has read this block's H1 (the pool's barriers): the next
      // block's conv may overwrite it
    }
    __syncthreads();

    // -- pred_m (fixed-order reduction) and the routed gradient per channel;
    // "first" keeps the lowest tied row only --
    {
      float s = 0.f;
      for (int c = tid; c < C2; c += THREADS) {
        const float d = decw[c], best = mx[c];
        s += best * d;
        int cnt = 0;
        if (a.pool_first) {
          bool found = false;
          for (int w = 0; w < TW; ++w) {
            const unsigned word = tie[c * TW + w];
            tie[c * TW + w] = found ? 0u : word & (0u - word);
            found = found || word != 0u;
          }
          cnt = 1;
        } else {
          for (int w = 0; w < TW; ++w) cnt += __popc(tie[c * TW + w]);
        }
        scale[c] = best > 0.f ? d / (float)cnt : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w];
      a.pred[(size_t)m * a.B + b] = s + a.decb[m];
    }
    // each row's routed channels (with a gradient), ascending: the first
    // LCAP listed, and their count. A lane per row: the 32 rows of a warp
    // share each word of the tie masks it reads
    for (int t = tid; t < n_t; t += THREADS) {
      const int tw = t >> 5, bit = t & 31;
      int cnt = 0;
#pragma unroll 8
      for (int c2 = 0; c2 < C2; ++c2) {
        const unsigned word = tie[c2 * TW + tw];  // loads first: the
        const float sc = scale[c2];               // iterations overlap
        if (((word >> bit) & 1u) && sc != 0.f) {
          if (cnt < LCAP) rowlist[t * LCAP + cnt] = (unsigned short)c2;
          ++cnt;
        }
      }
      rowcnt[t] = cnt;
    }
    __syncthreads();
    PHASE_TICK(4)  // pred, routed gradients, row lists

    float* out = a.dxm + ((size_t)m * a.B + b) * LV;
    for (int rb = 0; rb < nrb; ++rb) {
      const int t0 = rb * R;
      // -- G1[t] = [H1[t] > 0] * sum_{c routed to t} scale[c] * emb_w^T[c],
      // channels ascending, written over the A operand. A quarter warp a
      // row, four rows a warp at a time, 16 bytes a load: the rows of
      // emb_w^T of two channels of each row are loaded before the first is
      // used. A row with more than LCAP channels (wide ties)
      // is left to the second loop: one warp a row scanning the tie masks,
      // four rows of emb_w^T in flight --
      {
        const int q8 = lane >> 3, l8 = lane & 7, c4n = Cp / 4;
        for (int r0 = warp * 4; r0 < R; r0 += 4 * (THREADS / 32)) {
          const int r = r0 + q8, t = t0 + r;
          const int cnt = t < n_t ? rowcnt[t] : 0;
          const int listed = cnt > LCAP ? 0 : cnt;  // > LCAP: second loop
          float4 acc4[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          int most = listed;  // warp-uniform trip count
#pragma unroll
          for (int off = 8; off < 32; off <<= 1)
            most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
          for (int u0 = 0; u0 < most; u0 += 2) {
            float4 w[2][8];
            float sc[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const bool on = u0 + u < listed;
              const int cu = on ? rowlist[t * LCAP + u0 + u] : 0;
              sc[u] = on ? scale[cu] : 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (on && l8 + 8 * j < c4n)
                  w[u][j] = __ldg(reinterpret_cast<const float4*>(
                                      embwT + (size_t)cu * Cp) +
                                  l8 + 8 * j);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (u0 + u < listed)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  if (l8 + 8 * j < c4n) fma4(acc4[j], sc[u], w[u][j]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c4 = l8 + 8 * j;
            if (c4 < c4n && cnt <= LCAP) {
              const unsigned bits =
                  t < n_t ? h1pos[t * HW + (c4 >> 3)] >> ((c4 & 7) * 4) : 0u;
              *reinterpret_cast<float4*>(A + r * LDA + 4 * c4) = make_float4(
                  bits & 1u ? acc4[j].x : 0.f, bits & 2u ? acc4[j].y : 0.f,
                  bits & 4u ? acc4[j].z : 0.f, bits & 8u ? acc4[j].w : 0.f);
            }
          }
        }
      }
      for (int r = warp; r < R; r += THREADS / 32) {
        const int t = t0 + r;
        if (t >= n_t || rowcnt[t] <= LCAP) continue;  // warp-uniform
        float g[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) g[q] = 0.f;
        {
          const int tw = t >> 5;
          const unsigned bit = 1u << (t & 31);
          for (int c0 = 0; c0 < C2; c0 += 32) {
            const int c2 = c0 + lane;
            unsigned bal = __ballot_sync(
                0xffffffffu,
                c2 < C2 && (tie[c2 * TW + tw] & bit) && scale[c2] != 0.f);
            while (bal) {  // warp-uniform
              int cs[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                cs[u] = bal ? c0 + __ffs(bal) - 1 : -1;
                bal &= bal - 1;
              }
              float w[4][8];
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                  const int c = lane + 32 * q;
                  w[u][q] = cs[u] >= 0 && c < Cp
                                ? __ldg(embwT + (size_t)cs[u] * Cp + c)
                                : 0.f;
                }
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (cs[u] >= 0) {
                  const float sc = scale[cs[u]];
#pragma unroll
                  for (int q = 0; q < 8; ++q) g[q] = fmaf(sc, w[u][q], g[q]);
                }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = lane + 32 * q;
          if (c < Cp)
            A[r * LDA + c] = ((h1pos[t * HW + q] >> lane) & 1u) ? g[q] : 0.f;
        }
      }
      __syncthreads();
      PHASE_TICK(5)  // gather of G1

      // -- dP = G1 @ enc_w^T, staged over G1 --
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int ks = 0; ks < nks; ++ks) {
        wait_full(n);
        stage_product(acc, A, ring + slot_of(n) * STAGE_FLOATS, ks * KS, tx,
                      ty);
        done(n);
        ++n;
      }
      __syncthreads();  // every warp has read G1: dP may overwrite it
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* p = A + row_of(i) * LDP + tx * 4;
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(p + 64) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      __syncthreads();
      PHASE_TICK(6)  // dP product and staging

      // -- col2im: dx[pos, v] = sum_k dP[pos - k, k*V + v] over this row
      // block's rows, k ascending, added to what the previous row block
      // wrote (one thread per entry: every sum has one order) --
      const int t_end = min(t0 + R, n_t);
      const int f_hi = (t_end - 1) * V + KV;
      const int f_old = rb > 0 ? (t0 - 1) * V + KV : 0;
      for (int f = t0 * V + tid; f < f_hi; f += THREADS) {
        const int pos = f / V, v = f - pos * V;
        float s = f < f_old ? out[f] : 0.f;
        for (int k = 0; k < K; ++k) {
          const int t = pos - k;
          if (t >= t0 && t < t_end) s += A[(t - t0) * LDP + k * V + v];
        }
        out[f] = s;
      }
      __syncthreads();  // dP and dx are read before the next row block
      PHASE_TICK(7)     // col2im and store
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Any T and C, both types: a block per (sample, member), row strips
// ---------------------------------------------------------------------------
namespace wide {

using tc::rb;
using tc::smem_u32;

constexpr int THREADS = 256;  // 64 (tx) x 4 (ty)
constexpr int R = 32;         // rows t of a strip: one mark word a channel
constexpr int NC = 512;       // embed columns of a chunk: 8 a thread
constexpr int KS = 16;        // depth of a weight stage (C padded to it)
// (512 channels with a ring of 3 or 4 stages ran half again slower at
// L = 1022 on the H100: H1 is recomputed for each column chunk once it
// does not fit)
constexpr int DC = 1024;      // conv channels of H1 held at once
constexpr int NSTG = 2;       // emb_w stages in flight (a ring)
constexpr int RS = R + 4;     // H1^T row stride (floats): 16-byte rows
constexpr int KVP = 128;      // K*V padded (enc_w^T's columns): the limit
constexpr int GQ = DC / 32;   // conv channels a lane holds in the backward
constexpr int WARPS = THREADS / 32;

struct Args {
  const float* x;      // [B, L*V]   (bf16's values in float32 for bf16)
  const int2* tok;     // [B, L]     one-hot letter (else -1) and value
  const float* encw;   // [M, K*V, Cp]   rows of enc_w (conv)
  const float* encT;   // [M, Cp, KVP]   enc_w^T (dP)
  const float* emb;    // [M, Cp, C2p]   emb_w (embed product)
  const float* embwT;  // [M, C2, Cp]    rows of emb_w^T (G1)
  const float* encb;   // [M, Cp]
  const float* embb;   // [M, C2p]
  const float* decw;   // [M, C2]
  const float* decb;   // [M]
  float* pred;         // [M, B]        scratch
  float* dxm;          // [M, B, L*V]   scratch
  float* stat;         // [M, B, 3, C2] scratch: max, count, first row;
                       // backward: gradient, first row, a strip's rows
  unsigned* marks;     // [M, B, nstrip, C2] scratch: rows at the max
  int B, L, V, K, C, C2, M, pool_first, rnd, Cp, C2p, nstrip;
};

// Shared memory in bytes (offsets from the block's dynamic shared memory).
namespace lay {
constexpr int h1t = 0;                           // H1^T of a strip [DC][RS]
constexpr int stg = h1t + DC * RS * 4;           // NSTG stages of emb_w
constexpr int smax = stg + NSTG * KS * NC * 4;   // per chunk column: strip
constexpr int scnt = smax + NC * 4;              //   max (float bits), rows
constexpr int sfirst = scnt + NC * 4;            //   at it, first such row,
constexpr int smark = sfirst + NC * 4;           //   their bits
constexpr int red = smark + NC * 4;              // partial sums of pred
constexpr int total = red + WARPS * 4;
// backward: G1^T of a strip over H1^T, enc_w^T's stages and dP of a
// strip over the emb_w stages, the relu bits over the column statistics
static_assert(2 * KS * KVP * 4 + R * KVP * 4 <= smax - stg &&
                  DC * 4 <= red - smax && THREADS == 8 * 32 &&
                  KVP == 32 * 4 && R == 8 * 4,
              "the backward's buffers and its dP tiling");
static_assert(total <= 232448, "more than a block's shared memory");
}  // namespace lay

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// conv + bias at (t, c) before the relu: for each tap k the row of enc_w of
// the position's letter (one-hot), else every nonzero letter's row. The
// forward and the backward's relu mask both come from here: the same bits.
__device__ __forceinline__ float conv_pre(const Args& a, const int2* tok,
                                          const float* xb, const float* encw,
                                          const float* encb, int t, int c) {
  const int V = a.V, Cp = a.Cp;
  float acc = 0.f;
  for (int k = 0; k < a.K; ++k) {
    const int2 tv = tok[t + k];
    if (tv.x >= 0) {
      acc = fmaf(__int_as_float(tv.y),
                 __ldg(encw + (size_t)(k * V + tv.x) * Cp + c), acc);
    } else {
      for (int v = 0; v < V; ++v) {
        const float x = xb[(t + k) * V + v];
        if (x != 0.f)
          acc = fmaf(x, __ldg(encw + (size_t)(k * V + v) * Cp + c), acc);
      }
    }
  }
  return acc + encb[c];
}

constexpr int KFAST = 5;  // taps of the one-hot conv's fast path

// conv + b before the relu at rows t .. t+3 of channel c (rows from n_t on:
// 0): conv_pre's sums in its order, but for a sample whose every position
// is one-hot (and K <= KFAST) with the 20 row loads of enc_w issued
// before the first is used, so that their latencies overlap.
__device__ __forceinline__ void conv4(const Args& a, const int2* tok,
                                      const float* xb, const float* encw,
                                      const float* encb, bool onehot, int t,
                                      int n_t, int c, float (&pre)[4]) {
  if (!onehot || a.K > KFAST) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pre[i] = t + i < n_t ? conv_pre(a, tok, xb, encw, encb, t + i, c)
                           : 0.f;
    return;
  }
  float w[4][KFAST], xv[4][KFAST];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KFAST; ++k) {
      const bool in = t + i < n_t && k < a.K;
      const int2 tv = in ? tok[t + i + k] : make_int2(0, 0);
      xv[i][k] = __int_as_float(tv.y);
      w[i][k] = in ? __ldg(encw + (size_t)(k * a.V + tv.x) * a.Cp + c) : 0.f;
    }
  const float b = encb[c];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < KFAST; ++k)
      if (k < a.K) acc = fmaf(xv[i][k], w[i][k], acc);
    pre[i] = t + i < n_t ? acc + b : 0.f;
  }
}

// acc[i][j] += sum over a stage's 16 k of H1^T[k][row_i] * Bs[k][col_j]:
// rows ty*4 + i (i < 4) and 16 + ty*4 + i - 4, columns tx*4 + j (j < 4) and
// 256 + tx*4 + j - 4. A warp's lanes share ty: its A loads are broadcasts,
// its B loads 512 contiguous bytes.
__device__ __forceinline__ void stage_product(float (&acc)[8][8],
                                              const float* A,
                                              const float* Bs, int tx,
                                              int ty) {
#pragma unroll 4
  for (int kk = 0; kk < KS; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + kk * RS + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(A + kk * RS + 16 + ty * 4);
    const float4 b0 =
        *reinterpret_cast<const float4*>(Bs + kk * NC + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * NC + 256 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) fit_grad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* h1t = reinterpret_cast<float*>(smem + lay::h1t);
  float* stg = reinterpret_cast<float*>(smem + lay::stg);
  int* smax = reinterpret_cast<int*>(smem + lay::smax);
  int* scnt = reinterpret_cast<int*>(smem + lay::scnt);
  int* sfirst = reinterpret_cast<int*>(smem + lay::sfirst);
  unsigned* smark = reinterpret_cast<unsigned*>(smem + lay::smark);
  float* red = reinterpret_cast<float*>(smem + lay::red);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 63, ty = tid >> 6;
  const int b = blockIdx.x, m = blockIdx.y;
  const int V = a.V, K = a.K, C2 = a.C2, Cp = a.Cp, C2p = a.C2p;
  const int n_t = a.L - K + 1, LV = a.L * V;
  const size_t mb = (size_t)m * a.B + b;
  const float* encw = a.encw + (size_t)m * K * V * Cp;
  const float* encT = a.encT + (size_t)m * Cp * KVP;
  const float* emb = a.emb + (size_t)m * Cp * C2p;
  const float* embwT = a.embwT + (size_t)m * C2 * Cp;
  const float* encb = a.encb + (size_t)m * Cp;
  const float* embb = a.embb + (size_t)m * C2p;
  const float* decw = a.decw + (size_t)m * C2;
  const int2* tok = a.tok + (size_t)b * a.L;
  const float* xb = a.x + (size_t)b * LV;
  // per channel: running max (from -1: H2 >= 0), rows at it, first such row;
  // after the forward: the routed gradient and the first row (-1: none)
  float* st_max = a.stat + mb * 3 * C2;
  int* st_cnt = reinterpret_cast<int*>(st_max + C2);
  int* st_first = st_cnt + C2;
  unsigned* marks = a.marks + mb * a.nstrip * C2;
  auto row_of = [&](int i) { return (i < 4 ? 0 : 16) + ty * 4 + (i & 3); };
  auto col_of = [&](int j) { return (j < 4 ? 0 : 256) + tx * 4 + (j & 3); };

  for (int c = tid; c < C2; c += THREADS) {
    st_max[c] = -1.f;
    st_cnt[c] = 0;
    st_first[c] = 0;
  }
  for (int c = tid; c < NC; c += THREADS) {
    smax[c] = -1;
    scnt[c] = 0;
    sfirst[c] = INT_MAX;
    smark[c] = 0u;
  }
  int all_onehot = 1;  // every position of the sample one-hot
  for (int l = tid; l < a.L; l += THREADS) all_onehot &= tok[l].x >= 0;
  const bool onehot = __syncthreads_and(all_onehot) != 0;
  const int ndc = (Cp + DC - 1) / DC, nch = C2p / NC;

  for (int s = 0; s < a.nstrip; ++s) {
    const int t0 = s * R;
    for (int ch = 0; ch < nch; ++ch) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int dc = 0; dc < ndc; ++dc) {
        const int c0 = dc * DC, nc = min(DC, Cp - c0);
        if (ch == 0 || ndc > 1) {
          // -- H1^T = rnd(relu(conv + b)) of this strip's rows (0 past T)
          // and channels c0 .. c0 + nc - 1; a lane a channel --
          __syncthreads();  // every warp is done with the last H1^T
          for (int c = tid; c < nc; c += THREADS)
            for (int r = 0; r < R; r += 4) {
              float h[4];
              conv4(a, tok, xb, encw, encb, onehot, t0 + r, n_t, c0 + c, h);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                h[i] = h[i] > 0.f ? h[i] : 0.f;
                if (a.rnd) h[i] = rb(h[i]);
              }
              *reinterpret_cast<float4*>(h1t + c * RS + r) =
                  make_float4(h[0], h[1], h[2], h[3]);
            }
        }
        // -- the embed product over these channels, emb_w rows staged KS
        // at a time (two buffers, cp.async) --
        const int nks = nc / KS;
        auto stage = [&](int ks, int buf) {
          const float* src = emb + (size_t)(c0 + ks * KS) * C2p + ch * NC;
          const uint32_t dst = smem_u32(stg + buf * KS * NC);
          for (int i = tid; i < KS * NC / 4; i += THREADS) {
            const int r = i / (NC / 4), c4 = i % (NC / 4);
            cp_async16(dst + (r * NC + c4 * 4) * 4, src + (size_t)r * C2p +
                                                        c4 * 4);
          }
        };
        for (int p = 0; p < NSTG - 1; ++p) {
          if (p < nks) stage(p, p);
          cp_async_commit();
        }
        for (int ks = 0; ks < nks; ++ks) {
          const int ahead = ks + NSTG - 1;
          if (ahead < nks) stage(ahead, ahead % NSTG);
          cp_async_commit();
          cp_async_wait<NSTG - 1>();  // stage ks has landed
          __syncthreads();
          stage_product(acc, h1t + ks * KS * RS,
                        stg + (ks % NSTG) * KS * NC, tx, ty);
          __syncthreads();
        }
      }
      // -- H2 = rnd(relu(acc + b)) (rows past T: -1, out of the pool);
      // the strip's column maxima, the rows that reach them and the first
      // of those, by integer atomics (they commute: the same result in any
      // order; H2 >= 0, so its bits order as its values) --
      const int cb = ch * NC;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bias = embb[cb + col_of(j)];
        float best = -1.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[i][j] + bias;
          v = v > 0.f ? v : 0.f;
          if (a.rnd) v = rb(v);
          if (t0 + row_of(i) >= n_t) v = -1.f;
          acc[i][j] = v;
          best = fmaxf(best, v);
        }
        if (best >= 0.f) atomicMax(&smax[col_of(j)], __float_as_int(best));
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int want = smax[col_of(j)];
        unsigned bits = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (want >= 0 && __float_as_int(acc[i][j]) == want)
            bits |= 1u << row_of(i);
        if (bits) {
          atomicAdd(&scnt[col_of(j)], __popc(bits));
          atomicMin(&sfirst[col_of(j)], __ffs(bits) - 1);
          atomicOr(&smark[col_of(j)], bits);
        }
      }
      __syncthreads();
      // -- fold into the running statistics, a thread a column: a larger
      // max restarts them, an equal one adds rows; the strip's mark word
      // (rows at the running max) goes to device memory --
      for (int c = tid; c < NC; c += THREADS) {
        const int c2 = cb + c;
        if (c2 < C2) {
          unsigned word = 0u;
          if (smax[c] >= 0) {
            const float v = __int_as_float(smax[c]), old = st_max[c2];
            if (v > old) {
              st_max[c2] = v;
              st_cnt[c2] = scnt[c];
              st_first[c2] = t0 + sfirst[c];
              word = smark[c];
            } else if (v == old) {
              st_cnt[c2] += scnt[c];
              word = smark[c];
            }
          }
          marks[(size_t)s * C2 + c2] = word;
        }
        smax[c] = -1;
        scnt[c] = 0;
        sfirst[c] = INT_MAX;
        smark[c] = 0u;
      }
    }
  }
  __syncthreads();

  // -- pred_m (fixed-order reduction); per channel the routed gradient
  // rnd(mx > 0 ? dec_w / (split ? count : 1) : 0) over the max, and the
  // first row over the count (-1: no gradient) --
  {
    float sum = 0.f;
    for (int c = tid; c < C2; c += THREADS) {
      const float best = st_max[c], d = decw[c];
      sum += best * d;
      float sc = best > 0.f ? d / (float)(a.pool_first ? 1 : st_cnt[c]) : 0.f;
      if (a.rnd) sc = rb(sc);
      st_max[c] = sc;
      st_cnt[c] = sc != 0.f ? st_first[c] : -1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red[warp] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += red[w];
    a.pred[mb] = sum + a.decb[m];
  }

  // -- backward, strip by strip. (1) Each channel's routed rows of the
  // strip as a word of bits ("split": the strip's mark word, from the
  // strip of the first row on; "first": the first row alone), in device
  // memory. Then for each DC channels: (2) the bits of conv + b > 0
  // (recomputed, a thread a channel); (3) G1^T = rnd(sum over a row's
  // routed channels, ascending, of their gradients times the rows of
  // emb_w^T) * [conv + b > 0], a warp a row; (4) dP += G1 enc_w^T, a
  // product over the channels ascending with enc_w^T staged KS rows at a
  // time. Then col2im of the strip, one thread per entry of dx, added to
  // what the strips before wrote --
  float* g1t = reinterpret_cast<float*>(smem + lay::h1t);  // [DC][RS]
  float* estg = reinterpret_cast<float*>(smem + lay::stg);  // 2 [KS][KVP]
  float* dps = estg + 2 * KS * KVP;                         // [R][KVP]
  unsigned* hpos = reinterpret_cast<unsigned*>(smem + lay::smax);  // [DC]
  float* out = a.dxm + mb * LV;
  const float* sc_of = st_max;
  const int* first_of = st_cnt;
  unsigned* wrow = reinterpret_cast<unsigned*>(st_first);  // [C2]
  const int KV = K * V;
  const int ry = tid >> 5;  // dP: rows ry*4 .. +3, columns lane*4 .. +3
  for (int s = 0; s < a.nstrip; ++s) {
    const int t0 = s * R;
    for (int c2 = tid; c2 < C2; c2 += THREADS) {
      const int f = first_of[c2];
      unsigned w = 0u;
      if (f >= 0)
        w = a.pool_first ? (f / R == s ? 1u << (f % R) : 0u)
                         : (s >= f / R ? marks[(size_t)s * C2 + c2] : 0u);
      wrow[c2] = w;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int dc = 0; dc < ndc; ++dc) {
      const int c0 = dc * DC, nc = min(DC, Cp - c0);
      __syncthreads();  // wrow written; G1^T and hpos read
      for (int c = tid; c < nc; c += THREADS) {
        unsigned bits = 0u;
        for (int r = 0; r < R; r += 4) {
          float h[4];
          conv4(a, tok, xb, encw, encb, onehot, t0 + r, n_t, c0 + c, h);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            bits |= (unsigned)(h[i] > 0.f) << (r + i);
        }
        hpos[c] = bits;
      }
      __syncthreads();
      for (int r = warp; r < R; r += WARPS) {
        float g[GQ];
#pragma unroll
        for (int q = 0; q < GQ; ++q) g[q] = 0.f;
        for (int cb = 0; t0 + r < n_t && cb < C2; cb += 128) {
          unsigned w4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c2 = cb + 32 * u + lane;
            w4[u] = c2 < C2 ? wrow[c2] : 0u;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unsigned bal = __ballot_sync(0xffffffffu, (w4[u] >> r) & 1u);
            while (bal) {  // warp-uniform; two channels' rows in flight
              int cs[2];
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                cs[v] = bal ? cb + 32 * u + __ffs(bal) - 1 : -1;
                bal &= bal - 1u;
              }
              float w[2][GQ];
#pragma unroll
              for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int q = 0; q < GQ; ++q) {
                  const int c = lane + 32 * q;
                  w[v][q] = cs[v] >= 0 && c < nc
                                ? __ldg(embwT + (size_t)cs[v] * Cp + c0 + c)
                                : 0.f;
                }
#pragma unroll
              for (int v = 0; v < 2; ++v)
                if (cs[v] >= 0) {
                  const float sc = sc_of[cs[v]];
#pragma unroll
                  for (int q = 0; q < GQ; ++q)
                    g[q] = fmaf(sc, w[v][q], g[q]);
                }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < GQ; ++q) {
          const int c = lane + 32 * q;
          g1t[c * RS + r] = c < nc && ((hpos[c] >> r) & 1u)
                                ? (a.rnd ? rb(g[q]) : g[q])
                                : 0.f;
        }
      }
      const int nks = nc / KS;
      auto stage = [&](int ks, int buf) {
        const float* src = encT + (size_t)(c0 + ks * KS) * KVP;
        const uint32_t dst = smem_u32(estg + buf * KS * KVP);
        for (int i = tid; i < KS * KVP / 4; i += THREADS)
          cp_async16(dst + i * 16, src + i * 4);
      };
      stage(0, 0);
      cp_async_commit();
      for (int ks = 0; ks < nks; ++ks) {
        if (ks + 1 < nks) stage(ks + 1, (ks + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // (and, the first time, G1^T written)
        const float* A = g1t + ks * KS * RS;
        const float* Bs = estg + (ks & 1) * KS * KVP;
#pragma unroll 4
        for (int kk = 0; kk < KS; ++kk) {
          const float4 av =
              *reinterpret_cast<const float4*>(A + kk * RS + ry * 4);
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + kk * KVP + lane * 4);
          const float x[4] = {av.x, av.y, av.z, av.w};
          const float y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dps + (ry * 4 + i) * KVP + lane * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    const int t_end = min(t0 + R, n_t);
    const int f_hi = (t_end - 1) * V + KV;
    const int f_old = s > 0 ? (t0 - 1) * V + KV : 0;
    for (int f = t0 * V + tid; f < f_hi; f += THREADS) {
      const int pos = f / V, v = f - pos * V;
      float acc = f < f_old ? out[f] : 0.f;
      for (int k = 0; k < K; ++k) {
        const int t = pos - k;
        if (t >= t0 && t < t_end) acc += dps[(t - t0) * KVP + k * V + v];
      }
      out[f] = acc;
    }
  }
}

// each position's letter if it is one-hot (else -1) and its value
__global__ void tokens_kernel(const float* __restrict__ x, int2* tok, long n,
                              int V) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xv = x + i * V;
  int cnt = 0, first = -1;
  float val = 0.f;
  for (int v = 0; v < V; ++v) {
    const float xv_ = xv[v];
    if (xv_ != 0.f) {
      if (first < 0) {
        first = v;
        val = xv_;
      }
      ++cnt;
    }
  }
  tok[i] = make_int2(cnt == 1 ? first : -1, __float_as_int(val));
}

}  // namespace wide

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

size_t smem_bytes(int dtype) {
  return (size_t)(dtype == 1 ? tc::lay::total : simt::lay::total);
}

int member_reduce(const float* pred, const float* dxm, float* fit, float* dx,
                  int M, int B, long n, cudaStream_t stream) {
  const long work = n > B ? n : B;
  cnn_member_reduce<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      pred, dxm, fit, dx, M, B, n);
  return static_cast<int>(cudaGetLastError());
}

// what the bf16 kernel takes
bool tc_ok(int L, int V, int K, int C, int C2) {
  return L >= K && L - K + 1 <= tc::ROWS && K * V <= tc::NDP && V % 2 == 0 &&
         V <= 32 && C <= tc::MAX_C && C2 <= tc::MAX_C2 &&
         L * V <= tc::MAX_LV && L <= tc::MAX_L;
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The persistent grid's width: SMs / M blocks per member (at least 1, at
// most B). Returns a cudaError_t.
int grid_width(int M, int B, int* per) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *per = sms / M;
  if (*per < 1) *per = 1;
  if (*per > B) *per = B;
  return static_cast<int>(err);
}

// what the float32 kernel takes
bool simt_ok(int L, int V, int K, int C, int C2) {
  return L >= K && L - K + 1 <= simt::MAX_T && K * V <= simt::NT &&
         C <= simt::MAX_C && C2 <= simt::MAX_C2 && L <= simt::MAX_L;
}

// which kernel takes these sizes in dtype (0 = float32, 1 = bfloat16): 0
// simt, 1 tc, 2 wide; -1 none (K*V over the depth every kernel has)
int kernel_for(int L, int V, int K, int C, int C2, int dtype) {
  if (L < K || K < 1 || V < 1 || C < 1 || C2 < 1) return -1;
  if (dtype == 0 && simt_ok(L, V, K, C, C2)) return 0;
  if (dtype == 1 && tc_ok(L, V, K, C, C2)) return 1;
  return K * V <= wide::KVP ? 2 : -1;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for dtype (0 = float32,
// 1 = bfloat16); the wrapper checks it against the card's 227 KB.
long cnn_smem_bytes(int dtype) { return (long)smem_bytes(dtype); }

// The float32 kernel's layout: the columns of an embed chunk (emb [M,
// nchunk, Cp, this], also enc_w^T's columns) and the depth C is padded to.
int cnn_max_kv() { return simt::NT; }
int cnn_f32_depth() { return simt::KS; }

#ifdef CNN_PHASE_CLOCKS
// Copies the 8 phase clocks of block (0, 0) to out (reset != 0: zeroes
// them instead). Returns a cudaError_t.
int cnn_phase_clocks(long long* out, int reset) {
  long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (reset)
    return static_cast<int>(
        cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(zero)));
}
#endif

// Columns of one embed chunk: emb_blob holds ceil(C2 / this) chunks.
int cnn_bf16_chunk() { return tc::NCH; }

// float32, from the tensors prepare_ensemble makes (x [B, L*V]; encw
// [M, K*V, Cp], encT [M, Cp, 128], emb [M, nchunk, Cp, 128], embwT [M, C2,
// Cp], encb [M, Cp], embb [M, nchunk * 128], decw [M, C2], decb [M]; Cp = C
// rounded up to 16, zero-padded). Returns a cudaError_t.
int cnn_ensemble_fit_and_grad(const void* x, const void* encw,
                              const void* encT, const void* emb,
                              const void* embwT, const void* encb,
                              const void* embb, const void* decw,
                              const void* decb, void* pred, void* dxm,
                              void* fit, void* dx, int B, int L, int V, int K,
                              int C, int C2, int M, int pool_first,
                              void* stream) {
  if (B <= 0 || M <= 0 || !simt_ok(L, V, K, C, C2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Cp = round_up(C, simt::KS);
  const int nchunk = (C2 + simt::NT - 1) / simt::NT;
  simt::F32Args a{static_cast<const float*>(x),
                  static_cast<const float*>(encw),
                  static_cast<const float*>(encT),
                  static_cast<const float*>(emb),
                  static_cast<const float*>(embwT),
                  static_cast<const float*>(encb),
                  static_cast<const float*>(embb),
                  static_cast<const float*>(decw),
                  static_cast<const float*>(decb),
                  static_cast<float*>(pred),
                  static_cast<float*>(dxm),
                  B, L, V, K, C, C2, M, pool_first, Cp, nchunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per = 1;
  cudaError_t err = static_cast<cudaError_t>(grid_width(M, B, &per));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(simt::fit_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(0));
  if (err != cudaSuccess) return static_cast<int>(err);
  simt::fit_grad_kernel<<<dim3(per, M), simt::THREADS, smem_bytes(0), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return member_reduce(a.pred, a.dxm, static_cast<float*>(fit),
                       static_cast<float*>(dx), M, B, (long)B * L * V, s);
}

// bfloat16, from the tensors prepare_ensemble makes (x bf16 [B, L*V];
// enc_blob, emb_blob: swizzled weight tiles; embwT [M, C2, 256]; encb
// [M, 256], embb [M, nchunk * 96] float32, zero-padded; decw bf16 [M, C2];
// decb [M]). Returns a cudaError_t.
int cnn_ensemble_fit_and_grad_bf16(const void* x, const void* enc_blob,
                                   const void* emb_blob, const void* embwT,
                                   const void* encb, const void* embb,
                                   const void* decw, const void* decb,
                                   void* pred, void* dxm, void* fit, void* dx,
                                   int B, int L, int V, int K, int C, int C2,
                                   int M, int pool_first, void* stream) {
  using bf16 = __nv_bfloat16;
  if (B <= 0 || M <= 0 || !tc_ok(L, V, K, C, C2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunk = (C2 + tc::NCH - 1) / tc::NCH;
  tc::TcArgs a{static_cast<const bf16*>(x),
               static_cast<const bf16*>(enc_blob),
               static_cast<const bf16*>(emb_blob),
               static_cast<const bf16*>(embwT),
               static_cast<const float*>(encb),
               static_cast<const float*>(embb),
               static_cast<const bf16*>(decw),
               static_cast<const float*>(decb),
               static_cast<float*>(pred),
               static_cast<float*>(dxm),
               B, L, V, K, C, C2, M, pool_first, nchunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one block per SM, each on one member, walking samples in strides
  int per = 1;
  cudaError_t err = static_cast<cudaError_t>(grid_width(M, B, &per));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tc::fit_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(1));
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::fit_grad_kernel<<<dim3(per, M), tc::THREADS, smem_bytes(1), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return member_reduce(a.pred, a.dxm, static_cast<float*>(fit),
                       static_cast<float*>(dx), M, B, (long)B * L * V, s);
}

// The kernel that takes these sizes in dtype: 0 simt (float32), 1 tc
// (bfloat16), 2 wide (either type: T, C or C2 beyond the other two), -1 none.
int cnn_kernel_for(int L, int V, int K, int C, int C2, int dtype) {
  return kernel_for(L, V, K, C, C2, dtype);
}

// Columns of an embed chunk of the wide kernel's emb layout (C2 is padded
// to a multiple), the depth C is padded to, and its K*V limit.
int cnn_wide_chunk() { return wide::NC; }
int cnn_wide_depth() { return wide::KS; }
int cnn_wide_max_kv() { return wide::KVP; }

// Either type, from the float32 tensors prepare_ensemble's wide layout
// holds (the bf16 ensemble's values in float32 for bf16: x [B, L*V], encw
// [M, K*V, Cp], encT [M, Cp, 128], emb [M, Cp, C2p], embwT [M, C2, Cp],
// encb [M, Cp], embb [M, C2p], decw [M, C2], decb [M]; Cp = C rounded up to
// 16, C2p = C2 rounded up to 512, zero-padded); rnd = 1 rounds the
// activations and the routed gradient to bf16. Scratch: tok [B, L] int2,
// stat [M, B, 3, C2], marks [M, B, ceil(T / 32), C2]. Returns a cudaError_t.
int cnn_ensemble_fit_and_grad_wide(
    const void* x, void* tok, const void* encw, const void* encT,
    const void* emb, const void* embwT, const void* encb, const void* embb,
    const void* decw, const void* decb, void* pred, void* dxm, void* stat,
    void* marks, void* fit, void* dx, int B, int L, int V, int K, int C,
    int C2, int M, int pool_first, int rnd, void* stream) {
  if (B <= 0 || M <= 0 || L < K || K * V > wide::KVP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_t = L - K + 1;
  wide::Args a{static_cast<const float*>(x),
               static_cast<const int2*>(tok),
               static_cast<const float*>(encw),
               static_cast<const float*>(encT),
               static_cast<const float*>(emb),
               static_cast<const float*>(embwT),
               static_cast<const float*>(encb),
               static_cast<const float*>(embb),
               static_cast<const float*>(decw),
               static_cast<const float*>(decb),
               static_cast<float*>(pred),
               static_cast<float*>(dxm),
               static_cast<float*>(stat),
               static_cast<unsigned*>(marks),
               B, L, V, K, C, C2, M, pool_first, rnd,
               round_up(C, wide::KS), round_up(C2, wide::NC),
               (n_t + wide::R - 1) / wide::R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long n_pos = (long)B * L;
  wide::tokens_kernel<<<(unsigned)((n_pos + 255) / 256), 256, 0, s>>>(
      a.x, static_cast<int2*>(tok), n_pos, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wide::fit_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wide::lay::total);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide::fit_grad_kernel<<<dim3(B, M), wide::THREADS, wide::lay::total, s>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return member_reduce(a.pred, a.dxm, static_cast<float*>(fit),
                       static_cast<float*>(dx), M, B, (long)B * L * V, s);
}

}  // extern "C"
