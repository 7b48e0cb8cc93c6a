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
// Design of the wide kernels (namespace wide; both types, every shape the
// other two do not take: wild types longer than 256 residues, whose
// reference-width CNN has C = L, or wider ensembles). No length or
// channel limit; K*V <= 128. The embed product is [B*T, C] x [C, 2C] a
// member, every sample on the same emb_w, so the unit of work is (member,
// column tile, sample), its rows walked in tiles of 128.
//   * Kernels: the tokens of x (one-hot letter and value, else -1); the
//     forward, a block per (sample, column tile, member); the backward, a
//     block per (sample, member); the member reduction.
//   * Forward, bf16 (fwd_tc<N>): two warpgroups of 64 rows; column tiles
//     of N = 256 or 200 (wgmma n; whichever pads 2C less: 800 runs as 800).
//     Per depth chunk of 64 channels a ring slot (cp.async.bulk, mbarriers)
//     brings the emb_w^T tile [N][64] and the enc_w tile [K*V][64], both
//     128-byte swizzled as prepare_ensemble lays them out. The conv runs on
//     the tensor cores too: the tile's patches P [128][K*V] (one-hot
//     entries, or x where a position is not one-hot) times the enc_w tile
//     read MN-major (wgmma m64n64k16, transposed B; exact products), then
//     rnd(relu(+ b)) into the swizzled H1 tile that the embed wgmma
//     (m64nNk16) reads. A slot is refilled by the warp that releases it
//     last (a count; no warp waits).
//   * Forward, float32 (fwd_simt; FMAs, no TF32): 32 x 16 threads, 8 x 8
//     sums each, tiles of 128 rows x 256 columns; per depth stage of 16
//     channels the ring brings emb_w [16][256] and enc_w [K*V][16], the
//     block builds H1 of the stage (a gather-add of enc_w rows, 4 channels
//     a thread) into one of two buffers, one barrier a stage (after which
//     thread 0 refills the slot the stage before used); the halves of a
//     tile past T or 2C are left out of the products.
//   * Max-pool, both: each warp's column maxima of the accumulators
//     (shuffles), the tile's from them (the bias, relu and rounding act on
//     the maximum alone), then only the columns whose tile max reaches the
//     running max compare their rows (integer atomics on four words of bits
//     a column). The tile folds into running max, count and first row in
//     row order (a larger max restarts them); its mark words go to device
//     memory. A tile before the one that first reached a channel's final
//     max marked smaller values, so the backward reads the words from that
//     tile on: no T x 2C mask, no float atomics.
//   * Backward, per row tile: pred and the routed gradients once; each
//     row's routed channels as a run of a CSR list (counts by integer
//     atomics, a prefix sum, each run sorted: the order is fixed), rows past
//     4,096 pairs scan the channels; per depth chunk, G1 = rnd([H1 > 0] *
//     the routed rows of emb_w^T), two threads a row with the loads of 8 /
//     pieces-a-thread entries in flight, the relu mask from the forward's
//     own conv (bf16: the same tensor-core product; float32: the same
//     gather-add); dP = G1 enc_w^T (bf16 wgmma m64n128k16, K*V padded to
//     128; float32 FMAs, 8 x 8 a thread); col2im of the tile, one thread per
//     entry of dx in a fixed order, added to what the tiles before wrote.
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
// 0 of block (0, 0, 0) adds the clocks each phase took into g_phase_clocks;
// otherwise PHASE_TICK is empty. Every kernel ticks the same eight phases
// (the wide pair: the forward 1-3, the backward 0 and 4-7).
#ifdef CNN_PHASE_CLOCKS
__device__ long long g_phase_clocks[8];
#define PHASE_TICK(i)                                                  \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&        \
      blockIdx.z == 0) {                                               \
    const long long now_ = clock64();                                  \
    g_phase_clocks[i] += now_ - phase_t0;                              \
    phase_t0 = now_;                                                   \
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
// Any T and C, both types: a forward kernel per (sample, column tile,
// member) and a backward kernel per (sample, member); rows in tiles of 128
// ---------------------------------------------------------------------------
namespace wide {

using tc::bf_hi;
using tc::bf_lo;
using tc::fence_async_proxy;
using tc::mbar_init;
using tc::mbar_wait;
using tc::rb;
using tc::smem_u32;
using tc::sw;
using tc::wgmma_commit;
using tc::wgmma_desc;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int THREADS = 256;  // two warpgroups (bf16); 16 x 16 (float32 dP)
constexpr int WARPS = THREADS / 32;
constexpr int RT = 128;       // rows t of a row tile: four mark words a channel
constexpr int KVP = 128;      // K*V: the limit, and dP's columns padded
constexpr int KB = 64;        // bf16 depth chunk: 128-byte rows
constexpr int KS = 16;        // float32 depth stage
constexpr int NF = 256;       // float32 forward's column tile (8 x 8 a
                              // thread of FTHREADS)
constexpr int FTHREADS = 512;  // the float32 forward: 32 x 16 threads
constexpr int LDA = KS + 4;   // row stride of float32 H1 / G1 (floats)
constexpr int DPS = KVP + 4;  // row stride of the staged dP (floats)
constexpr int PCAP = 4096;    // (row, channel) pairs a row tile lists
constexpr int MAX_POS = RT + KVP;  // positions the patches of a tile cover

struct Args {
  const float* x;      // [B, L*V]   (bf16's values in float32 for bf16)
  const int2* tok;     // [B, L]     one-hot letter (else -1) and value
  const void* enc;     // bf16: [M, nkb, 128, 64] swizzled tiles of enc_w
                       // [j][c]; float32: [M, nks, K*V, 16] stages of it
  const float* encT;   // float32: [M, Cp, 128] enc_w^T (dP); bf16: unused
  const void* emb;     // bf16: [M, ncol, nkb, N, 64] swizzled tiles of
                       // emb_w^T [c2][c]; float32: [M, ncol, Cp, 256] emb_w
  const void* embwT;   // [M, C2, Cp]  rows of emb_w^T (G1), the type's
  const float* encb;   // [M, Cp]
  const float* embb;   // [M, ncol * N]
  const float* decw;   // [M, C2]     (bf16's values in float32)
  const float* decb;   // [M]
  float* pred;         // [M, B]        scratch
  float* dxm;          // [M, B, L*V]   scratch
  float* stat;         // [M, B, 3, C2] scratch: max, count, first row;
                       // backward: gradient, first row (-1: none)
  uint4* marks;        // [M, B, nrt, C2] scratch: a tile's rows at the max
  int B, L, V, K, C, C2, M, pool_first, N, Cp, ncol, nrt;
};

// d[64 x N] (+)= a[64 x 16] * b[N x 16]^T from shared memory, both K-major
// in the 128-byte swizzle; accumulate = 0 overwrites d
template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wg_mma<128>(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_mma<200>(float (&d)[100], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99}, "
      "%100, %101, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wg_mma<256>(float (&d)[128], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


__device__ __forceinline__ void wg_bar(int wg) {  // one warpgroup's barrier
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The bf16 conv as a product on the tensor cores: a row tile's patches P
// [128 rows][128] (row r: x at positions t0 + r .. t0 + r + K - 1, the
// K*V entries of its patch; zero past them) in two swizzled 64-deep tiles,
// times the enc_w tile of a chunk [128 (j)][64 (channels)] read MN-major
// (wgmma's transposed-B form: the tile as the ring holds it). Every
// product is exact; the forward and the backward's relu mask both come
// from here: the same bits.
constexpr int P_BYTES = RT * KVP * 2;
// d[64 x 64] (+)= a[64 x 16] * b[16 x 64], a K-major, b MN-major
__device__ __forceinline__ void wg_mma_conv(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// descriptor of a 128-byte-swizzled bf16 tile with its leading and stride
// byte offsets (MN-major: the stride steps from one group of 8 k to the next)
__device__ __forceinline__ uint64_t wgmma_desc2(uint32_t addr, int leading,
                                                int stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// this warpgroup's 64 rows of conv(chunk) = P @ enc_w tile, K*V deep
__device__ __forceinline__ void conv_mma(float (&d)[32], uint32_t p_u,
                                         uint32_t e_u, int wg, int KV) {
#pragma unroll
  for (int q = 0; q < KVP / 16; ++q)
    if (q * 16 < KV)
      wg_mma_conv(d,
                  wgmma_desc(p_u + (q / 4) * (RT * 128) + wg * 64 * 128) +
                      2 * (q % 4),
                  wgmma_desc2(e_u + q * 2048, 8192, 1024), q > 0);
}
// P of the row tile from t0: every thread clears its share, then a thread
// a (row, tap) writes the tap's letters. Ends with a barrier of the block.
__device__ __forceinline__ void build_patches(const Args& a, const int2* st,
                                              const float* xt, int t0,
                                              int n_t, unsigned char* p) {
  for (int i = threadIdx.x; i < P_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto put = [&](int r, int j, float v) {
    *reinterpret_cast<__nv_bfloat16*>(
        p + (j / 64) * (RT * 128) + sw(r, (j % 64) / 8) + (j % 8) * 2) =
        __float2bfloat16(v);
  };
  for (int e = threadIdx.x; e < RT * a.K; e += THREADS) {
    const int r = e / a.K, k = e - r * a.K;
    if (t0 + r >= n_t) continue;
    const int2 tv = st[r + k];
    if (tv.x >= 0) {
      put(r, k * a.V + tv.x, __int_as_float(tv.y));
    } else {
      for (int v = 0; v < a.V; ++v) {
        const float xv = xt[(r + k) * a.V + v];
        if (xv != 0.f) put(r, k * a.V + v, xv);
      }
    }
  }
  fence_async_proxy();
  __syncthreads();
}
// rnd(relu(conv + b)) of the accumulators into a swizzled bf16 tile [128
// rows][64] (this warpgroup's rows); channels from c0
__device__ __forceinline__ void conv_store(const float (&d)[32],
                                           const float* encb, int c0,
                                           int rbase, unsigned char* t) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const float b0 = encb[c0 + ni * 8 + tig * 2],
                b1 = encb[c0 + ni * 8 + tig * 2 + 1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const __nv_bfloat162 r2 = __floats2bfloat162_rn(
          fmaxf(d[ni * 4 + hf * 2] + b0, 0.f),
          fmaxf(d[ni * 4 + hf * 2 + 1] + b1, 0.f));
      *reinterpret_cast<__nv_bfloat162*>(t + sw(rbase + hf * 8, ni) +
                                         tig * 4) = r2;
    }
  }
}

// One or two bulk copies global -> shared completing on mbarrier `bar`,
// started when `on` (predicated: no branch next to the wgmmas)
__device__ __forceinline__ void bulk(uint32_t bar, uint32_t d0,
                                     const void* s0, int n0, uint32_t d1,
                                     const void* s1, int n1, bool on) {
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %7, 0;\n"
      "setp.ne.and.b32 q, %6, 0, p;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %8;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%1], [%2], %3, [%0];\n"
      "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%4], [%5], %6, [%0];\n}\n" ::"r"(bar),
      "r"(d0), "l"(s0), "r"(n0), "r"(d1), "l"(s1), "r"(n1), "r"((int)on),
      "r"(n0 + n1)
      : "memory");
}

// A ring of S shared-memory slots of weight tiles: tile i lives in slot
// i % S; fill(i, on) starts the copies of tile i when `on`. A slot is
// refilled with tile i + S once every warp is done with tile i: by the
// warp whose release completes the slot's count (release; counts only
// grow, no warp waits), or by thread 0 after a barrier of the block
// (refill).
template <int S>
struct Ring {
  uint32_t full0, count0;
  __device__ void init(uint32_t bars) {  // the caller syncs the block
    full0 = bars;
    count0 = bars + S * 8;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full0 + s * 8, 1);
        asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(count0 + s * 4)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ uint32_t full(uint32_t i) const { return full0 + (i % S) * 8; }
  __device__ void wait(uint32_t i) const { mbar_wait(full(i), (i / S) & 1); }
  template <class Fill>
  __device__ void start(Fill fill) const {  // the first S tiles
    for (uint32_t i = 0; i < S; ++i) fill(i, threadIdx.x == 0);
  }
  template <class Fill>
  __device__ void refill(uint32_t i, Fill fill) const {
    fill(i + S, threadIdx.x == 0);
  }
  template <class Fill>
  __device__ void release(uint32_t i, Fill fill) const {
    __syncwarp();
    const int lane0 = (threadIdx.x & 31) == 0;
    unsigned old = 0u;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
        "@p atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n}\n"
        : "+r"(old)
        : "r"(count0 + (i % S) * 4), "r"(lane0)
        : "memory");
    fill(i + S, lane0 && old == (unsigned)WARPS * (i / S + 1) - 1);
  }
};

// The tokens of the positions a row tile's patches cover (t0 .. t0 + RT +
// K - 2, within L) into st; true if every one is one-hot. Ends with a
// barrier of the block.
__device__ __forceinline__ bool tile_tokens(const Args& a, const int2* tok,
                                            int t0, int2* st) {
  const int np = min(RT + a.K - 1, a.L - t0);
  int oh = 1;
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int2 tv = tok[t0 + p];
    st[p] = tv;
    oh &= tv.x >= 0;
  }
  return __syncthreads_and(oh) != 0;
}

// conv before the bias at local row tl of a tile, W channels: for each tap
// the weights of the position's letter (one-hot) or of every nonzero letter
// in x (xt: x from the tile's first position); row(j, v, s) adds v times
// row j of enc_w (W channels) to s. The forward pass and the backward's
// relu mask both come from here: the same bits.
template <int W, class Row>
__device__ __forceinline__ void conv(const Args& a, const int2* st,
                                     bool onehot, const float* xt, int tl,
                                     float (&s)[W], Row row) {
#pragma unroll
  for (int q = 0; q < W; ++q) s[q] = 0.f;
  if (onehot) {
#pragma unroll 5
    for (int k = 0; k < a.K; ++k) {
      const int2 tv = st[tl + k];
      row(k * a.V + tv.x, __int_as_float(tv.y), s);
    }
    return;
  }
  for (int k = 0; k < a.K; ++k) {
    const int2 tv = st[tl + k];
    if (tv.x >= 0) {
      row(k * a.V + tv.x, __int_as_float(tv.y), s);
      continue;
    }
    for (int v = 0; v < a.V; ++v) {
      const float xv = xt[(tl + k) * a.V + v];
      if (xv != 0.f) row(k * a.V + v, xv, s);
    }
  }
}

template <bool BF>
__device__ __forceinline__ float act(float v) {  // rnd(relu(v))
  v = fmaxf(v, 0.f);
  return BF ? rb(v) : v;
}

// The column statistics of a forward block (N <= THREADS columns), in
// shared memory: the running max, rows at it and first such row; per row
// tile the tile's max (-1: none), the max its rows are compared with (-1:
// not compared) and a bit a column for those compared, the rows that reach
// it (four words) and the biases.
struct ColStats {
  float* rmax;
  int* rcnt;
  int* rfirst;
  float* tmax;
  float* want;
  unsigned* tmark;
  float* bias;
  unsigned* flag;
  static constexpr int BYTES = 256 * 40 + 32;
  __device__ ColStats(unsigned char* p)
      : rmax(reinterpret_cast<float*>(p)),
        rcnt(reinterpret_cast<int*>(p + 1024)),
        rfirst(reinterpret_cast<int*>(p + 2048)),
        tmax(reinterpret_cast<float*>(p + 3072)),
        want(reinterpret_cast<float*>(p + 4096)),
        tmark(reinterpret_cast<unsigned*>(p + 5120)),
        bias(reinterpret_cast<float*>(p + 9216)),
        flag(reinterpret_cast<unsigned*>(p + 10240)) {}
  __device__ void init(const float* embb, int N) {
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      rmax[c] = -1.f;
      rcnt[c] = 0;
      rfirst[c] = 0;
      for (int w = 0; w < 4; ++w) tmark[c * 4 + w] = 0u;
      bias[c] = embb[c];
    }
  }
  // After each warp's column maxima of the tile's sums in pmax [WARPS][N]
  // (-inf: no rows) and a barrier: the tile's max of each column (the
  // bias, relu and rounding are monotone, so they act on the maximum
  // alone) and the columns whose rows are compared with it (a tile max
  // > 0 that reaches the running max: a dead channel routes nothing).
  template <bool BF>
  __device__ void choose(const float* pmax, int N, int nwarps) {
    const int c = threadIdx.x;
    bool on = false;
    if (c < N) {
      float raw = -INFINITY;
      for (int w = 0; w < nwarps; ++w) raw = fmaxf(raw, pmax[w * N + c]);
      const float tm = raw > -INFINITY ? act<BF>(raw + bias[c]) : -1.f;
      tmax[c] = tm;
      on = tm > 0.f && tm >= rmax[c];
      want[c] = on ? tm : -1.f;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if ((c & 31) == 0 && c < 256) flag[c >> 5] = bal;
  }
  __device__ bool flagged(int c) const { return (flag[c >> 5] >> (c & 31)) & 1u; }
  // row r (of the tile) reaches the max of column c
  __device__ void mark(int c, int r) {
    atomicOr(&tmark[c * 4 + (r >> 5)], 1u << (r & 31));
  }
  // after the marks (and a barrier): fold the tile into the running
  // statistics (a larger max restarts them, an equal one adds rows), write
  // the tile's mark words of columns c0 + c < C2 and clear the tile
  __device__ void fold(int N, int c0, int C2, int t0, uint4* marks) {
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const float tm = tmax[c];
      const uint4 w = make_uint4(tmark[c * 4], tmark[c * 4 + 1],
                                 tmark[c * 4 + 2], tmark[c * 4 + 3]);
      const int pc = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (tm > rmax[c]) {
        rmax[c] = tm;
        rcnt[c] = pc;
        const int f = w.x ? __ffs(w.x) - 1
                    : w.y ? 32 + __ffs(w.y) - 1
                    : w.z ? 64 + __ffs(w.z) - 1
                    : w.w ? 96 + __ffs(w.w) - 1
                          : 0;
        rfirst[c] = t0 + f;
        out = w;
      } else if (tm == rmax[c] && tm > 0.f) {
        rcnt[c] += pc;
        out = w;
      }
      if (c0 + c < C2) marks[c0 + c] = out;
      for (int k = 0; k < 4; ++k) tmark[c * 4 + k] = 0u;
    }
  }
  __device__ void store(int N, int c0, int C2, float* st_max) {
    int* st_cnt = reinterpret_cast<int*>(st_max + C2);
    int* st_first = st_cnt + C2;
    for (int c = threadIdx.x; c < N && c0 + c < C2; c += blockDim.x) {
      st_max[c0 + c] = rmax[c];
      st_cnt[c0 + c] = rcnt[c];
      st_first[c0 + c] = rfirst[c];
    }
  }
};

// Shared-memory offsets of the kernels (bytes from the block's
// 1024-aligned dynamic shared memory).
template <int N>
struct FwdTcLay {
  static constexpr int EMB = N * KB * 2, ENC = KVP * KB * 2;  // a slot's tiles
  static constexpr int SLOT = EMB + ENC, SLOTS = N > 200 ? 3 : 4;
  static constexpr int H1 = RT * KB * 2;
  static constexpr int h1 = 0;                      // an H1 chunk,
  static constexpr int p = h1 + H1;                 // the tile's patches
  static constexpr int ring = p + P_BYTES;          // SLOTS x (emb, enc)
  static constexpr int st = ring + SLOTS * SLOT;    // tokens of a tile
  static constexpr int cs = st + MAX_POS * 8;       // column statistics
  static constexpr int bars = cs + ColStats::BYTES;
  static constexpr int total = (bars + 2 * SLOTS * 8 + 1023) / 1024 * 1024;
  static_assert(EMB % 1024 == 0 && SLOT % 1024 == 0, "tile alignment");
  static_assert(total <= 232448, "more than a block's shared memory");
};
struct FwdSimtLay {
  static constexpr int EMB = KS * NF * 4, ENC = KVP * KS * 4;
  static constexpr int SLOT = EMB + ENC, SLOTS = 4;
  static constexpr int A = RT * LDA * 4;
  static constexpr int ring = 0;
  static constexpr int a = ring + SLOTS * SLOT;     // two H1 stages
  static constexpr int st = a + 2 * A;
  static constexpr int cs = st + MAX_POS * 8;
  static constexpr int bars = cs + ColStats::BYTES;
  static constexpr int total = (bars + 2 * SLOTS * 8 + 1023) / 1024 * 1024;
  static_assert(total <= 232448 && NF * FTHREADS / 32 * 4 <= 2 * A,
                "shared memory; the pool's maxima fit over H1");
};
// the backward: B operand tiles, two G1 chunks, dP, the routed lists
template <bool BF>
struct BwdLay {
  static constexpr int SLOT = BF ? KVP * KB * 2 : KS * KVP * 4 + KVP * KS * 4;
  static constexpr int SLOTS = 4;
  static constexpr int G1 = BF ? RT * KB * 2 : RT * LDA * 4;
  static constexpr int g1 = 0;  // bf16: H1, then G1, and the patches;
  static constexpr int p = g1 + G1;  // float32: two G1 stages
  static constexpr int ring = (p + (BF ? P_BYTES : G1) + 1023) / 1024 * 1024;
  static constexpr int dps = ring + SLOTS * SLOT;   // dP [RT][DPS] float32;
  static constexpr int pairs = dps;                 // before it, the routed
  static constexpr int start = pairs + PCAP * 4;    // channels of each row
  static constexpr int cur = start + (RT + 4) * 4;  // (CSR), per channel its
  static constexpr int wrow = cur + RT * 4;         // words (WCAP at most)
  static constexpr int st = dps + RT * DPS * 4;
  static constexpr int red = st + MAX_POS * 8;
  static constexpr int bars = red + WARPS * 4;
  static constexpr int total = (bars + 2 * SLOTS * 8 + 1023) / 1024 * 1024;
  static constexpr int WCAP = (st - wrow) / 16;
  static_assert(SLOT % 1024 == 0 && total <= 232448, "shared memory");
};

// -- forward, bf16: a block per (sample b, column tile, member m); the two
// warpgroups hold 64 rows each of a 128-row tile. Per depth chunk of 64
// channels each warpgroup builds its rows of H1 (the conv, 8 channels a
// lane, from the enc_w tile in the ring) while its wgmma of the chunk
// before runs --
template <int N>
__global__ void __launch_bounds__(THREADS, 1) fwd_tc(const Args a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  using Lay = FwdTcLay<N>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if (smem_u32(smem_raw) & 1023u) __trap();  // the swizzle needs this base
  int2* st = reinterpret_cast<int2*>(smem + Lay::st);
  ColStats cs(smem + Lay::cs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp-uniform to the compiler (a shuffle), or the wgmmas serialise
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3, g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x, ct = blockIdx.y, m = blockIdx.z;
  const int n_t = a.L - a.K + 1, nkb = a.Cp / KB, ksteps = (a.C + 15) / 16;
  const size_t mb = (size_t)m * a.B + b;
  const float* encb = a.encb + (size_t)m * a.Cp;
  const float* xb = a.x + (size_t)b * a.L * a.V;
  const uint32_t n_tiles = (uint32_t)(a.nrt * nkb);
  const uint32_t ring_u = smem_u32(smem + Lay::ring);
  Ring<Lay::SLOTS> ring;
  // tile i: the emb_w^T tile (this column tile, chunk i % nkb) and the
  // K*V rows of the enc_w tile of the chunk, in one slot
  auto fill = [&](uint32_t i, bool on) {
    const int kc = (int)(i % nkb);
    const uint32_t dst = ring_u + (i % Lay::SLOTS) * Lay::SLOT;
    bulk(ring.full(i), dst,
         static_cast<const char*>(a.emb) +
             (((size_t)m * a.ncol + ct) * nkb + kc) * Lay::EMB,
         Lay::EMB, dst + Lay::EMB,
         static_cast<const char*>(a.enc) + ((size_t)m * nkb + kc) * Lay::ENC,
         (a.K * a.V + 15) / 16 * 16 * KB * 2,  // the rows the conv reads
         on && i < n_tiles);
  };
  ring.init(smem_u32(smem + Lay::bars));
  cs.init(a.embb + ((size_t)m * a.ncol + ct) * N, N);
  __syncthreads();
  ring.start(fill);

  float acc[N / 2], acc2[32];  // the embed product's sums, the conv's
#pragma unroll
  for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 32; ++q) acc2[q] = 0.f;
  const int rbase = wg * 64 + wq * 16 + g;  // this thread's rows: + 0, 8
  uint32_t n = 0;
  for (int rt = 0; rt < a.nrt; ++rt) {
    const int t0 = rt * RT;
    tile_tokens(a, a.tok + (size_t)b * a.L, t0, st);
    build_patches(a, st, xb + (size_t)t0 * a.V, t0, n_t, smem + Lay::p);
    const bool active = t0 + wg * 64 < n_t;  // warpgroup-uniform
    unsigned char* h1 = smem + Lay::h1;
    const uint32_t p_u = smem_u32(smem + Lay::p);
    auto slot_of = [&](uint32_t i) {
      return smem + Lay::ring + (i % Lay::SLOTS) * Lay::SLOT;
    };
    // -- this warpgroup's rows of H1 = rnd(relu(P @ enc_w + b)) of a chunk
    // on the tensor cores, each chunk's conv issued behind the product of
    // the chunk before --
    ring.wait(n);
    wgmma_fence();
    if (active) conv_mma(acc2, p_u, smem_u32(slot_of(n) + Lay::EMB), wg,
                         a.K * a.V);
    wgmma_commit();
    for (int kc = 0; kc < nkb; ++kc) {
      const uint32_t i = n + kc;
      const unsigned char* slot = slot_of(i);
      wgmma_wait<0>();  // the conv, and the chunk before: its slot is free
      if (kc > 0) ring.release(i - 1, fill);
      if (active) conv_store(acc2, encb, kc * KB, rbase, h1);
      fence_async_proxy();
      wg_bar(wg);
      PHASE_TICK(1)  // conv (H1)
      // -- H2's sums: acc += H1 chunk @ emb_w chunk, 64 rows a warpgroup --
      wgmma_fence();
      if (active) {
        const uint64_t da = wgmma_desc(smem_u32(h1) + wg * 64 * 128);
        const uint64_t db = wgmma_desc(smem_u32(slot));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (kc * 4 + ks < ksteps)
            wg_mma<N>(acc, da + 2 * ks, db + 2 * ks, kc + ks > 0);
      }
      if (kc + 1 < nkb) {
        ring.wait(i + 1);
        if (active) conv_mma(acc2, p_u, smem_u32(slot_of(i + 1) + Lay::EMB),
                             wg, a.K * a.V);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    ring.release(n + nkb - 1, fill);
    n += nkb;
    PHASE_TICK(2)  // embed product
    // -- max-pool of the tile, from the accumulators: each warp's column
    // maxima (shuffles over its 16 rows, several columns at once), the
    // tile's, then the rows that reach them, folded into the running
    // statistics --
    __syncthreads();  // every wgmma of the tile is done: H1 is free
    float* pmax = reinterpret_cast<float*>(smem + Lay::h1);
    const bool ok0 = t0 + rbase < n_t, ok1 = t0 + rbase + 8 < n_t;
    constexpr int NG = N / 8, G = NG % 8 == 0 ? 8 : 5;
#pragma unroll
    for (int n0 = 0; n0 < NG; n0 += G) {
      float v[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[q][j] = fmaxf(ok0 ? acc[(n0 + q) * 4 + j] : -INFINITY,
                          ok1 ? acc[(n0 + q) * 4 + 2 + j] : -INFINITY);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            v[q][j] = fmaxf(v[q][j],
                            __shfl_xor_sync(0xffffffffu, v[q][j], off));
      if (g == 0)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            pmax[warp * N + (n0 + q) * 8 + tig * 2 + j] = v[q][j];
    }
    __syncthreads();
    cs.choose<true>(pmax, N, WARPS);
    __syncthreads();
    unsigned fl[(N + 31) / 32];
#pragma unroll
    for (int w = 0; w < (N + 31) / 32; ++w) fl[w] = cs.flag[w];
#pragma unroll
    for (int ni = 0; ni < NG; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ni * 8 + tig * 2 + j;  // c / 32 = ni / 4
        if (!((fl[ni >> 2] >> (c & 31)) & 1u)) continue;
        const float want = cs.want[c], bias = cs.bias[c];
        if (ok0 && act<true>(acc[ni * 4 + j] + bias) == want)
          cs.mark(c, rbase);
        if (ok1 && act<true>(acc[ni * 4 + 2 + j] + bias) == want)
          cs.mark(c, rbase + 8);
      }
    __syncthreads();
    cs.fold(N, ct * N, a.C2, t0, a.marks + (mb * a.nrt + rt) * a.C2);
    PHASE_TICK(3)  // pool
  }
  __syncthreads();
  cs.store(N, ct * N, a.C2, a.stat + mb * 3 * a.C2);
}

// acc[i][j] += sum over a stage's KS k of A[row_i][k] * Bs[k][col_j] (Bs
// rows of NB columns): row_i = ty*4 + i (i < 4), 64 + ty*4 + i - 4; col_j =
// tx*4 + j (j < 4), NB/2 + tx*4 + j - 4. RI, CJ = 4 leave out the second
// half of the rows, columns (a tile's ragged edge). A warp's lanes read one
// or two addresses of A (broadcasts), and 16-byte pieces of a row of Bs.
template <int RI, int CJ, int NB>
__device__ __forceinline__ void product(float (&acc)[8][8], const float* A,
                                        const float* Bs, int tx, int ty) {
  const float* a0 = A + ty * 4 * LDA;
  const float* a1 = a0 + 64 * LDA;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a0 + i * LDA + kk);
      if (RI == 8)
        av[4 + i] = *reinterpret_cast<const float4*>(a1 + i * LDA + kk);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(Bs + (kk + s) * NB + tx * 4);
      float4 b1 = b0;
      if (CJ == 8)
        b1 = *reinterpret_cast<const float4*>(Bs + (kk + s) * NB + NB / 2 +
                                              tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float x = s == 0 ? av[i].x
                        : s == 1 ? av[i].y
                        : s == 2 ? av[i].z
                                 : av[i].w;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

// the product of a stage over the rows and columns of T and C2 (or K*V):
// halves past them left out
template <int NB>
__device__ __forceinline__ void product_edge(float (&acc)[8][8],
                                             const float* A, const float* Bs,
                                             int tx, int ty, bool rows2,
                                             bool cols2) {
  if (rows2 && cols2) product<8, 8, NB>(acc, A, Bs, tx, ty);
  else if (rows2) product<8, 4, NB>(acc, A, Bs, tx, ty);
  else if (cols2) product<4, 8, NB>(acc, A, Bs, tx, ty);
  else product<4, 4, NB>(acc, A, Bs, tx, ty);
}

// -- forward, float32: a block per (sample b, column tile of 256, member m),
// 8 x 8 sums a thread on FMAs (no TF32); per depth stage of 16 channels
// the block builds H1 of the stage (the conv, 4 channels a thread, from the
// enc_w stage in the ring) into one of two buffers --
__global__ void __launch_bounds__(FTHREADS, 1) fwd_simt(const Args a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  using Lay = FwdSimtLay;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  int2* st = reinterpret_cast<int2*>(smem + Lay::st);
  ColStats cs(smem + Lay::cs);
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;  // ty: the warp
  const int b = blockIdx.x, ct = blockIdx.y, m = blockIdx.z;
  const int n_t = a.L - a.K + 1, nks = a.Cp / KS, KV = a.K * a.V;
  const size_t mb = (size_t)m * a.B + b;
  const float* encb = a.encb + (size_t)m * a.Cp;
  const float* xb = a.x + (size_t)b * a.L * a.V;
  const uint32_t n_tiles = (uint32_t)(a.nrt * nks);
  const uint32_t ring_u = smem_u32(smem + Lay::ring);
  Ring<Lay::SLOTS> ring;
  // stage i: rows ks*16 .. +15 of this column tile of emb_w and the
  // columns ks*16 .. +15 of enc_w (ks = i % nks)
  auto fill = [&](uint32_t i, bool on) {
    const int ks = (int)(i % nks);
    const uint32_t dst = ring_u + (i % Lay::SLOTS) * Lay::SLOT;
    bulk(ring.full(i), dst,
         static_cast<const float*>(a.emb) +
             (((size_t)m * a.ncol + ct) * a.Cp + ks * KS) * NF,
         Lay::EMB, dst + Lay::EMB,
         static_cast<const float*>(a.enc) + ((size_t)m * nks + ks) * KV * KS,
         KV * KS * 4, on && i < n_tiles);
  };
  ring.init(smem_u32(smem + Lay::bars));
  cs.init(a.embb + ((size_t)m * a.ncol + ct) * NF, NF);
  __syncthreads();
  ring.start(fill);

  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); };
  auto col_of = [&](int j) { return (j < 4 ? 0 : NF / 2) + tx * 4 + (j & 3); };
  const bool cols2 = ct * NF + NF / 2 < a.C2;
  const int q4 = tid & 3, r = tid >> 2;  // H1: a row, 4 channels
  float acc[8][8];
  uint32_t n = 0;
  for (int rt = 0; rt < a.nrt; ++rt) {
    const int t0 = rt * RT;
    const bool onehot = tile_tokens(a, a.tok + (size_t)b * a.L, t0, st);
    const float* xt = xb + (size_t)t0 * a.V;
    const bool rows2 = t0 + 64 < n_t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int ks = 0; ks < nks; ++ks) {
      const uint32_t i = n + ks;
      ring.wait(i);
      const float* slot = reinterpret_cast<const float*>(
          smem + Lay::ring + (i % Lay::SLOTS) * Lay::SLOT);
      float* A = reinterpret_cast<float*>(smem + Lay::a + (ks & 1) * Lay::A);
      // -- H1 = relu(conv + b) of the stage's 16 channels (0 past T), into
      // the buffer the product before last read --
      {
        const float* est = slot + Lay::EMB / 4;  // enc_w [K*V][16]
        const float4 bias =
            *reinterpret_cast<const float4*>(encb + ks * KS + q4 * 4);
        auto row = [&](int j, float xv, float (&s)[4]) {
          const float4 w =
              *reinterpret_cast<const float4*>(est + j * KS + q4 * 4);
          s[0] = fmaf(xv, w.x, s[0]);
          s[1] = fmaf(xv, w.y, s[1]);
          s[2] = fmaf(xv, w.z, s[2]);
          s[3] = fmaf(xv, w.w, s[3]);
        };
        float s[4];
        const bool in = t0 + r < n_t;
        if (in) conv<4>(a, st, onehot, xt, r, s, row);
        *reinterpret_cast<float4*>(A + r * LDA + q4 * 4) =
            in ? make_float4(act<false>(s[0] + bias.x),
                             act<false>(s[1] + bias.y),
                             act<false>(s[2] + bias.z),
                             act<false>(s[3] + bias.w))
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // and every warp is done with stage i - 1
      if (i > 0) ring.refill(i - 1, fill);
      PHASE_TICK(1)  // conv (H1)
      product_edge<NF>(acc, A, slot, tx, ty, rows2, cols2);
      PHASE_TICK(2)  // embed product
    }
    n += nks;
    // -- max-pool of the tile, as the bf16 kernel's --
    __syncthreads();  // every product of the tile is done: A is free
    float* pmax = reinterpret_cast<float*>(smem + Lay::a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // a warp holds one ty: its 8 rows
      float v = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t0 + row_of(i) < n_t) v = fmaxf(v, acc[i][j]);
      pmax[ty * NF + col_of(j)] = v;
    }
    __syncthreads();
    cs.choose<false>(pmax, NF, FTHREADS / 32);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(j);
      if (!cs.flagged(c)) continue;
      const float want = cs.want[c], bias = cs.bias[c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t0 + row_of(i) < n_t && act<false>(acc[i][j] + bias) == want)
          cs.mark(c, row_of(i));
    }
    __syncthreads();
    cs.fold(NF, ct * NF, a.C2, t0, a.marks + (mb * a.nrt + rt) * a.C2);
    PHASE_TICK(3)  // pool
  }
  __syncthreads();
  cs.store(NF, ct * NF, a.C2, a.stat + mb * 3 * a.C2);
}

// -- backward, both types: a block per (sample b, member m) --

// pred_m (a fixed-order sum) and per channel the routed gradient rnd(mx > 0
// ? dec_w / (split ? count : 1) : 0) over the max, the first row over the
// count (-1: no gradient). Ends with a barrier of the block.
template <bool BF>
__device__ __forceinline__ void scales(const Args& a, int m, size_t mb,
                                       float* red) {
  const int C2 = a.C2, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* st_max = a.stat + mb * 3 * C2;
  int* st_cnt = reinterpret_cast<int*>(st_max + C2);
  const int* st_first = st_cnt + C2;
  const float* decw = a.decw + (size_t)m * C2;
  float sum = 0.f;
  for (int c = threadIdx.x; c < C2; c += THREADS) {
    const float best = st_max[c], d = decw[c];
    sum += best * d;
    float sc = best > 0.f ? d / (float)(a.pool_first ? 1 : st_cnt[c]) : 0.f;
    if (BF) sc = rb(sc);
    st_max[c] = sc;
    st_cnt[c] = sc != 0.f ? st_first[c] : -1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    a.pred[mb] = s + a.decb[m];
  }
}

// The rows of tile rt that channel c2 routes its gradient to ("split":
// the tile's mark words from the tile of the first row on; "first": the
// first row alone); first[c2] < 0: none.
__device__ __forceinline__ uint4 routed(const Args& a, const uint4* marks,
                                        const int* first, int rt, int c2) {
  const int f = first[c2];
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (f < 0 || f / RT > rt) return w;
  if (!a.pool_first) return marks[(size_t)rt * a.C2 + c2];
  if (f / RT == rt) {
    const unsigned bit = 1u << (f % 32);
    const int q = (f % RT) / 32;
    w = make_uint4(q == 0 ? bit : 0u, q == 1 ? bit : 0u, q == 2 ? bit : 0u,
                   q == 3 ? bit : 0u);
  }
  return w;
}

__device__ __forceinline__ bool routed_row(const Args& a, const uint4* marks,
                                           const int* first, int rt, int c2,
                                           int r) {
  const uint4 w = routed(a, marks, first, rt, c2);
  const unsigned q = r < 64 ? (r < 32 ? w.x : w.y) : (r < 96 ? w.z : w.w);
  return (q >> (r & 31)) & 1u;
}

// Where a backward block keeps the routed channels of a row tile: per
// row a run of pairs (CSR: start[r] .. start[r + 1], ascending), and per
// channel its four words of routed rows when C2 <= wcap. Rows past PCAP
// pairs scan the channels instead.
struct Routes {
  int* pairs;
  int* start;
  int* cur;
  unsigned* wrow;
  const uint4* marks;  // this (sample, member)'s mark words
  const int* first;    // per channel its first row (-1: no gradient)
  int wcap;
  __device__ bool cached(const Args& a) const { return a.C2 <= wcap; }
  __device__ int count(int r) const { return start[r + 1] - start[r]; }
  __device__ bool listed(int r) const { return start[r + 1] <= PCAP; }
  // does channel c2 route to row r of tile rt
  __device__ bool routes(const Args& a, int rt, int c2, int r) const {
    if (cached(a)) return (wrow[c2 * 4 + (r >> 5)] >> (r & 31)) & 1u;
    return routed_row(a, marks, first, rt, c2, r);
  }
};

// The routes of tile rt: counts by integer atomics, a prefix sum over the
// rows, the pairs placed by atomics and each row's run sorted (the set is
// fixed, so the order is). Ends with a barrier of the block.
__device__ __forceinline__ void tile_routes(const Args& a, const Routes& R,
                                            int rt) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int r = tid; r < RT; r += THREADS) R.cur[r] = 0;
  __syncthreads();
  const bool cached = R.cached(a);
  for (int c0 = tid; c0 < a.C2; c0 += 4 * THREADS) {  // four loads in flight
    uint4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c2 = c0 + u * THREADS;
      w[u] = c2 < a.C2 ? routed(a, R.marks, R.first, rt, c2)
                       : make_uint4(0u, 0u, 0u, 0u);
      if (cached && c2 < a.C2)
        *reinterpret_cast<uint4*>(R.wrow + c2 * 4) = w[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        for (unsigned bits = ws[q]; bits; bits &= bits - 1)
          atomicAdd(&R.cur[q * 32 + __ffs(bits) - 1], 1);
    }
  }
  __syncthreads();
  if (tid < 32) {  // start[r] = pairs of the rows before r
    int c[RT / 32], sum = 0;
#pragma unroll
    for (int k = 0; k < RT / 32; ++k) {
      c[k] = R.cur[lane * (RT / 32) + k];
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < RT / 32; ++k) {
      R.start[lane * (RT / 32) + k] = run;
      R.cur[lane * (RT / 32) + k] = 0;
      run += c[k];
    }
    if (lane == 31) R.start[RT] = incl;
  }
  __syncthreads();
  for (int c2 = tid; c2 < a.C2; c2 += THREADS) {
    const uint4 w = cached ? *reinterpret_cast<const uint4*>(R.wrow + c2 * 4)
                           : routed(a, R.marks, R.first, rt, c2);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (unsigned bits = ws[q]; bits; bits &= bits - 1) {
        const int r = q * 32 + __ffs(bits) - 1;
        if (R.listed(r)) R.pairs[R.start[r] + atomicAdd(&R.cur[r], 1)] = c2;
      }
  }
  __syncthreads();
  for (int r = tid; r < RT; r += THREADS) {
    if (!R.listed(r)) continue;
    int* l = R.pairs + R.start[r];
    const int nc = R.count(r);
    for (int i = 1; i < nc; ++i) {
      const int v = l[i];
      int j = i - 1;
      while (j >= 0 && l[j] > v) {
        l[j + 1] = l[j];
        --j;
      }
      l[j + 1] = v;
    }
  }
  __syncthreads();
}

// col2im of a tile: dx[pos, v] = sum_k dP[pos - k, k*V + v] over the
// tile's rows, k ascending, added to what the tiles before wrote (one
// thread per entry: every sum has one order)
__device__ __forceinline__ void col2im(const Args& a, float* out,
                                       const float* dps, int t0, int n_t) {
  const int V = a.V, KV = a.K * V;
  const int t_end = min(t0 + RT, n_t);
  const int f_hi = (t_end - 1) * V + KV;
  const int f_old = t0 > 0 ? (t0 - 1) * V + KV : 0;
  for (int f = t0 * V + threadIdx.x; f < f_hi; f += THREADS) {
    const int pos = f / V, v = f - pos * V;
    float s = f < f_old ? out[f] : 0.f;
    for (int k = 0; k < a.K; ++k) {
      const int t = pos - k;
      if (t >= t0 && t < t_end) s += dps[(t - t0) * DPS + k * V + v];
    }
    out[f] = s;
  }
}

// G1 of row r of tile rt at this thread's P pieces of its channels (two
// threads a row): the sum over the row's routed channels, ascending, of
// their gradients times their rows of emb_w^T (load(c2, k) loads piece k,
// gather(piece, sc, g) adds it). A listed row takes 8 / P entries at a
// time, all their loads issued before the first is used; others scan every
// channel, the row's two lanes (converged) testing one channel each.
template <int P, int WP, class Load, class Gather>
__device__ __forceinline__ void g1_row(const Args& a, const Routes& R,
                                       const float* scale, int rt, int r,
                                       float (&g)[P][WP], Load load,
                                       Gather gather) {
  constexpr int EB = 8 / P;
  using Piece = decltype(load(0, 0));
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int q = 0; q < WP; ++q) g[k][q] = 0.f;
  if (R.listed(r)) {
    const int* l = R.pairs + R.start[r];
    const int nc = R.count(r);
    for (int e0 = 0; e0 < nc; e0 += EB) {
      Piece rows[EB][P];
      float sc[EB];
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int c2 = l[min(e0 + e, nc - 1)];
        sc[e] = e0 + e < nc ? scale[c2] : 0.f;
#pragma unroll
        for (int k = 0; k < P; ++k) rows[e][k] = load(c2, k);
      }
#pragma unroll
      for (int e = 0; e < EB; ++e)
        if (e0 + e < nc)
#pragma unroll
          for (int k = 0; k < P; ++k) gather(rows[e][k], sc[e], g[k]);
    }
    return;
  }
  const int lane = threadIdx.x & 31, base = lane & ~1;
  const unsigned gmask = 3u << base;
  for (int c0 = 0; c0 < a.C2; c0 += 2) {
    const int c2 = c0 + (lane & 1);
    const bool on = c2 < a.C2 && R.routes(a, rt, c2, r);
    unsigned bal = (__ballot_sync(gmask, on) & gmask) >> base;
    while (bal) {
      const int cc = c0 + __ffs(bal) - 1;
      bal &= bal - 1;
#pragma unroll
      for (int k = 0; k < P; ++k) gather(load(cc, k), scale[cc], g[k]);
    }
  }
}

// -- backward, bf16: per row tile of 128 and depth chunk of 64 channels
// each warpgroup builds its rows of G1 (routed gather, relu mask from the
// conv, rounded) over the chunk while its dP wgmma of the chunk before runs;
// dP = G1 @ enc_w^T on wgmma m64n128k16 (K*V padded to 128) --
__global__ void __launch_bounds__(THREADS, 1) bwd_tc(const Args a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  using Lay = BwdLay<true>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if (smem_u32(smem_raw) & 1023u) __trap();
  int2* st = reinterpret_cast<int2*>(smem + Lay::st);
  float* dps = reinterpret_cast<float*>(smem + Lay::dps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // (as fwd_tc)
  const int wq = warp & 3, g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x, m = blockIdx.y;
  const int n_t = a.L - a.K + 1, nkb = a.Cp / KB, ksteps = (a.C + 15) / 16;
  const size_t mb = (size_t)m * a.B + b;
  const float* encb = a.encb + (size_t)m * a.Cp;
  const float* xb = a.x + (size_t)b * a.L * a.V;
  const bf16* embwT = static_cast<const bf16*>(a.embwT) + (size_t)m * a.C2 * a.Cp;
  const uint4* marks = a.marks + mb * a.nrt * a.C2;
  const float* scale = a.stat + mb * 3 * a.C2;
  const int* first = reinterpret_cast<const int*>(scale + a.C2);
  float* out = a.dxm + mb * a.L * a.V;
  const Routes R{reinterpret_cast<int*>(smem + Lay::pairs),
                 reinterpret_cast<int*>(smem + Lay::start),
                 reinterpret_cast<int*>(smem + Lay::cur),
                 reinterpret_cast<unsigned*>(smem + Lay::wrow),
                 marks, first, Lay::WCAP};
  const uint32_t n_tiles = (uint32_t)(a.nrt * nkb);
  const uint32_t ring_u = smem_u32(smem + Lay::ring);
  Ring<Lay::SLOTS> ring;
  auto fill = [&](uint32_t i, bool on) {  // tile i: enc_w, chunk i % nkb
    bulk(ring.full(i), ring_u + (i % Lay::SLOTS) * Lay::SLOT,
         static_cast<const char*>(a.enc) +
             ((size_t)m * nkb + (int)(i % nkb)) * Lay::SLOT,
         Lay::SLOT, 0u, nullptr, 0, on && i < n_tiles);
  };
  ring.init(smem_u32(smem + Lay::bars));
  __syncthreads();
  ring.start(fill);
  scales<true>(a, m, mb, reinterpret_cast<float*>(smem + Lay::red));
  __syncthreads();  // the gradients and first rows are read from here on
  PHASE_TICK(4)  // pred and routed gradients

  float acc[KVP / 2], acc2[32];  // dP's sums, the conv's
#pragma unroll
  for (int q = 0; q < KVP / 2; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 32; ++q) acc2[q] = 0.f;
  const int wt = tid & 127;
  const int rbase = wg * 64 + wq * 16 + g;  // this thread's rows: + 0, 8
  unsigned char* g1 = smem + Lay::g1;
  uint32_t n = 0;
  for (int rt = 0; rt < a.nrt; ++rt) {
    const int t0 = rt * RT;
    tile_tokens(a, a.tok + (size_t)b * a.L, t0, st);
    build_patches(a, st, xb + (size_t)t0 * a.V, t0, n_t, smem + Lay::p);
    tile_routes(a, R, rt);
    PHASE_TICK(0)  // tokens, patches and routed lists
    const bool active = t0 + wg * 64 < n_t;
    const uint32_t p_u = smem_u32(smem + Lay::p);
    auto slot_of = [&](uint32_t i) {
      return smem + Lay::ring + (i % Lay::SLOTS) * Lay::SLOT;
    };
    // -- H1 of a chunk (the forward's conv, the same bits) over the G1
    // tile, each chunk's conv issued behind the dP of the chunk before --
    ring.wait(n);
    wgmma_fence();
    if (active) conv_mma(acc2, p_u, smem_u32(slot_of(n)), wg, a.K * a.V);
    wgmma_commit();
    for (int kc = 0; kc < nkb; ++kc) {
      const uint32_t i = n + kc;
      const unsigned char* etile = slot_of(i);
      wgmma_wait<0>();
      if (kc > 0) ring.release(i - 1, fill);
      if (active) conv_store(acc2, encb, kc * KB, rbase, g1);
      wg_bar(wg);
      // -- G1 = rnd([H1 > 0] * routed gather) over H1, this warpgroup's
      // rows: two threads a row, 32 channels (four 16-byte pieces) each --
      if (active) {
        const int rr = wg * 64 + (wt >> 1), hf = wt & 1;
        const int c = kc * KB + hf * 32;
        auto load = [&](int c2, int k) {
          return __ldg(reinterpret_cast<const uint4*>(
              embwT + (size_t)c2 * a.Cp + c + k * 8));
        };
        auto gather = [&](uint4 w, float sc, float (&gg)[8]) {
          const unsigned ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            gg[2 * q] = fmaf(sc, bf_lo(ww[q]), gg[2 * q]);
            gg[2 * q + 1] = fmaf(sc, bf_hi(ww[q]), gg[2 * q + 1]);
          }
        };
        uint4 o[4] = {};
        if (t0 + rr < n_t) {  // uniform in the row's two lanes
          float gv[4][8];
          g1_row<4, 8>(a, R, scale, rt, rr, gv, load, gather);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint4 hv =
                *reinterpret_cast<const uint4*>(g1 + sw(rr, hf * 4 + k));
            const unsigned hw[4] = {hv.x, hv.y, hv.z, hv.w};
            unsigned ov[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat162 r2 = __floats2bfloat162_rn(
                  bf_lo(hw[q]) > 0.f ? gv[k][2 * q] : 0.f,
                  bf_hi(hw[q]) > 0.f ? gv[k][2 * q + 1] : 0.f);
              ov[q] = (unsigned)__bfloat16_as_ushort(r2.x) |
                      ((unsigned)__bfloat16_as_ushort(r2.y) << 16);
            }
            o[k] = make_uint4(ov[0], ov[1], ov[2], ov[3]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)  // over the pieces of H1 it read
          *reinterpret_cast<uint4*>(g1 + sw(rr, hf * 4 + k)) = o[k];
      }
      fence_async_proxy();
      wg_bar(wg);
      PHASE_TICK(5)  // gather of G1
      // -- dP += G1 chunk @ enc_w chunk^T --
      wgmma_fence();
      if (active) {
        const uint64_t da = wgmma_desc(smem_u32(g1) + wg * 64 * 128);
        const uint64_t db = wgmma_desc(smem_u32(etile));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (kc * 4 + ks < ksteps)
            wg_mma<KVP>(acc, da + 2 * ks, db + 2 * ks, kc + ks > 0);
      }
      if (kc + 1 < nkb) {
        ring.wait(i + 1);
        if (active)
          conv_mma(acc2, p_u, smem_u32(slot_of(i + 1)), wg, a.K * a.V);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    ring.release(n + nkb - 1, fill);
    n += nkb;
    __syncthreads();  // both warpgroups are done with the routes
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ni = 0; ni < KVP / 8; ++ni)
        *reinterpret_cast<float2*>(dps + (rbase + hf * 8) * DPS + ni * 8 +
                                   tig * 2) =
            make_float2(acc[ni * 4 + hf * 2], acc[ni * 4 + hf * 2 + 1]);
    __syncthreads();
    PHASE_TICK(6)  // dP product and staging
    col2im(a, out, dps, t0, n_t);
    __syncthreads();  // dP and dx are read before the next tile
    PHASE_TICK(7)     // col2im and store
  }
}

// -- backward, float32: per row tile of 128 and depth stage of 16 channels
// the block builds G1 of the stage (4 channels a thread) into one of two
// buffers; dP = G1 @ enc_w^T on FMAs, 8 x 8 a thread (K*V padded to 128) --
__global__ void __launch_bounds__(THREADS, 1) bwd_simt(const Args a) {
#ifdef CNN_PHASE_CLOCKS
  long long phase_t0 = clock64();
#endif
  using Lay = BwdLay<false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  int2* st = reinterpret_cast<int2*>(smem + Lay::st);
  float* dps = reinterpret_cast<float*>(smem + Lay::dps);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x, m = blockIdx.y;
  const int n_t = a.L - a.K + 1, nks = a.Cp / KS, KV = a.K * a.V;
  const size_t mb = (size_t)m * a.B + b;
  const float* encb = a.encb + (size_t)m * a.Cp;
  const float* xb = a.x + (size_t)b * a.L * a.V;
  const float* embwT = static_cast<const float*>(a.embwT) + (size_t)m * a.C2 * a.Cp;
  const uint4* marks = a.marks + mb * a.nrt * a.C2;
  const float* scale = a.stat + mb * 3 * a.C2;
  const int* first = reinterpret_cast<const int*>(scale + a.C2);
  float* out = a.dxm + mb * a.L * a.V;
  const Routes R{reinterpret_cast<int*>(smem + Lay::pairs),
                 reinterpret_cast<int*>(smem + Lay::start),
                 reinterpret_cast<int*>(smem + Lay::cur),
                 reinterpret_cast<unsigned*>(smem + Lay::wrow),
                 marks, first, Lay::WCAP};
  const uint32_t n_tiles = (uint32_t)(a.nrt * nks);
  const uint32_t ring_u = smem_u32(smem + Lay::ring);
  constexpr int ET = KS * KVP * 4;  // enc_w^T's stage, then enc_w's
  Ring<Lay::SLOTS> ring;
  auto fill = [&](uint32_t i, bool on) {
    const int ks = (int)(i % nks);
    const uint32_t dst = ring_u + (i % Lay::SLOTS) * Lay::SLOT;
    bulk(ring.full(i), dst, a.encT + ((size_t)m * a.Cp + ks * KS) * KVP, ET,
         dst + ET,
         static_cast<const float*>(a.enc) + ((size_t)m * nks + ks) * KV * KS,
         KV * KS * 4, on && i < n_tiles);
  };
  ring.init(smem_u32(smem + Lay::bars));
  __syncthreads();
  ring.start(fill);
  scales<false>(a, m, mb, reinterpret_cast<float*>(smem + Lay::red));
  __syncthreads();
  PHASE_TICK(4)  // pred and routed gradients

  const bool cols2 = 64 < KV;
  float acc[8][8];
  uint32_t n = 0;
  for (int rt = 0; rt < a.nrt; ++rt) {
    const int t0 = rt * RT;
    const bool onehot = tile_tokens(a, a.tok + (size_t)b * a.L, t0, st);
    tile_routes(a, R, rt);
    PHASE_TICK(0)  // tokens and routed lists
    const float* xt = xb + (size_t)t0 * a.V;
    const bool rows2 = t0 + 64 < n_t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int ks = 0; ks < nks; ++ks) {
      const uint32_t i = n + ks;
      ring.wait(i);
      const float* slot = reinterpret_cast<const float*>(
          smem + Lay::ring + (i % Lay::SLOTS) * Lay::SLOT);
      float* A = reinterpret_cast<float*>(smem + Lay::g1 + (ks & 1) * Lay::G1);
      {  // G1 of the stage: two threads a row, 8 channels each
        const int rr = tid >> 1, hf = tid & 1;
        const int c = ks * KS + hf * 8;
        const float* est = slot + ET / 4;  // enc_w [K*V][16]
        auto load = [&](int c2, int k) {
          return __ldg(reinterpret_cast<const float4*>(
              embwT + (size_t)c2 * a.Cp + c + k * 4));
        };
        auto gather = [&](float4 w, float sc, float (&gg)[4]) {
          gg[0] = fmaf(sc, w.x, gg[0]);
          gg[1] = fmaf(sc, w.y, gg[1]);
          gg[2] = fmaf(sc, w.z, gg[2]);
          gg[3] = fmaf(sc, w.w, gg[3]);
        };
        float4 o[2] = {};
        if (t0 + rr < n_t) {  // uniform in the row's two lanes
          float gv[2][4];
          g1_row<2, 4>(a, R, scale, rt, rr, gv, load, gather);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            auto row = [&](int j, float xv, float (&s)[4]) {
              const float4 w = *reinterpret_cast<const float4*>(
                  est + j * KS + hf * 8 + k * 4);
              s[0] = fmaf(xv, w.x, s[0]);
              s[1] = fmaf(xv, w.y, s[1]);
              s[2] = fmaf(xv, w.z, s[2]);
              s[3] = fmaf(xv, w.w, s[3]);
            };
            float s[4];
            conv<4>(a, st, onehot, xt, rr, s, row);
            const float4 bias =
                *reinterpret_cast<const float4*>(encb + c + k * 4);
            o[k] = make_float4(s[0] + bias.x > 0.f ? gv[k][0] : 0.f,
                               s[1] + bias.y > 0.f ? gv[k][1] : 0.f,
                               s[2] + bias.z > 0.f ? gv[k][2] : 0.f,
                               s[3] + bias.w > 0.f ? gv[k][3] : 0.f);
          }
        }
        *reinterpret_cast<float4*>(A + rr * LDA + hf * 8) = o[0];
        *reinterpret_cast<float4*>(A + rr * LDA + hf * 8 + 4) = o[1];
      }
      __syncthreads();  // and every warp is done with stage i - 1
      if (i > 0) ring.refill(i - 1, fill);
      PHASE_TICK(5)  // gather of G1
      product_edge<KVP>(acc, A, slot, tx, ty, rows2, cols2);
      PHASE_TICK(6)  // dP product
    }
    n += nks;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* p = dps + ((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * DPS + tx * 4;
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(p + 64) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    col2im(a, out, dps, t0, n_t);
    __syncthreads();
    PHASE_TICK(7)  // col2im and store
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

// the bf16 kernel's column tile for C2 embed channels: wgmma n of 256 or
// 200, whichever pads C2 less (ties: 256)
int bf16_cols(int C2) {
  const int p256 = (C2 + 255) / 256 * 256, p200 = (C2 + 199) / 200 * 200;
  return p200 < p256 ? 200 : 256;
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

// The wide kernels' layout: rows of a row tile (the mark words' unit), the
// depth C is padded to in dtype (0 = float32, 1 = bfloat16), the columns
// of a column tile for C2 embed channels in dtype, the K*V limit.
int cnn_wide_rows() { return wide::RT; }
int cnn_wide_depth(int dtype) { return dtype == 1 ? wide::KB : wide::KS; }
int cnn_wide_cols(int C2, int dtype) {
  return dtype == 1 ? wide::bf16_cols(C2) : wide::NF;
}
int cnn_wide_max_kv() { return wide::KVP; }

// Either type (rnd = 1: bfloat16), from the tensors prepare_ensemble's wide
// layout holds (x [B, L*V] float32 of the type's values; enc, encT, emb,
// embwT as cnn_fused.wide_layout makes them for the type; encb [M, Cp],
// embb [M, ncol * N], decw [M, C2] float32, decb [M]; Cp = C rounded up to
// cnn_wide_depth, N = cnn_wide_cols, zero-padded). Scratch: tok [B, L]
// int2, stat [M, B, 3, C2], marks [M, B, ceil(T / 128), C2] of four words.
// Launches the tokens, the forward (B x column tiles x M blocks), the
// backward (B x M) and the member reduction. Returns a cudaError_t.
int cnn_ensemble_fit_and_grad_wide(
    const void* x, void* tok, const void* enc, const void* encT,
    const void* emb, const void* embwT, const void* encb, const void* embb,
    const void* decw, const void* decb, void* pred, void* dxm, void* stat,
    void* marks, void* fit, void* dx, int B, int L, int V, int K, int C,
    int C2, int M, int pool_first, int rnd, int N, void* stream) {
  if (B <= 0 || M <= 0 || L < K || K < 1 || V < 1 || C < 1 || C2 < 1 ||
      K * V > wide::KVP || N != cnn_wide_cols(C2, rnd))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_t = L - K + 1;
  const int Cp = round_up(C, cnn_wide_depth(rnd));
  wide::Args a{static_cast<const float*>(x),
               static_cast<const int2*>(tok),
               enc,
               static_cast<const float*>(encT),
               emb,
               embwT,
               static_cast<const float*>(encb),
               static_cast<const float*>(embb),
               static_cast<const float*>(decw),
               static_cast<const float*>(decb),
               static_cast<float*>(pred),
               static_cast<float*>(dxm),
               static_cast<float*>(stat),
               static_cast<uint4*>(marks),
               B, L, V, K, C, C2, M, pool_first, N, Cp,
               (C2 + N - 1) / N, (n_t + wide::RT - 1) / wide::RT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long n_pos = (long)B * L;
  wide::tokens_kernel<<<(unsigned)((n_pos + 255) / 256), 256, 0, s>>>(
      a.x, static_cast<int2*>(tok), n_pos, V);
  cudaError_t err = cudaGetLastError();
  auto launch = [&](auto kernel, dim3 grid, int bytes,
                    int threads = wide::THREADS) {
    if (err != cudaSuccess) return;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return;
    kernel<<<grid, threads, bytes, s>>>(a);
    err = cudaGetLastError();
  };
  const dim3 fwd(B, a.ncol, M), bwd(B, M);
  if (rnd) {
    if (N == 256)
      launch(wide::fwd_tc<256>, fwd, wide::FwdTcLay<256>::total);
    else
      launch(wide::fwd_tc<200>, fwd, wide::FwdTcLay<200>::total);
    launch(wide::bwd_tc, bwd, wide::BwdLay<true>::total);
  } else {
    launch(wide::fwd_simt, fwd, wide::FwdSimtLay::total, wide::FTHREADS);
    launch(wide::bwd_simt, bwd, wide::BwdLay<false>::total);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return member_reduce(a.pred, a.dxm, static_cast<float*>(fit),
                       static_cast<float*>(dx), M, B, (long)B * L * V, s);
}

}  // extern "C"
