// Kernel A: fused Potts energy + input gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ppde_tpu/ops/potts_pallas.py:energy_and_grad
// (_kernel). For flattened one-hots xf [B, P], couplings W [P, P] and
// fields h [P] (P a multiple of 128; every sum is float32):
//
//     grad = xf @ W + h                                   [B, P]  float32
//     H    = sum_cols xf * (0.5 * (xf @ W) + h)           [B]     float32
//
// A call may also take a column block of the couplings, W[:, c0 : c0 + N]
// with h[c0 : c0 + N] (N and c0 multiples of 128; the tensor-parallel shard
// of parallel/mesh.shard_potts): it then returns that block's gradient
// [B, N] and the block's share of H, the sum over its columns j of
// xf[:, c0 + j] * (0.5 * (xf @ W)[:, c0 + j] + h[c0 + j]); the shares of all
// blocks add up to H. The whole call is the block (c0, N) = (0, P), and runs
// the same instructions as before blocks existed.
//
// W reaches the kernel as n bf16 planes [n, P, N] whose sum is W: a bf16 W
// is its own single plane; a float32 W is split once, on the host
// (ops/potts_fused.prepare), into W_hi = bf16(W), W_mid = bf16(W - W_hi) and
// W_lo = bf16(W - W_hi - W_mid). Three 8-bit significands hold all 24 bits of
// a float32, so W_hi + W_mid + W_lo == W exactly (outside the subnormal
// range), and xf's entries (0 and 1) are exact in bf16: every product
// xf * W_plane is exact, and the float32 path differs from xf @ W in float32
// only by the order of its float32 sums. h is float32 in both cases.
//
// What bounds it on the H100: bytes, up to B of about 1000 in bf16 (W, 47 MB
// at GFP's P = 4864, read once and the float32 gradient written once); the
// float32 path reads three planes (142 MB) and does three products
// (3 * 2*B*P*P operations, 0.15 ms at B = 1024 at the bf16 tensor-core
// peak), so it is bound by operations from a few hundred rows on. Either way
// a block is paced by how fast an SM pulls its tiles through L2, so tiles
// are large and many are in flight.
//
// Design: a GEMM with a fused epilogue. Each block owns a 128 x 128 output
// tile and walks K, the planes of each 64-deep stage one after another (so a
// row of xf with a single 1 gets hi + mid + lo == W exactly), through a ring
// of 6 shared-memory stages filled by cp.async (16 bytes a copy); both
// operands sit in the 128-byte swizzle and wgmma m64n128k16 reads them from
// shared memory, two warpgroups of 64 rows, one block per SM. At small B
// the split over K (below) cuts between depths, never between the planes of
// one depth. The W tile is staged as it lies
// in memory (rows of k, columns contiguous) and read MN-major (wgmma's
// transposed-B form), so any W is taken, symmetric or not, and nothing is
// transposed on the way. The TPU kernel's sequential-grid
// accumulator (acc_ref, carried from one column tile to the next) has no
// counterpart: blocks run in parallel and in no order. Each block writes its
// tile's gradient and ONE partial energy per row, sum_{cols in tile}
// xf * (0.5*acc + h); a second kernel adds the partials of each row in a
// fixed order. At small B the tiles are too few to fill the card, so K is
// split over gridDim.z: every split writes a partial gradient tile and the
// second kernel adds the splits and h in split order. No atomics: H and grad
// repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;   // columns of W per block (TILE_N)
constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// cp.async ring -> wgmma (both operands bf16, from shared memory in the
// 128-byte swizzle), two warpgroups of 64 rows each
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int TBM = 128;     // rows of xf per block
constexpr int TBK = 64;      // depth of one stage: 128-byte rows of xf
constexpr int STAGES = 6;    // ring of shared-memory stages
constexpr int A_BYTES = TBM * TBK * 2;  // xf stage [m][k], 128-byte rows
constexpr int W_BYTES = TBK * BN * 2;   // W stage [k][n], see w_off
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;

// Both tiles are kept in 128-byte rows of eight 16-byte chunks whose index
// is XORed with the low three bits of the row: the 128-byte swizzle wgmma
// reads. xf [128 x 64]: row m holds its 64 k (K-major).
__device__ __forceinline__ uint32_t a_off(int r, int chunk) {
  return r * (TBK * 2) + ((chunk ^ (r & 7)) << 4);
}
// W [64 x 128], as it lies in memory (n contiguous: MN-major): row k of the
// 64-column half `chunk >> 3` holds its 64 n; eight such rows are one
// 1024-byte group, the eight groups of a half follow one another
// (W_GROUP_BYTES apart), the second half lies W_HALF_BYTES after the first.
constexpr int W_GROUP_BYTES = 1024;
constexpr int W_HALF_BYTES = (TBK / 8) * W_GROUP_BYTES;
__device__ __forceinline__ uint32_t w_off(int k, int chunk) {
  return (chunk >> 3) * W_HALF_BYTES + (k >> 3) * W_GROUP_BYTES +
         (k & 7) * 128 + (((chunk & 7) ^ (k & 7)) << 4);
}

// Descriptor of a bf16 tile in the 128-byte swizzle: start address, leading
// and stride byte offsets. xf (K-major): 1024 bytes from one group of 8 rows
// to the next, the leading offset unused. W (MN-major): the leading offset
// steps from one 64-column half to the next, the stride offset from one
// group of 8 k to the next.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int leading,
                                               int stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// d[64 x 128] (+)= a[64 x 16] * b[16 x 128], both from shared memory, a
// K-major and b MN-major (the last immediate: b transposed); accumulate == 0
// overwrites d, so the accumulators need no zeroing (a plain write to them
// would serialise the asynchronous products)
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
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

// One block: rows row0..row0+127 of xf against columns col0..col0+127 of the
// planes of the column block W [P, N] (columns c0 + col0.. of the whole
// couplings, whose xf entries the epilogue reads) over the depths [64 * d0, 64 * d1) of its split (blockIdx.z);
// stage kt is depth (kt / PLANES) * 64 of plane kt % PLANES, so the planes
// of one depth follow one another into the same accumulators, and a split
// holds whole depths: a row of xf with a single 1 gets hi + mid + lo == W
// exactly, as a float32 product would (PLANES = 1, a bf16 W: stage kt is
// depth kt * 64, and the plane costs nothing). Without a split (gridDim.z
// == 1) it
// writes grad = acc + h; with one it writes its partial product to gpart[z]
// and potts_finish adds the splits and h in order. Either way it writes one
// partial energy per row. The load of stage kt + STAGES - 2 is started while
// the products of stages kt - 1 and kt are in flight.
template <int PLANES>
__global__ void __launch_bounds__(THREADS, 1)
potts_grad_kernel_wgmma(const __nv_bfloat16* __restrict__ xf,
                        const __nv_bfloat16* __restrict__ W,
                        const float* __restrict__ h,
                        float* __restrict__ grad, float* __restrict__ gpart,
                        float* __restrict__ partial, int B, int P, int N,
                        int c0) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float hs[BN];
  // the swizzle is a function of the address: stages start at 1024 bytes
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t sbase = smem_u32(smem);
  constexpr int D = STAGES - 2;  // prefetch distance in stages
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3, wg = warp / 4;
  const int row0 = blockIdx.y * TBM, col0 = blockIdx.x * BN;
  const int nsplit = gridDim.z, z = blockIdx.z;
  const int nk = P / TBK;
  const int kt0 = PLANES * (int)((long)nk * z / nsplit);
  const int kt1 = PLANES * (int)((long)nk * (z + 1) / nsplit);

  auto load_stage = [&](int slot, int kt) {
    const uint32_t sa = sbase + slot * STAGE_BYTES, sw = sa + A_BYTES;
    const int plane = kt % PLANES;
    const int k0 = (kt / PLANES) * TBK;
    const __nv_bfloat16* Wp = W + (size_t)plane * P * N;
#pragma unroll
    for (int j = 0; j < TBM * 8 / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i >> 3, c = i & 7;
      const bool ok = row0 + r < B;
      cp_async16(sa + a_off(r, c),
                 xf + (size_t)(ok ? row0 + r : 0) * P + k0 + c * 8,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < TBK * 16 / THREADS; ++j) {  // W: 16 chunks per row
      const int i = tid + j * THREADS, k = i >> 4, c = i & 15;
      cp_async16(sw + w_off(k, c), Wp + (size_t)(k0 + k) * N + col0 + c * 8);
    }
  };

  float d[BN / 2];  // first written by the first product

#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (kt0 + s < kt1) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<D - 1>();
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage kt landed; the products of kt - 2 are done
    if (kt + D < kt1) load_stage((kt - kt0 + D) % STAGES, kt + D);
    cp_async_commit();
    const uint32_t sa = sbase + ((kt - kt0) % STAGES) * STAGE_BYTES;
    const uint64_t da = wgmma_desc(sa + wg * 64 * (TBK * 2), 16, 1024);
    const uint64_t db =
        wgmma_desc(sa + A_BYTES, W_HALF_BYTES, W_GROUP_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk)  // a k-step: 32 bytes of a row of
                                           // xf, two 8-row groups of W
      wgmma_k16(d, da + 2 * kk, db + kk * (2 * W_GROUP_BYTES >> 4),
                kt > kt0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();

  // epilogue operands on chip: the tile's own xf[rows, col0 : col0 + 128]
  // (256-byte rows, staged into the free ring) and h
  constexpr int CPR = BN / 8;  // 16-byte chunks per row of the xf tile
  auto x_off = [](int r, int chunk) {
    return (uint32_t)(r * (BN * 2) + ((chunk ^ (r & 7)) << 4));
  };
#pragma unroll
  for (int j = 0; j < TBM * CPR / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < B;
    cp_async16(sbase + x_off(r, c),
               xf + (size_t)(ok ? row0 + r : 0) * P + c0 + col0 + c * 8,
               ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < BN; i += THREADS)
    hs[i] = h[col0 + i];
  cp_async_wait<0>();
  __syncthreads();

  const bool direct = nsplit == 1;
  float* out = direct ? grad : gpart + (size_t)z * B * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wg * 64 + (warp % 4) * 16 + g + half * 8, r = row0 + rl;
    float s = 0.f;
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int cl = ni * 8 + tig * 2;
      const float v0 = d[ni * 4 + half * 2], v1 = d[ni * 4 + half * 2 + 1];
      const float h0 = hs[cl], h1 = hs[cl + 1];
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
          smem + x_off(rl, cl >> 3) + (cl & 7) * 2);
      const float x0 = __bfloat162float(xv.x), x1 = __bfloat162float(xv.y);
      const float e0 = z == 0 ? h0 : 0.f, e1 = z == 0 ? h1 : 0.f;
      s += x0 * (0.5f * v0 + e0) + x1 * (0.5f * v1 + e1);
      if (r < B)
        *reinterpret_cast<float2*>(out + (size_t)r * N + col0 + cl) =
            direct ? make_float2(v0 + h0, v1 + h1) : make_float2(v0, v1);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tig == 0 && r < B)
      partial[(size_t)r * (nsplit * (N / BN)) + z * (N / BN) + blockIdx.x] =
          s;
  }
}

// The second kernel, one launch. Blocks [0, e_blocks): H[b] = the sum of
// row b's partial energies, one warp per row: lane l adds partials l,
// l + 32, ... in order, then a fixed xor tree adds the lanes. The blocks
// after them (only with a split over K): grad = h + the splits' partial
// products, added in split order.
__global__ void potts_finish(const float* __restrict__ partial,
                             float* __restrict__ H, int B, int n_part,
                             int e_blocks, const float* __restrict__ gpart,
                             const float* __restrict__ h,
                             float* __restrict__ grad, int N, int nsplit) {
  if ((int)blockIdx.x < e_blocks) {
    const int b = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (b >= B) return;
    float s = 0.f;
    for (int t = lane; t < n_part; t += 32)
      s += partial[(size_t)b * n_part + t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) H[b] = s;
    return;
  }
  const size_t n4 = (size_t)B * N / 4;
  const size_t i =
      (blockIdx.x - e_blocks) * (size_t)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int c = (int)((i * 4) % N);
  float4 s = *reinterpret_cast<const float4*>(h + c);
  for (int z = 0; z < nsplit; ++z) {
    const float4 v =
        reinterpret_cast<const float4*>(gpart + (size_t)z * B * N)[i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  reinterpret_cast<float4*>(grad)[i] = s;
}

int finish(const void* partial, void* H, int B, int n_part, const void* gpart,
           const void* h, void* grad, int N, int nsplit,
           cudaStream_t stream) {
  const int e_blocks = (B + 7) / 8;
  const size_t n4 = nsplit > 1 ? (size_t)B * N / 4 : 0;
  potts_finish<<<e_blocks + (unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(H), B, n_part,
      e_blocks, static_cast<const float*>(gpart),
      static_cast<const float*>(h), static_cast<float*>(grad), N,
      nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int PLANES>
int launch(const void* xf, const void* W, const void* h, void* grad,
           void* gpart, void* partial, void* H, int B, int P, int N, int c0,
           int nsplit, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // + 1024: the ring starts at a multiple of 1024 bytes
  constexpr int smem_bytes = STAGES * STAGE_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      potts_grad_kernel_wgmma<PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, (B + TBM - 1) / TBM, nsplit);
  potts_grad_kernel_wgmma<PLANES><<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const bf16*>(xf), static_cast<const bf16*>(W),
      static_cast<const float*>(h), static_cast<float*>(grad),
      static_cast<float*>(gpart), static_cast<float*>(partial), B, P, N, c0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(partial, H, B, nsplit * (N / BN), gpart, h, grad, N,
                nsplit, stream);
}

}  // namespace

extern "C" {

// Splits over K for a block of N columns of a [P, P] W: as many as give every
// SM a block (one fits an SM), at most 8 (each split writes and re-reads a
// float32 [B, N] partial product) and at most one per 64 deep. The caller
// allocates partial [B, splits * N / 128] and, for splits > 1, gpart
// [splits, B, N].
int potts_splits(int B, int P, int N) {
  const int tiles = (N / BN) * ((B + TBM - 1) / TBM);
  int s = 132 / tiles;
  if (s < 1) s = 1;
  if (s > 8) s = 8;
  if (s > P / TBK) s = P / TBK;
  return s;
}

// xf bf16 [B, P]; W: `planes` bf16 planes [planes, P, N] whose sum is the
// column block c0 : c0 + N of the couplings (N = P, c0 = 0: all of them; 1
// plane: a bf16 W; 3: a float32 W split by ops/potts_fused.prepare; no other
// count); h float32 [N], the block's fields; grad [B, N] and H [B] (the
// block's share). Returns a cudaError_t.
int potts_energy_and_grad(const void* xf, const void* W, const void* h,
                          void* grad, void* gpart, void* partial, void* H,
                          int B, int P, int N, int c0, int planes,
                          int splits, void* stream) {
  if (P % BN != 0 || N % BN != 0 || c0 % BN != 0 || N <= 0 || c0 < 0 ||
      c0 + N > P || B <= 0 || (planes != 1 && planes != 3) || splits < 1 ||
      splits > 8 || splits > P / TBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return planes == 1 ? launch<1>(xf, W, h, grad, gpart, partial, H, B, P, N,
                                 c0, splits, s)
                     : launch<3>(xf, W, h, grad, gpart, partial, H, B, P, N,
                                 c0, splits, s);
}

}  // extern "C"
