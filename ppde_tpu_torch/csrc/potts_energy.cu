// Kernel A: fused Potts energy + input gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ppde_tpu/ops/potts_pallas.py:energy_and_grad
// (_kernel). For flattened one-hots xf [B, P], symmetric couplings W [P, P]
// and fields h [P] (P a multiple of 128; xf, W and h share one type, float32
// or bfloat16; every sum is float32):
//
//     grad = xf @ W + h                                   [B, P]  float32
//     H    = sum_cols xf * (0.5 * (xf @ W) + h)           [B]     float32
//
// What bounds it on the H100: reading W (P*P elements, 47 MB in bf16 at GFP's
// P = 4864) at small B, the 2*B*P*P multiply-adds at large B.
//
// Design: a GEMM with a fused epilogue. Each block owns a BM x BN output
// tile and walks the whole K = P dimension through shared-memory tiles, so
// the TPU kernel's sequential-grid accumulator (acc_ref, carried from one
// 128-wide column tile to the next) has no counterpart: blocks run in
// parallel and in no order. Instead each block writes its tile's gradient
// and ONE partial energy per row, sum_{cols in tile} xf * (0.5*acc + h), into
// a [B, P/BN] scratch; a second small kernel adds the partials of each row in
// a fixed order. No atomics, so H repeats bit for bit from run to run.
// bf16 products run on the tensor cores (mma.sync m16n8k16, float32
// accumulate); float32 products are FMAs from shared memory. A wgmma/TMA
// pipeline is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;    // rows of xf per block
constexpr int BN = 128;   // columns of W per block (TILE_N)
constexpr int BK = 32;    // depth of one shared-memory stage
constexpr int TM = 4;     // rows per thread   (BM / 16)
constexpr int TN = 8;     // columns per thread (BN / 16)
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
potts_grad_kernel(const T* __restrict__ xf, const T* __restrict__ W,
                  const T* __restrict__ h, float* __restrict__ grad,
                  float* __restrict__ partial, int B, int P) {
  __shared__ float As[BK][BM + 4];  // A tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < P; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK, r = row0 + m;
      As[k][m] = r < B ? to_f(xf[(size_t)r * P + k0 + k]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      Bs[k][n] = to_f(W[(size_t)(k0 + k) * P + col0 + n]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: gradient tile + one partial energy per row of the tile
  const int n_tiles = P / BN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    float s = 0.f;
    if (r < B) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + tx + 16 * j;
        const float hc = to_f(h[c]);
        grad[(size_t)r * P + c] = acc[i][j] + hc;
        s += to_f(xf[(size_t)r * P + c]) * (0.5f * acc[i][j] + hc);
      }
    }
    // the 16 threads of one row are 16 consecutive lanes of one warp:
    // a fixed xor tree adds their sums
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off, 16);
    if (tx == 0 && r < B) partial[(size_t)r * n_tiles + blockIdx.x] = s;
  }
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

constexpr int BKM = 64;       // depth of one shared-memory stage (mma)
constexpr int KP = BKM + 8;   // bf16 row stride of the shared tiles

// bf16 version of potts_grad_kernel on the tensor cores: the same tile,
// epilogue and partials. 8 warps as 2 (rows) x 4 (columns), each owning a
// 32 x 32 block of the 64 x 128 tile. The next stage's tiles are loaded
// into registers while the current one is multiplied.
__global__ void __launch_bounds__(THREADS)
potts_grad_kernel_mma(const __nv_bfloat16* __restrict__ xf,
                      const __nv_bfloat16* __restrict__ W,
                      const __nv_bfloat16* __restrict__ h,
                      float* __restrict__ grad, float* __restrict__ partial,
                      int B, int P) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][KP];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][KP];  // [n][k] (transposed)
  __shared__ float red[4][BM];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3, wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  constexpr int NA = BM * BKM / 8 / THREADS;  // 16-byte loads of A
  constexpr int NW = BKM * BN / 8 / THREADS;  // 16-byte loads of W

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra[NA], rw[NW];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < NA; ++j) {  // A: 8 bf16 along k
      const int i = tid + j * THREADS, m = i / (BKM / 8);
      const int kseg = (i % (BKM / 8)) * 8, r = row0 + m;
      ra[j] = r < B ? *reinterpret_cast<const uint4*>(xf + (size_t)r * P +
                                                       k0 + kseg)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {  // W: 8 bf16 along n; lanes along k
      const int i = tid + j * THREADS, k = i % BKM, nseg = (i / BKM) * 8;
      rw[j] = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + k) * P +
                                              col0 + nseg);
    }
  };
  load(0);
  for (int k0 = 0; k0 < P; k0 += BKM) {
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int i = tid + j * THREADS;
      *reinterpret_cast<uint4*>(&As[i / (BKM / 8)][(i % (BKM / 8)) * 8]) =
          ra[j];
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      // consecutive lanes store consecutive k of one Bs row: no conflicts
      const int i = tid + j * THREADS, k = i % BKM, nseg = (i / BKM) * 8;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&rw[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q) Bs[nseg + q][k] = e[q];
    }
    __syncthreads();
    if (k0 + BKM < P) load(k0 + BKM);
#pragma unroll
    for (int kk = 0; kk < BKM; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tig * 2]);
        a[mi][1] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tig * 2]);
        a[mi][2] =
            *reinterpret_cast<const uint32_t*>(&As[r][kk + tig * 2 + 8]);
        a[mi][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tig * 2]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tig * 2 + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: gradient + per-row partial energy; rows of the fragment are
  // shared by the 4 lanes of a group (xor 1, 2), then by the 4 column warps
  // (added in order through shared memory)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm * 32 + mi * 16 + g + half * 8, r = row0 + rl;
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col0 + wn * 32 + ni * 8 + tig * 2 + j;
          const float v = acc[mi][ni][half * 2 + j];
          const float hc = __bfloat162float(h[c]);
          if (r < B) {
            grad[(size_t)r * P + c] = v + hc;
            s += __bfloat162float(xf[(size_t)r * P + c]) * (0.5f * v + hc);
          }
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tig == 0) red[wn][rl] = s;
    }
  __syncthreads();
  if (tid < BM && row0 + tid < B)
    partial[(size_t)(row0 + tid) * (P / BN) + blockIdx.x] =
        ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
}

// H[b] = sum of the row's partials, in tile order
__global__ void potts_energy_reduce(const float* __restrict__ partial,
                                    float* __restrict__ H, int B,
                                    int n_tiles) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)b * n_tiles + t];
  H[b] = s;
}

template <typename T>
int launch(const void* xf, const void* W, const void* h, void* grad,
           void* partial, void* H, int B, int P, cudaStream_t stream) {
  const dim3 grid(P / BN, (B + BM - 1) / BM);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    potts_grad_kernel_mma<<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(xf), static_cast<const T*>(W),
        static_cast<const T*>(h), static_cast<float*>(grad),
        static_cast<float*>(partial), B, P);
  else
    potts_grad_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(xf), static_cast<const T*>(W),
        static_cast<const T*>(h), static_cast<float*>(grad),
        static_cast<float*>(partial), B, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  potts_energy_reduce<<<(B + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(H), B, P / BN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile width of the partial-energy scratch: partial is [B, P / tile_n].
int potts_tile_n() { return BN; }

// dtype: 0 = float32, 1 = bfloat16 (xf, W and h). Returns a cudaError_t.
int potts_energy_and_grad(const void* xf, const void* W, const void* h,
                          void* grad, void* partial, void* H, int B, int P,
                          int dtype, void* stream) {
  if (P % BN != 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xf, W, h, grad, partial, H, B, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xf, W, h, grad, partial, H, B, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
