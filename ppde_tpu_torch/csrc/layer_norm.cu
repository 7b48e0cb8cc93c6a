// The layer norm of ESM2 and the MSA Transformer, forward and backward, for
// Hopper (sm_90a): bfloat16 (or float32) in and out, float32 only in
// registers.
//
// Replaces no Pallas TPU kernel: the JAX package's layer norm
// (ppde_tpu/models/esm2.py:135, _layer_norm) is plain jnp, which XLA fuses
// with its casts. PyTorch ran it as three kernels each way: x cast to float32,
// F.layer_norm in float32, the cast back (forward); the cotangent cast up,
// layer_norm's input gradient, the cast back (backward). In units of one
// [rows, D] tensor in the stream's type that moved 10 forward and 12
// backward, where the function needs 2 (read x, write y) and 3 (read x and
// dy, write dx). This source moves those 2 and 3, plus 8 bytes a row.
//
// For x [rows, D], g, b [D] (float32) and eps:
//
//     mu = mean(x),  var = mean((x - mu)^2),  rstd = rsqrt(var + eps)
//     y = (x - mu) rstd g + b
//
// every sum and product in float32 (the variance biased, by a second pass
// over the row held in registers, not E[x^2] - mu^2), y rounded once to x's
// type: F.layer_norm's function at float32 and its one rounding point. The
// forward keeps mu and rstd (float32, 8 bytes a row) for the backward when
// the wrapper asks (under autograd): reading them back costs less than
// the two warp reductions that would recompute them. The backward, for the
// cotangent dy of y:
//
//     xh = (x - mu) rstd
//     dx = rstd (g dy - mean(g dy) - xh mean(g dy xh))
//
// rounded once to x's type; and, when autograd asks for g's and b's
// gradients, dg = sum over rows of dy xh and db = sum of dy: each block
// sums its rows in registers (a warp's lanes own the same columns in every
// row) and writes one float32 partial per column, and a second small kernel
// sums the partials in a fixed order (no atomics: the gradients repeat bit
// for bit).
//
// What bounds it on the H100: the bytes (ESM2-150M's norm at GFP, 30,336
// rows of 640 in bf16: 78 MB forward, 117 MB backward, 23 / 35 us at 3.35
// TB/s); the arithmetic is a few operations an element. Design: a warp owns
// a row, a lane its 16-byte vectors c = j * 32 + lane (neighbouring lanes on
// neighbouring addresses, every load and store 16 bytes), all of a row's
// loads issued before the first is used; the row stays in registers between
// the passes, so x is read once. The number of vectors a lane holds (NV) is
// a template argument chosen from D: 2 at 480 (bf16), 3 at 640 and 768, 5
// at 1280; up to 16 (D up to 4,096 in bf16, 2,048 in float32). Eight rows a
// block; the reductions are warp shuffles, so the sampler's path has no
// shared memory and no barrier. g and b (a few KB) stay in L1 and L2. The
// backward holds x and dy in their own type (half the registers of float32
// copies in bf16), so that more warps fit. On an H100 at 700 W this runs
// at 75% (forward) and 79% (backward) of the bound at the shape above, 6
// and 4 times faster than the composition it replaces. In float32 the
// forward runs 1.1-1.7 times faster than F.layer_norm at 480-1280; the
// backward 1.2-1.5% slower than its at 480 and 640, 14-20% faster at 768
// and 1280.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr int THREADS = WARPS * 32;
constexpr int NV_MAX = 16;

template <typename T>
struct alignas(16) Vec {
  T e[16 / sizeof(T)];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V float32 values of g (or b) at column c * V
template <int V>
__device__ __forceinline__ void load_f32(const float* p, unsigned c,
                                         float (&out)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p + c * V)[q];
    out[4 * q] = t.x;
    out[4 * q + 1] = t.y;
    out[4 * q + 2] = t.z;
    out[4 * q + 3] = t.w;
  }
}

// The row ``row`` of a [rows, D] tensor into float32 registers v (zeros past
// the row's end); every load issued before the first conversion.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* base, size_t row,
                                         unsigned D, unsigned lane,
                                         float (&v)[NV][16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const unsigned nvec = D / V;
  const Vec<T>* r = reinterpret_cast<const Vec<T>*>(base + row * D);
  Vec<T> raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const unsigned c = j * 32 + lane;
    if (c < nvec) raw[j] = r[c];
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool in = j * 32 + lane < nvec;
#pragma unroll
    for (int k = 0; k < V; ++k) v[j][k] = in ? to_f(raw[j].e[k]) : 0.0f;
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, T* __restrict__ y,
                  float2* __restrict__ stats, unsigned rows, unsigned D,
                  float eps) {
  constexpr int V = 16 / sizeof(T);
  const unsigned lane = threadIdx.x % 32;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const unsigned nvec = D / V;
  float v[NV][V];
  load_row<T, NV>(x, row, D, lane, v);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) s += v[j][k];
  const float mu = warp_sum(s) / static_cast<float>(D);
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * 32 + lane < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[j][k] - mu;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
  if (stats != nullptr && lane == 0) stats[row] = make_float2(mu, rstd);
  Vec<T>* out = reinterpret_cast<Vec<T>*>(y + row * D);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const unsigned c = j * 32 + lane;
    if (c >= nvec) continue;
    float gv[V], bv[V];
    load_f32<V>(g, c, gv);
    load_f32<V>(b, c, bv);
    Vec<T> o;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o.e[k] = from_f<T>((v[j][k] - mu) * rstd * gv[k] + bv[k]);
    out[c] = o;
  }
}

// Blocks a SM the backward asks ptxas to fit: x and dy stay in registers
// in their own type between the two passes (8 registers a vector of both),
// the rest is recomputed. Up to 3 vectors a lane, 3 blocks (80 registers);
// wider rows get what ptxas gives (on the H100 at 700 W, bf16 rows of
// 640 and 768 ran 2-4% faster at 3 blocks than at 2, 4 or 5 or uncapped;
// at 1280 the cap of 3 ran 35% slower than none).
template <int NV, bool AFFINE>
constexpr int bwd_blocks() {
  return AFFINE || NV > 3 ? 1 : 3;
}

// dx of the rows blockIdx.x * WARPS + warp + i * gridDim.x * WARPS; with
// AFFINE, the block's float32 sums of dy xh and dy per column into
// part[blockIdx.x][0 | 1][D].
template <typename T, int NV, bool AFFINE>
__global__ void __launch_bounds__(THREADS, (bwd_blocks<NV, AFFINE>()))
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ g,
                  const float2* __restrict__ stats, T* __restrict__ dx,
                  float* __restrict__ part, unsigned rows, unsigned D) {
  constexpr int V = 16 / sizeof(T);
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned nvec = D / V;
  float ag[AFFINE ? NV : 1][V], ab[AFFINE ? NV : 1][V];
  if constexpr (AFFINE) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) ag[j][k] = ab[j][k] = 0.0f;
  }
  for (size_t row = static_cast<size_t>(blockIdx.x) * WARPS + warp;
       row < rows; row += static_cast<size_t>(gridDim.x) * WARPS) {
    const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + row * D);
    const Vec<T>* dr = reinterpret_cast<const Vec<T>*>(dy + row * D);
    Vec<T> xv[NV], dv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const unsigned c = j * 32 + lane;
      if (c < nvec) {
        xv[j] = xr[c];
        dv[j] = dr[c];
      }
    }
    const float2 st = stats[row];
    const float mu = st.x, rstd = st.y;
    float a = 0.0f, c2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const unsigned c = j * 32 + lane;
      if (c >= nvec) continue;
      float gv[V];
      load_f32<V>(g, c, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f(dv[j].e[k]);
        const float xh = (to_f(xv[j].e[k]) - mu) * rstd;
        const float gd = gv[k] * d;
        a += gd;
        c2 += gd * xh;
        if constexpr (AFFINE) {
          ag[j][k] += d * xh;
          ab[j][k] += d;
        }
      }
    }
    a = warp_sum(a) / static_cast<float>(D);
    c2 = warp_sum(c2) / static_cast<float>(D);
    Vec<T>* out = reinterpret_cast<Vec<T>*>(dx + row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const unsigned c = j * 32 + lane;
      if (c >= nvec) continue;
      float gv[V];
      load_f32<V>(g, c, gv);
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (to_f(xv[j].e[k]) - mu) * rstd;
        o.e[k] = from_f<T>(rstd * (gv[k] * to_f(dv[j].e[k]) - a - xh * c2));
      }
      out[c] = o;
    }
  }
  if constexpr (AFFINE) {
    // the block's warps add their columns' sums into shared memory one
    // warp at a time (a fixed order), then the block writes its partial
    extern __shared__ float sh[];  // [2][D]
    for (int w = 0; w < WARPS; ++w) {
      if (static_cast<int>(warp) == w) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const unsigned c = j * 32 + lane;
          if (c >= nvec) continue;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const unsigned i = c * V + k;
            sh[i] = w == 0 ? ag[j][k] : sh[i] + ag[j][k];
            sh[D + i] = w == 0 ? ab[j][k] : sh[D + i] + ab[j][k];
          }
        }
      }
      __syncthreads();
    }
    float* p = part + static_cast<size_t>(blockIdx.x) * 2 * D;
    for (unsigned i = threadIdx.x; i < 2 * D; i += THREADS) p[i] = sh[i];
  }
}

// dg [D] and db [D] from the partials [G][2][D]: a thread a column, the
// blocks' partials summed in block order
__global__ void ln_affine_sum_kernel(const float* __restrict__ part,
                                     unsigned G, unsigned D,
                                     float* __restrict__ dg,
                                     float* __restrict__ db) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * D) return;
  float s = 0.0f;
  for (unsigned k = 0; k < G; ++k)
    s += part[static_cast<size_t>(k) * 2 * D + i];
  if (i < D)
    dg[i] = s;
  else
    db[i - D] = s;
}

// NV (vectors a lane holds) as a template argument
template <typename F>
int by_nv(int nv, F f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 13: return f(std::integral_constant<int, 13>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 15: return f(std::integral_constant<int, 15>{});
    default: return f(std::integral_constant<int, 16>{});
  }
}

// the vectors a lane holds for a row of D elements of a dtype (0 = float32,
// 1 = bfloat16), or 0 where the kernels do not take D
int vectors_a_lane(int D, int dtype) {
  const int V = dtype == 0 ? 4 : 8;
  if (D < V || D % V != 0) return 0;
  const int nv = (D / V + 31) / 32;
  return nv <= NV_MAX ? nv : 0;
}

template <typename T, int NV>
int fwd(const void* x, const float* g, const float* b, void* y,
        float2* stats, unsigned rows, unsigned D, float eps, cudaStream_t s) {
  const unsigned blocks = (rows + WARPS - 1) / WARPS;
  ln_fwd_kernel<T, NV><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), stats, rows, D,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int bwd(const void* x, const void* dy, const float* g, const float2* stats,
        void* dx, float* part, float* dg, float* db, unsigned rows,
        unsigned D, unsigned G, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (part == nullptr) {
    const unsigned blocks = (rows + WARPS - 1) / WARPS;
    ln_bwd_kernel<T, NV, false><<<blocks, THREADS, 0, s>>>(
        xt, dyt, g, stats, dxt, nullptr, rows, D);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t shmem = 2 * D * sizeof(float);
  ln_bwd_kernel<T, NV, true><<<G, THREADS, shmem, s>>>(xt, dyt, g, stats,
                                                       dxt, part, rows, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ln_affine_sum_kernel<<<(2 * D + 255) / 256, 256, 0, s>>>(part, G, D, dg,
                                                           db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y [rows, D] in x's type from x [rows, D] and float32 g, b [D]; mu and
// rstd into stats [rows][2] (float32) unless stats is null. dtype: 0 =
// float32, 1 = bfloat16 (x and y). Returns a cudaError_t.
int layer_norm_fwd(const void* x, const void* g, const void* b, void* y,
                   void* stats, int rows, int D, float eps, int dtype,
                   void* stream) {
  const int nv = vectors_a_lane(D, dtype);
  if (rows < 1 || nv == 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float2* st = static_cast<float2*>(stats);
  return by_nv(nv, [&](auto NV) {
    constexpr int N = decltype(NV)::value;
    return dtype == 0
               ? fwd<float, N>(x, gf, bf, y, st, rows, D, eps, s)
               : fwd<__nv_bfloat16, N>(x, gf, bf, y, st, rows, D, eps, s);
  });
}

// dx [rows, D] in x's type from x, the cotangent dy [rows, D], g and the
// forward's stats; with part non-null ([G][2][D] float32 scratch), also dg
// and db [D] (float32), from G blocks. Returns a cudaError_t.
int layer_norm_bwd(const void* x, const void* dy, const void* g,
                   const void* stats, void* dx, void* part, void* dg,
                   void* db, int rows, int D, int G, int dtype,
                   void* stream) {
  const int nv = vectors_a_lane(D, dtype);
  if (rows < 1 || nv == 0 || (dtype != 0 && dtype != 1) ||
      (part != nullptr && (G < 1 || dg == nullptr || db == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float2* st = static_cast<const float2*>(stats);
  float* pf = static_cast<float*>(part);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  return by_nv(nv, [&](auto NV) {
    constexpr int N = decltype(NV)::value;
    return dtype == 0
               ? bwd<float, N>(x, dy, gf, st, dx, pf, dgf, dbf, rows, D, G, s)
               : bwd<__nv_bfloat16, N>(x, dy, gf, st, dx, pf, dgf, dbf, rows,
                                       D, G, s);
  });
}

}  // extern "C"
