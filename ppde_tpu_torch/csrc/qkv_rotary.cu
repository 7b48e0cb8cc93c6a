// The glue between ESM2's q, k, v projections and kernel C: the q scale,
// the rotary position embedding and the head-major layout in one pass,
// forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: the JAX package writes this glue in plain
// jnp (ppde_tpu/models/esm2.py: _attention's proj and the scale, _rotary),
// which XLA fuses into its neighbours. PyTorch runs it op by op: three
// head-major copies, the q scale and rotary's chunk, neg, cat, four
// products and two sums for q and for k, 14 kernels a layer in each
// direction that move about 4.7 times the bytes the function needs. This
// source exists to move them once.
//
// For the projections' outputs q, k, v [B*T, H*hd] (H the rank's heads) and
// the rotary tables cos, sin [T, hd] (models/esm2.py:_rotary_tables), the
// forward writes, each [B, H, T, hd] (kernel C's [B*H, T, hd]):
//
//     q' = rot(rnd(q s)),  k' = rot(k),  v' = v
//     rot(x)[i] = rnd(rnd(x[i] cos[t, i]) + rnd(r(x)[i] sin[t, i]))
//     r(x)[i] = -x[i + hd/2] for i < hd/2, x[i - hd/2] from hd/2 on
//
// (rnd: the rounding of a float32 product or sum to the tensors' type), and
// the backward, for the cotangents gq, gk, gv of q', k', v' [B, H, T, hd],
// writes dq, dk, dv [B*T, H*hd], the layout the projections' backward reads:
//
//     dq = rnd(u(gq) s),  dk = u(gk),  dv = gv
//     u(g)[i] = rnd(rnd(g[i] cos[t, i]) + r'(g)[i])
//     r'(g)[i] = rnd(g[i + hd/2] sin[t, i + hd/2]) for i < hd/2,
//                -rnd(g[i - hd/2] sin[t, i - hd/2]) from hd/2 on
//
// These are the rounding points of the PyTorch composition the kernels
// replace (ops/rotary_fused.py:qkv_rotary_plain) and of autograd through it,
// so the outputs equal that composition's bit for bit, in bfloat16 and in
// float32: every product and sum is an __fmul_rn / __fadd_rn, which nvcc
// does not contract into an FMA, and the tables are the composition's own.
//
// What bounds them on the H100: the bytes, each input read once and each
// output written once, 6 B T H hd elements a direction (ESM2-150M's call at
// GFP, B = 128, T = 237, H = 20, hd = 32 in bf16: 233 MB, 69.5 us at 3.35
// TB/s); the arithmetic is a few operations an element. Design: a thread
// owns one 16-byte vector of an output, taken in the output's order, so a
// warp stores 512 contiguous bytes. It loads its vector of the input where
// that lies in the other layout: one head's row of one position is hd
// contiguous elements, 16 to 256 bytes, whose 32-byte sectors the
// neighbouring threads of the warp load whole. The vector of pair partners
// (i +- hd/2) lies in the same row, so its load hits L1, and the rotation
// is done in registers; the tables (15 KB at GFP) stay in L1 and L2. No
// shared memory, no barrier. hd is a template argument (a multiple of 8 up
// to 64), so the partners' positions are known at compile time; where hd/2
// is not a whole number of vectors (bf16 at hd 8, 24, 40, 56) the partners
// are loaded one element at a time. A thread does its vector of all three
// tensors (one launch a direction), so that its three loads are in flight
// at once and the index arithmetic and the tables serve q and k. On an H100
// at 700 W this runs at 83% of the bound at the shape above, each way. (A
// first cut that took its tensor by blockIdx.y from an array among the
// kernel's parameters ran at a third of it: indexing the array at run time
// made ptxas copy the parameters to a stack frame in every thread.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct alignas(16) Vec {
  T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p) {
  return *reinterpret_cast<const Vec<T>*>(p);
}

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

// a float32 result rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q;  // q, k, v (forward) or gq, gk, gv (backward)
  const void* k;
  const void* v;
  void* oq;
  void* ok;
  void* ov;
  const void* cos;  // [T, hd]
  const void* sin;
  unsigned T, H;
  float scale;
};

// The rotation (forward) or its transpose (backward) of one vector x at
// column c * V of a head's row, from the partners' vector p and the tables'
// vectors; with q's scale where SCALED.
template <typename T, int HD, bool BWD, bool SCALED>
__device__ __forceinline__ Vec<T> rotate(const Vec<T>& x, const Vec<T>& p,
                                         const Vec<T>& cs, const Vec<T>& sn,
                                         unsigned c, float scale) {
  constexpr unsigned V = 16 / sizeof(T);
  Vec<T> y;
#pragma unroll
  for (unsigned j = 0; j < V; ++j) {
    const bool lo = c * V + j < HD / 2;
    float xv = to_f(x.e[j]), pv = to_f(p.e[j]);
    if (!BWD && SCALED) {
      xv = rnd<T>(__fmul_rn(xv, scale));
      pv = rnd<T>(__fmul_rn(pv, scale));
    }
    const float u = rnd<T>(__fmul_rn(xv, to_f(cs.e[j])));
    const float w = rnd<T>(__fmul_rn(pv, to_f(sn.e[j])));
    if (!BWD) {
      y.e[j] = from_f<T>(__fadd_rn(u, lo ? -w : w));
    } else {
      float g = __fadd_rn(u, lo ? w : -w);
      if (SCALED) g = __fmul_rn(rnd<T>(g), scale);
      y.e[j] = from_f<T>(g);
    }
  }
  return y;
}

// The partners' vector of the vector at column c * V of the head's row
// ``row`` (the elements at i + hd/2 for i < hd/2, i - hd/2 after).
template <typename T, int HD>
__device__ __forceinline__ Vec<T> partners(const T* row, unsigned c) {
  constexpr unsigned V = 16 / sizeof(T), HALF = HD / 2;
  if constexpr (HALF % V == 0) {
    return load(row + (c * V < HALF ? c * V + HALF : c * V - HALF));
  } else {
    Vec<T> p;
#pragma unroll
    for (unsigned j = 0; j < V; ++j) {
      const unsigned i = c * V + j;
      p.e[j] = row[i < HALF ? i + HALF : i - HALF];
    }
    return p;
  }
}

// Output vector o of each of the three tensors. Forward: o runs over
// [B][H][T][hd / V], the inputs are [B][T][H][hd]; backward the other way
// round. The three tensors' loads are issued before any is used.
template <typename T, int HD, bool BWD>
__device__ __forceinline__ void one_vector(const Args& a, unsigned n) {
  constexpr unsigned V = 16 / sizeof(T);
  constexpr unsigned CPR = HD / V;  // vectors in a head's row
  const unsigned o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n) return;
  const unsigned c = o % CPR;
  unsigned r = o / CPR, t, h, b;
  size_t row;  // the inputs' row of (b, t, h), in elements
  if (!BWD) {
    t = r % a.T;
    r /= a.T;
    h = r % a.H;
    b = r / a.H;
    row = (static_cast<size_t>(b * a.T + t) * a.H + h) * HD;
  } else {
    h = r % a.H;
    r /= a.H;
    t = r % a.T;
    b = r / a.T;
    row = (static_cast<size_t>(b * a.H + h) * a.T + t) * HD;
  }
  const T* q = static_cast<const T*>(a.q) + row;
  const T* k = static_cast<const T*>(a.k) + row;
  const Vec<T> xq = load(q + c * V), xk = load(k + c * V);
  const Vec<T> xv = load(static_cast<const T*>(a.v) + row + c * V);
  const Vec<T> pq = partners<T, HD>(q, c), pk = partners<T, HD>(k, c);
  // sin where the composition reads it: at the output's position forward,
  // at the partner's backward
  const T* cos_row = static_cast<const T*>(a.cos) + t * HD;
  const T* sin_row = static_cast<const T*>(a.sin) + t * HD;
  const Vec<T> cs = load(cos_row + c * V);
  const Vec<T> sn = BWD ? partners<T, HD>(sin_row, c) : load(sin_row + c * V);
  const size_t out = static_cast<size_t>(o) * V;
  *reinterpret_cast<Vec<T>*>(static_cast<T*>(a.oq) + out) =
      rotate<T, HD, BWD, true>(xq, pq, cs, sn, c, a.scale);
  *reinterpret_cast<Vec<T>*>(static_cast<T*>(a.ok) + out) =
      rotate<T, HD, BWD, false>(xk, pk, cs, sn, c, a.scale);
  *reinterpret_cast<Vec<T>*>(static_cast<T*>(a.ov) + out) = xv;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    qkv_rotary_fwd_kernel(Args a, unsigned n) {
  one_vector<T, HD, false>(a, n);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    qkv_rotary_bwd_kernel(Args a, unsigned n) {
  one_vector<T, HD, true>(a, n);
}

template <typename T, int HD, bool BWD>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr unsigned long long V = 16 / sizeof(T);
  const unsigned long long n = static_cast<unsigned long long>(B) * a.T *
                               a.H * (HD / V);
  if (n >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const unsigned n32 = static_cast<unsigned>(n);
  if (BWD)
    qkv_rotary_bwd_kernel<T, HD><<<blocks, THREADS, 0, s>>>(a, n32);
  else
    qkv_rotary_fwd_kernel<T, HD><<<blocks, THREADS, 0, s>>>(a, n32);
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

template <bool BWD>
int run(const void* x0, const void* x1, const void* x2, const void* cos,
        const void* sin, void* y0, void* y1, void* y2, int B, int T, int H,
        int hd, float scale, int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1 || hd < 8 || hd > 64 || hd % 8 != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x0, x1, x2, y0, y1, y2, cos, sin, static_cast<unsigned>(T),
               static_cast<unsigned>(H), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_hd(hd, [&](auto HD) {
    constexpr int D = decltype(HD)::value;
    return dtype == 0 ? launch<float, D, BWD>(a, B, s)
                      : launch<__nv_bfloat16, D, BWD>(a, B, s);
  });
}

}  // namespace

extern "C" {

// q', k', v [B, H, T, hd] from the projections' outputs q, k, v [B*T, H*hd]
// and the tables cos, sin [T, hd]; scale multiplies q. dtype: 0 = float32,
// 1 = bfloat16 (every tensor). Returns a cudaError_t.
int qkv_rotary_fwd(const void* q, const void* k, const void* v,
                   const void* cos, const void* sin, void* oq, void* ok,
                   void* ov, int B, int T, int H, int hd, float scale,
                   int dtype, void* stream) {
  return run<false>(q, k, v, cos, sin, oq, ok, ov, B, T, H, hd, scale, dtype,
                    stream);
}

// dq, dk, dv [B*T, H*hd] from the cotangents gq, gk, gv [B, H, T, hd] of
// qkv_rotary_fwd's outputs. Arguments as above. Returns a cudaError_t.
int qkv_rotary_bwd(const void* gq, const void* gk, const void* gv,
                   const void* cos, const void* sin, void* dq, void* dk,
                   void* dv, int B, int T, int H, int hd, float scale,
                   int dtype, void* stream) {
  return run<true>(gq, gk, gv, cos, sin, dq, dk, dv, B, T, H, hd, scale,
                   dtype, stream);
}

}  // extern "C"
