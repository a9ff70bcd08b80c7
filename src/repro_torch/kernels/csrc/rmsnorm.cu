// Fused RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm_2d
// (body _rmsnorm_kernel) and computes the same function per row of x [N, D]:
// the fp32 mean of squares, x * rsqrt(var + eps) rounded to x's dtype, then
// * w in fp32, rounded to x's dtype (the JAX model's bf16 rounding order).
// x and w are each fp32 or bf16.
//
// What bounds it on this card: bytes. It reads x and w once and writes the
// output once, (2 N D + D) * sizeof bytes, with about 4 operations an element,
// far below the card's operations-per-byte balance.
//
// Design:
// - At decode row counts (N at most the SMs), one CTA a row and one access
//   a thread (rmsnorm_row_kernel): an access is one 16-byte vector, held in
//   registers as loaded; the sum of squares is a warp-shuffle reduction,
//   then one step across warps through shared memory and a second shuffle.
//   Nothing else stands between the loads and the stores, so the kernel
//   costs the launch and one round trip to memory. On an H100 (chip_ab.py)
//   it came within 0.01-0.07 us of the device time of the Triton kernel it
//   replaced at 8 rows of 768, 1536 and 4096, where the persistent kernel
//   below took about 0.2 us more.
// - At prefill row counts, a persistent grid (rmsnorm_kernel): a CTA of NT
//   threads (a multiple of 32, from D at launch) normalises one row at a
//   time. Thread t holds accesses t and t + NT of the row in registers as
//   loaded, so x is read once and the output written once, with no second
//   pass over device memory; the raw vectors are widened to fp32 where they
//   are used. At most SMs x the CTAs an SM holds, sized so that every CTA
//   walks the same number of rows to within one; each CTA loops over rows
//   gridDim.x apart, and issues the loads of its next row before it reduces
//   the current one, so two rows' loads are in flight a CTA: enough bytes
//   moving to near the byte bound. Its sum of squares: a warp-shuffle
//   reduction, then one step across warps through shared memory,
//   double-buffered by row parity, so a row costs one __syncthreads.
// - The two kernels sum a row's squares in different orders, so a row's
//   output may differ in its last bit between a call of at most SMs rows
//   and a longer one (as a GEMM's may between two row counts).
// - w is read once per CTA, by 16-byte loads right after the first row's
//   (the two round trips overlap): the persistent kernel widens it to fp32
//   registers at once (every row a CTA walks uses the same columns), the
//   row kernel where it is used (its reduction then waits on x alone).
// - A row that is not a whole number of 16-byte vectors, or an x or a w that
//   is not 16-byte aligned, runs the same kernels with one-element accesses.
// - A row longer than a CTA holds (more than 1024 vectors: 8192 bf16 or
//   4096 fp32 elements) runs the persistent kernel, which walks it in
//   chunks: the first stays in registers, the rest are read a second time
//   for the output, their w with them.
//
// Backward (rmsnorm_bwd, new: the JAX package differentiates its jnp
// rmsnorm, models/layers.py:19, and the Pallas kernel has no VJP). Given x,
// w and dy it recomputes each row's r = rsqrt(mean(x^2) + eps) from x (the
// forward keeps nothing) and writes, in the plain version's autograd
// rounding order (kernels/ref.py rmsnorm_ref):
//   g  = dy * w rounded to x's dtype, t = x * r (fp32),
//   dx = r * (g - t * mean(g * t)), rounded to x's dtype;
//   dw = sum over rows of dy * y^, y^ = x * r rounded to x's dtype, summed
//        in fp32 and rounded to w's dtype.
// What bounds it: bytes (x and dy read, dx written; dw is one row). A
// persistent grid of CTAs walks the rows (rmsnorm_bwd_kernel); a thread
// holds its columns' w and its dw partial sums in registers, one reduction
// through shared memory gives a row's sum x^2 and sum g x together. Each
// CTA writes its dw partial row to an fp32 scratch [CTAs, D] and a second
// launch (rmsnorm_dw_kernel) sums the rows of it in order: no atomics, so
// two calls give the same bits. D up to 8192.
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

// A CTA's threads at most. The launch bounds name one CTA an SM as the
// least, which leaves ptxas the registers it needs (it spilled a few to stay
// under 64 when left to choose).
constexpr int MAX_THREADS = 512;
// Accesses a thread holds: 2 vectors (a CTA of 256 threads a 4096-wide bf16
// row), or 8 elements. On an H100, 2 vectors a thread on the persistent grid
// took less device time at [8192, 4096] than 1 or 4, or than a CTA a row.
constexpr int V_VEC = 2;
constexpr int V_ONE = 8;

// One access: E elements of T, kept as loaded (Raw), widened to fp32 at use;
// E fp32 values rounded to T and stored. 16 bytes when E * sizeof(T) == 16,
// else one element.
template <typename T, int E> struct Access;
template <typename T> struct Access<T, 1> {
  using Raw = T;
  __device__ static __forceinline__ Raw load(const T* p) { return *p; }
  __device__ static __forceinline__ Raw zero() { return from_f32<T>(0.f); }
  __device__ static __forceinline__ void unpack(const Raw& r, float* f) { f[0] = to_f32(r); }
  __device__ static __forceinline__ void store(T* p, const float* f) { p[0] = from_f32<T>(f[0]); }
};
template <typename T> struct Access16 {
  using Raw = uint4;
  __device__ static __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static __forceinline__ void unpack(const Raw& r, float* f) { Vec<T>::unpack(r, f); }
};
template <> struct Access<float, 4> : Access16<float> {
  __device__ static __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Access<__nv_bfloat16, 8> : Access16<__nv_bfloat16> {
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// E elements of w (at w + a * E) as loaded, widened to fp32 by unpack: 16-
// or 8-byte loads where E elements make whole ones (the 16-byte path, where
// w is 16-byte aligned), else one element at a time.
template <typename TW, int E> struct WLoad {
  static constexpr int B = E * (int)sizeof(TW);
  static constexpr bool V16 = B % 16 == 0, V8 = B == 8 && sizeof(TW) == 2;
  static constexpr int R = V16 ? B / 16 : (V8 ? 1 : E);
  using Raw = std::conditional_t<V16, uint4, std::conditional_t<V8, uint2, TW>>;
  Raw r[R];

  __device__ __forceinline__ void load(const TW* p) {
#pragma unroll
    for (int q = 0; q < R; ++q) r[q] = reinterpret_cast<const Raw*>(p)[q];
  }
  __device__ __forceinline__ void unpack(float* f) const {
    if constexpr (V16) {
#pragma unroll
      for (int q = 0; q < R; ++q) Vec<TW>::unpack(r[q], f + q * Vec<TW>::N);
    } else if constexpr (V8) {
      f[0] = __uint_as_float(r[0].x << 16);
      f[1] = __uint_as_float(r[0].x & 0xffff0000u);
      f[2] = __uint_as_float(r[0].y << 16);
      f[3] = __uint_as_float(r[0].y & 0xffff0000u);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) f[u] = to_f32(r[u]);
    }
  }
};

template <typename TW, int E>
__device__ __forceinline__ void load_w(const TW* p, float* f) {
  WLoad<TW, E> v;
  v.load(p);
  v.unpack(f);
}

// x * r rounded to x's dtype, then times w in fp32 (the output's rounding is
// the store's)
template <typename TX>
__device__ __forceinline__ float norm_times_w(float x, float r, float w) {
  return to_f32(from_f32<TX>(x * r)) * w;
}

// One CTA a row, one access a thread (blockDim.x >= the row's accesses,
// at most 1024).
template <typename TX, typename TW, int E>
__global__ void __launch_bounds__(1024)
rmsnorm_row_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ o,
                   int D, float eps) {
  using A = Access<TX, E>;
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const bool on = tid < D / E;
  const long long at = (long long)blockIdx.x * D + tid * E;
  const typename A::Raw raw = on ? A::load(x + at) : A::zero();
  WLoad<TW, E> wv;  // widened where it is used, so the reduction waits on x alone
  if (on) wv.load(w + tid * E);
  float f[E];
  A::unpack(raw, f);
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < E; ++u) ss = fmaf(f[u], f[u], ss);
  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  const float total = warp_sum((tid & 31) < (blockDim.x >> 5) ? red[tid & 31] : 0.f);
  const float r = rsqrtf(total / (float)D + eps);
  if (on) {
    float wr[E];
    wv.unpack(wr);
#pragma unroll
    for (int u = 0; u < E; ++u) f[u] = norm_times_w<TX>(f[u], r, wr[u]);
    A::store(o + at, f);
  }
}

template <typename TX, typename TW, int E, int V>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ o, int N,
               int D, float eps) {
  using A = Access<TX, E>;
  __shared__ float red[2][32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int n_acc = D / E;  // accesses a row
  const int chunk = nt * V;  // accesses the CTA holds at once

  typename A::Raw cur[V], nxt[V];
  auto load_row = [&](typename A::Raw (&dst)[V], long long row) {
    const TX* xr = x + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = tid + i * nt;
      dst[i] = a < n_acc ? A::load(xr + a * E) : A::zero();
    }
  };
  long long row = blockIdx.x;
  load_row(cur, row);
  // this thread's columns of w, in the same block as the first row's loads
  // so that both round trips overlap
  float wr[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int a = tid + i * nt;
    if (a < n_acc) {
      load_w<TW, E>(w + a * E, wr[i]);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) wr[i][u] = 0.f;
    }
  }

  for (int parity = 0; row < N; row += gridDim.x, parity ^= 1) {
    if (row + gridDim.x < N) load_row(nxt, row + gridDim.x);  // in flight meanwhile
    const TX* xr = x + row * D;
    TX* orow = o + row * D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float f[E];
      A::unpack(cur[i], f);
#pragma unroll
      for (int u = 0; u < E; ++u) ss = fmaf(f[u], f[u], ss);
    }
    for (int c0 = chunk; c0 < n_acc; c0 += chunk) {  // a row longer than a chunk
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int a = c0 + tid + i * nt;
        if (a < n_acc) {
          float f[E];
          A::unpack(A::load(xr + a * E), f);
#pragma unroll
          for (int u = 0; u < E; ++u) ss = fmaf(f[u], f[u], ss);
        }
      }
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) red[parity][tid >> 5] = ss;
    __syncthreads();
    float total = 0.f;
    for (int k = 0; k < nwarps; ++k) total += red[parity][k];
    const float r = rsqrtf(total / (float)D + eps);

#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = tid + i * nt;
      if (a < n_acc) {
        float f[E];
        A::unpack(cur[i], f);
#pragma unroll
        for (int u = 0; u < E; ++u) f[u] = norm_times_w<TX>(f[u], r, wr[i][u]);
        A::store(orow + a * E, f);
      }
    }
    for (int c0 = chunk; c0 < n_acc; c0 += chunk) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int a = c0 + tid + i * nt;
        if (a < n_acc) {
          float f[E], wf[E];
          A::unpack(A::load(xr + a * E), f);
          load_w<TW, E>(w + a * E, wf);
#pragma unroll
          for (int u = 0; u < E; ++u) f[u] = norm_times_w<TX>(f[u], r, wf[u]);
          A::store(orow + a * E, f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

template <typename TX, typename TW, int E, int V>
int launch(const void* x, const void* w, void* o, int N, int D, float eps,
           cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TW* wt = static_cast<const TW*>(w);
  TX* ot = static_cast<TX*>(o);
  const int n_acc = D / E;
  // per device, asked once: the SMs, and the CTAs an SM holds of the
  // persistent kernel at each block size
  static int n_sm[32] = {};
  static int per_sm[32][MAX_THREADS / 32 + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!n_sm[dev]) {
    err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (N <= n_sm[dev] && n_acc <= 1024) {
    rmsnorm_row_kernel<TX, TW, E><<<N, (n_acc + 31) / 32 * 32, 0, stream>>>(xt, wt, ot, D, eps);
    return (int)cudaGetLastError();
  }
  auto kernel = rmsnorm_kernel<TX, TW, E, V>;
  int nt = ((n_acc + V - 1) / V + 31) / 32 * 32;
  nt = nt < 32 ? 32 : (nt > MAX_THREADS ? MAX_THREADS : nt);
  int& occ = per_sm[dev][nt / 32];
  if (!occ) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, nt, 0);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) occ = 1;
  }
  // as many CTAs as the card holds at once, each the same number of rows (to
  // within one), so that no SM is left with a last row alone
  const long long most = (long long)n_sm[dev] * occ;
  const long long per = (N + most - 1) / most;
  const int grid = (int)((N + per - 1) / per);
  kernel<<<grid, nt, 0, stream>>>(xt, wt, ot, N, D, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_x(const void* x, const void* w, void* o, int N, int D, float eps,
             cudaStream_t s) {
  constexpr int VE = Vec<TX>::N;  // elements of a 16-byte vector
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      D % VE == 0)
    return launch<TX, TW, VE, V_VEC>(x, w, o, N, D, eps, s);
  return launch<TX, TW, 1, V_ONE>(x, w, o, N, D, eps, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int BWD_THREADS_MAX = 256;
constexpr int BWD_ELEMS = 32;  // elements of a row a thread holds at most

// One CTA walks rows blockIdx.x, + gridDim.x, ...; thread t holds accesses
// t, t + NT, ... (V of them) of E elements. partial: [gridDim.x, D] fp32.
template <typename TX, typename TW, int E>
__global__ void __launch_bounds__(BWD_THREADS_MAX, 1)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ dy,
                   TX* __restrict__ dx, float* __restrict__ partial, int N, int D, float eps) {
  using A = Access<TX, E>;
  constexpr int V = BWD_ELEMS / E;
  __shared__ float2 red[32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int n_acc = D / E;
  float wr[V][E], dw[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int a = tid + i * nt;
#pragma unroll
    for (int u = 0; u < E; ++u) {
      wr[i][u] = a < n_acc ? to_f32(w[a * E + u]) : 0.f;
      dw[i][u] = 0.f;
    }
  }
  for (long long row = blockIdx.x; row < N; row += gridDim.x) {
    const TX* xr = x + row * D;
    const TX* gr = dy + row * D;
    float xf[V][E], gf[V][E];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = tid + i * nt;
      const bool on = a < n_acc;
      A::unpack(on ? A::load(xr + a * E) : A::zero(), xf[i]);
      A::unpack(on ? A::load(gr + a * E) : A::zero(), gf[i]);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        // g = dy * w rounded to x's dtype, as the plain version's autograd
        const float g = to_f32(from_f32<TX>(gf[i][u] * wr[i][u]));
        ss = fmaf(xf[i][u], xf[i][u], ss);
        gx = fmaf(g, xf[i][u], gx);
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    __syncthreads();  // the previous row's reads of red are done
    if ((tid & 31) == 0) red[tid >> 5] = make_float2(ss, gx);
    __syncthreads();
    float tss = 0.f, tgx = 0.f;
    for (int k = 0; k < nwarps; ++k) {
      tss += red[k].x;
      tgx += red[k].y;
    }
    const float r = rsqrtf(tss / (float)D + eps);
    const float c = r * tgx / (float)D;  // mean(g * t), t = x * r
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = tid + i * nt;
      if (a >= n_acc) continue;
      float o[E];
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float t = xf[i][u] * r;
        const float g = to_f32(from_f32<TX>(gf[i][u] * wr[i][u]));
        o[u] = r * (g - t * c);
        dw[i][u] = fmaf(gf[i][u], to_f32(from_f32<TX>(t)), dw[i][u]);
      }
      A::store(dx + row * D + a * E, o);
    }
  }
  float* pr = partial + (long long)blockIdx.x * D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int a = tid + i * nt;
    if (a >= n_acc) continue;
#pragma unroll
    for (int u = 0; u < E; ++u) pr[a * E + u] = dw[i][u];
  }
}

// dw[c] = sum over the P partial rows of partial[., c], in row order.
template <typename TW>
__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial, TW* __restrict__ dw, int P,
                                  int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += partial[(long long)p * D + c];
  dw[c] = from_f32<TW>(acc);
}

template <typename TX, typename TW, int E>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, void* partial,
               int N, int D, int ctas, float eps, cudaStream_t stream) {
  constexpr int V = BWD_ELEMS / E;
  const int n_acc = D / E;
  int nt = ((n_acc + V - 1) / V + 31) / 32 * 32;
  if (nt > BWD_THREADS_MAX) return (int)cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<TX, TW, E><<<ctas, nt, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TX*>(dy),
      static_cast<TX*>(dx), static_cast<float*>(partial), N, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_kernel<TW><<<(D + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                             static_cast<TW*>(dw), ctas, D);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_bwd_x(const void* x, const void* w, const void* dy, void* dx, void* dw, void* partial,
                 int N, int D, int ctas, float eps, cudaStream_t s) {
  constexpr int VE = Vec<TX>::N;
  const uintptr_t al = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                       reinterpret_cast<uintptr_t>(dx);
  if (al % 16 == 0 && D % VE == 0)
    return launch_bwd<TX, TW, VE>(x, w, dy, dx, dw, partial, N, D, ctas, eps, s);
  return launch_bwd<TX, TW, 1>(x, w, dy, dx, dw, partial, N, D, ctas, eps, s);
}

}  // namespace

// x, dy, dx: contiguous [N, D] of one dtype (N >= 1, D <= 8192); w, dw:
// contiguous [D] of one dtype; partial: fp32 scratch [ctas, D], 1 <= ctas
// <= N, the rows the first launch's persistent grid splits the work into.
// ``dtypes`` as rmsnorm_fwd's. Two launches; returns the cudaError_t of the
// first that fails (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           void* partial, int N, int D, int ctas, float eps, int dtypes,
                           void* stream) {
  if (N < 1 || D < 1 || D > BWD_THREADS_MAX * BWD_ELEMS || ctas < 1 || ctas > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_ARGS x, w, dy, dx, dw, partial, N, D, ctas, eps, s
  switch (dtypes) {
    case 0: return launch_bwd_x<float, float>(BWD_ARGS);
    case 1: return launch_bwd_x<__nv_bfloat16, float>(BWD_ARGS);
    case 2: return launch_bwd_x<float, __nv_bfloat16>(BWD_ARGS);
    case 3: return launch_bwd_x<__nv_bfloat16, __nv_bfloat16>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

// x: contiguous [N, D] (N >= 1); w: contiguous [D]; o: contiguous [N, D]
// of x's dtype, 16-byte aligned. ``dtypes``: bit 0 set for bf16 x, bit 1 for
// bf16 w (else fp32). Returns the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* o, int N, int D, float eps,
                           int dtypes, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0: return launch_x<float, float>(x, w, o, N, D, eps, s);
    case 1: return launch_x<__nv_bfloat16, float>(x, w, o, N, D, eps, s);
    case 2: return launch_x<float, __nv_bfloat16>(x, w, o, N, D, eps, s);
    case 3: return launch_x<__nv_bfloat16, __nv_bfloat16>(x, w, o, N, D, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
