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
// What bounds it: bytes (x and dy read, dx written; dw is one row), so the
// design keeps enough of them in flight: the card needs about 25 KB an SM.
// The geometry is kernels/rmsnorm.py bwd_plan's (tested on the CPU):
// - Narrow rows (at most 192 accesses: bf16 D <= 1536, fp32 D <= 768;
//   rmsnorm_bwd_narrow_kernel): a row to a group of lanes of one warp, V of
//   2, 3, 4 or 6 accesses a lane (at D 128 bf16 eight lanes of two vectors,
//   four rows a warp; mamba2's 768 a warp of three), so a row's two sums
//   (x^2 and g x) reduce by shuffles within its group, with no shared
//   memory and no __syncthreads. Each group walks rows a grid's groups
//   apart and loads its next row's x and dy before it reduces the current
//   one. Several warps a CTA, as many CTAs as the SMs hold (the occupancy
//   API, asked once a geometry).
// - Wide rows (rmsnorm_bwd_wide_kernel): a row to a CTA, 16 elements a
//   thread, a persistent grid sized by the occupancy API; the 16-byte bf16
//   path loads the next row during the current one's reduction, whose step
//   across warps is double-buffered by row parity (one __syncthreads a row).
// - Both keep w as loaded and their columns' dw partials (fp32) in
//   registers. A narrow warp's groups add their partials by a fixed shuffle
//   butterfly, the warps add theirs into shared memory in warp order, and
//   each CTA writes one partial row to an fp32 scratch [CTAs, D]; a second
//   launch (rmsnorm_dw_kernel) sums each column over the CTAs in slices of
//   consecutive rows, then the slices in order: no atomics, so two calls
//   give the same bits. D up to 8192; every dtype pair, and one element an
//   access where a row is not whole 16-byte vectors or a pointer is not
//   16-byte aligned.
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
// Narrow rows: a row to a group of `lanes` lanes of one warp (a power of two
// up to 32), V accesses a lane (lane j of its group holds accesses j,
// j + lanes, ...). At most 32 x 6 accesses a row, so the CTA's dw buffer
// holds at most 1536 floats (bf16's 16-byte accesses).
constexpr int NARROW_MAX_ACC = 32 * 6;
constexpr int NARROW_MAX_D = NARROW_MAX_ACC * 8;
__host__ __device__ constexpr int narrow_threads_max(int v) { return v <= 2 ? 512 : 256; }
// Wide rows: a row to a CTA, WIDE_ELEMS elements a thread (two 16-byte
// bf16 vectors, four fp32 ones, or 16 single elements), so 512 threads take
// the widest row, 8192 elements.
constexpr int WIDE_ELEMS = 16;
constexpr int WIDE_THREADS_MAX = 512;
constexpr int BWD_MAX_D = WIDE_ELEMS * WIDE_THREADS_MAX;

// One row's part of the backward on the V accesses a thread holds of it:
// the sums of x^2 and g x (g = dy * w rounded to x's dtype, as the plain
// version's autograd), then, given the row's r, its dx and the dw terms
// dy * round(x r) added to the thread's fp32 partials.
template <typename TX, typename TW, int E, int V> struct BwdRow {
  using A = Access<TX, E>;
  typename A::Raw x[V], g[V];  // as loaded: x and dy

  __device__ __forceinline__ void load(const TX* xr, const TX* gr, int a0, int step, int n_acc,
                                       bool on) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = a0 + i * step;
      const bool ok = on && a < n_acc;
      x[i] = ok ? A::load(xr + a * E) : A::zero();
      g[i] = ok ? A::load(gr + a * E) : A::zero();
    }
  }
  template <typename W>
  __device__ __forceinline__ void sums(const W& w, float& ss, float& gx) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float xf[E], gf[E], wf[E];
      A::unpack(x[i], xf);
      A::unpack(g[i], gf);
      w.unpack(i, wf);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        ss = fmaf(xf[u], xf[u], ss);
        gx = fmaf(to_f32(from_f32<TX>(gf[u] * wf[u])), xf[u], gx);
      }
    }
  }
  // c = mean(g * t), t = x * r
  template <typename W>
  __device__ __forceinline__ void finish(const W& w, float r, float c, TX* dxr, int a0, int step,
                                         int n_acc, float (&dw)[V][E]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = a0 + i * step;
      if (a >= n_acc) continue;
      float xf[E], gf[E], wf[E], o[E];
      A::unpack(x[i], xf);
      A::unpack(g[i], gf);
      w.unpack(i, wf);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float t = xf[u] * r;
        o[u] = r * (to_f32(from_f32<TX>(gf[u] * wf[u])) - t * c);
        dw[i][u] = fmaf(gf[u], to_f32(from_f32<TX>(t)), dw[i][u]);
      }
      A::store(dxr + a * E, o);
    }
  }
};

// The V accesses of w a thread takes (a0, a0 + step, ...), zeros past the
// row (a masked access's x and dy are zeros, and 0 * w must stay 0): held in
// registers as loaded on the 16-byte path; read where used with one element
// an access, whose 16 a thread in a wide row would spill beside the rest it
// holds.
template <typename TW, int E, int V> struct WHeld {
  WLoad<TW, E> v[V];
  __device__ __forceinline__ WHeld(const TW* w, int a0, int step, int n_acc) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int a = a0 + i * step;
      if (a < n_acc) {
        v[i].load(w + a * E);
      } else {
#pragma unroll
        for (int q = 0; q < WLoad<TW, E>::R; ++q) v[i].r[q] = {};
      }
    }
  }
  __device__ __forceinline__ void unpack(int i, float* f) const { v[i].unpack(f); }
};
template <typename TW, int E, int V> struct WRead {
  const TW* w;
  int a0, step, n_acc;
  __device__ __forceinline__ WRead(const TW* w_, int a0_, int step_, int n_acc_)
      : w(w_), a0(a0_), step(step_), n_acc(n_acc_) {}
  __device__ __forceinline__ void unpack(int i, float* f) const {
    const int a = a0 + i * step;
    if (a < n_acc) {
      load_w<TW, E>(w + a * E, f);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) f[u] = 0.f;
    }
  }
};
template <typename TW, int E, int V>
using WRow = std::conditional_t<E == 1, WRead<TW, E, V>, WHeld<TW, E, V>>;

// Narrow rows. Group q = (CTA, warp, group) in order walks rows q, q + Q, ...
// (Q the groups of the grid), so a warp's groups read neighbouring rows and
// every warp walks the same number of rows to within one. A row's two sums
// reduce by shuffles within its group; the next rows' x and dy are loaded
// before the current ones reduce. At the end the groups of a warp add their
// dw partials by shuffles (a fixed butterfly), the warps add theirs into
// shared memory in warp order, and the CTA writes one partial row.
// partial: [gridDim.x, D] fp32.
template <typename TX, typename TW, int E, int V>
__global__ void __launch_bounds__(V <= 2 ? 512 : 256, 1)
rmsnorm_bwd_narrow_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                          const TX* __restrict__ dy, TX* __restrict__ dx,
                          float* __restrict__ partial, int N, int D, int lanes, float eps) {
  __shared__ float acc[NARROW_MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int j = lane & (lanes - 1), groups = 32 / lanes, grp = lane / lanes;
  const int n_acc = D / E;
  const long long Q = (long long)gridDim.x * nwarps * groups;
  const long long first = ((long long)blockIdx.x * nwarps + warp) * groups;  // the warp's rows
  const WRow<TW, E, V> wv(w, j, lanes, n_acc);
  float dw[V][E] = {};
  BwdRow<TX, TW, E, V> cur, nxt;
  {
    const long long row = first + grp;
    cur.load(x + row * D, dy + row * D, j, lanes, n_acc, row < N);
  }
  for (long long base = first; base < N; base += Q) {
    const long long row = base + grp, next = row + Q;
    nxt.load(x + next * D, dy + next * D, j, lanes, n_acc, next < N);  // in flight meanwhile
    float ss = 0.f, gx = 0.f;
    cur.sums(wv, ss, gx);
    for (int o = lanes >> 1; o; o >>= 1) {
      ss += __shfl_xor_sync(FULL_MASK, ss, o);
      gx += __shfl_xor_sync(FULL_MASK, gx, o);
    }
    const float r = rsqrtf(ss / (float)D + eps);
    if (row < N) cur.finish(wv, r, r * gx / (float)D, dx + row * D, j, lanes, n_acc, dw);
    cur = nxt;
  }
  // the groups of a warp hold the same columns: lanes j, j + lanes, ...
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int u = 0; u < E; ++u) dw[i][u] += __shfl_xor_sync(FULL_MASK, dw[i][u], o);
  }
  for (int k = 0; k < nwarps; ++k) {
    if (warp == k && lane < lanes) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int a = j + i * lanes;
        if (a >= n_acc) continue;
#pragma unroll
        for (int u = 0; u < E; ++u) {
          float* p = acc + a * E + u;
          *p = k ? *p + dw[i][u] : dw[i][u];
        }
      }
    }
    __syncthreads();
  }
  float* pr = partial + (long long)blockIdx.x * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) pr[c] = acc[c];
}

// Wide rows: CTA b walks rows b, b + gridDim.x, ...; thread t holds accesses
// t, t + NT, ... of a row. On the 16-byte bf16 path (32 bytes of x and of dy
// a thread) the next row's x and dy are loaded before the current one
// reduces; the other paths hold twice the registers a row and load a row
// where it starts. The reduction across warps goes through shared memory
// double-buffered by row parity, so a row costs one __syncthreads.
// partial: [gridDim.x, D] fp32.
template <typename TX, typename TW, int E>
__global__ void __launch_bounds__(WIDE_THREADS_MAX, 1)
rmsnorm_bwd_wide_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const TX* __restrict__ dy, TX* __restrict__ dx,
                        float* __restrict__ partial, int N, int D, float eps) {
  constexpr int V = WIDE_ELEMS / E;
  constexpr bool PREFETCH = E > 1 && sizeof(TX) == 2;
  __shared__ float2 red[2][32];
  const int tid = threadIdx.x, nt = blockDim.x, nwarps = nt >> 5;
  const int n_acc = D / E;
  const WRow<TW, E, V> wv(w, tid, nt, n_acc);
  float dw[V][E] = {};
  BwdRow<TX, TW, E, V> cur, nxt;
  long long row = blockIdx.x;
  if constexpr (PREFETCH) cur.load(x + row * D, dy + row * D, tid, nt, n_acc, true);
  for (int parity = 0; row < N; row += gridDim.x, parity ^= 1) {
    const long long next = row + gridDim.x;
    if constexpr (PREFETCH) {
      if (next < N) nxt.load(x + next * D, dy + next * D, tid, nt, n_acc, true);
    } else {
      cur.load(x + row * D, dy + row * D, tid, nt, n_acc, true);
    }
    float ss = 0.f, gx = 0.f;
    cur.sums(wv, ss, gx);
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if ((tid & 31) == 0) red[parity][tid >> 5] = make_float2(ss, gx);
    __syncthreads();
    float tss = 0.f, tgx = 0.f;
    for (int k = 0; k < nwarps; ++k) {
      tss += red[parity][k].x;
      tgx += red[parity][k].y;
    }
    const float r = rsqrtf(tss / (float)D + eps);
    cur.finish(wv, r, r * tgx / (float)D, dx + row * D, tid, nt, n_acc, dw);
    if constexpr (PREFETCH) cur = nxt;
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

// dw[c] = the P partial rows of column c summed: blockDim.y slices of
// ceil(P / blockDim.y) consecutive rows, each summed in row order, then the
// slices' sums in slice order (a fixed tree, no atomics). Block (32,
// slices), a column a lane.
template <typename TW>
__global__ void __launch_bounds__(1024)
rmsnorm_dw_kernel(const float* __restrict__ partial, TW* __restrict__ dw, int P, int D) {
  __shared__ float part[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  const int per = (P + blockDim.y - 1) / blockDim.y;
  const int p1 = min(P, (y + 1) * per);
  float acc = 0.f;
  if (c < D)
    for (int p = y * per; p < p1; ++p) acc += partial[(long long)p * D + c];
  part[y][threadIdx.x] = acc;
  __syncthreads();
  if (y == 0 && c < D) {
    float t = 0.f;
    for (int k = 0; k < (int)blockDim.y; ++k) t += part[k][threadIdx.x];
    dw[c] = from_f32<TW>(t);
  }
}

// One backward's geometry, from kernels/rmsnorm.py bwd_plan.
struct BwdArgs {
  const void *x, *w, *dy;
  void *dx, *dw, *partial;
  int N, D, vec, wide, vecs, lanes, threads, grid, slices;
  float eps;
  cudaStream_t stream;
};

template <typename TW>
int launch_dw(const BwdArgs& a) {
  rmsnorm_dw_kernel<TW><<<(a.D + 31) / 32, dim3(32, a.slices), 0, a.stream>>>(
      static_cast<const float*>(a.partial), static_cast<TW*>(a.dw), a.grid, a.D);
  return (int)cudaGetLastError();
}

// With ``occ``, the CTAs an SM holds of the first launch's kernel at
// a.threads (no launch); else the two launches.
template <typename TX, typename TW, int E, int V>
int narrow_bwd(const BwdArgs& a, int* occ) {
  auto kernel = rmsnorm_bwd_narrow_kernel<TX, TW, E, V>;
  if (a.lanes < 1 || a.lanes > 32 || (a.lanes & (a.lanes - 1)) || a.lanes * V < a.D / E ||
      a.threads > narrow_threads_max(V))
    return (int)cudaErrorInvalidValue;
  if (occ) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, a.threads, 0);
  kernel<<<a.grid, a.threads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<const TX*>(a.dy),
      static_cast<TX*>(a.dx), static_cast<float*>(a.partial), a.N, a.D, a.lanes, a.eps);
  cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_dw<TW>(a);
}

template <typename TX, typename TW, int E>
int wide_bwd(const BwdArgs& a, int* occ) {
  auto kernel = rmsnorm_bwd_wide_kernel<TX, TW, E>;
  if (a.vecs != WIDE_ELEMS / E || a.threads * (WIDE_ELEMS / E) < a.D / E)
    return (int)cudaErrorInvalidValue;
  if (occ) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, a.threads, 0);
  kernel<<<a.grid, a.threads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<const TX*>(a.dy),
      static_cast<TX*>(a.dx), static_cast<float*>(a.partial), a.N, a.D, a.eps);
  cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_dw<TW>(a);
}

template <typename TX, typename TW, int E>
int rows_bwd(const BwdArgs& a, int* occ) {
  if (a.wide) return wide_bwd<TX, TW, E>(a, occ);
  if (a.D > NARROW_MAX_ACC * E) return (int)cudaErrorInvalidValue;
  switch (a.vecs) {
    case 2: return narrow_bwd<TX, TW, E, 2>(a, occ);
    case 3: return narrow_bwd<TX, TW, E, 3>(a, occ);
    case 4: return narrow_bwd<TX, TW, E, 4>(a, occ);
    case 6: return narrow_bwd<TX, TW, E, 6>(a, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The 16-byte path where x, dy, dx and w are 16-byte aligned and a row is
// whole vectors (as the caller asks with a.vec), else one element an access.
template <typename TX, typename TW>
int access_bwd(const BwdArgs& a, int* occ) {
  constexpr int VE = Vec<TX>::N;
  if (!a.vec) return rows_bwd<TX, TW, 1>(a, occ);
  const uintptr_t al = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.dy) |
                       reinterpret_cast<uintptr_t>(a.dx) | reinterpret_cast<uintptr_t>(a.w);
  if (!occ && (al % 16 || a.D % VE)) return (int)cudaErrorInvalidValue;
  return rows_bwd<TX, TW, VE>(a, occ);
}

int dispatch_bwd(int dtypes, const BwdArgs& a, int* occ) {
  switch (dtypes) {
    case 0: return access_bwd<float, float>(a, occ);
    case 1: return access_bwd<__nv_bfloat16, float>(a, occ);
    case 2: return access_bwd<float, __nv_bfloat16>(a, occ);
    case 3: return access_bwd<__nv_bfloat16, __nv_bfloat16>(a, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward's geometry comes from kernels/rmsnorm.py bwd_plan: ``vec``
// the 16-byte path (else one element an access), ``wide`` a row a CTA (else
// a row a group of ``lanes`` lanes), ``vecs`` accesses a thread holds,
// ``threads`` a CTA, ``grid`` CTAs (at most N; each writes one row of
// ``partial``; a wide CTA loads its first row before it tests it),
// ``slices`` of the ordered dw sum. x, dy, dx: contiguous [N, D] of one
// dtype (N >= 1, D <= 8192); w, dw: contiguous [D] of one dtype; partial:
// fp32 scratch [grid, D]. ``dtypes`` as rmsnorm_fwd's. Two launches;
// returns the cudaError_t of the first that fails (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           void* partial, int N, int D, int vec, int wide, int vecs, int lanes,
                           int threads, int grid, int slices, float eps, int dtypes,
                           void* stream) {
  if (N < 1 || D < 1 || D > BWD_MAX_D || grid < 1 || grid > N || threads < 32 ||
      threads % 32 || threads > WIDE_THREADS_MAX || slices < 1 || slices > 32)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, w, dy, dx, dw, partial, N, D, vec, wide, vecs, lanes, threads, grid, slices,
                  eps, static_cast<cudaStream_t>(stream)};
  return dispatch_bwd(dtypes, a, nullptr);
}

// The CTAs an SM holds of the backward's first kernel for this geometry
// (rmsnorm_bwd's arguments of the same names), written to *ctas; launches
// nothing. Returns the cudaError_t of the query.
extern "C" int rmsnorm_bwd_occupancy(int D, int vec, int wide, int vecs, int lanes, int threads,
                                     int dtypes, void* ctas, void* stream) {
  (void)stream;
  if (D < 1 || D > BWD_MAX_D || threads < 32 || threads % 32 || threads > WIDE_THREADS_MAX)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, D, vec, wide, vecs,
                  lanes, threads, 1, 1, 0.f, nullptr};
  return dispatch_bwd(dtypes, a, static_cast<int*>(ctas));
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
