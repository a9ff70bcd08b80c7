// Shared pieces of the port's attention kernels (prefill flash and the split
// decode kernel of decode_split.cuh; the SSD scan and rmsnorm take its
// conversions and 16-byte vector unpacking): 16-byte vector tile loads, warp
// reductions, and the fp32 online-softmax update of R query rows against one
// shared-memory tile of TILE_K keys.
//
// Layout of a tile in shared memory, both as fp32:
//   K: [TILE_K][HD + 1]  -- lane j reads row j; the +1 pad puts the 32 lanes'
//                           reads of one column in 32 different banks
//   V: [TILE_K][HD]      -- lane l owns output dims l, l+32, ...; a warp
//                           reads one contiguous row at a time
// Keys past the end of the tensor are loaded as zeros, so a masked lane's
// probability (exactly 0) never multiplies garbage that could be inf/NaN.
//
// Tile loads move 16 bytes per thread per load and issue all of a thread's
// loads before the first shared-memory store, so a tile costs one round trip
// to device memory, not one per element. They need 16-byte-aligned rows
// (checked by the Python wrappers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF_F (-1e30f)
#define FULL_MASK 0xffffffffu

constexpr int TILE_K = 32;  // keys per tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 16-byte vector of T and its exact widening to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the top half of an fp32; the element at the lower address is the
  // low half of each 32-bit word
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Stage TILE_K rows of one tensor, W elements wide, into shared memory as
// fp32 rows S elements apart (W + 1 for a K tile, W for a V tile): each
// thread issues its 16-byte loads, in chunks of up to 8, before its stores.
template <typename T, int W, int NT, int S>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long stride_row,
                                          int t0, int n, int tid) {
  constexpr int VN = Vec<T>::N;
  constexpr int ROW_VECS = W / VN;
  constexpr int NVEC = TILE_K * ROW_VECS;
  constexpr int PER = (NVEC + NT - 1) / NT;  // vectors per thread
  constexpr int CH = PER < 8 ? PER : 8;      // loads in flight
  static_assert(PER % CH == 0, "tile vectors must split evenly into chunks");
#pragma unroll
  for (int c0 = 0; c0 < PER; c0 += CH) {
    uint4 r[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = tid + (c0 + i) * NT;
      const int j = e / ROW_VECS;
      const int col = (e - j * ROW_VECS) * VN;
      const int row = t0 + j;
      r[i] = (e < NVEC && row < n)
                 ? *reinterpret_cast<const uint4*>(base + row * stride_row + col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = tid + (c0 + i) * NT;
      if (e >= NVEC) continue;
      const int j = e / ROW_VECS;
      const int col = (e - j * ROW_VECS) * VN;
      float f[VN];
      Vec<T>::unpack(r[i], f);
#pragma unroll
      for (int u = 0; u < VN; ++u) dst[j * S + col + u] = f[u];
    }
  }
}

// Stage TILE_K rows (t0.. of a tensor whose rows are ``*_stride_row``
// elements apart) of K and V into shared memory as fp32, cooperatively over
// NT threads (``tid`` in [0, NT)); rows at or past ``n`` become zeros. K
// rows are HD wide, V rows HDV (HD unless given: MLA's prefill reads K at
// 192 and V at 128).
template <typename T, int HD, int NT, int HDV = HD>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const T* kbase,
                                             const T* vbase, long long k_stride_row,
                                             long long v_stride_row, int t0, int n, int tid) {
  load_rows<T, HD, NT, HD + 1>(ks, kbase, k_stride_row, t0, n, tid);
  load_rows<T, HDV, NT, HDV>(vs, vbase, v_stride_row, t0, n, tid);
}

// Running softmax statistics of R query rows; lane l holds output dims
// l + 32 * i of each row's unnormalised accumulator.
template <int HD, int R>
struct Rows {
  float m[R];
  float l[R];
  float acc[R][HD / 32];
};

template <int HD, int R>
__device__ __forceinline__ void rows_init(Rows<HD, R>& st) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.m[r] = NEG_INF_F;
    st.l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) st.acc[r][i] = 0.f;
  }
}

// R query rows (fp32, shared memory, ``HD`` apart, 16-byte aligned) against
// one tile; rows at or past ``nrows`` are skipped. Lane j scores key j for
// every row, so each K element read from shared memory feeds R FMAs and
// each V element R FMAs. ``valid[r]`` is lane j's mask bit for row r.
// Called by a whole warp. Scores run over HD, V rows (and the accumulators)
// are HDV wide (HD unless given).
template <int HD, int R, int HDV = HD>
__device__ __forceinline__ void rows_update(Rows<HDV, R>& st, const float* qs,
                                            const float* ks, const float* vs,
                                            const bool (&valid)[R], int nrows,
                                            float scale, int lane) {
  const float* kr = ks + lane * (HD + 1);
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) break;
      const float4 q = *reinterpret_cast<const float4*>(qs + r * HD + d);
      s[r] = fmaf(q.x, k0, s[r]);
      s[r] = fmaf(q.y, k1, s[r]);
      s[r] = fmaf(q.z, k2, s[r]);
      s[r] = fmaf(q.w, k3, s[r]);
    }
  }
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = 0.f;
    if (r >= nrows) continue;
    const float sv = valid[r] ? s[r] * scale : NEG_INF_F;
    const float m_new = fmaxf(st.m[r], warp_max(sv));
    const float corr = expf(st.m[r] - m_new);
    p[r] = valid[r] ? expf(sv - m_new) : 0.f;
    st.l[r] = st.l[r] * corr + warp_sum(p[r]);
#pragma unroll
    for (int i = 0; i < HDV / 32; ++i) st.acc[r][i] *= corr;
    st.m[r] = m_new;
  }
#pragma unroll 4
  for (int j = 0; j < TILE_K; ++j) {
    float v[HDV / 32];
#pragma unroll
    for (int i = 0; i < HDV / 32; ++i) v[i] = vs[j * HDV + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) break;
      const float pj = __shfl_sync(FULL_MASK, p[r], j);
#pragma unroll
      for (int i = 0; i < HDV / 32; ++i) st.acc[r][i] = fmaf(pj, v[i], st.acc[r][i]);
    }
  }
}

#define DISPATCH_HD(hd, HD_CONST, ...)          \
  switch (hd) {                                 \
    case 32: { constexpr int HD_CONST = 32; __VA_ARGS__; } break;   \
    case 64: { constexpr int HD_CONST = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int HD_CONST = 128; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue; \
  }
