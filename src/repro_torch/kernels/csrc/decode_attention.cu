// Single-token decode attention against the ring KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_bhgd (body _decode_kernel). It computes the same function:
// one query token per batch row against the ring cache, all G query heads of
// a KV head together so each KV tile is read once, keys masked by
// kpos < lengths[b] and kpos < w_real, fp32 online softmax, l floored at
// 1e-30 (a row of length 0 returns zeros, not NaN).
//
// What bounds it on this card: decode attention does 4*G*hd FLOPs per cached
// position against 2*hd*sizeof(T) bytes of K and V, far below the card's
// operations-per-byte balance, so it is bound by memory bandwidth: the bytes
// of the valid positions over 3.35 TB/s.
//
// Design: split-KV over a thread-block cluster, in one launch. A row (KV head,
// batch row) is a cluster of S CTAs (S a power of two up to 8, Hopper's
// portable cluster size, chosen by the launcher from W and the SM count);
// at max_batch 8 and W 2048 that is 8 x 8 x 8 = 512 CTAs for 132 SMs, where
// one CTA a row left half the card idle and the longest row's CTA walked
// all 64 of its tiles alone. The row's valid keys (below min(lengths[b],
// w_real), so a ragged batch reads sum(lengths) positions, not B * W) are
// cut into tiles of 32 and CTA r takes the r-th share of ceil(tiles / S)
// whole tiles (none, for a short row: it contributes m = -1e30, l = 0).
// Inside a CTA, 4 warps take the share's tiles in turn, each staging its
// tile in shared memory and scoring all G query heads against it. A bf16
// tile stays bf16 (load_kv_tile_bf16, widened to fp32 at use, which is
// exact, by rows_update_bf16: rows_update's arithmetic on such tiles); an
// fp32 tile goes through attn_common.cuh's load_kv_tile and rows_update. The
// warps merge by the max/sum rule into the CTA's unnormalised partial (m, l,
// acc[G][hd]) in its shared memory; after a cluster barrier each CTA reads
// all S partials through distributed shared memory (map_shared_rank),
// merges them by the same rule -- the rule of the JAX package's
// models/attention.py decode_attention_update across sequence shards -- and
// writes its 1/S of the row's G * hd outputs. No second launch, no scratch
// in device memory, no atomics. With S = 1 the key order and the arithmetic
// are the unsplit kernel's (the paged kernel's too): merging one partial
// multiplies by exp(0) = 1 and adds to 0, both exact.
//
// Shared memory at hd 128, G <= 4, bf16: 69 KiB a CTA (3 CTAs an SM),
// against 139 KiB of fp32 tiles and merge area before (one CTA an SM).
#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int MAX_GROUP = 16;  // query heads per KV head
constexpr int MAX_SPLITS = 8;  // CTAs a row: the portable cluster size

// K rows are padded so that lane j's reads of row j spread over the banks:
// 1 float (as attn_common.cuh's fp32 tiles), or 4 bf16 (8 bytes).
template <typename T> struct KPad { static constexpr int N = 1; };
template <> struct KPad<__nv_bfloat16> { static constexpr int N = 4; };

template <typename T, int HD>
__host__ __device__ constexpr int warp_tile_elems() {
  return TILE_K * (2 * HD + KPad<T>::N);
}

template <typename T, int HD, int GMAX>
constexpr size_t decode_smem_bytes() {
  constexpr size_t tiles = sizeof(T) * DEC_WARPS * warp_tile_elems<T, HD>();
  constexpr size_t merge = sizeof(float) * DEC_WARPS * GMAX * (HD + 2);  // aliases the tiles
  return sizeof(float) * (GMAX * HD + GMAX * (HD + 2)) + (tiles > merge ? tiles : merge);
}

// Stage TILE_K rows (t0.. of the cache, rows ``*_stride_row`` elements
// apart) of bf16 K and V in shared memory as bf16: K [TILE_K][HD + 4], V
// [TILE_K][HD]; rows at or past ``n`` become zeros. One warp.
template <int HD>
__device__ __forceinline__ void load_kv_tile_bf16(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                                  const __nv_bfloat16* kbase,
                                                  const __nv_bfloat16* vbase,
                                                  long long k_stride_row,
                                                  long long v_stride_row, int t0, int n,
                                                  int lane) {
  constexpr int VN = Vec<__nv_bfloat16>::N;
  constexpr int ROW_VECS = HD / VN;
  constexpr int PER = TILE_K * ROW_VECS / 32;  // vectors per lane per tensor
  constexpr int CH = PER < 8 ? PER : 8;        // loads in flight per tensor
  constexpr int KS = HD + KPad<__nv_bfloat16>::N;
  static_assert(PER % CH == 0, "tile vectors must split evenly into chunks");
#pragma unroll
  for (int c0 = 0; c0 < PER; c0 += CH) {
    uint4 kr[CH], vr[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = lane + (c0 + i) * 32;
      const int j = e / ROW_VECS;
      const int col = (e - j * ROW_VECS) * VN;
      const int row = t0 + j;
      if (row < n) {
        kr[i] = *reinterpret_cast<const uint4*>(kbase + row * k_stride_row + col);
        vr[i] = *reinterpret_cast<const uint4*>(vbase + row * v_stride_row + col);
      } else {
        kr[i] = make_uint4(0u, 0u, 0u, 0u);
        vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = lane + (c0 + i) * 32;
      const int j = e / ROW_VECS;
      const int col = (e - j * ROW_VECS) * VN;
      // K rows are 8-byte aligned, V rows 16-byte aligned
      uint2* kd = reinterpret_cast<uint2*>(ks + j * KS + col);
      kd[0] = make_uint2(kr[i].x, kr[i].y);
      kd[1] = make_uint2(kr[i].z, kr[i].w);
      *reinterpret_cast<uint4*>(vs + j * HD + col) = vr[i];
    }
  }
}

// rows_update (attn_common.cuh) on a tile kept as bf16: the same reads, in
// the same order, of the same values (widening bf16 to fp32 is exact), so
// the same fp32 arithmetic.
template <int HD, int R>
__device__ __forceinline__ void rows_update_bf16(Rows<HD, R>& st, const float* qs,
                                                 const __nv_bfloat16* ks,
                                                 const __nv_bfloat16* vs,
                                                 const bool (&valid)[R], int nrows,
                                                 float scale, int lane) {
  const __nv_bfloat16* kr = ks + lane * (HD + KPad<__nv_bfloat16>::N);
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(kr + d);
    const float k0 = __uint_as_float(u.x << 16);
    const float k1 = __uint_as_float(u.x & 0xffff0000u);
    const float k2 = __uint_as_float(u.y << 16);
    const float k3 = __uint_as_float(u.y & 0xffff0000u);
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
    for (int i = 0; i < HD / 32; ++i) st.acc[r][i] *= corr;
    st.m[r] = m_new;
  }
#pragma unroll 4
  for (int j = 0; j < TILE_K; ++j) {
    float v[HD / 32];
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) v[i] = to_f32(vs[j * HD + lane + 32 * i]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) break;
      const float pj = __shfl_sync(FULL_MASK, p[r], j);
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) st.acc[r][i] = fmaf(pj, v[i], st.acc[r][i]);
    }
  }
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int* __restrict__ lengths, int W, int H, int G,
                    long long sqb, long long sqh, long long skb, long long skw, long long skh,
                    long long svb, long long svw, long long svh, int w_real, float scale,
                    int splits) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* qs = smem;                  // [GMAX][HD]
  float* part_m = qs + GMAX * HD;    // this CTA's partial: [GMAX]
  float* part_l = part_m + GMAX;     // [GMAX]
  float* part_acc = part_l + GMAX;   // [GMAX][HD]
  T* tiles = reinterpret_cast<T*>(part_acc + GMAX * HD);
  T* ks = tiles + warp * warp_tile_elems<T, HD>();  // [TILE_K][HD + KPad]
  T* vs = ks + TILE_K * (HD + KPad<T>::N);         // [TILE_K][HD]
  // after the sweep the tiles are dead and hold the warps' states
  float* m_all = reinterpret_cast<float*>(tiles);  // [DEC_WARPS][GMAX]
  float* l_all = m_all + DEC_WARPS * GMAX;         // [DEC_WARPS][GMAX]
  float* acc_all = l_all + DEC_WARPS * GMAX;       // [DEC_WARPS][GMAX][HD]

  int valid_len = min(lengths[b], w_real);
  valid_len = max(0, min(valid_len, W));
  // this CTA's share: whole tiles [t_begin, t_end)
  const int n_tiles = (valid_len + TILE_K - 1) / TILE_K;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = rank * per;
  const int t_end = min(t_begin + per, n_tiles);

  const T* qbase = q + b * sqb + (long long)kvh * G * sqh;
  for (int e = tid; e < GMAX * HD; e += DEC_THREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    qs[e] = g < G ? to_f32(qbase[g * sqh + d]) : 0.f;
  }
  __syncthreads();

  Rows<HD, GMAX> st;
  rows_init<HD, GMAX>(st);
  const T* kbase = k + b * skb + kvh * skh;
  const T* vbase = v + b * svb + kvh * svh;
  for (int t = t_begin + warp; t < t_end; t += DEC_WARPS) {
    const int t0 = t * TILE_K;
    __syncwarp();  // this warp's previous tile is consumed
    if constexpr (sizeof(T) == 2)
      load_kv_tile_bf16<HD>(ks, vs, kbase, vbase, skw, svw, t0, W, lane);
    else
      load_kv_tile<T, HD, 32>(ks, vs, kbase, vbase, skw, svw, t0, W, lane);
    __syncwarp();
    bool valid[GMAX];
    const bool ok = t0 + lane < valid_len;
#pragma unroll
    for (int r = 0; r < GMAX; ++r) valid[r] = ok;
    if constexpr (sizeof(T) == 2)
      rows_update_bf16<HD, GMAX>(st, qs, ks, vs, valid, G, scale, lane);
    else
      rows_update<HD, GMAX>(st, qs, ks, vs, valid, G, scale, lane);
  }
  __syncthreads();  // every warp is done with the tiles

  // the warps' states -> this CTA's partial (merge_warps_store's arithmetic,
  // unnormalised)
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r >= G) break;
    if (lane == 0) {
      m_all[warp * GMAX + r] = st.m[r];
      l_all[warp * GMAX + r] = st.l[r];
    }
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      acc_all[(warp * GMAX + r) * HD + lane + 32 * i] = st.acc[r][i];
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += DEC_THREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    float M = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, m_all[w * GMAX + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = expf(m_all[w * GMAX + g] - M);
      L += l_all[w * GMAX + g] * c;
      O += acc_all[(w * GMAX + g) * HD + d] * c;
    }
    part_acc[e] = O;
    if (d == 0) {
      part_m[g] = M;
      part_l[g] = L;
    }
  }

  // every partial of the row, through distributed shared memory; CTA r
  // writes outputs r * 128.. of the row's G * HD, step S * 128
  cluster.sync();
  T* orow = o + ((long long)b * H + (long long)kvh * G) * HD;
  for (int e = rank * DEC_THREADS + tid; e < G * HD; e += splits * DEC_THREADS) {
    const int g = e / HD;
    float M = NEG_INF_F;
    for (int c = 0; c < splits; ++c) M = fmaxf(M, cluster.map_shared_rank(part_m, c)[g]);
    float L = 0.f, O = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float w = expf(cluster.map_shared_rank(part_m, c)[g] - M);
      L += cluster.map_shared_rank(part_l, c)[g] * w;
      O += cluster.map_shared_rank(part_acc, c)[e] * w;
    }
    orow[e] = from_f32<T>(O / fmaxf(L, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

template <typename T, int HD, int GMAX>
int launch(const void* q, const void* k, const void* v, void* o, const void* lengths, int B,
           int W, int H, int Hkv, long long sqb, long long sqh, long long skb, long long skw,
           long long skh, long long svb, long long svw, long long svh, int w_real, float scale,
           int splits, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<T, HD, GMAX>();
  auto kernel = decode_split_kernel<T, HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * Hkv, B);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(o),
                           static_cast<const int*>(lengths), W, H, H / Hkv, sqb, sqh, skb, skw,
                           skh, svb, svw, svh, w_real, scale, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_group(int G, const void* q, const void* k, const void* v, void* o,
                 const void* lengths, int B, int W, int H, int Hkv, long long sqb,
                 long long sqh, long long skb, long long skw, long long skh, long long svb,
                 long long svw, long long svh, int w_real, float scale, int splits,
                 cudaStream_t s) {
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, splits, s);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, splits, s);
  return launch<T, HD, MAX_GROUP>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh,
                                  svb, svw, svh, w_real, scale, splits, s);
}

}  // namespace

// q: [B, 1, H, hd] and k/v: [B, W, Hkv, hd] addressed through the given
// element strides (last dim contiguous, rows 16-byte aligned); lengths:
// contiguous int32 [B]; o: contiguous [B, 1, H, hd]. H / Hkv must be at
// most 16; ``splits``, the CTAs (one cluster) a row, 1 to 8. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* lengths, int B, int W, int H, int Hkv, int hd,
                                    long long sqb, long long sqh, long long skb, long long skw,
                                    long long skh, long long svb, long long svw, long long svh,
                                    int w_real, float scale, int is_bf16, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return launch_group<__nv_bfloat16, HD>(
                            G, q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, splits, s))
  } else {
    DISPATCH_HD(hd, HD, return launch_group<float, HD>(G, q, k, v, o, lengths, B, W, H, Hkv,
                                                       sqb, sqh, skb, skw, skh, svb, svw, svh,
                                                       w_real, scale, splits, s))
  }
  return 0;
}
