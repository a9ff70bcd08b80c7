// The split-KV decode kernel shared by ring decode (decode_attention.cu) and
// paged decode (paged_decode_attention.cu), hand-written for Hopper (sm_90a).
//
// It computes one query token per batch row against that row's cached keys,
// all query heads of a KV head together so each K/V tile is read once, keys
// masked by position < valid_len = min(lengths[b], limit), fp32 online
// softmax, l floored at 1e-30 (a row of length 0 returns zeros, not NaN).
// The two kernels differ only in where key t of row b lives, which a
// row-address policy answers:
//   RingRows:  b * skb + t * skw + kvh * skh              (a dense ring cache)
//   PagedRows: (page_table[b, t / page] * page + t % page) * skp + kvh * skh
// Everything else -- the split plan, the tile loads, the arithmetic, the
// merges -- is one template, so on the same K/V values with the same split
// count the paged kernel's output is bitwise the ring kernel's.
//
// What bounds it on this card: decode attention does 4*G*hd FLOPs per cached
// position against 2*hd*sizeof(T) bytes of K and V, far below the card's
// operations-per-byte balance, so it is bound by memory bandwidth: the bytes
// of the valid positions over 3.35 TB/s.
//
// Design: split-KV over a thread-block cluster, in one launch. A row (KV head,
// batch row, group of at most 16 query heads) is a cluster of S CTAs along x
// (S a power of two up to 8, Hopper's portable cluster size, chosen by the
// launcher from the row length and the SM count); at max_batch 8, 8 KV heads
// and 2048 positions that is 8 x 8 x 8 = 512 CTAs for 132 SMs. A KV head with
// G > 16 query heads runs ceil(G / 16) groups over grid z, so the cluster
// stays on x. The row's valid keys are cut into tiles of 32 and CTA r takes
// the r-th share of ceil(tiles / S) whole tiles (none, for a short row: it
// contributes m = -1e30, l = 0). Inside a CTA, 4 warps take the share's
// tiles in turn, each staging its tile in its own shared memory and scoring
// all its query heads against it: a bf16 tile stays bf16 (widened to fp32 at
// use, which is exact, by rows_update_bf16: rows_update's arithmetic on such
// tiles); an fp32 tile goes through attn_common.cuh's rows_update. Lane j
// resolves the address of tile row t0 + j; the 16-byte loads take a row's
// address from its lane by shuffle (paged) or compute it (ring). A row at or
// past valid_len is never resolved (its page may not exist) and loads as
// zeros. The paged policy reads the page-table entries of a warp's next tile
// before the current tile's loads, so that dependent read overlaps a tile of
// work instead of standing in front of every tile. The warps merge by the
// max/sum rule into the CTA's unnormalised partial (m, l, acc[G][hd]) in its
// shared memory; after a cluster barrier each CTA reads all S partials
// through distributed shared memory (map_shared_rank), merges them by the
// same rule -- the rule of the JAX package's models/attention.py
// decode_attention_update across sequence shards -- and writes its 1/S of
// the row's outputs. No second launch, no scratch in device memory, no
// atomics. With S = 1 merging one partial multiplies by exp(0) = 1 and adds
// to 0, both exact.
//
// Shared memory at hd 128, G <= 4, bf16: 69 KiB a CTA (3 CTAs an SM).
#pragma once

#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int GROUP_HEADS = 16;  // query heads one CTA holds
constexpr int MAX_SPLITS = 8;    // CTAs a row: the portable cluster size

// K rows are padded so that lane j's reads of row j spread over the banks:
// 1 float, or 4 bf16 (8 bytes).
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

// ---------------------------------------------------------------------------
// Row-address policies. Element offsets of K and V row t of (b, kvh):
//   k_base / v_base(b, kvh)   the part that does not depend on t;
//   fetch(b, t, valid_len)    the reads row t needs first (lane j, row t0 + j
//                             of the warp's next tile), issued a tile ahead;
//   own(pre, t)               this lane's row t offsets from what fetch read;
//   at(own, j, t, ko, vo)     row t = t0 + j's offsets, in any lane.

struct RingRows {
  long long skb, skw, skh, svb, svw, svh;
  struct Pre {};
  struct Own {};
  __device__ __forceinline__ long long k_base(int b, int kvh) const { return b * skb + kvh * skh; }
  __device__ __forceinline__ long long v_base(int b, int kvh) const { return b * svb + kvh * svh; }
  __device__ __forceinline__ Pre fetch(int, int, int) const { return {}; }
  __device__ __forceinline__ Own own(const Pre&, int) const { return {}; }
  __device__ __forceinline__ void at(const Own&, int, int t, long long& ko, long long& vo) const {
    ko = t * skw;
    vo = t * svw;
  }
};

// The pool's rows are evenly spaced (a block's stride is page times a row's,
// checked by the entry point), so a row is one 32-bit index into the pool's
// N * page rows: lane j holds row t0 + j's, and a load takes it by one
// 32-bit shuffle.
struct PagedRows {
  const int* page_table;  // [B, n_pages]
  int n_pages, page;
  long long skp, skh, svp, svh;
  struct Pre { int blk; };
  struct Own { int prow; };
  __device__ __forceinline__ long long k_base(int, int kvh) const { return kvh * skh; }
  __device__ __forceinline__ long long v_base(int, int kvh) const { return kvh * svh; }
  // a row at or past valid_len is never resolved: its page may not exist
  __device__ __forceinline__ Pre fetch(int b, int t, int valid_len) const {
    return {t < valid_len ? page_table[(long long)b * n_pages + t / page] : 0};
  }
  __device__ __forceinline__ Own own(const Pre& p, int t) const {
    return {p.blk * page + t % page};
  }
  __device__ __forceinline__ void at(const Own& o, int j, int, long long& ko,
                                     long long& vo) const {
    const int prow = __shfl_sync(FULL_MASK, o.prow, j);
    ko = prow * skp;
    vo = prow * svp;
  }
};

// ---------------------------------------------------------------------------
// Stage the warp's tile -- TILE_K rows from t0, rows at or past valid_len as
// zeros -- in shared memory: bf16 K [TILE_K][HD + 4] and V [TILE_K][HD] as
// bf16; fp32 K [TILE_K][HD + 1] and V [TILE_K][HD] as fp32 (attn_common.cuh's
// fp32 tile layout). Each lane issues a chunk of 16-byte loads before its
// first shared-memory store. One warp.
template <typename T, int HD, int GMAX, class P>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kbase, const T* vbase,
                                          const P& pol, const typename P::Own& own, int t0,
                                          int valid_len, int lane) {
  constexpr int VN = Vec<T>::N;
  constexpr int ROW_VECS = HD / VN;
  constexpr int PER = TILE_K * ROW_VECS / 32;  // vectors per lane per tensor
  // loads in flight per tensor; fewer where the softmax state is large, so
  // that no instantiation spills
  constexpr int CH_MAX = sizeof(T) == 4 || GMAX * HD / 32 >= 32 ? 4 : 8;
  constexpr int CH = PER < CH_MAX ? PER : CH_MAX;
  constexpr int KS = HD + KPad<T>::N;
  static_assert(PER % CH == 0, "tile vectors must split evenly into chunks");
#pragma unroll
  for (int c0 = 0; c0 < PER; c0 += CH) {
    uint4 kr[CH], vr[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = lane + (c0 + i) * 32;
      const int j = e / ROW_VECS;
      const int col = (e - j * ROW_VECS) * VN;
      const int t = t0 + j;
      long long ko, vo;
      pol.at(own, j, t, ko, vo);
      if (t < valid_len) {
        kr[i] = *reinterpret_cast<const uint4*>(kbase + ko + col);
        vr[i] = *reinterpret_cast<const uint4*>(vbase + vo + col);
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
      if constexpr (sizeof(T) == 2) {
        // K rows are 8-byte aligned, V rows 16-byte aligned
        uint2* kd = reinterpret_cast<uint2*>(ks + j * KS + col);
        kd[0] = make_uint2(kr[i].x, kr[i].y);
        kd[1] = make_uint2(kr[i].z, kr[i].w);
        *reinterpret_cast<uint4*>(vs + j * HD + col) = vr[i];
      } else {
        float f[VN];
        Vec<T>::unpack(kr[i], f);
#pragma unroll
        for (int u = 0; u < VN; ++u) ks[j * KS + col + u] = f[u];
        *reinterpret_cast<uint4*>(vs + j * HD + col) = vr[i];
      }
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

// ---------------------------------------------------------------------------
// grid (splits * Hkv, B, ceil(G / 16)), clusters of (splits, 1, 1); q: [B, 1,
// H, HD] through strides sqb, sqh; o: contiguous [B, 1, H, HD]. The launch
// bounds name one CTA an SM as the least, which leaves ptxas the registers
// each instantiation needs: left to choose, it spilled a few in some to
// stay under 64, 72 or 128.
template <typename T, int HD, int GMAX, class P>
__global__ void __launch_bounds__(DEC_THREADS, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int* __restrict__ lengths, const P pol, int H,
                    int G, long long sqb, long long sqh, int limit, float scale, int splits) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int h0 = kvh * G + blockIdx.z * GROUP_HEADS;  // this CTA's first query head
  const int gn = min(GROUP_HEADS, G - (int)blockIdx.z * GROUP_HEADS);  // and its count
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

  const int valid_len = max(0, min(lengths[b], limit));
  // this CTA's share: whole tiles [t_begin, t_end)
  const int n_tiles = (valid_len + TILE_K - 1) / TILE_K;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = rank * per;
  const int t_end = min(t_begin + per, n_tiles);

  const T* qbase = q + b * sqb + (long long)h0 * sqh;
  for (int e = tid; e < GMAX * HD; e += DEC_THREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    qs[e] = g < gn ? to_f32(qbase[g * sqh + d]) : 0.f;
  }
  __syncthreads();

  Rows<HD, GMAX> st;
  rows_init<HD, GMAX>(st);
  const T* kbase = k + pol.k_base(b, kvh);
  const T* vbase = v + pol.v_base(b, kvh);
  int t = t_begin + warp;
  typename P::Pre pre{};
  if (t < t_end) pre = pol.fetch(b, t * TILE_K + lane, valid_len);
  for (; t < t_end; t += DEC_WARPS) {
    const int t0 = t * TILE_K;
    const typename P::Own own = pol.own(pre, t0 + lane);
    // the next tile's reads (page-table entries) go out before this tile's
    if (t + DEC_WARPS < t_end) pre = pol.fetch(b, t0 + DEC_WARPS * TILE_K + lane, valid_len);
    __syncwarp();  // this warp's previous tile is consumed
    load_tile<T, HD, GMAX>(ks, vs, kbase, vbase, pol, own, t0, valid_len, lane);
    __syncwarp();
    bool valid[GMAX];
    const bool ok = t0 + lane < valid_len;
#pragma unroll
    for (int r = 0; r < GMAX; ++r) valid[r] = ok;
    if constexpr (sizeof(T) == 2)
      rows_update_bf16<HD, GMAX>(st, qs, ks, vs, valid, gn, scale, lane);
    else
      rows_update<HD, GMAX>(st, qs, reinterpret_cast<const float*>(ks),
                            reinterpret_cast<const float*>(vs), valid, gn, scale, lane);
  }
  __syncthreads();  // every warp is done with the tiles

  // the warps' states -> this CTA's partial, unnormalised
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r >= gn) break;
    if (lane == 0) {
      m_all[warp * GMAX + r] = st.m[r];
      l_all[warp * GMAX + r] = st.l[r];
    }
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      acc_all[(warp * GMAX + r) * HD + lane + 32 * i] = st.acc[r][i];
  }
  __syncthreads();
  for (int e = tid; e < gn * HD; e += DEC_THREADS) {
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
  // writes outputs r * 128.. of the CTA row's gn * HD, step S * 128
  cluster.sync();
  T* orow = o + ((long long)b * H + h0) * HD;
  for (int e = rank * DEC_THREADS + tid; e < gn * HD; e += splits * DEC_THREADS) {
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

template <typename T, int HD, int GMAX, class P>
int launch_split(const void* q, const void* k, const void* v, void* o, const void* lengths,
                 const P& pol, int B, int H, int Hkv, long long sqb, long long sqh, int limit,
                 float scale, int splits, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<T, HD, GMAX>();
  auto kernel = decode_split_kernel<T, HD, GMAX, P>;
  // the shared-memory opt-in, once per device
  static unsigned opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) opted_in |= 1u << dev;
  }
  const int G = H / Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * Hkv, B, (G + GROUP_HEADS - 1) / GROUP_HEADS);
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
                           static_cast<const int*>(lengths), pol, H, G, sqb, sqh, limit, scale,
                           splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel for q's dtype, the head dim and a CTA's query heads (4, 8 or
// 16 rows of state); cudaErrorInvalidValue for what it does not take.
template <class P>
int launch_decode(int is_bf16, int hd, const void* q, const void* k, const void* v, void* o,
                  const void* lengths, const P& pol, int B, int H, int Hkv, long long sqb,
                  long long sqh, int limit, float scale, int splits, cudaStream_t s) {
  if (Hkv < 1 || H % Hkv != 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv < GROUP_HEADS ? H / Hkv : GROUP_HEADS;  // a CTA's heads
#define DEC_LAUNCH(T)                                                                        \
  DISPATCH_HD(hd, HD, {                                                                      \
    if (g <= 4)                                                                              \
      return launch_split<T, HD, 4>(q, k, v, o, lengths, pol, B, H, Hkv, sqb, sqh, limit,    \
                                    scale, splits, s);                                       \
    if (g <= 8)                                                                              \
      return launch_split<T, HD, 8>(q, k, v, o, lengths, pol, B, H, Hkv, sqb, sqh, limit,    \
                                    scale, splits, s);                                       \
    return launch_split<T, HD, GROUP_HEADS>(q, k, v, o, lengths, pol, B, H, Hkv, sqb, sqh,   \
                                            limit, scale, splits, s);                        \
  })
  if (is_bf16) {
    DEC_LAUNCH(__nv_bfloat16)
  } else {
    DEC_LAUNCH(float)
  }
#undef DEC_LAUNCH
  return 0;
}

}  // namespace
