// Absorbed multi-head latent attention (MLA) decode, hand-written for Hopper
// (sm_90a): DeepSeek-V2's decode step against its latent KV cache, ring and
// paged.
//
// No Pallas kernel stands behind it: the JAX package computes this in jnp
// (src/repro/models/mla.py: mla_decode_update's ``attend`` plus its
// normalisation). The port runs attention on the card through hand-written
// kernels, so MLA decode gets one. It computes, for one query token of each
// batch row and every query head h:
//   s[h, t] = (q_lat[h] . ckv[t] + q_rope[h] . krope[t]) * scale   (fp32)
//   masked for t >= valid_len = min(valid_len[b], limit)
//   out[h]  = sum_t softmax(s[h])[t] * ckv[t]                       (r wide)
// with q_lat = q_nope . W_UK (the absorbed query, r = 512 wide), q_rope the
// query's RoPE half (64), ckv the latent cache [.., 512] and krope the
// shared RoPE key [.., 64]; l floored at 1e-30, so a row of length 0 gives
// zeros. Every head reads the same latent row: MLA is MQA over a 576-wide
// key whose first 512 entries are also the value.
//
// What bounds it on this card: at B = 8, 128 heads and 2,048 slots a call
// moves the valid latent rows once (1,152 bytes a row in bf16) and does
// 2 * 128 * 1,088 FLOPs a row, about 240 FLOP a byte: near the bf16 tensor
// cores' ridge (295), far above fp32 FMA's (20). So in bf16 only the tensor
// cores bring it near its bound, and there the bytes and the operations
// bound it about equally.
//
// bf16: both products on the tensor cores (mla_decode_wgmma_kernel), the
// shape of FlashMLA built on wgmma_common.cuh. It replaces a CUDA-core body
// (16 heads a CTA, fp32 FMAs: 0.1575 ms at chip_smoke.py phase 2's shape on
// an H100), which read each latent tile once per 16 heads.
//   * a CTA is 64 query heads (wgmma's M) of one batch row, two warpgroups;
//     H not a multiple of 64 zero-fills the missing heads and never writes
//     them. Q = [q_lat | q_rope], 64 x 576 bf16, is staged once: by TMA
//     (nine boxes of 64 heads, heads past H zero-filled), element by element
//     when its base or (b, h) strides are not 16-byte multiples. TMA beat
//     cp.async for Q on the card (the first tile waits on Q; PERF.md);
//   * a key tile is 64 latent rows x 576 (ckv's 512, then krope's 64), two
//     stages, tile i + 1 in flight while tile i is computed. A CTA has one
//     SM to itself and few tiles, so what one SM can pull bounds the
//     sweep; TMA fills the tiles (one thread issues a box of 64 columns a
//     column block: 64 rows of the ring, with rows past W zero-filled, or a
//     page of the pool, lane k of warp 0 the tile's k-th page from its
//     page-table read a tile ahead), with an mbarrier a stage. Boxes wholly
//     at or past valid_len are never read (their page may not exist); rows
//     at or past it inside a box are zeroed after it lands. A pool whose
//     page no box fits (not a multiple of 64, nor 8, 16 or 32) takes
//     cp.async 16-byte copies through decode_split.cuh's PagedRows instead,
//     lane j < 8 of warp w resolving row 8w + j. Q and the tiles sit in the
//     128-byte swizzle, nine 64-column blocks, each 1024-byte aligned;
//   * S = Q . K^T is wgmma.m64n64k16 over 36 k-steps, both operands K-major
//     as stored. The first warpgroup scores: its fp32 online softmax (log2
//     domain) runs on the S fragment, masked columns -1e30 and p = 0; it
//     rounds P to bf16 (as JAX casts e to the cache dtype before the value
//     sum) into shared memory with each row's rescale. (Both warpgroups
//     scoring, P kept in registers, was 10.6% slower on the card: S's
//     tensor-core time doubles, and P's round trip costs less.);
//   * O += P . V: V is the tile's first 512 columns, the MN-major B
//     operand; warpgroup g owns value columns 256 g .. 256 g + 255 (four
//     m64n64 accumulators, 128 fp32 registers a thread), A = P from shared
//     memory, the rescale skipped where a row's max did not move;
//   * split-KV over a thread-block cluster of up to 8 CTAs (the portable
//     size; 16 fit only 7 clusters at once and were slower): grid (splits,
//     ceil(H / 64), B), CTA r of a (row, head block) takes the r-th share
//     of the row's whole 64-row tiles, derived on the card from valid_len
//     (no length is read on the host: the decode step is one captured
//     graph; mla_decode_attention.py's tile_shares states the rule). With one CTA a
//     row the output is normalised and written from the registers. Else
//     each CTA's partial (m, l and its output normalised by l, bf16, over
//     the dead tiles) is merged through distributed shared memory by the
//     max/sum rule, CTA r writing its 1/S of the outputs: no scratch in
//     device memory, no atomics. Only the CTAs with tiles take part (the
//     shares are in order); an empty share holds m = -1e30, l = 0.
// Shared memory: Q 72 KiB + 2 x 72 KiB tiles + P 8 KiB + 768 bytes of
// softmax state + 3 mbarriers + 1 KiB alignment slack = 225.8 KiB of 227,
// one CTA an SM.
//
// fp32: the CUDA-core body (mla_decode_kernel). wgmma takes fp32 inputs only
// as TF32 (about three decimal digits); the fp32 path is held to 2e-5 of the
// plain version, so it stays on fp32 FMAs. Latent rows are loaded into
// shared memory once per block of 16 heads, grid (splits, H / 16, B),
// clusters of (splits, 1, 1), 32-row tiles, 8 warps a CTA:
//   * the tiles: two stages; while tile i is scored and summed, tile i + 1
//     is in flight (cp.async, 16 bytes a copy, rows at or past valid_len
//     zero-filled and never resolved). Warp w stages rows 4w..4w+3 of 576
//     elements, rows 16 bytes past a multiple of 128 bytes apart;
//   * the scores: lane j scores row j for heads 2w and 2w + 1 (q in
//     shared memory, read as broadcast float4s; four partial sums a head),
//     then warp w runs those two heads' online softmax (m, l in fp32) over
//     the tile and writes p and the rescale into shared memory;
//   * the values: thread (g, c) = (tid / 64, tid % 64) owns heads 4g..4g+3
//     at 8 latent columns (c * 4.. and 256 + c * 4..), 32 fp32
//     accumulators, one 16-byte read of a tile row feeding 16 FMAs;
//   * the merge: each CTA's unnormalised partial (m, l, acc [16][512] fp32
//     over the dead tiles) read by every CTA of the cluster through
//     distributed shared memory and merged by the max/sum rule, CTA r
//     writing its 1/S of the outputs.
// Shared memory: 183.2 KiB a CTA.
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap

#include "decode_split.cuh"
#include "wgmma_common.cuh"  // cp.async, wgmma and their descriptors

namespace {

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int MLA_R = 512;               // kv_lora_rank: scored and summed
constexpr int MLA_DR = 64;               // qk_rope_dim: scored only
constexpr int MLA_D = MLA_R + MLA_DR;    // the score width
constexpr int MLA_HB = 16;               // query heads a CTA; H a multiple
constexpr int MLA_TK = 32;               // latent rows a tile
constexpr int MLA_WARPS = 8;
constexpr int MLA_THREADS = MLA_WARPS * 32;
constexpr int MLA_MAX_SPLITS = 8;        // the portable cluster size
constexpr int MLA_ROWS = MLA_TK / MLA_WARPS;  // tile rows a warp stages
constexpr int MLA_STAGES = 2;

// a tile row's stride in elements: 576 plus 16 bytes
template <typename T>
__host__ __device__ constexpr int tile_stride() { return MLA_D + 16 / (int)sizeof(T); }

template <typename T>
constexpr size_t mla_smem_bytes() {
  // q [HB][D], p [TK][HB], the tile's rescale, m and l [HB] each (fp32);
  // then the tiles [STAGES][TK][stride] of T, which the partial acc
  // [HB][R] (fp32) aliases after the sweep
  constexpr size_t head = sizeof(float) * (MLA_HB * MLA_D + MLA_TK * MLA_HB + 3 * MLA_HB);
  constexpr size_t tile = sizeof(T) * MLA_STAGES * MLA_TK * tile_stride<T>();
  constexpr size_t acc = sizeof(float) * MLA_HB * MLA_R;
  return head + (tile > acc ? tile : acc);
}

// Issue the copies of the tile's 32 rows from t0 into ``tile`` (ckv's 512
// then krope's 64 a row; rows at or past valid_len zero-filled, from no
// address of theirs): warp ``warp`` its 4 rows, 16-byte cp.async copies.
// ``own`` holds lane j's resolution of row t0 + j (every lane of the warp
// calls this).
template <typename T, class P>
__device__ __forceinline__ void mla_issue_tile(T* tile, const T* cbase, const T* rbase,
                                               const P& pol, const typename P::Own& own,
                                               int t0, int valid_len, int warp, int lane) {
  constexpr int VN = Vec<T>::N;
  constexpr int RV = MLA_D / VN;  // vectors a row
  constexpr int CV = MLA_R / VN;  // of them ckv's
  constexpr int PER = MLA_ROWS * RV / 32;
  constexpr int KS = tile_stride<T>();
  static_assert(MLA_ROWS * RV % 32 == 0, "whole vectors a lane");
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + i * 32;
    const int j = warp * MLA_ROWS + e / RV;
    const int c = e % RV;
    const int t = t0 + j;
    long long co, ro;
    pol.at(own, j, t, co, ro);  // every lane: the paged rule shuffles
    const bool ok = t < valid_len;
    const T* src = !ok ? cbase : c < CV ? cbase + co + c * VN : rbase + ro + (c - CV) * VN;
    cp_async16(smem_addr(tile + j * KS + c * VN), src, ok);
  }
}

// grid (splits, H / 16, B), clusters of (splits, 1, 1). q_lat: [B, 1, H, R]
// and q_rope: [B, 1, H, DR] through strides (b, h); o: contiguous
// [B, 1, H, R].
template <typename T, class P>
__global__ void __launch_bounds__(MLA_THREADS, sizeof(T) == 2 ? 2 : 1)
mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ krope, T* __restrict__ o,
                  const int* __restrict__ valid_lens, const P pol, int H, long long sqlb,
                  long long sqlh, long long sqrb, long long sqrh, int limit, float scale,
                  int splits) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h0 = blockIdx.y * MLA_HB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int VN = Vec<T>::N;
  constexpr int NCH = 8 / VN;  // a thread's column chunks: 1 (bf16) or 2 (fp32)
  constexpr int KS = tile_stride<T>();

  float* qs = smem;                      // [HB][D]
  float* ps = qs + MLA_HB * MLA_D;       // [TK][HB] the tile's probabilities
  float* corr_s = ps + MLA_TK * MLA_HB;  // [HB] the tile's rescale of acc
  float* part_m = corr_s + MLA_HB;       // [HB] this CTA's partial
  float* part_l = part_m + MLA_HB;       // [HB]
  T* tiles = reinterpret_cast<T*>(part_l + MLA_HB);   // [STAGES][TK][KS]
  float* part_acc = reinterpret_cast<float*>(tiles);  // [HB][R], after the sweep

  const int valid_len = max(0, min(valid_lens[b], limit));
  // this CTA's share: whole tiles [t_begin, t_end)
  const int n_tiles = (valid_len + MLA_TK - 1) / MLA_TK;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = rank * per;
  const int t_end = min(t_begin + per, n_tiles);

  for (int e = tid; e < MLA_HB * MLA_D; e += MLA_THREADS) {
    const int g = e / MLA_D;
    const int d = e - g * MLA_D;
    const long long h = h0 + g;
    qs[e] = d < MLA_R ? to_f32(q_lat[b * sqlb + h * sqlh + d])
                      : to_f32(q_rope[b * sqrb + h * sqrh + (d - MLA_R)]);
  }

  // warp w's softmax state for heads 2w, 2w + 1 (the same on every lane)
  float m_run[2] = {NEG_INF_F, NEG_INF_F};
  float l_run[2] = {0.f, 0.f};
  // thread (hg, cc): heads 4 hg.., columns k * (R / NCH) + cc * VN ..
  const int hg = tid >> 6;
  const int cc = tid & 63;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;

  const T* cbase = ckv + pol.k_base(b, 0);
  const T* rbase = krope + pol.v_base(b, 0);
  // tile t of the share goes to stage (t - t_begin) % 2; the page-table
  // reads of a tile go out a tile ahead of its copies
  typename P::Pre pre{};
  if (t_begin < t_end) {
    pre = pol.fetch(b, t_begin * MLA_TK + lane, valid_len);
    const typename P::Own own = pol.own(pre, t_begin * MLA_TK + lane);
    if (t_begin + 1 < t_end) pre = pol.fetch(b, (t_begin + 1) * MLA_TK + lane, valid_len);
    mla_issue_tile<T>(tiles, cbase, rbase, pol, own, t_begin * MLA_TK, valid_len, warp, lane);
  }
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * MLA_TK;
    const T* tile = tiles + ((t - t_begin) & 1) * (MLA_TK * KS);
    if (t + 1 < t_end) {  // into the other stage, consumed at t - 1
      const typename P::Own own = pol.own(pre, t0 + MLA_TK + lane);
      if (t + 2 < t_end) pre = pol.fetch(b, t0 + 2 * MLA_TK + lane, valid_len);
      mla_issue_tile<T>(tiles + ((t + 1 - t_begin) & 1) * (MLA_TK * KS), cbase, rbase, pol,
                        own, t0 + MLA_TK, valid_len, warp, lane);
    }
    cp_async_commit();
    cp_async_wait1();  // tile t landed, tile t + 1 in flight
    __syncthreads();   // (and q staged, at the first tile)

    // scores of row t0 + lane for heads 2 warp, 2 warp + 1: four partial
    // sums a head
    const T* kr = tile + lane * KS;
    const float* q0 = qs + (2 * warp) * MLA_D;
    const float* q1 = q0 + MLA_D;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int d = 0; d < MLA_D; d += VN) {
      float kf[VN];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(kr + d), kf);
#pragma unroll
      for (int u = 0; u < VN; u += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q0 + d + u);
        const float4 c = *reinterpret_cast<const float4*>(q1 + d + u);
        a0[0] = fmaf(a.x, kf[u], a0[0]);
        a0[1] = fmaf(a.y, kf[u + 1], a0[1]);
        a0[2] = fmaf(a.z, kf[u + 2], a0[2]);
        a0[3] = fmaf(a.w, kf[u + 3], a0[3]);
        a1[0] = fmaf(c.x, kf[u], a1[0]);
        a1[1] = fmaf(c.y, kf[u + 1], a1[1]);
        a1[2] = fmaf(c.z, kf[u + 2], a1[2]);
        a1[3] = fmaf(c.w, kf[u + 3], a1[3]);
      }
    }
    const float s0 = (a0[0] + a0[1]) + (a0[2] + a0[3]);
    const float s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
    const bool ok = t0 + lane < valid_len;
    const float sv[2] = {ok ? s0 * scale : NEG_INF_F, ok ? s1 * scale : NEG_INF_F};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], warp_max(sv[r]));
      const float corr = expf(m_run[r] - m_new);
      const float p = ok ? expf(sv[r] - m_new) : 0.f;
      l_run[r] = l_run[r] * corr + warp_sum(p);
      m_run[r] = m_new;
      ps[lane * MLA_HB + 2 * warp + r] = p;
      if (lane == 0) corr_s[2 * warp + r] = corr;
    }
    __syncthreads();

    // acc[i][..] = acc * corr + sum_j p[j][4 hg + i] * ckv[j][cols]
    const float4 c4 = *reinterpret_cast<const float4*>(corr_s + 4 * hg);
    const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] *= cr[i];
#pragma unroll 4
    for (int j = 0; j < MLA_TK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + j * MLA_HB + 4 * hg);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        float v[VN];
        Vec<T>::unpack(
            *reinterpret_cast<const uint4*>(tile + j * KS + k * (MLA_R / NCH) + cc * VN), v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < VN; ++u) acc[i][k * VN + u] = fmaf(pr[i], v[u], acc[i][k * VN + u]);
      }
    }
    __syncthreads();  // the tile and p are consumed
  }
  cp_async_wait0();

  // this CTA's partial, unnormalised (acc over the dead tiles)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int u = 0; u < VN; u += 4)
        *reinterpret_cast<float4*>(part_acc + (4 * hg + i) * MLA_R + k * (MLA_R / NCH) +
                                   cc * VN + u) =
            make_float4(acc[i][k * VN + u], acc[i][k * VN + u + 1], acc[i][k * VN + u + 2],
                        acc[i][k * VN + u + 3]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part_m[2 * warp + r] = m_run[r];
      part_l[2 * warp + r] = l_run[r];
    }
  }

  // every partial of the (row, head block), through distributed shared
  // memory; CTA r writes outputs r * 256.. of the block's 16 * 512, step
  // S * 256
  cluster.sync();
  T* orow = o + ((long long)b * H + h0) * MLA_R;
  for (int e = rank * MLA_THREADS + tid; e < MLA_HB * MLA_R; e += splits * MLA_THREADS) {
    const int g = e / MLA_R;
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

// The shared-memory opt-in of ``kernel``, once per device.
template <typename K>
int opt_in(K kernel, size_t smem, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (done >> dev & 1u)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) done |= 1u << dev;
  return 0;
}

// A launch of ``grid`` in clusters of (splits, 1, 1); ``attr`` holds the
// cluster attribute the config points to.
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, int splits,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, class P>
int launch_mla(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
               void* o, const void* valid_len, const P& pol, int B, int H, long long sqlb,
               long long sqlh, long long sqrb, long long sqrh, int limit, float scale,
               int splits, cudaStream_t stream) {
  constexpr size_t smem = mla_smem_bytes<T>();
  auto kernel = mla_decode_kernel<T, P>;
  static unsigned opted_in = 0;
  const int e = opt_in(kernel, smem, opted_in);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(splits, H / MLA_HB, B), MLA_THREADS, smem, splits, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope), static_cast<T*>(o),
      static_cast<const int*>(valid_len), pol, H, sqlb, sqlh, sqrb, sqrh, limit, scale, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_H = 64;                       // query heads a CTA: wgmma's M
constexpr int WG_TK = 64;                      // latent rows a tile
constexpr int WG_THREADS = 256;                // two warpgroups
constexpr int WG_CB = MLA_D / 64;              // 128-byte column blocks a row: 9
constexpr int WG_VB = MLA_R / 64 / 2;          // value blocks a warpgroup owns: 4
constexpr uint32_t WG_BLOCK = 64 * 128;        // bytes of a 64-row column block
constexpr uint32_t WG_TILE = WG_CB * WG_BLOCK; // a Q or key tile: 72 KiB
constexpr int WG_ACC = MLA_R + 8;              // elements a head's row of the partial
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t wg_smem_bytes() {
  // Q, two key tiles, P (one column block); the rescale, m and l [64] each
  // (fp32); three mbarriers (the stages', Q's); slack to align the tiles to
  // the 1024-byte swizzle period
  return (size_t)3 * WG_TILE + WG_BLOCK + 3 * WG_H * sizeof(float) + 3 * 8 + 1024;
}
static_assert(wg_smem_bytes() <= 232448, "one CTA an SM");
static_assert(WG_H * WG_ACC * 2 <= 2 * WG_TILE, "the partial fits the dead tiles");
static_assert(3 * WG_H * MLA_MAX_SPLITS * sizeof(float) <= WG_TILE,
              "the merge's m, l and weights fit over Q");

// The tensor maps of the bf16 body's TMA copies (encoded on the host for
// each launch): ckv and krope as the cache holds them -- the ring [B, W, *]
// (3-D, rows past W zero-filled), the pool [N * page, *] (2-D, rows evenly
// spaced) -- boxes of 64 columns by ``rows`` rows (64, or a page of 8..32)
// under the 128-byte swizzle; q_lat and q_rope [B, H, *] (3-D, heads past H
// zero-filled) in boxes of 64 columns by 64 heads when ``q_tma``.
struct TmaMaps {
  CUtensorMap ckv, krope, q_lat, q_rope;
  int rows;
  int q_tma;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a box of ``map`` at (c0, c1[, c2]) into shared memory at ``dst``, its bytes
// reported to ``bar``
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Issue the TMA copies of the key tile's 64 rows from t0 into the tile at
// ``dst`` on barrier ``bar`` (warp 0; every lane calls this): the tile's
// boxes of ``G`` rows that hold a row below valid_len, lane k the k-th (the
// ring: one box of 64 rows, at (row, batch row) coordinates; the pool: a
// page's rows, from lane k's resolution ``own`` of row t0 + k G), ckv's 8
// column blocks and krope's one each. Rows at or past valid_len inside a
// box are zeroed after it lands, boxes wholly past it are never read.
template <class P>
__device__ __forceinline__ void wg_tma_tile(uint32_t dst, uint32_t bar, const TmaMaps& maps,
                                            const typename P::Own& own, int t0, int b,
                                            int valid_len, int lane) {
  const int G = maps.rows;
  const int ng = min(WG_TK / G, (valid_len - t0 + G - 1) / G);  // boxes with a valid row
  if (lane == 0) mbar_expect(bar, ng * G * MLA_D * 2);
  __syncwarp();
  if (lane < ng) {
    const uint32_t d = dst + lane * G * 128;
#pragma unroll
    for (int cb = 0; cb < WG_CB; ++cb) {
      const CUtensorMap* map = cb < WG_CB - 1 ? &maps.ckv : &maps.krope;
      const int c0 = cb < WG_CB - 1 ? cb * 64 : 0;
      if constexpr (std::is_same<P, RingRows>::value)
        tma_3d(d + cb * WG_BLOCK, map, c0, t0, b, bar);
      else
        tma_2d(d + cb * WG_BLOCK, map, c0, own.prow, bar);
    }
  }
}

// Issue the copies of the key tile's 64 rows from t0 into the tile at
// ``dst`` (ckv's 512 then krope's 64 a row, 128-byte swizzle; rows at or
// past valid_len zero-filled, from no address of theirs): warp ``warp`` its
// rows 8 warp .. 8 warp + 7, 18 16-byte copies a lane, consecutive lanes on
// consecutive 16 bytes of a row. Lane j < 8 of the warp holds row
// t0 + 8 warp + j's resolution in ``own`` (every lane calls this).
template <class P>
__device__ __forceinline__ void wg_issue_tile(uint32_t dst, const __nv_bfloat16* cbase,
                                              const __nv_bfloat16* rbase, const P& pol,
                                              const typename P::Own& own, int t0,
                                              int valid_len, int warp, int lane) {
  constexpr int CH = MLA_D / 8;     // 16-byte chunks a row
  constexpr int PER = 8 * CH / 32;  // a lane's copies
  static_assert(8 * CH % 32 == 0, "whole copies a lane");
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + i * 32;
    const int jl = e / CH;
    const int c = e - jl * CH;
    const int j = warp * 8 + jl;
    const int t = t0 + j;
    long long co, ro;
    pol.at(own, jl, t, co, ro);  // every lane: the paged rule shuffles
    const bool ok = t < valid_len;
    const __nv_bfloat16* src =
        !ok ? cbase : c < MLA_R / 8 ? cbase + co + c * 8 : rbase + ro + (c - MLA_R / 8) * 8;
    cp_async16(dst + sw128(j, c, WG_TK), src, ok);
  }
}

// grid (splits, ceil(H / 64), B), clusters of (splits, 1, 1). q_lat: [B, 1,
// H, R] and q_rope: [B, 1, H, DR] through strides (b, h); o: contiguous
// [B, 1, H, R]. TMA: the key tiles arrive by TMA, else by cp.async (a pool
// whose page no box fits); Q by TMA when ``maps.q_tma``, else element by
// element.
template <class P, bool TMA>
__global__ void __launch_bounds__(WG_THREADS, 1)
mla_decode_wgmma_kernel(const __nv_bfloat16* __restrict__ q_lat,
                        const __nv_bfloat16* __restrict__ q_rope,
                        const __nv_bfloat16* __restrict__ ckv,
                        const __nv_bfloat16* __restrict__ krope, __nv_bfloat16* __restrict__ o,
                        const int* __restrict__ valid_lens, const P pol,
                        const __grid_constant__ TmaMaps maps, int H, long long sqlb,
                        long long sqlh, long long sqrb, long long sqrh, int limit, float scale,
                        int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (sbase - raw);
  const uint32_t sq = sbase;               // Q [64 heads][576]
  const uint32_t skt = sbase + WG_TILE;    // the key tile of stage s at skt + s * WG_TILE
  const uint32_t sp = skt + 2 * WG_TILE;   // P [64 heads][64 rows]
  float* corr_s = reinterpret_cast<float*>(smem + 3 * WG_TILE + WG_BLOCK);  // [64]
  float* part_m = corr_s + WG_H;           // [64] this CTA's partial (log2 domain)
  float* part_l = part_m + WG_H;           // [64]
  const uint32_t bars = smem_addr(part_l + WG_H);  // mbarriers: stage 0, stage 1, Q
  // [64][WG_ACC] after the sweep: this CTA's partial, normalised
  __nv_bfloat16* part_o = reinterpret_cast<__nv_bfloat16*>(smem + WG_TILE);
  float* wts = reinterpret_cast<float*>(smem);  // [64][MLA_MAX_SPLITS] after the sweep, and m, l

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h0 = blockIdx.y * WG_H;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int row_a = (warp & 3) * 16 + (lane >> 2);  // this thread's heads: row_a, row_a + 8
  const int col0 = 2 * (lane & 3);                  // and columns 8 j + col0 (+1)
  // the tile row this lane resolves: TMA, lane k of warp 0 row k G (a box's
  // first); cp.async, lane j < 8 of warp w row 8 w + j
  const int my_row = TMA ? lane % (WG_TK / maps.rows) * maps.rows : 8 * warp + (lane & 7);

  const int valid_len = max(0, min(valid_lens[b], limit));
  // this CTA's share: whole tiles [t_begin, t_end)
  const int n_tiles = (valid_len + WG_TK - 1) / WG_TK;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = rank * per;
  const int t_end = min(t_begin + per, n_tiles);

  float oacc[WG_VB][32];
#pragma unroll
  for (int n = 0; n < WG_VB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[n][i] = 0.f;
  float m_run[2] = {NEG_INF_F, NEG_INF_F};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  const float scale_log2 = scale * LOG2E;
  const __nv_bfloat16* cbase = ckv + pol.k_base(b, 0);
  const __nv_bfloat16* rbase = krope + pol.v_base(b, 0);

  // Q and the first tile; the page-table reads of a tile go out a tile
  // ahead of its copies
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init(bars + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  typename P::Pre pre{};
  if (t_begin < t_end && maps.q_tma) {
    if (warp == 0) {
      if (lane == 0) mbar_expect(bars + 16, WG_TILE);
      __syncwarp();
      if (lane < WG_CB)
        tma_3d(sq + lane * WG_BLOCK, lane < WG_CB - 1 ? &maps.q_lat : &maps.q_rope,
               lane < WG_CB - 1 ? lane * 64 : 0, h0, b, bars + 16);
    }
  } else if (t_begin < t_end) {
    for (int e = tid; e < WG_H * (MLA_D / 8); e += WG_THREADS) {
      const int r = e / (MLA_D / 8);
      const int c = e - r * (MLA_D / 8);
      const bool ok = h0 + r < H;
      const long long h = min(h0 + r, H - 1);
      const uint16_t* src = reinterpret_cast<const uint16_t*>(
          c < MLA_R / 8 ? q_lat + b * sqlb + h * sqlh + c * 8
                        : q_rope + b * sqrb + h * sqrh + (c - MLA_R / 8) * 8);
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = ok ? src[2 * u] | (uint32_t)src[2 * u + 1] << 16 : 0u;
      *reinterpret_cast<uint4*>(smem + sw128(r, c, WG_H)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (t_begin < t_end && (!TMA || warp == 0)) {
    pre = pol.fetch(b, t_begin * WG_TK + my_row, valid_len);
    const typename P::Own own = pol.own(pre, t_begin * WG_TK + my_row);
    if (t_begin + 1 < t_end) pre = pol.fetch(b, (t_begin + 1) * WG_TK + my_row, valid_len);
    if constexpr (TMA)
      wg_tma_tile<P>(skt, bars, maps, own, t_begin * WG_TK, b, valid_len, lane);
    else
      wg_issue_tile(skt, cbase, rbase, pol, own, t_begin * WG_TK, valid_len, warp, lane);
  }
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * WG_TK;
    const int stage = (t - t_begin) & 1;
    const uint32_t kd = skt + stage * WG_TILE;
    if (t + 1 < t_end && (!TMA || warp == 0)) {  // into the other stage, consumed at t - 1
      const typename P::Own own = pol.own(pre, t0 + WG_TK + my_row);
      if (t + 2 < t_end) pre = pol.fetch(b, t0 + 2 * WG_TK + my_row, valid_len);
      if constexpr (TMA)
        wg_tma_tile<P>(skt + (stage ^ 1) * WG_TILE, bars + 8 * (stage ^ 1), maps, own,
                       t0 + WG_TK, b, valid_len, lane);
      else
        wg_issue_tile(skt + (stage ^ 1) * WG_TILE, cbase, rbase, pol, own, t0 + WG_TK,
                      valid_len, warp, lane);
    }
    if (t == t_begin && maps.q_tma) mbar_wait(bars + 16, 0);  // Q landed
    if constexpr (TMA) {
      // tile t landed; then its rows at or past valid_len zeroed
      mbar_wait(bars + 8 * stage, ((t - t_begin) >> 1) & 1);
      const int v0 = valid_len - t0;  // at least 1: the tile holds a valid row
      if (v0 < WG_TK)
        for (int e = tid; e < (WG_TK - v0) * (MLA_D / 8); e += WG_THREADS)
          *reinterpret_cast<uint4*>(smem + (kd - sbase) +
                                    sw128(v0 + e / (MLA_D / 8), e % (MLA_D / 8), WG_TK)) =
              make_uint4(0u, 0u, 0u, 0u);
    } else {
      cp_async_commit();
      cp_async_wait1();  // tile t landed, tile t + 1 in flight
    }
    fence_async_shared();
    __syncthreads();

    float corr[2] = {1.f, 1.f};
    if (wg == 0) {
      // S = Q . K^T over 36 steps of 32 bytes along a row
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MLA_D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * WG_BLOCK + (kk & 3) * 32;
        wgmma_ss_n64(s, wg_desc(sq + off, 16, 1024, 1), wg_desc(kd + off, 16, 1024, 1), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // scores in the log2 domain; rows at or past valid_len -> -1e30 (only
      // the row's last tile has any)
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
      if (t0 + WG_TK > valid_len) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (t0 + 8 * (j >> 2) + col0 + (j & 1) >= valid_len) s[j] = NEG_INF_F;
      }
      // online softmax of the two rows; a row's 64 scores lie on 4 lanes
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF_F;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, s[(j >> 1) * 4 + 2 * r + (j & 1)]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        corr[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        // masked scores give 0 even before the first visible row
        const float m_use = m_new == NEG_INF_F ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int idx = (j >> 1) * 4 + 2 * r + (j & 1);
          s[idx] = exp2f(s[idx] - m_use);
          sum += s[idx];
        }
        l_run[r] = l_run[r] * corr[r] + sum;
      }
      // P, rounded to bf16, and the rows' rescale to the other warpgroup
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(smem + (sp - sbase) +
                                             sw128(row_a + 8 * r, c, WG_H) + 2 * col0) =
              __floats2bfloat162_rn(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
      if ((lane & 3) == 0) {
        corr_s[row_a] = corr[0];
        corr_s[row_a + 8] = corr[1];
      }
    }
    fence_async_shared();  // P's stores, before wgmma reads them
    __syncthreads();
    if (wg != 0) {
      corr[0] = corr_s[row_a];
      corr[1] = corr_s[row_a + 8];
    }
    if (corr[0] != 1.f || corr[1] != 1.f) {  // the rows' max moved
#pragma unroll
      for (int n = 0; n < WG_VB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[n][i] *= corr[(i >> 1) & 1];
    }

    // O += P . V on this warpgroup's four value blocks
#pragma unroll
    for (int n = 0; n < WG_VB; ++n) fence_regs(oacc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_TK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < WG_VB; ++n) {
        const uint64_t dv =
            wg_desc(kd + (wg * WG_VB + n) * WG_BLOCK + kk * 16 * 128, 1024, 1024, 1);
        wgmma_ss_n64<1>(oacc[n], wg_desc(sp + kk * 32, 16, 1024, 1), dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < WG_VB; ++n) fence_regs(oacc[n]);
    __syncthreads();  // this stage and P are free
  }
  cp_async_wait0();
  __syncthreads();  // the tiles are dead (an empty share never staged any)
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row sums over the 4 lanes of a row
    l_run[r] += __shfl_xor_sync(FULL_MASK, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(FULL_MASK, l_run[r], 2);
  }
  if (wg == 0 && (lane & 3) == 0) {
    part_m[row_a] = m_run[0];
    part_m[row_a + 8] = m_run[1];
    part_l[row_a] = l_run[0];
    part_l[row_a + 8] = l_run[1];
  }
  __nv_bfloat16* orow = o + ((long long)b * H + h0) * MLA_R;
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(part_l[row_a + 8 * r], 1e-30f);

  if (splits == 1) {
    // one partial: its weight is 2^0; normalised in registers and written
    // from the fragment, no exchange
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = row_a + 8 * r;
      if (h0 + g >= H) continue;  // a missing head of a partial block
#pragma unroll
      for (int n = 0; n < WG_VB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + g * MLA_R + (wg * WG_VB + n) * 64 + 8 * j +
                                             col0) =
              __floats2bfloat162_rn(oacc[n][4 * j + 2 * r] * inv[r],
                                    oacc[n][4 * j + 2 * r + 1] * inv[r]);
    }
    return;
  }

  // this CTA's partial, normalised by its own l, in bf16 over the dead tiles
  // (half the bytes the merge moves between CTAs; its rounding is the
  // output's own)
#pragma unroll
  for (int n = 0; n < WG_VB; ++n)
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = (j >> 1) & 1;
      *reinterpret_cast<__nv_bfloat162*>(part_o + (row_a + 8 * r) * WG_ACC +
                                         (wg * WG_VB + n) * 64 + 8 * (j >> 2) + col0) =
          __floats2bfloat162_rn(oacc[n][j] * inv[r], oacc[n][j + 1] * inv[r]);
    }

  // every partial of the (row, head block) with tiles -- CTAs 0 .. live - 1,
  // the shares being in order; the others hold m = -1e30, l = 0 -- through
  // distributed shared memory: each (head, CTA)'s m and l read once, all at
  // once; each head's weights 2^(m_c - M) l_c / max(L, 1e-30); then CTA r
  // writes 16-byte chunks r * 256.. of the block's 64 * 64, step S * 256
  const int live = per > 0 ? min(splits, (n_tiles + per - 1) / per) : 0;
  cluster.sync();
  float* mm = wts + WG_H * MLA_MAX_SPLITS;  // [64][MLA_MAX_SPLITS]
  float* ll = mm + WG_H * MLA_MAX_SPLITS;   // [64][MLA_MAX_SPLITS]
  for (int e = tid; e < WG_H * live; e += WG_THREADS) {
    const int g = e % WG_H;
    const int c = e / WG_H;
    mm[g * MLA_MAX_SPLITS + c] = cluster.map_shared_rank(part_m, c)[g];
    ll[g * MLA_MAX_SPLITS + c] = cluster.map_shared_rank(part_l, c)[g];
  }
  __syncthreads();
  if (tid < WG_H) {
    const float* m = mm + tid * MLA_MAX_SPLITS;
    const float* l = ll + tid * MLA_MAX_SPLITS;
    float M = NEG_INF_F;
    for (int c = 0; c < live; ++c) M = fmaxf(M, m[c]);
    float L = 0.f;
    for (int c = 0; c < live; ++c) L += l[c] * exp2f(m[c] - M);
    const float inv_L = 1.f / fmaxf(L, 1e-30f);
    for (int c = 0; c < live; ++c) wts[tid * MLA_MAX_SPLITS + c] = exp2f(m[c] - M) * l[c] * inv_L;
  }
  __syncthreads();
  for (int e = rank * WG_THREADS + tid; e < WG_H * (MLA_R / 8); e += splits * WG_THREADS) {
    const int g = e / (MLA_R / 8);
    const int c8 = e - g * (MLA_R / 8);
    if (h0 + g >= H) break;  // a missing head of a partial block
    const float* w = wts + g * MLA_MAX_SPLITS;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      float v[8];
      Vec<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(
                                     cluster.map_shared_rank(part_o, c) + g * WG_ACC + 8 * c8),
                                 v);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] += v[u] * w[c];
    }
    uint32_t pk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __nv_bfloat162 h2 = __floats2bfloat162_rn(acc[2 * u], acc[2 * u + 1]);
      pk[u] = *reinterpret_cast<uint32_t*>(&h2);
    }
    *reinterpret_cast<uint4*>(orow + g * MLA_R + 8 * c8) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

template <class P, bool TMA>
int launch_mla_wgmma(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
                     void* o, const void* valid_len, const P& pol, const TmaMaps& maps, int B,
                     int H, long long sqlb, long long sqlh, long long sqrb, long long sqrh,
                     int limit, float scale, int splits, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  auto kernel = mla_decode_wgmma_kernel<P, TMA>;
  static unsigned opted_in = 0;
  int err = opt_in(kernel, wg_smem_bytes(), opted_in);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(splits, (H + WG_H - 1) / WG_H, B), WG_THREADS, wg_smem_bytes(), splits, stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf*>(q_lat),
                                     static_cast<const bf*>(q_rope), static_cast<const bf*>(ckv),
                                     static_cast<const bf*>(krope), static_cast<bf*>(o),
                                     static_cast<const int*>(valid_len), pol, maps, H, sqlb,
                                     sqlh, sqrb, sqrh, limit, scale, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda): a bf16 map of ``rank`` dims (innermost first), byte strides of
// the outer ones, boxes of ``box``, 128-byte swizzle, zeros out of bounds
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        p == nullptr)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Q's maps, when its base and (b, h) strides allow TMA (16-byte multiples)
int encode_q(TmaMaps& maps, const void* q_lat, const void* q_rope, int B, int H,
             long long sqlb, long long sqlh, long long sqrb, long long sqrh) {
  const long long a[6] = {(long long)reinterpret_cast<uintptr_t>(q_lat),
                          (long long)reinterpret_cast<uintptr_t>(q_rope), sqlb * 2, sqlh * 2,
                          sqrb * 2, sqrh * 2};
  maps.q_tma = 1;
  for (long long v : a) maps.q_tma &= v > 0 && v % 16 == 0;
  if (!maps.q_tma) return 0;
  const cuuint32_t box[3] = {64, WG_H, 1};
  const cuuint64_t ldims[3] = {MLA_R, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t lstr[2] = {(cuuint64_t)sqlh * 2, (cuuint64_t)sqlb * 2};
  const cuuint64_t rdims[3] = {MLA_DR, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t rstr[2] = {(cuuint64_t)sqrh * 2, (cuuint64_t)sqrb * 2};
  int err = encode_map(&maps.q_lat, q_lat, 3, ldims, lstr, box);
  if (!err) err = encode_map(&maps.q_rope, q_rope, 3, rdims, rstr, box);
  return err;
}

template <class P>
int launch_mla_any(int is_bf16, int B, int H, int r, int dr, const void* q_lat,
                   const void* q_rope, const void* ckv, const void* krope, void* o,
                   const void* valid_len, const P& pol, TmaMaps& maps, bool tma,
                   long long sqlb, long long sqlh, long long sqrb, long long sqrh, int limit,
                   float scale, int splits, cudaStream_t s) {
  if (r != MLA_R || dr != MLA_DR || H < MLA_HB || H % MLA_HB != 0 || splits < 1 ||
      splits > MLA_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const int err = encode_q(maps, q_lat, q_rope, B, H, sqlb, sqlh, sqrb, sqrh);
    if (err) return err;
#define MLA_WG(TM)                                                                        \
  return launch_mla_wgmma<P, TM>(q_lat, q_rope, ckv, krope, o, valid_len, pol, maps, B, H, \
                                 sqlb, sqlh, sqrb, sqrh, limit, scale, splits, s)
    if (tma) MLA_WG(true);
    if constexpr (!std::is_same<P, RingRows>::value) MLA_WG(false);  // the ring always takes TMA
#undef MLA_WG
    return (int)cudaErrorInvalidValue;
  }
  return launch_mla<float>(q_lat, q_rope, ckv, krope, o, valid_len, pol, B, H, sqlb, sqlh,
                           sqrb, sqrh, limit, scale, splits, s);
}

}  // namespace

// Ring: q_lat [B, 1, H, r] and q_rope [B, 1, H, dr] through strides (b, h),
// last dim contiguous; ckv [B, W, r] and krope [B, W, dr] through strides
// (b, w), last dim contiguous, rows 16-byte aligned; valid_len contiguous
// int32 [B] (clamped to W); o contiguous [B, 1, H, r]. r = 512, dr = 64, H a
// multiple of 16; ``splits``, the CTAs (one cluster) a (row, head block): 1
// to 8. Returns the cudaError_t of the launch (0 on success).
extern "C" int mla_decode_attention_fwd(const void* q_lat, const void* q_rope, const void* ckv,
                                        const void* krope, void* o, const void* valid_len,
                                        int B, int W, int H, int r, int dr, long long sqlb,
                                        long long sqlh, long long sqrb, long long sqrh,
                                        long long scb, long long scw, long long srb,
                                        long long srw, float scale, int is_bf16, int splits,
                                        void* stream) {
  const RingRows rows{scb, scw, 0, srb, srw, 0};
  TmaMaps maps = {};
  maps.rows = WG_TK;
  if (is_bf16 && r == MLA_R && dr == MLA_DR) {
    const cuuint32_t box[3] = {64, WG_TK, 1};
    const cuuint64_t cdims[3] = {MLA_R, (cuuint64_t)W, (cuuint64_t)B};
    const cuuint64_t cstr[2] = {(cuuint64_t)scw * 2, (cuuint64_t)scb * 2};
    const cuuint64_t rdims[3] = {MLA_DR, (cuuint64_t)W, (cuuint64_t)B};
    const cuuint64_t rstr[2] = {(cuuint64_t)srw * 2, (cuuint64_t)srb * 2};
    int err = encode_map(&maps.ckv, ckv, 3, cdims, cstr, box);
    if (!err) err = encode_map(&maps.krope, krope, 3, rdims, rstr, box);
    if (err) return err;
  }
  return launch_mla_any(is_bf16, B, H, r, dr, q_lat, q_rope, ckv, krope, o, valid_len,
                        rows, maps, true, sqlb, sqlh, sqrb, sqrh, W, scale, splits,
                        static_cast<cudaStream_t>(stream));
}

// Paged: as the ring, the latent pool ckv_blocks [N, page, r] and krope_blocks
// [N, page, dr] (a block's stride page times a row's, fewer than 2^31 rows)
// read through the contiguous int32 page table [B, n_pages] of in-range
// block ids; valid_len is clamped to n_pages * page. bf16 tiles arrive by
// TMA when a box fits the page (a multiple of 64, or 8, 16 or 32), else by
// cp.async.
extern "C" int paged_mla_decode_attention_fwd(
    const void* q_lat, const void* q_rope, const void* cb, const void* rb, void* o,
    const void* page_table, const void* valid_len, int B, int n_blocks, int n_pages, int page,
    int H, int r, int dr, long long sqlb, long long sqlh, long long sqrb, long long sqrh,
    long long scn, long long scp, long long srn, long long srp, float scale, int is_bf16,
    int splits, void* stream) {
  if (page < 1 || scn != page * scp || srn != page * srp) return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(page_table), n_pages, page, scp, 0, srp, 0};
  TmaMaps maps = {};
  const bool tma = page % WG_TK == 0 || (WG_TK % page == 0 && page >= 8);
  maps.rows = page < WG_TK ? page : WG_TK;
  if (is_bf16 && tma && r == MLA_R && dr == MLA_DR) {
    const cuuint32_t box[2] = {64, (cuuint32_t)maps.rows};
    const cuuint64_t cdims[2] = {MLA_R, (cuuint64_t)n_blocks * page};
    const cuuint64_t cstr[1] = {(cuuint64_t)scp * 2};
    const cuuint64_t rdims[2] = {MLA_DR, (cuuint64_t)n_blocks * page};
    const cuuint64_t rstr[1] = {(cuuint64_t)srp * 2};
    int err = encode_map(&maps.ckv, cb, 2, cdims, cstr, box);
    if (!err) err = encode_map(&maps.krope, rb, 2, rdims, rstr, box);
    if (err) return err;
  }
  return launch_mla_any(is_bf16, B, H, r, dr, q_lat, q_rope, cb, rb, o, valid_len,
                        rows, maps, tma, sqlb, sqlh, sqrb, sqrh, n_pages * page, scale, splits,
                        static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's cudaOccupancyMaxActiveClusters at ``splits`` CTAs a
// cluster into ``*n`` (every instantiation takes the same threads and
// shared memory). Returns the cudaError_t.
extern "C" int mla_decode_attention_clusters(int splits, int* n, void*) {
  if (splits < 1 || splits > MLA_MAX_SPLITS) return (int)cudaErrorInvalidValue;
  auto kernel = mla_decode_wgmma_kernel<RingRows, true>;
  static unsigned opted_in = 0;
  int err = opt_in(kernel, wg_smem_bytes(), opted_in);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(splits), WG_THREADS, wg_smem_bytes(), splits, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}
