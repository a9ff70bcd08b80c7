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
// moves about 19 MB (the valid latent rows once) and does 2 * 128 * 1,088
// FLOPs a row, about 240 FLOP a byte -- near the bf16 tensor cores' ridge
// (295), far above fp32 FMA's (20). This kernel runs on the CUDA cores in
// fp32, so it is bound by its FMAs, well above the least time of the work
// (about 5.6 us); a wgmma redesign (64 heads against a 64-key tile of 576)
// is later work.
//
// Design: the latent rows are loaded into shared memory once per block of
// 16 heads, so the cache is read H / 16 times (from L2 after the first),
// not once per head. Grid (splits, H / 16, B), clusters of (splits, 1, 1):
// a (row, head block) is a cluster of S CTAs (S a power of two up to 8,
// chosen by the launcher from the row length and the SM count), CTA r
// taking the r-th share of the row's 32-row tiles, as decode_split.cuh
// splits a row. 8 warps a CTA:
//   * the tiles: two stages in shared memory; while tile i is scored and
//     summed, tile i + 1 is in flight (cp.async, 16 bytes a copy, rows at
//     or past valid_len zero-filled and never resolved). Warp w stages
//     rows 4w..4w+3 of 576 elements (ckv then krope), rows 16 bytes past a
//     multiple of 128 bytes apart, so a quarter-warp's 16-byte reads of 8
//     rows hit 8 bank groups; row addresses come from decode_split.cuh's
//     RingRows / PagedRows (ckv through the K offsets, krope through the V
//     offsets), the paged page-table reads issued a tile ahead of the
//     copies that use them;
//   * the scores: lane j scores row j for heads 2w and 2w + 1 (q in
//     shared memory as fp32, read as broadcast float4s; four partial sums
//     a head, so eight FMA chains a thread), then warp w runs those two
//     heads' online softmax (m, l in fp32) over the tile and writes p and
//     the rescale into shared memory;
//   * the values: thread (g, c) = (tid / 64, tid % 64) owns heads 4g..4g+3
//     at 8 latent columns (bf16: c * 8..; fp32: c * 4.. and 256 + c * 4..),
//     32 fp32 accumulators, one 16-byte read of a tile row feeding 32 FMAs;
//   * the merge: each CTA's unnormalised partial (m, l, acc[16][512], acc
//     aliasing the dead tiles) is read by every CTA of the cluster through
//     distributed shared memory after a cluster barrier and merged by the
//     max/sum rule, CTA r writing its 1/S of the outputs: decode_split.cuh's
//     merge, no scratch in device memory, no atomics.
// Shared memory: 111.2 KiB (bf16), 183.2 KiB (fp32) a CTA.
#include "decode_split.cuh"
#include "wgmma_common.cuh"  // cp.async

namespace {

constexpr int MLA_R = 512;               // kv_lora_rank: scored and summed
constexpr int MLA_DR = 64;               // qk_rope_dim: scored only
constexpr int MLA_D = MLA_R + MLA_DR;    // the score width
constexpr int MLA_HB = 16;               // query heads a CTA
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

template <typename T, class P>
int launch_mla(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
               void* o, const void* valid_len, const P& pol, int B, int H, long long sqlb,
               long long sqlh, long long sqrb, long long sqrh, int limit, float scale,
               int splits, cudaStream_t stream) {
  constexpr size_t smem = mla_smem_bytes<T>();
  auto kernel = mla_decode_kernel<T, P>;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H / MLA_HB, B);
  cfg.blockDim = dim3(MLA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q_lat),
                           static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
                           static_cast<const T*>(krope), static_cast<T*>(o),
                           static_cast<const int*>(valid_len), pol, H, sqlb, sqlh, sqrb, sqrh,
                           limit, scale, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class P>
int launch_mla_any(int is_bf16, int B, int H, int r, int dr, const void* q_lat,
                   const void* q_rope, const void* ckv, const void* krope, void* o,
                   const void* valid_len, const P& pol, long long sqlb, long long sqlh,
                   long long sqrb, long long sqrh, int limit, float scale, int splits,
                   cudaStream_t s) {
  if (r != MLA_R || dr != MLA_DR || H < MLA_HB || H % MLA_HB != 0 || splits < 1 ||
      splits > MLA_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_mla<__nv_bfloat16>(q_lat, q_rope, ckv, krope, o, valid_len, pol, B, H, sqlb,
                                     sqlh, sqrb, sqrh, limit, scale, splits, s);
  return launch_mla<float>(q_lat, q_rope, ckv, krope, o, valid_len, pol, B, H, sqlb, sqlh,
                           sqrb, sqrh, limit, scale, splits, s);
}

}  // namespace

// Ring: q_lat [B, 1, H, r] and q_rope [B, 1, H, dr] through strides (b, h),
// last dim contiguous; ckv [B, W, r] and krope [B, W, dr] through strides
// (b, w), last dim contiguous, rows 16-byte aligned; valid_len contiguous
// int32 [B] (clamped to W); o contiguous [B, 1, H, r]. r = 512, dr = 64, H a
// multiple of 16; ``splits``, the CTAs (one cluster) a (row, head block), 1
// to 8. Returns the cudaError_t of the launch (0 on success).
extern "C" int mla_decode_attention_fwd(const void* q_lat, const void* q_rope, const void* ckv,
                                        const void* krope, void* o, const void* valid_len,
                                        int B, int W, int H, int r, int dr, long long sqlb,
                                        long long sqlh, long long sqrb, long long sqrh,
                                        long long scb, long long scw, long long srb,
                                        long long srw, float scale, int is_bf16, int splits,
                                        void* stream) {
  const RingRows rows{scb, scw, 0, srb, srw, 0};
  return launch_mla_any(is_bf16, B, H, r, dr, q_lat, q_rope, ckv, krope, o, valid_len, rows,
                        sqlb, sqlh, sqrb, sqrh, W, scale, splits,
                        static_cast<cudaStream_t>(stream));
}

// Paged: as the ring, the latent pool ckv_blocks [N, page, r] and krope_blocks
// [N, page, dr] (a block's stride page times a row's, fewer than 2^31 rows)
// read through the contiguous int32 page table [B, n_pages] of in-range
// block ids; valid_len is clamped to n_pages * page.
extern "C" int paged_mla_decode_attention_fwd(
    const void* q_lat, const void* q_rope, const void* cb, const void* rb, void* o,
    const void* page_table, const void* valid_len, int B, int n_pages, int page, int H, int r,
    int dr, long long sqlb, long long sqlh, long long sqrb, long long sqrh, long long scn,
    long long scp, long long srn, long long srp, float scale, int is_bf16, int splits,
    void* stream) {
  if (page < 1 || scn != page * scp || srn != page * srp) return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(page_table), n_pages, page, scp, 0, srp, 0};
  return launch_mla_any(is_bf16, B, H, r, dr, q_lat, q_rope, cb, rb, o, valid_len, rows, sqlb,
                        sqlh, sqrb, sqrh, n_pages * page, scale, splits,
                        static_cast<cudaStream_t>(stream));
}
