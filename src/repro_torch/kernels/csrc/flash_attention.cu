// Blocked flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bhsd (body _flash_kernel). It computes the same function:
// online-softmax attention with fp32 m/l/acc, GQA by reading KV head h / G,
// causal and sliding-window masks with whole-tile skipping, pad masks
// (sq_real / skv_real), optional packed-prefill segment ids (a query reads a
// key only when their ids match), NEG_INF = -1e30 masking and l floored at
// 1e-30 (a fully masked row writes zeros).
//
// Beyond the TPU kernel it takes an optional prior -- the dense K/V of a
// cached prefix [B, Pp, Hkv, hd] with prior_valid[b] keys valid in row b --
// for suffix prefill over reused pages. The JAX package computes that case in
// jnp (models/attention.py chunked_attention: prior columns valid below
// prior_valid[b] and visible to every query, suffix columns causal relative
// to the suffix, the window on absolute positions, query i at prior_valid[b]
// + i); the port's model calls this kernel on every prefill, so the kernel
// carries it. The KV sweep first walks the prior tiles below prior_valid[b]
// (from the window start, when there is a window), then the suffix tiles;
// with no prior the sweep is the plain one.
//
// What bounds it on this card: causal prefill does about 2*B*H*S^2*hd FLOPs
// against 2*B*S*(H+Hkv)*hd*sizeof(T) bytes, so at the main path's bf16
// shapes (B=8, H=32, Hkv=8, hd=128) the bytes bound the 256-token bucket and
// the bf16 tensor-core peak (989 TFLOP/s) the 1024-token one.
//
// bf16: both products on the tensor cores (flash_wgmma_kernel). It replaces
// a CUDA-core body that widened K/V tiles to fp32 in shared memory and ran
// both products as fp32 FMAs (about 16 TFLOP/s at the 1024 bucket). One CTA
// is one warpgroup (128 threads) owning 64 query rows, the M of wgmma:
//   * S = Q.K^T is wgmma.m64n64k16 over hd / 16 steps, Q and a 64-key K tile
//     both read from shared memory, both K-major as the model stores them
//     ([S, hd], hd contiguous), so nothing is transposed;
//   * O += P.V takes P from registers: the S accumulator fragment, rounded
//     to bf16 (as the Pallas kernel rounds P to the value dtype), is the
//     A-operand fragment of the next wgmma (FA3's register reuse); the V
//     tile is the MN-major B operand (the transpose bit of 16-bit wgmma);
//   * tiles sit in shared memory in the 128-byte swizzle (64-byte at hd 32)
//     that the wgmma descriptors name, one 64-element column block after
//     another, filled by cp.async 16-byte copies that read the model's
//     [B, S, H, hd] layout through its strides (no transpose or pad copy;
//     rows past the tensor's end are zero-filled);
//   * two K/V stages: tile i + 1 is in flight while tile i is computed;
//   * masks cost only where they bite: a tile wholly inside the causal,
//     window and pad region (and, with segment ids, with its keys and the
//     q-tile's rows all in one segment) skips per-element masking; a
//     boundary tile masks the S fragment. Causal, window and segment tiles
//     that no row reaches are never visited (below);
//   * under a causal mask the last q-tiles carry the most work, so they
//     launch first: q-tiles are the slowest grid dimension, in reverse.
//     With one query head a KV head (G = 1, MLA's prefill) no other head
//     reads a head's K/V, so its q-tiles run next to each other instead,
//     the heaviest first, and its K/V tiles stay in L2 across them.
// Shared memory: 5 tiles of 64 x hd bf16 (80 KiB at hd 128), 2 CTAs an SM.
//
// Packed prefill (segment ids): each segment id forms one contiguous run of a
// row, and the pad run (id -1) closes it, so no row of a q-tile sees a key
// before the run start of the tile's first row. The caller passes every
// row's run start (seg_start, int32 [B, S], built once per forward); both
// bodies start the key sweep at the tile holding seg_start[q0]. A packed
// row of T tokens then pays about the segments' own causal work (sum s^2 / 2
// pairs a head, plus up to a tile a segment) instead of T^2 / 2. A tile in
// the pad run starts at the pad run's start: pads attend to pads, as in the
// plain version.
//
// K and V head dims are template parameters apart: every dense head dim
// runs (hd, hd), and MLA's decompressed prefill runs (192, 128) -- q and k
// 128 nope + 64 rope, v 128 -- with scale 1 / sqrt(192) from the caller.
// At (192, 128) the bf16 body takes Q and K tiles three 128-byte column
// blocks wide (S = Q.K^T in 12 k-steps) and a V tile of two (P.V keeps N =
// 128); the fp32 body scores 192-wide K rows and sums 128-wide V rows.
// Shared memory at (192, 128), bf16: 105.5 KiB a CTA, still 2 CTAs an SM.
//
// Training: given a non-null lse, both bodies also write each row's
// log-sum-exp of its scaled scores (fp32 [B, H, Sq], natural units, +inf
// for a row that sees no key), from which flash_attention_bwd.cu recomputes
// P; a serving launch passes null and writes nothing more.
//
// fp32: the CUDA-core body (flash_fwd_kernel). wgmma takes fp32 inputs only
// as TF32, which keeps about three decimal digits; the fp32 path is held to
// 2e-5 of the plain version, so it stays on fp32 FMAs: 8 warps of 8 query
// rows, lane j scoring key j against all 8 rows from 32-key fp32 tiles.
#include <climits>
#include <cstdint>

#include "attn_common.cuh"
#include "wgmma_common.cuh"  // cp.async, wgmma and their descriptors

namespace {

constexpr int BQ = 64;
constexpr float LN2 = 0.6931471805599453f;
constexpr int FLASH_WARPS = 8;

// A row's log-sum-exp of its scaled scores, from its running max m and sum
// l in natural units: +inf for a row that saw no key, so that the
// backward's exp(s * scale - lse) is 0 there.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}
constexpr int FLASH_THREADS = FLASH_WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / FLASH_WARPS;

template <int HD, int HDV>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (BQ * HD + TILE_K * (HD + 1) + TILE_K * HDV) + sizeof(int) * TILE_K;
}

// HD: q and k's head dim; HDV: v's (and the output's)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(FLASH_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ q_seg,
                 const int* __restrict__ k_seg, const int* __restrict__ seg_start,
                 const T* __restrict__ pk,
                 const T* __restrict__ pv, const int* __restrict__ prior_valid, int Sq,
                 int Skv, int Pp, int H, int G, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb, long long svs,
                 long long svh, long long spkb, long long spks, long long spkh,
                 long long spvb, long long spvs, long long spvh, int causal, int window,
                 int sq_real, int skv_real, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [BQ][HD]
  float* ks = qs + BQ * HD;                   // [TILE_K][HD + 1]
  float* vs = ks + TILE_K * (HD + 1);         // [TILE_K][HDV]
  int* kseg_s = reinterpret_cast<int*>(vs + TILE_K * HDV);  // [TILE_K]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool segmented = q_seg != nullptr;

  const T* qbase = q + b * sqb + h * sqh;
  for (int e = tid; e < BQ * HD; e += FLASH_THREADS) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int qi = q0 + r;
    qs[e] = qi < Sq ? to_f32(qbase[qi * sqs + d]) : 0.f;
  }

  Rows<HDV, ROWS_PER_WARP> st;
  rows_init<HDV, ROWS_PER_WARP>(st);
  int qseg_r[ROWS_PER_WARP];
  const int row0 = warp * ROWS_PER_WARP;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qi = q0 + row0 + r;
    qseg_r[r] = (segmented && qi < Sq) ? q_seg[(long long)b * Sq + qi] : -2;
  }

  // The cached prefix first: row b's prior keys below pvalid, visible to every
  // query; query row qpos sits at absolute position pvalid + qpos.
  const int pvalid = prior_valid != nullptr ? max(0, min(prior_valid[b], Pp)) : 0;
  int p_begin = 0;
  if (window > 0) p_begin = max(0, pvalid + q0 - window + 1);
  p_begin = (p_begin / TILE_K) * TILE_K;
  const T* pkbase = pk + b * spkb + kvh * spkh;
  const T* pvbase = pv + b * spvb + kvh * spvh;
  for (int t0 = p_begin; t0 < pvalid; t0 += TILE_K) {
    __syncthreads();  // the previous tile is consumed (and the q tile staged)
    load_kv_tile<T, HD, FLASH_THREADS, HDV>(ks, vs, pkbase, pvbase, spks, spvs, t0, pvalid,
                                            tid);
    __syncthreads();

    const int kpos = t0 + lane;
    bool valid[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qpos = q0 + row0 + r;
      bool ok = kpos < pvalid && qpos < sq_real;
      if (window > 0) ok = ok && kpos > pvalid + qpos - window;
      valid[r] = ok;
    }
    rows_update<HD, ROWS_PER_WARP, HDV>(st, qs + row0 * HD, ks, vs, valid, ROWS_PER_WARP,
                                        scale, lane);
  }

  // Then the suffix: the KV tiles any row of this q-tile can reach.
  int kv_end = skv_real;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  if (seg_start != nullptr) kv_begin = max(kv_begin, seg_start[(long long)b * Sq + q0]);
  kv_begin = (kv_begin / TILE_K) * TILE_K;

  const T* kbase = k + b * skb + kvh * skh;
  const T* vbase = v + b * svb + kvh * svh;
  for (int t0 = kv_begin; t0 < kv_end; t0 += TILE_K) {
    __syncthreads();  // the previous tile is consumed (and the q tile staged)
    load_kv_tile<T, HD, FLASH_THREADS, HDV>(ks, vs, kbase, vbase, sks, svs, t0, Skv, tid);
    if (segmented && tid < TILE_K)
      kseg_s[tid] = (t0 + tid < Skv) ? k_seg[(long long)b * Skv + t0 + tid] : -3;
    __syncthreads();

    const int kpos = t0 + lane;
    bool valid[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qpos = q0 + row0 + r;
      bool ok = kpos < skv_real && qpos < sq_real;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (segmented) ok = ok && qseg_r[r] == kseg_s[lane];
      valid[r] = ok;
    }
    rows_update<HD, ROWS_PER_WARP, HDV>(st, qs + row0 * HD, ks, vs, valid, ROWS_PER_WARP,
                                        scale, lane);
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Sq + qpos] = row_lse(st.m[r], st.l[r]);
    T* orow = o + (((long long)b * Sq + qpos) * H + h) * HDV;
#pragma unroll
    for (int i = 0; i < HDV / 32; ++i) orow[lane + 32 * i] = from_f32<T>(st.acc[r][i] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_BQ = 64;        // query rows a CTA owns: wgmma's M
constexpr int WG_BK = WG_TILE_ROWS;  // keys a K/V tile holds
constexpr int WG_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD, int HDV>
constexpr size_t wg_smem_bytes() {
  // Q, then per stage K and V; then the key segment ids of each stage; plus
  // slack to align the tiles to the 1024-byte swizzle period
  return (size_t)(1 + WG_STAGES) * WgTile<HD>::BYTES + (size_t)WG_STAGES * WgTile<HDV>::BYTES +
         sizeof(int) * WG_STAGES * WG_BK + 1024;
}

// HD: q and k's head dim (the Q and K tiles); HDV: v's (the V tile and the
// output). SEG: the row carries segment ids (q_seg / k_seg non-null); its
// own instantiation, so unpacked prefill compiles no segment code at all
template <int HD, int HDV, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, const int* __restrict__ q_seg,
                   const int* __restrict__ k_seg,
                   const int* __restrict__ seg_start, const __nv_bfloat16* __restrict__ pk,
                   const __nv_bfloat16* __restrict__ pv,
                   const int* __restrict__ prior_valid, int Sq, int Skv, int Pp, int H, int G,
                   long long sqb, long long sqs, long long sqh, long long skb, long long sks,
                   long long skh, long long svb, long long svs, long long svh, long long spkb,
                   long long spks, long long spkh, long long spvb, long long spvs,
                   long long spvh, int causal, int window, int sq_real, int skv_real,
                   float scale) {
  using Tl = WgTile<HD>;   // Q and K tiles
  using Tv = WgTile<HDV>;  // V tiles
  constexpr uint32_t STAGE_BYTES = Tl::BYTES + Tv::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (sbase - raw);
  // K of stage s at sq_tile + Tl::BYTES + s * STAGE_BYTES, V after it
  const uint32_t sq_tile = sbase;
  int* kseg_s = reinterpret_cast<int*>(smem + Tl::BYTES + WG_STAGES * STAGE_BYTES);

  // q-tiles are the slowest grid dimension, the last (heaviest) first; at
  // G = 1 the fastest, a head's q-tiles next to each other
  const int nqt = (Sq + WG_BQ - 1) / WG_BQ;
  const int hb = gridDim.x / nqt;  // H * B
  const int qt = nqt - 1 - (G == 1 ? (int)blockIdx.x % nqt : (int)blockIdx.x / hb);
  const int rem = G == 1 ? (int)blockIdx.x / nqt : (int)blockIdx.x - (nqt - 1 - qt) * hb;
  const int h = rem % H;
  const int b = rem / H;
  const int kvh = h / G;
  const int q0 = qt * WG_BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  const int col0 = 2 * (lane & 3);                 // and columns 8 j + col0 (+1)
  constexpr bool segmented = SEG;

  // the Q tile; 16-byte copies when its rows allow them
  const __nv_bfloat16* qbase = q + b * sqb + h * sqh;
  const bool q_vec = ((reinterpret_cast<uintptr_t>(qbase) | (uintptr_t)(sqs * 2)) & 15) == 0;
  for (int e = tid; e < Tl::CHUNKS; e += WG_THREADS) {
    const int r = e / (HD / 8);
    const int ch = e - r * (HD / 8);
    const int qi = q0 + r;
    const __nv_bfloat16* src = qbase + (long long)min(qi, Sq - 1) * sqs + ch * 8;
    if (q_vec) {
      cp_async16(sq_tile + Tl::offset(r, ch), src, qi < Sq);
    } else {
      uint16_t w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        w[u] = qi < Sq ? reinterpret_cast<const uint16_t*>(src)[u] : (uint16_t)0;
      *reinterpret_cast<uint4*>(smem + Tl::offset(r, ch)) =
          make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                     w[6] | (w[7] << 16));
    }
  }

  // the tiles to sweep: the cached prefix first (keys below pvalid, from the
  // window start), then the suffix tiles any row of this q-tile can reach
  const int pvalid = prior_valid != nullptr ? max(0, min(prior_valid[b], Pp)) : 0;
  int p_begin = window > 0 ? max(0, pvalid + q0 - window + 1) : 0;
  p_begin = (p_begin / WG_BK) * WG_BK;
  const int n_prior = pvalid > p_begin ? (pvalid - p_begin + WG_BK - 1) / WG_BK : 0;
  int kv_end = skv_real;
  if (causal) kv_end = min(kv_end, q0 + WG_BQ);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  // packed rows: no key before the run start of the tile's first row. Key
  // tiles from full_from on may skip the mask as far as segments go: all of
  // them without segment ids; with them, when the tile's first and last
  // rows share a run (so every row of it is in that run, and under a causal
  // mask every key from its start up to the rows), those from the run start
  int full_from = segmented ? INT_MAX : 0;
  if (segmented && seg_start != nullptr) {
    const long long rb = (long long)b * Sq;
    const int run0 = seg_start[rb + q0];
    kv_begin = max(kv_begin, run0);
    if (causal && run0 == seg_start[rb + min(q0 + WG_BQ, Sq) - 1]) full_from = run0;
  }
  kv_begin = (kv_begin / WG_BK) * WG_BK;
  const int n_tiles = n_prior + (kv_end > kv_begin ? (kv_end - kv_begin + WG_BK - 1) / WG_BK : 0);

  const __nv_bfloat16* kb = k + b * skb + kvh * skh;
  const __nv_bfloat16* vb = v + b * svb + kvh * svh;
  const __nv_bfloat16* pkb = pk + b * spkb + kvh * spkh;
  const __nv_bfloat16* pvb = pv + b * spvb + kvh * spvh;

  auto issue = [&](int i, int stage) {
    const bool prior = i < n_prior;
    const int t0 = prior ? p_begin + i * WG_BK : kv_begin + (i - n_prior) * WG_BK;
    const int n = prior ? pvalid : Skv;
    const __nv_bfloat16* kt = prior ? pkb : kb;
    const __nv_bfloat16* vt = prior ? pvb : vb;
    const long long ks = prior ? spks : sks;
    const long long vs = prior ? spvs : svs;
    const uint32_t kd = sq_tile + Tl::BYTES + stage * STAGE_BYTES;
    const uint32_t vd = kd + Tl::BYTES;
    constexpr int KPER = Tl::CHUNKS / WG_THREADS, VPER = Tv::CHUNKS / WG_THREADS;
#pragma unroll
    for (int u = 0; u < (KPER > VPER ? KPER : VPER); ++u) {
      const int e = tid + u * WG_THREADS;
      if (u < KPER) {
        const int r = e / (HD / 8);
        const int ch = e - r * (HD / 8);
        const int row = t0 + r;
        const bool ok = row < n;
        cp_async16(kd + Tl::offset(r, ch), kt + (ok ? row : 0) * ks + ch * 8, ok);
      }
      if (u < VPER) {
        const int r = e / (HDV / 8);
        const int ch = e - r * (HDV / 8);
        const int row = t0 + r;
        const bool ok = row < n;
        cp_async16(vd + Tv::offset(r, ch), vt + (ok ? row : 0) * vs + ch * 8, ok);
      }
    }
    if (segmented && !prior && tid < WG_BK)
      kseg_s[stage * WG_BK + tid] = t0 + tid < Skv ? k_seg[(long long)b * Skv + t0 + tid] : -3;
  };

  int qseg[2] = {-2, -2};
  if (segmented) {
    if (row_a < Sq) qseg[0] = q_seg[(long long)b * Sq + row_a];
    if (row_a + 8 < Sq) qseg[1] = q_seg[(long long)b * Sq + row_a + 8];
  }

  float oacc[Tv::NPV][Tv::PVN / 2];
#pragma unroll
  for (int n = 0; n < Tv::NPV; ++n)
#pragma unroll
    for (int i = 0; i < Tv::PVN / 2; ++i) oacc[n][i] = 0.f;
  float m_run[2] = {NEG_INF_F, NEG_INF_F};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  const float scale_log2 = scale * LOG2E;

  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();  // with the Q tile
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile i (and Q) landed, tile i + 1 in flight
    fence_async_shared();
    __syncthreads();

    const uint32_t kd = sq_tile + Tl::BYTES + stage * STAGE_BYTES;
    const uint32_t vd = kd + Tl::BYTES;
    // S = Q . K^T over hd / 16 steps of 32 bytes along a row
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk * 32 / Tl::RB) * (WG_BK * Tl::RB) + (kk * 32) % Tl::RB;
      wgmma_ss_n64(s, wg_desc(sq_tile + off, 16, 8 * Tl::RB, Tl::LAYOUT),
                   wg_desc(kd + off, 16, 8 * Tl::RB, Tl::LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scores in the log2 domain; masked entries -> NEG_INF_F where the tile
    // is not wholly inside the visible region
    const bool prior = i < n_prior;
    const int t0 = prior ? p_begin + i * WG_BK : kv_begin + (i - n_prior) * WG_BK;
    bool full;
    if (prior)
      full = t0 + WG_BK <= pvalid && (window <= 0 || t0 > pvalid + q0 + WG_BQ - 1 - window);
    else
      full = t0 >= full_from && t0 + WG_BK <= skv_real && (!causal || t0 + WG_BK - 1 <= q0) &&
             (window <= 0 || t0 > q0 + WG_BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
    if (!full) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;  // fragment element j: row row_a + 8 r
        const int qpos = row_a + 8 * r;
        const int kcol = 8 * (j >> 2) + col0 + (j & 1);
        const int kpos = t0 + kcol;
        bool ok;
        if (prior) {
          ok = kpos < pvalid && (window <= 0 || kpos > pvalid + qpos - window);
        } else {
          ok = kpos < skv_real && (!causal || qpos >= kpos) &&
               (window <= 0 || kpos > qpos - window) &&
               (!segmented || qseg[r] == kseg_s[stage * WG_BK + kcol]);
        }
        if (!ok) s[j] = NEG_INF_F;
      }
    }

    // online softmax of the two rows; a row's 64 scores lie on 4 lanes
    float corr[2];
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
      // with no visible key yet, masked scores must still give 0
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
#pragma unroll
    for (int n = 0; n < Tv::NPV; ++n)
#pragma unroll
      for (int i2 = 0; i2 < Tv::PVN / 2; ++i2) oacc[n][i2] *= corr[(i2 >> 1) & 1];

    // O += P . V: P's bf16 A fragments straight from the S fragment
#pragma unroll
    for (int n = 0; n < Tv::NPV; ++n) fence_regs(oacc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        __nv_bfloat162 p2 = __floats2bfloat162_rn(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
        a[u] = *reinterpret_cast<uint32_t*>(&p2);
      }
#pragma unroll
      for (int n = 0; n < Tv::NPV; ++n) {
        const uint64_t dv = wg_desc(vd + n * (WG_BK * Tv::RB) + kk * 16 * Tv::RB, 8 * Tv::RB,
                                    8 * Tv::RB, Tv::LAYOUT);
        if constexpr (Tv::PVN == 64)
          wgmma_rs_n64(oacc[n], a, dv);
        else
          wgmma_rs_n32(oacc[n], a, dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < Tv::NPV; ++n) fence_regs(oacc[n]);
    __syncthreads();  // this stage is free for tile i + 2
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the row sums over the 4 lanes of a row, then the normalised rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(FULL_MASK, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(FULL_MASK, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row_a + 8 * r;
    if (qpos >= Sq) continue;
    // rows at or past sq_real see no key: zeros, as a fully masked row
    const bool live = qpos < sq_real;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + h) * Sq + qpos] =
          live ? row_lse(m_run[r] * LN2, l_run[r]) : __int_as_float(0x7f800000);
    __nv_bfloat16* orow = o + (((long long)b * Sq + qpos) * H + h) * HDV;
#pragma unroll
    for (int n = 0; n < Tv::NPV; ++n)
#pragma unroll
      for (int j = 0; j < Tv::PVN / 8; ++j) {
        const __nv_bfloat162 w =
            live ? __floats2bfloat162_rn(oacc[n][4 * j + 2 * r] * inv,
                                         oacc[n][4 * j + 2 * r + 1] * inv)
                 : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * Tv::PVN + 8 * j + col0) = w;
      }
  }
}

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* q_seg,
                 const void* k_seg, const void* seg_start, const void* pk, const void* pv,
                 const void* prior_valid, int B, int Sq, int Skv, int Pp, int H, int Hkv,
                 long long sqb, long long sqs, long long sqh, long long skb, long long sks,
                 long long skh, long long svb, long long svs, long long svh, long long spkb,
                 long long spks, long long spkh, long long spvb, long long spvs, long long spvh,
                 int causal, int window, int sq_real, int skv_real, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<HD, HDV>();
  auto kernel = q_seg != nullptr ? flash_wgmma_kernel<HD, HDV, true>
                                 : flash_wgmma_kernel<HD, HDV, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int nqt = (Sq + WG_BQ - 1) / WG_BQ;
  kernel<<<nqt * H * B, WG_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(o), static_cast<float*>(lse), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg),
      static_cast<const int*>(seg_start), static_cast<const bf*>(pk), static_cast<const bf*>(pv),
      static_cast<const int*>(prior_valid), Sq, Skv, Pp, H, H / Hkv, sqb, sqs, sqh, skb, sks,
      skh, svb, svs, svh, spkb, spks, spkh, spvb, spvs, spvh, causal, window, sq_real,
      skv_real, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* q_seg,
           const void* k_seg, const void* seg_start, const void* pk, const void* pv,
           const void* prior_valid, int B, int Sq, int Skv, int Pp, int H, int Hkv,
           long long sqb, long long sqs, long long sqh, long long skb, long long sks,
           long long skh, long long svb, long long svs, long long svh, long long spkb,
           long long spks, long long spkh, long long spvb, long long spvs, long long spvh,
           int causal, int window, int sq_real, int skv_real, float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD, HDV>();
  auto kernel = flash_fwd_kernel<T, HD, HDV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, FLASH_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg),
      static_cast<const int*>(seg_start), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const int*>(prior_valid), Sq, Skv, Pp, H, H / Hkv, sqb, sqs, sqh, skb, sks,
      skh, svb, svs, svh, spkb, spks, spkh, spvb, spvs, spvh, causal, window, sq_real,
      skv_real, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// lse: contiguous fp32 [B, H, Sq], each row's log-sum-exp of its scaled
// scores (+inf where the row sees no key), or null: written only when
// given (a training forward keeps it for csrc/flash_attention_bwd.cu; a
// serving launch passes null and writes nothing more than before).
// q: [B, Sq, H, hd], k: [B, Skv, Hkv, hd], v: [B, Skv, Hkv, hdv] and pk/pv:
// [B, Pp, Hkv, hd] addressed through the given element strides (last dim
// contiguous); o: contiguous [B, Sq, H, hdv]. hdv == hd in {32, 64, 128},
// or (hd, hdv) = (192, 128), MLA's prefill, which takes no prior and no
// segment ids. q_seg / k_seg: contiguous int32 [B, Sq] /
// [B, Skv], or both null; seg_start: contiguous int32 [B, Sq], each row's
// run start (see above), or null (no tile skipped by segment, none taken
// unmasked). prior_valid: contiguous int32 [B], or null with
// no prior (pk / pv are then not read). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const void* q_seg, const void* k_seg,
                                   const void* seg_start, const void* pk,
                                   const void* pv, const void* prior_valid, int B, int Sq,
                                   int Skv, int Pp, int H, int Hkv, int hd, int hdv,
                                   long long sqb, long long sqs, long long sqh, long long skb,
                                   long long sks, long long skh, long long svb, long long svs,
                                   long long svh, long long spkb, long long spks,
                                   long long spkh, long long spvb, long long spvs,
                                   long long spvh, int causal, int window, int sq_real,
                                   int skv_real, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                                           \
  q, k, v, o, lse, q_seg, k_seg, seg_start, pk, pv, prior_valid, B, Sq, Skv, Pp, H, Hkv, sqb, sqs, \
      sqh, skb, sks, skh, svb, svs, svh, spkb, spks, spkh, spvb, spvs, spvh, causal, window,  \
      sq_real, skv_real, scale, s
  if (hdv != hd) {
    if (hd != 192 || hdv != 128 || q_seg != nullptr || prior_valid != nullptr)
      return (int)cudaErrorInvalidValue;
    return is_bf16 ? launch_wgmma<192, 128>(FLASH_ARGS) : launch<float, 192, 128>(FLASH_ARGS);
  }
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return launch_wgmma<HD, HD>(FLASH_ARGS))
  } else {
    DISPATCH_HD(hd, HD, return (launch<float, HD, HD>(FLASH_ARGS)))
  }
#undef FLASH_ARGS
  return 0;
}
