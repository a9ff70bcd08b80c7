// Flash-attention backward, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// jnp attention (src/repro/models/attention.py), and its Pallas forward
// (src/repro/kernels/flash_attention.py: flash_attention_bhsd) has no VJP.
// The port's forward on the card is the hand-written kernel of
// flash_attention.cu, whose output carries no autograd graph, so its
// gradient is a kernel too: ops.flash_attention's autograd Function calls
// this file's entry point with the forward's output O and the log-sum-exp
// it saved (lse, fp32 [B, H, Sq]).
//
// It computes, per (b, query head h, kv head h / G):
//   P  = exp(Q K^T * scale - lse)   (0 where masked)
//   D  = rowsum(dO o O)
//   dV = sum over the G query heads of P^T dO
//   dS = P o (dO V^T - D)
//   dK = scale * sum over the G heads of dS^T Q,   dQ = scale * dS K
// under every mask the forward takes but segment ids and a prior: causal
// (query i sees key j <= i, absolute indices, as the forward), the window
// (j > i - window), the pads (rows at or past sq_real, keys at or past
// skv_real), Sq != Skv (cross-attention), any G, hd 32 / 64 / 128 and MLA's
// (q/k 192, v 128). A row that sees no key has lse = +inf and P = 0, so its
// gradients are zero.
//
// Nothing is atomic, and every sum runs in a fixed order, so two calls give
// the same bits. Three launches:
//   1. flash_bwd_dot_kernel: D, one warp a row;
//   2. dK/dV: one CTA per (64-key tile, kv head, batch row) walks the G query
//      heads of its kv head and the 64-row q-tiles that reach its keys,
//      recomputes S and dO V^T, and accumulates dK and dV in registers; it
//      writes them once, so the GQA sum needs no atomics;
//   3. dQ: one CTA per (64-row q-tile, query head, batch row) over the key
//      tiles its rows reach, recomputing S and dO V^T, accumulating dQ in
//      registers; the last (under a causal mask the heaviest) q-tiles first.
// Together they do seven products of a (q-tile, key-tile) pair where the
// function needs five (S and dO V^T are recomputed in the dQ kernel): the
// price of writing dQ without fp32 atomics, whose order would change the
// bits from call to call.
//
// What bounds it on this card: operations. At the training shape (B 2, S
// 4096, H 32, Hkv 8, hd 128, causal) the five products are about
// 5 B H S^2 hd = 0.69 TFLOP against 0.3 GB moved, 0.695 ms at the bf16
// tensor-core peak; the seven executed, 0.97 ms.
//
// bf16: every product on the tensor cores (flash_bwd_dkdv_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel), built from the forward's pieces
// (wgmma_common.cuh: the swizzled WgTile, cp.async staging through the
// model's strides, the m64n64k16 products, the accumulator fragment reused
// as a register A operand). One CTA is one warpgroup owning 64 rows, the M
// of wgmma:
//   * dK/dV: the CTA's keys are M. S^T = K.Q^T and dP^T = V.dO^T are
//     shared-memory products over hd, K and Q (V and dO) both K-major as
//     the model stores them, so nothing is transposed. P^T and dS^T are
//     formed in the accumulator fragment, whose column is the q row (lse
//     and D are read per column); rounded to bf16 they are the A fragments
//     of dV += P^T.dO and dK += dS^T.Q, whose B (dO, Q) is the MN-major
//     tile (the transpose bit), as the forward's P.V. What bounds the body
//     is registers: dK and dV take 64 + 64 fp32 registers a thread at hd
//     128, and a 64-row S^T and dP^T 32 + 32 more, which spilled past the
//     255-register limit. So each q-tile is taken in two halves of 32 rows
//     (m64n32 for S^T and dP^T, 16 registers each; each half's P^T and dS^T
//     feed two k-steps of dV and dK, in flight while the next half's S^T
//     and dP^T are computed): 244 registers, no spill, under
//     __launch_bounds__(128, 1), two CTAs an SM by registers and by shared
//     memory. The Q, dO, lse and D of q-tile i + 1 are in flight while tile
//     i computes (two stages);
//   * dQ: the CTA's q rows are M. S = Q.K^T and dP = dO.V^T as the forward's
//     S; dQ += dS.K takes dS from registers and the K tile MN-major; K and V
//     tiles in two stages;
//   * masks cost only on boundary tiles, as in the forward; scale multiplies
//     dK and dQ in fp32 at the store.
// Numerics: P and dS are rounded to bf16 as wgmma operands (as the forward
// rounds P for P.V); every sum is fp32; the gradients are rounded once, at
// the store. Shared memory at hd 128: 98 KiB a CTA (dK/dV), 97 KiB (dQ).
//
// fp32: the CUDA-core body (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel).
// wgmma takes fp32 only as TF32; the fp32 path serves the card-vs-CPU
// gradient gate at 1e-4, so it stays on fp32 FMAs: each product is a
// register-tiled shared-memory GEMM (a thread owns a 4 x 4 tile of S or a
// 4-key x hd/16-dim tile of dK / dV / dQ, operands read as 16-byte vectors
// from fp32 tiles whose rows are padded by 4 floats).
//
// MLA's head dims (192, 128): q and k at 192, v, dO and O at 128 (D sums
// over 128). The bf16 dK/dV plan above holds dK and dV in 128 + 128 fp32
// columns; a 64 x 192 dK beside dV's 128 would take 96 + 64 accumulator
// registers and spill. So dK is taken in two passes over the q-walk, as two
// launches of the same body (template parameters DKB0, NDKB, WITH_DV): the
// first writes dV and dK's column blocks 0-1 (the dense plan's registers,
// S^T over 192), the second recomputes S^T and dP^T and writes dK's block 2
// (64 columns) alone. That repeats two of the four products of a (q-tile,
// key-tile) pair in the second pass: the price of no spill. dQ keeps its 64
// x 192 accumulator (96 registers) in one CTA and takes each key tile in two
// halves of 32 keys (S, dP and dS at 16 registers each, each half's dS two
// k-steps of dQ), as dK/dV takes its q-tile: with 64-key S and dP beside
// it, it spilled at the 255 registers of two CTAs an SM. The fp32 body runs (192, 128) with its own shared
// memory: K and Q tiles 196 floats a row, V and dO 132, 198.5 KiB (dK/dV)
// and 181.5 KiB (dQ) a CTA.
//
// Left: a fused dQ (five products, not seven) needs a deterministic
// cross-CTA sum.
#include <cstdint>

#include "attn_common.cuh"
#include "wgmma_common.cuh"  // cp.async, wgmma, their descriptors, WgTile

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BR = 64;  // q rows of a tile
constexpr int BC = 64;  // keys of a tile
constexpr int PAD = 4;  // floats a tile row is padded by
constexpr int RS = 4;   // rows (and keys) a thread owns of an S tile
constexpr int RA = 4;   // rows of dK / dV / dQ a thread owns

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Whether query i sees key j.
__device__ __forceinline__ bool visible(int i, int j, int causal, int window, int sq_real,
                                        int skv_real) {
  return i < sq_real && j < skv_real && (!causal || i >= j) && (window <= 0 || j > i - window);
}

// Whether every query of rows q0 .. q0 + 63 sees every key of k0 .. k0 + 63.
__device__ __forceinline__ bool tile_full(int q0, int k0, int causal, int window, int sq_real,
                                          int skv_real) {
  return q0 + 64 <= sq_real && k0 + 64 <= skv_real && (!causal || k0 + 63 <= q0) &&
         (window <= 0 || k0 > q0 + 63 - window);
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] (fp32), one warp a row.
template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
                     int B, int Sq, int H, long long sob, long long sos, long long soh,
                     long long sdb, long long sds, long long sdh) {
  const long long row = (long long)blockIdx.x * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * H * Sq) return;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const int b = (int)(row / ((long long)Sq * H));
  const T* orow = o + b * sob + i * sos + h * soh;
  const T* drow = dout + b * sdb + i * sds + h * sdh;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < HD / 32; ++u)
    acc = fmaf(to_f32(orow[lane + 32 * u]), to_f32(drow[lane + 32 * u]), acc);
  acc = warp_sum(acc);
  if (lane == 0) dsum[row] = acc;  // row == (b * H + h) * Sq + i
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// Rows t0 .. t0 + 63 of a [*, HD] tensor (rows ``stride_row`` elements
// apart, 16-byte aligned) into an fp32 tile of 64 rows HD + PAD apart;
// rows at or past n become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long stride_row,
                                          int t0, int n, int tid) {
  load_rows<float, HD, BWD_THREADS, HD + PAD>(dst, base, stride_row, t0, n, tid);
  load_rows<float, HD, BWD_THREADS, HD + PAD>(dst + TILE_K * (HD + PAD), base, stride_row,
                                              t0 + TILE_K, n, tid);
}

// acc[r][c] += A[rows tm + 16 r] . B[rows tn + 16 c] over HD, both tiles
// HD + PAD apart (an S-shaped product, NT: both operands HD-contiguous).
template <int HD>
__device__ __forceinline__ void mm_nt(float (&acc)[RS][RS], const float* a, const float* b, int tm,
                                      int tn) {
  constexpr int LD = HD + PAD;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[RS], bv[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (tm + 16 * r) * LD + d);
#pragma unroll
    for (int c = 0; c < RS; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tn + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int c = 0; c < RS; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
      }
  }
}

// acc[r][u] += sum over 64 rows i of A[i][m0 + r] * B[i][d0 + u] (TN: A is
// [64][LDA], its columns m0 .. m0 + 3 a thread's; B is [64][HD + PAD], its
// columns d0 .. d0 + HD / 16 - 1 a thread's).
template <int HD, int LDA>
__device__ __forceinline__ void mm_tn(float (&acc)[RA][HD / 16], const float* a, const float* b,
                                      int m0, int d0) {
  constexpr int DU = HD / 16;
  constexpr int LDB = HD + PAD;
#pragma unroll 4
  for (int i = 0; i < 64; ++i) {
    const float4 av = *reinterpret_cast<const float4*>(a + i * LDA + m0);
    float bv[DU];
#pragma unroll
    for (int u = 0; u < DU; u += 2) {
      const float2 t = *reinterpret_cast<const float2*>(b + i * LDB + d0 + u);
      bv[u] = t.x;
      bv[u + 1] = t.y;
    }
    const float ar[RA] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int u = 0; u < DU; ++u) acc[r][u] = fmaf(ar[r], bv[u], acc[r][u]);
  }
}

template <int HD, int HDV>
constexpr size_t dkdv_smem_bytes() {
  // K, Q tiles (HD); V, dO tiles (HDV); P and dS tiles; lse and D of the
  // q-tile: 198.5 KiB at (192, 128)
  return sizeof(float) *
         (2 * 64 * (HD + PAD) + 2 * 64 * (HDV + PAD) + 2 * BR * (BC + PAD) + 2 * BR);
}

// HD: q and k's head dim (Q, K, dK); HDV: v's (V, dO, dV)
template <int HD, int HDV>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                      int G, long long sqb, long long sqs, long long sqh, long long skb,
                      long long sks, long long skh, long long svb, long long svs,
                      long long svh, long long sdb, long long sds, long long sdh, int causal,
                      int window, int sq_real, int skv_real, float scale) {
  constexpr int LD = HD + PAD;
  constexpr int LDV = HDV + PAD;
  constexpr int LP = BC + PAD;
  constexpr int DU = HD / 16;
  constexpr int DUV = HDV / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [BC][LD]
  float* vs = ks + 64 * LD;    // [BC][LDV]
  float* qs = vs + 64 * LDV;   // [BR][LD]
  float* dos = qs + 64 * LD;   // [BR][LDV]
  float* ps = dos + 64 * LDV;  // [BR][LP]: P
  float* dss = ps + BR * LP;   // [BR][LP]: dS
  float* lse_s = dss + BR * LP;
  float* d_s = lse_s + BR;

  const int k0 = blockIdx.x * BC;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = H / G;
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;        // S tile: rows tm + 16 r, keys tn + 16 c
  // dK / dV: keys m0 .., dims d0 .. (dK) and dv0 .. (dV)
  const int m0 = (tid & 15) * RA, d0 = (tid >> 4) * DU, dv0 = (tid >> 4) * DUV;

  load_tile<HD>(ks, k + b * skb + kvh * skh, sks, k0, Skv, tid);
  load_tile<HDV>(vs, v + b * svb + kvh * svh, svs, k0, Skv, tid);

  float dk_acc[RA][DU], dv_acc[RA][DUV];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
#pragma unroll
    for (int u = 0; u < DU; ++u) dk_acc[r][u] = 0.f;
#pragma unroll
    for (int u = 0; u < DUV; ++u) dv_acc[r][u] = 0.f;
  }

  // the q rows that see any key of this tile
  int q_begin = causal ? k0 : 0;
  int q_end = sq_real;
  if (window > 0) q_end = min(q_end, k0 + BC - 1 + window);
  if (k0 >= skv_real) q_end = 0;
  q_begin = (q_begin / BR) * BR;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    for (int q0 = q_begin; q0 < q_end; q0 += BR) {
      __syncthreads();  // the previous tile's reads are done (and K, V staged)
      load_tile<HD>(qs, q + b * sqb + h * sqh, sqs, q0, Sq, tid);
      load_tile<HDV>(dos, dout + b * sdb + h * sdh, sds, q0, Sq, tid);
      if (tid < BR) {
        const int i = q0 + tid;
        const long long at = ((long long)b * H + h) * Sq + i;
        lse_s[tid] = i < Sq ? lse[at] : inf_f();
        d_s[tid] = i < Sq ? dsum[at] : 0.f;
      }
      __syncthreads();

      float s[RS][RS], dp[RS][RS];
#pragma unroll
      for (int r = 0; r < RS; ++r)
#pragma unroll
        for (int c = 0; c < RS; ++c) s[r][c] = dp[r][c] = 0.f;
      mm_nt<HD>(s, qs, ks, tm, tn);
      mm_nt<HDV>(dp, dos, vs, tm, tn);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int il = tm + 16 * r;
        const float l = lse_s[il], dd = d_s[il];
#pragma unroll
        for (int c = 0; c < RS; ++c) {
          const int jl = tn + 16 * c;
          const bool ok = visible(q0 + il, k0 + jl, causal, window, sq_real, skv_real);
          const float p = ok ? expf(s[r][c] * scale - l) : 0.f;
          ps[il * LP + jl] = p;
          dss[il * LP + jl] = p * (dp[r][c] - dd);
        }
      }
      __syncthreads();
      mm_tn<HDV, LP>(dv_acc, ps, dos, m0, dv0);
      mm_tn<HD, LP>(dk_acc, dss, qs, m0, d0);
    }
  }

  // dk, dv: contiguous [B, Skv, Hkv, HD] and [B, Skv, Hkv, HDV]
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int j = k0 + m0 + r;
    if (j >= Skv) continue;
    const long long row = (long long)b * Skv + j;
    float* dkr = dk + (row * Hkv + kvh) * HD + d0;
    float* dvr = dv + (row * Hkv + kvh) * HDV + dv0;
#pragma unroll
    for (int u = 0; u < DU; ++u) dkr[u] = dk_acc[r][u] * scale;
#pragma unroll
    for (int u = 0; u < DUV; ++u) dvr[u] = dv_acc[r][u];
  }
}

template <int HD, int HDV>
constexpr size_t dq_smem_bytes() {
  // Q, K tiles (HD); dO, V tiles (HDV); dS^T; lse and D of the q-tile
  return sizeof(float) * (2 * 64 * (HD + PAD) + 2 * 64 * (HDV + PAD) + BC * (BR + PAD) + 2 * BR);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dq, int Sq, int Skv, int H, int G, long long sqb,
                    long long sqs, long long sqh, long long skb, long long sks, long long skh,
                    long long svb, long long svs, long long svh, long long sdb, long long sds,
                    long long sdh, int causal, int window, int sq_real, int skv_real,
                    float scale) {
  constexpr int LD = HD + PAD;
  constexpr int LDV = HDV + PAD;
  constexpr int LT = BR + PAD;
  constexpr int DU = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BR][LD]
  float* dos = qs + 64 * LD;   // [BR][LDV]
  float* ks = dos + 64 * LDV;  // [BC][LD]
  float* vs = ks + 64 * LD;    // [BC][LDV]
  float* dst = vs + 64 * LDV;  // [BC][LT]: dS^T
  float* lse_s = dst + BC * LT;
  float* d_s = lse_s + BR;

  // under a causal mask the last q-tiles carry the most work: they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
  const int m0 = (tid & 15) * RA, d0 = (tid >> 4) * DU;  // dQ: rows m0 .., dims d0 ..

  load_tile<HD>(qs, q + b * sqb + h * sqh, sqs, q0, Sq, tid);
  load_tile<HDV>(dos, dout + b * sdb + h * sdh, sds, q0, Sq, tid);
  if (tid < BR) {
    const int i = q0 + tid;
    const long long at = ((long long)b * H + h) * Sq + i;
    lse_s[tid] = i < Sq ? lse[at] : inf_f();
    d_s[tid] = i < Sq ? dsum[at] : 0.f;
  }

  float dq_acc[RA][DU];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int u = 0; u < DU; ++u) dq_acc[r][u] = 0.f;

  // the key tiles any row of this q-tile sees
  int kv_end = skv_real;
  if (causal) kv_end = min(kv_end, q0 + BR);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  if (q0 >= sq_real) kv_end = 0;
  kv_begin = (kv_begin / BC) * BC;

  const float* kb = k + b * skb + kvh * skh;
  const float* vb = v + b * svb + kvh * svh;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BC) {
    __syncthreads();  // the previous tile's reads are done (and Q, dO staged)
    load_tile<HD>(ks, kb, sks, k0, Skv, tid);
    load_tile<HDV>(vs, vb, svs, k0, Skv, tid);
    __syncthreads();

    float s[RS][RS], dp[RS][RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int c = 0; c < RS; ++c) s[r][c] = dp[r][c] = 0.f;
    mm_nt<HD>(s, qs, ks, tm, tn);
    mm_nt<HDV>(dp, dos, vs, tm, tn);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int il = tm + 16 * r;
      const float l = lse_s[il], dd = d_s[il];
#pragma unroll
      for (int c = 0; c < RS; ++c) {
        const int jl = tn + 16 * c;
        const bool ok = visible(q0 + il, k0 + jl, causal, window, sq_real, skv_real);
        const float p = ok ? expf(s[r][c] * scale - l) : 0.f;
        dst[jl * LT + il] = p * (dp[r][c] - dd);
      }
    }
    __syncthreads();
    mm_tn<HD, LT>(dq_acc, dst, ks, m0, d0);
  }

  const long long hrow = (long long)H * HD;  // dq: contiguous [B, Sq, H, HD]
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = q0 + m0 + r;
    if (i >= Sq) continue;
    float* dqr = dq + ((long long)b * Sq + i) * hrow + (long long)h * HD + d0;
#pragma unroll
    for (int u = 0; u < DU; ++u) dqr[u] = dq_acc[r][u] * scale;
  }
}

template <int HD, int HDV>
int launch_fp32(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* dq, void* dk, void* dv, void* dsum, int B, int Sq,
                int Skv, int H, int Hkv, long long sqb, long long sqs, long long sqh,
                long long skb, long long sks, long long skh, long long svb, long long svs,
                long long svh, long long sob, long long sos, long long soh, long long sdb,
                long long sds, long long sdh, int causal, int window, int sq_real,
                int skv_real, float scale, cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dt = static_cast<const float*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const int G = H / Hkv;

  const long long rows = (long long)B * H * Sq;
  const int per = BWD_THREADS / 32;
  flash_bwd_dot_kernel<float, HDV><<<(unsigned)((rows + per - 1) / per), BWD_THREADS, 0,
                                     stream>>>(static_cast<const float*>(o), dt, ds, B, Sq, H,
                                               sob, sos, soh, sdb, sds, sdh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s1 = dkdv_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD, HDV><<<dim3((Skv + BC - 1) / BC, Hkv, B), BWD_THREADS, s1, stream>>>(
      qt, kt, vt, dt, lt, ds, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, G,
      sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, causal, window, sq_real,
      skv_real, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s2 = dq_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD, HDV><<<dim3((Sq + BR - 1) / BR, H, B), BWD_THREADS, s2, stream>>>(
      qt, kt, vt, dt, lt, ds, static_cast<float*>(dq), Sq, Skv, H, G, sqb, sqs, sqh, skb, sks,
      skh, svb, svs, svh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_M = WG_TILE_ROWS;  // keys (dK/dV) or q rows (dQ) a CTA owns
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Rows t0 .. t0 + 63 of a [*, HD] bf16 tensor (rows ``stride`` elements
// apart, 16-byte aligned) into the WgTile at ``dst``, by cp.async; rows at
// or past n become zeros.
template <int HD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* base, long long stride,
                                          int t0, int n, int tid) {
  using Tt = WgTile<HD>;
#pragma unroll
  for (int u = 0; u < Tt::CHUNKS / WG_THREADS; ++u) {
    const int e = tid + u * WG_THREADS;
    const int r = e / (HD / 8);
    const int ch = e - r * (HD / 8);
    const int row = t0 + r;
    const bool ok = row < n;
    cp_async16(dst + Tt::offset(r, ch), base + (ok ? row : 0) * stride + ch * 8, ok);
  }
}

// d[64 x N] = A[64 x HD] . B[N x HD]^T (N 64 or 32), A and B rows of
// WgTiles read K-major (``b`` may start at row 32 of its tile)
template <int HD, int N>
__device__ __forceinline__ void mma_nt(float (&d)[N / 2], uint32_t a, uint32_t b) {
  using Tt = WgTile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 32 / Tt::RB) * (WG_M * Tt::RB) + (kk * 32) % Tt::RB;
    const uint64_t da = wg_desc(a + off, 16, 8 * Tt::RB, Tt::LAYOUT);
    const uint64_t db = wg_desc(b + off, 16, 8 * Tt::RB, Tt::LAYOUT);
    if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, kk > 0);
    else
      wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// d[64 x NB PVN] += A[64 x 16 KS] . B[16 KS x NB PVN]: A the bf16 pairs of
// a 64 x 16 KS accumulator fragment (a[i] holds its elements 2 i, 2 i + 1),
// B rows of a WgTile read MN-major, one column block of PVN columns a
// product, NB blocks from ``b`` (which may start at row 32, and at any
// column block: all of them by default)
template <int HD, int KS, int NB = WgTile<HD>::NPV>
__device__ __forceinline__ void mma_rs(float (&d)[NB][WgTile<HD>::PVN / 2],
                                       const uint32_t (&a)[4 * KS], uint32_t b) {
  using Tt = WgTile<HD>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint64_t db = wg_desc(b + n * (WG_M * Tt::RB) + kk * 16 * Tt::RB, 8 * Tt::RB,
                                  8 * Tt::RB, Tt::LAYOUT);
      if constexpr (Tt::PVN == 64)
        wgmma_rs_n64(d[n], ak, db);
      else
        wgmma_rs_n32(d[n], ak, db);
    }
  }
}

template <int N, int M>
__device__ __forceinline__ void zero_acc(float (&d)[N][M]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < M; ++i) d[n][i] = 0.f;
}
template <int N, int M>
__device__ __forceinline__ void fence_acc(float (&d)[N][M]) {
#pragma unroll
  for (int n = 0; n < N; ++n) fence_regs(d[n]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Rows ``row`` and ``row`` + 8 of a fragment-shaped [64 x NB PVN] fp32 sum,
// times ``mul``, as bf16 into a contiguous row-major tensor whose rows are
// ``ld`` elements apart (``out`` at row 0 and the sum's first column); rows
// at or past n are not written.
template <int HD, int NB = WgTile<HD>::NPV>
__device__ __forceinline__ void store_frag(bf16* out, long long ld, int row, int n, int col0,
                                           const float (&d)[NB][WgTile<HD>::PVN / 2],
                                           float mul) {
  using Tt = WgTile<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n) continue;
    bf16* o = out + (long long)(row + 8 * r) * ld;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < Tt::PVN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + c * Tt::PVN + 8 * j + col0) =
            __floats2bfloat162_rn(d[c][4 * j + 2 * r] * mul, d[c][4 * j + 2 * r + 1] * mul);
  }
}

template <int HD, int HDV>
constexpr size_t dkdv_wgmma_smem_bytes() {
  // K and V; per stage Q and dO; per stage the q-tile's lse and D (64 fp32
  // each); slack to align the tiles to the 1024-byte swizzle period
  return (size_t)3 * (WgTile<HD>::BYTES + WgTile<HDV>::BYTES) + 2 * 2 * WG_M * sizeof(float) +
         1024;
}

// HD: q and k's head dim (the Q and K tiles, dK); HDV: v's (V, dO, dV).
// The CTA writes dK's column blocks DKB0 .. DKB0 + NDKB - 1 (of PVN
// columns each) and, when WITH_DV, dV: at (HD, HDV) = (192, 128) one
// launch takes dV and dK's first two blocks, a second dK's third, so that
// no CTA holds more than the 128 + 128 accumulator columns of the dense
// plan (see launch_wgmma).
template <int HD, int HDV, int DKB0 = 0, int NDKB = WgTile<HD>::NPV, bool WITH_DV = true>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dsum,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
                            int G, long long sqb, long long sqs, long long sqh, long long skb,
                            long long sks, long long skh, long long svb, long long svs,
                            long long svh, long long sdb, long long sds, long long sdh,
                            int causal, int window, int sq_real, int skv_real, float scale) {
  using Tk = WgTile<HD>;   // K and Q tiles
  using Tv = WgTile<HDV>;  // V and dO tiles
  constexpr uint32_t STAGE_BYTES = Tk::BYTES + Tv::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t k_tile = sbase;
  const uint32_t v_tile = k_tile + Tk::BYTES;
  const uint32_t stage0 = v_tile + Tv::BYTES;  // Q of stage s at stage0 + s * STAGE_BYTES, dO after
  const uint32_t stats_off = (sbase - raw) + Tk::BYTES + Tv::BYTES + 2 * STAGE_BYTES;
  // per stage: lse of the q-tile's 64 rows, then their D
  const float* stats = reinterpret_cast<const float*>(smem_raw + stats_off);

  // key tiles are the slowest grid dimension, the first (under a causal
  // mask the heaviest) first
  const int Hkv = H / G;
  const int hb = gridDim.x / ((Skv + WG_M - 1) / WG_M);  // Hkv * B
  const int kt = blockIdx.x / hb;
  const int rem = blockIdx.x - kt * hb;
  const int kvh = rem % Hkv;
  const int b = rem / Hkv;
  const int k0 = kt * WG_M;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key_a, key_a + 8
  const int col0 = 2 * (lane & 3);                 // and q columns 8 j + col0 (+1)

  // the q rows that see any key of this tile
  int q_begin = causal ? k0 : 0;
  int q_end = sq_real;
  if (window > 0) q_end = min(q_end, k0 + WG_M - 1 + window);
  if (k0 >= skv_real) q_end = 0;
  q_begin = (q_begin / WG_M) * WG_M;
  const int nq = q_end > q_begin ? (q_end - q_begin + WG_M - 1) / WG_M : 0;
  const int n_iter = G * nq;  // (query head, q-tile) pairs, heads outer

  copy_tile<HD>(k_tile, k + b * skb + kvh * skh, sks, k0, Skv, tid);
  copy_tile<HDV>(v_tile, v + b * svb + kvh * svh, svs, k0, Skv, tid);

  // the first query head of this kv head: its Q and dO rows, and (threads
  // 0..63) its lse or (threads 64..127) its D
  const bf16* q_h0 = q + b * sqb + (long long)kvh * G * sqh;
  const bf16* do_h0 = dout + b * sdb + (long long)kvh * G * sdh;
  const float* st_h0 = (tid < WG_M ? lse : dsum) + ((long long)b * H + kvh * G) * Sq;
  auto issue = [&](int it, int stage) {
    const int hg = it / nq;
    const int q0 = q_begin + (it - hg * nq) * WG_M;
    const uint32_t qd = stage0 + stage * STAGE_BYTES;
    copy_tile<HD>(qd, q_h0 + hg * sqh, sqs, q0, Sq, tid);
    copy_tile<HDV>(qd + Tk::BYTES, do_h0 + hg * sdh, sds, q0, Sq, tid);
    const int i = q0 + (tid & (WG_M - 1));
    cp_async4(raw + stats_off + (stage * 2 * WG_M + tid) * 4,
              st_h0 + (long long)hg * Sq + min(i, Sq - 1), i < Sq);
  };

  static_assert(DKB0 + NDKB <= Tk::NPV, "dK's column blocks inside the tile");
  constexpr uint32_t DK_COL = DKB0 * (WG_M * Tk::RB);  // bytes to dK's first column block
  float dk_acc[NDKB][Tk::PVN / 2], dv_acc[WITH_DV ? Tv::NPV : 1][Tv::PVN / 2];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  const float scale_log2 = scale * LOG2E;

  if (n_iter > 0) issue(0, 0);
  cp_async_commit();  // with K and V
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) issue(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile it (and K, V) landed, tile it + 1 in flight
    fence_async_shared();
    __syncthreads();

    const int hg = it / nq;
    const int q0 = q_begin + (it - hg * nq) * WG_M;
    const uint32_t qd = stage0 + stage * STAGE_BYTES;
    const uint32_t dod = qd + Tk::BYTES;
        const float* st = stats + stage * 2 * WG_M;
    const bool full = tile_full(q0, k0, causal, window, sq_real, skv_real);
    // the q-tile in two halves of 32 rows, so that S^T and dP^T hold 16
    // registers each beside dK and dV: half f's P^T and dS^T feed its two
    // k-steps of dV and dK while half f + 1's S^T and dP^T are computed
    uint32_t pa[2][8], da[2][8];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 32 q rows each
      float s[16], dp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = dp[j] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_nt<HD, 32>(s, k_tile, qd + f * 32 * Tk::RB);
      mma_nt<HDV, 32>(dp, v_tile, dod + f * 32 * Tv::RB);
      wgmma_commit();
      wgmma_wait0();  // (and the previous half's dV, dK products)
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T in the fragment: element j sits at key key_a + 8 ((j /
      // 2) % 2) and q row q0 + 32 f + 8 (j / 4) + col0 + j % 2, whose lse and
      // D the stage holds; masked entries are 0 where the tile is not
      // wholly visible
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int c = 32 * f + 8 * (j >> 2) + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(st + c);
        const float2 d2 = *reinterpret_cast<const float2*>(st + WG_M + c);
        float p0 = exp2f(fmaf(s[j], scale_log2, -l2.x * LOG2E));
        float p1 = exp2f(fmaf(s[j + 1], scale_log2, -l2.y * LOG2E));
        if (!full) {
          const int key = key_a + 8 * ((j >> 1) & 1);
          if (!visible(q0 + c, key, causal, window, sq_real, skv_real)) p0 = 0.f;
          if (!visible(q0 + c + 1, key, causal, window, sq_real, skv_real)) p1 = 0.f;
        }
        pa[f][j >> 1] = pack_bf16(p0, p1);
        da[f][j >> 1] = pack_bf16(p0 * (dp[j] - d2.x), p1 * (dp[j + 1] - d2.y));
      }

      // dV += P^T . dO and dK += dS^T . Q over the half's 32 q rows, the A
      // fragments from registers
      wgmma_fence();
      if constexpr (WITH_DV) mma_rs<HDV, 2>(dv_acc, pa[f], dod + f * 32 * Tv::RB);
      mma_rs<HD, 2, NDKB>(dk_acc, da[f], qd + f * 32 * Tk::RB + DK_COL);
      wgmma_commit();
    }
    wgmma_wait0();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncthreads();  // this stage is free for tile it + 2
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // dk, dv: contiguous [B, Skv, Hkv, HD / HDV]
  const long long kv_at = (long long)b * Skv * Hkv + kvh;  // row 0 of this (b, kv head)
  store_frag<HD, NDKB>(dk + kv_at * HD + DKB0 * Tk::PVN, (long long)Hkv * HD, key_a, Skv, col0,
                       dk_acc, scale);
  if constexpr (WITH_DV)
    store_frag<HDV>(dv + kv_at * HDV, (long long)Hkv * HDV, key_a, Skv, col0, dv_acc, 1.f);
}

template <int HD, int HDV>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q and dO; per stage K and V; slack to align the tiles to 1024 bytes
  return (size_t)3 * (WgTile<HD>::BYTES + WgTile<HDV>::BYTES) + 1024;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          bf16* __restrict__ dq, int Sq, int Skv, int H, int G, long long sqb,
                          long long sqs, long long sqh, long long skb, long long sks,
                          long long skh, long long svb, long long svs, long long svh,
                          long long sdb, long long sds, long long sdh, int causal, int window,
                          int sq_real, int skv_real, float scale) {
  using Tk = WgTile<HD>;   // Q and K tiles
  using Tv = WgTile<HDV>;  // dO and V tiles
  constexpr uint32_t STAGE_BYTES = Tk::BYTES + Tv::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = sbase;
  const uint32_t do_tile = q_tile + Tk::BYTES;
  const uint32_t stage0 = do_tile + Tv::BYTES;  // K of stage s at stage0 + s * STAGE_BYTES, V after

  // q-tiles are the slowest grid dimension, the last (heaviest) first
  const int nqt = (Sq + WG_M - 1) / WG_M;
  const int hb = gridDim.x / nqt;  // H * B
  const int qt = nqt - 1 - (int)blockIdx.x / hb;
  const int rem = (int)blockIdx.x - (nqt - 1 - qt) * hb;
  const int h = rem % H;
  const int b = rem / H;
  const int kvh = h / G;
  const int q0 = qt * WG_M;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  const int col0 = 2 * (lane & 3);                 // and key columns 8 j + col0 (+1)

  copy_tile<HD>(q_tile, q + b * sqb + h * sqh, sqs, q0, Sq, tid);
  copy_tile<HDV>(do_tile, dout + b * sdb + h * sdh, sds, q0, Sq, tid);
  // the rows' lse (log2 units) and D; rows past Sq see nothing (masked)
  float l_row[2], d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_a + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + i;
    l_row[r] = i < Sq ? lse[at] * LOG2E : inf_f();
    d_row[r] = i < Sq ? dsum[at] : 0.f;
  }

  // the key tiles any row of this q-tile sees
  int kv_end = skv_real;
  if (causal) kv_end = min(kv_end, q0 + WG_M);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  if (q0 >= sq_real) kv_end = 0;
  kv_begin = (kv_begin / WG_M) * WG_M;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + WG_M - 1) / WG_M : 0;

  const bf16* kb = k + b * skb + kvh * skh;
  const bf16* vb = v + b * svb + kvh * svh;
  auto issue = [&](int i, int stage) {
    const int t0 = kv_begin + i * WG_M;
    const uint32_t kd = stage0 + stage * STAGE_BYTES;
    copy_tile<HD>(kd, kb, sks, t0, Skv, tid);
    copy_tile<HDV>(kd + Tk::BYTES, vb, svs, t0, Skv, tid);
  };

  float dq_acc[Tk::NPV][Tk::PVN / 2];
  zero_acc(dq_acc);
  const float scale_log2 = scale * LOG2E;
  constexpr int KH = HD > 128 ? 2 : 1;  // parts of a key tile
  constexpr int NK = WG_M / KH;         // keys a part

  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();  // with the Q and dO tiles
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile i (and Q, dO) landed, tile i + 1 in flight
    fence_async_shared();
    __syncthreads();

    const int t0 = kv_begin + i * WG_M;
    const uint32_t kd = stage0 + stage * STAGE_BYTES;
    const uint32_t vd = kd + Tk::BYTES;
    const bool full = tile_full(q0, t0, causal, window, sq_real, skv_real);
    // the key tile in KH parts of NK keys: at HD 192 the 64 x 192 dQ (96
    // registers) leaves no room for a 64-key S and dP beside it, so S, dP
    // and dS take 32 keys at a time (each part's dS feeds two k-steps of dQ)
#pragma unroll
    for (int f = 0; f < KH; ++f) {
      // S = Q . K^T and dP = dO . V^T: 64 q rows x NK keys each
      float s[NK / 2], dp[NK / 2];
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) s[j] = dp[j] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_nt<HD, NK>(s, q_tile, kd + f * NK * Tk::RB);
      mma_nt<HDV, NK>(dp, do_tile, vd + f * NK * Tv::RB);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // dS in the fragment (element j at row row_a + 8 ((j / 2) % 2), key
      // t0 + NK f + 8 (j / 4) + col0 + j % 2); masked entries 0 on boundary
      // tiles
      uint32_t da[NK / 4];
#pragma unroll
      for (int j = 0; j < NK / 2; j += 2) {
        const int r = (j >> 1) & 1;
        const int key = t0 + f * NK + 8 * (j >> 2) + col0;
        float p0 = exp2f(fmaf(s[j], scale_log2, -l_row[r]));
        float p1 = exp2f(fmaf(s[j + 1], scale_log2, -l_row[r]));
        if (!full) {
          const int qpos = row_a + 8 * r;
          if (!visible(qpos, key, causal, window, sq_real, skv_real)) p0 = 0.f;
          if (!visible(qpos, key + 1, causal, window, sq_real, skv_real)) p1 = 0.f;
        }
        da[j >> 1] = pack_bf16(p0 * (dp[j] - d_row[r]), p1 * (dp[j + 1] - d_row[r]));
      }

      // dQ += dS . K over the part's keys, the K tile read MN-major
      fence_acc(dq_acc);
      wgmma_fence();
      mma_rs<HD, NK / 16>(dq_acc, da, kd + f * NK * Tk::RB);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dq_acc);
    }
    __syncthreads();  // this stage is free for tile i + 2
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // dq: contiguous [B, Sq, H, HD]
  const long long q_at = (long long)b * Sq * H + h;  // row 0 of this (b, head)
  store_frag<HD>(dq + q_at * HD, (long long)H * HD, row_a, Sq, col0, dq_acc, scale);
}

template <int HD, int HDV, int DKB0, int NDKB, bool WITH_DV>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const float* lse, const float* dsum, bf16* dk, bf16* dv, int B, int Sq,
                        int Skv, int H, int G, long long sqb, long long sqs, long long sqh,
                        long long skb, long long sks, long long skh, long long svb,
                        long long svs, long long svh, long long sdb, long long sds,
                        long long sdh, int causal, int window, int sq_real, int skv_real,
                        float scale, cudaStream_t stream) {
  constexpr size_t s1 = dkdv_wgmma_smem_bytes<HD, HDV>();
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD, HDV, DKB0, NDKB, WITH_DV>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  const int n_kt = (Skv + WG_M - 1) / WG_M;
  dkdv<<<n_kt * (H / G) * B, WG_THREADS, s1, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, Sq, Skv, H, G, sqb, sqs, sqh, skb, sks, skh, svb, svs,
      svh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale);
  return cudaGetLastError();
}

#define BWD_DKDV_ARGS                                                                         \
  qt, kt, vt, dt, lt, ds, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H, G, sqb, \
      sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, causal, window, sq_real, skv_real,  \
      scale, stream

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dq, void* dk, void* dv, void* dsum, int B, int Sq,
                 int Skv, int H, int Hkv, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb, long long svs,
                 long long svh, long long sob, long long sos, long long soh, long long sdb,
                 long long sds, long long sdh, int causal, int window, int sq_real,
                 int skv_real, float scale, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const int G = H / Hkv;

  const long long rows = (long long)B * H * Sq;
  const int per = BWD_THREADS / 32;
  flash_bwd_dot_kernel<bf16, HDV><<<(unsigned)((rows + per - 1) / per), BWD_THREADS, 0,
                                    stream>>>(static_cast<const bf16*>(o), dt, ds, B, Sq, H, sob,
                                              sos, soh, sdb, sds, sdh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dK and dV: one launch where dK is at most two column blocks wide (hd
  // up to 128); at HD 192, dV and dK's blocks 0-1, then dK's block 2
  constexpr int NPV = WgTile<HD>::NPV;
  constexpr int FIRST = NPV < 2 ? NPV : 2;
  err = launch_dkdv<HD, HDV, 0, FIRST, true>(BWD_DKDV_ARGS);
  if (err != cudaSuccess) return (int)err;
  if constexpr (NPV > FIRST) {
    err = launch_dkdv<HD, HDV, FIRST, NPV - FIRST, false>(BWD_DKDV_ARGS);
    if (err != cudaSuccess) return (int)err;
  }

  constexpr size_t s2 = dq_wgmma_smem_bytes<HD, HDV>();
  auto dqk = flash_bwd_dq_wgmma_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Sq + WG_M - 1) / WG_M;
  dqk<<<nqt * H * B, WG_THREADS, s2, stream>>>(
      qt, kt, vt, dt, lt, ds, static_cast<bf16*>(dq), Sq, Skv, H, G, sqb, sqs, sqh, skb, sks,
      skh, svb, svs, svh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale);
  return (int)cudaGetLastError();
}
#undef BWD_DKDV_ARGS

}  // namespace

// q: [B, Sq, H, hd]; o, dout: [B, Sq, H, hdv]; k: [B, Skv, Hkv, hd]; v:
// [B, Skv, Hkv, hdv], each addressed through its (batch, position, head)
// element strides, last dim contiguous, rows 16-byte aligned; lse:
// contiguous fp32 [B, H, Sq] from the forward; dq, dk, dv: contiguous, of
// q's, k's and v's shapes; dsum: fp32 scratch of B * H * Sq. (hd, hdv) is
// (32, 32), (64, 64), (128, 128) or MLA's (192, 128); H a multiple of Hkv.
// bf16 runs the tensor-core body, fp32 the CUDA-core body. Three launches
// on ``stream`` (four in bf16 at (192, 128)). Returns the cudaError_t of
// the first that fails (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* dsum, int B, int Sq, int Skv, int H, int Hkv,
                                   int hd, int hdv, long long sqb, long long sqs, long long sqh,
                                   long long skb, long long sks, long long skh, long long svb,
                                   long long svs, long long svh, long long sob, long long sos,
                                   long long soh, long long sdb, long long sds, long long sdh,
                                   int causal, int window, int sq_real, int skv_real,
                                   float scale, int is_bf16, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_ARGS                                                                              \
  q, k, v, o, lse, dout, dq, dk, dv, dsum, B, Sq, Skv, H, Hkv, sqb, sqs, sqh, skb, sks, skh, svb, \
      svs, svh, sob, sos, soh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale, s
  if (hd == 192 && hdv == 128)
    return is_bf16 ? launch_wgmma<192, 128>(BWD_ARGS) : launch_fp32<192, 128>(BWD_ARGS);
  if (hdv != hd) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return (launch_wgmma<HD, HD>(BWD_ARGS)))
  } else {
    DISPATCH_HD(hd, HD, return (launch_fp32<HD, HD>(BWD_ARGS)))
  }
#undef BWD_ARGS
  return 0;
}
