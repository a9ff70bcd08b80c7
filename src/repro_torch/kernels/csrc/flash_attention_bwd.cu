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
// It computes, per (b, query head h, kv head h / G), in fp32:
//   P  = exp(Q K^T * scale - lse)   (0 where masked)
//   D  = rowsum(dO o O)
//   dV = sum over the G query heads of P^T dO
//   dS = P o (dO V^T - D)
//   dK = scale * sum over the G heads of dS^T Q,   dQ = scale * dS K
// under every mask the forward takes but segment ids and a prior: causal
// (query i sees key j <= i, absolute indices, as the forward), the window
// (j > i - window), the pads (rows at or past sq_real, keys at or past
// skv_real), Sq != Skv (cross-attention), any G, hd 32 / 64 / 128. A row
// that sees no key has lse = +inf and P = 0, so its gradients are zero.
//
// The arithmetic is fp32 from inputs widened on load, so the bf16 and fp32
// paths round where the plain version's autograd does: the gradients once,
// at the store. Nothing is atomic, and every sum runs in a fixed order, so
// two calls give the same bits:
//   1. flash_bwd_dot_kernel: D, one warp a row;
//   2. flash_bwd_dkdv_kernel: one CTA per (64-key tile, kv head, batch row)
//      walks the G query heads of its kv head and the 64-row q-tiles that
//      reach its keys, recomputes S and dO V^T, and accumulates dK and dV
//      in registers; it writes them once, so the GQA sum needs no atomics;
//   3. flash_bwd_dq_kernel: one CTA per (64-row q-tile, query head, batch
//      row) over the key tiles its rows reach, recomputing S and dO V^T,
//      accumulating dQ in registers.
// Together they do seven products of a (q-tile, key-tile) pair where the
// function needs five (S and dO V^T are recomputed in the dQ kernel).
//
// What bounds it on this card: operations. At the training shape (B 2, S
// 4096, H 32, Hkv 8, hd 128, causal) the five products are about
// 5 B H S^2 hd = 0.69 TFLOP against 0.3 GB moved. This first kernel runs
// them as fp32 FMAs on the CUDA cores, not on the tensor cores: each
// product is a register-tiled shared-memory GEMM (a thread owns a 4 x 4
// tile of S or a 4-key x hd/16-dim tile of dK / dV / dQ, operands read as
// 16-byte vectors from fp32 tiles whose rows are padded by 4 floats so that
// 8 threads reading 8 rows hit 32 different banks). Its time stands beside
// the tensor-core bound in PERF.md; a tensor-core body is later work.
#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BR = 64;  // q rows of a tile
constexpr int BC = 64;  // keys of a tile
constexpr int PAD = 4;  // floats a tile row is padded by
constexpr int RS = 4;   // rows (and keys) a thread owns of an S tile
constexpr int RA = 4;   // rows of dK / dV / dQ a thread owns

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Rows t0 .. t0 + 63 of a [*, HD] tensor (rows ``stride_row`` elements
// apart, 16-byte aligned) into an fp32 tile of 64 rows HD + PAD apart;
// rows at or past n become zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long stride_row, int t0,
                                          int n, int tid) {
  load_rows<T, HD, BWD_THREADS, HD + PAD>(dst, base, stride_row, t0, n, tid);
  load_rows<T, HD, BWD_THREADS, HD + PAD>(dst + TILE_K * (HD + PAD), base, stride_row,
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

// Whether query i sees key j.
__device__ __forceinline__ bool visible(int i, int j, int causal, int window, int sq_real,
                                        int skv_real) {
  return i < sq_real && j < skv_real && (!causal || i >= j) && (window <= 0 || j > i - window);
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

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles; P and dS tiles; lse and D of the q-tile
  return sizeof(float) * (4 * 64 * (HD + PAD) + 2 * BR * (BC + PAD) + 2 * BR);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Skv, int H, int G, long long sqb, long long sqs, long long sqh,
                      long long skb, long long sks, long long skh, long long svb, long long svs,
                      long long svh, long long sdb, long long sds, long long sdh, int causal,
                      int window, int sq_real, int skv_real, float scale) {
  constexpr int LD = HD + PAD;
  constexpr int LP = BC + PAD;
  constexpr int DU = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [BC][LD]
  float* vs = ks + 64 * LD;    // [BC][LD]
  float* qs = vs + 64 * LD;    // [BR][LD]
  float* dos = qs + 64 * LD;   // [BR][LD]
  float* ps = dos + 64 * LD;   // [BR][LP]: P
  float* dss = ps + BR * LP;   // [BR][LP]: dS
  float* lse_s = dss + BR * LP;
  float* d_s = lse_s + BR;

  const int k0 = blockIdx.x * BC;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = H / G;
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;        // S tile: rows tm + 16 r, keys tn + 16 c
  const int m0 = (tid & 15) * RA, d0 = (tid >> 4) * DU;  // dK / dV: keys m0 .., dims d0 ..

  load_tile<T, HD>(ks, k + b * skb + kvh * skh, sks, k0, Skv, tid);
  load_tile<T, HD>(vs, v + b * svb + kvh * svh, svs, k0, Skv, tid);

  float dk_acc[RA][DU], dv_acc[RA][DU];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int u = 0; u < DU; ++u) dk_acc[r][u] = dv_acc[r][u] = 0.f;

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
      load_tile<T, HD>(qs, q + b * sqb + h * sqh, sqs, q0, Sq, tid);
      load_tile<T, HD>(dos, dout + b * sdb + h * sdh, sds, q0, Sq, tid);
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
      mm_nt<HD>(dp, dos, vs, tm, tn);
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
      mm_tn<HD, LP>(dv_acc, ps, dos, m0, d0);
      mm_tn<HD, LP>(dk_acc, dss, qs, m0, d0);
    }
  }

  const long long hkv_row = (long long)Hkv * HD;  // dk, dv: contiguous [B, Skv, Hkv, HD]
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int j = k0 + m0 + r;
    if (j >= Skv) continue;
    T* dkr = dk + ((long long)b * Skv + j) * hkv_row + (long long)kvh * HD + d0;
    T* dvr = dv + ((long long)b * Skv + j) * hkv_row + (long long)kvh * HD + d0;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      dkr[u] = from_f32<T>(dk_acc[r][u] * scale);
      dvr[u] = from_f32<T>(dv_acc[r][u]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; dS^T; lse and D of the q-tile
  return sizeof(float) * (4 * 64 * (HD + PAD) + BC * (BR + PAD) + 2 * BR);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, int Sq, int Skv, int H,
                    int G, long long sqb, long long sqs, long long sqh, long long skb,
                    long long sks, long long skh, long long svb, long long svs, long long svh,
                    long long sdb, long long sds, long long sdh, int causal, int window,
                    int sq_real, int skv_real, float scale) {
  constexpr int LD = HD + PAD;
  constexpr int LT = BR + PAD;
  constexpr int DU = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BR][LD]
  float* dos = qs + 64 * LD;   // [BR][LD]
  float* ks = dos + 64 * LD;   // [BC][LD]
  float* vs = ks + 64 * LD;    // [BC][LD]
  float* dst = vs + 64 * LD;   // [BC][LT]: dS^T
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

  load_tile<T, HD>(qs, q + b * sqb + h * sqh, sqs, q0, Sq, tid);
  load_tile<T, HD>(dos, dout + b * sdb + h * sdh, sds, q0, Sq, tid);
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

  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BC) {
    __syncthreads();  // the previous tile's reads are done (and Q, dO staged)
    load_tile<T, HD>(ks, kb, sks, k0, Skv, tid);
    load_tile<T, HD>(vs, vb, svs, k0, Skv, tid);
    __syncthreads();

    float s[RS][RS], dp[RS][RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int c = 0; c < RS; ++c) s[r][c] = dp[r][c] = 0.f;
    mm_nt<HD>(s, qs, ks, tm, tn);
    mm_nt<HD>(dp, dos, vs, tm, tn);
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
    T* dqr = dq + ((long long)b * Sq + i) * hrow + (long long)h * HD + d0;
#pragma unroll
    for (int u = 0; u < DU; ++u) dqr[u] = from_f32<T>(dq_acc[r][u] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
               const void* dout, void* dq, void* dk, void* dv, void* dsum, int B, int Sq,
               int Skv, int H, int Hkv, long long sqb, long long sqs, long long sqh,
               long long skb, long long sks, long long skh, long long svb, long long svs,
               long long svh, long long sob, long long sos, long long soh, long long sdb,
               long long sds, long long sdh, int causal, int window, int sq_real, int skv_real,
               float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const int G = H / Hkv;

  const long long rows = (long long)B * H * Sq;
  const int per = BWD_THREADS / 32;
  flash_bwd_dot_kernel<T, HD><<<(unsigned)((rows + per - 1) / per), BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(o), dt, ds, B, Sq, H, sob, sos, soh, sdb, sds, sdh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s1 = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((Skv + BC - 1) / BC, Hkv, B), BWD_THREADS, s1, stream>>>(
      qt, kt, vt, dt, lt, ds, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, G, sqb, sqs,
      sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s2 = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BR - 1) / BR, H, B), BWD_THREADS, s2, stream>>>(
      qt, kt, vt, dt, lt, ds, static_cast<T*>(dq), Sq, Skv, H, G, sqb, sqs, sqh, skb, sks, skh,
      svb, svs, svh, sdb, sds, sdh, causal, window, sq_real, skv_real, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd], each addressed
// through its (batch, position, head) element strides, last dim contiguous,
// rows 16-byte aligned; lse: contiguous fp32 [B, H, Sq] from the forward;
// dq, dk, dv: contiguous, of q's, k's and v's shapes; dsum: fp32 scratch of
// B * H * Sq. hd in {32, 64, 128}; H a multiple of Hkv. Three launches on
// ``stream``. Returns the cudaError_t of the first that fails (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* dsum, int B, int Sq, int Skv, int H, int Hkv,
                                   int hd, long long sqb, long long sqs, long long sqh,
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
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return (launch_bwd<__nv_bfloat16, HD>(BWD_ARGS)))
  } else {
    DISPATCH_HD(hd, HD, return (launch_bwd<float, HD>(BWD_ARGS)))
  }
#undef BWD_ARGS
  return 0;
}
