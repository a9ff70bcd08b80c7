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
// (from the window start, when there is a window), then the suffix tiles as
// before; with no prior the sweep is the plain one, unchanged.
//
// Design. One CTA per (q-tile of BQ = 64 rows, q-head, batch row); 8 warps,
// each owning 8 query rows. The CTA walks the KV tiles its rows can reach
// (causal: up to the tile's last row; window: from its first row's window
// start), staging each tile of 32 keys in shared memory as fp32 (16-byte
// loads, one round trip per tile) and reusing it for all 64 rows. Inside a
// warp, lane j scores key j against all 8 rows at once, so each K and V
// element read from shared memory feeds 8 FMAs; a row's max and sum take
// one warp reduction each, and P.V broadcasts p_j by shuffle while each lane
// keeps HD/32 output dims of every row in registers. Inputs are read in the
// model's [B, S, H, hd] layout through their strides, so no transpose or pad
// copy is made; the ragged tail is masked in the kernel.
//
// What bounds it on this card: causal prefill does about 2*B*H*S^2*hd FLOPs
// against 2*B*S*(H+Hkv)*hd*sizeof(T) bytes, so at the main path's bf16
// shapes (B=8, H=32, Hkv=8, hd=128) the bytes bound the 256-token bucket and
// the bf16 tensor-core peak bounds the 1024-token one. This first kernel
// does its products with fp32 FMAs on the CUDA cores and is far from either
// bound; moving QK^T and PV onto wgmma with TMA-fed shared-memory tiles is
// the later fix.
#include "attn_common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int FLASH_WARPS = 8;
constexpr int FLASH_THREADS = FLASH_WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / FLASH_WARPS;

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (BQ * HD + TILE_K * (HD + 1) + TILE_K * HD) + sizeof(int) * TILE_K;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FLASH_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const int* __restrict__ q_seg,
                 const int* __restrict__ k_seg, const T* __restrict__ pk,
                 const T* __restrict__ pv, const int* __restrict__ prior_valid, int Sq,
                 int Skv, int Pp, int H, int G, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb, long long svs,
                 long long svh, long long spkb, long long spks, long long spkh,
                 long long spvb, long long spvs, long long spvh, int causal, int window,
                 int sq_real, int skv_real, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [BQ][HD]
  float* ks = qs + BQ * HD;                   // [TILE_K][HD + 1]
  float* vs = ks + TILE_K * (HD + 1);         // [TILE_K][HD]
  int* kseg_s = reinterpret_cast<int*>(vs + TILE_K * HD);  // [TILE_K]

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

  Rows<HD, ROWS_PER_WARP> st;
  rows_init<HD, ROWS_PER_WARP>(st);
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
    load_kv_tile<T, HD, FLASH_THREADS>(ks, vs, pkbase, pvbase, spks, spvs, t0, pvalid, tid);
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
    rows_update<HD, ROWS_PER_WARP>(st, qs + row0 * HD, ks, vs, valid, ROWS_PER_WARP,
                                   scale, lane);
  }

  // Then the suffix: the KV tiles any row of this q-tile can reach.
  int kv_end = skv_real;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  kv_begin = (kv_begin / TILE_K) * TILE_K;

  const T* kbase = k + b * skb + kvh * skh;
  const T* vbase = v + b * svb + kvh * svh;
  for (int t0 = kv_begin; t0 < kv_end; t0 += TILE_K) {
    __syncthreads();  // the previous tile is consumed (and the q tile staged)
    load_kv_tile<T, HD, FLASH_THREADS>(ks, vs, kbase, vbase, sks, svs, t0, Skv, tid);
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
    rows_update<HD, ROWS_PER_WARP>(st, qs + row0 * HD, ks, vs, valid, ROWS_PER_WARP,
                                   scale, lane);
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
    T* orow = o + (((long long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) orow[lane + 32 * i] = from_f32<T>(st.acc[r][i] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_seg,
           const void* k_seg, const void* pk, const void* pv, const void* prior_valid, int B,
           int Sq, int Skv, int Pp, int H, int Hkv, long long sqb, long long sqs, long long sqh,
           long long skb, long long sks, long long skh, long long svb, long long svs,
           long long svh, long long spkb, long long spks, long long spkh, long long spvb,
           long long spvs, long long spvh, int causal, int window, int sq_real, int skv_real,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, FLASH_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int*>(q_seg), static_cast<const int*>(k_seg),
      static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const int*>(prior_valid), Sq, Skv, Pp, H, H / Hkv, sqb, sqs, sqh, skb, sks,
      skh, svb, svs, svh, spkb, spks, spkh, spvb, spvs, spvh, causal, window, sq_real,
      skv_real, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Sq, H, hd], k/v: [B, Skv, Hkv, hd] and pk/pv: [B, Pp, Hkv, hd]
// addressed through the given element strides (last dim contiguous);
// o: contiguous [B, Sq, H, hd]. q_seg / k_seg: contiguous int32 [B, Sq] /
// [B, Skv], or both null. prior_valid: contiguous int32 [B], or null with
// no prior (pk / pv are then not read). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* q_seg, const void* k_seg, const void* pk,
                                   const void* pv, const void* prior_valid, int B, int Sq,
                                   int Skv, int Pp, int H, int Hkv, int hd, long long sqb,
                                   long long sqs, long long sqh, long long skb, long long sks,
                                   long long skh, long long svb, long long svs, long long svh,
                                   long long spkb, long long spks, long long spkh,
                                   long long spvb, long long spvs, long long spvh, int causal,
                                   int window, int sq_real, int skv_real, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return launch<__nv_bfloat16, HD>(
                            q, k, v, o, q_seg, k_seg, pk, pv, prior_valid, B, Sq, Skv, Pp, H,
                            Hkv, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, spkb, spks, spkh,
                            spvb, spvs, spvh, causal, window, sq_real, skv_real, scale, s))
  } else {
    DISPATCH_HD(hd, HD, return launch<float, HD>(
                            q, k, v, o, q_seg, k_seg, pk, pv, prior_valid, B, Sq, Skv, Pp, H,
                            Hkv, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, spkb, spks, spkh,
                            spvb, spvs, spvh, causal, window, sq_real, skv_real, scale, s))
  }
  return 0;
}
