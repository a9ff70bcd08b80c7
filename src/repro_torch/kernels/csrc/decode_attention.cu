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
// Design. One CTA per (KV head, batch row), 4 warps. The CTA walks only the
// tiles below its row's valid length -- that loop bound is what makes the
// kernel length-aware (the TPU kernel needed an index-map clamp for it): a
// ragged batch reads sum(lengths) positions, not B * W. The warps split the
// tiles between them (warp w takes tiles w, w + 4, ...), each staging its
// own tiles of 32 positions in its own shared-memory region as fp32 straight
// from the cache's [B, W, Hkv, hd] layout, and each scoring all G query
// heads of the group against its tile (attn_common.cuh's rows_update). At
// the end the four warps' partial softmax states merge in shared memory by
// the max/sum rule (the rule of the JAX package's
// models/attention.py decode_attention_update across sequence shards).
//
// What bounds it on this card: decode attention does 4*G*hd FLOPs per cached
// position against 2*hd*sizeof(T) bytes of K and V, far below the card's
// operations-per-byte balance, so it is bound by memory bandwidth. At the
// main path's max_batch = 8 the grid is B * Hkv = 64 CTAs for 132 SMs, and
// the longest row's CTA sets the kernel's time; splitting a row's sequence
// across CTAs (flash-decoding, merged by the same max/sum rule) is the later
// fix.
#include "attn_common.cuh"

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int MAX_GROUP = 16;  // query heads per KV head

template <int HD, int GMAX>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) * (GMAX * HD                          // q rows
                          + DEC_WARPS * TILE_K * (2 * HD + 1)  // per-warp K and V tiles
                          + DEC_WARPS * GMAX * (HD + 2));      // per-warp m, l, acc
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ lengths, int W, int H, int G,
              long long sqb, long long sqh, long long skb, long long skw, long long skh,
              long long svb, long long svw, long long svh, int w_real, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* qs = smem;                                                // [GMAX][HD]
  float* ks = qs + GMAX * HD + warp * TILE_K * (2 * HD + 1);       // [TILE_K][HD + 1]
  float* vs = ks + TILE_K * (HD + 1);                              // [TILE_K][HD]
  float* m_all = smem + GMAX * HD + DEC_WARPS * TILE_K * (2 * HD + 1);  // [W][GMAX]
  float* l_all = m_all + DEC_WARPS * GMAX;                              // [W][GMAX]
  float* acc_all = l_all + DEC_WARPS * GMAX;                            // [W][GMAX][HD]

  int valid_len = min(lengths[b], w_real);
  valid_len = max(0, min(valid_len, W));

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
  for (int t0 = warp * TILE_K; t0 < valid_len; t0 += DEC_WARPS * TILE_K) {
    __syncwarp();  // this warp's previous tile is consumed
    load_kv_tile<T, HD, 32>(ks, vs, kbase, vbase, skw, svw, t0, W, lane);
    __syncwarp();
    bool valid[GMAX];
    const bool ok = t0 + lane < valid_len;
#pragma unroll
    for (int r = 0; r < GMAX; ++r) valid[r] = ok;
    rows_update<HD, GMAX>(st, qs, ks, vs, valid, G, scale, lane);
  }

  // merge the warps' partial states: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
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
    o[((long long)b * H + (long long)kvh * G + g) * HD + d] = from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
int launch(const void* q, const void* k, const void* v, void* o, const void* lengths, int B,
           int W, int H, int Hkv, long long sqb, long long sqh, long long skb, long long skw,
           long long skh, long long svb, long long svw, long long svh, int w_real, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD, GMAX>();
  auto kernel = decode_kernel<T, HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kernel<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int*>(lengths), W, H, H / Hkv, sqb, sqh, skb, skw,
      skh, svb, svw, svh, w_real, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_group(int G, const void* q, const void* k, const void* v, void* o,
                 const void* lengths, int B, int W, int H, int Hkv, long long sqb,
                 long long sqh, long long skb, long long skw, long long skh, long long svb,
                 long long svw, long long svh, int w_real, float scale, cudaStream_t s) {
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, s);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, s);
  return launch<T, HD, MAX_GROUP>(q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh,
                                  svb, svw, svh, w_real, scale, s);
}

}  // namespace

// q: [B, 1, H, hd] and k/v: [B, W, Hkv, hd] addressed through the given
// element strides (last dim contiguous, rows 16-byte aligned); lengths:
// contiguous int32 [B]; o: contiguous [B, 1, H, hd]. H / Hkv must be at
// most 16. Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* lengths, int B, int W, int H, int Hkv, int hd,
                                    long long sqb, long long sqh, long long skb, long long skw,
                                    long long skh, long long svb, long long svw, long long svh,
                                    int w_real, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return launch_group<__nv_bfloat16, HD>(
                            G, q, k, v, o, lengths, B, W, H, Hkv, sqb, sqh, skb, skw, skh, svb,
                            svw, svh, w_real, scale, s))
  } else {
    DISPATCH_HD(hd, HD, return launch_group<float, HD>(G, q, k, v, o, lengths, B, W, H, Hkv,
                                                       sqb, sqh, skb, skw, skh, svb, svw, svh,
                                                       w_real, scale, s))
  }
  return 0;
}
