// Single-token decode attention against the paged KV block pool,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:
// paged_decode_attention_bhgd (body _paged_decode_kernel). It computes the
// same function: one query token per batch row, all G query heads of a KV
// head together, against keys fetched through the row's page table -- key t
// of row b lives in block page_table[b, t / page], row t % page of the
// [N, page, Hkv, hd] pool -- masked by t < lengths[b] and t < n_pages * page,
// fp32 online softmax, l floored at 1e-30 (a row of length 0 returns zeros).
//
// Design. The ring kernel's (decode_attention.cu): one CTA per (KV head,
// batch row), 4 warps splitting the row's tiles of TILE_K = 32 keys (warp w
// takes tiles w, w + 4, ...), each warp staging its tiles in its own shared
// memory as fp32 and scoring all G heads against them, then the in-CTA
// max/sum merge. Only the tile loader differs: lane j resolves the address of
// tile row t0 + j through the page table once, and the 16-byte vector loads
// take their row's address from that lane by shuffle (attn_common.cuh's
// load_kv_tile_rows). A K/V row of hd elements stays contiguous inside its
// block, so the vector loads apply unchanged; with page = 16 a tile spans two
// pages. The keys run in the ring kernel's order through the same arithmetic,
// so for the same K/V values the output is bitwise the ring kernel's.
//
// Length-aware like the TPU kernel's clamped index_map: the loop stops at the
// row's valid length, and a tile row at or past it is never resolved (its
// page may not exist) -- it loads zeros and is masked.
//
// What bounds it on this card: as the ring kernel, memory bandwidth (4*G*hd
// FLOPs per key against 2*hd*sizeof(T) bytes). Shared prefix blocks are read
// once per row from device memory or from L2; rows sharing a prefix run in
// parallel CTAs, so the second read of a block usually hits L2. Each tile
// adds one dependent read of the page table before its loads; the grid is
// B * Hkv CTAs, as in the ring kernel, so at max_batch = 8 the longest row
// sets the time. Split-KV across CTAs is the later fix for both.
#include "attn_common.cuh"

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int MAX_GROUP = 16;  // query heads per KV head

template <int HD, int GMAX>
constexpr size_t paged_smem_bytes() {
  return sizeof(float) * (GMAX * HD                          // q rows
                          + DEC_WARPS * TILE_K * (2 * HD + 1)  // per-warp K and V tiles
                          + DEC_WARPS * GMAX * (HD + 2));      // per-warp m, l, acc
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kb,
                    const T* __restrict__ vb, T* __restrict__ o,
                    const int* __restrict__ page_table, const int* __restrict__ lengths,
                    int n_pages, int page, int H, int G, long long sqb, long long sqh,
                    long long skn, long long skp, long long skh, long long svn, long long svp,
                    long long svh, float scale) {
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

  const int valid_len = max(0, min(lengths[b], n_pages * page));

  const T* qbase = q + b * sqb + (long long)kvh * G * sqh;
  for (int e = tid; e < GMAX * HD; e += DEC_THREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    qs[e] = g < G ? to_f32(qbase[g * sqh + d]) : 0.f;
  }
  __syncthreads();

  Rows<HD, GMAX> st;
  rows_init<HD, GMAX>(st);
  const int* pt = page_table + (long long)b * n_pages;
  for (int t0 = warp * TILE_K; t0 < valid_len; t0 += DEC_WARPS * TILE_K) {
    __syncwarp();  // this warp's previous tile is consumed
    const int t = t0 + lane;
    long long koff = -1, voff = -1;
    if (t < valid_len) {
      const int lp = t / page;
      const long long blk = pt[lp];
      const int r = t - lp * page;
      koff = blk * skn + r * skp + kvh * skh;
      voff = blk * svn + r * svp + kvh * svh;
    }
    load_kv_tile_rows<T, HD>(ks, vs, kb, vb, koff, voff, lane);
    __syncwarp();
    bool valid[GMAX];
    const bool ok = t < valid_len;
#pragma unroll
    for (int r = 0; r < GMAX; ++r) valid[r] = ok;
    rows_update<HD, GMAX>(st, qs, ks, vs, valid, G, scale, lane);
  }

  merge_warps_store<T, HD, GMAX, DEC_WARPS>(st, m_all, l_all, acc_all,
                                            o + ((long long)b * H + (long long)kvh * G) * HD,
                                            G, tid);
}

template <typename T, int HD, int GMAX>
int launch(const void* q, const void* kb, const void* vb, void* o, const void* page_table,
           const void* lengths, int B, int n_pages, int page, int H, int Hkv, long long sqb,
           long long sqh, long long skn, long long skp, long long skh, long long svn,
           long long svp, long long svh, float scale, cudaStream_t stream) {
  constexpr size_t smem = paged_smem_bytes<HD, GMAX>();
  auto kernel = paged_decode_kernel<T, HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kernel<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kb), static_cast<const T*>(vb),
      static_cast<T*>(o), static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      n_pages, page, H, H / Hkv, sqb, sqh, skn, skp, skh, svn, svp, svh, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_group(int G, const void* q, const void* kb, const void* vb, void* o,
                 const void* page_table, const void* lengths, int B, int n_pages, int page,
                 int H, int Hkv, long long sqb, long long sqh, long long skn, long long skp,
                 long long skh, long long svn, long long svp, long long svh, float scale,
                 cudaStream_t s) {
  if (G <= 4)
    return launch<T, HD, 4>(q, kb, vb, o, page_table, lengths, B, n_pages, page, H, Hkv, sqb,
                            sqh, skn, skp, skh, svn, svp, svh, scale, s);
  if (G <= 8)
    return launch<T, HD, 8>(q, kb, vb, o, page_table, lengths, B, n_pages, page, H, Hkv, sqb,
                            sqh, skn, skp, skh, svn, svp, svh, scale, s);
  return launch<T, HD, MAX_GROUP>(q, kb, vb, o, page_table, lengths, B, n_pages, page, H, Hkv,
                                  sqb, sqh, skn, skp, skh, svn, svp, svh, scale, s);
}

}  // namespace

// q: [B, 1, H, hd] and kb/vb: [N, page, Hkv, hd] addressed through the given
// element strides (last dim contiguous, rows 16-byte aligned); page_table:
// contiguous int32 [B, n_pages] of in-range block ids; lengths: contiguous
// int32 [B]; o: contiguous [B, 1, H, hd]. H / Hkv must be at most 16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_fwd(const void* q, const void* kb, const void* vb,
                                          void* o, const void* page_table, const void* lengths,
                                          int B, int n_pages, int page, int H, int Hkv, int hd,
                                          long long sqb, long long sqh, long long skn,
                                          long long skp, long long skh, long long svn,
                                          long long svp, long long svh, float scale,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP || page < 1) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (is_bf16) {
    DISPATCH_HD(hd, HD, return launch_group<__nv_bfloat16, HD>(
                            G, q, kb, vb, o, page_table, lengths, B, n_pages, page, H, Hkv, sqb,
                            sqh, skn, skp, skh, svn, svp, svh, scale, s))
  } else {
    DISPATCH_HD(hd, HD, return launch_group<float, HD>(
                            G, q, kb, vb, o, page_table, lengths, B, n_pages, page, H, Hkv, sqb,
                            sqh, skn, skp, skh, svn, svp, svh, scale, s))
  }
  return 0;
}
