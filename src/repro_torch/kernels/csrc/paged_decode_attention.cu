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
// The kernel is decode_split.cuh's split-KV kernel, the ring kernel's, with
// the paged row address: lane j resolves tile row t0 + j through the page
// table, a tile ahead (the page-table read overlaps the current tile), into
// the row's index among the pool's N * page rows, and the 16-byte vector
// loads take that index from lane j by shuffle. A K/V row of hd elements stays contiguous inside its block, so the
// vector loads apply unchanged; with page = 16 a tile spans two pages. With
// the ring kernel's split count, on the same K/V values, the output is
// bitwise the ring kernel's. Length-aware like the TPU kernel's clamped
// index_map: a row at or past the valid length is never resolved (its page
// may not exist). decode_split.cuh states the design and what bounds it;
// rows sharing a prefix read its blocks in parallel CTAs, so the second read
// of a block usually hits L2.
#include "decode_split.cuh"

// q: [B, 1, H, hd] and kb/vb: [N, page, Hkv, hd] addressed through the given
// element strides (last dim contiguous, rows 16-byte aligned, a block's
// stride page times a row's, fewer than 2^31 rows in all); page_table:
// contiguous int32 [B, n_pages] of in-range block ids; lengths: contiguous
// int32 [B]; o: contiguous [B, 1, H, hd]. Any H / Hkv (groups of at most 16
// query heads a CTA); ``splits``, the CTAs (one cluster) a row, 1 to 8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_fwd(const void* q, const void* kb, const void* vb,
                                          void* o, const void* page_table, const void* lengths,
                                          int B, int n_pages, int page, int H, int Hkv, int hd,
                                          long long sqb, long long sqh, long long skn,
                                          long long skp, long long skh, long long svn,
                                          long long svp, long long svh, float scale,
                                          int is_bf16, int splits, void* stream) {
  if (page < 1 || skn != page * skp || svn != page * svp) return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(page_table), n_pages, page, skp, skh, svp, svh};
  return launch_decode(is_bf16, hd, q, kb, vb, o, nullptr, lengths, rows, B, H, Hkv, sqb, sqh,
                       n_pages * page, scale, splits, static_cast<cudaStream_t>(stream));
}
