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
// The kernel is decode_split.cuh's split-KV kernel (a cluster of CTAs a row,
// merged through distributed shared memory) with the ring row address
// b * skb + t * skw + kvh * skh; that file states the design and what bounds
// it. Only the valid positions are read (below min(lengths[b], w_real, W)),
// so a ragged batch reads sum(lengths) positions, not B * W.
#include "decode_split.cuh"

// q: [B, 1, H, hd] and k/v: [B, W, Hkv, hd] addressed through the given
// element strides (last dim contiguous, rows 16-byte aligned); lengths:
// contiguous int32 [B]; o: contiguous [B, 1, H, hd]. Any H / Hkv (groups of
// at most 16 query heads a CTA); ``splits``, the CTAs (one cluster) a row,
// 1 to 8. Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* lengths, int B, int W, int H, int Hkv, int hd,
                                    long long sqb, long long sqh, long long skb, long long skw,
                                    long long skh, long long svb, long long svw, long long svh,
                                    int w_real, float scale, int is_bf16, int splits,
                                    void* stream) {
  const RingRows rows{skb, skw, skh, svb, svw, svh};
  return launch_decode(is_bf16, hd, q, k, v, o, lengths, rows, B, H, Hkv, sqb, sqh,
                       w_real < W ? w_real : W, scale, splits,
                       static_cast<cudaStream_t>(stream));
}
