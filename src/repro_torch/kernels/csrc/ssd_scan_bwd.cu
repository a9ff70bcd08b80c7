// Backward of the chunked Mamba-2 SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// jnp ssd_chunked (src/repro/models/mamba.py), and its Pallas forward
// (src/repro/kernels/ssd_scan.py: ssd_scan_bhsd) has no VJP. The port's
// forward on the card is ssd_scan.cu, whose output carries no autograd
// graph, so its gradient is a kernel too: ops.ssd_scan's autograd Function
// calls this file's entry point with the forward's inputs and dy.
//
// It computes the gradient of the function ssd_scan.cu's header states, from
// a zero state, the final state taking no gradient. Per batch row and head,
// in chunks of CL = 64 positions (the function does not depend on the chunk
// length up to rounding), with a_t = dt_t A, cums_i the in-chunk inclusive
// prefix sum of a, x'_j = dt_j x_j, H_c the state entering chunk c and G_c'
// the gradient of the state leaving it (G of the last chunk is 0):
//   G_c'      = G_{c+1},  G_c (entering) = sum_i e^{cums_i} dy_i C_i^T
//                                           + e^{cums_last} G_c'
//   dx'_j     = sum_{i>=j} (C_i.B_j) e^{cums_i - cums_j} dy_i
//               + e^{cums_last - cums_j} G_c' B_j
//   dB_j      = sum_h [ sum_{i>=j} W_ij C_i + e^{cums_last - cums_j} x'_j^T G_c' ]
//   dC_i      = sum_h [ sum_{j<=i} W_ij B_j + e^{cums_i} dy_i^T H_c ]
// with W_ij = (dy_i.x'_j) e^{cums_i - cums_j} for j <= i; the gradient of
// cums_i is sum_j W_ij (C_i.B_j) - sum_k W_ki (C_k.B_i) + U_i - V_i, plus, at
// the chunk's last position, e^{cums_last} <G_c', H_c> + sum_j V_j, where
// U_i = C_i . e^{cums_i} dy_i^T H_c and V_j = x'_j . e^{cums_last - cums_j}
// G_c' B_j; da is its reverse in-chunk cumulative sum, and
//   dx_j = dt_j dx'_j,   ddt_j = x_j . dx'_j + A da_j,   dA = sum dt_j da_j.
//
// The in-chunk prefix sums of dt A and the sums that feed da, ddt and dA run
// in fp64, the decays are exponentials of fp32 differences of fp64 sums, as
// in the forward's fp32 kernel. Nothing is atomic and every sum runs in a
// fixed order, so two calls give the same bits. The states are recomputed,
// never saved by the forward: saving them would hold [b, nc, nh, hd, ds]
// fp32 a layer through the whole backward.
//
// What bounds it on this card: at mamba2-130m's training shape ([8, 4096],
// 24 heads of 64, ds 128) the function needs about 2 L^2 hd + 2 L^2 ds + 5
// L hd ds multiply-adds a (chunk, head) (84 GFLOP, 0.085 ms at the bf16
// tensor-core peak) against reading x, dy, dt, B, C and writing their
// gradients once (0.102 ms at 3.35 TB/s). What a chunked design adds is
// the states H and G' (and, in fp32, each chunk's contribution to them),
// [b, nc, nh, hd, ds] each; on the tensor cores the per-head elementwise
// work between the products, latency-bound at one CTA an SM, takes most of
// the time. ssd_scan.py's docstring and PERF.md carry the numbers.
//
// bf16: four launches, every product on the tensor cores (wgmma, one
// 64-position chunk a 64-row tile), built from the forward's pieces
// (wgmma_common.cuh: the 128-byte swizzle, cp.async staging through the
// model's strides, the m64nNk16 products, the hi/lo operand pairs):
//   1. ssd_bwd_walk_wgmma_kernel, one warpgroup a (head, batch row,
//      direction): the forward walk over chunks (H_{c+1} = e^{cl_c} H_c +
//      X'_c^T B_c, X' = x e^{cums_last - cums_j} dt_j) and the backward one
//      (G'_{c-1} = e^{cl_c} G'_c + dY'_c^T C_c, dY' = dy e^{cums_i}). The
//      carry is the wgmma accumulator itself: scaled by the chunk's decay
//      in registers, then the chunk's product (M = head dim, N = d_state in
//      m64n64 column blocks, or m64n16 at d_state 16 with the operand
//      transposed into K-major, K = positions; X' and dY' hi/lo pairs, B
//      and C exact) accumulates onto it, so no chunk's contribution goes to
//      memory. Each chunk's H or G' is written in bf16 to shared memory as
//      launch 2's swizzled tile ([hd, ds]; [ds, hd] at d_state 16, its
//      K-major operand) and stored by one bulk copy (TMA); the next chunk's
//      x or dy, operand and dt load meanwhile (cp.async, two stages).
//   2. ssd_bwd_out_wgmma_kernel, two warpgroups a (chunk, group of heads,
//      batch row), one CTA an SM (171 KiB of shared memory at d_state 128,
//      103 KiB at 16), the next head's x, dy, dt (cp.async) and H and G' (a
//      bulk copy each, on an mbarrier) in flight while a head computes (two
//      stages). Warpgroup 1 takes C.B^T and dy.x^T (K = ds, hd), forms W
//      and M = (C.B^T) o decay (j <= i) in registers, writes both as hi/lo
//      pairs to shared memory, sums the rows and columns of T = W o C.B^T
//      (quad and warp shuffles, then the four warps' column parts in
//      order), then dC += W.B (W K-major) while U is summed from dC's state
//      term dy.H (H MN-major) scaled by e^{cums_i}. Warpgroup 0 scans dt A,
//      takes B.G'^T and x.G' (G' K-major and MN-major), then dx' = e^{cums_last
//      - cums_j} B.G'^T + M^T.dy and dB += W^T.C + e^{cums_last - cums_j}
//      dt_j x.G', where M^T and W^T are the same shared tiles read MN-major
//      (wgmma's transpose bit), no transposed copy; V and x . dx' from dx',
//      dx stored; and, while warpgroup 1 forms the next head's W and M, the
//      previous head's reverse cumulative sum for da (one warp's suffix
//      scan over two halves), ddt and its part of dA. Each warpgroup keeps
//      its sum over the CTA's heads (dB, dC) in one [64, ds] fp32
//      accumulator that the products accumulate onto; <G', H> is split over
//      both.
//   3. ssd_bwd_sum_kernel: dB and dC, the groups' partials summed in group
//      order, cast to B's and C's dtype.
//   4. ssd_bwd_da_kernel: dA, the (batch row, chunk) parts summed in order.
// Numerics: x, dy, B and C go in exact; X', dY', W and M as hi/lo pairs
// (hi = bf16(v), lo = bf16(v - hi)); H and G' as one bf16 plane each (the
// walk keeps them in fp32 until the store): tests/test_torch_ssd_bwd_plan.py
// states the plan on the CPU and keeps the readings that chose it (none of
// those roundings alone, nor all of them, leaves the bf16 gradient rule;
// the pairs cost products, which are far from the bound, and no bytes).
// Every product sums in fp32; the outputs are rounded once, at the store.
// The decays of W and M are 2^x on the multi-function unit (ex2.approx) of
// the fp64 difference in log2 units, and the fp64 sums of T, U, V, x . dx'
// and <G', H> take each product (or pair of products) rounded to fp32 once:
// the accurate expf and the fp64 conversions of every factor were the
// largest part of launch 2's elementwise work, for differences of about
// 2^-22 and 2^-24, far under bf16's.
//
// fp32: five launches on the CUDA cores, every product in fp32 FMAs, held
// to 1e-5 of each gradient's largest entry against float64, which
// tensor-core products cannot meet:
//   1. ssd_bwd_chunk_kernel, per (chunk, head, batch row): the chunk's own
//      state contribution sum_j e^{cums_last - cums_j} x'_j B_j^T, its
//      contribution to the entering state's gradient sum_i e^{cums_i} dy_i
//      C_i^T, and its decay e^{cums_last}; [hd, ds] fp32 each.
//   2. ssd_bwd_pass_kernel: the two walks over chunks, one float4 of a
//      head's state a thread, in place: forward, the state entering each
//      chunk (H_c); backward, the gradient of the state leaving each (G_c').
//   3. ssd_bwd_out_kernel, per (chunk, group of heads, batch row): dx, ddt,
//      the (chunk, head)'s part of dA, and dB and dC summed over the CTA's
//      heads in registers, written as the group's fp32 partial. Shared
//      memory: B, C, H, G' as fp32 [64][ds + 4] tiles, x and dy [64][68],
//      three [64][68] score tiles: 217 KiB at ds 128 (one CTA an SM), 106
//      KiB at ds 16. The head dim is a template parameter (HD 16, 32, 48,
//      64); a CTA's 16 threads of a row share its HD / 16 columns.
//   4., 5. as bf16's 3. and 4.
#include "attn_common.cuh"   // FULL_MASK, to_f32 / from_f32, Vec
#include "wgmma_common.cuh"  // cp.async, wgmma and their descriptors

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;        // threads a CTA (fp32 launches 1 and 3)
constexpr int CL = 64;         // positions a chunk
constexpr int LP = CL + 4;     // pitch of a [CL][CL] tile
constexpr int HDM = 64;        // the largest head dim
constexpr int XP = HDM + 4;    // pitch of an x / dy tile
constexpr int PASS_THREADS = 256;

// In-chunk inclusive prefix sums of dt * A for the chunk at c0 (Lc real
// positions), by warps 0 and 1: cums[CL] (fp64) and dts[CL] (0 past the
// sequence, so a padded position neither decays nor adds). Every thread of
// the CTA calls it (it holds two barriers).
__device__ __forceinline__ void chunk_scan(double* cums, float* dts, double* carry,
                                           const float* dtb, long long sds, int c0, int Lc,
                                           float a, int tid) {
  double v = 0.0;
  if (tid < CL) {
    const float d = tid < Lc ? dtb[(long long)(c0 + tid) * sds] : 0.f;
    dts[tid] = d;
    v = (double)d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(FULL_MASK, v, o);
      if ((tid & 31) >= o) v += n;
    }
    if (tid == 31) *carry = v;
  }
  __syncthreads();
  if (tid < CL) cums[tid] = tid >= 32 ? v + *carry : v;
  __syncthreads();
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// sum over the 16 threads of a half-warp (lanes 0-15 or 16-31)
__device__ __forceinline__ double half_warp_sum(double v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

template <int DS>
constexpr size_t chunk_smem_bytes() {
  return sizeof(double) * (CL + 2) + sizeof(float) * (2 * CL * XP + 2 * CL * (DS + 4) + 3 * CL);
}

// Launch 1 (fp32): per (chunk, head, batch row) the chunk's state contribution
// (states), its part of the entering state's gradient (grads), its decay.
template <typename T, int DS, int HD>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ states, float* __restrict__ grads,
                     float* __restrict__ decay, int S, int nh, int nc, long long sxb,
                     long long sxs, long long sxh, long long sdb, long long sds, long long sdh,
                     long long sbb, long long sbs, long long scb, long long scs) {
  constexpr int SP = DS + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cums = reinterpret_cast<double*>(smem_raw);  // [CL]
  double* carry = cums + CL;                           // [2]
  float* xw = reinterpret_cast<float*>(carry + 2);     // [CL][XP] e^{cl - cums_j} dt_j x_j
  float* dyw = xw + CL * XP;                           // [CL][XP] e^{cums_i} dy_i
  float* bs = dyw + CL * XP;                           // [CL][SP]
  float* cs = bs + CL * SP;                            // [CL][SP]
  float* dts = cs + CL * SP;                           // [CL]
  float* wx = dts + CL;                                // [CL] e^{cl - cums_j} dt_j
  float* ey = wx + CL;                                 // [CL] e^{cums_i}

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * CL, Lc = min(CL, S - c0);
  chunk_scan(cums, dts, carry, dt + b * sdb + h * sdh, sds, c0, Lc, A[h], tid);
  const double cl = cums[CL - 1];
  if (tid < CL) {
    wx[tid] = expf((float)(cl - cums[tid])) * dts[tid];
    ey[tid] = expf((float)cums[tid]);
  }
  __syncthreads();

  const T* xb = x + b * sxb + h * sxh;
  const T* dyb = dy + ((long long)b * S * nh + h) * HD;  // dy: contiguous [b, S, nh, HD]
  for (int e = tid; e < CL * HD; e += NT) {
    const int j = e / HD, p = e - j * HD;
    const bool in = j < Lc;
    xw[j * XP + p] = in ? to_f32(xb[(long long)(c0 + j) * sxs + p]) * wx[j] : 0.f;
    dyw[j * XP + p] = in ? to_f32(dyb[(long long)(c0 + j) * nh * HD + p]) * ey[j] : 0.f;
  }
  for (int e = tid; e < CL * DS; e += NT) {
    const int j = e / DS, s = e - j * DS;
    const bool in = j < Lc;
    bs[j * SP + s] = in ? to_f32(Bm[b * sbb + (long long)(c0 + j) * sbs + s]) : 0.f;
    cs[j * SP + s] = in ? to_f32(Cm[b * scb + (long long)(c0 + j) * scs + s]) : 0.f;
  }
  __syncthreads();

  // [HD, DS] outputs in 4 x 4 blocks, the state column fastest
  const long long at = (((long long)b * nc + c) * nh + h) * HD * DS;
  constexpr int NBLK = (HD / 4) * (DS / 4);
  for (int blk = tid; blk < NBLK; blk += NT) {
    const int p0 = (blk / (DS / 4)) * 4, s0 = (blk % (DS / 4)) * 4;
    float sa[4][4], qa[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sa[r][q] = qa[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < CL; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xw + j * XP + p0);
      const float4 dv = *reinterpret_cast<const float4*>(dyw + j * XP + p0);
      const float4 bv = *reinterpret_cast<const float4*>(bs + j * SP + s0);
      const float4 cv = *reinterpret_cast<const float4*>(cs + j * SP + s0);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w}, dr[4] = {dv.x, dv.y, dv.z, dv.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w}, cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sa[r][q] = fmaf(xr[r], bc[q], sa[r][q]);
          qa[r][q] = fmaf(dr[r], cc[q], qa[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long o = at + (long long)(p0 + r) * DS + s0;
      *reinterpret_cast<float4*>(states + o) = make_float4(sa[r][0], sa[r][1], sa[r][2], sa[r][3]);
      *reinterpret_cast<float4*>(grads + o) = make_float4(qa[r][0], qa[r][1], qa[r][2], qa[r][3]);
    }
  }
  if (tid == 0) decay[((long long)b * nc + c) * nh + h] = expf((float)cl);
}

// Launch 2 (fp32): both walks over the chunks, one float4 of one head's
// state a thread (``head4`` float4s a head). In place: states[c] becomes the
// state entering chunk c, grads[c] the gradient of the state leaving it.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(float* __restrict__ states, float* __restrict__ grads,
                    const float* __restrict__ decay, int nh, int nc, int head4) {
  const int b = blockIdx.y;
  const long long e = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const long long slab = (long long)nh * head4;  // float4s of one chunk's states
  if (e >= slab) return;
  const int h = (int)(e / head4);
  float4* sp = reinterpret_cast<float4*>(states) + (long long)b * nc * slab + e;
  float4* gp = reinterpret_cast<float4*>(grads) + (long long)b * nc * slab + e;
  const float* dp = decay + (long long)b * nc * nh + h;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const float4 s = sp[c * slab];
    const float d = dp[(long long)c * nh];
    sp[c * slab] = carry;
    carry = make_float4(fmaf(carry.x, d, s.x), fmaf(carry.y, d, s.y), fmaf(carry.z, d, s.z),
                        fmaf(carry.w, d, s.w));
  }
  carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const float4 q = gp[c * slab];
    const float d = dp[(long long)c * nh];
    gp[c * slab] = carry;
    carry = make_float4(fmaf(carry.x, d, q.x), fmaf(carry.y, d, q.y), fmaf(carry.z, d, q.z),
                        fmaf(carry.w, d, q.w));
  }
}

template <int DS>
constexpr size_t out_smem_bytes() {
  // fp64: cums, the row and column sums of T, U, V, da, the warps' <G', H>
  // parts and the scan carry; fp32: B, C, H, G', x, dy, C.B^T, W,
  // (C.B^T) o decay, then dt, e^{cums}, e^{cl - cums} and x . dx'
  return sizeof(double) * (6 * CL + NT / 32 + 2) +
         sizeof(float) * (2 * CL * (DS + 4) + 2 * HDM * (DS + 4) + 2 * CL * XP + 3 * CL * LP +
                          4 * CL);
}

// Launch 3 (fp32): per (chunk, group of ``hpc`` heads, batch row).
template <typename T, int DS, int HD>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ dy,
                   const float* __restrict__ hst, const float* __restrict__ gst,
                   const float* __restrict__ decay, T* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ dbc, double* __restrict__ da_part, int S, int nh, int nc,
                   int hpc, long long sxb, long long sxs, long long sxh, long long sdb,
                   long long sds, long long sdh, long long sbb, long long sbs, long long scb,
                   long long scs) {
  constexpr int SP = DS + 4;
  constexpr int NCS = DS / 16;  // state columns a thread owns
  constexpr int NCX = HD / 16;  // head-dim columns a thread owns
  static_assert(HD % 16 == 0 && HD <= HDM && DS % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cums = reinterpret_cast<double*>(smem_raw);  // [CL]
  double* rows = cums + CL;     // [CL] sum_j T_ij
  double* cols = rows + CL;     // [CL] sum_i T_ij
  double* uu = cols + CL;       // [CL] U
  double* vv = uu + CL;         // [CL] V
  double* da = vv + CL;         // [CL] the gradient of a (dt A)
  double* red = da + CL;        // [NT / 32] <G', H> by warp
  double* carry = red + NT / 32;  // [2]
  float* bs = reinterpret_cast<float*>(carry + 2);  // [CL][SP]
  float* cs = bs + CL * SP;     // [CL][SP]
  float* hs = cs + CL * SP;     // [HDM][SP] H entering the chunk
  float* gs = hs + HDM * SP;    // [HDM][SP] G' leaving it
  float* xs = gs + HDM * SP;    // [CL][XP] x (not dt x)
  float* dys = xs + CL * XP;    // [CL][XP] dy
  float* cb = dys + CL * XP;    // [CL][LP] C_i . B_j
  float* wt = cb + CL * LP;     // [CL][LP] W
  float* cbm = wt + CL * LP;    // [CL][LP] (C_i . B_j) e^{cums_i - cums_j}, j <= i
  float* dts = cbm + CL * LP;   // [CL]
  float* ec = dts + CL;         // [CL] e^{cums_i}
  float* we = ec + CL;          // [CL] e^{cl - cums_j}
  float* xdx = we + CL;         // [CL] x_j . dx'_j

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z, ng = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * CL, Lc = min(CL, S - c0);
  const int r0 = 4 * (tid >> 4);   // rows of this thread's blocks
  const int tx = tid & 15;
  const int j0 = 4 * tx;           // columns of its 4 x 4 block of a [CL][CL] tile
  const int s0 = tx * NCS;         // and of its [CL][DS] and [CL][HD] blocks
  const int p0 = tx * NCX;

  for (int e = tid; e < CL * DS; e += NT) {
    const int j = e / DS, s = e - j * DS;
    const bool in = j < Lc;
    bs[j * SP + s] = in ? to_f32(Bm[b * sbb + (long long)(c0 + j) * sbs + s]) : 0.f;
    cs[j * SP + s] = in ? to_f32(Cm[b * scb + (long long)(c0 + j) * scs + s]) : 0.f;
  }
  __syncthreads();
  {  // C.B^T, shared by every head
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int s = 0; s < DS; s += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = *reinterpret_cast<const float4*>(cs + (r0 + r) * SP + s);
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(bs + (j0 + q) * SP + s);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = dot4(cv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(cb + (r0 + r) * LP + j0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }

  float dbacc[4][NCS], dcacc[4][NCS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < NCS; ++q) dbacc[r][q] = dcacc[r][q] = 0.f;

  for (int hh = 0; hh < hpc; ++hh) {
    const int h = g * hpc + hh;
    const float a = A[h];
    __syncthreads();  // the previous head is done with every per-head array
    // 1. x, dy, H, G' and the chunk's prefix sums
    const T* xb = x + b * sxb + h * sxh;
    const T* dyb = dy + ((long long)b * S * nh + h) * HD;  // dy: contiguous [b, S, nh, HD]
    for (int e = tid; e < CL * HD; e += NT) {
      const int j = e / HD, p = e - j * HD;
      const bool in = j < Lc;
      xs[j * XP + p] = in ? to_f32(xb[(long long)(c0 + j) * sxs + p]) : 0.f;
      dys[j * XP + p] = in ? to_f32(dyb[(long long)(c0 + j) * nh * HD + p]) : 0.f;
    }
    const long long st_at = (((long long)b * nc + c) * nh + h) * HD * DS;
    for (int e = tid; e < HD * DS / 4; e += NT) {
      const int p = e / (DS / 4), s = 4 * (e - p * (DS / 4));
      *reinterpret_cast<float4*>(hs + p * SP + s) =
          *reinterpret_cast<const float4*>(hst + st_at + 4 * e);
      *reinterpret_cast<float4*>(gs + p * SP + s) =
          *reinterpret_cast<const float4*>(gst + st_at + 4 * e);
    }
    chunk_scan(cums, dts, carry, dt + b * sdb + h * sdh, sds, c0, Lc, a, tid);
    if (tid < CL) {
      ec[tid] = expf((float)cums[tid]);
      we[tid] = expf((float)(cums[CL - 1] - cums[tid]));
    }
    // (the scan's second barrier has published x, dy, H, G' and cums)

    // 2. W = (dy_i . x_j) dt_j e^{cums_i - cums_j} and (C.B^T) o decay, j <= i
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int p = 0; p < HD; p += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = *reinterpret_cast<const float4*>(dys + (r0 + r) * XP + p);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = *reinterpret_cast<const float4*>(xs + (j0 + q) * XP + p);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = dot4(dv[r], xv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        float w[4], m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q;
          const float dcy = j <= i ? expf((float)(cums[i] - cums[j])) : 0.f;
          w[q] = acc[r][q] * dts[j] * dcy;
          m[q] = cb[i * LP + j] * dcy;
        }
        *reinterpret_cast<float4*>(wt + i * LP + j0) = make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(cbm + i * LP + j0) = make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // 3. the row and column sums of T = W o C.B^T (threads 0..127)
    if (tid < CL) {
      double t = 0.0;
      for (int j = 0; j <= tid; ++j) t += (double)wt[tid * LP + j] * cb[tid * LP + j];
      rows[tid] = t;
    } else if (tid < 2 * CL) {
      const int j = tid - CL;
      double t = 0.0;
      for (int i = j; i < CL; ++i) t += (double)wt[i * LP + j] * cb[i * LP + j];
      cols[j] = t;
    }

    // 4. dx' = ((C.B^T) o decay)^T dy + e^{cl - cums_j} B_j G'^T (rows r0..,
    //    head-dim columns p0..); V_j and x_j . dx'_j summed over the
    //    half-warp that shares the rows
    {
      float in_[4][NCX], st[4][NCX];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NCX; ++q) in_[r][q] = st[r][q] = 0.f;
      for (int i = r0; i < CL; ++i) {
        const float4 m4 = *reinterpret_cast<const float4*>(cbm + i * LP + r0);
        const float mr[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int q = 0; q < NCX; ++q) {
          const float d = dys[i * XP + p0 + q];
#pragma unroll
          for (int r = 0; r < 4; ++r) in_[r][q] = fmaf(mr[r], d, in_[r][q]);
        }
      }
#pragma unroll 2
      for (int s = 0; s < DS; s += 4) {
        float4 bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = *reinterpret_cast<const float4*>(bs + (r0 + r) * SP + s);
#pragma unroll
        for (int q = 0; q < NCX; ++q) {
          const float4 gv = *reinterpret_cast<const float4*>(gs + (p0 + q) * SP + s);
#pragma unroll
          for (int r = 0; r < 4; ++r) st[r][q] = dot4(bv[r], gv, st[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = r0 + r;
        const float w = we[j], d = dts[j];
        double v = 0.0, xd = 0.0;
        T* dxr = dx + (((long long)b * S + c0 + j) * nh + h) * HD + p0;
#pragma unroll
        for (int q = 0; q < NCX; ++q) {
          const float sp = w * st[r][q];
          const float dxp = in_[r][q] + sp;
          const float xv = xs[j * XP + p0 + q];
          v += (double)(xv * d) * sp;
          xd += (double)xv * dxp;
          if (j < Lc) dxr[q] = from_f32<T>(d * dxp);
        }
        v = half_warp_sum(v);
        xd = half_warp_sum(xd);
        if (tx == 0) {
          vv[j] = v;
          xdx[j] = (float)xd;
        }
      }
    }

    // 5. dB += W^T C + e^{cl - cums_j} dt_j x_j^T G' and dC += W B +
    //    e^{cums_i} dy_i^T H (rows r0.., state columns s0..); U_i over the
    //    half-warp
    {
      float t[4][NCS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NCS; ++q) t[r][q] = 0.f;
      for (int i = r0; i < CL; ++i) {
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i * LP + r0);
        const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          const float cv = cs[i * SP + s0 + q];
#pragma unroll
          for (int r = 0; r < 4; ++r) dbacc[r][q] = fmaf(wr[r], cv, dbacc[r][q]);
        }
      }
#pragma unroll 4
      for (int p = 0; p < HD; ++p) {
        float xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = xs[(r0 + r) * XP + p];
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          const float gv = gs[p * SP + s0 + q];
#pragma unroll
          for (int r = 0; r < 4; ++r) t[r][q] = fmaf(xr[r], gv, t[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float f = we[r0 + r] * dts[r0 + r];
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          dbacc[r][q] = fmaf(f, t[r][q], dbacc[r][q]);
          t[r][q] = 0.f;
        }
      }
      for (int j = 0; j < r0 + 4; ++j) {
        float wr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wr[r] = wt[(r0 + r) * LP + j];
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          const float bv = bs[j * SP + s0 + q];
#pragma unroll
          for (int r = 0; r < 4; ++r) dcacc[r][q] = fmaf(wr[r], bv, dcacc[r][q]);
        }
      }
#pragma unroll 4
      for (int p = 0; p < HD; ++p) {
        float dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dr[r] = dys[(r0 + r) * XP + p];
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          const float hv = hs[p * SP + s0 + q];
#pragma unroll
          for (int r = 0; r < 4; ++r) t[r][q] = fmaf(dr[r], hv, t[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        const float e = ec[i];
        double u = 0.0;
#pragma unroll
        for (int q = 0; q < NCS; ++q) {
          const float inter = e * t[r][q];
          dcacc[r][q] += inter;
          u += (double)cs[i * SP + s0 + q] * inter;
        }
        u = half_warp_sum(u);
        if (tx == 0) uu[i] = u;
      }
    }

    // <G', H> over the head's state
    {
      double gh = 0.0;
      for (int e = tid; e < HD * DS; e += NT) {
        const int p = e / DS, s = e - p * DS;
        gh += (double)gs[p * SP + s] * hs[p * SP + s];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(FULL_MASK, gh, o);
      if (lane == 0) red[warp] = gh;
    }
    __syncthreads();

    // 6. the gradient of cums, da its reverse cumulative sum, this (chunk,
    //    head)'s part of dA: one thread, in a fixed order
    if (tid == 0) {
      double vsum = 0.0, gh = 0.0;
      for (int j = 0; j < CL; ++j) vsum += vv[j];
      for (int w = 0; w < NT / 32; ++w) gh += red[w];
      const double last =
          (double)decay[((long long)b * nc + c) * nh + h] * gh + vsum;
      double run = 0.0, part = 0.0;
      for (int k = CL - 1; k >= 0; --k) {
        run += rows[k] - cols[k] + uu[k] - vv[k] + (k == CL - 1 ? last : 0.0);
        da[k] = run;
        part += (double)dts[k] * run;
      }
      da_part[((long long)b * nc + c) * nh + h] = part;
    }
    __syncthreads();
    if (tid < Lc)
      ddt[((long long)b * S + c0 + tid) * nh + h] = (float)((double)xdx[tid] + (double)a * da[tid]);
  }

  // this group's dB and dC partials: dbc [2][b][ng][S][DS] fp32
  const long long plane = (long long)gridDim.z * ng * S * DS;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pos = c0 + r0 + r;
    if (pos >= S) continue;
    float* pb = dbc + (((long long)b * ng + g) * S + pos) * DS + s0;
#pragma unroll
    for (int q = 0; q < NCS; ++q) {
      pb[q] = dbacc[r][q];
      pb[plane + q] = dcacc[r][q];
    }
  }
}

// fp32's launch 4, bf16's 3: dB and dC, the groups' partials summed in group
// order.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dbc, T* __restrict__ dB, T* __restrict__ dC,
                   int nb, int ng, long long row) {  // row: S * DS elements a batch row
  const long long e = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= nb * row) return;
  const long long b = e / row, o = e - b * row;
  const long long plane = (long long)nb * ng * row;
  const float* p = dbc + b * ng * row + o;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < ng; ++g) {
    sb += p[g * row];
    sc += p[plane + g * row];
  }
  dB[e] = from_f32<T>(sb);
  dC[e] = from_f32<T>(sc);
}

// fp32's launch 5, bf16's 4: dA[h], the (batch row, chunk) parts summed in
// order.
__global__ void __launch_bounds__(128)
ssd_bwd_da_kernel(const double* __restrict__ da_part, float* __restrict__ dA, int n, int nh) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= nh) return;
  double s = 0.0;
  for (int k = 0; k < n; ++k) s += da_part[(long long)k * nh + h];
  dA[h] = (float)s;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG = 128;         // threads of a warpgroup
constexpr int HDW = 64;         // head dim of the tensor-core path
constexpr int TB64 = 64 * 128;  // bytes of a 64-row, 128-byte column block
constexpr int BAR_ALL = 1;      // launch 2's named barrier of both warpgroups
constexpr int BAR_WG0 = 2;      // and of warpgroup 0 alone

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Bulk copies (the Tensor Memory Accelerator, one thread issuing) of a
// contiguous run of ``bytes`` (a multiple of 16, 16-byte aligned): shared to
// global in a bulk group; global to shared, completing on an mbarrier.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk stores issued so far have read their source (``READ``) or are done
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (a, b) as a bf16 pair hi = bf16(v) and a pair lo = bf16(v - hi), as
// ssd_scan.cu holds an fp32 operand: hi + lo keeps about 16 bits of mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// 128-byte column blocks of a [rows][DS] bf16 tile with d_state contiguous:
// DS / 64, and one at DS = 16, whose 32-byte rows take the first two 16-byte
// chunks of each 128-byte row (as in ssd_scan.cu)
template <int DS>
__host__ __device__ constexpr int col_blocks() {
  static_assert(DS == 16 || DS % 64 == 0, "d_state 16 or a multiple of 64");
  return DS >= 64 ? DS / 64 : 1;
}

// byte offset of bf16 element (r, col) of a 128-byte-swizzled tile of ``rows`` rows
__device__ __forceinline__ uint32_t sw_elem(int r, int col, int rows) {
  return sw128(r, col >> 3, rows) + (col & 7) * 2;
}

// 2^x on the multi-function unit (ex2.approx, about 2 ulp; denormals to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr double LOG2E = 1.4426950408889634;

// sum over the four lanes of a quad (the lanes that share an accumulator row)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}
// the inclusive prefix sum of v over a warp's lanes (fp64)
__device__ __forceinline__ double warp_scan(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// column block ``i`` of a [64 x 64 CB] accumulator as wgmma's operand
__device__ __forceinline__ float (&acc_block(float* a, int i))[32] {
  return *reinterpret_cast<float(*)[32]>(a + 32 * i);
}

// bytes of one bf16 state plane of a head (H or G'): [64 p][DS s], or [16
// s][64 p] at DS = 16, 128-byte swizzled as launch 2 holds it in shared
// memory; the walk stores it in that form
template <int DS>
__host__ __device__ constexpr uint32_t plane_bytes() {
  return DS >= 64 ? col_blocks<DS>() * TB64 : 2048;
}
template <int DS>
constexpr size_t walk_smem() {
  // two stages of x or dy [64][64] and the B or C chunk; X'^T or dY'^T
  // hi/lo; dt of two stages and the rows' scale [CL] each; the scan's warp
  // sums
  return 2 * (1 + col_blocks<DS>()) * TB64 + 2 * TB64 + sizeof(float) * 3 * CL +
         sizeof(double) * 2 + 1024;
}

// Launch 1 (bf16): the walk over chunks, one CTA per (head, batch
// row, direction), three an SM (168 registers: mamba2-130m's [8, 4096] is
// 384 CTAs, one wave). Forward (z = 0): H_c, the state entering chunk c, then
// H_{c+1} = e^{cl_c} H_c + X'_c^T B_c; backward (z = 1): G'_c, the gradient
// of the state leaving chunk c, then G'_{c-1} = e^{cl_c} G'_c + dY'_c^T C_c.
// The carry is the wgmma accumulator itself ([64 p][DS s] fp32): scaled by
// the chunk's decay in registers, then the chunk's product (X' or dY' a
// hi/lo pair, K-major; B or C MN-major, or transposed K-major at DS = 16)
// accumulates onto it, so no chunk's contribution goes to memory. Each
// chunk's H or G' is stored as one bf16 plane before its update: [64 p][DS
// s], or [DS s][64 p] at DS = 16 (launch 2's K-major operand). The next
// chunk's x or dy, operand and dt load while a chunk computes (two stages).
template <int DS>
__global__ void __launch_bounds__(WG, 3)
ssd_bwd_walk_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                          bf16* __restrict__ hs, bf16* __restrict__ gs, int S, int nh, int nc,
                          long long sxb, long long sxs, long long sxh, long long sdb,
                          long long sds, long long sdh, long long sbb, long long sbs,
                          long long scb, long long scs) {
  constexpr int CB = col_blocks<DS>();
  constexpr int CPR = DS / 8;                 // 16-byte chunks of a [*][DS] row
  constexpr int NA = DS >= 64 ? 32 * CB : 8;  // accumulator floats of a [64 x DS] tile
  constexpr uint32_t PLANE = plane_bytes<DS>();
  // a stage: x or dy [64 j][64 p], unswizzled; the B or C chunk [64 j][DS s]
  // (MN-major; at DS = 16 unswizzled, transposed half a column block on)
  constexpr uint32_t STAGE = (1 + CB) * TB64, O_AT = 2 * STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* dts = reinterpret_cast<float*>(sm + O_AT + 2 * TB64);  // [2][CL]
  float* ws = dts + 2 * CL;  // e^{cl - cums_j} dt_j (forward) or e^{cums_i} (backward)
  double* red = reinterpret_cast<double*>(ws + CL);  // [2]

  const int h = blockIdx.x, b = blockIdx.y;
  const bool fwd = blockIdx.z == 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // dy: contiguous [b, S, nh, HDW]
  const bf16* src = fwd ? x + b * sxb + h * sxh : dy + ((long long)b * S * nh + h) * HDW;
  const long long srow = fwd ? sxs : (long long)nh * HDW;
  const bf16* opnd = fwd ? Bm + b * sbb : Cm + b * scb;
  const long long orow = fwd ? sbs : scs;
  bf16* plane = (fwd ? hs : gs) + ((long long)b * nc * nh + h) * (HDW * DS);
  const long long chunk_stride = (long long)nh * HDW * DS;
  const float a = A[h];

  auto stage = [&](int c, int st) {
    const int c0 = c * CL;
    const uint32_t s0 = base + st * STAGE;
#pragma unroll
    for (int u = 0; u < CL * 8 / WG; ++u) {
      const int e = tid + u * WG;
      const int r = e >> 3, ch = e & 7;
      const bool ok = c0 + r < S;
      cp_async16(s0 + r * 128 + ch * 16, src + (ok ? c0 + r : 0) * srow + ch * 8, ok);
    }
#pragma unroll
    for (int u = 0; u < CL * CPR / WG; ++u) {
      const int e = tid + u * WG;
      const int r = e / CPR, ch = e % CPR;
      const bool ok = c0 + r < S;
      const uint32_t dst = DS >= 64 ? sw128(r, ch, CL) : r * (2 * DS) + ch * 16;
      cp_async16(s0 + TB64 + dst, opnd + (ok ? c0 + r : 0) * orow + ch * 8, ok);
    }
    if (tid < CL) {
      const bool ok = c0 + tid < S;
      cp_async4(smem_addr(dts + st * CL + tid),
                dt + b * sdb + (ok ? c0 + tid : 0) * sds + h * sdh, ok);
    }
  };

  float carry[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) carry[j] = 0.f;
  stage(fwd ? 0 : nc - 1, 0);
  cp_async_commit();
  for (int n = 0; n < nc; ++n) {
    const int c = fwd ? n : nc - 1 - n, st = n & 1;
    const bool update = n + 1 < nc;  // the last chunk's update is never read
    if (update) stage(fwd ? c + 1 : c - 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this chunk's stage landed
    __syncthreads();
    const uint32_t s0 = base + st * STAGE;

    // this chunk's H or G' is the carry before its update: written in
    // bf16 where the pair will go (free since the last product), as the
    // output launch's shared-memory tile, then stored by one bulk copy
    if constexpr (DS >= 64) {
#pragma unroll
      for (int j = 0; j < NA; j += 2) {
        const int jj = j & 31;
        *reinterpret_cast<uint32_t*>(
            sm + O_AT + sw_elem(frag_row(jj, warp, lane), 64 * (j >> 5) + frag_col(jj, lane),
                                HDW)) = pack_bf16(carry[j], carry[j + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NA; ++j)
        *reinterpret_cast<bf16*>(sm + O_AT + sw_elem(frag_col(j, lane), frag_row(j, warp, lane),
                                                     DS)) = __float2bfloat16(carry[j]);
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) bulk_store(plane + c * chunk_stride, base + O_AT, PLANE);
    if (!update) {
      if (tid == 0) bulk_store_wait<false>();
      break;
    }

    if constexpr (DS < 64) {  // the operand's transpose: row s, chunk q holds [8q + t][s]
      const bf16* raw_op = reinterpret_cast<const bf16*>(sm + st * STAGE + TB64);
      for (int e = tid; e < DS * (CL / 8); e += WG) {
        const int s = e % DS, q = e / DS;
        uint32_t w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          __nv_bfloat162 pr;
          pr.x = raw_op[(8 * q + 2 * t) * DS + s];
          pr.y = raw_op[(8 * q + 2 * t + 1) * DS + s];
          w[t] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(sm + st * STAGE + TB64 + TB64 / 2 + sw128(s, q, DS)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }

    // the in-chunk prefix sum of dt A (fp64), warps 0 and 1
    const float d = tid < CL ? dts[st * CL + tid] : 0.f;
    double v = (double)d * a;
    if (warp < 2) {
      v = warp_scan(v, lane);
      if (lane == 31) red[warp] = v;
    }
    __syncthreads();
    const double cl = red[0] + red[1];
    if (tid < CL) {
      const double cu = warp == 1 ? v + red[0] : v;
      ws[tid] = fwd ? expf((float)(cl - cu)) * d : expf((float)cu);
    }
    const float decay = expf((float)cl);
    if (tid == 0) bulk_store_wait<true>();  // the plane has left the pair's room
    __syncthreads();

    // X'^T = (x ws)^T or dY'^T = (dy ws)^T as a hi/lo pair, K-major: row p,
    // 16-byte chunk q holds position 8q + t, t < 8
    const bf16* xs = reinterpret_cast<const bf16*>(sm + st * STAGE);
#pragma unroll
    for (int u = 0; u < HDW * CL / 8 / WG; ++u) {
      const int e = tid + u * WG;
      const int p = e & (HDW - 1), q = e / HDW;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 8 * q + 2 * t;
        split_bf16(__bfloat162float(xs[j * HDW + p]) * ws[j],
                   __bfloat162float(xs[(j + 1) * HDW + p]) * ws[j + 1], hi[t], lo[t]);
      }
      const uint32_t off = sw128(p, q, HDW);
      *reinterpret_cast<uint4*>(sm + O_AT + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm + O_AT + TB64 + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_shared();
    __syncthreads();

    // carry = e^{cl} carry + (A^T hi + A^T lo) . operand
#pragma unroll
    for (int j = 0; j < NA; ++j) carry[j] *= decay;
    fence_regs(carry);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CL / 16; ++kk) {
      const uint64_t hi = wg_desc(base + O_AT + kk * 32, 16, 1024, 1);
      const uint64_t lo = wg_desc(base + O_AT + TB64 + kk * 32, 16, 1024, 1);
      if constexpr (DS >= 64) {
#pragma unroll
        for (int i = 0; i < CB; ++i) {
          const uint64_t bi = wg_desc(s0 + TB64 + i * TB64 + kk * 16 * 128, 1024, 1024, 1);
          wgmma_ss_n64<1>(acc_block(carry, i), hi, bi, 1);
          wgmma_ss_n64<1>(acc_block(carry, i), lo, bi, 1);
        }
      } else {
        const uint64_t bt = wg_desc(s0 + TB64 + TB64 / 2 + kk * 32, 16, 1024, 1);
        wgmma_ss_n16(carry, hi, bt, 1);
        wgmma_ss_n16(carry, lo, bt, 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(carry);
    __syncthreads();  // this stage, the pair and the scan's arrays are free
  }
}

template <int DS>
__host__ __device__ constexpr uint32_t out_stage_bytes() {  // x, dy, H, G' of one head
  return 2 * TB64 + 2 * plane_bytes<DS>();
}
template <int DS>
__host__ __device__ constexpr uint32_t out_tiles_bytes() {
  // the C and B chunks (at DS = 16 also their transposes), two stages, W and
  // M hi/lo
  return 2 * col_blocks<DS>() * TB64 + (DS < 64 ? 2 * 2048 : 0) + 2 * out_stage_bytes<DS>() +
         4 * TB64;
}
// The sums of one head that feed da, ddt and dA, kept by head parity: one
// head's da runs while the next head's W and M are formed.
struct HeadSums {
  double rows[CL];     // sum_j T_ij
  double uu[CL];       // U
  double vv[CL];       // V
  double colp[4][CL];  // sum_i T_ij over each warp's 16 rows
  double ghp[8];       // <G', H> by warp
  double decay;        // e^{cums_last}
  float dt[CL];
  float xdx[CL];       // x_j . dx'_j
};

template <int DS>
constexpr size_t out_wg_smem() {
  // then cums and the scan's two warp sums (fp64), two HeadSums, fp32 dt
  // of two stages, e^{cums}, e^{cl - cums}, e^{cl - cums} dt [CL] each, and
  // the two stages' mbarriers
  return out_tiles_bytes<DS>() + sizeof(double) * (CL + 2) + 2 * sizeof(HeadSums) +
         sizeof(float) * 5 * CL + 2 * sizeof(uint64_t) + 1024;
}

// da, the reverse in-chunk cumulative sum of the gradient of cums, then ddt
// (``ddb``: position 0 of the chunk, ``nh`` apart) and the (chunk, head)'s
// part of dA from one head's sums: one warp, lane l holding positions l and
// l + 32, every sum in a fixed order
__device__ __forceinline__ void head_da(const HeadSums& hs, float a, int lane, int Lc,
                                        float* ddb, int nh, double* part) {
  const int k0 = lane, k1 = lane + 32;
  double c0s = hs.colp[0][k0], c1s = hs.colp[0][k1];
#pragma unroll
  for (int w = 1; w < 4; ++w) {
    c0s += hs.colp[w][k0];
    c1s += hs.colp[w][k1];
  }
  double g0 = hs.rows[k0] - c0s + hs.uu[k0] - hs.vv[k0];
  double g1 = hs.rows[k1] - c1s + hs.uu[k1] - hs.vv[k1];
  const double vsum = warp_sum(hs.vv[k0] + hs.vv[k1]);
  double gh = hs.ghp[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) gh += hs.ghp[w];
  if (lane == 31) g1 += hs.decay * gh + vsum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // suffix sums over the lanes
    const double n0 = __shfl_down_sync(FULL_MASK, g0, o);
    const double n1 = __shfl_down_sync(FULL_MASK, g1, o);
    if (lane + o < 32) {
      g0 += n0;
      g1 += n1;
    }
  }
  g0 += __shfl_sync(FULL_MASK, g1, 0);  // da_k0 = g0, da_k1 = g1
  const double p = warp_sum((double)hs.dt[k0] * g0 + (double)hs.dt[k1] * g1);
  if (lane == 0) *part = p;
  if (k0 < Lc) ddb[(long long)k0 * nh] = (float)((double)hs.xdx[k0] + (double)a * g0);
  if (k1 < Lc) ddb[(long long)k1 * nh] = (float)((double)hs.xdx[k1] + (double)a * g1);
}

// Launch 2 (bf16): per (chunk, group of ``hpc`` heads, batch row), two
// warpgroups; hs and gs the bf16 planes of H and G'.
template <int DS>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_out_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                         const bf16* __restrict__ hs, const bf16* __restrict__ gs,
                         bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbc,
                         double* __restrict__ da_part, int S, int nh, int nc, int hpc,
                         long long sxb, long long sxs, long long sxh, long long sdb,
                         long long sds, long long sdh, long long sbb, long long sbs,
                         long long scb, long long scs) {
  constexpr int CB = col_blocks<DS>();
  constexpr int CPR = DS / 8;                  // 16-byte chunks of a [*][DS] row
  constexpr int NA = DS >= 64 ? 32 * CB : 8;   // accumulator floats of a [64 x DS] tile
  constexpr uint32_t PLANE = plane_bytes<DS>(), STAGE = out_stage_bytes<DS>();
  // C and B chunks [64][DS] (K-major; MN-major at DS >= 64); at DS = 16 C^T
  // and B^T [16 s][64] (K-major); two stages of x [64 j][64 p], dy [64 i][64
  // p], H and G' (planes); W hi/lo and M hi/lo [64 i][64 j]
  constexpr uint32_t O_C = 0, O_B = CB * TB64, O_T = 2 * CB * TB64,
                     O_S = O_T + (DS < 64 ? 2 * 2048 : 0), O_W = O_S + 2 * STAGE,
                     O_M = O_W + 2 * TB64, O_END = O_M + 2 * TB64;
  static_assert(O_END == out_tiles_bytes<DS>(), "shared-memory layout");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  double* cums = reinterpret_cast<double*>(sm + O_END);  // [CL]
  double* red = cums + CL;     // [2] the scan's warp sums
  HeadSums* sums = reinterpret_cast<HeadSums*>(red + 2);  // [2] by head parity
  float* dts = reinterpret_cast<float*>(sums + 2);        // [2][CL] staged dt
  float* ec = dts + 2 * CL;    // [CL] e^{cums_i}
  float* we = ec + CL;         // [CL] e^{cl - cums_j}
  float* fw = we + CL;         // [CL] e^{cl - cums_j} dt_j
  const uint32_t bars = smem_addr(fw + CL);  // [2] the stages' mbarriers (H and G')

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z, ng = gridDim.y;
  const int h0 = g * hpc;
  const int c0 = c * CL, Lc = min(CL, S - c0);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (WG - 1);
  const int warp = wt >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's fragment rows r0, r0 + 8

  const bf16* Cb = Cm + b * scb;
  const bf16* Bb = Bm + b * sbb;
  for (int e = tid; e < CL * CPR; e += 2 * WG) {
    const int r = e / CPR, ch = e % CPR;
    const bool ok = c0 + r < S;
    const long long row = ok ? c0 + r : 0;
    cp_async16(base + O_C + sw128(r, ch, CL), Cb + row * scs + ch * 8, ok);
    cp_async16(base + O_B + sw128(r, ch, CL), Bb + row * sbs + ch * 8, ok);
  }
  auto stage = [&](int k, int st) {
    const int h = h0 + k;
    const uint32_t s0 = base + O_S + st * STAGE;
    const bf16* xb = x + b * sxb + h * sxh;
    const bf16* dyb = dy + ((long long)b * S * nh + h) * HDW;  // dy: contiguous [b, S, nh, HDW]
    for (int e = tid; e < CL * 8; e += 2 * WG) {
      const int r = e >> 3, ch = e & 7;
      const bool ok = c0 + r < S;
      const long long row = ok ? c0 + r : 0;
      cp_async16(s0 + sw128(r, ch, CL), xb + row * sxs + ch * 8, ok);
      cp_async16(s0 + TB64 + sw128(r, ch, CL), dyb + row * nh * HDW + ch * 8, ok);
    }
    // H and G': each plane already in its shared-memory form, one bulk copy
    if (tid == 0) {
      const long long at = (((long long)b * nc + c) * nh + h) * (HDW * DS);
      mbar_expect(bars + 8 * st, 2 * PLANE);
      bulk_load(s0 + 2 * TB64, hs + at, PLANE, bars + 8 * st);
      bulk_load(s0 + 2 * TB64 + PLANE, gs + at, PLANE, bars + 8 * st);
    }
    if (tid < CL) {
      const bool ok = c0 + tid < S;
      cp_async4(smem_addr(dts + st * CL + tid),
                dt + b * sdb + (ok ? c0 + tid : 0) * sds + h * sdh, ok);
    }
  };
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(0, 0);
  cp_async_commit();
  cp_async_wait0();
  mbar_wait(bars, 0);
  __syncthreads();
  if constexpr (DS < 64) {  // C^T, B^T: row s, 16-byte chunk q holds [8q + t][s], t < 8
    for (int e = tid; e < 2 * DS * (CL / 8); e += 2 * WG) {
      const int which = e / (DS * (CL / 8));
      const int f = e % (DS * (CL / 8)), s = f % DS, q = f / DS;
      const uint8_t* src = sm + (which ? O_B : O_C);
      uint32_t w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        __nv_bfloat162 pr;
        pr.x = *reinterpret_cast<const bf16*>(src + sw_elem(8 * q + 2 * t, s, CL));
        pr.y = *reinterpret_cast<const bf16*>(src + sw_elem(8 * q + 2 * t + 1, s, CL));
        w[t] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      *reinterpret_cast<uint4*>(sm + O_T + which * 2048 + sw128(s, q, DS)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }  // (made visible to wgmma by the first head's fence and barrier)

  // this warpgroup's sum over the CTA's heads: dB (warpgroup 0), dC (1)
  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  if (wg == 0) {
    for (int k = 0; k < hpc; ++k) {
      const int st = k & 1, h = h0 + k;
      if (k + 1 < hpc) stage(k + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait1();  // head k's stage landed
      mbar_wait(bars + 8 * st, (k >> 1) & 1);
      fence_async_shared();
      bar_sync(BAR_ALL, 2 * WG);
      const uint32_t sx = base + O_S + st * STAGE, sdy = sx + TB64, sG = sx + 2 * TB64 + PLANE;
      const uint8_t* xt = sm + (sx - base);
      HeadSums& hs = sums[k & 1];
      float* dtc = hs.dt;

      // dx's state term B.G'^T [64 j][64 p] and dB's x.G' [64 j][DS s]
      float dxa[32], dbt[NA];
#pragma unroll
      for (int j = 0; j < 32; ++j) dxa[j] = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j) dbt[j] = 0.f;
      fence_regs(dxa);
      fence_regs(dbt);
      wgmma_fence();
      if constexpr (DS >= 64) {
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk) {
          const uint32_t off = (kk >> 2) * TB64 + (kk & 3) * 32;
          wgmma_ss_n64(dxa, wg_desc(base + O_B + off, 16, 1024, 1), wg_desc(sG + off, 16, 1024, 1),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < CL / 16; ++kk) {
          const uint64_t xa = wg_desc(sx + kk * 32, 16, 1024, 1);
#pragma unroll
          for (int i = 0; i < CB; ++i)
            wgmma_ss_n64<1>(acc_block(dbt, i), xa,
                            wg_desc(sG + i * TB64 + kk * 16 * 128, 1024, 1024, 1), kk > 0);
        }
      } else {  // G'^T [16 s][64 p]: MN-major for B.G'^T, K-major for x.G'
        wgmma_ss_n64<1>(dxa, wg_desc(base + O_B, 16, 1024, 1), wg_desc(sG, 1024, 1024, 1), 0);
#pragma unroll
        for (int kk = 0; kk < CL / 16; ++kk)
          wgmma_ss_n16(dbt, wg_desc(sx + kk * 32, 16, 1024, 1), wg_desc(sG + kk * 32, 16, 1024, 1),
                       kk > 0);
      }
      wgmma_commit();

      // meanwhile the in-chunk prefix sum of dt A (fp64), warps 0 and 1
      float d = 0.f;
      double v = 0.0;
      if (wt < CL) {
        d = dts[st * CL + wt];
        v = warp_scan((double)d * A[h], lane);
        if (lane == 31) red[warp] = v;
      }
      bar_sync(BAR_WG0, WG);
      if (wt < CL) {
        const double cu = warp == 1 ? v + red[0] : v, cl = red[0] + red[1];
        const float w = expf((float)(cl - cu));
        cums[wt] = cu;
        dtc[wt] = d;
        if (wt == 0) hs.decay = (double)expf((float)cl);
        ec[wt] = expf((float)cu);
        we[wt] = w;
        fw[wt] = w * d;
      }
      bar_sync(BAR_ALL, 2 * WG);  // the scan's arrays are published

      // V_j = x'_j . e^{cl - cums_j} (B.G'^T)_j; the state terms scaled
      wgmma_wait0();
      fence_regs(dxa);
      fence_regs(dbt);
      double vs[2] = {0.0, 0.0};
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1, row = r0 + 8 * r;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xt + sw_elem(row, frag_col(j, lane), CL)));
        const float e = we[row], dr = dtc[row];
        dxa[j] *= e;
        dxa[j + 1] *= e;
        vs[r] += (double)fmaf(xv.y * dr, dxa[j + 1], xv.x * dr * dxa[j]);
      }
      vs[0] = quad_sum(vs[0]);
      vs[1] = quad_sum(vs[1]);
      if ((lane & 3) == 0) {
        hs.vv[r0] = vs[0];
        hs.vv[r0 + 8] = vs[1];
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) dbt[j] *= fw[r0 + 8 * ((j >> 1) & 1)];
      // <G', H> over the first half of the planes
      {
        double gh = 0.0;
        for (int e = wt; e < (int)PLANE / 32; e += WG) {
          float gf[8], hf[8];
          Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(sm + (sG - base) + 16 * e), gf);
          Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(sm + (sG - base) - PLANE + 16 * e), hf);
          float p = 0.f;  // bf16 products are exact in fp32
#pragma unroll
          for (int t = 0; t < 8; ++t) p = fmaf(gf[t], hf[t], p);
          gh += (double)p;
        }
        gh = warp_sum(gh);
        if (lane == 0) hs.ghp[warp] = gh;
      }
      // the previous head's da, while warpgroup 1 forms W and M
      if (warp == 3 && k > 0)
        head_da(sums[(k - 1) & 1], A[h - 1], lane, Lc,
                ddt + ((long long)b * S + c0) * nh + h - 1, nh,
                da_part + ((long long)b * nc + c) * nh + h - 1);
      bar_sync(BAR_ALL, 2 * WG);  // W and M are in shared memory

      // dx' += M^T.dy and dB += W^T.C, M^T and W^T read MN-major; then dB
      // += the scaled state term
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        const uint32_t ko = kk * 16 * 128;
        const uint64_t dyb = wg_desc(sdy + ko, 1024, 1024, 1);
        wgmma_ss_n64<1, 1>(dxa, wg_desc(base + O_M + ko, 1024, 1024, 1), dyb, 1);
        wgmma_ss_n64<1, 1>(dxa, wg_desc(base + O_M + TB64 + ko, 1024, 1024, 1), dyb, 1);
        const uint64_t wh = wg_desc(base + O_W + ko, 1024, 1024, 1);
        const uint64_t wl = wg_desc(base + O_W + TB64 + ko, 1024, 1024, 1);
        if constexpr (DS >= 64) {
#pragma unroll
          for (int i = 0; i < CB; ++i) {
            const uint64_t cd = wg_desc(base + O_C + i * TB64 + ko, 1024, 1024, 1);
            wgmma_ss_n64<1, 1>(acc_block(acc, i), wh, cd, 1);
            wgmma_ss_n64<1, 1>(acc_block(acc, i), wl, cd, 1);
          }
        } else {
          const uint64_t ct = wg_desc(base + O_T + kk * 32, 16, 1024, 1);
          wgmma_ss_n16<1>(acc, wh, ct, 1);
          wgmma_ss_n16<1>(acc, wl, ct, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dxa);
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] += dbt[j];

      // x_j . dx'_j, and dx = dt_j dx'_j
      double xd[2] = {0.0, 0.0};
      bf16* dxb = dx + (((long long)b * S + c0) * nh + h) * HDW;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1, row = r0 + 8 * r, col = frag_col(j, lane);
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xt + sw_elem(row, col, CL)));
        xd[r] += (double)fmaf(xv.y, dxa[j + 1], xv.x * dxa[j]);
        if (c0 + row < S)
          *reinterpret_cast<uint32_t*>(dxb + (long long)row * nh * HDW + col) =
              pack_bf16(dtc[row] * dxa[j], dtc[row] * dxa[j + 1]);
      }
      xd[0] = quad_sum(xd[0]);
      xd[1] = quad_sum(xd[1]);
      if ((lane & 3) == 0) {
        hs.xdx[r0] = (float)xd[0];
        hs.xdx[r0 + 8] = (float)xd[1];
      }
      bar_sync(BAR_ALL, 2 * WG);  // this head's sums are published
    }
    if (warp == 3) {  // the last head's da
      const int h = h0 + hpc - 1;
      head_da(sums[(hpc - 1) & 1], A[h], lane, Lc, ddt + ((long long)b * S + c0) * nh + h, nh,
              da_part + ((long long)b * nc + c) * nh + h);
    }
  } else {
    for (int k = 0; k < hpc; ++k) {
      const int st = k & 1, h = h0 + k;
      if (k + 1 < hpc) stage(k + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait1();
      mbar_wait(bars + 8 * st, (k >> 1) & 1);
      fence_async_shared();
      bar_sync(BAR_ALL, 2 * WG);
      const uint32_t sx = base + O_S + st * STAGE, sdy = sx + TB64, sH = sx + 2 * TB64;
      HeadSums& hs = sums[k & 1];
      const float* dtc = hs.dt;

      // C.B^T (K = d_state) and dy.x^T (K = head dim), [64 i][64 j]
      float cbr[32], dyx[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) cbr[j] = dyx[j] = 0.f;
      fence_regs(cbr);
      fence_regs(dyx);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        const uint32_t off = (kk >> 2) * TB64 + (kk & 3) * 32;
        wgmma_ss_n64(cbr, wg_desc(base + O_C + off, 16, 1024, 1),
                     wg_desc(base + O_B + off, 16, 1024, 1), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk)
        wgmma_ss_n64(dyx, wg_desc(sdy + kk * 32, 16, 1024, 1), wg_desc(sx + kk * 32, 16, 1024, 1),
                     kk > 0);
      wgmma_commit();
      bar_sync(BAR_ALL, 2 * WG);  // the scan's arrays
      wgmma_wait0();
      fence_regs(cbr);
      fence_regs(dyx);

      // W = dy.x^T dt_j e^{cums_i - cums_j} and M = C.B^T e^{cums_i -
      // cums_j} (j <= i) as hi/lo pairs; the row sums of T = W o C.B^T and
      // its column sums over this thread's two rows
      {
        const double ci[2] = {cums[r0] * LOG2E, cums[r0 + 8] * LOG2E};
        double rs[2] = {0.0, 0.0}, cp[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) cp[q] = 0.0;
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1, i = r0 + 8 * r, col = frag_col(j, lane);
          float w2[2], m2[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int jc = col + u;
            const float dcy = jc <= i ? ex2((float)(ci[r] - cums[jc] * LOG2E)) : 0.f;
            w2[u] = dyx[j + u] * dtc[jc] * dcy;
            m2[u] = cbr[j + u] * dcy;
            const double t = (double)(w2[u] * cbr[j + u]);
            rs[r] += t;
            cp[(j >> 2) * 2 + u] += t;
          }
          uint32_t hi, lo;
          const uint32_t off = sw_elem(i, col, CL);
          split_bf16(w2[0], w2[1], hi, lo);
          *reinterpret_cast<uint32_t*>(sm + O_W + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + O_W + TB64 + off) = lo;
          split_bf16(m2[0], m2[1], hi, lo);
          *reinterpret_cast<uint32_t*>(sm + O_M + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + O_M + TB64 + off) = lo;
        }
        rs[0] = quad_sum(rs[0]);
        rs[1] = quad_sum(rs[1]);
        if ((lane & 3) == 0) {
          hs.rows[r0] = rs[0];
          hs.rows[r0 + 8] = rs[1];
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cp[q] += __shfl_xor_sync(FULL_MASK, cp[q], o);
        }
        if (lane < 4) {
#pragma unroll
          for (int q = 0; q < 16; ++q) hs.colp[warp][8 * (q >> 1) + 2 * lane + (q & 1)] = cp[q];
        }
      }
      fence_async_shared();

      // dC's state term dy.H [64 i][DS s] (H MN-major; K-major H^T at DS = 16)
      float dct[NA];
#pragma unroll
      for (int j = 0; j < NA; ++j) dct[j] = 0.f;
      fence_regs(dct);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        const uint64_t ya = wg_desc(sdy + kk * 32, 16, 1024, 1);
        if constexpr (DS >= 64) {
#pragma unroll
          for (int i = 0; i < CB; ++i)
            wgmma_ss_n64<1>(acc_block(dct, i), ya,
                            wg_desc(sH + i * TB64 + kk * 16 * 128, 1024, 1024, 1), kk > 0);
        } else {
          wgmma_ss_n16(dct, ya, wg_desc(sH + kk * 32, 16, 1024, 1), kk > 0);
        }
      }
      wgmma_commit();
      // <G', H> over the second half of the planes
      {
        double gh = 0.0;
        for (int e = wt; e < (int)PLANE / 32; e += WG) {
          const uint32_t o = (sH - base) + PLANE / 2 + 16 * e;
          float gf[8], hf[8];
          Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(sm + o + PLANE), gf);
          Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(sm + o), hf);
          float p = 0.f;  // bf16 products are exact in fp32
#pragma unroll
          for (int t = 0; t < 8; ++t) p = fmaf(gf[t], hf[t], p);
          gh += (double)p;
        }
        gh = warp_sum(gh);
        if (lane == 0) hs.ghp[4 + warp] = gh;
      }
      bar_sync(BAR_ALL, 2 * WG);  // W and M are in shared memory

      // dC += W.B, in flight while U_i = C_i . e^{cums_i} (dy.H)_i is
      // summed and the state term scaled; then dC += that term
      wgmma_wait0();
      fence_regs(dct);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        const uint64_t wh = wg_desc(base + O_W + kk * 32, 16, 1024, 1);
        const uint64_t wl = wg_desc(base + O_W + TB64 + kk * 32, 16, 1024, 1);
        if constexpr (DS >= 64) {
#pragma unroll
          for (int i = 0; i < CB; ++i) {
            const uint64_t bd = wg_desc(base + O_B + i * TB64 + kk * 16 * 128, 1024, 1024, 1);
            wgmma_ss_n64<1>(acc_block(acc, i), wh, bd, 1);
            wgmma_ss_n64<1>(acc_block(acc, i), wl, bd, 1);
          }
        } else {
          const uint64_t bt = wg_desc(base + O_T + 2048 + kk * 32, 16, 1024, 1);
          wgmma_ss_n16(acc, wh, bt, 1);
          wgmma_ss_n16(acc, wl, bt, 1);
        }
      }
      wgmma_commit();
      double us[2] = {0.0, 0.0};
#pragma unroll
      for (int j = 0; j < NA; j += 2) {
        const int jj = j & 31, r = (jj >> 1) & 1, i = r0 + 8 * r;
        const int col = 64 * (j >> 5) + frag_col(jj, lane);
        const float2 cv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm + O_C + sw_elem(i, col, CL)));
        const float e = ec[i];
        dct[j] *= e;
        dct[j + 1] *= e;
        us[r] += (double)fmaf(cv.y, dct[j + 1], cv.x * dct[j]);
      }
      us[0] = quad_sum(us[0]);
      us[1] = quad_sum(us[1]);
      if ((lane & 3) == 0) {
        hs.uu[r0] = us[0];
        hs.uu[r0 + 8] = us[1];
      }
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] += dct[j];
      bar_sync(BAR_ALL, 2 * WG);  // this head's sums are published
    }
  }

  // this group's partial: dB (warpgroup 0) or dC (1), dbc [2][b][ng][S][DS]
  float* pb = dbc + (((long long)wg * gridDim.z + b) * ng + g) * S * DS;
#pragma unroll
  for (int j = 0; j < NA; j += 2) {
    const int jj = j & 31, row = frag_row(jj, warp, lane);
    if (c0 + row < S)
      *reinterpret_cast<float2*>(pb + (long long)(c0 + row) * DS + 64 * (j >> 5) +
                                 frag_col(jj, lane)) = make_float2(acc[j], acc[j + 1]);
  }
}

// The ordered sums: fp32's launches 4 and 5, bf16's 3 and 4.
template <typename T>
int finish(float* parts, double* dap, void* dB, void* dC, void* dA, int b, int S, int DS, int nh,
           int nc, int ng, cudaStream_t stream) {
  const long long row = (long long)S * DS;
  ssd_bwd_sum_kernel<T><<<(unsigned)((b * row + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS,
                          0, stream>>>(parts, static_cast<T*>(dB), static_cast<T*>(dC), b, ng,
                                       row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_da_kernel<<<(nh + 127) / 128, 128, 0, stream>>>(dap, static_cast<float*>(dA), b * nc,
                                                          nh);
  return (int)cudaGetLastError();
}

template <int DS>
int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC, void* states,
                void* grads, void* decay, void* dbc, void* da_part, int b, int S, int nh,
                int hpc, long long sxb, long long sxs, long long sxh, long long sdb,
                long long sds, long long sdh, long long sbb, long long sbs, long long scb,
                long long scs, cudaStream_t stream) {
  if (b < 1 || S < 1 || hpc < 1 || nh % hpc) return (int)cudaErrorInvalidValue;
  const int nc = (S + CL - 1) / CL, ng = nh / hpc;
  const dim3 grid(nc, ng, b);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  // states and grads: H and G' as bf16 planes (decay is not used)
  bf16* hp = static_cast<bf16*>(states);
  bf16* gp = static_cast<bf16*>(grads);

  constexpr size_t s1 = walk_smem<DS>();
  auto walk_k = ssd_bwd_walk_wgmma_kernel<DS>;
  cudaError_t err =
      cudaFuncSetAttribute(walk_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  walk_k<<<dim3(nh, b, 2), WG, s1, stream>>>(xb, dtf, Af, Bb, Cb, dyb, hp, gp, S, nh, nc, sxb,
                                            sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s3 = out_wg_smem<DS>();
  auto out_k = ssd_bwd_out_wgmma_kernel<DS>;
  err = cudaFuncSetAttribute(out_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return (int)err;
  float* parts = static_cast<float*>(dbc);
  double* dap = static_cast<double*>(da_part);
  out_k<<<grid, 2 * WG, s3, stream>>>(xb, dtf, Af, Bb, Cb, dyb, hp, gp, static_cast<bf16*>(dx),
                                      static_cast<float*>(ddt), parts, dap, S, nh, nc, hpc, sxb,
                                      sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return finish<bf16>(parts, dap, dB, dC, dA, b, S, DS, nh, nc, ng, stream);
}

template <typename T, int DS, int HD>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC, void* states,
           void* grads, void* decay, void* dbc, void* da_part, int b, int S, int nh, int hpc,
           long long sxb, long long sxs, long long sxh, long long sdb, long long sds,
           long long sdh, long long sbb, long long sbs, long long scb, long long scs,
           cudaStream_t stream) {
  if (b < 1 || S < 1 || hpc < 1 || nh % hpc) return (int)cudaErrorInvalidValue;
  const int nc = (S + CL - 1) / CL, ng = nh / hpc;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* gr = static_cast<float*>(grads);
  float* dc = static_cast<float*>(decay);

  constexpr size_t s1 = chunk_smem_bytes<DS>();
  auto chunk_k = ssd_bwd_chunk_kernel<T, DS, HD>;
  cudaError_t err = cudaFuncSetAttribute(chunk_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s1);
  if (err != cudaSuccess) return (int)err;
  chunk_k<<<dim3(nc, nh, b), NT, s1, stream>>>(xt, dtf, Af, Bt, Ct, dyt, st, gr, dc, S, nh, nc,
                                               sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int head4 = HD * DS / 4;
  ssd_bwd_pass_kernel<<<dim3((nh * head4 + PASS_THREADS - 1) / PASS_THREADS, b), PASS_THREADS,
                        0, stream>>>(st, gr, dc, nh, nc, head4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t s3 = out_smem_bytes<DS>();
  auto out_k = ssd_bwd_out_kernel<T, DS, HD>;
  err = cudaFuncSetAttribute(out_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return (int)err;
  float* parts = static_cast<float*>(dbc);
  double* dap = static_cast<double*>(da_part);
  out_k<<<dim3(nc, ng, b), NT, s3, stream>>>(
      xt, dtf, Af, Bt, Ct, dyt, st, gr, dc, static_cast<T*>(dx), static_cast<float*>(ddt), parts,
      dap, S, nh, nc, hpc, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return finish<T>(parts, dap, dB, dC, dA, b, S, DS, nh, nc, ng, stream);
}

}  // namespace

// x: [b, S, nh, hd], dt: [b, S, nh] fp32, B/C: [b, S, 1, ds], each addressed
// through the given element strides (last dims contiguous; bf16 rows
// 16-byte aligned); A: [nh] fp32; dy: contiguous [b, S, nh, hd] in x's
// dtype. Writes dx (contiguous, x's shape and dtype), ddt (contiguous fp32
// [b, S, nh]), dA (fp32 [nh]), dB and dC (contiguous [b, S, 1, ds], B's
// dtype). Scratch, all contiguous (nc = ceil(S / 64)): states and grads
// [b, nc, nh, hd, ds] in x's dtype (fp32: each chunk's contributions, then
// H and G' in place; bf16: H and G' in launch 2's shared-memory form);
// decay fp32 [b, nc, nh] (fp32 only; null for bf16); dbc fp32 [2, b, nh /
// hpc, S, ds]; da_part fp64 [b, nc, nh]. ``hpc`` heads a CTA of the output
// launch (a divisor of nh); ds 128 or 16; hd 16, 32, 48 or 64 in fp32, 64
// in bf16. Five launches (fp32) or four (bf16) on ``stream``; returns the
// first non-zero cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, void* states, void* grads, void* decay,
                            void* dbc, void* da_part, int b, int S, int nh, int hd, int ds,
                            int hpc, int is_bf16, long long sxb, long long sxs, long long sxh,
                            long long sdb, long long sds, long long sdh, long long sbb,
                            long long sbs, long long scb, long long scs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_ARGS                                                                        \
  x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, states, grads, decay, dbc, da_part, b, S, nh, hpc, \
      sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs, st
  if (is_bf16) {
    if (hd != 64) return (int)cudaErrorInvalidValue;
    if (ds == 128) return launch_bf16<128>(SSD_BWD_ARGS);
    if (ds == 16) return launch_bf16<16>(SSD_BWD_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#define SSD_BWD_FP32(DS_)                                                          \
  switch (hd) {                                                                    \
    case 16: return launch<float, DS_, 16>(SSD_BWD_ARGS);                          \
    case 32: return launch<float, DS_, 32>(SSD_BWD_ARGS);                          \
    case 48: return launch<float, DS_, 48>(SSD_BWD_ARGS);                          \
    case 64: return launch<float, DS_, 64>(SSD_BWD_ARGS);                          \
  }                                                                                \
  return (int)cudaErrorInvalidValue;
  if (ds == 128) {
    SSD_BWD_FP32(128)
  }
  if (ds == 16) {
    SSD_BWD_FP32(16)
  }
#undef SSD_BWD_FP32
#undef SSD_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
