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
//   G_c'      = G_{c+1}',  G_c (entering) = sum_i e^{cums_i} dy_i C_i^T
//                                            + e^{cums_last} G_c'
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
// Five launches, every product on the CUDA cores in fp32 (fp32 or bf16
// loads), the in-chunk prefix sums of dt A and the sums that feed da, ddt
// and dA in fp64; the decays are expf of fp32 differences of fp64 sums, as
// in the forward's fp32 kernel:
//   1. ssd_bwd_chunk_kernel, per (chunk, head, batch row): the chunk's own
//      state contribution sum_j e^{cums_last - cums_j} x'_j B_j^T, its
//      contribution to the entering state's gradient sum_i e^{cums_i} dy_i
//      C_i^T, and its decay e^{cums_last}; [hd, ds] fp32 each.
//   2. ssd_bwd_pass_kernel: the two walks over chunks, one float4 of a
//      head's state a thread: forward, the state entering each chunk (H_c,
//      in place of the contribution); backward, the gradient of the state
//      leaving each chunk (G_c', in place of the other). The states are
//      recomputed, never saved by the forward: saving them would hold
//      [b, nc, nh, hd, ds] fp32 a layer through the whole backward.
//   3. ssd_bwd_out_kernel, per (chunk, group of heads, batch row): C.B^T once
//      a CTA, then per head W and (C.B^T) o decay as 64 x 64 tiles, dx, ddt,
//      this (chunk, head)'s part of dA (fp64), and dB and dC summed over the
//      CTA's heads in registers, written as the group's fp32 partial.
//   4. ssd_bwd_sum_kernel: dB and dC, the groups' partials summed in group
//      order, cast to B's and C's dtype.
//   5. ssd_bwd_da_kernel: dA, the (batch row, chunk) parts summed in order.
// Nothing is atomic and every sum runs in a fixed order, so two calls give
// the same bits.
//
// Shared memory of launch 3: B, C, H, G' as fp32 [64][ds + 4] tiles, x and dy
// [64][68], three [64][68] score tiles: 217 KiB at ds 128 (one CTA an SM),
// 106 KiB at ds 16. The head dim is a template parameter (HD 16, 32, 48, 64;
// bf16 64); a CTA's 16 threads of a row share its HD / 16 columns.
//
// What bounds it on this card: at mamba2-130m's training shape ([8, 4096],
// 24 heads of 64, ds 128) about 2 L^2 hd + 2 L^2 ds + 5 L hd ds multiply-adds
// a (chunk, head) against reading x, dy, dt, B, C and writing their
// gradients once; ssd_scan.py's docstring and PERF.md carry the numbers. This
// first kernel runs every product on the CUDA cores; the tensor-core form
// (the forward's wgmma pieces) is later work.
#include "attn_common.cuh"  // FULL_MASK, to_f32 / from_f32

namespace {

constexpr int NT = 256;        // threads a CTA (launches 1 and 3)
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

// Launch 1: per (chunk, head, batch row) the chunk's state contribution
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

// Launch 2: both walks over the chunks, one float4 of one head's state a
// thread (``head4`` float4s a head). In place: states[c] becomes the state
// entering chunk c, grads[c] the gradient of the state leaving it.
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

// Launch 3: per (chunk, group of ``hpc`` heads, batch row).
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

// Launch 4: dB and dC, the groups' partials summed in group order.
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

// Launch 5: dA[h], the (batch row, chunk) parts summed in order.
__global__ void __launch_bounds__(128)
ssd_bwd_da_kernel(const double* __restrict__ da_part, float* __restrict__ dA, int n, int nh) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= nh) return;
  double s = 0.0;
  for (int k = 0; k < n; ++k) s += da_part[(long long)k * nh + h];
  dA[h] = (float)s;
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

  const long long row = (long long)S * DS;
  ssd_bwd_sum_kernel<T><<<(unsigned)((b * row + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS,
                          0, stream>>>(parts, static_cast<T*>(dB), static_cast<T*>(dC), b, ng,
                                       row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_da_kernel<<<(nh + 127) / 128, 128, 0, stream>>>(dap, static_cast<float*>(dA), b * nc,
                                                          nh);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, S, nh, hd], dt: [b, S, nh] fp32, B/C: [b, S, 1, ds], each addressed
// through the given element strides (last dims contiguous); A: [nh] fp32;
// dy: contiguous [b, S, nh, hd] in x's dtype. Writes dx (contiguous, x's
// shape and dtype), ddt (contiguous fp32 [b, S, nh]), dA (fp32 [nh]), dB
// and dC (contiguous [b, S, 1, ds], B's dtype). Scratch, all contiguous:
// states and grads fp32 [b, nc, nh, hd, ds] and decay fp32 [b, nc, nh]
// (nc = ceil(S / 64)), dbc fp32 [2, b, nh / hpc, S, ds], da_part fp64
// [b, nc, nh]. ``hpc`` heads a CTA of launch 3 (a divisor of nh); ds 128
// or 16; hd 16, 32, 48 or 64 in fp32, 64 in bf16. Five launches on
// ``stream``; returns the first non-zero cudaError_t.
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
    if (ds == 128) return launch<__nv_bfloat16, 128, 64>(SSD_BWD_ARGS);
    if (ds == 16) return launch<__nv_bfloat16, 16, 64>(SSD_BWD_ARGS);
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
