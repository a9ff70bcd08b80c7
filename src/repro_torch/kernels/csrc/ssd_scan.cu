// Chunked Mamba-2 SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_bhsd
// (body _ssd_kernel). It computes the same function from a zero state: for
// each chunk of L positions, with cums the in-chunk inclusive prefix sum of
// dt * A,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j     (intra)
//         + exp(cums_i) C_i . state                                  (inter)
//   state = exp(cums_last) state + sum_j exp(cums_last - cums_j) dt_j x_j B_j^T
// and returns y in x's dtype and the final [hd, ds] state in fp32. The
// function does not depend on L up to rounding.
//
// Inputs are read through their strides in the model's layout: x [b,S,nh,hd],
// dt [b,S,nh] fp32, A [nh] fp32, B/C [b,S,1,ds] (one group, shared by every
// head). The ragged tail is masked in the kernels: positions >= S load dt =
// 0 (so exp(0 A) = 1 leaves the state as the last real position left it),
// x, B and C as zeros, and nothing is written past S. No padded copy is made.
//
// What bounds it on this card: the function needs the causal half of C.B^T
// once per chunk (one B/C group serves every head), and per head the causal
// half of the scores times dt x, C.state and the state update, about
// L^2 ds + L^2 hd + 4 L hd ds FLOPs, against reading x, dt, B, C once and
// writing y and the state once; at the main paths' shapes the bytes bound
// it: mamba2-130m (S = 1024, 24 heads, hd 64, ds 128) about 2.3 us at 3.35
// TB/s, jamba-v0.1-52b (S = 1024, 128 heads, hd 64, ds 16) about 10 us.
//
// d_state is a template parameter (DS, 128 and 16) of every kernel here;
// the wrapper picks the instance. No padded copy of a narrower state is
// made: at DS = 16 the scratch and every product shrink to the state's own
// width.
//
// bf16: the SSD algorithm's own steps (arXiv:2405.21060, section 6) on the
// tensor cores, in three launches over (chunk of CL = 64 positions, group
// of heads, batch row); the TPU grid (one sequential walk over the chunks a
// head) is not carried over. 64 is wgmma's M, so a chunk is one tile in
// every product, its C.B^T one 64 x 64 accumulator.
//   1. ssd_scan_states_kernel: per (chunk, head) the in-chunk scan of dt A,
//      w_j = exp(cums_last - cums_j) dt_j, and the chunk's contribution to
//      the state, X'^T . B with X' = x w, on wgmma.m64n64k16 (M = head dim,
//      N = d_state in two column blocks, K = the chunk's positions) into an
//      fp32 scratch [b, nc, nh, hd, ds]; and the chunk's decay
//      exp(cums_last). At DS = 16 the B chunk is transposed once a CTA
//      into the K-major operand of wgmma.m64n16k16 (an MN-major operand
//      16 wide does not fill a 128-byte swizzled row).
//   2. ssd_scan_pass_kernel: the state passing, sequential over chunks only,
//      one float4 of every head's state a thread: prev_c (the state entering
//      chunk c) = exp(cums_last,c-1) prev_c-1 + S_c-1 in fp32, stored for
//      chunk c as bf16 hi/lo planes; the last one is the final state.
//   3. ssd_scan_out_kernel: per (chunk, group of heads) C.B^T on wgmma once
//      per CTA, kept in registers for all of the CTA's heads; per head the
//      inter term C . prev^T (C exact), scaled by exp(cums_i) per row; then
//      P = C.B^T exp(cums_i - cums_j) dt_j for j <= i (dt folded in, so x
//      stays exact) as register A operands of y += P . x, x the MN-major B
//      operand, as flash does with P . V; y rounded to bf16 once, at the
//      store.
// Every fp32 operand of a product -- X', P and prev -- goes in as a hi/lo
// pair (hi = bf16(v), lo = bf16(v - hi), about 16 bits of mantissa), two
// wgmmas into one fp32 accumulator. One rounding of X' or of P puts y at or
// past the bf16 tolerance (5e-2, rtol 2e-2 of the fp32 plain version) at
// mamba2-130m's widths: the state sums every position's rounding and each
// output reads it through a 128-term product (tests/test_torch_ssd_plan.py
// states the plan and keeps those readings). DS = 16 keeps the pairs: no
// reading yet shows one rounding inside the tolerance at jamba's widths.
// The pairs cost wgmmas, which are far from the bound here, and no bytes of
// x, B or C. At DS = 16 the state products C.B^T and C.prev^T are one
// k-step each. Operands sit in shared memory under the 128-byte swizzle
// (wgmma_common.cuh), loaded by cp.async straight from the model's strided
// rows; a [64][16] operand keeps its 32-byte rows in the first two chunks
// of 128-byte rows. Launches 1 and 3 walk the CTA's heads with two stages:
// head k + 1's x, dt (and prev) load while head k computes. Launch 3 holds
// 98 KB of shared memory, two CTAs an SM (56 KB at DS = 16); the B chunk,
// needed only for C.B^T, shares its room with stage 1. Launch 1 holds 50 KB
// (42 KB at DS = 16). The launcher allocates the scratch (torch.empty) and
// picks the heads a CTA takes; prev of chunk 0 is never written or read (the
// state starts at 0).
//
// fp32: the CUDA-core kernel (ssd_scan_kernel), held to 3e-5 of the plain
// version, which TF32 products would miss. One CTA owns one (batch row,
// head, P columns of the head dim) and loops over the chunks itself, the
// [P, ds] fp32 slice of the state held in shared memory for the whole sweep;
// rows p of the state are independent, so the head dim splits across CTAs
// (at P = 16 a head is 4 CTAs). Inside a chunk it sweeps row tiles of 64
// positions and, for each, the column tiles j <= i, staging C and B tiles in
// shared memory as fp32, transposed to [ds][64]; the decay is exp(cums_i -
// cums_j) from differences (never a quotient of exponentials, which
// overflows), taken only where j <= i. The chunk length is the config's (a
// multiple of 64, at most 256). The three sums -- a score C_i . B_j over
// d_state, y_i over the state and up to a chunk of positions, the state's
// update -- and the in-chunk prefix sums of dt A run in fp64 (the fp32
// operands multiply exactly there), each rounded to fp32 once, the decay
// exponents as fp32 differences of fp64 sums. All in fp32 (the fp32 sums'
// rounding moves exp(cums_i - cums_j) by about 1e-5), the kernel sat up to
// 4.0e-5 from a float64 recurrence at b=8, S=2048 (|y| up to 21), one
// element 3.5e-5 from the plain version, past the 3e-5 tolerance; now 2.2e-6
// (NVIDIA H100 80GB HBM3, 700 W). fp64 runs at half the fp32 rate on this
// card; the fp32 path serves only fp32 models.
#include "attn_common.cuh"    // to_f32 / from_f32 and 16-byte vector unpacking
#include "wgmma_common.cuh"   // cp.async, wgmma and their descriptors

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int TILE = 64;       // positions per row / column tile
constexpr int TP = TILE + 4;   // pitch of a transposed [DS][TILE] tile
constexpr int SP = TILE + 4;   // pitch of the [TILE][TILE] score tile
constexpr int MAX_CHUNK = 256; // one scan element per thread
constexpr int P = 16;          // head-dim columns of the state per CTA

// d_state is a template parameter DS of every kernel below: 128
// (mamba2-130m) and 16 (jamba-v0.1-52b), the widths the serving path runs
template <int DS>
constexpr size_t smem_floats(int chunk) {
  // the fp64 prefix sums and scan carries first (two floats each), then
  // the fp32 arrays; the [P][DS] state at pitch DS + 1
  return 2 * ((size_t)chunk + NT / 32) + (size_t)P * (DS + 1) + 2 * (size_t)DS * TP +
         (size_t)TILE * SP + (size_t)chunk * P + 2 * (size_t)chunk;
}

// Stage ``n`` rows (from ``row0``, ``stride`` elements apart) of a [*, DS]
// operand as fp32, transposed to dst[s * TP + r]; rows at or past n become
// zeros. Each thread issues all its 16-byte loads before its first
// shared-memory store, so a tile costs one round trip to memory; consecutive
// threads take consecutive rows, so the transposed stores hit 32 banks.
template <int DS, typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* base, long long stride,
                                            int row0, int n, int tid) {
  constexpr int VN = Vec<T>::N;              // elements per 16-byte vector
  constexpr int PER = TILE * DS / VN / NT;   // vectors per thread
  static_assert(PER * VN * NT == TILE * DS, "a tile in whole vectors");
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = tid + i * NT;
    const int r = u % TILE;
    v[i] = r < n ? *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * stride +
                                                   (u / TILE) * VN)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = tid + i * NT;
    float f[VN];
    Vec<T>::unpack(v[i], f);
    float* col = dst + (u / TILE) * VN * TP + u % TILE;
#pragma unroll
    for (int k = 0; k < VN; ++k) col[k * TP] = f[k];
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state_out,
                int S, int nh, int hd, int chunk, long long sxb, long long sxs, long long sxh,
                long long sdb, long long sds, long long sdh, long long sbb, long long sbs,
                long long scb, long long scs) {
  // thread roles: RA rows x 1 column of the [TILE, P] output tile; a 4x4
  // block of the [TILE, TILE] score tile; SK rows x 1 column of the state
  constexpr int RA = TILE * P / NT;  // 4
  constexpr int SK = P * DS / NT;    // 8 at DS 128, 1 at DS 16
  constexpr int STP = DS + 1;        // pitch of the [P][DS] state
  static_assert(RA % 4 == 0 && SK * NT == P * DS && NT % DS == 0, "tile shapes");

  extern __shared__ __align__(16) float smem[];
  double* cums = reinterpret_cast<double*>(smem);  // [chunk] in-chunk prefix sum of dt * A
  double* red = cums + chunk;                       // [NT / 32] scan carries
  float* st = reinterpret_cast<float*>(red + NT / 32);  // [P][STP] the state slice
  float* cT = st + P * STP;         // [DS][TP] C tile, transposed
  float* bT = cT + DS * TP;         // [DS][TP] B tile, transposed
  float* sc = bT + DS * TP;         // [TILE][SP] decayed scores
  float* xa = sc + TILE * SP;       // [chunk][P] dt * x
  float* wend = xa + chunk * P;     // [chunk] exp(cums_last - cums_j)
  float* dts = wend + chunk;        // [chunk] dt, zero past the sequence

  const int p0 = blockIdx.x * P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float a = A[h];

  const T* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + b * sdb + h * sdh;
  const T* Bb = Bm + b * sbb;
  const T* Cb = Cm + b * scb;
  T* yb = y + ((long long)b * S * nh + h) * hd + p0;  // y: contiguous [b,S,nh,hd]

  const int ty = tid >> 4, tx = tid & 15;      // score block rows 4ty.., cols 4tx..
  const int yp = tid % P, yr = (tid / P) * RA;  // output column, first row
  const int ss = tid % DS, sp = (tid / DS) * SK;  // state column, first row

  for (int e = tid; e < P * STP; e += NT) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int Lc = min(chunk, S - c0);
    __syncthreads();  // the previous chunk is done with xa, cums, wend, st

    // this chunk's P columns of x as 16-byte vectors, loads issued first
    constexpr int XV = P / Vec<T>::N;                  // vectors per row
    constexpr int XPER = MAX_CHUNK * XV / NT;          // vectors per thread
    uint4 xv[XPER];
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
      const int u = tid + i * NT;
      const int j = u / XV;
      xv[i] = j < Lc ? *reinterpret_cast<const uint4*>(xb + (long long)(c0 + j) * sxs +
                                                       (u % XV) * Vec<T>::N)
                     : make_uint4(0u, 0u, 0u, 0u);
    }

    // in-chunk inclusive prefix sum of dt * A: warp scans, then the carries
    const float d = tid < Lc ? dtb[(long long)(c0 + tid) * sds] : 0.f;
    if (tid < chunk) dts[tid] = d;
    double v = (double)d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    // dt * x (zero past the sequence: x and dt load as zeros there)
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
      const int u = tid + i * NT;
      const int j = u / XV;
      if (j < chunk) {
        float f[Vec<T>::N];
        Vec<T>::unpack(xv[i], f);
        float* dst = xa + j * P + (u % XV) * Vec<T>::N;
#pragma unroll
        for (int k = 0; k < Vec<T>::N; ++k) dst[k] = f[k] * dts[j];
      }
    }
    if (warp == 0) {
      double w = lane < NT / 32 ? red[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < NT / 32; o <<= 1) {
        const double n = __shfl_up_sync(FULL_MASK, w, o);
        if (lane >= o) w += n;
      }
      if (lane < NT / 32) red[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += red[warp - 1];
    if (tid < chunk) cums[tid] = v;
    __syncthreads();
    const double clast = cums[Lc - 1];
    for (int j = tid; j < chunk; j += NT)
      wend[j] = j < Lc ? expf((float)(clast - cums[j])) : 0.f;
    const float chunk_decay = expf((float)clast);

    const int nti = (Lc + TILE - 1) / TILE;
    for (int ti = 0; ti < nti; ++ti) {
      const int i0 = ti * TILE;
      const bool last = ti == nti - 1;
      load_tile_t<DS>(cT, Cb, scs, c0 + i0, min(TILE, Lc - i0), tid);
      __syncthreads();

      // inter-chunk term: exp(cums_i) C_i . state[p, :]
      double acc[RA];
#pragma unroll
      for (int k = 0; k < RA; ++k) acc[k] = 0.0;
      for (int s = 0; s < DS; ++s) {
        const double stv = st[yp * STP + s];
#pragma unroll
        for (int k = 0; k < RA; k += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(cT + s * TP + yr + k);
          acc[k] += c4.x * stv;
          acc[k + 1] += c4.y * stv;
          acc[k + 2] += c4.z * stv;
          acc[k + 3] += c4.w * stv;
        }
      }
#pragma unroll
      for (int k = 0; k < RA; ++k) acc[k] *= expf((float)cums[i0 + yr + k]);

      // the last row tile also carries the state to the chunk's end
      double sacc[SK];
      if (last) {
#pragma unroll
        for (int k = 0; k < SK; ++k) sacc[k] = (double)st[(sp + k) * STP + ss] * chunk_decay;
      }

      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * TILE;
        __syncthreads();  // the previous B tile and scores are consumed
        load_tile_t<DS>(bT, Bb, sbs, c0 + j0, min(TILE, Lc - j0), tid);
        __syncthreads();

        // scores: a 4x4 block of C_i . B_j, decayed and masked to j <= i
        double sblk[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sblk[r][c] = 0.0;
        for (int s = 0; s < DS; ++s) {
          const float4 cv = *reinterpret_cast<const float4*>(cT + s * TP + 4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(bT + s * TP + 4 * tx);
          const double cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sblk[r][c] += cr[r] * bc[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ty + r;
          const double ci = cums[i0 + i];
          float out[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 4 * tx + c;
            out[c] = j0 + j <= i0 + i
                         ? (float)(sblk[r][c] * expf((float)(ci - cums[j0 + j])))
                         : 0.f;
          }
          *reinterpret_cast<float4*>(sc + i * SP + 4 * tx) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();

        // intra-chunk term: scores times dt * x
        for (int j = 0; j < TILE; j += 4) {
          double xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xa[(j0 + j + q) * P + yp];
#pragma unroll
          for (int k = 0; k < RA; ++k) {
            const float4 s4 = *reinterpret_cast<const float4*>(sc + (yr + k) * SP + j);
            acc[k] += s4.x * xv[0];
            acc[k] += s4.y * xv[1];
            acc[k] += s4.z * xv[2];
            acc[k] += s4.w * xv[3];
          }
        }

        // state injection: dt_j x_j[p] exp(cums_last - cums_j) B_j[s]
        if (last) {
          for (int j = 0; j < TILE; j += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bT + ss * TP + j);
            const float4 w4 = *reinterpret_cast<const float4*>(wend + j0 + j);
            const double bw[4] = {(double)b4.x * w4.x, (double)b4.y * w4.y,
                                  (double)b4.z * w4.z, (double)b4.w * w4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float* xrow = xa + (j0 + j + q) * P + sp;
              if constexpr (SK % 4 == 0) {
#pragma unroll
                for (int k = 0; k < SK; k += 4) {
                  const float4 x4 = *reinterpret_cast<const float4*>(xrow + k);
                  sacc[k] += x4.x * bw[q];
                  sacc[k + 1] += x4.y * bw[q];
                  sacc[k + 2] += x4.z * bw[q];
                  sacc[k + 3] += x4.w * bw[q];
                }
              } else {
#pragma unroll
                for (int k = 0; k < SK; ++k) sacc[k] += xrow[k] * bw[q];
              }
            }
          }
        }
      }

#pragma unroll
      for (int k = 0; k < RA; ++k) {
        const int i = i0 + yr + k;
        if (i < Lc) yb[(long long)(c0 + i) * nh * hd + yp] = from_f32<T>((float)acc[k]);
      }
      if (last) {
        // every thread read the old state (inter term) before the column
        // sweep's first barrier; each writes only its own elements
#pragma unroll
        for (int k = 0; k < SK; ++k) st[(sp + k) * STP + ss] = (float)sacc[k];
      }
    }
  }

  __syncthreads();
  float* sout = state_out + (((long long)b * nh + h) * hd + p0) * DS;
  for (int e = tid; e < P * DS; e += NT) {
    const int p = e / DS;
    sout[e] = st[p * STP + (e - p * DS)];
  }
}

template <typename T, int DS>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state_out, int b, int S, int nh, int hd, int chunk, long long sxb,
           long long sxs, long long sxh, long long sdb, long long sds, long long sdh,
           long long sbb, long long sbs, long long scb, long long scs, cudaStream_t stream) {
  if (chunk % TILE || chunk > MAX_CHUNK || hd % P || S <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<DS>(chunk) * sizeof(float);
  auto kernel = ssd_scan_kernel<T, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hd / P, nh, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state_out), S, nh, hd, chunk, sxb, sxs, sxh, sdb, sds, sdh, sbb,
      sbs, scb, scs);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int WG = 128;           // one warpgroup a CTA
constexpr int CL = 64;            // positions a chunk: wgmma's M
constexpr int HDW = 64;           // head dim of the tensor-core path
constexpr int TB64 = 64 * 128;    // bytes of a 64-row, 128-byte column block
constexpr int PASS_THREADS = 256;

// 128-byte column blocks of a [rows][DS] bf16 tile with d_state contiguous:
// DS / 64, and one at DS = 16, whose 32-byte rows take the first two 16-byte
// chunks of each 128-byte row (wgmma's one k-step over d_state reads just
// those), so every such operand keeps the 128-byte swizzle and its
// 1024-byte 8-row stride
template <int DS>
__host__ __device__ constexpr int col_blocks() {
  static_assert(DS == 16 || DS % 64 == 0, "d_state 16 or a multiple of 64");
  return DS >= 64 ? DS / 64 : 1;
}

template <int DS>
constexpr size_t states_smem() {
  return (col_blocks<DS>() + 4) * TB64 + (3 * CL + 2) * sizeof(float) + 1024;
}
template <int DS>
constexpr size_t out_smem() {
  return (col_blocks<DS>() + 2 * (1 + 2 * col_blocks<DS>())) * TB64 +
         (3 * CL + 2) * sizeof(float) + 1024;
}

// the in-chunk inclusive prefix sum of dt * A over CL = 64 positions, held
// by warps 0 and 1 (thread t: position t); ``red`` takes the two warp sums.
// Returns cums_t; ``last`` receives cums_63. Every thread of the CTA calls it.
__device__ __forceinline__ float chunk_cumsum(float v, int warp, int lane, float* red,
                                              float& last) {
  if (warp < 2) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) red[warp] = v;
  }
  __syncthreads();
  last = red[0] + red[1];
  return warp == 1 ? v + red[0] : v;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (a, b) as a bf16 pair hi = bf16(v) and a pair lo = bf16(v - hi): hi + lo
// holds v to about 16 bits of mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Launch 1: each chunk's contribution to the state, per head.
template <int DS>
__global__ void __launch_bounds__(WG)
ssd_scan_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decay, int S, int nh,
                       int nc, int hpc, long long sxb, long long sxs, long long sxh,
                       long long sdb, long long sds, long long sdh, long long sbb,
                       long long sbs) {
  constexpr int CB = col_blocks<DS>();
  constexpr int CPR = DS / 8;  // 16-byte chunks of a B row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  // the B chunk: at DS >= 64 [64 j][DS s], the MN-major operand (CB column
  // blocks); at DS = 16 it lands unswizzled ([64 j][32 bytes]) and is
  // transposed once a CTA to B^T [16 s][64 j] at +TB64 / 2, the K-major
  // operand of an m64n16 product (an MN-major operand 16 wide does not fill
  // the 128-byte swizzle's rows). Then X'^T hi and lo [64 p][64 j] (K-major
  // operands); x of two stages [64 j][64 p], unswizzled; dt of two stages,
  // w, the scan's warp sums
  const uint32_t sB = base, sA = base + CB * TB64, sX = sA + 2 * TB64;
  float* dts = reinterpret_cast<float*>(sm + (CB + 4) * TB64);
  float* ws = dts + 2 * CL;
  float* red = ws + CL;

  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpc;
  const int nheads = min(hpc, nh - h0);
  const int c0 = c * CL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* Bb = Bm + b * sbb;
#pragma unroll
  for (int u = 0; u < CL * CPR / WG; ++u) {
    const int e = tid + u * WG;
    const int r = e / CPR, ch = e % CPR;
    const bool ok = c0 + r < S;
    const uint32_t dst = DS >= 64 ? sB + sw128(r, ch, CL) : sB + r * (2 * DS) + ch * 16;
    cp_async16(dst, Bb + (ok ? c0 + r : 0) * sbs + ch * 8, ok);
  }
  auto stage = [&](int k, int st) {
    const int h = h0 + k;
    const bf16* xb = x + b * sxb + h * sxh;
#pragma unroll
    for (int u = 0; u < CL * 8 / WG; ++u) {
      const int e = tid + u * WG;
      const int r = e >> 3, ch = e & 7;
      const bool ok = c0 + r < S;
      cp_async16(sX + st * TB64 + r * 128 + ch * 16, xb + (ok ? c0 + r : 0) * sxs + ch * 8, ok);
    }
    if (tid < CL) {
      const bool ok = c0 + tid < S;
      cp_async4(smem_addr(dts + st * CL + tid),
                dt + b * sdb + (ok ? c0 + tid : 0) * sds + h * sdh, ok);
    }
  };
  stage(0, 0);
  cp_async_commit();

  for (int k = 0; k < nheads; ++k) {
    const int st = k & 1, h = h0 + k;
    if (k + 1 < nheads) stage(k + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // head k's stage (and the B chunk) landed
    __syncthreads();

    if constexpr (DS < 64) {
      if (k == 0) {  // B^T, K-major: row s, 16-byte chunk q holds B[8q + t][s], t < 8
        const bf16* bs = reinterpret_cast<const bf16*>(sm);
        for (int e = tid; e < DS * (CL / 8); e += WG) {
          const int s = e % DS, q = e / DS;
          uint32_t w[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            __nv_bfloat162 pr;
            pr.x = bs[(8 * q + 2 * t) * DS + s];
            pr.y = bs[(8 * q + 2 * t + 1) * DS + s];
            w[t] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          *reinterpret_cast<uint4*>(sm + TB64 / 2 + sw128(s, q, DS)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }

    const float d = warp < 2 ? dts[st * CL + tid] : 0.f;
    float last;
    const float cums = chunk_cumsum(d * A[h], warp, lane, red, last);
    if (warp < 2) ws[tid] = expf(last - cums) * d;
    if (tid == 0) decay[((long long)b * nc + c) * nh + h] = expf(last);
    __syncthreads();

    // X'^T = (x w)^T as a hi/lo pair, K-major: row p, 16-byte chunk q holds
    // x[8q + t][p] w[8q + t], t < 8
    const bf16* xs = reinterpret_cast<const bf16*>(sm + (sX - base) + st * TB64);
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
      *reinterpret_cast<uint4*>(sm + (sA - base) + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm + (sA - base) + TB64 + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_shared();
    __syncthreads();

    // state contribution [64 p][DS s] = (X'hi + X'lo)^T . B, K = the chunk's
    // 64 positions
    float* out = states + (((long long)b * nc + c) * nh + h) * (HDW * DS);
    if constexpr (DS >= 64) {
      float dacc[CB][32];
#pragma unroll
      for (int i = 0; i < CB; ++i) {
#pragma unroll
        for (int j = 0; j < 32; ++j) dacc[i][j] = 0.f;
        fence_regs(dacc[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        const uint64_t hi = wg_desc(sA + kk * 32, 16, 1024, 1);
        const uint64_t lo = wg_desc(sA + TB64 + kk * 32, 16, 1024, 1);
#pragma unroll
        for (int i = 0; i < CB; ++i) {
          const uint64_t bi = wg_desc(sB + i * TB64 + kk * 16 * 128, 1024, 1024, 1);
          wgmma_ss_n64<1>(dacc[i], hi, bi, kk > 0);
          wgmma_ss_n64<1>(dacc[i], lo, bi, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < CB; ++i) fence_regs(dacc[i]);
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        float* o = out + frag_row(j, warp, lane) * DS + frag_col(j, lane);
#pragma unroll
        for (int i = 0; i < CB; ++i)
          *reinterpret_cast<float2*>(o + 64 * i) = make_float2(dacc[i][j], dacc[i][j + 1]);
      }
    } else {
      float dacc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) dacc[j] = 0.f;
      fence_regs(dacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        const uint64_t hi = wg_desc(sA + kk * 32, 16, 1024, 1);
        const uint64_t lo = wg_desc(sA + TB64 + kk * 32, 16, 1024, 1);
        const uint64_t bt = wg_desc(sB + TB64 / 2 + kk * 32, 16, 1024, 1);
        wgmma_ss_n16(dacc, hi, bt, kk > 0);
        wgmma_ss_n16(dacc, lo, bt, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dacc);
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        *reinterpret_cast<float2*>(out + frag_row(j, warp, lane) * DS + frag_col(j, lane)) =
            make_float2(dacc[j], dacc[j + 1]);
    }
    __syncthreads();  // X'^T, w, the warp sums and this stage are free
  }
}

// Launch 2: the state passing, one float4 of one head's state a thread.
template <int DS>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_scan_pass_kernel(const float* __restrict__ states, const float* __restrict__ decay,
                     bf16* __restrict__ prev, float* __restrict__ state_out, int nh,
                     int nc) {
  constexpr int HEAD4 = HDW * DS / 4;  // float4s of one head's state
  const int b = blockIdx.y;
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= nh * HEAD4) return;
  const int h = e / HEAD4;
  const int o = e - h * HEAD4;
  const long long slab = (long long)nh * HEAD4;  // float4s of one chunk's states
  const float4* sp = reinterpret_cast<const float4*>(states) + (long long)b * nc * slab + e;
  const float* dp = decay + (long long)b * nc * nh + h;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float4 s = sp[c * slab];
    const float dcy = dp[(long long)c * nh];
    if (c > 0) {
      bf16* pp = prev + (((long long)b * nc + c) * nh + h) * (2 * HDW * DS) + 4 * o;
      uint2 hi, lo;
      split_bf16(carry.x, carry.y, hi.x, lo.x);
      split_bf16(carry.z, carry.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(pp) = hi;
      *reinterpret_cast<uint2*>(pp + HDW * DS) = lo;
    }
    carry = make_float4(carry.x * dcy + s.x, carry.y * dcy + s.y, carry.z * dcy + s.z,
                        carry.w * dcy + s.w);
  }
  reinterpret_cast<float4*>(state_out)[(long long)b * slab + e] = carry;
}

// Launch 3: each chunk's outputs, per group of heads.
template <int DS>
__global__ void __launch_bounds__(WG, 2)
ssd_scan_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ prev,
                    bf16* __restrict__ y, int S, int nh, int nc, int hpc, long long sxb,
                    long long sxs, long long sxh, long long sdb, long long sds, long long sdh,
                    long long sbb, long long sbs, long long scb, long long scs) {
  constexpr int CB = col_blocks<DS>();
  constexpr int CPR = DS / 8;  // 16-byte chunks of a [*][DS] row
  // a stage: x [64 j][64 p], prev hi and lo [64 p][DS s]
  constexpr uint32_t STAGE = (1 + 2 * CB) * TB64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  // C chunk [64 i][DS s] (K-major), then two stages; the B chunk [64 j][DS s]
  // (K-major) sits where stage 1 goes, and is dead once C.B^T is taken
  const uint32_t sC = base, sS0 = base + CB * TB64, sB = sS0 + STAGE;
  float* dts = reinterpret_cast<float*>(sm + CB * TB64 + 2 * STAGE);  // [2][CL]
  float* cs = dts + 2 * CL;                                          // [CL]
  float* red = cs + CL;

  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpc;
  const int nheads = min(hpc, nh - h0);
  const int c0 = c * CL;
  const bool carry_in = c > 0;  // chunk 0 starts from the zero state
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* Bb = Bm + b * sbb;
  const bf16* Cb = Cm + b * scb;
#pragma unroll
  for (int u = 0; u < CL * CPR / WG; ++u) {
    const int e = tid + u * WG;
    const int r = e / CPR, ch = e % CPR;
    const bool ok = c0 + r < S;
    const long long row = ok ? c0 + r : 0;
    cp_async16(sC + sw128(r, ch, CL), Cb + row * scs + ch * 8, ok);
    cp_async16(sB + sw128(r, ch, CL), Bb + row * sbs + ch * 8, ok);
  }
  auto stage = [&](int k, int st) {
    const int h = h0 + k;
    const uint32_t sx = sS0 + st * STAGE;
    const bf16* xb = x + b * sxb + h * sxh;
#pragma unroll
    for (int u = 0; u < CL * 8 / WG; ++u) {
      const int e = tid + u * WG;
      const int r = e >> 3, ch = e & 7;
      const bool ok = c0 + r < S;
      cp_async16(sx + sw128(r, ch, CL), xb + (ok ? c0 + r : 0) * sxs + ch * 8, ok);
    }
    if (carry_in) {
      const bf16* ph = prev + (((long long)b * nc + c) * nh + h) * (2 * HDW * DS);
#pragma unroll
      for (int u = 0; u < HDW * CPR / WG; ++u) {
        const int e = tid + u * WG;
        const int r = e / CPR, ch = e % CPR;
        cp_async16(sx + TB64 + sw128(r, ch, HDW), ph + r * DS + ch * 8, true);
        cp_async16(sx + (1 + CB) * TB64 + sw128(r, ch, HDW), ph + HDW * DS + r * DS + ch * 8,
                   true);
      }
    }
    if (tid < CL) {
      const bool ok = c0 + tid < S;
      cp_async4(smem_addr(dts + st * CL + tid),
                dt + b * sdb + (ok ? c0 + tid : 0) * sds + h * sdh, ok);
    }
  };
  stage(0, 0);
  cp_async_commit();
  cp_async_wait0();
  fence_async_shared();
  __syncthreads();

  // C.B^T of the chunk, once for all of the CTA's heads, K = d_state
  float cb[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) cb[j] = 0.f;
  fence_regs(cb);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DS / 16; ++kk) {
    const uint32_t off = (kk >> 2) * TB64 + (kk & 3) * 32;
    wgmma_ss_n64(cb, wg_desc(sC + off, 16, 1024, 1), wg_desc(sB + off, 16, 1024, 1), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(cb);
  __syncthreads();  // the B chunk is read: stage 1 may take its room

  const int ra = warp * 16 + (lane >> 2);  // this thread's rows ra, ra + 8
  bf16* yb = y + ((long long)b * S + c0) * nh * HDW;
  for (int k = 0; k < nheads; ++k) {
    const int st = k & 1, h = h0 + k;
    if (k + 1 < nheads) stage(k + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // head k's stage landed
    fence_async_shared();
    __syncthreads();
    const uint32_t sx = sS0 + st * STAGE;

    // the inter term on the tensor cores: C . prev^T, prev = hi + lo
    float yacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) yacc[j] = 0.f;
    if (carry_in) {
      fence_regs(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        const uint32_t off = (kk >> 2) * TB64 + (kk & 3) * 32;
        wgmma_ss_n64(yacc, wg_desc(sC + off, 16, 1024, 1),
                     wg_desc(sx + TB64 + off, 16, 1024, 1), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        const uint32_t off = (kk >> 2) * TB64 + (kk & 3) * 32;
        wgmma_ss_n64(yacc, wg_desc(sC + off, 16, 1024, 1),
                     wg_desc(sx + (1 + CB) * TB64 + off, 16, 1024, 1), 1);
      }
      wgmma_commit();
    }

    // meanwhile the in-chunk prefix sum of dt * A and the scores P as a
    // hi/lo pair of register A operands
    const float* dth = dts + st * CL;
    float last;
    const float cums = chunk_cumsum(warp < 2 ? dth[tid] * A[h] : 0.f, warp, lane, red, last);
    if (warp < 2) cs[tid] = cums;
    __syncthreads();
    const float ci[2] = {cs[ra], cs[ra + 8]};
    uint32_t pa[CL / 16][4], pl[CL / 16][4];
#pragma unroll
    for (int kk = 0; kk < CL / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 8 * kk + 2 * u;  // elements j, j + 1: row i, columns jc, jc + 1
        const int i = frag_row(j, warp, lane), jc = frag_col(j, lane);
        const float p0 = jc <= i ? cb[j] * expf(ci[u & 1] - cs[jc]) * dth[jc] : 0.f;
        const float p1 =
            jc + 1 <= i ? cb[j + 1] * expf(ci[u & 1] - cs[jc + 1]) * dth[jc + 1] : 0.f;
        split_bf16(p0, p1, pa[kk][u], pl[kk][u]);
      }
    if (carry_in) {
      wgmma_wait0();
      fence_regs(yacc);
      const float e0 = expf(ci[0]), e1 = expf(ci[1]);
#pragma unroll
      for (int j = 0; j < 32; ++j) yacc[j] *= ((j >> 1) & 1) ? e1 : e0;
    }

    // y += (Phi + Plo) . x, x the MN-major operand
    fence_regs(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CL / 16; ++kk) {
      const uint64_t dx = wg_desc(sx + kk * 16 * 128, 1024, 1024, 1);
      wgmma_rs_n64(yacc, pa[kk], dx);
      wgmma_rs_n64(yacc, pl[kk], dx);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(yacc);

#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int i = frag_row(j, warp, lane);
      if (c0 + i < S)
        *reinterpret_cast<uint32_t*>(yb + (long long)i * nh * HDW + h * HDW +
                                     frag_col(j, lane)) = pack_bf16(yacc[j], yacc[j + 1]);
    }
    __syncthreads();  // this stage, the cums and the warp sums are free
  }
}

template <int DS>
int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                void* y, void* state_out, void* scratch, int b, int S, int nh, int hd, int hpc,
                long long sxb, long long sxs, long long sxh, long long sdb, long long sds,
                long long sdh, long long sbb, long long sbs, long long scb, long long scs,
                cudaStream_t stream) {
  if (hd != HDW || hpc < 1 || S <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  constexpr size_t STATES_SMEM = states_smem<DS>(), OUT_SMEM = out_smem<DS>();
  auto states_kernel = ssd_scan_states_kernel<DS>;
  auto out_kernel = ssd_scan_out_kernel<DS>;
  cudaError_t err = cudaFuncSetAttribute(
      states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STATES_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)OUT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nc = (S + CL - 1) / CL;
  const dim3 grid(nc, (nh + hpc - 1) / hpc, b);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  // scratch: the chunk states (fp32), the entering states' hi/lo planes
  // (bf16, as many bytes), the chunks' decays (fp32)
  const long long n_state = (long long)b * nc * nh * HDW * DS;
  float* st = static_cast<float*>(scratch);
  bf16* pv = reinterpret_cast<bf16*>(st + n_state);
  float* dc = st + 2 * n_state;
  states_kernel<<<grid, WG, STATES_SMEM, stream>>>(
      xb, dtf, Af, Bb, st, dc, S, nh, nc, hpc, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int HEAD4 = HDW * DS / 4;
  ssd_scan_pass_kernel<DS><<<dim3((nh * HEAD4 + PASS_THREADS - 1) / PASS_THREADS, b),
                             PASS_THREADS, 0, stream>>>(st, dc, pv,
                                                        static_cast<float*>(state_out), nh, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  out_kernel<<<grid, WG, OUT_SMEM, stream>>>(
      xb, dtf, Af, Bb, static_cast<const bf16*>(Cm), pv, static_cast<bf16*>(y), S, nh, nc,
      hpc, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32. x: [b, S, nh, hd], dt: [b, S, nh] fp32, B/C: [b, S, 1, ds] addressed
// through the given element strides (x's and B/C's last dim contiguous); A:
// [nh] fp32; y: contiguous [b, S, nh, hd]; state_out: contiguous
// [b, nh, hd, ds] fp32; ds 128 or 16, hd a multiple of P, chunk a multiple
// of 64 up to 256. Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state_out, int b, int S, int nh,
                            int hd, int ds, int chunk, long long sxb, long long sxs,
                            long long sxh, long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long scb, long long scs,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 128:
      return launch<float, 128>(x, dt, A, Bm, Cm, y, state_out, b, S, nh, hd, chunk, sxb, sxs,
                                sxh, sdb, sds, sdh, sbb, sbs, scb, scs, st);
    case 16:
      return launch<float, 16>(x, dt, A, Bm, Cm, y, state_out, b, S, nh, hd, chunk, sxb, sxs,
                               sxh, sdb, sds, sdh, sbb, sbs, scb, scs, st);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16, the same layouts with hd == 64 and 16-byte-aligned rows, plus one
// scratch buffer of (2 b nc nh hd ds + b nc nh) fp32 words, nc = ceil(S /
// 64): the chunk states [b, nc, nh, hd, ds] fp32, the entering states
// [b, nc, nh, 2, hd, ds] bf16, the decays [b, nc, nh] fp32; ``hpc`` heads a
// CTA; ds 128 or 16. Three launches on ``stream``; returns the first non-zero cudaError_t.
extern "C" int ssd_scan_bf16_fwd(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y, void* state_out,
                                 void* scratch, int b, int S, int nh, int hd, int ds, int hpc,
                                 long long sxb, long long sxs, long long sxh, long long sdb,
                                 long long sds, long long sdh, long long sbb, long long sbs,
                                 long long scb, long long scs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 128:
      return launch_bf16<128>(x, dt, A, Bm, Cm, y, state_out, scratch, b, S, nh, hd, hpc, sxb,
                              sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs, st);
    case 16:
      return launch_bf16<16>(x, dt, A, Bm, Cm, y, state_out, scratch, b, S, nh, hd, hpc, sxb,
                             sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs, st);
  }
  return (int)cudaErrorInvalidValue;
}
