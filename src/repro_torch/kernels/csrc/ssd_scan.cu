// Chunked Mamba-2 SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_bhsd
// (body _ssd_kernel). It computes the same function, in fp32 throughout, from
// a zero state: for each chunk of L positions, with cums the in-chunk
// inclusive prefix sum of dt * A,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j     (intra)
//         + exp(cums_i) C_i . state                                  (inter)
//   state = exp(cums_last) state + sum_j exp(cums_last - cums_j) dt_j x_j B_j^T
// and returns y in x's dtype and the final [hd, ds] state in fp32.
//
// Design. The TPU kernel walks the chunks as the innermost, sequential grid
// dimension and keeps the state in VMEM scratch; Hopper's blocks run in no
// order, so here one CTA owns one (batch row, head, P columns of the head
// dim) and loops over the chunks itself, the [P, ds] fp32 slice of the state
// held in shared memory for the whole sweep. Rows p of the state are
// independent (y[:, p] needs only state[p, :] and (x dt)[:, p]), so the
// head dim splits across CTAs: at P = 16 a head is 4 CTAs, 96 for the 24
// heads of mamba2-130m at batch 1, where one CTA per head would fill 24 of
// the 132 SMs. Each of a head's CTAs recomputes the C.B^T scores it needs.
//
// Inside a chunk the L x L score matrix is never held whole: the CTA sweeps
// row tiles of 64 positions, and for each the column tiles j <= i (tiles
// above the diagonal are skipped, as the flash kernel skips causal tiles),
// staging C and B tiles in shared memory as fp32, transposed to [ds][64] so
// that a thread's 4x4 block of scores reads two 16-byte vectors per step of
// the ds sum. Tiles and x load as 16-byte vectors, each thread issuing all
// its loads before its first shared-memory store. The decay is exp(cums_i - cums_j) from differences (never a
// quotient of exponentials, which overflows), and is taken only where j <= i.
// The in-chunk prefix sum of dt * A is a block-wide fp32 scan. The last row
// tile of a chunk visits every column tile, and injects each B tile into the
// state as it passes.
//
// Inputs are read through their strides in the model's layout: x [b,S,nh,hd],
// dt [b,S,nh] fp32, A [nh] fp32, B/C [b,S,1,ds] (one group, shared by every
// head: the heads' CTAs read the same rows from L2, where the JAX wrapper
// broadcasts them to all heads and transposes every operand). The chunk
// length is the config's (a multiple of 64, at most 256); the ragged tail is
// masked in the kernel: positions >= S take dt = 0, so exp(0 A) = 1 leaves
// the state exactly as the last real position left it, B and C load as zeros,
// and nothing is written past S. No padded copy is made.
//
// What bounds it on this card: the function needs the causal half of C.B^T
// once per chunk (one B/C group serves every head), and per head the causal
// half of the scores times dt x, C.state and the state update, about
// L^2 ds + L^2 hd + 4 L hd ds FLOPs, against reading x, dt, B, C once and
// writing y and the state once; at the main path's shapes (S = 1024, 24
// heads, hd 64, ds 128) the bytes bound it (about 2.3 us at 3.35 TB/s).
// This first kernel does its products with fp32 FMAs on the CUDA cores, and
// each CTA recomputes C.B^T; one C.B^T per chunk on wgmma is the later fix.
#include "attn_common.cuh"  // to_f32 / from_f32 and 16-byte vector unpacking

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int TILE = 64;       // positions per row / column tile
constexpr int DS = 128;        // d_state
constexpr int TP = TILE + 4;   // pitch of a transposed [DS][TILE] tile
constexpr int SP = TILE + 4;   // pitch of the [TILE][TILE] score tile
constexpr int STP = DS + 1;    // pitch of the [P][DS] state
constexpr int MAX_CHUNK = 256; // one scan element per thread
constexpr int P = 16;          // head-dim columns of the state per CTA

constexpr size_t smem_floats(int chunk) {
  return (size_t)P * STP + 2 * (size_t)DS * TP + (size_t)TILE * SP + (size_t)chunk * P +
         3 * (size_t)chunk + NT / 32;
}

// Stage ``n`` rows (from ``row0``, ``stride`` elements apart) of a [*, DS]
// operand as fp32, transposed to dst[s * TP + r]; rows at or past n become
// zeros. Each thread issues all its 16-byte loads before its first
// shared-memory store, so a tile costs one round trip to memory; consecutive
// threads take consecutive rows, so the transposed stores hit 32 banks.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* base, long long stride,
                                            int row0, int n, int tid) {
  constexpr int VN = Vec<T>::N;              // elements per 16-byte vector
  constexpr int PER = TILE * DS / VN / NT;   // vectors per thread
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

template <typename T>
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
  constexpr int SK = P * DS / NT;    // 8
  static_assert(RA % 4 == 0 && SK % 4 == 0 && NT % DS == 0, "tile shapes");

  extern __shared__ __align__(16) float smem[];
  float* st = smem;                 // [P][STP] the state slice
  float* cT = st + P * STP;         // [DS][TP] C tile, transposed
  float* bT = cT + DS * TP;         // [DS][TP] B tile, transposed
  float* sc = bT + DS * TP;         // [TILE][SP] decayed scores
  float* xa = sc + TILE * SP;       // [chunk][P] dt * x
  float* cums = xa + chunk * P;     // [chunk] in-chunk prefix sum of dt * A
  float* wend = cums + chunk;       // [chunk] exp(cums_last - cums_j)
  float* dts = wend + chunk;        // [chunk] dt, zero past the sequence
  float* red = dts + chunk;         // [NT / 32] scan carries

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
    float v = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL_MASK, v, o);
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
      float w = lane < NT / 32 ? red[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < NT / 32; o <<= 1) {
        const float n = __shfl_up_sync(FULL_MASK, w, o);
        if (lane >= o) w += n;
      }
      if (lane < NT / 32) red[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += red[warp - 1];
    if (tid < chunk) cums[tid] = v;
    __syncthreads();
    const float clast = cums[Lc - 1];
    for (int j = tid; j < chunk; j += NT) wend[j] = j < Lc ? expf(clast - cums[j]) : 0.f;
    const float chunk_decay = expf(clast);

    const int nti = (Lc + TILE - 1) / TILE;
    for (int ti = 0; ti < nti; ++ti) {
      const int i0 = ti * TILE;
      const bool last = ti == nti - 1;
      load_tile_t(cT, Cb, scs, c0 + i0, min(TILE, Lc - i0), tid);
      __syncthreads();

      // inter-chunk term: exp(cums_i) C_i . state[p, :]
      float acc[RA];
#pragma unroll
      for (int k = 0; k < RA; ++k) acc[k] = 0.f;
      for (int s = 0; s < DS; ++s) {
        const float stv = st[yp * STP + s];
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
      for (int k = 0; k < RA; ++k) acc[k] *= expf(cums[i0 + yr + k]);

      // the last row tile also carries the state to the chunk's end
      float sacc[SK];
      if (last) {
#pragma unroll
        for (int k = 0; k < SK; ++k) sacc[k] = st[(sp + k) * STP + ss] * chunk_decay;
      }

      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * TILE;
        __syncthreads();  // the previous B tile and scores are consumed
        load_tile_t(bT, Bb, sbs, c0 + j0, min(TILE, Lc - j0), tid);
        __syncthreads();

        // scores: a 4x4 block of C_i . B_j, decayed and masked to j <= i
        float sblk[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sblk[r][c] = 0.f;
        for (int s = 0; s < DS; ++s) {
          const float4 cv = *reinterpret_cast<const float4*>(cT + s * TP + 4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(bT + s * TP + 4 * tx);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sblk[r][c] += cr[r] * bc[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ty + r;
          const float ci = cums[i0 + i];
          float out[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 4 * tx + c;
            out[c] = j0 + j <= i0 + i ? sblk[r][c] * expf(ci - cums[j0 + j]) : 0.f;
          }
          *reinterpret_cast<float4*>(sc + i * SP + 4 * tx) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();

        // intra-chunk term: scores times dt * x
        for (int j = 0; j < TILE; j += 4) {
          float xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xa[(j0 + j + q) * P + yp];
#pragma unroll
          for (int k = 0; k < RA; ++k) {
            const float4 s4 = *reinterpret_cast<const float4*>(sc + (yr + k) * SP + j);
            acc[k] += s4.x * xv[0] + s4.y * xv[1] + s4.z * xv[2] + s4.w * xv[3];
          }
        }

        // state injection: dt_j x_j[p] exp(cums_last - cums_j) B_j[s]
        if (last) {
          for (int j = 0; j < TILE; j += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bT + ss * TP + j);
            const float4 w4 = *reinterpret_cast<const float4*>(wend + j0 + j);
            const float bw[4] = {b4.x * w4.x, b4.y * w4.y, b4.z * w4.z, b4.w * w4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float* xrow = xa + (j0 + j + q) * P + sp;
#pragma unroll
              for (int k = 0; k < SK; k += 4) {
                const float4 x4 = *reinterpret_cast<const float4*>(xrow + k);
                sacc[k] += x4.x * bw[q];
                sacc[k + 1] += x4.y * bw[q];
                sacc[k + 2] += x4.z * bw[q];
                sacc[k + 3] += x4.w * bw[q];
              }
            }
          }
        }
      }

#pragma unroll
      for (int k = 0; k < RA; ++k) {
        const int i = i0 + yr + k;
        if (i < Lc) yb[(long long)(c0 + i) * nh * hd + yp] = from_f32<T>(acc[k]);
      }
      if (last) {
        // every thread read the old state (inter term) before the column
        // sweep's first barrier; each writes only its own elements
#pragma unroll
        for (int k = 0; k < SK; ++k) st[(sp + k) * STP + ss] = sacc[k];
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

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state_out, int b, int S, int nh, int hd, int chunk, long long sxb,
           long long sxs, long long sxh, long long sdb, long long sds, long long sdh,
           long long sbb, long long sbs, long long scb, long long scs, cudaStream_t stream) {
  if (chunk % TILE || chunk > MAX_CHUNK || hd % P || S <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(chunk) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
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

}  // namespace

// x: [b, S, nh, hd], dt: [b, S, nh] fp32, B/C: [b, S, 1, DS] addressed through
// the given element strides (x's and B/C's last dim contiguous); A: [nh]
// fp32; y: contiguous [b, S, nh, hd] in x's dtype; state_out: contiguous
// [b, nh, hd, DS] fp32; hd a multiple of P. Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state_out, int b, int S, int nh,
                            int hd, int ds, int chunk, long long sxb, long long sxs,
                            long long sxh, long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long scb, long long scs,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds != DS) return (int)cudaErrorInvalidValue;
#define SSD_ARGS                                                                          \
  x, dt, A, Bm, Cm, y, state_out, b, S, nh, hd, chunk, sxb, sxs, sxh, sdb, sds, sdh, sbb, \
      sbs, scb, scs, s
  const int err = is_bf16 ? launch<__nv_bfloat16>(SSD_ARGS) : launch<float>(SSD_ARGS);
#undef SSD_ARGS
  return err;
}
