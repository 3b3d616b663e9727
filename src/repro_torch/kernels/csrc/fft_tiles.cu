// 2-D DFT and inverse DFT of small tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft8.py: `fft2_tiles`
// (body `_fft_kernel`) and `ifft2_tiles` (body `_ifft_kernel`), the first
// and third launches of the staged spectral conv.  Per K x K tile:
//
//   forward  Y = W X W^T      X real [t, t] zero-padded to K x K,
//                             W[j][k] = exp(-2 pi i jk / K)
//   inverse  y = Re(V Y V^T)  V = conj(W) / K
//
//   fft2_tiles_f32:  x [B, t, t] (t <= K)      -> yr, yi [B, K, K]
//   ifft2_tiles_f32: yr, yi [B, K, K]          -> y [B, K, K]
//
// Bound on an H100 SXM: bytes.  The forward reads 4 K^2 (4 t^2) and writes
// 8 K^2 bytes a tile, the inverse reads 8 K^2 and writes 4 K^2, against
// 12 K^3 flops a tile as two DFT products (the radix-2 forms below do
// about a sixth of those): 4 flops a byte at most, under the card's 20
// fp32 flops a byte (67 TFLOP/s over 3.35 TB/s).  Both kernels are
// written for the bandwidth alone, on the same pieces:
//  * A persistent grid (the card's SMs times the CTAs an SM holds at the
//    kernel's shared memory, `resident_ctas`) walks steps of consecutive
//    tiles (16 forward, 32 inverse), contiguous in device memory.  Each
//    step's tiles land by 16-byte `cp.async` copies, consecutive threads on
//    consecutive chunks, in a ring of three slots, so step i + 1's and
//    i + 2's loads run under step i's arithmetic.
//  * A tile's rows are rotated by the tile and a row slot's 16-byte halves
//    swapped where the slot is >= 4 (`tile_at`) instead of a pad column:
//    the copies keep whole 16-byte chunks, and a pass's scalar reads (8
//    threads of a tile on a row, 4 tiles a warp) and 16-byte reads (a
//    tile's 8 rows) both hit 32 distinct banks.
//  * The 8-point transforms run in registers by radix 2 (`rdft8`, `idft8`),
//    a thread a column, then after a barrier a thread a row, and the
//    output rows go out from registers as 16-byte stores: a warp writes
//    whole runs of each plane (1 KB forward, 512 bytes inverse).
// The forward (`fft2_tiles_kernel`) takes the real input's symmetry: the
// column pass keeps rows 0..K/2 of W X (row K - u is the conjugate of row
// u), so it writes 5 of 8 rows to the stage and the row pass reads row
// min(u, K - u).  It writes twice the bytes it reads, so its lane pairs
// swap half rows before storing, and each store instruction writes whole
// 32-byte sectors (`store_rows`).  Its t < K instantiation pads the tiles
// in 4-byte copies (rows of 4 t bytes are not 16-byte aligned); the
// staged conv always hands it t = K.
#include <cuda_runtime.h>

#include "cp_async.cuh"

#ifndef FFT_K
#define FFT_K 8
#endif

namespace {

using namespace repro_torch;

constexpr int K = FFT_K;
constexpr int TILE = K * K;             // floats of one tile plane
static_assert(K == 8, "rdft8 and idft8 are the 8-point transforms");

// The place of element (r, c) of a step's tile t in a [tiles][TILE] plane:
// row slot q = (r + t) & 7, its 16-byte halves swapped where q >= 4.
__device__ __forceinline__ int tile_at(int t, int r, int c) {
  const int q = (r + t) & 7;
  return t * TILE + q * K + (c ^ (q & 4));
}

// X[k] = sum_n x[n] e^{+2 pi i n k / 8} in place (natural order), by
// radix 2: pairs (n, n + 4), then the even and odd halves' 4-point
// transforms, then the twiddles e^{i pi k / 4}.
__device__ __forceinline__ void idft8(float (&xr)[8], float (&xi)[8]) {
  constexpr float H = 0.70710678118654752f;
  const float a0r = xr[0] + xr[4], a0i = xi[0] + xi[4];
  const float a1r = xr[0] - xr[4], a1i = xi[0] - xi[4];
  const float a2r = xr[2] + xr[6], a2i = xi[2] + xi[6];
  const float a3r = xr[2] - xr[6], a3i = xi[2] - xi[6];
  const float a4r = xr[1] + xr[5], a4i = xi[1] + xi[5];
  const float a5r = xr[1] - xr[5], a5i = xi[1] - xi[5];
  const float a6r = xr[3] + xr[7], a6i = xi[3] + xi[7];
  const float a7r = xr[3] - xr[7], a7i = xi[3] - xi[7];
  // the halves' 4-point transforms (i z = (-z.im, z.re))
  const float e0r = a0r + a2r, e0i = a0i + a2i;
  const float e2r = a0r - a2r, e2i = a0i - a2i;
  const float e1r = a1r - a3i, e1i = a1i + a3r;
  const float e3r = a1r + a3i, e3i = a1i - a3r;
  const float o0r = a4r + a6r, o0i = a4i + a6i;
  const float o2r = a4r - a6r, o2i = a4i - a6i;
  const float o1r = a5r - a7i, o1i = a5i + a7r;
  const float o3r = a5r + a7i, o3i = a5i - a7r;
  // twiddled odd terms: w z, i z, w^3 z with w = e^{i pi / 4}
  const float t1r = H * (o1r - o1i), t1i = H * (o1r + o1i);
  const float t2r = -o2i, t2i = o2r;
  const float t3r = -H * (o3r + o3i), t3i = H * (o3r - o3i);
  xr[0] = e0r + o0r; xi[0] = e0i + o0i;
  xr[4] = e0r - o0r; xi[4] = e0i - o0i;
  xr[1] = e1r + t1r; xi[1] = e1i + t1i;
  xr[5] = e1r - t1r; xi[5] = e1i - t1i;
  xr[2] = e2r + t2r; xi[2] = e2i + t2i;
  xr[6] = e2r - t2r; xi[6] = e2i - t2i;
  xr[3] = e3r + t3r; xi[3] = e3i + t3i;
  xr[7] = e3r - t3r; xi[7] = e3i - t3i;
}

// X[k] = sum_n x[n] e^{-2 pi i n k / 8} of real x for k = 0..4 (X[8 - k]
// is conj X[k]; X[0] and X[4] are real), by radix 2 as `idft8` with the
// conjugate twiddles.
__device__ __forceinline__ void rdft8(const float (&x)[8], float (&re)[5],
                                      float (&im)[5]) {
  constexpr float H = 0.70710678118654752f;
  const float a0 = x[0] + x[4], a1 = x[0] - x[4];
  const float a2 = x[2] + x[6], a3 = x[2] - x[6];
  const float a4 = x[1] + x[5], a5 = x[1] - x[5];
  const float a6 = x[3] + x[7], a7 = x[3] - x[7];
  const float p = H * (a5 - a7), m = H * (a5 + a7);
  re[0] = (a0 + a2) + (a4 + a6); im[0] = 0.f;
  re[4] = (a0 + a2) - (a4 + a6); im[4] = 0.f;
  re[1] = a1 + p; im[1] = -a3 - m;
  re[2] = a0 - a2; im[2] = a6 - a4;
  re[3] = a1 - p; im[3] = a3 - m;
}

// The CTAs of `kernel` the card holds at once (its SMs times the CTAs an
// SM holds at `threads` threads and `smem` bytes of dynamic shared
// memory), queried once a device into `cache`.
cudaError_t resident_ctas(const void* kernel, int threads, int smem,
                          int (&cache)[64], int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *ctas = cache[dev];
  return cudaSuccess;
}

// ---- the forward ----
//
// Thread (tile, j) takes column j of X from the ring slot (real), its
// DFT's rows 0..4 by `rdft8`, and writes them to the half stage
// (`half_at`); after a barrier, thread (tile, u) reads row min(u, 8 - u)
// of W X as 16-byte reads, conjugated where u > 4, takes its DFT as
// conj(idft8(conj .)), and row u of Y goes out by `store_rows`.  A step
// is 16 tiles (128 threads): steps of 8 timed 1-2 % faster, of 32 and 64
// slower (the step* variants of scripts/kernel_breakdown.py --only fft).
constexpr int FT = 128;                  // threads
constexpr int FT_TB = FT / K;            // tiles a step: a thread a column
constexpr int FT_STAGES = 3;             // ring slots
constexpr int HR = K / 2 + 1;            // rows of W X kept
constexpr int HT = HR * K;               // floats of a tile's half stage
constexpr int FT_PLANE = FT_TB * TILE;   // floats of a step's input
// ring slots and the half stage (re, im)
constexpr int FT_SMEM =
    (FT_STAGES * FT_PLANE + 2 * FT_TB * HT) * (int)sizeof(float);

// The place of element (u, c), u <= 4, of tile t's rows of W X: row u at
// u * K, row 4's halves swapped, so the row pass's 16-byte reads of rows
// 0..4 (8 threads of a tile) hit distinct banks.
__device__ __forceinline__ int half_at(int t, int u, int c) {
  return t * HT + u * K + (c ^ (u & 4));
}

// Start the copies of step `step`'s tiles [step * FT_TB, + FT_TB) of x into
// ring slot `slot` as K x K tiles, zero-filled past B and past row and
// column t.  FULL (t == K): a step is FT_TB * 256 contiguous bytes, one
// 16-byte copy a chunk; else one 4-byte copy an element.
template <bool FULL>
__device__ __forceinline__ void load_real_step(const float* __restrict__ x,
                                               float* slot, long long step,
                                               long long B, int t) {
  const long long base = step * FT_TB;
  if (FULL) {
#pragma unroll
    for (int k = 0; k < FT_PLANE / 4 / FT; ++k) {
      const int j = (int)threadIdx.x + k * FT;
      const int i = j / (TILE / 4), q = j % (TILE / 4);  // tile, chunk
      const bool ok = base + i < B;
      cp_async16(slot + tile_at(i, q / 2, 4 * (q % 2)),
                 x + (ok ? (base + i) * TILE + 4 * q : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < FT_PLANE / FT; ++k) {
      const int e = (int)threadIdx.x + k * FT;
      const int i = e / TILE, r = (e / K) % K, c = e % K;
      const bool ok = base + i < B && r < t && c < t;
      cp_async4(slot + tile_at(i, r, c),
                x + (ok ? ((base + i) * t + r) * t + c : 0), ok);
    }
  }
}

// A 16-byte store of `v` at `p` (16-byte aligned).
__device__ __forceinline__ void put(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Store row j of a tile's output planes `dr`, `di` from lane (tile, j),
// which holds it in `re`, `im` (every lane calls it: lanes 2k and 2k + 1
// swap a half row, so that each 16-byte store instruction writes whole
// 32-byte sectors: the even lane stores the first halves of rows 2k and
// 2k + 1, the odd lane their second halves).  Nothing is stored where !ok.
__device__ __forceinline__ void store_rows(float* __restrict__ dr,
                                           float* __restrict__ di,
                                           const float (&re)[K],
                                           const float (&im)[K], int j,
                                           bool ok) {
  const bool odd = j & 1;
  float pr[4], pi[4];           // the half rows the partner stores
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pr[c] = __shfl_xor_sync(~0u, odd ? re[c] : re[4 + c], 1);
    pi[c] = __shfl_xor_sync(~0u, odd ? im[c] : im[4 + c], 1);
  }
  if (!ok) return;
  const int o = (j & ~1) * K + 4 * odd;         // row 2k, this lane's half
  const float4 r_own = odd ? make_float4(re[4], re[5], re[6], re[7])
                           : make_float4(re[0], re[1], re[2], re[3]);
  const float4 i_own = odd ? make_float4(im[4], im[5], im[6], im[7])
                           : make_float4(im[0], im[1], im[2], im[3]);
  const float4 r_got = make_float4(pr[0], pr[1], pr[2], pr[3]);
  const float4 i_got = make_float4(pi[0], pi[1], pi[2], pi[3]);
  put(dr + o, odd ? r_got : r_own);
  put(dr + o + K, odd ? r_own : r_got);
  put(di + o, odd ? i_got : i_own);
  put(di + o + K, odd ? i_own : i_got);
}

template <bool FULL>
__global__ void __launch_bounds__(FT)
fft2_tiles_kernel(const float* __restrict__ x, float* __restrict__ yr,
                  float* __restrict__ yi, long long B, int t) {
  extern __shared__ __align__(16) float s_ft[];
  float* ring = s_ft;                              // [FT_STAGES][FT_PLANE]
  float* s_br = s_ft + FT_STAGES * FT_PLANE;       // rows 0..4 of W X
  float* s_bi = s_br + FT_TB * HT;
  const int tile = threadIdx.x / K, j = threadIdx.x % K;
  const long long steps = (B + FT_TB - 1) / FT_TB;
  const long long first = blockIdx.x, stride = gridDim.x;
  for (int k = 0; k < FT_STAGES - 1; ++k) {
    const long long st = first + k * stride;
    if (st < steps)
      load_real_step<FULL>(x, ring + k * FT_PLANE, st, B, t);
    cp_async_commit();
  }
  // rows 0 and 4 of W X are real: their imaginary parts stay 0
  for (int e = threadIdx.x; e < FT_TB * HT; e += FT) s_bi[e] = 0.f;
  int i = 0;
  for (long long st = first; st < steps; st += stride, ++i) {
    cp_async_wait<FT_STAGES - 2>();
    __syncthreads();            // step i landed; slot i - 1 and the stage
                                // are free
    const long long nx = st + (FT_STAGES - 1) * stride;
    if (nx < steps)
      load_real_step<FULL>(
          x, ring + ((i + FT_STAGES - 1) % FT_STAGES) * FT_PLANE, nx, B, t);
    cp_async_commit();
    const float* sx = ring + (i % FT_STAGES) * FT_PLANE;
    // column j of X -> rows 0..4 of column j of W X
    float xc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) xc[r] = sx[tile_at(tile, r, j)];
    float cr[HR], ci[HR];
    rdft8(xc, cr, ci);
#pragma unroll
    for (int u = 0; u < HR; ++u) s_br[half_at(tile, u, j)] = cr[u];
#pragma unroll
    for (int u = 1; u < HR - 1; ++u) s_bi[half_at(tile, u, j)] = ci[u];
    __syncthreads();            // W X written
    // row u = j of Y = the DFT of row u of W X, which is row 8 - u
    // conjugated for u > 4: DFT(z) = conj(idft8(conj z))
    const int r = j <= K / 2 ? j : K - j;
    float br[K], bi[K];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = half_at(tile, r, 4 * h);
      const float4 a = *reinterpret_cast<const float4*>(s_br + o);
      const float4 b = *reinterpret_cast<const float4*>(s_bi + o);
      br[4 * h] = a.x; br[4 * h + 1] = a.y;
      br[4 * h + 2] = a.z; br[4 * h + 3] = a.w;
      bi[4 * h] = b.x; bi[4 * h + 1] = b.y;
      bi[4 * h + 2] = b.z; bi[4 * h + 3] = b.w;
    }
    const float conj = j <= K / 2 ? -1.f : 1.f;
#pragma unroll
    for (int c = 0; c < K; ++c) bi[c] *= conj;
    idft8(br, bi);
#pragma unroll
    for (int c = 0; c < K; ++c) bi[c] = -bi[c];
    const long long gt = st * FT_TB + tile;
    store_rows(yr + gt * TILE, yi + gt * TILE, br, bi, j, gt < B);
  }
  cp_async_wait_all();          // no copy outlives the CTA
}

// ---- the inverse ----
//
// Both planes of a step land in the ring in `tile_at`'s layout.  Thread
// (tile, j) takes column j of Y (re, im), its unnormalised 8-point inverse
// DFT by `idft8`, and writes it to a stage in the same layout; after a
// barrier, thread (tile, u) takes row u of that, its inverse DFT's real
// part, scales it by 1 / 64 (exact) and stores the 32-byte output row as
// two 16-byte stores.
constexpr int IT = 256;                 // threads
constexpr int IT_TB = IT / K;           // tiles a step: a thread a column
constexpr int IT_STAGES = 3;            // ring slots
constexpr int IT_PLANE = IT_TB * TILE;  // floats of a step's plane
// ring slots (re, im planes) and the column pass's output (re, im)
constexpr int IT_SMEM = (IT_STAGES + 1) * 2 * IT_PLANE * (int)sizeof(float);

// Issue step `step`'s tiles [step * IT_TB, + IT_TB) of both planes into
// ring slot `slot` (zero-filled past B), one 16-byte copy a chunk.
__device__ __forceinline__ void load_step(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          float* slot, long long step,
                                          long long B) {
  constexpr int CHUNKS = IT_PLANE / 4;        // 16-byte chunks a plane
  const long long base = step * IT_TB;
#pragma unroll
  for (int k = 0; k < 2 * CHUNKS / IT; ++k) {
    const int j = (int)threadIdx.x + k * IT;
    const int p = j / CHUNKS, q = j % CHUNKS;  // plane, chunk (shifts)
    const int t = q / (TILE / 4), r = (q / 2) % K, h = q % 2;
    const bool ok = base + t < B;
    const float* src =
        (p ? xi : xr) + (ok ? (base + t) * TILE + 4 * (q % (TILE / 4)) : 0);
    cp_async16(slot + p * IT_PLANE + tile_at(t, r, 4 * h), src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(IT)
ifft2_tiles_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ y, long long B) {
  extern __shared__ __align__(16) float s_it[];
  float* ring = s_it;                          // [IT_STAGES][2][IT_PLANE]
  float* s_br = s_it + IT_STAGES * 2 * IT_PLANE;   // column pass output
  float* s_bi = s_br + IT_PLANE;
  const int t = threadIdx.x / K, j = threadIdx.x % K;
  const long long steps = (B + IT_TB - 1) / IT_TB;
  const long long first = blockIdx.x, stride = gridDim.x;
  for (int k = 0; k < IT_STAGES - 1; ++k) {
    const long long st = first + k * stride;
    if (st < steps) load_step(xr, xi, ring + k * 2 * IT_PLANE, st, B);
    cp_async_commit();
  }
  int i = 0;
  for (long long st = first; st < steps; st += stride, ++i) {
    cp_async_wait<IT_STAGES - 2>();
    __syncthreads();            // step i landed; slot i - 1 and the stage
                                // are free
    const long long nx = st + (IT_STAGES - 1) * stride;
    if (nx < steps)
      load_step(xr, xi, ring + ((i + IT_STAGES - 1) % IT_STAGES) * 2 *
                                   IT_PLANE, nx, B);
    cp_async_commit();
    const float* sr = ring + (i % IT_STAGES) * 2 * IT_PLANE;
    const float* si = sr + IT_PLANE;
    // column j of Y -> column j of B = V' Y (unnormalised)
    float cr[K], ci[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      cr[r] = sr[tile_at(t, r, j)];
      ci[r] = si[tile_at(t, r, j)];
    }
    idft8(cr, ci);
#pragma unroll
    for (int u = 0; u < K; ++u) {
      s_br[tile_at(t, u, j)] = cr[u];
      s_bi[tile_at(t, u, j)] = ci[u];
    }
    __syncthreads();            // B written
    // row u = j of B -> row u of y = Re(B V'^T) / 64
    float rr[K], ri[K];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tile_at(t, j, 4 * h);
      const float4 a = *reinterpret_cast<const float4*>(s_br + o);
      const float4 b = *reinterpret_cast<const float4*>(s_bi + o);
      rr[4 * h] = a.x; rr[4 * h + 1] = a.y;
      rr[4 * h + 2] = a.z; rr[4 * h + 3] = a.w;
      ri[4 * h] = b.x; ri[4 * h + 1] = b.y;
      ri[4 * h + 2] = b.z; ri[4 * h + 3] = b.w;
    }
    idft8(rr, ri);
    const long long tile = st * IT_TB + t;
    if (tile < B) {
      constexpr float SCALE = 1.f / (K * K);
      float4* dst = reinterpret_cast<float4*>(y + tile * TILE + j * K);
      dst[0] = make_float4(rr[0] * SCALE, rr[1] * SCALE, rr[2] * SCALE,
                           rr[3] * SCALE);
      dst[1] = make_float4(rr[4] * SCALE, rr[5] * SCALE, rr[6] * SCALE,
                           rr[7] * SCALE);
    }
  }
  cp_async_wait_all();          // no copy outlives the CTA
}

}  // namespace

extern "C" {

// x [B, t, t] f32 (t <= FFT_K) -> yr/yi [B, K, K] f32, the 2-D DFT of the
// zero-padded tiles.  The caller checks shapes, devices and layouts.
int fft2_tiles_f32(const float* x, float* yr, float* yi, long long B, int t,
                   void* stream) {
  static int ctas[2][64] = {};
  if (t < 1 || t > K) return (int)cudaErrorInvalidValue;
  const bool full = t == K;
  const void* kernel = full ? (const void*)fft2_tiles_kernel<true>
                            : (const void*)fft2_tiles_kernel<false>;
  int n = 0;
  cudaError_t err = resident_ctas(kernel, FT, FT_SMEM, ctas[full], &n);
  if (err != cudaSuccess) return (int)err;
  const long long steps = (B + FT_TB - 1) / FT_TB;
  const unsigned grid = (unsigned)(steps < n ? steps : n);
  if (full)
    fft2_tiles_kernel<true><<<grid, FT, FT_SMEM, (cudaStream_t)stream>>>(
        x, yr, yi, B, t);
  else
    fft2_tiles_kernel<false><<<grid, FT, FT_SMEM, (cudaStream_t)stream>>>(
        x, yr, yi, B, t);
  return (int)cudaGetLastError();
}

// xr/xi [B, K, K] f32 -> y [B, K, K] f32, Re of the 2-D inverse DFT.
int ifft2_tiles_f32(const float* xr, const float* xi, float* y, long long B,
                    void* stream) {
  static int ctas[64] = {};
  int n = 0;
  cudaError_t err = resident_ctas((const void*)ifft2_tiles_kernel, IT,
                                  IT_SMEM, ctas, &n);
  if (err != cudaSuccess) return (int)err;
  const long long steps = (B + IT_TB - 1) / IT_TB;
  const unsigned grid = (unsigned)(steps < n ? steps : n);
  ifft2_tiles_kernel<<<grid, IT, IT_SMEM, (cudaStream_t)stream>>>(xr, xi, y,
                                                                   B);
  return (int)cudaGetLastError();
}

}  // extern "C"
