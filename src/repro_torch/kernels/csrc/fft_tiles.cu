// 2-D DFT and inverse DFT of small tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fft8.py: `fft2_tiles`
// (body `_fft_kernel`) and `ifft2_tiles` (body `_ifft_kernel`), the first
// and third launches of the staged spectral conv.  Per K x K tile:
//
//   forward  Y = W X W^T      X real [t, t] zero-padded to K x K,
//                             W[j][k] = exp(-2 pi i jk / K) = cr + i ci
//   inverse  y = Re(V Y V^T)  V = conj(W) / K = vr + i vi
//
//   fft2_tiles_f32:  x [B, t, t] (t <= K)      -> yr, yi [B, K, K]
//   ifft2_tiles_f32: yr, yi [B, K, K]          -> y [B, K, K]
//
// Bound on an H100 SXM: bytes.  The forward reads 4 t^2 and writes 8 K^2
// bytes a tile, the inverse reads 8 K^2 and writes 4 K^2, against ~3 K^3
// (forward) and ~6 K^3 (inverse) real multiply-adds: 0.3-0.5 flop a byte,
// two orders under the card's 20 flop/byte fp32 balance (67 TFLOP/s over
// 3.35 TB/s).  The forward (`fft2_tiles_kernel`) keeps every tile's
// bytes moving once, in 128-byte transactions, and does the arithmetic
// where the data already is:
//  * A CTA of 256 threads takes TB = 32 tiles per step (grid-stride over
//    the batch in 64-bit indices: the staged VGG16 path hands it up to
//    4 * 64 * 1444 = 369,664 tiles).  The step's tiles are contiguous in
//    device memory, so consecutive threads load consecutive floats into a
//    shared [TB][K][K+1] stage (the pad column spreads the row reads over
//    the banks); a t < K tile is zero-padded in this load, the host makes
//    no padded copy.
//  * Stage 1: thread (tile, row j) holds row j of X in registers and
//    writes row j of A = X W^T (complex) to shared memory.  Stage 2: the
//    same thread, now as column v, reads column v of A and forms column v
//    of W A in registers.  The DFT matrices sit in shared memory, read as
//    broadcasts.
//  * The result goes back through the shared stage and out in the same
//    coalesced order.  fp32 FMA on CUDA cores, no tensor cores (the
//    products are 8 x 8 and the kernel is bytes-bound).
// The inverse (`ifft2_tiles_kernel`) is written for the bandwidth alone:
// a persistent grid, a three-slot ring of 16-byte asynchronous copies, a
// rotated layout in place of the pad, and radix-2 butterflies (below).
#include <cuda_runtime.h>

#include "cp_async.cuh"

#ifndef FFT_K
#define FFT_K 8
#endif

namespace {

using namespace repro_torch;

constexpr int K = FFT_K;
constexpr int KP = K + 1;          // padded row pitch of the shared stage
constexpr int NT = 256;            // threads per CTA
constexpr int TB = NT / K;         // tiles per CTA step: one thread a row
static_assert(NT % K == 0, "a CTA step covers whole tiles");

// Copy the step's tiles [base, base + nt) of a [B, t, t] array into the
// shared [TB][K][KP] stage, zero-filling rows and columns t..K-1 and the
// tiles past nt.
__device__ __forceinline__ void load_tiles(const float* __restrict__ src,
                                           float* __restrict__ stage,
                                           long long base, int nt, int t) {
  const int tt = t * t;
  for (int e = threadIdx.x; e < TB * K * K; e += NT) {
    const int i = e / (K * K), r = (e / K) % K, c = e % K;
    float v = 0.f;
    if (i < nt && r < t && c < t)
      v = src[(base + i) * tt + r * t + c];
    stage[(i * K + r) * KP + c] = v;
  }
}

// Copy the stage's first nt tiles out to a [B, K, K] array.
__device__ __forceinline__ void store_tiles(const float* __restrict__ stage,
                                            float* __restrict__ dst,
                                            long long base, int nt) {
  for (int e = threadIdx.x; e < nt * K * K; e += NT) {
    const int i = e / (K * K), r = (e / K) % K, c = e % K;
    dst[(base + i) * (K * K) + r * K + c] = stage[(i * K + r) * KP + c];
  }
}

__device__ __forceinline__ void load_matrix(const float* __restrict__ g,
                                            float* __restrict__ s) {
  for (int e = threadIdx.x; e < K * K; e += NT) s[e] = g[e];
}

__global__ void __launch_bounds__(NT)
fft2_tiles_kernel(const float* __restrict__ x, const float* __restrict__ cr_g,
                  const float* __restrict__ ci_g, float* __restrict__ yr,
                  float* __restrict__ yi, long long B, int t) {
  __shared__ float s_x[TB * K * KP];
  __shared__ float s_ar[TB * K * KP];
  __shared__ float s_ai[TB * K * KP];
  __shared__ float cr[K * K], ci[K * K];
  load_matrix(cr_g, cr);
  load_matrix(ci_g, ci);
  const int lt = threadIdx.x / K, j = threadIdx.x % K;
  for (long long base = (long long)blockIdx.x * TB; base < B;
       base += (long long)gridDim.x * TB) {
    const int nt = (int)(B - base < TB ? B - base : TB);
    load_tiles(x, s_x, base, nt, t);
    __syncthreads();
    // stage 1: row j of A = X W^T (X real; W symmetric)
    float xrow[K];
#pragma unroll
    for (int c = 0; c < K; ++c) xrow[c] = s_x[(lt * K + j) * KP + c];
#pragma unroll
    for (int v = 0; v < K; ++v) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        ar = fmaf(xrow[c], cr[v * K + c], ar);
        ai = fmaf(xrow[c], ci[v * K + c], ai);
      }
      s_ar[(lt * K + j) * KP + v] = ar;
      s_ai[(lt * K + j) * KP + v] = ai;
    }
    __syncthreads();
    // stage 2: column v = j of Y = W A (complex)
    float acr[K], aci[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      acr[r] = s_ar[(lt * K + r) * KP + j];
      aci[r] = s_ai[(lt * K + r) * KP + j];
    }
    float outr[K], outi[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float wr = cr[u * K + r], wi = ci[u * K + r];
        re = fmaf(wr, acr[r], fmaf(-wi, aci[r], re));
        im = fmaf(wr, aci[r], fmaf(wi, acr[r], im));
      }
      outr[u] = re;
      outi[u] = im;
    }
    __syncthreads();               // every column of A is read
#pragma unroll
    for (int u = 0; u < K; ++u) {
      s_ar[(lt * K + u) * KP + j] = outr[u];
      s_ai[(lt * K + u) * KP + j] = outi[u];
    }
    __syncthreads();
    store_tiles(s_ar, yr, base, nt);
    store_tiles(s_ai, yi, base, nt);
    __syncthreads();               // the stages are free for the next step
  }
}

// ---- the inverse: a bandwidth kernel ----
//
// y = Re(V Y V^T) reads 512 bytes and writes 256 a tile against 6 K^3
// flops as two DFT products, 4 a byte (the radix-2 form below does about
// a fifth of those), under the card's 20: bound by bytes.  Design:
//  * A persistent grid (the card's SMs times the CTAs an SM holds at this
//    kernel's shared memory) walks steps of IT_TB = 32 consecutive tiles,
//    which are contiguous in device memory (IT_TB * 256 bytes a plane).
//    Each step's tiles land by 16-byte `cp.async` copies, consecutive
//    threads on consecutive chunks, in a ring of three slots, so step
//    i + 1's and i + 2's loads run under step i's arithmetic.
//  * A tile's rows are rotated by the tile (row r at row slot (r + t) & 7)
//    and a slot's two 16-byte halves swapped where the slot is >= 4
//    (`tile_at`): the copies keep whole 16-byte chunks, the column pass's
//    scalar reads (8 threads of a tile on a row, 4 tiles a warp) and the
//    row pass's 16-byte reads (a tile's 8 rows) both hit 32 distinct banks.
//    No division or modulo per element.
//  * Thread (tile, j) takes column j of Y (re, im), its unnormalised
//    8-point inverse DFT in registers by radix 2 (`idft8`), and writes it
//    to a stage in the same layout; after a barrier, thread (tile, u) takes
//    row u of that, its inverse DFT's real part, scales it by 1 / 64 (exact)
//    and stores the 32-byte output row as two 16-byte stores.
constexpr int IT = 256;                 // threads
constexpr int IT_TB = IT / K;           // tiles a step: a thread a column
constexpr int IT_STAGES = 3;            // ring slots
constexpr int TILE = K * K;             // floats of one tile plane
constexpr int IT_PLANE = IT_TB * TILE;  // floats of a step's plane
// ring slots (re, im planes) and the column pass's output (re, im)
constexpr int IT_SMEM = (IT_STAGES + 1) * 2 * IT_PLANE * (int)sizeof(float);
static_assert(K == 8, "idft8 is the 8-point transform");

// The place of element (r, c) of the step's tile t in a [IT_TB][TILE]
// plane: row slot q = (r + t) & 7, its 16-byte halves swapped where q >= 4.
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

// CTAs for B tiles: enough steps for every tile, at most 8 CTAs an SM of
// the card's 132 (the rest is the grid-stride loop).
unsigned grid_for(long long B) {
  long long blocks = (B + TB - 1) / TB;
  return (unsigned)(blocks < 132 * 8 ? blocks : 132 * 8);
}

}  // namespace

extern "C" {

// x [B, t, t] f32 (t <= FFT_K), cr/ci the [K, K] DFT matrix, yr/yi
// [B, K, K] f32.  The caller checks shapes, devices and layouts.
int fft2_tiles_f32(const float* x, const float* cr, const float* ci,
                   float* yr, float* yi, long long B, int t, void* stream) {
  if (t < 1 || t > K) return (int)cudaErrorInvalidValue;
  fft2_tiles_kernel<<<grid_for(B), NT, 0, (cudaStream_t)stream>>>(
      x, cr, ci, yr, yi, B, t);
  return (int)cudaGetLastError();
}

// xr/xi [B, K, K] f32 -> y [B, K, K] f32, Re of the 2-D inverse DFT.
// A persistent grid: the card's SMs times the CTAs one holds at the
// kernel's shared memory (queried once a device).
int ifft2_tiles_f32(const float* xr, const float* xi, float* y, long long B,
                    void* stream) {
  static int ctas[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (ctas[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             ifft2_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             IT_SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ifft2_tiles_kernel, IT, IT_SMEM)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas[dev] = sms * per_sm;
  }
  const long long steps = (B + IT_TB - 1) / IT_TB;
  const unsigned grid = (unsigned)(steps < ctas[dev] ? steps : ctas[dev]);
  ifft2_tiles_kernel<<<grid, IT, IT_SMEM, (cudaStream_t)stream>>>(xr, xi, y,
                                                                   B);
  return (int)cudaGetLastError();
}

}  // extern "C"
