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
// 3.35 TB/s).  So the design keeps every tile's bytes moving once, in
// 128-byte transactions, and does the arithmetic where the data already
// is:
//  * A CTA of 256 threads takes TB = 32 tiles per step (grid-stride over
//    the batch in 64-bit indices: the staged VGG16 path hands it up to
//    4 * 64 * 1444 = 369,664 tiles).  The step's tiles are contiguous in
//    device memory, so consecutive threads load consecutive floats into a
//    shared [TB][K][K+1] stage (the pad column spreads the row reads over
//    the banks); a t < K tile is zero-padded in this load, the host makes
//    no padded copy.
//  * Stage 1: thread (tile, row j) holds row j of X in registers and
//    writes row j of A = X W^T (X V^T for the inverse, complex) to shared
//    memory.  Stage 2: the same thread, now as column v, reads column v of
//    A and forms column v of W A (Re(V A)) in registers.  The DFT matrices
//    sit in shared memory, read as broadcasts.
//  * The result goes back through the shared stage and out in the same
//    coalesced order.  fp32 FMA on CUDA cores, no tensor cores (the
//    products are 8 x 8 and the kernel is bytes-bound).
#include <cuda_runtime.h>

#ifndef FFT_K
#define FFT_K 8
#endif

namespace {

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

__global__ void __launch_bounds__(NT)
ifft2_tiles_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ vr_g,
                   const float* __restrict__ vi_g, float* __restrict__ y,
                   long long B) {
  __shared__ float s_xr[TB * K * KP];
  __shared__ float s_xi[TB * K * KP];
  __shared__ float s_ar[TB * K * KP];
  __shared__ float s_ai[TB * K * KP];
  __shared__ float vr[K * K], vi[K * K];
  load_matrix(vr_g, vr);
  load_matrix(vi_g, vi);
  const int lt = threadIdx.x / K, j = threadIdx.x % K;
  for (long long base = (long long)blockIdx.x * TB; base < B;
       base += (long long)gridDim.x * TB) {
    const int nt = (int)(B - base < TB ? B - base : TB);
    load_tiles(xr, s_xr, base, nt, K);
    load_tiles(xi, s_xi, base, nt, K);
    __syncthreads();
    // stage 1: row j of A = X V^T (complex; V symmetric)
    float rr[K], ri[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      rr[c] = s_xr[(lt * K + j) * KP + c];
      ri[c] = s_xi[(lt * K + j) * KP + c];
    }
#pragma unroll
    for (int v = 0; v < K; ++v) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float wr = vr[v * K + c], wi = vi[v * K + c];
        ar = fmaf(rr[c], wr, fmaf(-ri[c], wi, ar));
        ai = fmaf(rr[c], wi, fmaf(ri[c], wr, ai));
      }
      s_ar[(lt * K + j) * KP + v] = ar;
      s_ai[(lt * K + j) * KP + v] = ai;
    }
    __syncthreads();
    // stage 2: column v = j of Re(V A), into the (now free) real stage
#pragma unroll
    for (int u = 0; u < K; ++u) {
      float re = 0.f;
#pragma unroll
      for (int r = 0; r < K; ++r)
        re = fmaf(vr[u * K + r], s_ar[(lt * K + r) * KP + j],
                  fmaf(-vi[u * K + r], s_ai[(lt * K + r) * KP + j], re));
      s_xr[(lt * K + u) * KP + j] = re;
    }
    __syncthreads();
    store_tiles(s_xr, y, base, nt);
    __syncthreads();
  }
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

// xr/xi [B, K, K] f32, vr/vi = conj(W) / K, y [B, K, K] f32.
int ifft2_tiles_f32(const float* xr, const float* xi, const float* vr,
                    const float* vi, float* y, long long B, void* stream) {
  ifft2_tiles_kernel<<<grid_for(B), NT, 0, (cudaStream_t)stream>>>(
      xr, xi, vr, vi, y, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
