// Frequency-binned batched complex GEMM (the spectral Hadamard, Eq 3), for
// Hopper (sm_90a):
//
//   Y[f, n, p] = sum_m W[f, n, m] * X[f, m, p]          (complex, f32)
//
//   wr/wi [F, N, M], xr/xi [F, M, P] -> yr/yi [F, N, P]
//
// Replaces the TPU kernel `spectral_hadamard` of
// src/repro/kernels/spectral_hadamard.py, with its bodies `_kernel_os`
// (output-stationary) and `_kernel_rmw` (weight- and input-stationary), the
// second launch of the staged spectral conv.  Complex products use the
// reference's 3-multiplication Karatsuba form over an m range:
//   m1 = Wr Xr, m2 = Wi Xi, m3 = (Wr + Wi)(Xr + Xi);
//   re = m1 - m2, im = (m3 - m1) - m2.
//
// Bound on an H100 SXM: 6 F N M P flops at 67 TFLOP/s fp32 against
// 8 (F N M + F M P + F N P) bytes at 3.35 TB/s.  The staged VGG16 layers at
// batch 1 (P = T <= 1444 tiles, F = 64 bins, dense K^2 planes) sit near the
// balance point, about 20 flop/byte: the early layers lean to operations,
// conv4_x/conv5_x (P = 36 or 9, N = M = 512, 134 MB of planes) to bytes.
//
// Design (fp32 FMA on CUDA cores, no TF32, no library GEMM):
//  * A CTA of 256 threads computes a 64 (n) x 64 (p) output tile of one
//    bin, each thread 4 x 4 outputs with three accumulators per output
//    (m1, m2, m3) in registers.  Operands pass through shared memory in
//    chunks of 16 channels: W as [k][n] (transposed on the load, rows of 68
//    floats), X as [k][p], each with its Karatsuba sum plane (Wr + Wi,
//    Xr + Xi) formed on the load; a thread reads its 4 n and 4 p of a
//    channel as float4s.  Ragged N, M and P edges are zero-filled on the
//    load and masked on the store.
//  * The three flows keep the reference's meaning of "what stays resident"
//    while the other operand streams:
//      output-stationary: CTA = (p tile, n tile, bin), walks all M;
//      weight-stationary: CTA = (n tile, m range, bin) keeps its W block
//        (64 x RM, three planes, <= 104 KB) in shared memory and walks
//        every p tile;
//      input-stationary:  CTA = (p tile, m range, bin) keeps its X block
//        (RM x 64, three planes, <= 96 KB) and walks every n tile.
//  * On the TPU the ws/is grids read-modify-write Y in HBM across an
//    in-order m axis.  CUDA CTAs run in no order, so each m range g of
//    RM channels writes its (re, im) tile to slice g of a split-K
//    workspace [G][2][F][N][P], and a second launch sums the slices in
//    ascending g (the reference's RMW order).  No atomics: a launch gives
//    the same bits every time.  With one range (G = 1) the tile goes
//    straight to Y.
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64, BP = 64;    // output tile: n x p
constexpr int KC = 16;             // channels per shared-memory chunk
constexpr int AP = BN + 4;         // row pitch of the [k][n] W stage
constexpr int NT = 256;            // threads: 16 x 16, 4 x 4 outputs each
constexpr int RM_MAX = 128;        // widest m range (weight/input-stat.)
enum { OS = 0, WS = 1, IS = 2 };

struct Acc {
  float m1[4][4], m2[4][4], m3[4][4];
};

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a.m1[i][j] = a.m2[i][j] = a.m3[i][j] = 0.f;
}

// W[f][n0 .. n0+63][k0 .. k0+15] (channels >= khi and rows >= N as zeros)
// into rows row0 .. row0+15 of the [k][AP] stages (re, im, re + im).
__device__ __forceinline__ void load_w(const float* __restrict__ wr,
                                       const float* __restrict__ wi,
                                       long long fo, int N, int M, int n0,
                                       int k0, int khi, float* sr, float* si,
                                       float* ss, int row0) {
  for (int e = threadIdx.x; e < BN * KC; e += NT) {
    const int n = e / KC, k = e % KC;
    const int gn = n0 + n, gm = k0 + k;
    float a = 0.f, b = 0.f;
    if (gn < N && gm < khi) {
      const long long i = fo + (long long)gn * M + gm;
      a = wr[i];
      b = wi[i];
    }
    const int s = (row0 + k) * AP + n;
    sr[s] = a;
    si[s] = b;
    ss[s] = a + b;
  }
}

// X[f][k0 .. k0+15][p0 .. p0+63] into rows row0 .. row0+15 of the [k][BP]
// stages (re, im, re + im).
__device__ __forceinline__ void load_x(const float* __restrict__ xr,
                                       const float* __restrict__ xi,
                                       long long fo, int M, int P, int p0,
                                       int k0, int khi, float* sr, float* si,
                                       float* ss, int row0) {
  for (int e = threadIdx.x; e < KC * BP; e += NT) {
    const int k = e / BP, p = e % BP;
    const int gm = k0 + k, gp = p0 + p;
    float a = 0.f, b = 0.f;
    if (gm < khi && gp < P) {
      const long long i = fo + (long long)gm * P + gp;
      a = xr[i];
      b = xi[i];
    }
    const int s = (row0 + k) * BP + p;
    sr[s] = a;
    si[s] = b;
    ss[s] = a + b;
  }
}

// One chunk of KC channels: rows ka.. of the W stages against rows kb.. of
// the X stages into the thread's 4 x 4 outputs.
__device__ __forceinline__ void mac(const float* ar, const float* ai,
                                    const float* as, int ka,
                                    const float* br, const float* bi,
                                    const float* bs, int kb, Acc& acc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    const float4 wr = *reinterpret_cast<const float4*>(
        &ar[(ka + k) * AP + ty * 4]);
    const float4 wi = *reinterpret_cast<const float4*>(
        &ai[(ka + k) * AP + ty * 4]);
    const float4 ws = *reinterpret_cast<const float4*>(
        &as[(ka + k) * AP + ty * 4]);
    const float4 xr = *reinterpret_cast<const float4*>(
        &br[(kb + k) * BP + tx * 4]);
    const float4 xi = *reinterpret_cast<const float4*>(
        &bi[(kb + k) * BP + tx * 4]);
    const float4 xs = *reinterpret_cast<const float4*>(
        &bs[(kb + k) * BP + tx * 4]);
    const float a1[4] = {wr.x, wr.y, wr.z, wr.w};
    const float a2[4] = {wi.x, wi.y, wi.z, wi.w};
    const float a3[4] = {ws.x, ws.y, ws.z, ws.w};
    const float b1[4] = {xr.x, xr.y, xr.z, xr.w};
    const float b2[4] = {xi.x, xi.y, xi.z, xi.w};
    const float b3[4] = {xs.x, xs.y, xs.z, xs.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc.m1[i][j] = fmaf(a1[i], b1[j], acc.m1[i][j]);
        acc.m2[i][j] = fmaf(a2[i], b2[j], acc.m2[i][j]);
        acc.m3[i][j] = fmaf(a3[i], b3[j], acc.m3[i][j]);
      }
  }
}

// The tile's (re, im) = (m1 - m2, m3 - m1 - m2) at [.., n0.., p0..] of two
// [N][P] planes starting at offset fo.
__device__ __forceinline__ void store(const Acc& acc, float* __restrict__ yr,
                                      float* __restrict__ yi, long long fo,
                                      int N, int P, int n0, int p0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p >= P) continue;
      const long long o = fo + (long long)n * P + p;
      yr[o] = acc.m1[i][j] - acc.m2[i][j];
      yi[o] = acc.m3[i][j] - acc.m1[i][j] - acc.m2[i][j];
    }
  }
}

// Floats of dynamic shared memory of a flow's CTA for m ranges of RM.
int smem_floats(int flow, int RM) {
  const int rk = (RM + KC - 1) / KC * KC;
  if (flow == WS) return 3 * rk * AP + 3 * KC * BP;
  if (flow == IS) return 3 * rk * BP + 3 * KC * AP;
  return 3 * KC * AP + 3 * KC * BP;
}

template <int FLOW>
__global__ void __launch_bounds__(NT)
hadamard_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                float* __restrict__ ws, int F, int N, int M, int P, int RM,
                int G) {
  extern __shared__ __align__(16) float smem[];
  const int f = blockIdx.z;
  const long long wo = (long long)f * N * M, xo = (long long)f * M * P;
  const long long plane = (long long)F * N * P;
  const long long yo = (long long)f * N * P;
  Acc acc;
  if constexpr (FLOW == OS) {
    float *ar = smem, *ai = ar + KC * AP, *as = ai + KC * AP;
    float *br = as + KC * AP, *bi = br + KC * BP, *bs = bi + KC * BP;
    const int n0 = blockIdx.y * BN, p0 = blockIdx.x * BP;
    zero(acc);
    for (int k0 = 0; k0 < M; k0 += KC) {
      load_w(wr, wi, wo, N, M, n0, k0, M, ar, ai, as, 0);
      load_x(xr, xi, xo, M, P, p0, k0, M, br, bi, bs, 0);
      __syncthreads();
      mac(ar, ai, as, 0, br, bi, bs, 0, acc);
      __syncthreads();
    }
    store(acc, yr, yi, yo, N, P, n0, p0);
    return;
  }
  // weight- / input-stationary: m range g of RM channels
  const int g = blockIdx.y;
  const int mlo = g * RM, mhi = min(M, mlo + RM);
  const int rk = (mhi - mlo + KC - 1) / KC * KC;
  float* outr = G > 1 ? ws + (2LL * g) * plane : yr;
  float* outi = G > 1 ? ws + (2LL * g + 1) * plane : yi;
  if constexpr (FLOW == WS) {
    float *ar = smem, *ai = ar + rk * AP, *as = ai + rk * AP;
    float *br = as + rk * AP, *bi = br + KC * BP, *bs = bi + KC * BP;
    const int n0 = blockIdx.x * BN;
    for (int k0 = mlo; k0 < mhi; k0 += KC)
      load_w(wr, wi, wo, N, M, n0, k0, mhi, ar, ai, as, k0 - mlo);
    for (int p0 = 0; p0 < P; p0 += BP) {
      zero(acc);
      for (int k0 = mlo; k0 < mhi; k0 += KC) {
        load_x(xr, xi, xo, M, P, p0, k0, mhi, br, bi, bs, 0);
        __syncthreads();
        mac(ar, ai, as, k0 - mlo, br, bi, bs, 0, acc);
        __syncthreads();
      }
      store(acc, outr, outi, yo, N, P, n0, p0);
    }
  } else {
    float *br = smem, *bi = br + rk * BP, *bs = bi + rk * BP;
    float *ar = bs + rk * BP, *ai = ar + KC * AP, *as = ai + KC * AP;
    const int p0 = blockIdx.x * BP;
    for (int k0 = mlo; k0 < mhi; k0 += KC)
      load_x(xr, xi, xo, M, P, p0, k0, mhi, br, bi, bs, k0 - mlo);
    for (int n0 = 0; n0 < N; n0 += BN) {
      zero(acc);
      for (int k0 = mlo; k0 < mhi; k0 += KC) {
        load_w(wr, wi, wo, N, M, n0, k0, mhi, ar, ai, as, 0);
        __syncthreads();
        mac(ar, ai, as, 0, br, bi, bs, k0 - mlo, acc);
        __syncthreads();
      }
      store(acc, outr, outi, yo, N, P, n0, p0);
    }
  }
}

// Split-K finish: Y = sum over g ascending of the workspace slices.
__global__ void __launch_bounds__(256)
finish_kernel(const float* __restrict__ ws, float* __restrict__ yr,
              float* __restrict__ yi, long long plane, int G) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < plane; i += (long long)gridDim.x * blockDim.x) {
    float re = ws[i], im = ws[plane + i];
    for (int g = 1; g < G; ++g) {
      re += ws[2LL * g * plane + i];
      im += ws[(2LL * g + 1) * plane + i];
    }
    yr[i] = re;
    yi[i] = im;
  }
}

template <int FLOW>
int launch(const float* wr, const float* wi, const float* xr, const float* xi,
           float* yr, float* yi, float* ws, int F, int N, int M, int P,
           int RM, cudaStream_t stream) {
  if (F < 1 || N < 1 || M < 1 || P < 1 || F > 65535)
    return (int)cudaErrorInvalidValue;
  if (FLOW != OS && (RM < 1 || RM > RM_MAX || RM % KC))
    return (int)cudaErrorInvalidValue;
  const int G = FLOW == OS ? 1 : (M + RM - 1) / RM;
  if (G > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = 4 * smem_floats(FLOW, FLOW == OS ? KC : RM < M ? RM : M);
  cudaError_t err = cudaFuncSetAttribute(
      hadamard_kernel<FLOW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned pb = (P + BP - 1) / BP, nb = (N + BN - 1) / BN;
  dim3 grid(FLOW == WS ? nb : pb, FLOW == OS ? nb : G, F);
  hadamard_kernel<FLOW><<<grid, NT, bytes, stream>>>(
      wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM, G);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return (int)err;
  const long long plane = (long long)F * N * P;
  long long blocks = (plane + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  finish_kernel<<<(unsigned)blocks, 256, 0, stream>>>(ws, yr, yi, plane, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output-stationary.  The caller checks shapes, devices and layouts.
int spectral_hadamard_f32(const float* wr, const float* wi, const float* xr,
                          const float* xi, float* yr, float* yi, int F, int N,
                          int M, int P, void* stream) {
  return launch<OS>(wr, wi, xr, xi, yr, yi, nullptr, F, N, M, P, 0,
                    (cudaStream_t)stream);
}

// Weight- / input-stationary over m ranges of RM channels (a multiple of
// 16, at most 128); with G = ceil(M / RM) > 1 ranges, ws is a workspace of
// G * 2 * F * N * P floats.
int spectral_hadamard_ws_f32(const float* wr, const float* wi,
                             const float* xr, const float* xi, float* yr,
                             float* yi, float* ws, int F, int N, int M, int P,
                             int RM, void* stream) {
  return launch<WS>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM,
                    (cudaStream_t)stream);
}

int spectral_hadamard_is_f32(const float* wr, const float* wi,
                             const float* xr, const float* xi, float* yr,
                             float* yi, float* ws, int F, int N, int M, int P,
                             int RM, void* stream) {
  return launch<IS>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM,
                    (cudaStream_t)stream);
}

}  // extern "C"
