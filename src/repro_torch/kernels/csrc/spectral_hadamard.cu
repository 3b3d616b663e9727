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
// second launch of the staged spectral conv.  The reference forms complex
// products in Karatsuba's three multiplications; this kernel takes the four
// real products, re = Wr Xr - Wi Xi and im = Wr Xi + Wi Xr, because
// Karatsuba's im = (Wr + Wi)(Xr + Xi) - Wr Xr - Wi Xi cancels against the
// larger sum plane: in 3xTF32 it read 4.7e-6 of max|Y| at M = 512, the four
// products under 1e-6 (mma_tf32.cuh).
//
// Bound on an H100 SXM: 6 F N M P flops against 8 (F N M + F M P + F N P)
// bytes at 3.35 TB/s.  The staged VGG16 layers at batch 1 (P <= 1444 tiles,
// F = 64 bins, dense K^2 planes) sit near the balance point: the early
// layers lean to operations, conv4_x/conv5_x (P = 25 or 9, N = M = 512,
// 134 MB of W planes a layer) to bytes, where W is nearly all of them.
//
// Design (tensor cores in 3xTF32, a cp.async ring, no library GEMM):
//  * The four real products run on `mma.sync.m16n8k8` TF32 with f32
//    accumulation: n rows are the MMA's m, channels its k, tiles its n.
//    Each f32 operand is split once into a TF32 high part and the TF32
//    rounding of its remainder, and a product is lo*hi + hi*lo + hi*hi
//    (mma_tf32.cuh): three MMAs, which keep f32 accuracy where one TF32
//    pass keeps ~1e-3.  Each k step's products go to fresh accumulators
//    that are then added to the running (re, im) in f32: a long sum kept
//    in the MMA accumulator loses low bits (mma_tf32.cuh).
//    `mma.sync`, not
//    `wgmma`: wgmma's TF32 B operand must be K-major in shared memory,
//    and X [F, M, P] is P-major, so it would need a transpose on the load;
//    mma.sync's fragments are read from shared memory by index.
//  * A CTA is four warps.  Its output tile follows P: 64 n x 64 p (warps
//    2 x 2, 32 x 32 each) for P > 32; for P <= 32 a narrow 128 n x BP p
//    tile (BP = 8, 16 or 32, warps 4 x 1) so that W, which then carries
//    nearly all of the bytes, streams once with no 64-wide p padding.
//  * Operands stream through a cp.async ring (16-byte copies where a row
//    is 16-byte aligned, else 4-byte; ragged N, M and P zero-filled):
//    three stages of 32 channels (wide) or four of 16 (narrow), so two or
//    three chunks are in flight while one computes.  W is copied in its
//    stored [n][m] layout, the MMA's row-major A, with no transpose; X
//    [m][p] is the MMA's B.  Row pitches (36 / 20 floats for W, BP + 8
//    for X; 8 at BP 8) make every fragment read conflict-free.
//  * The three flows keep the reference's meaning of "what stays resident"
//    while the other operand streams:
//      output-stationary: CTA = (p tile, n tile, bin), walks its m range;
//      weight-stationary: CTA = (n tile, m range, bin) keeps its W block
//        (BN x RM, both planes) in shared memory and walks every p tile,
//        streaming X;
//      input-stationary:  CTA = (p tile, m range, bin) keeps its X block
//        (RM x BP) and walks every n tile, streaming W.
//  * On the TPU the ws/is grids read-modify-write Y in HBM across an
//    in-order m axis.  CUDA CTAs run in no order, so each m range g of
//    RM channels writes its (re, im) tile to slice g of a split-K
//    workspace [G][2][F][N][P], and a second launch (`sum_slices.cuh`)
//    sums the slices in ascending g (the reference's RMW order).  No
//    atomics: a launch gives the same bits every time.  Output-stationary
//    takes the same split where its grid would not fill the card (the
//    wrapper's `launch_geometry`).  With one range (G = 1) the tile goes
//    straight to Y.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_tf32.cuh"
#include "sum_slices.cuh"

namespace {

using repro_torch::clamp_bytes;
using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::mma3;
using repro_torch::split_frag;

constexpr int NT = 128;            // four warps
constexpr int RM_MAX = 128;        // widest resident m range (ws / is)
constexpr int SMEM_MAX = 232448;
enum { OS = 0, WS = 1, IS = 2 };

template <int BN_, int BP_, int BK_, int STAGES_, int WARPS_N_>
struct Tile {
  static constexpr int BN = BN_, BP = BP_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_N = WARPS_N_, WARPS_P = 4 / WARPS_N_;
  static constexpr int WN = BN / WARPS_N, WP = BP / WARPS_P;
  static constexpr int MT = WN / 16, PT = WP / 8;  // MMA tiles a warp
  static constexpr int AP = BK + 4;                // pitch of a W chunk
  static constexpr int XP = BP == 8 ? 8 : BP + 8;  // pitch of an X row
  static_assert(MT >= 1 && PT >= 1 && BK % 8 == 0, "tile shape");
};
using Wide = Tile<64, 64, 32, 3, 2>;
template <int BP>
using Narrow = Tile<128, BP, 16, 4, 4>;

// Channels a resident block of RM holds, and its W row pitch (pitch % 32
// is 4 or 20: conflict-free A fragments).
template <class T>
__host__ __device__ inline int resident_k(int RM) {
  return (RM + T::BK - 1) / T::BK * T::BK;
}

template <class T>
__host__ __device__ inline int smem_floats(int flow, int RM) {
  const int w_chunk = 2 * T::BN * T::AP, x_chunk = 2 * T::BK * T::XP;
  if (flow == WS)
    return 2 * T::BN * (resident_k<T>(RM) + 4) + T::STAGES * x_chunk;
  if (flow == IS) return 2 * resident_k<T>(RM) * T::XP + T::STAGES * w_chunk;
  return T::STAGES * (w_chunk + x_chunk);
}

// Copy W[n0 .. n0+BN)[k0 .. k0+BK) (channels >= khi, rows >= N as zeros)
// into both planes of a [BN][pitch] block at column `col`.
template <class T>
__device__ __forceinline__ void load_w(const float* wr, const float* wi,
                                       long long wo, int N, int M, int n0,
                                       int k0, int khi, float* dst, int pitch,
                                       int col, bool vec) {
  float* dr = dst + col;
  float* di = dr + T::BN * pitch;
  if (vec) {
    constexpr int C4 = T::BK / 4;
    for (int e = threadIdx.x; e < T::BN * C4; e += NT) {
      const int n = e / C4, c = e % C4;
      const int k = k0 + 4 * c;
      const int bytes = n0 + n < N ? clamp_bytes(khi - k) : 0;
      const long long g = wo + (long long)(n0 + n) * M + k;
      cp_async16(dr + n * pitch + 4 * c, bytes ? wr + g : wr, bytes);
      cp_async16(di + n * pitch + 4 * c, bytes ? wi + g : wi, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < T::BN * T::BK; e += NT) {
      const int n = e / T::BK, c = e % T::BK;
      const bool in = n0 + n < N && k0 + c < khi;
      const long long g = wo + (long long)(n0 + n) * M + k0 + c;
      cp_async4(dr + n * pitch + c, in ? wr + g : wr, in);
      cp_async4(di + n * pitch + c, in ? wi + g : wi, in);
    }
  }
}

// Copy X[k0 .. k0+BK)[p0 .. p0+BP) into both planes of a [rows][XP] block
// from row `row`; `plane` floats apart.
template <class T>
__device__ __forceinline__ void load_x(const float* xr, const float* xi,
                                       long long xo, int P, int p0, int k0,
                                       int khi, float* dst, int plane,
                                       int row, bool vec) {
  float* dr = dst + row * T::XP;
  float* di = dr + plane;
  if (vec) {
    constexpr int C4 = T::BP / 4;
    for (int e = threadIdx.x; e < T::BK * C4; e += NT) {
      const int k = e / C4, c = e % C4;
      const int p = p0 + 4 * c;
      const int bytes = k0 + k < khi && p < P ? clamp_bytes(P - p) : 0;
      const long long g = xo + (long long)(k0 + k) * P + p;
      cp_async16(dr + k * T::XP + 4 * c, bytes ? xr + g : xr, bytes);
      cp_async16(di + k * T::XP + 4 * c, bytes ? xi + g : xi, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < T::BK * T::BP; e += NT) {
      const int k = e / T::BP, c = e % T::BP;
      const bool in = k0 + k < khi && p0 + c < P;
      const long long g = xo + (long long)(k0 + k) * P + p0 + c;
      cp_async4(dr + k * T::XP + c, in ? xr + g : xr, in);
      cp_async4(di + k * T::XP + c, in ? xi + g : xi, in);
    }
  }
}

template <class T, int FLOW>
__global__ void __launch_bounds__(NT, 2)
hadamard_tf32_kernel(const float* __restrict__ wr,
                     const float* __restrict__ wi,
                     const float* __restrict__ xr,
                     const float* __restrict__ xi, float* __restrict__ yr,
                     float* __restrict__ yi, float* __restrict__ ws, int F,
                     int N, int M, int P, int RM, int G, int vec_w,
                     int vec_x) {
  constexpr int BN = T::BN, BP = T::BP, BK = T::BK, S = T::STAGES;
  constexpr int MT = T::MT, PT = T::PT, AP = T::AP, XP = T::XP;
  extern __shared__ __align__(16) float smem[];
  const int f = blockIdx.z % F, g = blockIdx.z / F;
  const int mlo = g * RM, mhi = min(M, mlo + RM);
  const int nk = (mhi - mlo + BK - 1) / BK;           // chunks of the range
  const long long wo = (long long)f * N * M, xo = (long long)f * M * P;
  const long long plane = (long long)F * N * P;
  const long long yo = (long long)f * N * P;
  float* outr = G > 1 ? ws + 2LL * g * plane : yr;
  float* outi = G > 1 ? ws + (2LL * g + 1) * plane : yi;
  // the output tiles this CTA walks: its own (os), every p tile (ws) or
  // every n tile (is)
  const int walk = FLOW == WS ? (P + BP - 1) / BP
                   : FLOW == IS ? (N + BN - 1) / BN : 1;
  const int steps = walk * nk;
  const int rk = resident_k<T>(RM);
  const int rp = rk + 4;                              // resident W pitch
  // shared memory: the resident block (ws: W [2][BN][rp], is: X
  // [2][rk][XP]) and then the ring
  float* res = smem;
  float* ring = smem + (FLOW == WS ? 2 * BN * rp : FLOW == IS ? 2 * rk * XP
                                                              : 0);
  constexpr int w_chunk = 2 * BN * AP, x_chunk = 2 * BK * XP;
  constexpr int slot = FLOW == WS ? x_chunk : FLOW == IS ? w_chunk
                                                         : w_chunk + x_chunk;
  auto tile_n0 = [&](int tile) {
    return FLOW == WS ? (int)blockIdx.x * BN
                      : FLOW == IS ? tile * BN : (int)blockIdx.y * BN;
  };
  auto tile_p0 = [&](int tile) {
    return FLOW == WS ? tile * BP : (int)blockIdx.x * BP;
  };
  // start the copies of step s (tile s / nk, chunk s % nk) into its slot
  auto fetch = [&](int s) {
    const int tile = s / nk, c = s % nk;
    const int k0 = mlo + c * BK;
    float* dst = ring + (s % S) * slot;
    if (FLOW != WS)
      load_w<T>(wr, wi, wo, N, M, tile_n0(tile), k0, mhi, dst, AP, 0, vec_w);
    if (FLOW != IS)
      load_x<T>(xr, xi, xo, P, tile_p0(tile), k0, mhi,
                dst + (FLOW == OS ? w_chunk : 0), BK * XP, 0, vec_x);
  };
  if (FLOW == WS)
    for (int c = 0; c < nk; ++c)
      load_w<T>(wr, wi, wo, N, M, (int)blockIdx.x * BN, mlo + c * BK, mhi, res,
                rp, c * BK, vec_w);
  if (FLOW == IS)
    for (int c = 0; c < nk; ++c)
      load_x<T>(xr, xi, xo, P, (int)blockIdx.x * BP, mlo + c * BK, mhi, res,
                rk * XP, c * BK, vec_x);
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) fetch(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp / T::WARPS_P, wp = warp % T::WARPS_P;
  const int gq = lane / 4, tq = lane % 4;
  float are[MT][PT][4], aim[MT][PT][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) are[i][j][r] = aim[i][j][r] = 0.f;
  };
  zero();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();               // step s has landed; slot s - 1 is free
    if (s + S - 1 < steps) fetch(s + S - 1);
    cp_async_commit();
    const int tile = s / nk, c = s % nk;
    const float* sl = ring + (s % S) * slot;
    // A (W) [BN][pa] from column ca; B (X) [..][XP] from row cb
    const float* a_r = FLOW == WS ? res : sl;
    const int pa = FLOW == WS ? rp : AP, ca = FLOW == WS ? c * BK : 0;
    const int pla = BN * pa;
    const float* b_r = FLOW == IS ? res : sl + (FLOW == OS ? w_chunk : 0);
    const int cb = FLOW == IS ? c * BK : 0;
    const int plb = FLOW == IS ? rk * XP : BK * XP;
    const int k8 = (min(BK, mhi - mlo - c * BK) + 7) / 8;
    for (int kk = 0; kk < k8; ++kk) {
      float ar[MT][4], ai[MT][4], br[PT][2], bi[PT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int o = (wn * T::WN + i * 16 + gq) * pa + ca + kk * 8 + tq;
        const int o2[4] = {o, o + 8 * pa, o + 4, o + 8 * pa + 4};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ar[i][r] = a_r[o2[r]];
          ai[i][r] = a_r[pla + o2[r]];
        }
      }
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int o = (cb + kk * 8 + tq) * XP + wp * T::WP + j * 8 + gq;
        br[j][0] = b_r[o];
        br[j][1] = b_r[o + 4 * XP];
        bi[j][0] = b_r[plb + o];
        bi[j][1] = b_r[plb + o + 4 * XP];
      }
      // re += Wr Xr - Wi Xi, im += Wr Xi + Wi Xr, each in 3xTF32 into
      // fresh accumulators added in f32; X's parts are split per W row
      // tile, which keeps few fragments live
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t arh[4], arl[4], aih[4], ail[4];
        split_frag(ar[i], arh, arl);
        split_frag(ai[i], aih, ail);
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          uint32_t brh[2], brl[2], bih[2], bil[2];
          split_frag(br[j], brh, brl);
          split_frag(bi[j], bih, bil);
          float tr[4] = {0.f, 0.f, 0.f, 0.f}, tq[4] = {0.f, 0.f, 0.f, 0.f};
          float ti[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(tr, arh, arl, brh, brl);
          mma3(tq, aih, ail, bih, bil);
          mma3(ti, arh, arl, bih, bil);
          mma3(ti, aih, ail, brh, brl);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            are[i][j][r] += tr[r] - tq[r];
            aim[i][j][r] += ti[r];
          }
        }
      }
    }
    if (c != nk - 1) continue;
    // the tile's (re, im)
    const int n0 = tile_n0(tile), p0 = tile_p0(tile);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows gq, gq + 8: two p each
          const int n = n0 + wn * T::WN + i * 16 + gq + 8 * h;
          const int p = p0 + wp * T::WP + j * 8 + 2 * tq;
          if (n >= N || p >= P) continue;
          const long long o = yo + (long long)n * P + p;
          const float re[2] = {are[i][j][2 * h], are[i][j][2 * h + 1]};
          const float im[2] = {aim[i][j][2 * h], aim[i][j][2 * h + 1]};
          if (P % 2 == 0) {             // p even: an aligned pair
            *reinterpret_cast<float2*>(outr + o) = make_float2(re[0], re[1]);
            *reinterpret_cast<float2*>(outi + o) = make_float2(im[0], im[1]);
          } else {
            outr[o] = re[0];
            outi[o] = im[0];
            if (p + 1 < P) {
              outr[o + 1] = re[1];
              outi[o + 1] = im[1];
            }
          }
        }
    zero();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class T, int FLOW>
int launch_tile(const float* wr, const float* wi, const float* xr,
                const float* xi, float* yr, float* yi, float* ws, int F,
                int N, int M, int P, int RM, int G, cudaStream_t stream) {
  const int bytes = 4 * smem_floats<T>(FLOW, RM);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hadamard_tf32_kernel<T, FLOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec_w = M % 4 == 0 && aligned16(wr) && aligned16(wi);
  const int vec_x = P % 4 == 0 && aligned16(xr) && aligned16(xi);
  const unsigned pb = (P + T::BP - 1) / T::BP, nb = (N + T::BN - 1) / T::BN;
  const dim3 grid(FLOW == WS ? nb : pb, FLOW == OS ? nb : 1, F * G);
  hadamard_tf32_kernel<T, FLOW><<<grid, NT, bytes, stream>>>(
      wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM, G, vec_w, vec_x);
  return (int)cudaGetLastError();
}

template <int FLOW>
int launch(const float* wr, const float* wi, const float* xr, const float* xi,
           float* yr, float* yi, float* ws, int F, int N, int M, int P,
           int RM, int BP, cudaStream_t stream) {
  if (F < 1 || N < 1 || M < 1 || P < 1 || RM < 1)
    return (int)cudaErrorInvalidValue;
  if (FLOW != OS && (RM > RM_MAX || RM % 16)) return (int)cudaErrorInvalidValue;
  const int G = (M + RM - 1) / RM;
  if (G > 1 && (ws == nullptr || RM % 4)) return (int)cudaErrorInvalidValue;
  if ((long long)F * G > 65535) return (int)cudaErrorInvalidValue;
  if (RM > M) RM = M;              // one range: size the block to M
  int err;
  switch (BP) {
    case 8:
      err = launch_tile<Narrow<8>, FLOW>(wr, wi, xr, xi, yr, yi, ws, F, N, M,
                                         P, RM, G, stream);
      break;
    case 16:
      err = launch_tile<Narrow<16>, FLOW>(wr, wi, xr, xi, yr, yi, ws, F, N,
                                          M, P, RM, G, stream);
      break;
    case 32:
      err = launch_tile<Narrow<32>, FLOW>(wr, wi, xr, xi, yr, yi, ws, F, N,
                                          M, P, RM, G, stream);
      break;
    case 64:
      err = launch_tile<Wide, FLOW>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P,
                                    RM, G, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || G == 1) return err;
  return (int)repro_torch::launch_sum_slices(ws, yr, yi, (long long)F * N * P,
                                             G, stream);
}

}  // namespace

extern "C" {

// The three flows, each over m ranges of RM channels (ws / is: a multiple
// of 16, at most 128; os: a multiple of 4, or M) with an output tile BP p
// wide (8, 16, 32: 128 n rows; 64: 64 n rows); with G = ceil(M / RM) > 1
// ranges, ws is a workspace of G * 2 * F * N * P floats.  The caller checks
// shapes, devices and layouts.
int spectral_hadamard_f32(const float* wr, const float* wi, const float* xr,
                          const float* xi, float* yr, float* yi, float* ws,
                          int F, int N, int M, int P, int RM, int BP,
                          void* stream) {
  return launch<OS>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM, BP,
                    (cudaStream_t)stream);
}

int spectral_hadamard_ws_f32(const float* wr, const float* wi,
                             const float* xr, const float* xi, float* yr,
                             float* yi, float* ws, int F, int N, int M, int P,
                             int RM, int BP, void* stream) {
  return launch<WS>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM, BP,
                    (cudaStream_t)stream);
}

int spectral_hadamard_is_f32(const float* wr, const float* wi,
                             const float* xr, const float* xi, float* yr,
                             float* yi, float* ws, int F, int N, int M, int P,
                             int RM, int BP, void* stream) {
  return launch<IS>(wr, wi, xr, xi, yr, yi, ws, F, N, M, P, RM, BP,
                    (cudaStream_t)stream);
}

}  // extern "C"
