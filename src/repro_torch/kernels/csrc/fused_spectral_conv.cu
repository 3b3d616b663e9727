// Fused spectral convolution, output-stationary flow, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_spectral_pipeline` with body `_kernel_os`
// in src/repro/kernels/fused_spectral_conv.py.  One launch computes a whole
// spectral conv layer on overlap-save windows:
//
//   y[s2, n, p] = act( Re( sum_f Dv[s2, f] * sum_m W[f, n, m] * (Df[f, :] . xt[:, m, p]) ) + b[n] )
//
//   xt  [S = K^2, M, P = B*T]  overlap-save windows, s-leading; rows of P
//                              floats at a pitch of x_pitch floats
//   wr/wi [Fa, N, M]           spectral kernel planes on the Fa active bins
//   dfr/dfi [Fa, S]            forward 2-D DFT rows (active bins)
//   dvr/dvi [S2 = t^2, Fa]     inverse 2-D DFT, valid rows x active columns
//   bias [N] -> y [S2, N, P]   all fp32
//
// Bound on an H100 SXM at the full VGG16 shapes (K = 8, t = 6, Fa = 64,
// batch 1): the layer stack does 29.3 GFLOP (tile-FFT 4.5, Karatsuba
// Hadamard 21.1, valid-row IFFT 3.7) and must move 0.97 GB (kernel planes
// 0.84 GB), so it is fp32-compute bound overall (0.44 ms at 67 TFLOP/s
// vs 0.29 ms at 3.35 TB/s).  conv5_x at batch 1 is byte bound: each layer
// streams 134 MB of planes for 9 tiles of work.
//
// Design (fp32 FMA on CUDA cores, no TF32):
//  * As on the TPU, the spectra X~ and Y~ never reach device memory and
//    every output element is written once, after bias and ReLU.
//  * Unlike the TPU grid, which carries the [Fa, bn, bp] complex psum in
//    VMEM across an "arbitrary" m axis, a CTA owns an (n-block, p-block)
//    and loops over the input channels itself.  The full psum (512 B per
//    output at Fa = 64) does not fit a CTA at useful block sizes, so the
//    bins are split across the CTAs of a thread-block cluster: CTA z of a
//    cluster of ceil(Fa/FSC_FC) takes bins [z*FSC_FC, (z+1)*FSC_FC), keeps
//    its chunk's Y~ in registers over the whole m loop, and folds
//    Re(Dv[:, chunk] . Y~_chunk) into a [S2, BN, BP] spatial partial in its
//    shared memory (the IFFT is linear in the bins).  The cluster then sums
//    the partials through distributed shared memory in a fixed rank order
//    (deterministic, no atomics), each CTA finishing S2/cluster of the
//    output rows with bias + ReLU.  This multiplies the CTAs per layer by
//    Fa/FSC_FC, which is what fills the card on conv4_x/conv5_x at batch 1
//    (8-16 (n, p) blocks of 64 channels for 132 SMs).
//  * Each CTA holds only its chunk's DFT rows and columns; the tile-FFT
//    computes only its own bins, so splitting the bins adds no FFT work.
//  * Windows and kernel planes stream through a two-stage cp.async ring,
//    so the next channel step's loads overlap this step's arithmetic.
//    Issuing the copies is the costliest part of a step when done per
//    element, so rows that are 16-byte aligned (window rows when the
//    pitch is a multiple of 4, which the Python layout arranges; plane
//    rows when M is) move as 16-byte copies, the rest as 4-byte ones.
//  * The complex product uses 4 real FMAs (not Karatsuba): on CUDA cores
//    the Hadamard loop is bound by shared-memory loads, and the direct
//    form needs fewer of them.  Spectra are stored as (re, im) pairs and
//    plane rows are read 16 bytes at a time.
//  * Ragged N / M / P edges are zero-filled by the copies (cp.async with a
//    short or zero source size), never padded in the operands.  So is a
//    ragged last bin chunk (Fa not a multiple of FSC_FC, which the TPU
//    kernel accepts too; the plan pads its active bins to whole chunks):
//    its missing DFT rows, DFT columns and kernel planes read as zeros.
//
// The halo sibling (`fused_spectral_pipeline_halo_f32`, replacing the TPU
// kernel `fused_spectral_pipeline_halo`) is the same kernel on another input
// path: a CTA's 16 tile slots hold one halo block (bth x btw tiles of one
// image), each channel step stages the block's raw rows (halo.cuh) and
// expands them into the same [S][BM][BP] window stage, and the flush stores
// finished tiles straight into y[B, N, H_out, W_out].  The FFT, Hadamard,
// IFFT, cluster split and rank-order reduction are the windowed kernel's
// code (the kernel is templated on the input path), so on the same plan
// both paths give the same values.  Its bound is B1's operations on the
// real tiles and the raw activation read once; idle slots (blocks past the
// tile grid, 3x3-tile blocks in 16 slots) cost time, not bytes.
//
// The weight- and input-stationary flows (entry points *_ws_f32 and
// *_is_f32, windowed and halo; replacing the TPU bodies `_kernel_ws` (:571)
// and `_kernel_is` (:591) of src/repro/kernels/fused_spectral_conv.py with
// their psum read-modify-write `_dma_rmw_start` (:487) / `_dma_rmw_finish`
// (:497)) compute the same function with another reuse.  A flow CTA owns one m range of RM input
// channels (RM a multiple of FSC_BM; G = ceil(M / RM) ranges) and one bin
// chunk of a cluster, as above:
//  * weight-stationary (reuse kernels): CTA = (m range, n block, chunk).  It
//    copies its plane block [FC][BN][RM] into shared memory once and walks
//    every tile block with it, so each plane element is read from device
//    memory once per layer.  Windows are re-read once per n block.
//  * input-stationary (reuse activations): CTA = (tile block, m range,
//    chunk).  It computes X~ of its windows for the whole m range once into
//    shared memory ([FC][RM][BP]) and walks every n block, streaming the
//    planes; each tile-FFT is computed once per tile block.
// After each output rectangle the cluster sums its bin chunks over
// distributed shared memory in rank order, as B1 does.  With one m range
// (G = 1) that is the finished output (bias, ReLU, stored as B1 stores it).
// Otherwise it is the range's partial, written to slice g of a split-K
// workspace [G, S2, N, slots] that the wrapper allocates, and a second
// launch (split_k.cuh) sums the slices in ascending g and applies bias and
// ReLU: no atomics, the same bits on every launch.  Bound: B1's operations
// plus the IFFT per m range, and bytes with the workspace written and read
// once; the flows trade it against re-reading planes (os, is) or windows
// (os, ws).  A CTA keeps one of the three arrays resident on top of B1's
// spatial partial, so RM is capped by shared memory: 16 for ws, 64 for is.
//
// Every entry point takes an optional residual shortcut `sc` laid out like
// y (B6 residual, shortcut.cuh), added after the bias and before the ReLU
// where the output is stored: B1/B3's flush, the flows' one-range flush or
// their finish pass.  B1/B3 read it from device memory at the flush or, with
// `sc_staged`, prefetch rank r's flush rows r, r + C, ... of the CTA's
// rectangle into shared memory before the channel loop (ceil(S2 / C) rows of
// BN x BP floats after the Layout; the wrapper checks that they fit).
//
// Block sizes come from the build (-DFSC_*), set by the Python wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "cp_async.cuh"
#include "halo.cuh"
#include "shortcut.cuh"
#include "split_k.cuh"

#if !defined(FSC_BN) || !defined(FSC_BP) || !defined(FSC_BM) || \
    !defined(FSC_FC) || !defined(FSC_THREADS)
#error "build through repro_torch.kernels._build (defines FSC_* block sizes)"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int BN = FSC_BN;        // output channels per CTA
constexpr int BP = FSC_BP;        // tiles per CTA
constexpr int BM = FSC_BM;        // input channels per pipeline step
constexpr int FC = FSC_FC;        // frequency bins per CTA (cluster rank)
constexpr int NT = FSC_THREADS;   // threads per CTA
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int MP = BM * BP;       // (m, p) pairs per step
constexpr int TN = BN * BP / NT;  // outputs per thread, spaced NSTRIDE in n
constexpr int NSTRIDE = NT / BP;
constexpr int FPT = FC * MP / NT; // tile-FFT bins per thread
constexpr int W_PLANE = FC * BN * BM;      // floats of one re or im plane
static_assert(NT % BP == 0 && (BN * BP) % NT == 0, "Hadamard thread map");
static_assert(BP % 4 == 0 && BM % 4 == 0, "16-byte copies and plane loads");
static_assert(NT % MP == 0 && (FC * MP) % NT == 0 && FPT % 2 == 0,
              "tile-FFT map (bin pairs as float4 DFT loads)");

// the reuse flows
constexpr int OS = 0;   // output-stationary: psum in registers over all of M
constexpr int WS = 1;   // weight-stationary: planes of an m range resident
constexpr int IS = 2;   // input-stationary: X~ of an m range resident

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory carve-up, in floats.  A ring stage holds the step's input
// (windows, or a halo block's raw rows) and, for os, its kernel planes; for
// is it holds the input while X~ is built and the planes afterwards.  The
// halo path also expands the raw rows into one window stage.  The spatial
// partial of an output rectangle aliases the ring (and the window stage).
// A staged shortcut (sc_floats) follows everything.
struct Layout {
  int df, dv, xf, res, stage, x_sz, x_stage, win, sc, total;
  __host__ __device__ Layout(int flow, int S, int S2, int x_floats,
                             int win_floats, int RM, int sc_floats = 0) {
    df = 0;                                  // [S][FC] (re, im)
    dv = df + 2 * S * FC;                    // [S2][FC] (re, im)
    xf = dv + 2 * S2 * FC;                   // X~ (re, im): [FC][MP]; is:
                                             // [FC][RM * BP] (the m range)
    res = xf + 2 * FC * (flow == IS ? RM * BP : MP);
    stage = res + (flow == WS ? 2 * FC * BN * RM : 0);   // ws: wr, wi
                                             // [FC][BN][RM] of the m range
    x_sz = align4(x_floats);
    x_stage = flow == OS ? x_sz + 2 * W_PLANE
                         : flow == WS ? x_sz : imax(x_sz, 2 * W_PLANE);
    win = stage + 2 * x_stage;               // [S][MP] expanded windows
    const int loop = 2 * x_stage + win_floats;
    const int acc = S2 * BN * BP;            // spatial partial, aliases both
    sc = stage + imax(loop, acc);            // [rows][BN][BP] staged shortcut
    total = sc + sc_floats;
  }
};

using namespace repro_torch;

// Windowed input: the host's windows xt [S][M][P] (rows of P floats at
// x_pitch), output tiles y [S2][N][P].
struct WindowedPath {
  const float* xt;
  int P, x_pitch;
  struct Blk {
    int p0;
    bool vec;   // 16-byte copies: every row start 16-byte aligned
  };
  __host__ __device__ int blocks() const { return (P + BP - 1) / BP; }
  __host__ __device__ int x_floats(int S) const { return S * MP; }
  __host__ __device__ int win_floats(int) const { return 0; }
  __device__ Blk block(int bx, int) const {
    return {bx * BP, x_pitch % 4 == 0 && (size_t)xt % 16 == 0};
  }
  __device__ void prepare(float*, int, int) const {}
  // windows [S][BM][BP] of channels m0.., zero-filled outside [M) x [P)
  __device__ void load(const Blk& k, float* sx, int S, int M, int m0,
                       int tid) const {
    if (k.vec) {
      for (int i = tid; i < S * MP / 4; i += NT) {
        const int s = i / (MP / 4), r = i - s * (MP / 4);
        const int m = r / (BP / 4), p = 4 * (r - m * (BP / 4));
        const int bytes = m0 + m < M ? clamp_bytes(P - k.p0 - p) : 0;
        cp_async16(sx + s * MP + m * BP + p,
                   bytes ? xt + ((size_t)s * M + m0 + m) * x_pitch + k.p0 + p
                         : xt, bytes);
      }
    } else {
      for (int i = tid; i < S * MP; i += NT) {
        const int s = i / MP, r = i - s * MP, m = r / BP, p = r - m * BP;
        const bool ok = m0 + m < M && k.p0 + p < P;
        cp_async4(sx + i,
                  ok ? xt + ((size_t)s * M + m0 + m) * x_pitch + k.p0 + p
                     : xt, ok);
      }
    }
  }
  __device__ const float* windows(const Blk&, const float* sx, float*,
                                  int) const {
    return sx;
  }
  __device__ long long out_at(const Blk& k, int s2, int n, int N,
                              int p) const {
    return k.p0 + p < P ? ((long long)s2 * N + n) * P + k.p0 + p : -1;
  }
};

using HaloIn = HaloPath<NT, BM, BP>;   // halo.cuh

// Output-stationary (B1 on the windowed path, B3 on the halo path): a CTA
// owns an (n block, tile block, bin chunk) and sums all of M in registers.
// SC: the shortcut's placement (shortcut.cuh).
template <class Path, int SC>
__global__ void __launch_bounds__(NT, 1)
fused_os_kernel(const Path io, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ dfr,
                const float* __restrict__ dfi, const float* __restrict__ dvr,
                const float* __restrict__ dvi, const float* __restrict__ bias,
                const float* __restrict__ sc, float* __restrict__ y, int S,
                int M, int Fa, int N, int S2, int relu) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(OS, S, S2, io.x_floats(S),
                 SC == SC_STAGED ? io.win_floats(S) : 0, BM);
  float* s_df = smem + L.df;
  float* s_dv = smem + L.dv;
  float* s_xf = smem + L.xf;
  float* s_y = smem + L.stage;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const typename Path::Blk blk = io.block(blockIdx.x, tid);
  const int n0 = blockIdx.y * BN;
  const int f0 = blockIdx.z * FC;           // this CTA's bin chunk
  const int tp = tid % BP, tn = tid / BP;   // Hadamard / fold / store map
  const int mp = tid % MP, fq = tid / MP;   // tile-FFT map

  const int fc = Fa - f0 < FC ? Fa - f0 : FC;   // bins of this chunk
  for (int i = tid; i < S * FC; i += NT) {
    const int s = i / FC, f = i - s * FC;
    const bool ok = f < fc;
    s_df[2 * i] = ok ? dfr[(size_t)(f0 + f) * S + s] : 0.f;
    s_df[2 * i + 1] = ok ? dfi[(size_t)(f0 + f) * S + s] : 0.f;
  }
  for (int i = tid; i < S2 * FC; i += NT) {
    const int s = i / FC, f = i - s * FC;
    const bool ok = f < fc;
    s_dv[2 * i] = ok ? dvr[(size_t)s * Fa + f0 + f] : 0.f;
    s_dv[2 * i + 1] = ok ? dvi[(size_t)s * Fa + f0 + f] : 0.f;
  }

  io.prepare(smem + L.win, S, tid);

  // 16-byte plane copies where every row start is 16-byte aligned
  const bool w_vec = M % 4 == 0 && (size_t)wr % 16 == 0 &&
                     (size_t)wi % 16 == 0;

  // one pipeline step: the input of channels m0.. (windows [S][BM][BP] or
  // raw rows) and this chunk's planes [FC][BN][BM] (re, im), zero-filled
  // outside [M) x [N) x [Fa)
  auto load_step = [&](int buf, int m0) {
    float* sx = smem + L.stage + buf * L.x_stage;
    float* swr = sx + L.x_sz;
    float* swi = swr + W_PLANE;
    io.load(blk, sx, S, M, m0, tid);
    if (w_vec) {
      for (int i = tid; i < W_PLANE / 4; i += NT) {
        const int f = i / (BN * BM / 4), r = i - f * (BN * BM / 4);
        const int n = r / (BM / 4), m = 4 * (r - n * (BM / 4));
        const int bytes =
            n0 + n < N && f < fc ? clamp_bytes(M - m0 - m) : 0;
        const size_t g = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
        cp_async16(swr + 4 * i, bytes ? wr + g : wr, bytes);
        cp_async16(swi + 4 * i, bytes ? wi + g : wi, bytes);
      }
    } else {
      for (int i = tid; i < W_PLANE; i += NT) {
        const int f = i / (BN * BM), r = i - f * (BN * BM);
        const int n = r / BM, m = r - n * BM;
        const bool ok = n0 + n < N && m0 + m < M && f < fc;
        const size_t g = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
        cp_async4(swr + i, ok ? wr + g : wr, ok);
        cp_async4(swi + i, ok ? wi + g : wi, ok);
      }
    }
    cp_async_commit();
  };

  float ar[FC][TN], ai[FC][TN];
#pragma unroll
  for (int f = 0; f < FC; ++f)
#pragma unroll
    for (int j = 0; j < TN; ++j) ar[f][j] = ai[f][j] = 0.f;

  // staged shortcut: the elements this thread adds at the flush (rows
  // rank, rank + C, ... in the flush's map), zero where nothing is stored;
  // the copies join the first step's group
  float* s_sc = smem + L.sc;
  if constexpr (SC == SC_STAGED) {
    const int rank = (int)cluster.block_rank();
    const int n_ranks = (int)cluster.num_blocks();
    for (int s = rank, q = 0; s < S2; s += n_ranks, ++q)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tn + j * NSTRIDE, gn = n0 + n;
        const long long o = gn < N ? io.out_at(blk, s, gn, N, tp) : -1;
        cp_async4(s_sc + (q * BN + n) * BP + tp, o >= 0 ? sc + o : sc,
                  o >= 0);
      }
  }

  const int n_steps = (M + BM - 1) / BM;
  load_step(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps)
      load_step((step + 1) & 1, (step + 1) * BM);
    else
      cp_async_commit();                    // empty group keeps the count
    cp_async_wait_prev();
    __syncthreads();                        // step's stage (and DFT) ready
    const float* stage = smem + L.stage + (step & 1) * L.x_stage;
    const float* sx = io.windows(blk, stage, smem + L.win, tid);
    const float* swr = stage + L.x_sz;
    const float* swi = swr + W_PLANE;

    // Stage 1: tile-FFT of this chunk's bins, X~[f, m, p] = Df[f, :] . x[:, m, p]
    {
      float xr[FPT], xi[FPT];
#pragma unroll
      for (int j = 0; j < FPT; ++j) xr[j] = xi[j] = 0.f;
      const float4* d4 =
          reinterpret_cast<const float4*>(s_df) + fq * (FPT / 2);
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float xv = sx[s * MP + mp];
#pragma unroll
        for (int q = 0; q < FPT / 2; ++q) {
          const float4 d = d4[s * (FC / 2) + q];   // bins 2q, 2q+1: re, im
          xr[2 * q] = fmaf(d.x, xv, xr[2 * q]);
          xi[2 * q] = fmaf(d.y, xv, xi[2 * q]);
          xr[2 * q + 1] = fmaf(d.z, xv, xr[2 * q + 1]);
          xi[2 * q + 1] = fmaf(d.w, xv, xi[2 * q + 1]);
        }
      }
      float2* xf2 = reinterpret_cast<float2*>(s_xf);
#pragma unroll
      for (int j = 0; j < FPT; ++j)
        xf2[(fq * FPT + j) * MP + mp] = make_float2(xr[j], xi[j]);
    }
    __syncthreads();

    // Stage 2: complex Hadamard summed over this step's channels
    const float2* xf2 = reinterpret_cast<const float2*>(s_xf);
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      float w_r[TN][BM], w_i[TN][BM];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = (f * BN + tn + j * NSTRIDE) * BM;
#pragma unroll
        for (int m = 0; m < BM; m += 4) {
          const float4 a = *reinterpret_cast<const float4*>(swr + row + m);
          const float4 b = *reinterpret_cast<const float4*>(swi + row + m);
          w_r[j][m] = a.x; w_r[j][m + 1] = a.y;
          w_r[j][m + 2] = a.z; w_r[j][m + 3] = a.w;
          w_i[j][m] = b.x; w_i[j][m + 1] = b.y;
          w_i[j][m + 2] = b.z; w_i[j][m + 3] = b.w;
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float2 xv = xf2[f * MP + m * BP + tp];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ar[f][j] = fmaf(w_r[j][m], xv.x, fmaf(-w_i[j][m], xv.y, ar[f][j]));
          ai[f][j] = fmaf(w_r[j][m], xv.y, fmaf(w_i[j][m], xv.x, ai[f][j]));
        }
      }
    }
    __syncthreads();                        // stage and X~ free for reuse
  }

  // Stage 3: this chunk's valid-row IFFT -> spatial partial (aliases the
  // ring, whose last readers passed the barrier above)
  const float4* dv4 = reinterpret_cast<const float4*>(s_dv);
  for (int s = 0; s < S2; ++s) {
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = 0.f;
#pragma unroll
    for (int f = 0; f < FC; f += 2) {
      const float4 d = dv4[(s * FC + f) / 2];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        v[j] = fmaf(d.x, ar[f][j], fmaf(-d.y, ai[f][j], v[j]));
        v[j] = fmaf(d.z, ar[f + 1][j], fmaf(-d.w, ai[f + 1][j], v[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      s_y[(s * BN + tn + j * NSTRIDE) * BP + tp] = v[j];
  }
  cluster.sync();                           // every chunk's partial is ready

  // Stage 4: sum the cluster's partials in rank order, bias (+ shortcut) +
  // ReLU, one write per output element; rank r finishes rows r, r + C, ...
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const float* part[MAX_CLUSTER];
  for (int q = 0; q < n_ranks; ++q) part[q] = cluster.map_shared_rank(s_y, q);
  if constexpr (SC == SC_STAGED) cp_async_wait_all();   // long since landed
  for (int s = rank, row = 0; s < S2; s += n_ranks, ++row) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tn + j * NSTRIDE, gn = n0 + n;
      const int at = (s * BN + n) * BP + tp;
      float v = 0.f;
      for (int q = 0; q < n_ranks; ++q) v += part[q][at];
      const long long o = gn < N ? io.out_at(blk, s, gn, N, tp) : -1;
      if (o >= 0) {
        v += bias[gn];
        if constexpr (SC == SC_GLOBAL) v += sc[o];
        if constexpr (SC == SC_STAGED) v += s_sc[(row * BN + n) * BP + tp];
        if (relu) v = fmaxf(v, 0.f);
        y[o] = v;
      }
    }
  }
  cluster.sync();                           // keep partials alive for readers
}

// The weight- and input-stationary flows (FLOW) on either input path
// (Path).  Grid: ws (m range, n block, chunk); is (tile block, m range,
// chunk); a cluster spans the chunks.  ws (the split-K workspace) is
// written only when the flow has more than one m range.  (Output-
// stationary keeps its own kernel above: folding it into this template
// made the compiler spill its register accumulators.)  SC: none or a
// global shortcut, added here with one m range, else by the finish pass.
template <class Path, int FLOW, int SC>
__global__ void __launch_bounds__(NT, 1)
fused_flow_kernel(const Path io, const float* __restrict__ wr,
                  const float* __restrict__ wi,
                  const float* __restrict__ dfr,
                  const float* __restrict__ dfi,
                  const float* __restrict__ dvr,
                  const float* __restrict__ dvi,
                  const float* __restrict__ bias,
                  const float* __restrict__ sc, float* __restrict__ y,
                  float* __restrict__ ws, int S, int M, int Fa, int N,
                  int S2, int relu, int RM) {
  static_assert(FLOW == WS || FLOW == IS, "output-stationary: above");
  static_assert(SC == SC_NONE || SC == SC_GLOBAL, "staged: os only");
  extern __shared__ __align__(16) float smem[];
  const Layout L(FLOW, S, S2, io.x_floats(S), 0, RM);
  float* s_df = smem + L.df;
  float* s_dv = smem + L.dv;
  float2* s_xf = reinterpret_cast<float2*>(smem + L.xf);
  float* s_res = smem + L.res;
  float* s_y = smem + L.stage;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int f0 = blockIdx.z * FC;           // this CTA's bin chunk
  const int tp = tid % BP, tn = tid / BP;   // Hadamard / fold / store map
  const int mp = tid % MP, fq = tid / MP;   // tile-FFT map
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();

  // this CTA's m range: range r of G
  const int G = FLOW == WS ? gridDim.x : gridDim.y;
  const int r = FLOW == WS ? blockIdx.x : blockIdx.y;
  const int m_lo = r * RM;
  const int m_hi = m_lo + RM < M ? m_lo + RM : M;
  const int n_steps = (m_hi - m_lo + BM - 1) / BM;
  const int slots = io.blocks() * BP;       // workspace tile columns

  const int fc = Fa - f0 < FC ? Fa - f0 : FC;   // bins of this chunk
  for (int i = tid; i < S * FC; i += NT) {
    const int s = i / FC, f = i - s * FC;
    const bool ok = f < fc;
    s_df[2 * i] = ok ? dfr[(size_t)(f0 + f) * S + s] : 0.f;
    s_df[2 * i + 1] = ok ? dfi[(size_t)(f0 + f) * S + s] : 0.f;
  }
  for (int i = tid; i < S2 * FC; i += NT) {
    const int s = i / FC, f = i - s * FC;
    const bool ok = f < fc;
    s_dv[2 * i] = ok ? dvr[(size_t)s * Fa + f0 + f] : 0.f;
    s_dv[2 * i + 1] = ok ? dvi[(size_t)s * Fa + f0 + f] : 0.f;
  }

  // 16-byte plane copies where every row start is 16-byte aligned
  const bool w_vec = M % 4 == 0 && (size_t)wr % 16 == 0 &&
                     (size_t)wi % 16 == 0;

  // this chunk's planes of n block n0 and channels m0 .. m0 + width into
  // swr [FC][BN][width] and the im half after it, zero-filled outside
  // [M) x [N) x [Fa) (width is BM or RM, both multiples of 4)
  auto load_w = [&](float* swr, int n0, int m0, int width) {
    float* swi = swr + FC * BN * width;
    const int w4 = width / 4;
    if (w_vec) {
      for (int i = tid; i < FC * BN * w4; i += NT) {
        const int f = i / (BN * w4), q = i - f * (BN * w4);
        const int n = q / w4, m = 4 * (q - n * w4);
        const int bytes =
            n0 + n < N && f < fc ? clamp_bytes(M - m0 - m) : 0;
        const size_t g = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
        cp_async16(swr + 4 * i, bytes ? wr + g : wr, bytes);
        cp_async16(swi + 4 * i, bytes ? wi + g : wi, bytes);
      }
    } else {
      for (int i = tid; i < FC * BN * width; i += NT) {
        const int f = i / (BN * width), q = i - f * (BN * width);
        const int n = q / width, m = q - n * width;
        const bool ok = n0 + n < N && m0 + m < M && f < fc;
        const size_t g = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
        cp_async4(swr + i, ok ? wr + g : wr, ok);
        cp_async4(swi + i, ok ? wi + g : wi, ok);
      }
    }
  };
  auto ring = [&](int buf) { return smem + L.stage + buf * L.x_stage; };

  // Stage 1: tile-FFT of this chunk's bins for the step's windows sx
  // [S][BM][BP]: X~[f, m, p] = Df[f, :] . x[:, m, p] -> xf2[f * pitch + mp]
  auto fft_step = [&](const float* sx, float2* xf2, int pitch) {
    float xr[FPT], xi[FPT];
#pragma unroll
    for (int j = 0; j < FPT; ++j) xr[j] = xi[j] = 0.f;
    const float4* d4 = reinterpret_cast<const float4*>(s_df) + fq * (FPT / 2);
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float xv = sx[s * MP + mp];
#pragma unroll
      for (int q = 0; q < FPT / 2; ++q) {
        const float4 d = d4[s * (FC / 2) + q];   // bins 2q, 2q+1: re, im
        xr[2 * q] = fmaf(d.x, xv, xr[2 * q]);
        xi[2 * q] = fmaf(d.y, xv, xi[2 * q]);
        xr[2 * q + 1] = fmaf(d.z, xv, xr[2 * q + 1]);
        xi[2 * q + 1] = fmaf(d.w, xv, xi[2 * q + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < FPT; ++j)
      xf2[(fq * FPT + j) * pitch + mp] = make_float2(xr[j], xi[j]);
  };

  float ar[FC][TN], ai[FC][TN];
  auto zero_acc = [&]() {
#pragma unroll
    for (int f = 0; f < FC; ++f)
#pragma unroll
      for (int j = 0; j < TN; ++j) ar[f][j] = ai[f][j] = 0.f;
  };

  // Stage 2: complex Hadamard summed over one step's BM channels: planes
  // swr/swi [FC][BN][width] at column mo, X~ xf2[f * pitch + m * BP + p]
  auto hadamard_step = [&](const float* swr, const float* swi, int width,
                           int mo, const float2* xf2, int pitch) {
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      float w_r[TN][BM], w_i[TN][BM];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = (f * BN + tn + j * NSTRIDE) * width + mo;
#pragma unroll
        for (int m = 0; m < BM; m += 4) {
          const float4 a = *reinterpret_cast<const float4*>(swr + row + m);
          const float4 b = *reinterpret_cast<const float4*>(swi + row + m);
          w_r[j][m] = a.x; w_r[j][m + 1] = a.y;
          w_r[j][m + 2] = a.z; w_r[j][m + 3] = a.w;
          w_i[j][m] = b.x; w_i[j][m + 1] = b.y;
          w_i[j][m + 2] = b.z; w_i[j][m + 3] = b.w;
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float2 xv = xf2[f * pitch + m * BP + tp];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ar[f][j] = fmaf(w_r[j][m], xv.x, fmaf(-w_i[j][m], xv.y, ar[f][j]));
          ai[f][j] = fmaf(w_r[j][m], xv.y, fmaf(w_i[j][m], xv.x, ai[f][j]));
        }
      }
    }
  };

  // Stage 3: this chunk's valid-row IFFT -> spatial partial s_y (aliases
  // the ring: call after the barrier that ends the last step)
  auto fold = [&]() {
    const float4* dv4 = reinterpret_cast<const float4*>(s_dv);
    for (int s = 0; s < S2; ++s) {
      float v[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] = 0.f;
#pragma unroll
      for (int f = 0; f < FC; f += 2) {
        const float4 d = dv4[(s * FC + f) / 2];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          v[j] = fmaf(d.x, ar[f][j], fmaf(-d.y, ai[f][j], v[j]));
          v[j] = fmaf(d.z, ar[f + 1][j], fmaf(-d.w, ai[f + 1][j], v[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j)
        s_y[(s * BN + tn + j * NSTRIDE) * BP + tp] = v[j];
    }
  };

  // Stage 4: sum the cluster's partials in rank order, one write per
  // element; rank q finishes rows q, q + C, ...  With one m range the sum
  // is the output (bias (+ shortcut) + ReLU, stored through the input
  // path); otherwise it is range r's partial, stored to workspace slice r.
  auto reduce_store = [&](const typename Path::Blk& blk, int bx, int n0) {
    cluster.sync();                         // every chunk's partial is ready
    const float* part[MAX_CLUSTER];
    for (int q = 0; q < n_ranks; ++q)
      part[q] = cluster.map_shared_rank(s_y, q);
    for (int s = rank; s < S2; s += n_ranks) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tn + j * NSTRIDE, gn = n0 + n;
        const int at = (s * BN + n) * BP + tp;
        float v = 0.f;
        for (int q = 0; q < n_ranks; ++q) v += part[q][at];
        if (gn >= N) continue;
        if (G == 1) {
          const long long o = io.out_at(blk, s, gn, N, tp);
          if (o >= 0) {
            v += bias[gn];
            if constexpr (SC == SC_GLOBAL) v += sc[o];
            if (relu) v = fmaxf(v, 0.f);
            y[o] = v;
          }
        } else {
          ws[(((size_t)r * S2 + s) * N + gn) * slots + bx * BP + tp] = v;
        }
      }
    }
    cluster.sync();                         // keep partials alive for readers
  };

  if constexpr (FLOW == WS) {
    // every tile block of one n block, the m range's planes resident
    const int n0 = blockIdx.y * BN;
    load_w(s_res, n0, m_lo, RM);
    cp_async_commit();                      // waited for with the first step
    for (int bx = 0; bx < io.blocks(); ++bx) {
      const typename Path::Blk blk = io.block(bx, tid);
      io.prepare(smem + L.win, S, tid);     // the partial overwrote it
      auto load_x = [&](int buf, int m0) {
        io.load(blk, ring(buf), S, M, m0, tid);
        cp_async_commit();
      };
      zero_acc();
      load_x(0, m_lo);
      for (int step = 0; step < n_steps; ++step) {
        if (step + 1 < n_steps)
          load_x((step + 1) & 1, m_lo + (step + 1) * BM);
        else
          cp_async_commit();                // empty group keeps the count
        cp_async_wait_prev();
        __syncthreads();                    // step's stage ready
        const float* sx = io.windows(blk, ring(step & 1), smem + L.win, tid);
        fft_step(sx, s_xf, MP);
        __syncthreads();
        hadamard_step(s_res, s_res + FC * BN * RM, RM, step * BM, s_xf, MP);
        __syncthreads();                    // stage and X~ free for reuse
      }
      fold();
      reduce_store(blk, bx, n0);
    }
  } else {
    // is: one tile block; X~ of the m range once, then every n block
    const typename Path::Blk blk = io.block(blockIdx.x, tid);
    io.prepare(smem + L.win, S, tid);
    const int pitch = RM * BP;
    auto load_x = [&](int buf, int m0) {
      io.load(blk, ring(buf), S, M, m0, tid);
      cp_async_commit();
    };
    load_x(0, m_lo);
    for (int step = 0; step < n_steps; ++step) {
      if (step + 1 < n_steps)
        load_x((step + 1) & 1, m_lo + (step + 1) * BM);
      else
        cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      const float* sx = io.windows(blk, ring(step & 1), smem + L.win, tid);
      fft_step(sx, s_xf + step * MP, pitch);
      __syncthreads();                      // stage free for reuse
    }
    for (int n0 = 0; n0 < N; n0 += BN) {
      auto load_p = [&](int buf, int m0) {
        load_w(ring(buf), n0, m0, BM);
        cp_async_commit();
      };
      zero_acc();
      load_p(0, m_lo);
      for (int step = 0; step < n_steps; ++step) {
        if (step + 1 < n_steps)
          load_p((step + 1) & 1, m_lo + (step + 1) * BM);
        else
          cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const float* stage = ring(step & 1);
        hadamard_step(stage, stage + W_PLANE, BM, 0, s_xf + step * MP,
                      pitch);
        __syncthreads();
      }
      fold();
      reduce_store(blk, blockIdx.x, n0);
    }
  }
}

// Configure and launch one layer on `stream` (and, for a flow with more
// than one m range, the split-K finish pass); returns the cudaError_t of the
// configuration and the launches (0 on success).  A shape whose shared
// memory exceeds the per-block limit fails cudaFuncSetAttribute.
template <class Path, int FLOW, int SC>
int launch(const Path& io, const float* wr, const float* wi,
           const float* dfr, const float* dfi, const float* dvr,
           const float* dvi, const float* bias, const float* sc, float* y,
           float* ws, int S, int M, int Fa, int N, int S2, int relu, int RM,
           void* stream) {
  if (FLOW != OS && (RM < BM || RM % BM != 0))
    return (int)cudaErrorInvalidValue;
  const int G = FLOW == OS ? 1 : (M + RM - 1) / RM;
  if (G > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int chunks = (Fa + FC - 1) / FC;
  // a staged shortcut: ceil(S2 / C) rows of the CTA's rectangle
  const int sc_floats =
      SC == SC_STAGED ? (S2 + chunks - 1) / chunks * BN * BP : 0;
  const Layout L(FLOW, S, S2, io.x_floats(S), io.win_floats(S), RM,
                 sc_floats);
  const size_t smem = (size_t)L.total * sizeof(float);
  const void* kernel;
  if constexpr (FLOW == OS)
    kernel = (const void*)fused_os_kernel<Path, SC>;
  else
    kernel = (const void*)fused_flow_kernel<Path, FLOW, SC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  const int nb = (N + BN - 1) / BN;
  cfg.gridDim = FLOW == OS ? dim3(io.blocks(), nb, chunks)
              : FLOW == WS ? dim3(G, nb, chunks)
                           : dim3(io.blocks(), G, chunks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = chunks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (FLOW == OS)
    err = cudaLaunchKernelEx(&cfg, fused_os_kernel<Path, SC>, io, wr, wi,
                             dfr, dfi, dvr, dvi, bias, sc, y, S, M, Fa, N,
                             S2, relu);
  else
    err = cudaLaunchKernelEx(&cfg, fused_flow_kernel<Path, FLOW, SC>, io, wr,
                             wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                             Fa, N, S2, relu, RM);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (FLOW != OS)    // os: one m range, no finish pass
    if (G > 1)
      err = launch_finish<Path, BP, SC>(io, ws, bias, sc, y, G, S2, N,
                                        io.blocks() * BP, relu,
                                        (cudaStream_t)stream);
  return (int)err;
}

// The instantiation for the shortcut's placement, chosen on the host: none
// (sc null), global, or staged (output-stationary only).
template <class Path, int FLOW>
int dispatch(const Path& io, const float* wr, const float* wi,
             const float* dfr, const float* dfi, const float* dvr,
             const float* dvi, const float* bias, const float* sc, float* y,
             float* ws, int S, int M, int Fa, int N, int S2, int relu,
             int RM, int sc_staged, void* stream) {
  if (sc == nullptr) {
    if (sc_staged) return (int)cudaErrorInvalidValue;
    return launch<Path, FLOW, SC_NONE>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                       sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                       stream);
  }
  if (!sc_staged)
    return launch<Path, FLOW, SC_GLOBAL>(io, wr, wi, dfr, dfi, dvr, dvi,
                                         bias, sc, y, ws, S, M, Fa, N, S2,
                                         relu, RM, stream);
  if constexpr (FLOW == OS)
    return launch<Path, OS, SC_STAGED>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                       sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                       stream);
  else
    return (int)cudaErrorInvalidValue;
}

bool windowed_ok(int S, int M, int P, int x_pitch, int Fa, int N, int S2) {
  return Fa >= 1 && Fa <= MAX_CLUSTER * FC && S >= 1 && M >= 1 && P >= 1 &&
         x_pitch >= P && N >= 1 && S2 >= 1;
}

template <int FLOW>
int windowed(const float* xt, const float* wr, const float* wi,
             const float* dfr, const float* dfi, const float* dvr,
             const float* dvi, const float* bias, const float* sc, float* y,
             float* ws, int S, int M, int P, int x_pitch, int Fa, int N,
             int S2, int relu, int RM, int sc_staged, void* stream) {
  if (!windowed_ok(S, M, P, x_pitch, Fa, N, S2))
    return (int)cudaErrorInvalidValue;
  return dispatch<WindowedPath, FLOW>(WindowedPath{xt, P, x_pitch}, wr, wi,
                                      dfr, dfi, dvr, dvi, bias, sc, y, ws, S,
                                      M, Fa, N, S2, relu, RM, sc_staged,
                                      stream);
}

template <int FLOW>
int halo(const float* x, const float* wr, const float* wi, const float* dfr,
         const float* dfi, const float* dvr, const float* dvi,
         const float* bias, const float* sc, float* y, float* ws, int B,
         int M, int H, int W, int K, int ksize, int pad, int n_th, int n_tw,
         int bth, int btw, int nbh, int nbw, int pre, int band, int Fa,
         int N, int S2, int relu, int RM, int sc_staged, void* stream) {
  HaloIn io{x, {}};
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > BP || S2 != io.g.t * io.g.t || Fa < 1 ||
      Fa > MAX_CLUSTER * FC || N < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<HaloIn, FLOW>(io, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y,
                                ws, K * K, M, Fa, N, S2, relu, RM, sc_staged,
                                stream);
}

}  // namespace

extern "C" {

// Every entry point: `sc`, the optional residual shortcut laid out like y
// (null for none), and `sc_staged` (output-stationary only: stage it in
// shared memory; 0 reads it at the flush).

// Windowed layer.  Fa is at most 8 * FSC_FC (one cluster of
// ceil(Fa / FSC_FC) CTAs); xt's rows of P floats lie x_pitch floats apart;
// sc is [S2, N, P]; the caller checks shapes, devices and layouts.
int fused_spectral_pipeline_f32(const float* xt, const float* wr,
                                const float* wi, const float* dfr,
                                const float* dfi, const float* dvr,
                                const float* dvi, const float* bias,
                                float* y, const float* sc, int S, int M,
                                int P, int x_pitch, int Fa, int N, int S2,
                                int relu, int sc_staged, void* stream) {
  return windowed<OS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, nullptr,
                      S, M, P, x_pitch, Fa, N, S2, relu, BM, sc_staged,
                      stream);
}

// Windowed layer, weight- / input-stationary over m ranges of RM channels
// (a multiple of FSC_BM).  With G = ceil(M / RM) > 1 ranges, ws is a
// workspace of G * S2 * N * ceil(P / FSC_BP) * FSC_BP floats.
int fused_spectral_pipeline_ws_f32(const float* xt, const float* wr,
                                   const float* wi, const float* dfr,
                                   const float* dfi, const float* dvr,
                                   const float* dvi, const float* bias,
                                   float* y, const float* sc, float* ws,
                                   int S, int M, int P, int x_pitch, int Fa,
                                   int N, int S2, int relu, int RM,
                                   int sc_staged, void* stream) {
  return windowed<WS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                      P, x_pitch, Fa, N, S2, relu, RM, sc_staged, stream);
}

int fused_spectral_pipeline_is_f32(const float* xt, const float* wr,
                                   const float* wi, const float* dfr,
                                   const float* dfi, const float* dvr,
                                   const float* dvi, const float* bias,
                                   float* y, const float* sc, float* ws,
                                   int S, int M, int P, int x_pitch, int Fa,
                                   int N, int S2, int relu, int RM,
                                   int sc_staged, void* stream) {
  return windowed<IS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                      P, x_pitch, Fa, N, S2, relu, RM, sc_staged, stream);
}

// Halo layer: x [B, M, H, W] contiguous, y and sc [B, N, H_out, W_out]; the
// tile grid (n_th x n_tw, spectral.make_geometry) in blocks of bth x btw <=
// FSC_BP tiles (spectral.halo_block_geometry), one CTA per (image, block).
// Band mode (band = 1): x is a shard's extended band whose first pre = k - 1
// rows are its top halo, and y is the uncropped band canvas
// [B, N, n_th*t, n_tw*t] (halo.cuh); pre = band = 0 is the plain layer.
int fused_spectral_pipeline_halo_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, int B, int M, int H, int W, int K, int ksize,
    int pad, int n_th, int n_tw, int bth, int btw, int nbh, int nbw, int pre,
    int band, int Fa, int N, int S2, int relu, int sc_staged, void* stream) {
  return halo<OS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, nullptr, B, M,
                  H, W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre,
                  band, Fa, N, S2, relu, BM, sc_staged, stream);
}

// Halo layer, weight- / input-stationary; ws (G > 1) holds
// G * S2 * N * B * nbh * nbw * FSC_BP floats.
int fused_spectral_pipeline_halo_ws_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, float* ws, int B, int M, int H, int W, int K,
    int ksize, int pad, int n_th, int n_tw, int bth, int btw, int nbh,
    int nbw, int pre, int band, int Fa, int N, int S2, int relu, int RM,
    int sc_staged, void* stream) {
  return halo<WS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, B, M, H,
                  W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre, band,
                  Fa, N, S2, relu, RM, sc_staged, stream);
}

int fused_spectral_pipeline_halo_is_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, float* ws, int B, int M, int H, int W, int K,
    int ksize, int pad, int n_th, int n_tw, int bth, int btw, int nbh,
    int nbw, int pre, int band, int Fa, int N, int S2, int relu, int RM,
    int sc_staged, void* stream) {
  return halo<IS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, B, M, H,
                  W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre, band,
                  Fa, N, S2, relu, RM, sc_staged, stream);
}

}  // extern "C"
