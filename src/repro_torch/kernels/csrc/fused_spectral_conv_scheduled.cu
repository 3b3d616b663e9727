// Fused spectral convolution with the SCHEDULED sparse Hadamard (Alg 2),
// output-stationary flow, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_spectral_pipeline_scheduled` with body
// `_kernel_os_sched` (stages `_tile_fft`, `_scheduled_hadamard`,
// `_ifft_real_nf`, epilogue) in src/repro/kernels/fused_spectral_conv.py.
// One launch computes a whole spectral conv layer on overlap-save windows,
// reading the kernel as the Alg-2 INDEX/VALUE tables instead of planes:
//
//   X~[f, m, p]   = Df[f, :] . xt[:, m, p]                (tile-FFT)
//   per (group g, channel m, cycle t, PE lane n):
//     bin f       = idx[g, m, t, sel[g, m, t, n]]
//     Y~[g*N' + n, f, p] += (vr + i vi)[g, m, t, n] * X~[f, m, p]
//   y[s2, o, p]   = act( Re( Dv[s2, :] . Y~[o, :, p] ) + b[o] )
//
//   xt  [S = K^2, M, P = B*T]   windows, rows of P floats at x_pitch
//   idx [GN, Mp, T, R] int32    replica read addresses (bins in [0, Fa))
//   sel [GN, Mp, T, NP] int32   replica column feeding PE lane n
//   vr/vi [GN, Mp, T, NP] f32   lane weight; zero = idle lane / padding
//   dfr/dfi [Fa, S], dvr/dvi [S2, Fa], bias [N] -> y [S2, N, P]
//
// Bound on an H100 SXM: operations = tile-FFT 4*Fa*S*M*P + complex MAC
// 8*(non-zero table entries)*P + valid-row IFFT 4*S2*Fa*N*P + epilogue
// 2*S2*N*P at 67 TFLOP/s fp32; bytes = windows + the four tables +
// operators + bias + output at 3.35 TB/s.  At alpha 4 the MACs are a third
// of the plane kernel's Karatsuba work and the tables half its plane
// bytes; full VGG16 at batch 1 is operations-bound overall, conv4_x and
// conv5_x bytes-bound (chip_smoke.py prints every layer's bound).  On CUDA
// cores a table entry costs a gather, a complex MAC and a scatter per
// tile, ~8 instructions where the plane kernel's register-blocked MAC
// costs ~1, so instruction issue, not the bound, limits this kernel.
//
// Design (fp32 FMA on CUDA cores, no TF32):
//  * As on the TPU, X~ and Y~ never reach device memory and each output is
//    written once, after bias and ReLU.  Indexed shared-memory loads take
//    the place of the TPU's one-hot gather/route/scatter matmuls.
//  * CTA = (block of BP = 4 tiles, kernel group of N' <= 64 lanes, chunk of
//    input channels).  Its complex psum covers every lane and every bin:
//    [64 bins][64 lanes] x 4 tiles (128 KB of shared memory).  So every
//    table entry of the group is a hit: each entry is decoded once per
//    CTA (out_index = idx[t][sel[t][n]]) and applied to all 4 tiles with
//    16-byte loads and stores, and the tile-FFT of a channel is computed
//    once per CTA, for all bins.
//  * A thread owns PE lane n and every 4th cycle of it.  The exact cover
//    serves each (lane, bin) once per channel, so no two threads and no
//    two cycles of a channel touch the same psum cell: the plain
//    read-modify-write has no race, and the result does not depend on
//    thread timing.
//  * One pipeline step is one input channel: its window rows and its four
//    table blocks (~16 KB at T = 20) arrive by cp.async into a two-stage
//    ring while the previous channel computes; two barriers per channel.
//  * Small layers at batch 1 (conv4_x, conv5_x: 7 or 3 tile blocks of 8
//    groups) have too few (tile, group) blocks to fill 132 SMs, so the
//    input channels are split over the CTAs of a thread-block cluster
//    (C <= 8, picked from the SM count).  After its channels each CTA
//    folds its psum through the valid-row IFFT into a [S2][64][4] spatial
//    partial (aliasing the psum), and the cluster sums the partials over
//    distributed shared memory in rank order (no atomics), each CTA
//    finishing S2/C output rows with bias + ReLU.  The output is bitwise
//    repeatable.
//  * Ragged edges are masked, never padded in the operands: the last
//    group (N not a multiple of NP), lanes NP..63, padded cycles (zero
//    weights), bins Fa..63 (zero DFT rows and columns) and the last tile
//    block (zero-filled window copies, no store).
//
// The halo sibling (`fused_spectral_pipeline_scheduled_halo_f32`, replacing
// the TPU kernel `fused_spectral_pipeline_scheduled_halo`) is the same kernel
// on another input path: a CTA's 4 tile slots hold one halo block (bth x btw
// tiles of one image), each channel step stages the block's raw rows
// (halo.cuh) and expands them into the same [S][4] window stage, and the
// rank that finishes an output row stores it straight into y[B, N, H_out,
// W_out].  The table walk, IFFT and cluster reduction are this kernel's
// code (templated on the input path); only the cluster size can differ
// from the windowed launch of the same layer, since it follows the number
// of (tile block, group) pairs, and with it the order of the channel sum.
//
// The weight- and input-stationary flows (entry points *_ws_f32 and
// *_is_f32, windowed and halo; replacing the TPU bodies `_kernel_ws_sched`
// (:642) and `_kernel_is_sched` (:659) of src/repro/kernels/
// fused_spectral_conv.py with their psum read-modify-write) compute the
// same function with another reuse.  A flow CTA owns one m range of RM input
// channels (G = ceil(M / RM) ranges) and no cluster:
//  * weight-stationary (reuse kernels): CTA = (m range, kernel group).  It
//    copies the group's table blocks of its RM channels into shared memory
//    once and walks every 4-tile block with them, so each table entry is
//    read from device memory once per layer; windows are re-read once per
//    group.  The 128 KB psum leaves room for about three table blocks (~16
//    KB each at T = 20), so RM is 1-3.
//  * input-stationary (reuse activations): CTA = (tile block, m range).  It
//    computes X~ of its 4 tiles for the m range once ([RM][64 bins] complex)
//    and walks every kernel group, streaming its tables; each tile-FFT is
//    computed once per tile block.
// After each (tile block, group) the CTA folds its psum through the
// valid-row IFFT as above.  With one m range that is the finished output;
// otherwise it is range g's partial, stored to slice g of the split-K
// workspace [G, S2, N, slots], and the finish pass of split_k.cuh sums the
// slices in ascending g and applies bias and ReLU (no atomics).  Bound: the
// os kernel's operations plus the IFFT per m range, and its bytes plus the
// workspace written and read once; ws's few table channels per CTA make G
// large (64-171 on VGG16), so the workspace, and a fold per tile block,
// decide its time; is pays the fold once per group.
//
// Every entry point takes an optional residual shortcut `sc` laid out like
// y (B6 residual, shortcut.cuh), added after the bias and before the ReLU
// where the output is stored: B4/B5's flush, the flows' one-range store or
// their finish pass.  B4/B5 read it from device memory at the flush or, with
// `sc_staged`, prefetch cluster rank r's flush rows r, r + C, ... of the
// CTA's 4 tiles x 64 lanes into shared memory before the channel loop
// (ceil(S2 / C) rows of 64 x 4 floats after the Layout; the wrapper checks
// that they fit, for the C this launch picks).
//
// Block sizes come from the build (-DSCH_*), set by the Python wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "cp_async.cuh"
#include "halo.cuh"
#include "shortcut.cuh"
#include "split_k.cuh"

#if !defined(SCH_BN) || !defined(SCH_THREADS)
#error "build through repro_torch.kernels._build (defines SCH_* block sizes)"
#endif

namespace cg = cooperative_groups;

namespace {

using namespace repro_torch;

constexpr int BN = SCH_BN;        // PE lanes (output channels) per CTA
constexpr int NT = SCH_THREADS;   // threads per CTA
constexpr int BP = 4;             // tiles per CTA: one float4 per cell
constexpr int FMAX = 64;          // bins per CTA (all active bins)
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int TQ = NT / BN;       // threads per lane (cycle phases)
constexpr int DFP = FMAX + 8;     // DFT row pitch in float2: the 4 s-phases
                                  // of a warp read two bank halves
static_assert(NT % BN == 0 && BN % 32 == 0, "lane-major thread map");
static_assert(NT == FMAX * BP, "tile-FFT map: 64 bins x 4 s-phases");
static_assert(TQ == BP, "epilogue map: cycle phase tq is tile tq");

// the reuse flows
constexpr int OS = 0;   // output-stationary: channels split over a cluster
constexpr int WS = 1;   // weight-stationary: table blocks of an m range
constexpr int IS = 2;   // input-stationary: X~ of an m range resident

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory carve-up, in floats (every array 16-byte aligned).  A ring
// stage holds one channel's input (windows, or a halo block's raw rows)
// and, for os, its table rows; for is it holds the input while X~ is built
// and the table rows afterwards.  The halo path also expands the raw rows
// into one window stage.  The epilogue's inverse DFT and spatial partial
// alias the psum.  A staged shortcut (sc_floats) follows everything.
struct Layout {
  int df, psum, xf, res, stage, stage_size, x_sz, idx_sz, tab_sz, tab_blk,
      win, part, dv, sc, total;
  __host__ __device__ Layout(int flow, int S, int S2, int T, int R, int NP,
                             int x_floats, int win_floats, int RM,
                             int sc_floats = 0) {
    df = 0;                                   // [S][DFP] (re, im)
    psum = df + 2 * S * DFP;                  // re, im [FMAX][BN] float4
    xf = psum + 2 * FMAX * BN * BP;           // re, im [FMAX] float4; is:
                                              // one pair per channel of RM
    x_sz = align4(x_floats);                  // windows [S][BP] or raw rows
    idx_sz = align4(T * R);                   // idx [T][R]
    tab_sz = align4(T * NP);                  // sel, vr, vi [T][NP]
    tab_blk = idx_sz + 3 * tab_sz;            // one (group, channel) block
    res = xf + 2 * FMAX * BP * (flow == IS ? RM : 1);
    stage = res + (flow == WS ? RM * tab_blk : 0);   // ws: the m range's
                                                     // table blocks
    stage_size = flow == OS ? x_sz + tab_blk
                            : flow == WS ? x_sz : imax(x_sz, tab_blk);
    win = stage + 2 * stage_size;             // [S][BP] expanded windows
    part = psum;                              // [S2][BN][BP], epilogue
    dv = part + S2 * BN * BP;                 // [S2][FMAX] (re, im)
    const int loop_end = win + win_floats;
    const int epi_end = dv + 2 * S2 * FMAX;
    sc = loop_end > epi_end ? loop_end : epi_end;   // [rows][BN][BP]
    total = sc + sc_floats;
  }
};

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
  __host__ __device__ int x_floats(int S) const { return S * BP; }
  __host__ __device__ int win_floats(int) const { return 0; }
  __device__ Blk block(int bx, int) const {
    return {bx * BP, x_pitch % 4 == 0 && (size_t)xt % 16 == 0};
  }
  __device__ void prepare(float*, int, int) const {}
  // channel m's window rows [S][BP], zero-filled past P
  __device__ void load(const Blk& k, float* sx, int S, int M, int m,
                       int tid) const {
    for (int s = tid; s < S; s += NT) {
      const float* row = xt + ((size_t)s * M + m) * x_pitch + k.p0;
      if (k.vec) {
        const int bytes = clamp_bytes(P - k.p0);
        cp_async16(sx + s * BP, bytes ? row : xt, bytes);
      } else {
        for (int p = 0; p < BP; ++p)
          cp_async4(sx + s * BP + p, k.p0 + p < P ? row + p : xt,
                    k.p0 + p < P);
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

using HaloIn = HaloPath<NT, 1, BP>;   // halo.cuh

// copy `count` contiguous 4-byte words, 16 bytes at a time when aligned
__device__ __forceinline__ void stage_words(float* dst, const float* src,
                                            int count, int tid) {
  int done = 0;
  if (((size_t)src & 15) == 0) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * NT)
      cp_async16(dst + i, src + i, 16);
  }
  for (int i = done + tid; i < count; i += NT) cp_async4(dst + i, src + i, true);
}

// One kernel for the three flows (FLOW) on either input path (Path).
// Grid: os (tile block, group, cluster rank over channel chunks); ws (m
// range, group); is (tile block, m range).  ws (the split-K workspace) is
// written only when the flow has more than one m range.  SC: the
// shortcut's placement (shortcut.cuh; staged for os only).
template <class Path, int FLOW, int SC>
__global__ void __launch_bounds__(NT, 1)
fused_sched_kernel(const Path io, const int* __restrict__ idx,
                   const int* __restrict__ sel, const float* __restrict__ vr,
                   const float* __restrict__ vi,
                   const float* __restrict__ dfr,
                   const float* __restrict__ dfi,
                   const float* __restrict__ dvr,
                   const float* __restrict__ dvi,
                   const float* __restrict__ bias,
                   const float* __restrict__ sc, float* __restrict__ y,
                   float* __restrict__ ws, int S, int M, int Mp, int T,
                   int R, int NP, int Fa, int N, int S2, int relu, int RM) {
  static_assert(SC != SC_STAGED || FLOW == OS, "staged: os only");
  extern __shared__ __align__(16) float smem[];
  const Layout L(FLOW, S, S2, T, R, NP, io.x_floats(S),
                 SC == SC_STAGED ? io.win_floats(S) : 0, RM);
  float2* s_df = reinterpret_cast<float2*>(smem + L.df);
  float4* s_pr = reinterpret_cast<float4*>(smem + L.psum);
  float4* s_pi = s_pr + FMAX * BN;
  float4* s_x = reinterpret_cast<float4*>(smem + L.xf);
  float* s_part = smem + L.part;
  float4* s_dv = reinterpret_cast<float4*>(smem + L.dv);   // bin pairs

  const int tid = threadIdx.x;
  const int slots = io.blocks() * BP;        // workspace tile columns
  const int GN = (N + NP - 1) / NP;
  // this CTA's channels: a cluster rank's share (os) or m range r of G
  int m_lo, m_hi, r = 0, G = 1;
  if constexpr (FLOW == OS) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int n_ranks = (int)cluster.num_blocks();
    m_lo = rank * M / n_ranks;
    m_hi = (rank + 1) * M / n_ranks;
  } else {
    G = FLOW == WS ? gridDim.x : gridDim.y;
    r = FLOW == WS ? blockIdx.x : blockIdx.y;
    m_lo = r * RM;
    m_hi = m_lo + RM < M ? m_lo + RM : M;
  }

  // forward DFT rows, bins Fa..63 zero
  for (int i = tid; i < S * FMAX; i += NT) {
    const int s = i / FMAX, f = i - s * FMAX;
    s_df[s * DFP + f] = f < Fa ? make_float2(dfr[(size_t)f * S + s],
                                             dfi[(size_t)f * S + s])
                               : make_float2(0.f, 0.f);
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto zero_psum = [&]() {
    for (int i = tid; i < 2 * FMAX * BN; i += NT) s_pr[i] = zero4;
  };

  const size_t tab_row = (size_t)T * NP;     // one (g, m) table block
  auto ring = [&](int buf) { return smem + L.stage + buf * L.stage_size; };
  // group g's table block of channel m into dst (idx, sel, vr, vi)
  auto stage_tables = [&](float* dst, int g, int m) {
    const size_t gm = (size_t)g * Mp + m;
    stage_words(dst, reinterpret_cast<const float*>(idx) + gm * T * R,
                T * R, tid);
    dst += L.idx_sz;
    stage_words(dst, reinterpret_cast<const float*>(sel) + gm * tab_row,
                T * NP, tid);
    stage_words(dst + L.tab_sz, vr + gm * tab_row, T * NP, tid);
    stage_words(dst + 2 * L.tab_sz, vi + gm * tab_row, T * NP, tid);
  };

  // tile-FFT map: bin ff, s-phase fh (lanes of 4 reduce by shuffles)
  const int ff = tid / 4, fh = tid & 3;
  // walk map: lane n, cycles t = tq, tq + TQ, ...
  const int n = tid % BN, tq = tid / BN;

  // Stage 1: tile-FFT of every bin for the 4 tiles of one channel's
  // windows xw [S][BP] -> xr[f], xi[f]
  auto fft_channel = [&](const float* xw, float4* xr, float4* xi) {
    const float4* x4 = reinterpret_cast<const float4*>(xw);
    float4 ar = zero4, ai = zero4;
    for (int s = fh; s < S; s += 4) {
      const float4 xv = x4[s];
      const float2 d = s_df[s * DFP + ff];
      ar.x = fmaf(d.x, xv.x, ar.x); ai.x = fmaf(d.y, xv.x, ai.x);
      ar.y = fmaf(d.x, xv.y, ar.y); ai.y = fmaf(d.y, xv.y, ai.y);
      ar.z = fmaf(d.x, xv.z, ar.z); ai.z = fmaf(d.y, xv.z, ai.z);
      ar.w = fmaf(d.x, xv.w, ar.w); ai.w = fmaf(d.y, xv.w, ai.w);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ar.x += __shfl_xor_sync(0xffffffffu, ar.x, o);
      ar.y += __shfl_xor_sync(0xffffffffu, ar.y, o);
      ar.z += __shfl_xor_sync(0xffffffffu, ar.z, o);
      ar.w += __shfl_xor_sync(0xffffffffu, ar.w, o);
      ai.x += __shfl_xor_sync(0xffffffffu, ai.x, o);
      ai.y += __shfl_xor_sync(0xffffffffu, ai.y, o);
      ai.z += __shfl_xor_sync(0xffffffffu, ai.z, o);
      ai.w += __shfl_xor_sync(0xffffffffu, ai.w, o);
    }
    if (fh == 0) xr[ff] = ar;
    if (fh == 1) xi[ff] = ai;
  };

  // Stage 2: execute lane n's cycles t = tq, tq + TQ, ... of one table
  // block tab (idx, sel, vr, vi) on all 4 tiles of X~ xr/xi
  auto apply_tables = [&](const float* tab, const float4* xr,
                          const float4* xi) {
    const int* s_idx = reinterpret_cast<const int*>(tab);
    const int* s_sel = s_idx + L.idx_sz;
    const float* s_vr = reinterpret_cast<const float*>(s_sel) + L.tab_sz;
    const float* s_vi = s_vr + L.tab_sz;
    if (n >= NP) return;
    for (int t = tq; t < T; t += TQ) {
      const int i = t * NP + n;
      const float wr = s_vr[i], wi = s_vi[i];
      const int rr = s_sel[i];
      if ((wr != 0.f || wi != 0.f) && (unsigned)rr < (unsigned)R) {
        const int f = s_idx[t * R + rr];
        if ((unsigned)f < (unsigned)Fa) {
          const float4 x_r = xr[f], x_i = xi[f];
          const int c = f * BN + n;
          float4 pr = s_pr[c], pi = s_pi[c];
          pr.x = fmaf(wr, x_r.x, fmaf(-wi, x_i.x, pr.x));
          pr.y = fmaf(wr, x_r.y, fmaf(-wi, x_i.y, pr.y));
          pr.z = fmaf(wr, x_r.z, fmaf(-wi, x_i.z, pr.z));
          pr.w = fmaf(wr, x_r.w, fmaf(-wi, x_i.w, pr.w));
          pi.x = fmaf(wr, x_i.x, fmaf(wi, x_r.x, pi.x));
          pi.y = fmaf(wr, x_i.y, fmaf(wi, x_r.y, pi.y));
          pi.z = fmaf(wr, x_i.z, fmaf(wi, x_r.z, pi.z));
          pi.w = fmaf(wr, x_i.w, fmaf(wi, x_r.w, pi.w));
          s_pr[c] = pr;
          s_pi[c] = pi;
        }
      }
    }
  };

  // Stage 3: valid-row IFFT of the psum -> spatial partial s_part.  The
  // thread's cell (n, tile tq) comes into registers over all bins, then
  // the partial and the inverse DFT overwrite the psum.  Call after the
  // barrier that ends the last channel.
  auto fold = [&]() {
    float pr[FMAX], pi[FMAX];
    const float* psr = reinterpret_cast<const float*>(s_pr);
    const float* psi = reinterpret_cast<const float*>(s_pi);
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      pr[f] = psr[(f * BN + n) * BP + tq];
      pi[f] = psi[(f * BN + n) * BP + tq];
    }
    __syncthreads();
    for (int i = tid; i < S2 * FMAX / 2; i += NT) {
      const int s = i / (FMAX / 2), f = 2 * (i - s * (FMAX / 2));
      const size_t at = (size_t)s * Fa + f;
      s_dv[i] = make_float4(f < Fa ? dvr[at] : 0.f, f < Fa ? dvi[at] : 0.f,
                            f + 1 < Fa ? dvr[at + 1] : 0.f,
                            f + 1 < Fa ? dvi[at + 1] : 0.f);
    }
    __syncthreads();
    for (int s = 0; s < S2; ++s) {
      float v = 0.f;
#pragma unroll
      for (int f = 0; f < FMAX; f += 2) {
        const float4 d = s_dv[s * (FMAX / 2) + f / 2];
        v = fmaf(d.x, pr[f], fmaf(-d.y, pi[f], v));
        v = fmaf(d.z, pr[f + 1], fmaf(-d.w, pi[f + 1], v));
      }
      s_part[(s * BN + n) * BP + tq] = v;
    }
  };

  // flows: store this CTA's own partial of group g, tile block bx: the
  // output (one m range) or workspace slice r
  auto store = [&](const typename Path::Blk& blk, int bx, int g) {
    const int gn = g * NP + n;
    if (n >= NP || gn >= N) return;
    for (int s = 0; s < S2; ++s) {
      float v = s_part[(s * BN + n) * BP + tq];
      if (G == 1) {
        const long long o = io.out_at(blk, s, gn, N, tq);
        if (o >= 0) {
          v += bias[gn];
          if constexpr (SC == SC_GLOBAL) v += sc[o];
          if (relu) v = fmaxf(v, 0.f);
          y[o] = v;
        }
      } else {
        ws[(((size_t)r * S2 + s) * N + gn) * slots + bx * BP + tq] = v;
      }
    }
  };

  if constexpr (FLOW == OS) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int n_ranks = (int)cluster.num_blocks();
    const typename Path::Blk blk = io.block(blockIdx.x, tid);
    const int g = blockIdx.y;                // kernel group: lanes g*NP + n
    io.prepare(smem + L.win, S, tid);
    zero_psum();
    // one pipeline step: channel m's input (window rows [S][BP] or raw
    // rows) and table blocks
    auto load_step = [&](int buf, int m) {
      io.load(blk, ring(buf), S, M, m, tid);
      stage_tables(ring(buf) + L.x_sz, g, m);
      cp_async_commit();
    };
    float4* s_xr = s_x;
    float4* s_xi = s_x + FMAX;
    // staged shortcut: the elements this thread adds at the flush (rows
    // rank, rank + C, ... of lane n, tile tq), zero where nothing is
    // stored; their group is waited for with the first channel's
    float* s_sc = smem + L.sc;
    if constexpr (SC == SC_STAGED) {
      const int gn = g * NP + n;
      for (int s = rank, q = 0; s < S2; s += n_ranks, ++q) {
        const long long o =
            n < NP && gn < N ? io.out_at(blk, s, gn, N, tq) : -1;
        cp_async4(s_sc + (q * BN + n) * BP + tq, o >= 0 ? sc + o : sc,
                  o >= 0);
      }
      cp_async_commit();
    }
    if (m_lo < m_hi) load_step(0, m_lo);
    for (int m = m_lo; m < m_hi; ++m) {
      const int buf = (m - m_lo) & 1;
      cp_async_wait_all();
      __syncthreads();     // channel m staged; channel m - 1 fully applied
      if (m + 1 < m_hi) load_step(buf ^ 1, m + 1);
      const float* sx = ring(buf);
      const float* xw = io.windows(blk, sx, smem + L.win, tid);
      fft_channel(xw, s_xr, s_xi);
      __syncthreads();                       // X~ of channel m is ready
      apply_tables(sx + L.x_sz, s_xr, s_xi);
    }
    __syncthreads();                         // every channel applied
    fold();
    cluster.sync();                          // every rank's partial is ready

    // Stage 4: sum the cluster's partials in rank order, bias (+
    // shortcut) + ReLU, one write per output element; rank r finishes rows
    // r, r + C, ...
    const float* part[MAX_CLUSTER];
    for (int q = 0; q < n_ranks; ++q)
      part[q] = cluster.map_shared_rank(s_part, q);
    const int gn = g * NP + n;
    if constexpr (SC == SC_STAGED) cp_async_wait_all();  // long since landed
    for (int s = rank, row = 0; s < S2; s += n_ranks, ++row) {
      const int at = (s * BN + n) * BP + tq;
      float v = 0.f;
      for (int q = 0; q < n_ranks; ++q) v += part[q][at];
      const long long o =
          n < NP && gn < N ? io.out_at(blk, s, gn, N, tq) : -1;
      if (o >= 0) {
        v += bias[gn];
        if constexpr (SC == SC_GLOBAL) v += sc[o];
        if constexpr (SC == SC_STAGED) v += s_sc[(row * BN + n) * BP + tq];
        if (relu) v = fmaxf(v, 0.f);
        y[o] = v;
      }
    }
    cluster.sync();                          // keep partials alive for readers
  } else if constexpr (FLOW == WS) {
    // every tile block of one group, the m range's table blocks resident
    const int g = blockIdx.y;
    float* s_tab = smem + L.res;
    for (int m = m_lo; m < m_hi; ++m)
      stage_tables(s_tab + (m - m_lo) * L.tab_blk, g, m);
    cp_async_commit();                       // waited for with channel m_lo
    float4* s_xr = s_x;
    float4* s_xi = s_x + FMAX;
    for (int bx = 0; bx < io.blocks(); ++bx) {
      const typename Path::Blk blk = io.block(bx, tid);
      io.prepare(smem + L.win, S, tid);
      zero_psum();
      auto load_x = [&](int buf, int m) {
        io.load(blk, ring(buf), S, M, m, tid);
        cp_async_commit();
      };
      load_x(0, m_lo);
      for (int m = m_lo; m < m_hi; ++m) {
        const int buf = (m - m_lo) & 1;
        cp_async_wait_all();
        __syncthreads();   // channel m staged; channel m - 1 fully applied
        if (m + 1 < m_hi) load_x(buf ^ 1, m + 1);
        const float* xw = io.windows(blk, ring(buf), smem + L.win, tid);
        fft_channel(xw, s_xr, s_xi);
        __syncthreads();                     // X~ of channel m is ready
        apply_tables(s_tab + (m - m_lo) * L.tab_blk, s_xr, s_xi);
      }
      __syncthreads();                       // every channel applied
      fold();
      __syncthreads();                       // partial complete
      store(blk, bx, g);
      __syncthreads();                       // partial read: psum reusable
    }
  } else {
    // one tile block: X~ of the m range once, then every group
    const typename Path::Blk blk = io.block(blockIdx.x, tid);
    io.prepare(smem + L.win, S, tid);
    auto xr_of = [&](int m) { return s_x + (m - m_lo) * 2 * FMAX; };
    auto load_x = [&](int buf, int m) {
      io.load(blk, ring(buf), S, M, m, tid);
      cp_async_commit();
    };
    load_x(0, m_lo);
    for (int m = m_lo; m < m_hi; ++m) {
      const int buf = (m - m_lo) & 1;
      cp_async_wait_all();
      __syncthreads();     // channel m staged; channel m - 1 transformed
      if (m + 1 < m_hi) load_x(buf ^ 1, m + 1);
      const float* xw = io.windows(blk, ring(buf), smem + L.win, tid);
      fft_channel(xw, xr_of(m), xr_of(m) + FMAX);
    }
    for (int g = 0; g < GN; ++g) {
      auto load_t = [&](int buf, int m) {
        stage_tables(ring(buf), g, m);
        cp_async_commit();
      };
      __syncthreads();     // X~ ready / the previous group's partial read
      zero_psum();
      load_t(0, m_lo);
      for (int m = m_lo; m < m_hi; ++m) {
        const int buf = (m - m_lo) & 1;
        cp_async_wait_all();
        __syncthreads();   // channel m staged; channel m - 1 fully applied
        if (m + 1 < m_hi) load_t(buf ^ 1, m + 1);
        apply_tables(ring(buf), xr_of(m), xr_of(m) + FMAX);
      }
      __syncthreads();                       // every channel applied
      fold();
      __syncthreads();                       // partial complete
      store(blk, blockIdx.x, g);
    }
  }
}

// Configure and launch one layer on `stream` (and, for a flow with more
// than one m range, the split-K finish pass); returns the cudaError_t of the
// configuration and the launches (0 on success).  Output-stationary splits
// the input channels over a cluster of C CTAs, C the smallest count that
// gives about two CTAs per SM (at most 8, at most M).  Sizes whose shared
// memory exceeds the per-block limit fail cudaFuncSetAttribute.
template <class Path, int FLOW, int SC>
int launch(const Path& io, const int* idx, const int* sel, const float* vr,
           const float* vi, const float* dfr, const float* dfi,
           const float* dvr, const float* dvi, const float* bias,
           const float* sc, float* y, float* ws, int S, int M, int GN,
           int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
           int RM, void* stream) {
  if (Fa < 1 || Fa > FMAX || S < 1 || M < 1 || Mp < M || GN < 1 || T < 1 ||
      R < 1 || NP < 1 || NP > BN || N < 1 || N > GN * NP || S2 < 1 ||
      RM < 1)
    return (int)cudaErrorInvalidValue;
  const int G = FLOW == OS ? 1 : (M + RM - 1) / RM;
  if (G > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int C = 1;
  if (FLOW == OS) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int blocks = io.blocks() * GN;
    C = (2 * sms + blocks - 1) / blocks;
    C = C < 1 ? 1 : C > MAX_CLUSTER ? MAX_CLUSTER : C;
    C = C > M ? M : C;
  }
  // a staged shortcut: ceil(S2 / C) rows of the CTA's lanes x tiles
  const int sc_floats = SC == SC_STAGED ? (S2 + C - 1) / C * BN * BP : 0;
  const Layout L(FLOW, S, S2, T, R, NP, io.x_floats(S), io.win_floats(S),
                 RM, sc_floats);
  const size_t smem = (size_t)L.total * sizeof(float);
  err = cudaFuncSetAttribute(fused_sched_kernel<Path, FLOW, SC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = FLOW == OS ? dim3(io.blocks(), GN, C)
              : FLOW == WS ? dim3(G, GN, 1)
                           : dim3(io.blocks(), G, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_sched_kernel<Path, FLOW, SC>, io, idx,
                           sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                           S, M, Mp, T, R, NP, Fa, N, S2, relu, RM);
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
int dispatch(const Path& io, const int* idx, const int* sel, const float* vr,
             const float* vi, const float* dfr, const float* dfi,
             const float* dvr, const float* dvi, const float* bias,
             const float* sc, float* y, float* ws, int S, int M, int GN,
             int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
             int RM, int sc_staged, void* stream) {
  if (sc == nullptr) {
    if (sc_staged) return (int)cudaErrorInvalidValue;
    return launch<Path, FLOW, SC_NONE>(io, idx, sel, vr, vi, dfr, dfi, dvr,
                                       dvi, bias, sc, y, ws, S, M, GN, Mp, T,
                                       R, NP, Fa, N, S2, relu, RM, stream);
  }
  if (!sc_staged)
    return launch<Path, FLOW, SC_GLOBAL>(io, idx, sel, vr, vi, dfr, dfi,
                                         dvr, dvi, bias, sc, y, ws, S, M, GN,
                                         Mp, T, R, NP, Fa, N, S2, relu, RM,
                                         stream);
  if constexpr (FLOW == OS)
    return launch<Path, OS, SC_STAGED>(io, idx, sel, vr, vi, dfr, dfi, dvr,
                                       dvi, bias, sc, y, ws, S, M, GN, Mp, T,
                                       R, NP, Fa, N, S2, relu, RM, stream);
  else
    return (int)cudaErrorInvalidValue;
}

template <int FLOW>
int windowed(const float* xt, const int* idx, const int* sel,
             const float* vr, const float* vi, const float* dfr,
             const float* dfi, const float* dvr, const float* dvi,
             const float* bias, const float* sc, float* y, float* ws, int S,
             int M, int P, int x_pitch, int GN, int Mp, int T, int R, int NP,
             int Fa, int N, int S2, int relu, int RM, int sc_staged,
             void* stream) {
  if (P < 1 || x_pitch < P) return (int)cudaErrorInvalidValue;
  return dispatch<WindowedPath, FLOW>(WindowedPath{xt, P, x_pitch}, idx, sel,
                                      vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                                      ws, S, M, GN, Mp, T, R, NP, Fa, N, S2,
                                      relu, RM, sc_staged, stream);
}

template <int FLOW>
int halo(const float* x, const int* idx, const int* sel, const float* vr,
         const float* vi, const float* dfr, const float* dfi,
         const float* dvr, const float* dvi, const float* bias,
         const float* sc, float* y, float* ws, int B, int M, int H, int W,
         int K, int ksize, int pad, int n_th, int n_tw, int bth, int btw,
         int nbh, int nbw, int pre, int band, int Mp, int T, int R, int NP,
         int Fa, int N, int S2, int relu, int RM, int sc_staged,
         void* stream) {
  HaloIn io{x, {}};
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > BP || S2 != io.g.t * io.g.t || NP < 1)
    return (int)cudaErrorInvalidValue;
  const int GN = (N + NP - 1) / NP;
  return dispatch<HaloIn, FLOW>(io, idx, sel, vr, vi, dfr, dfi, dvr, dvi,
                                bias, sc, y, ws, K * K, M, GN, Mp, T, R, NP,
                                Fa, N, S2, relu, RM, sc_staged, stream);
}

}  // namespace

extern "C" {

// Every entry point: `sc`, the optional residual shortcut laid out like y
// (null for none), and `sc_staged` (output-stationary only: stage it in
// shared memory; 0 reads it at the flush).

// Windowed layer.  Tables are [GN, Mp, T, R] (idx) and [GN, Mp, T, NP]
// (sel, vr, vi) with NP <= SCH_BN lanes per group and Mp >= M; Fa is at
// most 64; xt's rows of P floats lie x_pitch floats apart; sc is
// [S2, N, P].  The caller checks shapes, devices and layouts.
int fused_spectral_pipeline_scheduled_f32(
    const float* xt, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc, int S,
    int M, int P, int x_pitch, int GN, int Mp, int T, int R, int NP, int Fa,
    int N, int S2, int relu, int sc_staged, void* stream) {
  return windowed<OS>(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                      nullptr, S, M, P, x_pitch, GN, Mp, T, R, NP, Fa, N, S2,
                      relu, 1, sc_staged, stream);
}

// Windowed layer, weight- / input-stationary over m ranges of RM channels;
// with G = ceil(M / RM) > 1 ranges, ws is a workspace of
// G * S2 * N * ceil(P / 4) * 4 floats.
int fused_spectral_pipeline_scheduled_ws_f32(
    const float* xt, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int S, int M, int P, int x_pitch, int GN, int Mp, int T,
    int R, int NP, int Fa, int N, int S2, int relu, int RM, int sc_staged,
    void* stream) {
  return windowed<WS>(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                      ws, S, M, P, x_pitch, GN, Mp, T, R, NP, Fa, N, S2,
                      relu, RM, sc_staged, stream);
}

int fused_spectral_pipeline_scheduled_is_f32(
    const float* xt, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int S, int M, int P, int x_pitch, int GN, int Mp, int T,
    int R, int NP, int Fa, int N, int S2, int relu, int RM, int sc_staged,
    void* stream) {
  return windowed<IS>(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                      ws, S, M, P, x_pitch, GN, Mp, T, R, NP, Fa, N, S2,
                      relu, RM, sc_staged, stream);
}

// Halo layer: x [B, M, H, W] contiguous, y and sc [B, N, H_out, W_out]; the
// tile grid (n_th x n_tw, spectral.make_geometry) in blocks of bth x btw <=
// 4 tiles (spectral.halo_block_geometry); tables as for the windowed layer.
// Band mode (band = 1): x is a shard's extended band whose first pre = k - 1
// rows are its top halo, and y is the uncropped band canvas
// [B, N, n_th*t, n_tw*t] (halo.cuh); pre = band = 0 is the plain layer.
int fused_spectral_pipeline_scheduled_halo_f32(
    const float* x, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc, int B,
    int M, int H, int W, int K, int ksize, int pad, int n_th, int n_tw,
    int bth, int btw, int nbh, int nbw, int pre, int band, int Mp, int T,
    int R, int NP, int Fa, int N, int S2, int relu, int sc_staged,
    void* stream) {
  return halo<OS>(x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                  nullptr, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                  nbh, nbw, pre, band, Mp, T, R, NP, Fa, N, S2, relu, 1,
                  sc_staged, stream);
}

// Halo layer, weight- / input-stationary; ws (G > 1) holds
// G * S2 * N * B * nbh * nbw * 4 floats.
int fused_spectral_pipeline_scheduled_halo_ws_f32(
    const float* x, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int B, int M, int H, int W, int K, int ksize, int pad,
    int n_th, int n_tw, int bth, int btw, int nbh, int nbw, int pre,
    int band, int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
    int RM, int sc_staged, void* stream) {
  return halo<WS>(x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                  B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw,
                  pre, band, Mp, T, R, NP, Fa, N, S2, relu, RM, sc_staged,
                  stream);
}

int fused_spectral_pipeline_scheduled_halo_is_f32(
    const float* x, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int B, int M, int H, int W, int K, int ksize, int pad,
    int n_th, int n_tw, int bth, int btw, int nbh, int nbw, int pre,
    int band, int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
    int RM, int sc_staged, void* stream) {
  return halo<IS>(x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                  B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw,
                  pre, band, Mp, T, R, NP, Fa, N, S2, relu, RM, sc_staged,
                  stream);
}

}  // extern "C"
