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
// conv5_x bytes-bound (chip_smoke.py prints every layer's bound).
//
// Design of the output-stationary kernel (B4 windowed, B5 halo;
// `fused_sched_os_kernel`, 512 threads):
//  * As on the TPU, X~ and Y~ never reach device memory and each output is
//    written once, after bias and ReLU.  The TPU applies the tables through
//    one-hot gather/route/scatter matmuls; here each channel's entries are
//    expanded into a dense weight block W[bin][lane] in shared memory (the
//    exact cover gives every (bin, lane) at most one entry a channel), and
//    the complex MACs read it.
//  * CTA = (block of 8 tiles, one half (32 lanes) of a kernel group of N'
//    <= 64 lanes, a cluster rank over the input channels), all 64 bins.
//    The psum [64 bins][32 lanes][8 tiles] lives in registers: warp w of
//    16 keeps bins 4 w .. 4 w + 3 of lane `lane`, so a MAC is a register
//    FMA against a broadcast X~ row, with no shared read-modify-write.
//  * One pipeline step is one input channel: its window rows and its table
//    rows (idx, then the CTA's 32 lanes of sel, vr, vi) arrive by cp.async
//    into a five-stage ring.  Per step, between two barriers: warps 0-7
//    run the tile-FFT on the tensor cores in 3xTF32 (mma3_f32; the DFT rows
//    split once per CTA into fragment order; the 8 tile slots as the 8
//    columns), warps 8-15 expand the channel's tables into W, and all warps
//    run the previous channel's MACs (X~ and W double-buffered; a MAC
//    zeroes the W cell it read for the channel after next).
//  * After its channels, the CTA stages Y~ in shared memory and runs the
//    valid-row IFFT on the tensor cores (A = [Dvr | -Dvi] split once into
//    fragment order, B = Y~; 3xTF32) into a [S2][32 x 8] partial.  Where
//    (tile block, group half) CTAs would not fill the card, the input
//    channels are split over a thread-block cluster of C CTAs (C <= 8,
//    chosen from the card's cluster capacity, `os_cluster`), and the
//    cluster sums its ranks' partials over distributed shared memory in
//    rank order (no atomics), each rank finishing rows r, r + C, ... with
//    bias + ReLU.  The output is bitwise repeatable.
//  * Ragged edges are masked, never padded in the operands: the last
//    group (N not a multiple of NP), lanes past NP, padded cycles (zero
//    weights), bins Fa..63 (zero DFT rows and columns) and the last tile
//    block (zero-filled window copies, no store).
//
// The halo sibling (`fused_spectral_pipeline_scheduled_halo_f32`, replacing
// the TPU kernel `fused_spectral_pipeline_scheduled_halo`) is the same kernel
// on another input path: a CTA's 8 tile slots hold one halo block (bth x btw
// tiles of one image), each channel step stages the block's raw rows
// (halo.cuh), the tile-FFT reads its window elements from them by offset,
// and the rank that finishes an output row stores it straight into y[B, N,
// H_out, W_out].  Only the cluster size can differ from the windowed launch
// of the same layer, since it follows the number of (tile block, group
// half) CTAs, and with it the order of the channel sum.
//
// The weight- and input-stationary flows (entry points *_ws_f32 and
// *_is_f32, windowed and halo; replacing the TPU bodies `_kernel_ws_sched`
// (:642) and `_kernel_is_sched` (:659) of src/repro/kernels/
// fused_spectral_conv.py with their psum read-modify-write) compute the
// same function with another reuse, on the CUDA cores (`fused_sched_kernel`,
// 4 tiles and a whole group a CTA, the psum [64 bins][64 lanes][4 tiles] in
// shared memory, each entry applied by a read-modify-write).  A flow CTA
// owns one m range of RM input channels (G = ceil(M / RM) ranges) and no
// cluster:
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
// CTA's 8 tiles x 32 lanes into shared memory before the channel loop
// (ceil(S2 / C) rows of 32 x 8 floats after the OsLayout; the wrapper
// checks that they fit, for the C this launch picks).
//
// Block sizes come from the build (-DSCH_*), set by the Python wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

#include "cp_async.cuh"
#include "halo.cuh"
#include "mma_tf32.cuh"
#include "shortcut.cuh"
#include "split_k.cuh"

#if !defined(SCH_BN) || !defined(SCH_THREADS) || \
    !defined(SCH_OS_THREADS) || !defined(SCH_FIXED_STEPS)
#error "build through repro_torch.kernels._build (defines SCH_* block sizes)"
#endif

namespace cg = cooperative_groups;

namespace {

using namespace repro_torch;

constexpr int BN = SCH_BN;        // PE lanes (output channels) per CTA
constexpr int NT = SCH_THREADS;   // threads per CTA
constexpr int BP = 4;             // flows: tiles per CTA, one float4 a cell
constexpr int FMAX = 64;          // bins per CTA (all active bins)
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int TQ = NT / BN;       // threads per lane (cycle phases)
constexpr int DFP = FMAX + 8;     // DFT row pitch in float2: the 4 s-phases
                                  // of a warp read two bank halves
static_assert(NT % BN == 0 && BN % 32 == 0, "lane-major thread map");
static_assert(NT == FMAX * BP, "tile-FFT map: 64 bins x 4 s-phases");
static_assert(TQ == BP, "epilogue map: cycle phase tq is tile tq");

// The output-stationary kernel (B4, B5): a CTA takes OBP tiles and one
// half (OLN lanes) of a kernel group, all FMAX bins, with ONT threads:
// warp w (of 16) keeps the psum of bins 4 w .. 4 w + 3 for lane `lane` in
// registers; in the tile-FFT, warp w < 8 takes bins 8 w .. 8 w + 7 (re,
// then im: the 16 rows of an m16n8k8 A fragment).
constexpr int OBP = 8;
constexpr int OLN = 32;
constexpr int ONT = SCH_OS_THREADS;
constexpr int OWARPS = ONT / 32;
constexpr int OBINS = FMAX / OWARPS;      // psum bins a warp keeps
constexpr int YP = OLN * OBP + 8;         // Y~ / partial row pitch (8 mod 32)
constexpr int OS_STAGES = 5;              // the deepest ring tried (>= 2)
constexpr int MT2_MAX = 4;                // IFFT row tiles: S2 <= 64
constexpr int KS2 = 2 * FMAX / 8;         // IFFT k steps (re, im bins)
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a CTA
// The cluster rule's price of a CTA's set-up, IFFT and reduction, in
// channel steps (os_cluster; fsc.SCHED_FIXED_STEPS mirrors it).
constexpr int FIXED_STEPS = SCH_FIXED_STEPS;
static_assert(ONT == 512 && OWARPS == 16 && OBINS == 4 && OLN == 32 &&
                  FMAX == 8 * (OWARPS / 2),
              "output-stationary map: 16 warps, 4 psum bins a warp, the "
              "tile-FFT on warps 0-7");

// the reuse flows
constexpr int OS = 0;   // output-stationary: channels split over a cluster
constexpr int WS = 1;   // weight-stationary: table blocks of an m range
constexpr int IS = 2;   // input-stationary: X~ of an m range resident

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory carve-up of the flows, in floats (every array 16-byte
// aligned).  A ring stage holds one channel's input (windows, or a halo
// block's raw rows); for is it holds the input while X~ is built and the
// table rows afterwards.  The halo path also expands the raw rows into one
// window stage.  The epilogue's inverse DFT and spatial partial alias the
// psum.
struct Layout {
  int df, psum, xf, res, stage, stage_size, x_sz, idx_sz, tab_sz, tab_blk,
      win, part, dv, total;
  __host__ __device__ Layout(int flow, int S, int S2, int T, int R, int NP,
                             int x_floats, int win_floats, int RM) {
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
    stage_size = flow == WS ? x_sz : imax(x_sz, tab_blk);
    win = stage + 2 * stage_size;             // [S][BP] expanded windows
    part = psum;                              // [S2][BN][BP], epilogue
    dv = part + S2 * BN * BP;                 // [S2][FMAX] (re, im)
    total = imax(win + win_floats, dv + 2 * S2 * FMAX);
  }
};

// Shared-memory carve-up of the output-stationary kernel, in floats.  The
// channel loop: the tile-FFT's split A fragments ([2][8 row tiles][8 k
// steps][32 lanes][4]), X~ and the expanded weights of two channels
// (double-buffered; X~ re, im [FMAX][OBP]; W (re, im) [FMAX][OLN]), the
// halo path's S window offsets, then a ring of `stages` slots, each one
// channel's input (windows [S][OBP] or a halo block's raw rows) and its
// table rows (idx [T][R], then sel, vr, vi [T][OLN] of the CTA's lanes).
// After the loop the same bytes hold Y~ ([2 FMAX][YP]: re, then im rows),
// then the partial ([S2][YP], in Y~'s place), and the IFFT's split A
// fragments ([2][mt2][KS2][32][4]).  A staged shortcut (sc_floats)
// follows both.  Five stages where they fit the card's limit, else fewer
// (at least two).
struct OsLayout {
  int fa, xf, wd, soff, ring, x_sz, idx_sz, tab_sz, slot, stages, ys, va,
      sc, total;
  __host__ __device__ OsLayout(int S, int S2, int T, int R, int x_floats,
                               int sc_floats) {
    fa = 0;
    xf = fa + 2 * 8 * 8 * 128;
    wd = xf + 2 * 2 * FMAX * OBP;
    soff = wd + 2 * 2 * FMAX * OLN;
    ring = soff + align4(S);
    x_sz = align4(x_floats);
    idx_sz = align4(T * R);
    tab_sz = T * OLN;
    slot = x_sz + idx_sz + 3 * tab_sz;
    ys = 0;
    va = ys + 2 * FMAX * YP;
    const int epi = va + 2 * ((S2 + 15) / 16) * KS2 * 128;
    for (stages = OS_STAGES;; --stages) {
      sc = imax(ring + stages * slot, epi);
      total = sc + sc_floats;
      if (stages <= 2 || 4 * total <= SMEM_MAX) break;
    }
  }
};

// Windowed input in blocks of TP tiles: the host's windows xt [S][M][P]
// (rows of P floats at x_pitch), output tiles y [S2][N][P].
template <int TP, int TN>
struct WinPath {
  const float* xt;
  int P, x_pitch;
  struct Blk {
    int p0;
    bool vec;   // 16-byte copies: every row start 16-byte aligned
  };
  __host__ __device__ int blocks() const { return (P + TP - 1) / TP; }
  __host__ __device__ int x_floats(int S) const { return S * TP; }
  __host__ __device__ int win_floats(int) const { return 0; }
  __device__ Blk block(int bx, int) const {
    return {bx * TP, x_pitch % 4 == 0 && (size_t)xt % 16 == 0};
  }
  __device__ void prepare(float*, int, int) const {}
  // channel m's window rows [S][TP], zero-filled past P
  __device__ void load(const Blk& k, float* sx, int S, int M, int m,
                       int tid) const {
    constexpr int C4 = TP / 4;              // 16-byte chunks of a row
    for (int i = tid; i < S * C4; i += TN) {
      const int s = i / C4, c = 4 * (i - s * C4);
      const float* row = xt + ((size_t)s * M + m) * x_pitch + k.p0 + c;
      if (k.vec) {
        const int bytes = clamp_bytes(P - k.p0 - c);
        cp_async16(sx + s * TP + c, bytes ? row : xt, bytes);
      } else {
        for (int p = 0; p < 4; ++p)
          cp_async4(sx + s * TP + c + p, k.p0 + c + p < P ? row + p : xt,
                    k.p0 + c + p < P);
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
  // the output-stationary kernel's tile-FFT reads window element s of
  // tile slot p from the staged rows (zero past S)
  struct FftCol {
    int p;
  };
  __device__ void fft_offsets(int*, int) const {}
  __device__ FftCol fft_col(const Blk&, int col, int) const { return {col}; }
  __device__ float fft_x(const float* sx, const int*, FftCol c, int s,
                         int S) const {
    return s < S ? sx[s * TP + c.p] : 0.f;
  }
};
using WindowedPath = WinPath<BP, NT>;     // the flows
using WindowedOs = WinPath<OBP, ONT>;     // the output-stationary kernel

using HaloIn = HaloPath<NT, 1, BP>;   // halo.cuh: the flows'
using HaloOs = HaloPath<ONT, 1, OBP>;  // and the output-stationary kernel's

// copy `count` contiguous 4-byte words, 16 bytes at a time when aligned
// (TN threads)
template <int TN = NT>
__device__ __forceinline__ void stage_words(float* dst, const float* src,
                                            int count, int tid) {
  int done = 0;
  if (((size_t)src & 15) == 0) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * TN)
      cp_async16(dst + i, src + i, 16);
  }
  for (int i = done + tid; i < count; i += TN)
    cp_async4(dst + i, src + i, true);
}

// rows [T] of lanes l0 .. l0 + OLN of a table block [T][NP] at src into
// dst [T][OLN], zero past NP; 16 bytes at a time where every row start is
// 16-byte aligned (vec); the output-stationary kernel's ONT threads
__device__ __forceinline__ void stage_lanes(float* dst, const float* src,
                                            int T, int NP, int l0, bool vec,
                                            int tid) {
  if (vec) {
    for (int i = tid; i < T * (OLN / 4); i += ONT) {
      const int t = i / (OLN / 4), c = 4 * (i - t * (OLN / 4));
      const int bytes = clamp_bytes(NP - l0 - c);
      cp_async16(dst + t * OLN + c,
                 bytes ? src + (size_t)t * NP + l0 + c : src, bytes);
    }
  } else {
    for (int i = tid; i < T * OLN; i += ONT) {
      const int t = i / OLN, n = i - t * OLN;
      const bool ok = l0 + n < NP;
      cp_async4(dst + i, ok ? src + (size_t)t * NP + l0 + n : src, ok);
    }
  }
}

// Output-stationary (B4 on the windowed path, B5 on the halo path).  Grid
// (tile block of OBP tiles, kernel group x lane half, cluster rank); a
// cluster of C CTAs splits the input channels, rank r taking [r M / C,
// (r + 1) M / C).  Per channel (one ring step), three jobs between two
// barriers:
//  * warps 0-7: the tile-FFT of all FMAX bins on the tensor cores
//    (3xTF32; warp w's bins 8 w .. as the A fragment, split once per CTA
//    into shared memory; the 8 tile slots as the columns) into X~;
//  * warps 8-15: the channel's Alg-2 tables expanded into W[bin][lane]
//    (re, im): each table entry decoded once, bin = idx[t][sel[t][n]],
//    the exact cover giving every (bin, lane) at most one entry;
//  * all 16 warps: the previous channel's MACs, psum[f][n][p] += W[f][n]
//    X~[f][p], thread (warp w, lane n) keeping bins 4 w .. 4 w + 3 of lane
//    n for all OBP tiles in registers (no shared read-modify-write), its
//    X~ row a broadcast, and zeroing the W cells it read.
// X~ and W are double-buffered, so one barrier a channel separates the
// jobs.  After the channels, Y~ goes to shared memory, the valid-row IFFT
// runs on the tensor cores (A = [Dvr | -Dvi] split once, B = Y~; 3xTF32),
// and the cluster sums its ranks' partials in rank order: rank r finishes
// rows r, r + C, ... with bias (+ shortcut) + ReLU, one write per output
// element.  The output repeats bit for bit.
template <class Path, int SC>
__global__ void __launch_bounds__(ONT, 1)
fused_sched_os_kernel(const Path io, const int* __restrict__ idx,
                      const int* __restrict__ sel,
                      const float* __restrict__ vr,
                      const float* __restrict__ vi,
                      const float* __restrict__ dfr,
                      const float* __restrict__ dfi,
                      const float* __restrict__ dvr,
                      const float* __restrict__ dvi,
                      const float* __restrict__ bias,
                      const float* __restrict__ sc, float* __restrict__ y,
                      int S, int M, int Mp, int T, int R, int NP, int Fa,
                      int N, int S2, int relu, int halves) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const OsLayout L(S, S2, T, R, io.x_floats(S),
                   SC == SC_STAGED ? (S2 + n_ranks - 1) / n_ranks * OLN * OBP
                                   : 0);
  uint32_t* s_fa = reinterpret_cast<uint32_t*>(smem + L.fa);
  float* s_x = smem + L.xf;                 // X~ [2][re, im][FMAX][OBP]
  float2* s_w = reinterpret_cast<float2*>(smem + L.wd);   // [2][FMAX][OLN]
  int* s_soff = reinterpret_cast<int*>(smem + L.soff);
  float* ring = smem + L.ring;
  float* s_sc = smem + L.sc;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // MMA fragment coordinates
  const typename Path::Blk blk = io.block(blockIdx.x, tid);
  const int g = blockIdx.y / halves;        // kernel group
  const int l0 = (blockIdx.y - g * halves) * OLN;   // its lanes l0 ..
  const int m_lo = rank * M / n_ranks, m_hi = (rank + 1) * M / n_ranks;
  const int n_steps = m_hi - m_lo;
  const int mt2 = (S2 + 15) / 16;

  // the tile-FFT's A, split once in fragment order: row tile w, row r < 8
  // Re Df[8 w + r], r >= 8 Im Df[8 w + r - 8], column k = window row
  // kk * 8 + (lane's column); zero past Fa and S; and W zeroed
  for (int i = tid; i < 8 * 8 * 128; i += ONT) {
    const int w = i / 1024, kk = (i / 128) % 8, ln = (i / 4) % 32, e = i % 4;
    const int r = ln / 4 + (e & 1) * 8;
    const int sw = kk * 8 + ln % 4 + (e & 2) * 2;
    const int f = 8 * w + r % 8;
    float x = 0.f;
    if (f < Fa && sw < S) x = (r < 8 ? dfr : dfi)[(size_t)f * S + sw];
    split(x, s_fa[i], s_fa[8 * 8 * 128 + i]);
  }
  for (int i = tid; i < 2 * FMAX * OLN; i += ONT)
    s_w[i] = make_float2(0.f, 0.f);
  io.fft_offsets(s_soff, tid);

  // flush map: row half fr, lane fn, tile slot fp; staged shortcut: the
  // elements this thread adds at the flush (rows rank + C (2 q + fr)),
  // zero where nothing is stored; they join the first channel's copies
  const int fr = tid / (OLN * OBP), fe = tid % (OLN * OBP);
  const int fn = fe / OBP, fp = fe % OBP;
  const int gn = g * NP + l0 + fn;
  const bool n_ok = l0 + fn < NP && gn < N;
  if constexpr (SC == SC_STAGED) {
    for (int s = rank + fr * n_ranks, q = fr; s < S2;
         s += 2 * n_ranks, q += 2) {
      const long long o = n_ok ? io.out_at(blk, s, gn, N, fp) : -1;
      cp_async4(s_sc + q * OLN * OBP + fe, o >= 0 ? sc + o : sc, o >= 0);
    }
  }

  // one ring step: channel m's input (window rows [S][OBP] or raw rows)
  // and its table rows (idx, then the CTA's lanes of sel, vr, vi)
  const bool vec_t = NP % 4 == 0 && (size_t)sel % 16 == 0 &&
                     (size_t)vr % 16 == 0 && (size_t)vi % 16 == 0;
  const size_t tab_row = (size_t)T * NP;
  auto load_step = [&](int slot, int m) {
    float* st = ring + slot * L.slot;
    io.load(blk, st, S, M, m, tid);
    const size_t gm = (size_t)g * Mp + m;
    float* dt = st + L.x_sz;
    stage_words<ONT>(dt, reinterpret_cast<const float*>(idx) + gm * T * R,
                     T * R, tid);
    dt += L.idx_sz;
    stage_lanes(dt, reinterpret_cast<const float*>(sel) + gm * tab_row, T,
                NP, l0, vec_t, tid);
    stage_lanes(dt + L.tab_sz, vr + gm * tab_row, T, NP, l0, vec_t, tid);
    stage_lanes(dt + 2 * L.tab_sz, vi + gm * tab_row, T, NP, l0, vec_t, tid);
  };

  // the psum of bins 4 warp .. 4 warp + 3, lane `lane`, all tiles
  float pr[OBINS][OBP], pi[OBINS][OBP];
#pragma unroll
  for (int b = 0; b < OBINS; ++b)
#pragma unroll
    for (int p = 0; p < OBP; ++p) pr[b][p] = pi[b][p] = 0.f;

  // the MACs of channel step i: X~ and W buffer i & 1; the W cells read
  // are zeroed for the step two ahead
  auto macs = [&](int i) {
    const float* xr = s_x + (i & 1) * 2 * FMAX * OBP;
    const float* xi = xr + FMAX * OBP;
    float2* w = s_w + (i & 1) * FMAX * OLN;
#pragma unroll
    for (int b = 0; b < OBINS; ++b) {
      const int f = OBINS * warp + b;
      const float2 wv = w[f * OLN + lane];
      w[f * OLN + lane] = make_float2(0.f, 0.f);
      const float4 r0 = *reinterpret_cast<const float4*>(xr + f * OBP);
      const float4 r1 = *reinterpret_cast<const float4*>(xr + f * OBP + 4);
      const float4 j0 = *reinterpret_cast<const float4*>(xi + f * OBP);
      const float4 j1 = *reinterpret_cast<const float4*>(xi + f * OBP + 4);
      const float xa[OBP] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float xb[OBP] = {j0.x, j0.y, j0.z, j0.w, j1.x, j1.y, j1.z, j1.w};
#pragma unroll
      for (int p = 0; p < OBP; ++p) {
        pr[b][p] = fmaf(wv.x, xa[p], fmaf(-wv.y, xb[p], pr[b][p]));
        pi[b][p] = fmaf(wv.x, xb[p], fmaf(wv.y, xa[p], pi[b][p]));
      }
    }
  };

  // The channel loop: step i's tile-FFT (warps 0-7) and table expansion
  // (warps 8-15) beside step i - 1's MACs (all warps); the copies run
  // L.stages - 1 steps ahead.
  const typename Path::FftCol fcol = io.fft_col(blk, gq, tq);
  for (int st = 0; st < L.stages - 1; ++st) {
    if (st < n_steps) load_step(st, m_lo + st);
    cp_async_commit();
  }
  __syncthreads();      // the A fragments, W and the offsets are ready
  for (int i = 0; i <= n_steps; ++i) {
    if (i < n_steps) {
      if (L.stages >= 5)
        cp_async_wait<3>();
      else if (L.stages == 4)
        cp_async_wait<2>();
      else if (L.stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    __syncthreads();    // step i landed; step i - 1's X~ and W are ready
    if (i + L.stages - 1 < n_steps)
      load_step((i + L.stages - 1) % L.stages, m_lo + i + L.stages - 1);
    cp_async_commit();
    if (i < n_steps) {
      const float* st = ring + (i % L.stages) * L.slot;
      if (warp < 8) {
        // Stage 1: X~ of bins 8 warp .. on the 8 tile slots (all 8 k
        // steps: A is zero past S and fft_x reads nothing there)
        const uint4* ah4 = reinterpret_cast<const uint4*>(s_fa) + warp * 256;
        const uint4* al4 = ah4 + 8 * 8 * 32;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint4 h = ah4[kk * 32 + lane], l = al4[kk * 32 + lane];
          const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
          const uint32_t al[4] = {l.x, l.y, l.z, l.w};
          const float b[2] = {io.fft_x(st, s_soff, fcol, kk * 8 + tq, S),
                              io.fft_x(st, s_soff, fcol, kk * 8 + tq + 4, S)};
          uint32_t bh[2], bl[2];
          split_frag(b, bh, bl);
          mma3_f32(c, ah, al, bh, bl);
        }
        float* xr = s_x + (i & 1) * 2 * FMAX * OBP;
        const int o = (8 * warp + gq) * OBP + 2 * tq;
        *reinterpret_cast<float2*>(xr + o) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(xr + FMAX * OBP + o) =
            make_float2(c[2], c[3]);
      } else {
        // Stage 2: the channel's tables into W buffer i & 1
        const int* s_idx = reinterpret_cast<const int*>(st + L.x_sz);
        const int* s_sel = s_idx + L.idx_sz;
        const float* s_vr = reinterpret_cast<const float*>(s_sel) + L.tab_sz;
        const float* s_vi = s_vr + L.tab_sz;
        float2* w = s_w + (i & 1) * FMAX * OLN;
        for (int e = tid - ONT / 2; e < T * OLN; e += ONT / 2) {
          const float w_r = s_vr[e], w_i = s_vi[e];
          const int rr = s_sel[e];
          if ((w_r == 0.f && w_i == 0.f) || (unsigned)rr >= (unsigned)R)
            continue;
          const int f = s_idx[(e / OLN) * R + rr];
          if ((unsigned)f < (unsigned)Fa)
            w[f * OLN + e % OLN] = make_float2(w_r, w_i);
        }
      }
    }
    if (i > 0) macs(i - 1);   // Stage 3
  }

  // Stage 4: Y~ [2 FMAX][YP] (re rows, then im) from the registers, the
  // IFFT's A split into fragment order, then partial[s2][(n, p)] = sum_k
  // A[s2][k] Y~[k][(n, p)] on the tensor cores, warp w n-tiles w, w + 16
  __syncthreads();      // the loop's shared memory is free
  float* s_y = smem + L.ys;
#pragma unroll
  for (int b = 0; b < OBINS; ++b) {
    const int f = OBINS * warp + b;
    float* yr = s_y + f * YP + lane * OBP;
    float* yi = yr + FMAX * YP;
    *reinterpret_cast<float4*>(yr) =
        make_float4(pr[b][0], pr[b][1], pr[b][2], pr[b][3]);
    *reinterpret_cast<float4*>(yr + 4) =
        make_float4(pr[b][4], pr[b][5], pr[b][6], pr[b][7]);
    *reinterpret_cast<float4*>(yi) =
        make_float4(pi[b][0], pi[b][1], pi[b][2], pi[b][3]);
    *reinterpret_cast<float4*>(yi + 4) =
        make_float4(pi[b][4], pi[b][5], pi[b][6], pi[b][7]);
  }
  uint32_t* s_va = reinterpret_cast<uint32_t*>(smem + L.va);
  for (int i = tid; i < mt2 * KS2 * 128; i += ONT) {
    const int kk = (i / 128) % KS2, m2 = i / (128 * KS2);
    const int ln = (i / 4) % 32, e = i % 4;
    const int s2 = m2 * 16 + ln / 4 + (e & 1) * 8;
    const int k = kk * 8 + ln % 4 + (e & 2) * 2;
    const int f = k % FMAX;
    float x = 0.f;
    if (s2 < S2 && f < Fa)
      x = k < FMAX ? dvr[(size_t)s2 * Fa + f] : -dvi[(size_t)s2 * Fa + f];
    split(x, s_va[i], s_va[mt2 * KS2 * 128 + i]);
  }
  __syncthreads();
  float acc[MT2_MAX][2][4];
#pragma unroll
  for (int a = 0; a < MT2_MAX; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
  const uint4* vh4 = reinterpret_cast<const uint4*>(s_va);
  const uint4* vl4 = reinterpret_cast<const uint4*>(s_va + mt2 * KS2 * 128);
#pragma unroll 2
  for (int kk = 0; kk < KS2; ++kk) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* col = s_y + (kk * 8 + tq) * YP + (warp + 16 * j) * 8 + gq;
      const float b[2] = {col[0], col[4 * YP]};
      split_frag(b, bh[j], bl[j]);
    }
#pragma unroll
    for (int m2 = 0; m2 < MT2_MAX; ++m2) {
      if (m2 >= mt2) break;
      const uint4 h = vh4[(m2 * KS2 + kk) * 32 + lane];
      const uint4 l = vl4[(m2 * KS2 + kk) * 32 + lane];
      const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
      const uint32_t al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int j = 0; j < 2; ++j) mma3_f32(acc[m2][j], ah, al, bh[j], bl[j]);
    }
  }
  __syncthreads();      // Y~ is read: the partial [S2][YP] replaces it
  float* s_part = s_y;
#pragma unroll
  for (int m2 = 0; m2 < MT2_MAX; ++m2) {
    if (m2 >= mt2) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int s2 = m2 * 16 + gq + 8 * h2;
        if (s2 < S2)
          *reinterpret_cast<float2*>(s_part + s2 * YP +
                                     (warp + 16 * j) * 8 + 2 * tq) =
              make_float2(acc[m2][j][2 * h2], acc[m2][j][2 * h2 + 1]);
      }
  }
  cluster.sync();       // every rank's partial is ready

  // Stage 5: sum the ranks' partials in rank order, bias (+ shortcut) +
  // ReLU, one write per output element; rank r finishes rows r, r + C, ...
  // (thread half fr every other one)
  const float* part[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    part[q] = cluster.map_shared_rank(s_part, q < n_ranks ? q : 0);
  if constexpr (SC == SC_STAGED) cp_async_wait_all();   // long since landed
  for (int s = rank + fr * n_ranks, q = fr; s < S2;
       s += 2 * n_ranks, q += 2) {
    const int at = s * YP + fe;
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < n_ranks) v += part[c][at];
    const long long o = n_ok ? io.out_at(blk, s, gn, N, fp) : -1;
    if (o >= 0) {
      v += bias[gn];
      if constexpr (SC == SC_GLOBAL) v += sc[o];
      if constexpr (SC == SC_STAGED) v += s_sc[q * OLN * OBP + fe];
      if (relu) v = fmaxf(v, 0.f);
      y[o] = v;
    }
  }
  cluster.sync();       // keep partials alive for readers
}

// The weight- and input-stationary flows (FLOW) on either input path
// (Path), on the CUDA cores.  Grid: ws (m range, group); is (tile block, m
// range).  ws (the split-K workspace) is written only when the flow has
// more than one m range.  SC: none or a global shortcut.
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
  static_assert(FLOW != OS && SC != SC_STAGED, "output-stationary: above");
  extern __shared__ __align__(16) float smem[];
  const Layout L(FLOW, S, S2, T, R, NP, io.x_floats(S), 0, RM);
  float2* s_df = reinterpret_cast<float2*>(smem + L.df);
  float4* s_pr = reinterpret_cast<float4*>(smem + L.psum);
  float4* s_pi = s_pr + FMAX * BN;
  float4* s_x = reinterpret_cast<float4*>(smem + L.xf);
  float* s_part = smem + L.part;
  float4* s_dv = reinterpret_cast<float4*>(smem + L.dv);   // bin pairs

  const int tid = threadIdx.x;
  const int slots = io.blocks() * BP;        // workspace tile columns
  const int GN = (N + NP - 1) / NP;
  // this CTA's channels: m range r of G
  const int G = FLOW == WS ? gridDim.x : gridDim.y;
  const int r = FLOW == WS ? blockIdx.x : blockIdx.y;
  const int m_lo = r * RM, m_hi = m_lo + RM < M ? m_lo + RM : M;

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

  if constexpr (FLOW == WS) {
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

// The most clusters of `cluster` output-stationary CTAs (one an SM) the
// card runs at once (cudaOccupancyMaxActiveClusters; clusters stay within
// a GPC).
int os_max_clusters(int cluster, int* count) {
  const void* kernel = (const void*)fused_sched_os_kernel<WindowedOs, SC_NONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, cluster);
  cfg.blockDim = dim3(ONT);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// The output-stationary kernel's cluster over the input channels for
// `blocks` (tile block, kernel group, lane half) clusters on a card that
// runs cap[c] clusters of c CTAs at once: among C <= min(MAX_CLUSTER, M),
// the least waves x (ceil(M / C) + FIXED_STEPS), ties to the smaller C
// (fsc.sched_cluster mirrors it).
int os_cluster(int blocks, int M, const int* cap) {
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= MAX_CLUSTER && c <= M; ++c) {
    const long long waves = (blocks + cap[c] - 1) / cap[c];
    const long long cost = waves * ((M + c - 1) / c + FIXED_STEPS);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = c;
    }
  }
  return best;
}

// cap[c] of the current device, queried once per device.
int os_capacity(const int** cap) {
  static int table[64][MAX_CLUSTER + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (table[dev][1] == 0) {
    for (int c = 1; c <= MAX_CLUSTER; ++c) {
      int count = 0;
      const int e = os_max_clusters(c, &count);
      if (e != 0) return e;
      if (count < 1) return (int)cudaErrorInvalidValue;
      table[dev][c] = count;
    }
  }
  *cap = table[dev];
  return 0;
}

// Configure and launch one layer on `stream` (and, for a flow with more
// than one m range, the split-K finish pass); returns the cudaError_t of the
// configuration and the launches (0 on success).  Output-stationary: grid
// (tile blocks, GN x lane halves, C), a cluster of C CTAs over the input
// channels (os_cluster).  Sizes whose shared memory exceeds the per-block
// limit fail cudaFuncSetAttribute.
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
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (FLOW == OS) {
    if (S > 64 || S2 > 16 * MT2_MAX) return (int)cudaErrorInvalidValue;
    const int* cap = nullptr;
    const int e = os_capacity(&cap);
    if (e != 0) return e;
    const int halves = (NP + OLN - 1) / OLN;
    const int C = os_cluster(io.blocks() * GN * halves, M, cap);
    // a staged shortcut: ceil(S2 / C) rows of the CTA's lanes x tiles
    const int sc_floats = SC == SC_STAGED ? (S2 + C - 1) / C * OLN * OBP : 0;
    const OsLayout L(S, S2, T, R, io.x_floats(S), sc_floats);
    cfg.dynamicSmemBytes = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_sched_os_kernel<Path, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = dim3(io.blocks(), GN * halves, C);
    cfg.blockDim = dim3(ONT);
    attr[0].val.clusterDim.z = C;
    err = cudaLaunchKernelEx(&cfg, fused_sched_os_kernel<Path, SC>, io, idx,
                             sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, S,
                             M, Mp, T, R, NP, Fa, N, S2, relu, halves);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  } else {
    const int G = (M + RM - 1) / RM;
    if (G > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
    const Layout L(FLOW, S, S2, T, R, NP, io.x_floats(S), io.win_floats(S),
                   RM);
    cfg.dynamicSmemBytes = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_sched_kernel<Path, FLOW, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = FLOW == WS ? dim3(G, GN, 1) : dim3(io.blocks(), G, 1);
    err = cudaLaunchKernelEx(&cfg, fused_sched_kernel<Path, FLOW, SC>, io,
                             idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc,
                             y, ws, S, M, Mp, T, R, NP, Fa, N, S2, relu, RM);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (G > 1)
      err = launch_finish<Path, BP, SC>(io, ws, bias, sc, y, G, S2, N,
                                        io.blocks() * BP, relu,
                                        (cudaStream_t)stream);
    return (int)err;
  }
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
  using Path = typename std::conditional<FLOW == OS, WindowedOs,
                                         WindowedPath>::type;
  return dispatch<Path, FLOW>(Path{xt, P, x_pitch}, idx, sel, vr, vi, dfr,
                              dfi, dvr, dvi, bias, sc, y, ws, S, M, GN, Mp, T,
                              R, NP, Fa, N, S2, relu, RM, sc_staged, stream);
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
  typename std::conditional<FLOW == OS, HaloOs, HaloIn>::type io{x, {}};
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > (FLOW == OS ? OBP : BP) || S2 != io.g.t * io.g.t || NP < 1)
    return (int)cudaErrorInvalidValue;
  const int GN = (N + NP - 1) / NP;
  return dispatch<decltype(io), FLOW>(io, idx, sel, vr, vi, dfr, dfi, dvr,
                                      dvi, bias, sc, y, ws, K * K, M, GN, Mp,
                                      T, R, NP, Fa, N, S2, relu, RM,
                                      sc_staged, stream);
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

// The most clusters of `cluster` output-stationary CTAs the card runs at
// once, into *count (the wrapper mirrors the launch's cluster rule by it).
int fused_spectral_pipeline_scheduled_os_max_clusters(int cluster,
                                                      int* count) {
  return os_max_clusters(cluster, count);
}

}  // extern "C"
