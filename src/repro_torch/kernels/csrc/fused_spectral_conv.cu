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
// batch 1): the layer stack does 29.3 GFLOP (tile-FFT 4.5, Hadamard 21.1
// counted as Karatsuba's three products, valid-row IFFT 3.7) and must move
// 0.97 GB (kernel planes 0.84 GB), so it is fp32-compute bound overall
// (0.44 ms at 67 TFLOP/s vs 0.29 ms at 3.35 TB/s).  conv5_x at batch 1 is
// byte bound: each layer streams 134 MB of planes for 9 tiles of work.
//
// Design of the output-stationary kernel (B1 windowed, B3 halo): the three
// products on the tensor cores in 3xTF32 (`mma.sync.m16n8k8`, each f32
// operand split into TF32 hi + lo, lo*hi + hi*lo + hi*hi; mma_tf32.cuh),
// f32-level error where f32 FMAs on the CUDA cores peak at 67 TFLOP/s.
//  * As on the TPU, the spectra X~ and Y~ never reach device memory and
//    every output element is written once, after bias and ReLU.
//  * Unlike the TPU grid, which carries the [Fa, bn, bp] complex psum in
//    VMEM across an "arbitrary" m axis, a CTA owns an (n-block, p-block)
//    and loops over the input channels itself.  The full psum (512 B per
//    output at Fa = 64) does not fit a CTA at useful block sizes, so the
//    bins are split across the CTAs of a thread-block cluster: CTA z of a
//    cluster of ceil(Fa/FSC_FC) takes bins [z*FSC_FC, (z+1)*FSC_FC), keeps
//    its chunk's Y~ in MMA accumulator fragments over the whole m loop and
//    folds Re(Dv[:, chunk] . Y~_chunk) into a [S2, BN, BP] spatial partial
//    in its shared memory (the IFFT is linear in the bins).  The cluster
//    sums the partials through distributed shared memory in a fixed rank
//    order (deterministic, no atomics), each CTA finishing S2/cluster of
//    the output rows with bias + ReLU.  Where tile blocks x n blocks x bin
//    chunks is under one CTA an SM (conv5_x at batch 1: 64 CTAs for 132
//    SMs), the wrapper also splits M into ranges over CTAs; each range's
//    partial goes to slice g of a split-K workspace and the finish pass of
//    split_k.cuh sums the slices in ascending g before bias + ReLU.
//  * Per 8-channel step, 8 warps: (1) tile-FFT, X~[16 x MP] = [Re Df;
//    Im Df][16 x S] . windows[S x MP] with MP = BM x BP (channel, tile)
//    columns, a warp per channel (16 columns); Df's fragments are split
//    once per CTA and stored in fragment order (two 16-byte loads a k
//    step), the k order within a step permuted (fft_row) so that the
//    swizzled window stage reads conflict-free; (2) the Hadamard per bin,
//    [BN x BM] . [BM x BP] complex, from four real products (re = Wr Xr -
//    Wi Xi, im = Wr Xi + Wi Xr; not Karatsuba, whose cancellation costs
//    ~5e-6 of max|Y| at M = 512), a warp per bin holding 4 x 2
//    accumulator tiles of re and im.  Every k step's hi*hi products and
//    correction terms go to fresh accumulators added in f32 (`mma3_f32`:
//    the tensor cores' own accumulation truncates, a one-sided error that
//    compounds over a network).  (3) After the m loop, the valid-row IFFT
//    [S2 x 16] . [16 x BN BP] runs on the tensor cores too, 8 output
//    channels at a time through a Y~ stage in X~'s place.
//  * A ring of three stages (two where three do not fit beside a staged
//    shortcut), one mbarrier a slot, two barriers a step (stage landed;
//    X~ written).  Thread 0 loads each step's windows (box [BM][S][BP],
//    64-byte swizzle) and planes (boxes [FC][BN][BM], 32-byte swizzle)
//    by TMA: issuing per-thread copies took more of a step than the
//    products.  Where rows are not 16-byte aligned (planes with M % 4 !=
//    0, windows at a pitch that is not a multiple of 4 floats), and for
//    the halo path's raw rows, cp.async copies write the same layouts.
//    The swizzles make every MMA fragment read conflict-free; X~ rows are
//    padded.
//  * Ragged N / M / P edges are zero-filled by the copies (cp.async with a
//    short or zero source size; TMA's out-of-bounds fill), never padded in
//    the operands.  So is a
//    ragged last bin chunk (Fa not a multiple of FSC_FC, which the TPU
//    kernel accepts too; the plan pads its active bins to whole chunks):
//    its missing DFT rows, DFT columns and kernel planes read as zeros.
//
// The halo sibling (`fused_spectral_pipeline_halo_f32`, replacing the TPU
// kernel `fused_spectral_pipeline_halo`) is the same kernel on another input
// path: a CTA's 16 tile slots hold one halo block (bth x btw tiles of one
// image), each channel step stages the block's raw rows (halo.cuh), the
// tile-FFT reads its window elements from them by offset, and the flush
// stores finished tiles straight into y[B, N, H_out, W_out].  The FFT,
// Hadamard, IFFT, cluster split and rank-order reduction are the windowed
// kernel's code (the kernel is templated on the input path); so are the
// weight- and input-stationary kernels'.  Its bound is B1's operations on
// the real tiles and the raw activation read once; idle slots (blocks past
// the tile grid, 3x3-tile blocks in 16 slots) cost time, not bytes.
//
// The weight- and input-stationary flows (entry points *_ws_f32 and
// *_is_f32, windowed and halo; replacing the TPU bodies `_kernel_ws` (:571)
// and `_kernel_is` (:591) of src/repro/kernels/fused_spectral_conv.py with
// their psum read-modify-write `_dma_rmw_start` (:487) / `_dma_rmw_finish`
// (:497)) compute the same function with another reuse, from B1's
// tensor-core pieces (shared device functions: the tile-FFT, the
// Hadamard, the Y~ gather and its IFFT).  A flow CTA owns one m range of
// RM input channels (RM a multiple of FSC_BM; G = ceil(M / RM) ranges)
// and one bin chunk of a cluster, as above:
//  * weight-stationary (reuse kernels; `fused_ws_kernel`): CTA = (chunk of
//    tile blocks, n block of 32, m range, bin chunk).  Its plane block
//    [FC][32][RM] lands in shared memory once (TMA boxes) and stays while
//    it walks its chunk of tile blocks, their windows streamed through a
//    TMA ring; each plane element is read from device memory once per
//    chunk of tile blocks (fsc.ws_launch_geometry sizes the chunks by the
//    card's cluster capacity), the windows once per n block.
//  * input-stationary (reuse activations; `fused_is_kernel`): CTA = (tile
//    block, m range, chunk).  It computes X~ of its windows for the whole
//    m range once into shared memory ([FC][RM][BP], the windows by TMA
//    through a three-stage mbarrier ring) and walks every n block,
//    streaming its planes by TMA boxes through the same ring; each
//    tile-FFT is computed once per tile block.
// After each output rectangle the cluster gathers each n-tile's Y~ over
// its bin chunks at one rank through distributed shared memory, which
// takes that n-tile's IFFT over every bin, summing the chunks in rank
// order.  With one m range (G = 1) that is the finished output (bias,
// ReLU).
// Otherwise it is the range's partial, written to slice g of a split-K
// workspace [G, S2, N, slots] that the wrapper allocates, and a second
// launch (split_k.cuh) sums the slices in ascending g and applies bias and
// ReLU: no atomics, the same bits on every launch.  Bound: B1's operations
// plus the IFFT per m range, and bytes with the workspace written and read
// once; the flows trade it against re-reading planes (os, is) or windows
// (os, ws).  A CTA keeps one of the three arrays resident beside its ring,
// so RM is capped by shared memory at K = 8: 32 for ws beside a three-slot
// window ring, 48 beside two; 64 for is.
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
#include <type_traits>

#include "cp_async.cuh"
#include "halo.cuh"
#include "mma_tf32.cuh"
#include "shortcut.cuh"
#include "sm90.cuh"
#include "split_k.cuh"

#if !defined(FSC_BN) || !defined(FSC_BP) || !defined(FSC_BM) || \
    !defined(FSC_FC) || !defined(FSC_OS_STAGES) || !defined(FSC_OS_THREADS)
#error "build through repro_torch.kernels._build (defines FSC_* block sizes)"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int BN = FSC_BN;        // output channels per CTA
constexpr int BP = FSC_BP;        // tiles per CTA
constexpr int BM = FSC_BM;        // input channels per pipeline step
constexpr int FC = FSC_FC;        // frequency bins per CTA (cluster rank)
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int MP = BM * BP;       // (m, p) pairs per step
constexpr int W_PLANE = FC * BN * BM;      // floats of one re or im plane
static_assert(BP % 4 == 0 && BM % 4 == 0, "16-byte copies and plane loads");

// The output-stationary kernel's MMA tiling: ONT threads, a warp per
// channel (16 (channel, tile) columns) of the tile-FFT and per bin in the
// Hadamard (all BN rows); the IFFT's 16 k rows are the chunk's (re, im)
// bins.  Its flush map: OTN outputs a thread, ONSTRIDE apart in n.
constexpr int ONT = FSC_OS_THREADS;
constexpr int WARPS = ONT / 32;
constexpr int OTN = BN * BP / ONT;
constexpr int ONSTRIDE = ONT / BP;
constexpr int OS_STAGES = FSC_OS_STAGES;  // the deepest ring tried (3)
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a CTA
constexpr int XP = BP + 8;                // X~ pitch of a channel row
constexpr int XFP = BM * XP + 8;          // X~ pitch of a bin
constexpr int YQ = 8 * BP + 8;            // Y~ row pitch (8 channels)
constexpr int MT2_MAX = 4;                // IFFT row tiles: S2 <= 64

// The window row (within a k step of 8) that the tile-FFT's k index k
// reads: k = tq and tq + 4 of a lane's B fragment take rows whose bits
// (0, 2) are tq's bits (0, 1) and bit 1 is (k >= 4), so that the four
// rows of a fragment register fall into the four bank groups of the
// 64-byte-swizzled window stage.
__host__ __device__ constexpr int fft_row(int k) {
  return (k & 1) + 2 * (k >> 2) + 4 * ((k >> 1) & 1);
}
static_assert(FC == 8 && BM == 8 && BN == 64 && BP == 16 && WARPS == FC &&
                  WARPS == BM && 16 * YQ <= 2 * FC * XFP,
              "output-stationary MMA tiling (16 rows = 8 bins x re, im; a "
              "warp per channel in the FFT and per bin in the Hadamard)");

// the reuse flows
constexpr int OS = 0;   // output-stationary: psum in MMA accumulators, m range
constexpr int WS = 1;   // weight-stationary: planes of an m range resident
constexpr int IS = 2;   // input-stationary: X~ of an m range resident

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory carve-up of the output-stationary kernel, in floats, from
// a base aligned to 1024 bytes (OS_ALIGN floats of slack): the FFT's A
// fragments (hi, lo) in fragment order, the IFFT's, X~ (re, im; after the
// m loop the Y~ stage), the halo path's S window offsets, one mbarrier a
// ring slot, then (1024-byte aligned, as the TMA swizzles want) the ring
// of `stages` slots: the step's windows or raw rows, then its planes, re
// and im.  After the m loop the spatial partial aliases the ring.  A
// staged shortcut (sc_floats) follows everything.  Three stages where
// they fit the card's limit, else two.
constexpr int OS_ALIGN = 256;
__host__ __device__ constexpr int align_to(int n, int a) {
  return (n + a - 1) / a * a;
}
struct OsLayout {
  int da, va, xf, soff, bar, ring, x_sz, slot, stages, part, sc, total;
  __host__ __device__ OsLayout(int S, int S2, int x_floats, int sc_floats) {
    const int ks = (S + 7) / 8, mt2 = (S2 + 15) / 16;
    da = 0;                                  // [2][ks][32 lanes][4]
    va = da + 2 * ks * 128;                  // [2][mt2][2][32][4]
    xf = va + 2 * mt2 * 256;                 // [2][FC][XFP]
    soff = xf + 2 * FC * XFP;                // [S] ints
    bar = soff + align4(S);                  // [OS_STAGES] mbarriers
    ring = align_to(bar + align4(2 * OS_STAGES), OS_ALIGN);
    x_sz = align_to(x_floats, 128);          // 512-byte aligned planes
    slot = x_sz + 2 * W_PLANE;
    part = ring;                             // [S2][BN][BP]
    const int epi = S2 * BN * BP;
    for (stages = OS_STAGES;; --stages) {
      sc = ring + imax(stages * slot, epi);
      total = sc + sc_floats + OS_ALIGN;
      if (stages <= 2 || 4 * total <= SMEM_MAX) break;
    }
  }
};

// The TMA tensor maps of an output-stationary or input-stationary launch:
// the windows (windowed path) and both kernel planes.
struct OsMaps {
  CUtensorMap x, wr, wi;
};

// Shared-memory carve-up of the input-stationary kernel, in floats, from a
// base aligned to 1024 bytes: the FFT's A fragments (as in OsLayout), whose
// place the gather buffer takes once X~ is built (every chunk's Y~ of the
// n-tiles this cluster rank finishes: [C sources][16 rows, re then im of
// the source's bins][is_lc(C) columns, 8 floats of padding]; sized for the
// largest C), X~ of the CTA's whole m range (re, im:
// [FC][RM channel rows of BP], swizzled, not padded: tile p of channel m
// at p ^ is_swz(m); bins RM BP + 8 = 8 mod 32 floats apart), the IFFT's A
// (Dvr, -Dvi of every bin: [2][16 mt2 rows][IS_DVP]), the halo path's S
// window offsets, one mbarrier a ring slot, then (1024-byte aligned) a
// ring of `stages` slots, each one step's windows or raw rows while X~ is
// built, then one step's planes (re, im).  Three stages where they fit
// the card's limit, else two.
__host__ __device__ constexpr int is_swz(int m) { return ((m >> 1) & 1) << 3; }
constexpr int IS_NT = BN * BP / 8;          // n-tiles (8 columns) a block
__host__ __device__ constexpr int is_lc(int C) {   // a rank's row pitch:
  return 8 * ((IS_NT + C - 1) / C) + 8;            // its columns, padded
}
__host__ __device__ constexpr int is_recv() {
  int most = 0;
  for (int c = 1; c <= MAX_CLUSTER; ++c) most = imax(most, c * 16 * is_lc(c));
  return most;
}
constexpr int IS_DVP = MAX_CLUSTER * FC + 4;     // A row pitch (4 mod 32)
struct IsLayout {
  int da, rv, xfp, xf, dv, soff, bar, ring, x_sz, slot, stages, total;
  __host__ __device__ IsLayout(int S, int S2, int x_floats, int RM) {
    const int ks = (S + 7) / 8, mt2 = (S2 + 15) / 16;
    da = rv = 0;                             // [2][ks][32 lanes][4]; gather
    xfp = RM * BP + 8;                       // X~ pitch of a bin
    xf = imax(2 * ks * 128, is_recv());      // [2][FC][xfp]
    dv = xf + 2 * FC * xfp;                  // [2][16 mt2][IS_DVP]
    soff = dv + 2 * 16 * mt2 * IS_DVP;       // [S] ints
    bar = soff + align4(S);                  // [OS_STAGES] mbarriers
    ring = align_to(bar + align4(2 * OS_STAGES), OS_ALIGN);
    x_sz = align_to(x_floats, 128);
    slot = imax(x_sz, 2 * W_PLANE);
    for (stages = OS_STAGES;; --stages) {
      total = ring + stages * slot + OS_ALIGN;
      if (stages <= 2 || 4 * total <= SMEM_MAX) break;
    }
  }
};

// Shared-memory carve-up of the weight-stationary kernel, in floats, from
// a base aligned to 1024 bytes: the FFT's A fragments (as in OsLayout), the
// IFFT's A over every bin (Dvr, Dvi of the S2 valid rows, Dvi negated
// where it is split: [2][S2][IS_DVP]; rows past S2 read as 0), X~ of a
// step (as in OsLayout: [2][FC][XFP]), whose place the gather buffer
// takes in each rectangle's epilogue (the Y~ of the n-tiles a cluster
// rank finishes: [C sources][16 rows][ws_lc(C)], sized for the largest
// C), the halo path's S window offsets, one mbarrier a ring slot and one
// for the planes, then (1024-byte aligned, as the TMA swizzles want) the m
// range's planes, resident: one [re, im][FC][WBN][BM] block a BM-channel
// step, each landed as the output-stationary kernel's plane stage (WBN
// rows), and a ring of `stages` slots of one step's windows (512-byte
// aligned, as the windows' 8192 floats keep them) or raw rows (16-byte
// aligned).  WS_STAGES stages where they fit the card's limit, else fewer,
// at least two.
constexpr int WS_STAGES = 4;                    // the deepest ring
constexpr int WBN = 32;                         // output channels a CTA
constexpr int W_WPLANE = FC * WBN * BM;         // a step's re or im plane
// the tile-FFT's k steps unrolled (windows, raw rows) and the IFFT's: the
// fastest measured without a spill (scripts/kernel_breakdown.py)
constexpr int WS_FFT_UNROLL[2] = {8, 4};
constexpr int WS_IFFT_UNROLL = 4;
constexpr int WS_NT = WBN * BP / 8;             // n-tiles (8 columns) a CTA
__host__ __device__ constexpr int ws_lc(int C) {   // a rank's row pitch
  return 8 * ((WS_NT + C - 1) / C) + 8;
}
__host__ __device__ constexpr int ws_recv() {
  int most = 0;
  for (int c = 1; c <= MAX_CLUSTER; ++c) most = imax(most, c * 16 * ws_lc(c));
  return most;
}
struct WsLayout {
  int da, dv, xf, soff, bar, planes, ring, slot, stages, total;
  __host__ __device__ WsLayout(int S, int S2, int x_floats, int RM) {
    const int ks = (S + 7) / 8;
    da = 0;                                  // [2][ks][32 lanes][4]
    dv = da + 2 * ks * 128;                  // [2][S2][IS_DVP]
    xf = dv + 2 * S2 * IS_DVP;               // X~ [2][FC][XFP]; gather
    soff = xf + imax(2 * FC * XFP, ws_recv());
    bar = soff + align4(S);                  // ring slots, then planes
    planes = align_to(bar + align4(2 * (WS_STAGES + 1)), OS_ALIGN);
    ring = planes + RM / BM * 2 * W_WPLANE;
    slot = align4(x_floats);
    for (stages = WS_STAGES;; --stages) {
      total = ring + stages * slot + OS_ALIGN;
      if (stages <= 2 || 4 * total <= SMEM_MAX) break;
    }
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
  };
  __host__ __device__ int blocks() const { return (P + BP - 1) / BP; }
  __host__ __device__ int x_floats(int S) const { return S * MP; }
  __device__ Blk block(int bx, int) const { return {bx * BP}; }
  __device__ long long out_at(const Blk& k, int s2, int n, int N,
                              int p) const {
    return k.p0 + p < P ? ((long long)s2 * N + n) * P + k.p0 + p : -1;
  }
  // The output-stationary kernel's window stage: [BM][S][BP], rows R =
  // m S + s of BP floats, 16-byte chunk c of a row at c ^ ((R >> 1) & 3):
  // the layout a TMA box (p, s, m) lands in with the 64-byte swizzle, which
  // the FFT's B fragment reads conflict-free (its k order permuted, see
  // the kernel).  The 4-byte copies write the same layout where the launch
  // does not take TMA (rows not 16-byte aligned; aligned rows always go by
  // TMA, so the loader has no 16-byte path).
  struct FftCol {
    int m, p;
  };
  __device__ static int win_at(int S, int m, int s, int p) {
    const int r = m * S + s;
    return r * BP + ((((p >> 2) ^ (r >> 1)) & 3) << 2) + (p & 3);
  }
  __device__ int tma_p0(const Blk& k) const { return k.p0; }
  template <int T>
  __device__ void load_os(const Blk& k, float* sx, int S, int M, int m0,
                          int tid) const {
    for (int i = tid; i < BM * S * BP; i += T) {
      const int r = i / BP, p = i - r * BP, m = r / S, s = r - m * S;
      const bool ok = m0 + m < M && k.p0 + p < P;
      cp_async4(sx + win_at(S, m, s, p),
                ok ? xt + ((size_t)s * M + m0 + m) * x_pitch + k.p0 + p
                   : xt, ok);
    }
  }
  __device__ void fft_offsets(int*, int) const {}
  __device__ FftCol fft_col(const Blk&, int col, int) const {
    return {col / BP, col % BP};
  }
  __device__ float fft_x(const float* sx, const int*, FftCol c, int s,
                         int S) const {
    return s < S ? sx[win_at(S, c.m, s, c.p)] : 0.f;
  }
};

using HaloOs = HaloPath<ONT, BM, BP>;  // halo.cuh: every kernel's halo path

// The weight-stationary kernel's halo path: HaloOs's blocks and output,
// with a step's raw rows staged by 16-byte copies.  The flow stages a
// block's rows once per n block, so their copies count: HaloOs's
// per-element copies cost it a third of its time.  A raw row is staged
// from the 16-byte aligned column a0 = c0 - sh below the block's first
// column c0 (sh = c0 mod 4), at a pitch cp of its columns plus 3 rounded
// up to 4 floats, plus 4 where that is a multiple of 8 ([BM][rows][cp]:
// cp = 4 mod 8, so the FFT's B reads of tile rows 6 apart fall in
// different banks); chunks wholly inside the image's row go
// by one 16-byte cp.async where its rows are 16-byte strided (W % 4 ==
// 0), the rest element by element (zero outside the image and past M).
// The tile-FFT reads window elements by offset as HaloOs's does, shifted
// by sh.
struct HaloWsPath : HaloOs {
  __host__ __device__ int cp() const {
    const int c = align4(g.cols + 3);
    return c % 8 ? c : c + 4;
  }
  __host__ __device__ int x_floats(int) const { return BM * g.rows * cp(); }
  template <int T>
  __device__ void load_os(const Blk& k, float* sx, int, int, int m0,
                          int tid) const {
    static_assert(T == ONT && ONT / 32 == BM, "a warp per channel");
    const int lane = tid % 32, m = tid / 32, pitch = cp(), q4 = pitch / 4;
    const int a0 = k.hb.c0 - (k.hb.c0 & 3);
    const bool m_ok = m0 + m < g.M;
    const bool vec = g.W % 4 == 0 && (size_t)x % 16 == 0;
    const float* plane =
        x + ((size_t)k.hb.b * g.M + (m_ok ? m0 + m : 0)) * g.H * g.W;
    float* d = sx + m * g.rows * pitch;
    // lane's chunks i = lane + 32 j as (row r, chunk c4), advanced without
    // a division: 32 chunks are dr rows and dc chunks
    const int dr = 32 / q4, dc = 32 - dr * q4;
    int r = lane / q4, c4 = lane - r * q4;
    for (; r < g.rows; r += dr, c4 += dc) {
      if (c4 >= q4) {
        c4 -= q4;
        if (++r >= g.rows) break;
      }
      const int c = 4 * c4, gc = a0 + c, gr = k.hb.r0 + r;
      const bool row_ok = m_ok && (unsigned)gr < (unsigned)g.H;
      const float* src = plane + (size_t)gr * g.W + gc;
      float* dst = d + r * pitch + c;
      if (vec && row_ok && gc >= 0 && gc + 4 <= g.W) {
        cp_async16(dst, src, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && (unsigned)(gc + e) < (unsigned)g.W;
          cp_async4(dst + e, ok ? src + e : x, ok);
        }
      }
    }
  }
  __device__ void fft_offsets(int* soff, int tid) const {
    for (int s = tid; s < g.K * g.K; s += ONT)
      soff[s] = (s / g.K) * cp() + s % g.K;
  }
  __device__ FftCol fft_col(const Blk& k, int col, int) const {
    const int m = col / BP, p = col - m * BP;
    const int ii = p / g.btw, jj = p - ii * g.btw;
    return {(m * g.rows + ii * g.t) * cp() + jj * g.t + (k.hb.c0 & 3),
            k.hb.real(g, p)};
  }
  // window element s = u K + v at u cp + v, computed (K = 8: shifts)
  // rather than read from the offsets table, one load a B element fewer
  __device__ float fft_x(const float* raw, const int* soff, FftCol c, int s,
                         int S) const {
    const int o = g.K == 8 ? (s >> 3) * cp() + (s & 7) : soff[s];
    return c.real && s < S ? raw[c.base + o] : 0.f;
  }
};

// ---------------------------------------------------------------------------
// Device pieces of the tensor-core kernels (output-, input- and
// weight-stationary), each thread's part of a CTA-wide step
// ---------------------------------------------------------------------------

// The tile-FFT's A of bin chunk f0 (fc bins): row r < 8 is Re Df[f0 + r],
// r >= 8 Im Df[f0 + r - 8], column s, split to TF32 (hi, lo) once and
// stored in fragment order [k step][lane][a0..a3] (the lo parts ks * 128
// words after the hi ones), zero outside the chunk and S.  The k index
// within a step of 8 window rows is permuted (k -> fft_row(k)), here and
// where the FFT reads the windows, so that the swizzled window stage
// reads conflict-free.  BATCH elements a thread are loaded before any is
// split, so their load latencies overlap.
template <int BATCH = 1>
__device__ __forceinline__ void split_fft_a(uint32_t* s_da,
                                            const float* __restrict__ dfr,
                                            const float* __restrict__ dfi,
                                            int f0, int fc, int S, int tid) {
  const int n = (S + 7) / 8 * 128;
  for (int i0 = tid; i0 < n; i0 += BATCH * ONT) {
    float x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * ONT;
      const int kk = i / 128, ln = (i / 4) % 32, e = i % 4;
      const int r = ln / 4 + (e & 1) * 8;
      const int s = kk * 8 + fft_row(ln % 4 + (e & 2) * 2);
      const int f = r % 8;
      x[k] = 0.f;
      if (i < n && f < fc && s < S)
        x[k] = (r < 8 ? dfr : dfi)[(size_t)(f0 + f) * S + s];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (i0 + k * ONT < n)
        split(x[k], s_da[i0 + k * ONT], s_da[n + i0 + k * ONT]);
  }
}

// The IFFT's A over every bin, in f32: s_dv [2][rows][IS_DVP], part 0 Dvr,
// part 1 -Dvi, row s2, column f; zero past S2 and Fa.
__device__ __forceinline__ void load_dv(float* s_dv,
                                        const float* __restrict__ dvr,
                                        const float* __restrict__ dvi,
                                        int rows, int S2, int Fa, int tid) {
  for (int i = tid; i < 2 * rows * IS_DVP; i += ONT) {
    const int h = i / (rows * IS_DVP), rw = i % (rows * IS_DVP);
    const int s2 = rw / IS_DVP, f = rw % IS_DVP;
    s_dv[i] = s2 < S2 && f < Fa
                  ? (h ? -dvi[(size_t)s2 * Fa + f] : dvr[(size_t)s2 * Fa + f])
                  : 0.f;
  }
}

// Stage 1 of a channel step: the tile-FFT of the warp's channel, its
// columns fcol (tiles 8 j + gq) against the split A; c[j] rows gq: Re X~
// of bin gq, gq + 8: Im, at tiles 8 j + 2 tq (+1).  UNROLL of its k steps
// unrolled (the register budget of the caller).
template <int UNROLL, class Path>
__device__ __forceinline__ void tile_fft(
    const Path& io, const float* sx, const int* s_soff,
    const typename Path::FftCol (&fcol)[2], const uint32_t* s_da, int S,
    int lane, int tq, float (&c)[2][4]) {
  const int ks = (S + 7) / 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = 0.f;
  const uint4* ah4 = reinterpret_cast<const uint4*>(s_da);
  const uint4* al4 = reinterpret_cast<const uint4*>(s_da + ks * 128);
#pragma unroll(UNROLL)
  for (int kk = 0; kk < ks; ++kk) {
    const uint4 h = ah4[kk * 32 + lane], l = al4[kk * 32 + lane];
    const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
    const uint32_t al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float b[2] = {
          io.fft_x(sx, s_soff, fcol[j], kk * 8 + fft_row(tq), S),
          io.fft_x(sx, s_soff, fcol[j], kk * 8 + fft_row(tq + 4), S)};
      uint32_t bh[2], bl[2];
      split_frag(b, bh, bl);
      mma3_f32(c[j], ah, al, bh, bl);
    }
  }
}

// X~ of one step in the output-stationary layout ([2][FC][XFP]: a bin's
// BM channel rows of XP floats): the warp's tile-FFT result (channel
// `warp`) stored, and the split B fragments of bin hf read for the
// Hadamard (k = channel tq (+4), columns tiles 8 pt + gq).
__device__ __forceinline__ void store_xf(float* s_xr, float* s_xi,
                                         const float (&c)[2][4], int warp,
                                         int gq, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int o = gq * XFP + warp * XP + j * 8 + 2 * tq;
    *reinterpret_cast<float2*>(s_xr + o) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(s_xi + o) = make_float2(c[j][2], c[j][3]);
  }
}
__device__ __forceinline__ void load_xf(const float* s_xr, const float* s_xi,
                                        int hf, int gq, int tq,
                                        uint32_t (&brh)[2][2],
                                        uint32_t (&brl)[2][2],
                                        uint32_t (&bih)[2][2],
                                        uint32_t (&bil)[2][2]) {
#pragma unroll
  for (int pt = 0; pt < 2; ++pt) {
    const int o = hf * XFP + tq * XP + pt * 8 + gq;
    const float br[2] = {s_xr[o], s_xr[o + 4 * XP]};
    const float bi[2] = {s_xi[o], s_xi[o + 4 * XP]};
    split_frag(br, brh[pt], brl[pt]);
    split_frag(bi, bih[pt], bil[pt]);
  }
}

// Stage 2 of a channel step: the complex Hadamard of bin hf over BM
// channels, A = rows n of bin hf of a plane stage swr/swi [FC][BN][BM]
// (a row's two 16-byte chunks swapped where n & 4, as the copies land
// it), k = m; B = the split X~ fragments.  The four real products per
// bin (re = Wr Xr - Wi Xi, im = Wr Xi + Wi Xr) go to the step's fresh
// accumulators, added to are/aim[mt][pt] (n rows 16 mt + gq (+8), tiles
// 8 pt + 2 tq (+1)) in f32, over a plane stage of PBN rows a bin (NA
// row tiles of 16).
template <int PBN = BN, int NA>
__device__ __forceinline__ void hadamard_mma(
    const float* swr, const float* swi, int hf, int gq, int tq,
    const uint32_t (&brh)[2][2], const uint32_t (&brl)[2][2],
    const uint32_t (&bih)[2][2], const uint32_t (&bil)[2][2],
    float (&are)[NA][2][4], float (&aim)[NA][2][4]) {
  static_assert(NA * 16 == PBN, "a row tile of 16 rows per accumulator");
  const int k_lo = tq ^ (gq & 4), k_hi = (tq + 4) ^ (gq & 4);
#pragma unroll
  for (int mt = 0; mt < NA; ++mt) {
    const int row = (hf * PBN + mt * 16 + gq) * BM;
    const float ar[4] = {swr[row + k_lo], swr[row + 8 * BM + k_lo],
                         swr[row + k_hi], swr[row + 8 * BM + k_hi]};
    const float ai[4] = {swi[row + k_lo], swi[row + 8 * BM + k_lo],
                         swi[row + k_hi], swi[row + 8 * BM + k_hi]};
    uint32_t arh[4], arl[4], aih[4], ail[4], nih[4], nil[4];
    split_frag(ar, arh, arl);
    split_frag(ai, aih, ail);
    neg_frag(aih, nih);
    neg_frag(ail, nil);
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {    // this step's sum, then f32 adds
      float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
      mma3_f32(tr, arh, arl, brh[pt], brl[pt]);
      mma3_f32(tr, nih, nil, bih[pt], bil[pt]);
      mma3_f32(ti, arh, arl, bih[pt], bil[pt]);
      mma3_f32(ti, aih, ail, brh[pt], brl[pt]);
      add4(are[mt][pt], tr);
      add4(aim[mt][pt], ti);
    }
  }
}

// The gather of a cluster's Y~ (the input- and weight-stationary
// epilogues): the warp pushes its bin hf's Y~ (row hf re, 8 + hf im) of
// the n-tiles ct = 2 n + pt of accumulator row tiles MT0 .. MT0 + NMT - 1
// (ct counted from row tile MT0) into the gather buffer s_rv of the rank
// that finishes it, rank ct % C: row block `rank` (this CTA's chunk),
// columns (ct / C) 8 + 2 tq (+1) at a row pitch of lc.
template <int MT0, int NMT, int NA>
__device__ __forceinline__ void push_ytilde(
    cg::cluster_group& cluster, float* s_rv, int rank, int n_ranks, int lc,
    int hf, int gq, int tq, const float (&are)[NA][2][4],
    const float (&aim)[NA][2][4]) {
#pragma unroll
  for (int mt = MT0; mt < MT0 + NMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        const int ct = ((mt - MT0) * 16 + gq + 8 * hh) * 2 + pt;
        float* dst = cluster.map_shared_rank(s_rv, ct % n_ranks) +
                     rank * 16 * lc;
        const int col = (ct / n_ranks) * 8 + 2 * tq;
        *reinterpret_cast<float2*>(dst + hf * lc + col) =
            make_float2(are[mt][pt][2 * hh], are[mt][pt][2 * hh + 1]);
        *reinterpret_cast<float2*>(dst + (8 + hf) * lc + col) =
            make_float2(aim[mt][pt][2 * hh], aim[mt][pt][2 * hh + 1]);
      }
}

// The valid-row IFFT of the n-tiles i = 0 .. n_cts - 1 a cluster rank
// finishes, NJ a warp at a time: partial[s2][col] = sum over the source
// chunks q (rank order) and their bins k of A[s2][bin0 + FC q + k] .
// Y~_q[k][col], its B fragments read from the gathered Y~ (s_rv: [C][16
// rows, re then im][lc]) and A from s_dv ([2][rows][IS_DVP]: Dvr, then
// -Dvi, or +Dvi negated here where NEG_IM; rows past `rows` read as 0),
// in 3xTF32.  The sources are summed inside each k loop in rank order, so
// the result repeats bit for bit.  store(i, s2, col, v) takes each
// finished element (s2 < S2, col 0..7 of n-tile i).  KQ_UNROLL of the
// (source, re / im) steps are unrolled.
template <int NJ, bool NEG_IM, int KQ_UNROLL, class Store>
__device__ __forceinline__ void gather_ifft(const float* s_rv, int lc,
                                            const float* s_dv, int rows,
                                            int bin0, int n_ranks, int n_cts,
                                            int S2, int warp, int gq, int tq,
                                            Store&& store) {
  const int mt2 = (S2 + 15) / 16;
#pragma unroll 1
  for (int i0 = NJ * warp; i0 < n_cts; i0 += NJ * WARPS) {
    const bool two = NJ > 1 && i0 + 1 < n_cts;
    float d[MT2_MAX][NJ][4];
#pragma unroll
    for (int a = 0; a < MT2_MAX; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[a][j][e] = 0.f;
#pragma unroll(KQ_UNROLL)
    for (int kq = 0; kq < 2 * n_ranks; ++kq) {   // (source, re / im)
      const int cq = kq / 2, h = kq % 2;
      const float* rb = s_rv + (cq * 16 + h * 8 + tq) * lc;
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = (i0 + (two ? j : 0)) * 8 + gq;
        const float b[2] = {rb[col], rb[4 * lc + col]};
        split_frag(b, bh[j], bl[j]);
      }
      const float* av = s_dv + h * rows * IS_DVP + bin0 + cq * FC + tq;
#pragma unroll
      for (int m2 = 0; m2 < MT2_MAX; ++m2) {
        if (m2 >= mt2) break;
        const int r = m2 * 16 + gq;
        const float* ar = av + r * IS_DVP;
        const float a[4] = {r < rows ? ar[0] : 0.f,
                            r + 8 < rows ? ar[8 * IS_DVP] : 0.f,
                            r < rows ? ar[4] : 0.f,
                            r + 8 < rows ? ar[8 * IS_DVP + 4] : 0.f};
        uint32_t ah[4], al[4];
        split_frag(a, ah, al);
        if (NEG_IM && h) {          // -x splits into the negated parts
          neg_frag(ah, ah);
          neg_frag(al, al);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma3_f32(d[m2][j], ah, al, bh[j],
                                              bl[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j == 1 && !two) break;
#pragma unroll
      for (int m2 = 0; m2 < MT2_MAX; ++m2) {
        if (m2 >= mt2) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s2 = m2 * 16 + gq + (e >> 1) * 8;
          if (s2 < S2) store(i0 + j, s2, 2 * tq + (e & 1), d[m2][j][e]);
        }
      }
    }
  }
}

// Output-stationary (B1 on the windowed path, B3 on the halo path): a CTA
// owns an (n block, tile block, bin chunk) and an m range of RM channels
// (all of M unless the wrapper splits it), and sums its range in MMA
// accumulators.  A cluster of C CTAs covers C consecutive bin chunks: all
// of them (H = 1 bin group), or, where clusters of that size would not
// fill the card, a 1/H share.  With one slice (one range, one group) it
// stores the finished output; otherwise the partial of range g, group h
// goes to workspace slice g H + h for the finish pass.
// SC: the shortcut's placement (shortcut.cuh; staged only with one slice).
template <class Path, int SC>
__global__ void __launch_bounds__(ONT, 1)
fused_os_kernel(const Path io, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ dfr,
                const float* __restrict__ dfi, const float* __restrict__ dvr,
                const float* __restrict__ dvi, const float* __restrict__ bias,
                const float* __restrict__ sc, float* __restrict__ y,
                float* __restrict__ ws, int S, int M, int Fa, int N, int S2,
                int relu, int RM, const __grid_constant__ OsMaps maps,
                int tma_x, int tma_w) {
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 4 * OS_ALIGN - 1) &
      ~(uintptr_t)(4 * OS_ALIGN - 1));
  const int chunks = (Fa + FC - 1) / FC;
  const OsLayout L(S, S2, io.x_floats(S),
                   SC == SC_STAGED ? (S2 + chunks - 1) / chunks * BN * BP
                                   : 0);     // staged: one slice, C = chunks
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  const bool tma = tma_x || tma_w;
  uint32_t* s_da = reinterpret_cast<uint32_t*>(smem + L.da);
  uint32_t* s_va = reinterpret_cast<uint32_t*>(smem + L.va);
  float* s_xr = smem + L.xf;                // X~ [FC][XFP], re then im
  float* s_xi = s_xr + FC * XFP;
  int* s_soff = reinterpret_cast<int*>(smem + L.soff);
  float* ring = smem + L.ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // MMA fragment coordinates
  const typename Path::Blk blk = io.block(blockIdx.x, tid);
  const int n0 = blockIdx.y * BN;
  const int chunk = blockIdx.z % chunks, g = blockIdx.z / chunks;
  const int n_ranks = (int)cluster.num_blocks();
  const int H = chunks / n_ranks;           // bin groups
  const int slices = gridDim.z / chunks * H;
  const int slice = g * H + chunk / n_ranks;
  const int f0 = chunk * FC;                // this CTA's bin chunk
  const int fc = Fa - f0 < FC ? Fa - f0 : FC;   // bins of this chunk
  const int m_lo = g * RM, m_hi = min(M, m_lo + RM);
  const int n_steps = (m_hi - m_lo + BM - 1) / BM;
  const int mt2 = (S2 + 15) / 16;

  // The tile-FFT's A (split_fft_a) and the IFFT's A: row s2, column k < 8
  // Re Dv[s2][f0 + k], k >= 8 -Im Dv[s2][f0 + k - 8], split to TF32 (hi,
  // lo) once, stored in fragment order [k step][lane][a0..a3], zero
  // outside the chunk and S2.
  split_fft_a(s_da, dfr, dfi, f0, fc, S, tid);
  for (int i = tid; i < mt2 * 256; i += ONT) {
    const int mt = i / 256, kk = (i / 128) % 2, ln = (i / 4) % 32, e = i % 4;
    const int s2 = mt * 16 + ln / 4 + (e & 1) * 8;
    const int f = ln % 4 + (e & 2) * 2;
    float x = 0.f;
    if (s2 < S2 && f < fc)
      x = kk == 0 ? dvr[(size_t)s2 * Fa + f0 + f]
                  : -dvi[(size_t)s2 * Fa + f0 + f];
    split(x, s_va[i], s_va[mt2 * 256 + i]);
  }
  io.fft_offsets(s_soff, tid);
  if (tma && tid == 0) {
    for (int q = 0; q < L.stages; ++q) sm90::mbar_init(&bars[q], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // 16-byte plane copies where every row start is 16-byte aligned.  Never
  // taken: launch_os loads such planes by TMA or refuses the launch.  It
  // stays because without it ptxas spills in this kernel (every variant
  // of the 4-byte loop alone tried spilled 24-36 bytes); the SASS checks
  // (no STL in fused_os_kernel: chip_smoke.py (b), the card tests) guard
  // the allocation.
  const bool w_vec = M % 4 == 0 && (size_t)wr % 16 == 0 &&
                     (size_t)wi % 16 == 0;

  // one pipeline step into ring slot `slot`: the input of channels m0..
  // (windows [BM][S][BP] or raw rows) and this chunk's planes [FC][BN][BM]
  // (re, im; row n's two 16-byte chunks swapped where n & 4), zero-filled
  // outside [M) x [N) x [Fa).  TMA boxes (issued by thread 0, complete on
  // the slot's mbarrier) land in the same swizzled layouts as the copies:
  // the windows with the 64-byte swizzle, the planes with the 32-byte one.
  auto load_step = [&](int slot, int m0) {
    float* sx = ring + slot * L.slot;
    float* swr = sx + L.x_sz;
    float* swi = swr + W_PLANE;
    if (tma && tid == 0) {
      sm90::mbar_expect_tx(&bars[slot], (tma_x ? 4 * S * BM * BP : 0) +
                                            (tma_w ? 8 * W_PLANE : 0));
      if constexpr (std::is_same<Path, WindowedPath>::value)
        if (tma_x)
          sm90::tma_load_3d(sx, &maps.x, &bars[slot], io.tma_p0(blk), 0, m0);
      if (tma_w) {
        sm90::tma_load_3d(swr, &maps.wr, &bars[slot], m0, n0, f0);
        sm90::tma_load_3d(swi, &maps.wi, &bars[slot], m0, n0, f0);
      }
    }
    if (!tma_x) io.template load_os<ONT>(blk, sx, S, M, m0, tid);
    if (tma_w) return;
    if (w_vec) {
      for (int i = tid; i < W_PLANE / 4; i += ONT) {
        const int f = i / (BN * BM / 4), r = i - f * (BN * BM / 4);
        const int n = r / (BM / 4), c = r - n * (BM / 4);
        const int bytes =
            n0 + n < N && f < fc ? clamp_bytes(M - m0 - 4 * c) : 0;
        const size_t gi = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + 4 * c;
        const int d = (f * BN + n) * BM + 4 * (c ^ ((n >> 2) & 1));
        cp_async16(swr + d, bytes ? wr + gi : wr, bytes);
        cp_async16(swi + d, bytes ? wi + gi : wi, bytes);
      }
    } else {
      for (int i = tid; i < W_PLANE; i += ONT) {
        const int f = i / (BN * BM), r = i - f * (BN * BM);
        const int n = r / BM, m = r - n * BM;
        const bool ok = n0 + n < N && m0 + m < M && f < fc;
        const size_t gi = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
        const int d = (f * BN + n) * BM + (m ^ (((n >> 2) & 1) << 2));
        cp_async4(swr + d, ok ? wr + gi : wr, ok);
        cp_async4(swi + d, ok ? wi + gi : wi, ok);
      }
    }
  };

  // staged shortcut: the elements this thread adds at the flush (rows
  // rank, rank + C, ... in the flush's map), zero where nothing is stored;
  // the copies join the first step's group
  const int tp = tid % BP, tn = tid / BP;   // flush map
  float* s_sc = smem + L.sc;
  if constexpr (SC == SC_STAGED) {
    const int rank = (int)cluster.block_rank();
    for (int s = rank, q = 0; s < S2; s += n_ranks, ++q)
#pragma unroll
      for (int j = 0; j < OTN; ++j) {
        const int n = tn + j * ONSTRIDE, gn = n0 + n;
        const long long o = gn < N ? io.out_at(blk, s, gn, N, tp) : -1;
        cp_async4(s_sc + (q * BN + n) * BP + tp, o >= 0 ? sc + o : sc,
                  o >= 0);
      }
  }

  // the warp's FFT columns: channel `warp`, tiles 8 j + gq (j = 0, 1);
  // its Hadamard bin: `warp`, rows 16 mt + gq (+ 8); plane rows swap their
  // 16-byte chunks where n & 4, i.e. gq & 4
  const typename Path::FftCol fcol[2] = {
      io.fft_col(blk, warp * BP + gq, tq), io.fft_col(blk, warp * BP + 8 + gq,
                                                      tq)};
  const int hf = warp;
  float are[4][2][4], aim[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) are[i][j][r] = aim[i][j][r] = 0.f;

  for (int st = 0; st < L.stages - 1; ++st) {
    if (st < n_steps) load_step(st, m_lo + st * BM);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    if (L.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (tma) sm90::mbar_wait(&bars[step % L.stages], (step / L.stages) & 1);
    __syncthreads();    // step's stage (and the fragments) ready; the slot
                        // of step - 1 and X~ are free
    const int nx = step + L.stages - 1;
    if (nx < n_steps) load_step(nx % L.stages, m_lo + nx * BM);
    cp_async_commit();
    const float* sx = ring + (step % L.stages) * L.slot;

    // Stage 1: tile-FFT of the warp's channel into X~
    {
      float c[2][4];
      tile_fft<2>(io, sx, s_soff, fcol, s_da, S, lane, tq, c);
      store_xf(s_xr, s_xi, c, warp, gq, tq);
    }
    __syncthreads();    // X~ written

    // Stage 2: complex Hadamard of bin hf over the step's BM channels:
    // A = W[hf] rows (n), k = m; B = X~[hf] (k = m, columns p)
    {
      uint32_t brh[2][2], brl[2][2], bih[2][2], bil[2][2];
      load_xf(s_xr, s_xi, hf, gq, tq, brh, brl, bih, bil);
      hadamard_mma(sx + L.x_sz, sx + L.x_sz + W_PLANE, hf, gq, tq, brh, brl,
                   bih, bil, are, aim);
    }
  }
  __syncthreads();      // the ring's last readers are done: Y~ and the
                        // spatial partial alias it

  // Stage 3: this chunk's valid-row IFFT, 8 output channels (n rows
  // 16 mt + 8 hh + r) at a time: each warp stages its bin's rows into Y~
  // [16 (re, im bins)][YQ] (in X~'s place), then all warps take
  // partial[s2][n][p] = A'[s2][:] . Y~[:][(r, p)], 8 columns a tile
  float* s_y = s_xr;
  float* s_part = smem + L.part;
  const uint4* vh4 = reinterpret_cast<const uint4*>(s_va);
  const uint4* vl4 = reinterpret_cast<const uint4*>(s_va + mt2 * 256);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int mt = q / 2, hh = q % 2;
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      const int col = gq * BP + pt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(s_y + hf * YQ + col) =
          make_float2(are[mt][pt][2 * hh], are[mt][pt][2 * hh + 1]);
      *reinterpret_cast<float2*>(s_y + (8 + hf) * YQ + col) =
          make_float2(aim[mt][pt][2 * hh], aim[mt][pt][2 * hh + 1]);
    }
    __syncthreads();    // Y~ of these 8 channels staged
#pragma unroll
    for (int nt = warp; nt < 8 * BP / 8; nt += WARPS) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* yc = s_y + (kk * 8 + tq) * YQ + nt * 8 + gq;
        const float b[2] = {yc[0], yc[4 * YQ]};
        split_frag(b, bh[kk], bl[kk]);
      }
#pragma unroll
      for (int m2 = 0; m2 < MT2_MAX; ++m2) {   // independent row tiles
        if (m2 >= mt2) break;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint4 vh = vh4[(m2 * 2 + kk) * 32 + lane];
          const uint4 vl = vl4[(m2 * 2 + kk) * 32 + lane];
          const uint32_t ah[4] = {vh.x, vh.y, vh.z, vh.w};
          const uint32_t al[4] = {vl.x, vl.y, vl.z, vl.w};
          mma3_f32(d, ah, al, bh[kk], bl[kk]);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int s2 = m2 * 16 + gq + 8 * h2;
          if (s2 < S2)
            *reinterpret_cast<float2*>(s_part + s2 * BN * BP + q * 8 * BP +
                                       nt * 8 + 2 * tq) =
                make_float2(d[2 * h2], d[2 * h2 + 1]);
        }
      }
    }
    __syncthreads();    // Y~ read: the next channels may overwrite it
  }
  cluster.sync();       // every chunk's partial is ready

  // Stage 4: sum the cluster's partials in rank order; rank r finishes rows
  // r, r + C, ...: bias (+ shortcut) + ReLU, one write per output element,
  // or (slices > 1) the partial to its workspace slice
  const int rank = (int)cluster.block_rank();
  const int slots = io.blocks() * BP;
  const float* part[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    part[q] = cluster.map_shared_rank(s_part, q < n_ranks ? q : 0);
  if constexpr (SC == SC_STAGED) cp_async_wait_all();   // long since landed
  for (int s = rank, row = 0; s < S2; s += n_ranks, ++row) {
#pragma unroll
    for (int j = 0; j < OTN; ++j) {
      const int n = tn + j * ONSTRIDE, gn = n0 + n;
      const int at = (s * BN + n) * BP + tp;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < n_ranks) v += part[q][at];
      if (gn >= N) continue;
      if (slices > 1) {
        ws[(((size_t)slice * S2 + s) * N + gn) * slots + blockIdx.x * BP + tp] =
            v;
        continue;
      }
      const long long o = io.out_at(blk, s, gn, N, tp);
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

// Input-stationary (B2 is plane, both input paths) on the tensor cores: a
// CTA owns a tile block, m range r of RM channels and a bin chunk; a
// cluster of C CTAs spans the chunks.  One pipeline runs every step of the
// CTA through the ring: first the range's window steps, whose tile-FFT
// (fused_os_kernel's) builds X~ of the chunk for the whole range once,
// then, for each n block, the range's plane steps, whose Hadamard
// (fused_os_kernel's) sums the range in fresh MMA accumulators against
// the resident X~.  The copies run ahead across n blocks: the epilogue of
// an n block touches no ring slot.  Epilogue: each warp stages its bin's
// Y~ (re, im) into the CTA's Y~ stage; after a cluster barrier, rank q
// computes the valid-row IFFT of the n-tiles (8 columns) q, q + C, ... of
// the block over every chunk's bins, its B fragments read from the
// chunks' Y~ stages through distributed shared memory and its A (Dv, all
// bins) from device memory, in 3xTF32, and stores the finished columns
// from registers: the output (bias (+ shortcut) + ReLU) with one m range,
// else range r's partial to workspace slice r for split_k.cuh's finish
// pass.  The chunks are summed inside each k-loop in rank order, so the
// result repeats bit for bit.  The cluster's arrive after the gather and
// its wait before the next n block's Y~ is written let the plane steps
// run in between.
template <class Path, int SC>
__global__ void __launch_bounds__(ONT, 1)
fused_is_kernel(const Path io, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ dfr,
                const float* __restrict__ dfi, const float* __restrict__ dvr,
                const float* __restrict__ dvi, const float* __restrict__ bias,
                const float* __restrict__ sc, float* __restrict__ y,
                float* __restrict__ ws, int S, int M, int Fa, int N, int S2,
                int relu, int RM, const __grid_constant__ OsMaps maps,
                int tma_x, int tma_w) {
  static_assert(SC == SC_NONE || SC == SC_GLOBAL, "staged: os only");
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 4 * OS_ALIGN - 1) &
      ~(uintptr_t)(4 * OS_ALIGN - 1));
  const IsLayout L(S, S2, io.x_floats(S), RM);
  const int ST = L.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  const bool tma = tma_x || tma_w;
  uint32_t* s_da = reinterpret_cast<uint32_t*>(smem + L.da);
  float* s_rv = smem + L.rv;                // gather buffer, after the FFT
  float* s_dv = smem + L.dv;                // IFFT A [2][16 mt2][IS_DVP]
  float* s_xr = smem + L.xf;                // X~ [FC][xfp], re then im
  float* s_xi = s_xr + FC * L.xfp;
  int* s_soff = reinterpret_cast<int*>(smem + L.soff);
  float* ring = smem + L.ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // MMA fragment coordinates
  const typename Path::Blk blk = io.block(blockIdx.x, tid);
  const int G = gridDim.y, r = blockIdx.y;
  const int f0 = blockIdx.z * FC;           // this CTA's bin chunk
  const int fc = Fa - f0 < FC ? Fa - f0 : FC;
  const int m_lo = r * RM, m_hi = min(M, m_lo + RM);
  const int n_steps = (m_hi - m_lo + BM - 1) / BM;
  const int nb = (N + BN - 1) / BN;
  const int mt2 = (S2 + 15) / 16;
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // the cluster's bin group (clusters of C consecutive chunks) and the
  // workspace slice of (m range, bin group)
  const int H = gridDim.z / n_ranks, hg = blockIdx.z / n_ranks;
  const int slice = r * H + hg, slices = G * H;

  // the FFT's A fragments and the IFFT's A over every bin
  split_fft_a(s_da, dfr, dfi, f0, fc, S, tid);
  load_dv(s_dv, dvr, dvi, 16 * mt2, S2, Fa, tid);
  io.fft_offsets(s_soff, tid);
  if (tma && tid == 0) {
    for (int q = 0; q < ST; ++q) sm90::mbar_init(&bars[q], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // step q of the pipeline: q < n_steps the window step q, else plane
  // step (q - n_steps) % n_steps of n block (q - n_steps) / n_steps.
  // Thread 0 arms slot q % ST's barrier with the step's TMA bytes; the
  // copies (TMA boxes, or cp.async where rows are not 16-byte aligned)
  // land in fused_os_kernel's swizzled layouts.
  const int total = n_steps * (1 + nb);
  auto issue = [&](int q) {
    const int slot = q % ST;
    float* st = ring + slot * L.slot;
    if (q < n_steps) {
      const int m0 = m_lo + q * BM;
      if (tma && tid == 0)
        sm90::mbar_expect_tx(&bars[slot], tma_x ? 4 * S * BM * BP : 0);
      if constexpr (std::is_same<Path, WindowedPath>::value)
        if (tma_x && tid == 0)
          sm90::tma_load_3d(st, &maps.x, &bars[slot], io.tma_p0(blk), 0, m0);
      if (!tma_x) io.template load_os<ONT>(blk, st, S, M, m0, tid);
      return;
    }
    const int p = q - n_steps, n0 = p / n_steps * BN;
    const int m0 = m_lo + (p % n_steps) * BM;
    float* swr = st;
    float* swi = swr + W_PLANE;
    if (tma && tid == 0)
      sm90::mbar_expect_tx(&bars[slot], tma_w ? 8 * W_PLANE : 0);
    if (tma_w) {
      if (tid == 0) {
        sm90::tma_load_3d(swr, &maps.wr, &bars[slot], m0, n0, f0);
        sm90::tma_load_3d(swi, &maps.wi, &bars[slot], m0, n0, f0);
      }
      return;
    }
    for (int i = tid; i < W_PLANE; i += ONT) {
      const int f = i / (BN * BM), rw = i - f * (BN * BM);
      const int n = rw / BM, m = rw - n * BM;
      const bool ok = n0 + n < N && m0 + m < M && f < fc;
      const size_t gi = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
      const int d = (f * BN + n) * BM + (m ^ (((n >> 2) & 1) << 2));
      cp_async4(swr + d, ok ? wr + gi : wr, ok);
      cp_async4(swi + d, ok ? wi + gi : wi, ok);
    }
  };

  // step q's stage once it landed (the slot of step q - 1 is free then
  // and takes step q + ST - 1's copies)
  auto begin = [&](int q) {
    if (ST == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (tma) sm90::mbar_wait(&bars[q % ST], (q / ST) & 1);
    __syncthreads();
    if (q + ST - 1 < total) issue(q + ST - 1);
    cp_async_commit();
    return ring + (q % ST) * L.slot;
  };
  for (int q = 0; q < ST - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }

  // Stage 1, the window steps: X~ rows q BM + warp of each bin, the
  // tile-FFT of step q; the warp's columns: channel `warp`, tiles 8 j + gq
  {
    const typename Path::FftCol fcol[2] = {
        io.fft_col(blk, warp * BP + gq, tq),
        io.fft_col(blk, warp * BP + 8 + gq, tq)};
#pragma unroll 1
    for (int q = 0; q < n_steps; ++q) {
      const float* st = begin(q);
      float c[2][4];
      tile_fft<2>(io, st, s_soff, fcol, s_da, S, lane, tq, c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = gq * L.xfp + (q * BM + warp) * BP +
                      ((j * 8 + 2 * tq) ^ is_swz(warp));
        *reinterpret_cast<float2*>(s_xr + o) = make_float2(c[j][0], c[j][1]);
        *reinterpret_cast<float2*>(s_xi + o) = make_float2(c[j][2], c[j][3]);
      }
    }
  }
  sm90::cluster_arrive();   // this CTA's FFT fragments are no longer read

  // Stage 2, the plane steps: step s of n block n0 against the resident
  // X~; the warp's bin `warp`, A rows 16 mt + gq (+ 8), k swizzled as the
  // plane stage
  const int hf = warp;
  float are[4][2][4], aim[4][2][4];
#pragma unroll 1
  for (int q = n_steps; q < total; ++q) {
    const float* st = begin(q);
    const int p = q - n_steps, s = p % n_steps, n0 = p / n_steps * BN;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) are[i][j][e] = aim[i][j][e] = 0.f;
    }
    {
      uint32_t brh[2][2], brl[2][2], bih[2][2], bil[2][2];
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        const int o = hf * L.xfp + (s * BM + tq) * BP +
                      ((pt * 8 + gq) ^ is_swz(tq));
        const float br[2] = {s_xr[o], s_xr[o + 4 * BP]};
        const float bi[2] = {s_xi[o], s_xi[o + 4 * BP]};
        split_frag(br, brh[pt], brl[pt]);
        split_frag(bi, bih[pt], bil[pt]);
      }
      hadamard_mma(st, st + W_PLANE, hf, gq, tq, brh, brl, bih, bil, are,
                   aim);
    }
    if (s < n_steps - 1) continue;

    // Stage 3: the n block's epilogue.  Every peer is done with its gather
    // buffer (its FFT, or the previous n block's gather: wait); the warp
    // pushes its bin's Y~ (row hf re, 8 + hf im) of each n-tile into the
    // buffer of the rank that finishes it, and the cluster meets.
    sm90::cluster_wait();
    const int lc_n = is_lc(n_ranks);
    push_ytilde<0, 4>(cluster, s_rv, rank, n_ranks, lc_n, hf, gq, tq, are,
                      aim);
    cluster.sync();     // every chunk's Y~ of this rank's n-tiles is here

    // the valid-row IFFT of the rank's n-tiles ct = rank + C i (columns
    // 8 ct .., n = ct / 2), two a warp at a time, stored from registers:
    // the output or workspace slice r
    const int slots = io.blocks() * BP;
    gather_ifft<2, false, 1>(
        s_rv, lc_n, s_dv, 16 * mt2, hg * n_ranks * FC, n_ranks,
        (IS_NT - rank + n_ranks - 1) / n_ranks, S2, warp, gq, tq,
        [&](int i, int s2, int col, float v) {
          const int ct = rank + n_ranks * i;
          const int gn = n0 + ct / 2;
          if (gn >= N) return;
          const int pp = (ct % 2) * 8 + col;
          if (slices > 1) {
            ws[(((size_t)slice * S2 + s2) * N + gn) * slots +
               blockIdx.x * BP + pp] = v;
            return;
          }
          const long long o = io.out_at(blk, s2, gn, N, pp);
          if (o >= 0) {
            v += bias[gn];
            if constexpr (SC == SC_GLOBAL) v += sc[o];
            if (relu) v = fmaxf(v, 0.f);
            y[o] = v;
          }
        });
    sm90::cluster_arrive();   // this CTA's gather buffer is read
  }
  sm90::cluster_wait();     // no CTA exits while a peer may still push
}

// Weight-stationary (B2 ws plane, both input paths) on the tensor cores,
// from the pieces of fused_os_kernel and fused_is_kernel.  A CTA owns an
// n block of WBN = 32 output channels (half the other flows' 64, so that
// an m range twice as wide fits and the epilogue gathers in one round),
// m range g of RM channels and a bin chunk, and a chunk of `per`
// consecutive tile blocks; a cluster of C CTAs spans the bin chunks (all
// of them).  Its m range's planes [FC][WBN][RM] (re, im) land once, by TMA
// boxes into one block a BM-channel step (cp.async where rows are not
// 16-byte aligned), and stay resident while it walks its tile blocks: for
// each, the range's steps run through the ring of window steps (TMA boxes,
// or the halo path's raw rows, whose tile-FFT reads them by offset), each
// a tile-FFT into X~ and the Hadamard against the step's resident plane
// block, summed in MMA accumulators.  The ring runs ahead across tile
// blocks.  Each output rectangle (tile block, n block, m range) ends in
// the input-stationary kernel's gather (the gather buffer takes X~'s
// place): the warps push their bin's Y~ to the rank that finishes each
// n-tile, and rank q computes the valid-row IFFT of its n-tiles over every
// chunk's bins and stores them from registers: the output (bias (+
// shortcut) + ReLU) with one m range, else range g's partial to workspace
// slice g for split_k.cuh's finish pass.  One cluster sums each rectangle
// of a range, whichever chunk of tile blocks it falls in, so a repeat
// launch, or the halo path's, gives the same bits.
template <class Path, int SC>
__global__ void __launch_bounds__(ONT, 1)
fused_ws_kernel(const Path io, const float* __restrict__ wr,
                const float* __restrict__ wi, const float* __restrict__ dfr,
                const float* __restrict__ dfi, const float* __restrict__ dvr,
                const float* __restrict__ dvi, const float* __restrict__ bias,
                const float* __restrict__ sc, float* __restrict__ y,
                float* __restrict__ ws, int S, int M, int Fa, int N, int S2,
                int relu, int RM, int per,
                const __grid_constant__ OsMaps maps, int tma_x, int tma_w) {
  static_assert(SC == SC_NONE || SC == SC_GLOBAL, "staged: os only");
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 4 * OS_ALIGN - 1) &
      ~(uintptr_t)(4 * OS_ALIGN - 1));
  const WsLayout L(S, S2, io.x_floats(S), RM);
  const int ST = L.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* w_bar = bars + WS_STAGES;       // the planes' barrier
  uint32_t* s_da = reinterpret_cast<uint32_t*>(smem + L.da);
  float* s_dv = smem + L.dv;                // IFFT A [2][S2][IS_DVP]
  float* s_xr = smem + L.xf;                // X~ [FC][XFP], re then im
  float* s_xi = s_xr + FC * XFP;
  float* s_rv = smem + L.xf;                // the gather buffer, in X~'s
  int* s_soff = reinterpret_cast<int*>(smem + L.soff);
  float* planes = smem + L.planes;          // [step][re, im][W_WPLANE]
  float* ring = smem + L.ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // MMA fragment coordinates
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z / n_ranks;       // the m range
  const int n0 = blockIdx.y * WBN;
  const int f0 = rank * FC;                 // this CTA's bin chunk
  const int fc = Fa - f0 < FC ? Fa - f0 : FC;
  const int m_lo = g * RM, m_hi = min(M, m_lo + RM);
  const int n_steps = (m_hi - m_lo + BM - 1) / BM;
  const int b_lo = blockIdx.x * per;
  const int n_blk = min(io.blocks(), b_lo + per) - b_lo;

  // the IFFT's A over every bin (Dvr, Dvi: negated where it is split) by
  // cp.async in the planes' group, first needed by the first epilogue;
  // the FFT's split A, its loads in batches
  for (int i = tid; i < 2 * S2 * IS_DVP; i += ONT) {
    const int h = i / (S2 * IS_DVP), rw = i - h * (S2 * IS_DVP);
    const int s2 = rw / IS_DVP, f = rw - s2 * IS_DVP;
    const bool ok = f < Fa;
    cp_async4(s_dv + i, ok ? (h ? dvi : dvr) + (size_t)s2 * Fa + f : dvr, ok);
  }
  split_fft_a<4>(s_da, dfr, dfi, f0, fc, S, tid);
  io.fft_offsets(s_soff, tid);
  if (tid == 0) {
    for (int q = 0; q < ST; ++q) sm90::mbar_init(&bars[q], 1);
    sm90::mbar_init(w_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the range's planes, once: step s's block [FC][WBN][BM] of channels
  // m_lo + s BM (re, then im W_WPLANE floats later), row n's two 16-byte
  // chunks swapped where n & 4, zero-filled outside [M) x [N) x [Fa); by
  // TMA (32-byte swizzle) on w_bar, else by cp.async in the group of the
  // IFFT's A (the first step's wait covers it)
  if (tma_w) {
    if (tid == 0) {
      sm90::mbar_expect_tx(w_bar, n_steps * 8 * W_WPLANE);
      for (int s = 0; s < n_steps; ++s) {
        float* pw = planes + s * 2 * W_WPLANE;
        sm90::tma_load_3d(pw, &maps.wr, w_bar, m_lo + s * BM, n0, f0);
        sm90::tma_load_3d(pw + W_WPLANE, &maps.wi, w_bar, m_lo + s * BM,
                          n0, f0);
      }
    }
  } else {
    for (int i = tid; i < n_steps * W_WPLANE; i += ONT) {
      const int s = i / W_WPLANE, e = i - s * W_WPLANE;
      const int f = e / (WBN * BM), rw = e - f * (WBN * BM);
      const int n = rw / BM, m = rw - n * BM, m0 = m_lo + s * BM;
      const bool ok = n0 + n < N && m0 + m < m_hi && f < fc;
      const size_t gi = ((size_t)(f0 + f) * N + n0 + n) * M + m0 + m;
      float* pw = planes + s * 2 * W_WPLANE;
      const int d = (f * WBN + n) * BM + (m ^ (((n >> 2) & 1) << 2));
      cp_async4(pw + d, ok ? wr + gi : wr, ok);
      cp_async4(pw + W_WPLANE + d, ok ? wi + gi : wi, ok);
    }
  }
  cp_async_commit();

  // ring step q: tile block b_lo + q / n_steps, channels m_lo + (q %
  // n_steps) BM: windows [BM][S][BP] by a TMA box (64-byte swizzle) on
  // the slot's barrier, else by the path's copies (the halo path's raw
  // rows, [BM][rows][cp])
  const int total = n_blk * n_steps;
  auto issue = [&](int q) {
    const int slot = q % ST;
    float* st = ring + slot * L.slot;
    const int m0 = m_lo + (q % n_steps) * BM;
    const typename Path::Blk blk = io.block(b_lo + q / n_steps, tid);
    if constexpr (std::is_same<Path, WindowedPath>::value)
      if (tma_x) {
        if (tid == 0) {
          sm90::mbar_expect_tx(&bars[slot], 4 * S * BM * BP);
          sm90::tma_load_3d(st, &maps.x, &bars[slot], io.tma_p0(blk), 0, m0);
        }
        return;
      }
    io.template load_os<ONT>(blk, st, S, M, m0, tid);
  };
  auto begin = [&](int q) {
    if (ST == 4)
      cp_async_wait<2>();
    else if (ST == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (tma_x) sm90::mbar_wait(&bars[q % ST], (q / ST) & 1);
    __syncthreads();    // step q landed; the slot of step q - 1 is free
    if (q + ST - 1 < total) issue(q + ST - 1);
    cp_async_commit();
    return ring + (q % ST) * L.slot;
  };
  for (int q = 0; q < ST - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }

  const int hf = warp;                      // the warp's Hadamard bin
  float are[WBN / 16][2][4], aim[WBN / 16][2][4];
  // one flat loop over the CTA's steps (tile block q / n_steps, step q %
  // n_steps of the range), as fused_is_kernel walks its n blocks: fewer
  // values live beside the accumulators than nested loops keep
#pragma unroll 1
  for (int q = 0; q < total; ++q) {
    const float* sx = begin(q);
    const int b = q / n_steps, s = q - b * n_steps, bx = b_lo + b;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < WBN / 16; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) are[i][j][e] = aim[i][j][e] = 0.f;
    }
    if (tma_w && q == 0) sm90::mbar_wait(w_bar, 0);
    // Stage 1: tile-FFT of the warp's channel (tiles 8 j + gq) into X~
    {
      const typename Path::Blk blk = io.block(bx, tid);
      const typename Path::FftCol fcol[2] = {
          io.fft_col(blk, warp * BP + gq, tq),
          io.fft_col(blk, warp * BP + 8 + gq, tq)};
      float c[2][4];
      tile_fft<WS_FFT_UNROLL[std::is_same<Path, HaloWsPath>::value]>(
          io, sx, s_soff, fcol, s_da, S, lane, tq, c);
      store_xf(s_xr, s_xi, c, warp, gq, tq);
    }
    __syncthreads();    // X~ written
    // Stage 2: complex Hadamard of bin hf against step s's planes
    {
      const float* pw = planes + s * 2 * W_WPLANE;
      uint32_t brh[2][2], brl[2][2], bih[2][2], bil[2][2];
      load_xf(s_xr, s_xi, hf, gq, tq, brh, brl, bih, bil);
      hadamard_mma<WBN>(pw, pw + W_WPLANE, hf, gq, tq, brh, brl, bih, bil,
                        are, aim);
    }
    if (s < n_steps - 1) continue;

    // Stage 3: the rectangle's epilogue: every peer is done with its X~
    // (the gather buffer's place), the warps push their bin's Y~ to the
    // finishing ranks, the cluster meets, and each rank takes the IFFT of
    // its n-tiles ct = rank + C i and stores them.  The cluster rank, m
    // range and n block are read again here rather than kept live through
    // the steps (no spill at 255 registers).
    sm90::cluster_arrive();
    const int rank = sm90::fresh_cluster_rank();
    const int n_ranks = sm90::fresh_cluster_size();
    const int g = sm90::fresh_cta_z() / n_ranks;
    const int n0 = sm90::fresh_cta_y() * WBN;
    const typename Path::Blk blk = io.block(bx, tid);
    const int lc = ws_lc(n_ranks), G = gridDim.z / n_ranks;
    const int slots = io.blocks() * BP;
    sm90::cluster_wait();
    push_ytilde<0, WBN / 16>(cluster, s_rv, rank, n_ranks, lc, hf, gq, tq,
                             are, aim);
    cluster.sync();     // every chunk's Y~ of this rank's n-tiles is here
    gather_ifft<1, true, WS_IFFT_UNROLL>(
        s_rv, lc, s_dv, S2, 0, n_ranks,
        (WS_NT - rank + n_ranks - 1) / n_ranks, S2, warp, gq, tq,
        [&](int i, int s2, int col, float v) {
          const int ct = rank + n_ranks * i;
          const int gn = n0 + ct / 2;
          if (gn >= N) return;
          const int pp = (ct % 2) * 8 + col;
          if (G > 1) {
            ws[(((size_t)g * S2 + s2) * N + gn) * slots + bx * BP + pp] = v;
            return;
          }
          const long long o = io.out_at(blk, s2, gn, N, pp);
          if (o >= 0) {
            v += bias[gn];
            if constexpr (SC == SC_GLOBAL) v += sc[o];
            if (relu) v = fmaxf(v, 0.f);
            y[o] = v;
          }
        });
    __syncthreads();    // the gather is read: the next block's X~ may land
  }
}

// The launch attributes shared by every kernel: a cluster over the bin
// chunks along z.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, int chunks,
                void* stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = chunks;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A 3-D f32 tensor map (dims innermost first, strides in bytes of dims 1
// and 2) with boxes `box` and the given swizzle; false where the driver
// refuses it.
bool tensor_map_3d(CUtensorMap* map, const void* base,
                   const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                   const cuuint32_t (&box)[3], CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = sm90::tensor_map_encoder();
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The windows xt [S][M][P] (rows at x_pitch) as boxes (BP tiles, all S
// rows, BM channels): they land as [BM][S][BP] with the 64-byte swizzle.
bool window_map(CUtensorMap* map, const float* xt, int P, int S, int M,
                int x_pitch) {
  return tensor_map_3d(map, xt, {(cuuint64_t)P, (cuuint64_t)S,
                                 (cuuint64_t)M},
                       {(cuuint64_t)M * x_pitch * 4, (cuuint64_t)x_pitch * 4},
                       {BP, (cuuint32_t)S, BM},
                       CU_TENSOR_MAP_SWIZZLE_64B);
}

// A kernel plane [Fa][N][M] as boxes (BM channels, `rows` output
// channels, FC bins): they land as [FC][rows][BM] with the 32-byte swizzle
// (a row's two 16-byte chunks swapped where n & 4).
bool plane_map(CUtensorMap* map, const float* w, int M, int N, int Fa,
               int rows) {
  return tensor_map_3d(map, w, {(cuuint64_t)M, (cuuint64_t)N,
                                (cuuint64_t)Fa},
                       {(cuuint64_t)M * 4, (cuuint64_t)N * M * 4},
                       {BM, (cuuint32_t)rows, FC},
                       CU_TENSOR_MAP_SWIZZLE_32B);
}

// The TMA maps of a plane launch: windows (windowed path, rows 16-byte
// aligned) and planes (M % 4 == 0, 16-byte aligned; boxes of `rows` output
// channels) by TMA, the rest by the copies, which write the same layouts;
// false where the CUDA driver API refuses a map.
template <class Path>
bool os_maps(const Path& io, const float* wr, const float* wi, int S, int M,
             int N, int Fa, OsMaps& maps, int& tma_x, int& tma_w,
             int rows = BN) {
  maps = {};
  tma_x = tma_w = 0;
  if constexpr (std::is_same<Path, WindowedPath>::value)
    if (io.x_pitch % 4 == 0 && aligned16(io.xt)) {
      if (!window_map(&maps.x, io.xt, io.P, S, M, io.x_pitch)) return false;
      tma_x = 1;
    }
  if (M % 4 == 0 && aligned16(wr) && aligned16(wi)) {
    if (!plane_map(&maps.wr, wr, M, N, Fa, rows) ||
        !plane_map(&maps.wi, wi, M, N, Fa, rows))
      return false;
    tma_w = 1;
  }
  return true;
}

// Configure and launch one output-stationary layer on `stream` over m
// ranges of RM channels (a multiple of BM, or M for one range) and, with
// more than one range, the split-K finish pass; returns the cudaError_t of
// the configuration and the launches (0 on success).  A shape whose shared
// memory exceeds the per-block limit fails cudaFuncSetAttribute.
template <class Path, int SC>
int launch_os(const Path& io, const float* wr, const float* wi,
              const float* dfr, const float* dfi, const float* dvr,
              const float* dvi, const float* bias, const float* sc, float* y,
              float* ws, int S, int M, int Fa, int N, int S2, int relu,
              int RM, int CL, void* stream) {
  if (RM >= M) RM = M;
  if (RM < 1 || (RM < M && RM % BM != 0)) return (int)cudaErrorInvalidValue;
  const int G = (M + RM - 1) / RM;
  const int chunks = (Fa + FC - 1) / FC;
  if (CL < 1 || chunks % CL != 0 || S2 > 16 * MT2_MAX)
    return (int)cudaErrorInvalidValue;
  const int slices = G * (chunks / CL);
  if ((slices > 1 && (ws == nullptr || SC == SC_STAGED)) ||
      (long long)chunks * G > 65535)
    return (int)cudaErrorInvalidValue;
  // a staged shortcut: ceil(S2 / C) rows of the CTA's rectangle
  const OsLayout L(S, S2, io.x_floats(S),
                   SC == SC_STAGED ? (S2 + chunks - 1) / chunks * BN * BP
                                   : 0);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_os_kernel<Path, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // TMA for the windows and the planes where their rows are 16-byte
  // aligned (the copies load the rest into the same layout; aligned
  // planes: TMA or no launch, so the kernel's 16-byte plane copies are
  // unreachable)
  OsMaps maps;
  int tma_x, tma_w;
  if (!os_maps(io, wr, wi, S, M, N, Fa, maps, tma_x, tma_w))
    return (int)cudaErrorInvalidValue;
  const int nb = (N + BN - 1) / BN;
  ClusterLaunch cl(dim3(io.blocks(), nb, chunks * G), ONT, smem, CL, stream);
  err = cudaLaunchKernelEx(&cl.cfg, fused_os_kernel<Path, SC>, io, wr, wi,
                           dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M, Fa, N,
                           S2, relu, RM, maps, tma_x, tma_w);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (SC != SC_STAGED)
    if (slices > 1)
      err = launch_finish<Path, BP, SC>(io, ws, bias, sc, y, slices, S2, N,
                                        io.blocks() * BP, relu,
                                        (cudaStream_t)stream);
  return (int)err;
}

// The most clusters of `cluster` output-stationary CTAs (one an SM) the
// card runs at once: clusters stay within a GPC, so the SMs a size fills
// depend on it (cudaOccupancyMaxActiveClusters).
int os_max_clusters(int cluster, int* count) {
  const void* kernel = (const void*)fused_os_kernel<WindowedPath, SC_NONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(dim3(1, 1, cluster), ONT, SMEM_MAX, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cl.cfg);
}

// The same for the input-stationary kernel's clusters of `cluster` CTAs.
int is_max_clusters(int cluster, int* count) {
  const void* kernel = (const void*)fused_is_kernel<WindowedPath, SC_NONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(dim3(1, 1, cluster), ONT, SMEM_MAX, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cl.cfg);
}

// The same for the weight-stationary kernel's clusters of `cluster` CTAs.
int ws_max_clusters(int cluster, int* count) {
  const void* kernel = (const void*)fused_ws_kernel<WindowedPath, SC_NONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(dim3(1, 1, cluster), ONT, SMEM_MAX, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cl.cfg);
}

// Configure and launch one weight- / input-stationary layer on `stream`
// (and, with more than one slice, the split-K finish pass), as above, over
// G m ranges of RM channels (a multiple of BM): ws with a cluster over all
// bin chunks and chunks of `split` tile blocks a CTA; is over G x chunks /
// `split` bin groups (clusters of `split` chunks, dividing them).
template <class Path, int FLOW, int SC>
int launch_flow(const Path& io, const float* wr, const float* wi,
                const float* dfr, const float* dfi, const float* dvr,
                const float* dvi, const float* bias, const float* sc,
                float* y, float* ws, int S, int M, int Fa, int N, int S2,
                int relu, int RM, int split, void* stream) {
  if (RM < BM || RM % BM != 0 || S2 > 16 * MT2_MAX || split < 1)
    return (int)cudaErrorInvalidValue;
  const int G = (M + RM - 1) / RM;
  const int chunks = (Fa + FC - 1) / FC;
  const int CL = FLOW == WS ? chunks : split;
  if (chunks % CL != 0 || (long long)G * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const int slices = G * (chunks / CL);
  if (slices > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int nb = (N + WBN - 1) / WBN;      // the ws launch's n blocks
  OsMaps maps;
  int tma_x, tma_w;
  if (!os_maps(io, wr, wi, S, M, N, Fa, maps, tma_x, tma_w,
               FLOW == WS ? WBN : BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (FLOW == IS) {
    const IsLayout L(S, S2, io.x_floats(S), RM);
    const size_t smem = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_is_kernel<Path, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ClusterLaunch cl(dim3(io.blocks(), G, chunks), ONT, smem, CL, stream);
    err = cudaLaunchKernelEx(&cl.cfg, fused_is_kernel<Path, SC>, io, wr, wi,
                             dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M, Fa,
                             N, S2, relu, RM, maps, tma_x, tma_w);
  } else {
    const WsLayout L(S, S2, io.x_floats(S), RM);
    const size_t smem = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_ws_kernel<Path, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int cx = (io.blocks() + split - 1) / split;
    ClusterLaunch cl(dim3(cx, nb, G * chunks), ONT, smem, chunks, stream);
    err = cudaLaunchKernelEx(&cl.cfg, fused_ws_kernel<Path, SC>, io, wr, wi,
                             dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M, Fa,
                             N, S2, relu, RM, split, maps, tma_x, tma_w);
  }
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (slices > 1)
    err = launch_finish<Path, BP, SC>(io, ws, bias, sc, y, slices, S2, N,
                                      io.blocks() * BP, relu,
                                      (cudaStream_t)stream);
  return (int)err;
}

// The instantiation for the shortcut's placement, chosen on the host (and
// `split`: the output- and input-stationary launches' cluster size, the
// weight-stationary one's tile blocks a CTA): none (sc null), global, or
// staged (output-stationary with one slice: the
// wrapper asks for it only then; a split launch's finish pass reads the
// shortcut globally, so a staged request there is refused).
template <class Path, int FLOW>
int dispatch(const Path& io, const float* wr, const float* wi,
             const float* dfr, const float* dfi, const float* dvr,
             const float* dvi, const float* bias, const float* sc, float* y,
             float* ws, int S, int M, int Fa, int N, int S2, int relu,
             int RM, int split, int sc_staged, void* stream) {
  if (sc == nullptr && sc_staged) return (int)cudaErrorInvalidValue;
  if constexpr (FLOW == OS) {
    if (sc == nullptr)
      return launch_os<Path, SC_NONE>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                      split, stream);
    if (!sc_staged)
      return launch_os<Path, SC_GLOBAL>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                        sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                        split, stream);
    return launch_os<Path, SC_STAGED>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                      split, stream);
  } else {
    if (sc_staged) return (int)cudaErrorInvalidValue;
    if (sc == nullptr)
      return launch_flow<Path, FLOW, SC_NONE>(io, wr, wi, dfr, dfi, dvr, dvi,
                                              bias, sc, y, ws, S, M, Fa, N,
                                              S2, relu, RM, split, stream);
    return launch_flow<Path, FLOW, SC_GLOBAL>(io, wr, wi, dfr, dfi, dvr, dvi,
                                              bias, sc, y, ws, S, M, Fa, N,
                                              S2, relu, RM, split, stream);
  }
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
             int S2, int relu, int RM, int split, int sc_staged,
             void* stream) {
  if (!windowed_ok(S, M, P, x_pitch, Fa, N, S2))
    return (int)cudaErrorInvalidValue;
  return dispatch<WindowedPath, FLOW>(WindowedPath{xt, P, x_pitch}, wr, wi,
                                      dfr, dfi, dvr, dvi, bias, sc, y, ws, S,
                                      M, Fa, N, S2, relu, RM, split, sc_staged,
                                      stream);
}

template <int FLOW>
int halo(const float* x, const float* wr, const float* wi, const float* dfr,
         const float* dfi, const float* dvr, const float* dvi,
         const float* bias, const float* sc, float* y, float* ws, int B,
         int M, int H, int W, int K, int ksize, int pad, int n_th, int n_tw,
         int bth, int btw, int nbh, int nbw, int pre, int band, int Fa,
         int N, int S2, int relu, int RM, int split, int sc_staged,
         void* stream) {
  // the weight-stationary kernel's own halo staging (HaloWsPath)
  typename std::conditional<FLOW == WS, HaloWsPath, HaloOs>::type io{};
  io.x = x;
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > BP || S2 != io.g.t * io.g.t || Fa < 1 ||
      Fa > MAX_CLUSTER * FC || N < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<decltype(io), FLOW>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, K * K, M, Fa, N, S2, relu,
                                      RM, split, sc_staged, stream);
}

}  // namespace

extern "C" {

// Every entry point: `sc`, the optional residual shortcut laid out like y
// (null for none), and `sc_staged` (output-stationary only: stage it in
// shared memory; 0 reads it at the flush).

// Windowed layer.  Fa is at most 8 * FSC_FC (ceil(Fa / FSC_FC) bin
// chunks); xt's rows of P floats lie x_pitch floats apart; sc is
// [S2, N, P]; the caller checks shapes, devices and layouts.  M is summed
// in ranges of RM channels (a multiple of FSC_BM; RM >= M: one range) and
// the chunks in clusters of CL CTAs (CL divides the chunks); with
// S = ceil(M / RM) * chunks / CL > 1 slices, ws is a workspace of
// S * S2 * N * ceil(P / FSC_BP) * FSC_BP floats.
int fused_spectral_pipeline_f32(const float* xt, const float* wr,
                                const float* wi, const float* dfr,
                                const float* dfi, const float* dvr,
                                const float* dvi, const float* bias,
                                float* y, const float* sc, float* ws, int S,
                                int M, int P, int x_pitch, int Fa, int N,
                                int S2, int relu, int RM, int CL,
                                int sc_staged, void* stream) {
  return windowed<OS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                      P, x_pitch, Fa, N, S2, relu, RM, CL, sc_staged, stream);
}

// Windowed layer, weight- / input-stationary over m ranges of RM channels
// (a multiple of FSC_BM).  Weight-stationary: `per` tile blocks a CTA
// (fsc.ws_launch_geometry).  With G = ceil(M / RM) > 1 ranges, ws is a
// workspace of G * S2 * N * ceil(P / FSC_BP) * FSC_BP floats.
int fused_spectral_pipeline_ws_f32(const float* xt, const float* wr,
                                   const float* wi, const float* dfr,
                                   const float* dfi, const float* dvr,
                                   const float* dvi, const float* bias,
                                   float* y, const float* sc, float* ws,
                                   int S, int M, int P, int x_pitch, int Fa,
                                   int N, int S2, int relu, int RM, int per,
                                   int sc_staged, void* stream) {
  return windowed<WS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                      P, x_pitch, Fa, N, S2, relu, RM, per, sc_staged,
                      stream);
}

// Input-stationary: the chunks in clusters of CL CTAs (CL divides them);
// with S = G * chunks / CL > 1 slices, ws holds S * S2 * N * ceil(P /
// FSC_BP) * FSC_BP floats.
int fused_spectral_pipeline_is_f32(const float* xt, const float* wr,
                                   const float* wi, const float* dfr,
                                   const float* dfi, const float* dvr,
                                   const float* dvi, const float* bias,
                                   float* y, const float* sc, float* ws,
                                   int S, int M, int P, int x_pitch, int Fa,
                                   int N, int S2, int relu, int RM, int CL,
                                   int sc_staged, void* stream) {
  return windowed<IS>(xt, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M,
                      P, x_pitch, Fa, N, S2, relu, RM, CL, sc_staged, stream);
}

// Halo layer: x [B, M, H, W] contiguous, y and sc [B, N, H_out, W_out]; the
// tile grid (n_th x n_tw, spectral.make_geometry) in blocks of bth x btw <=
// FSC_BP tiles (spectral.halo_block_geometry), one CTA per (image, block).
// Band mode (band = 1): x is a shard's extended band whose first pre = k - 1
// rows are its top halo, and y is the uncropped band canvas
// [B, N, n_th*t, n_tw*t] (halo.cuh); pre = band = 0 is the plain layer.
// M in ranges of RM channels and the chunks in clusters of CL CTAs as
// above; ws (more than one slice) holds
// slices * S2 * N * B * nbh * nbw * FSC_BP floats.
int fused_spectral_pipeline_halo_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, float* ws, int B, int M, int H, int W, int K,
    int ksize, int pad, int n_th, int n_tw, int bth, int btw, int nbh,
    int nbw, int pre, int band, int Fa, int N, int S2, int relu, int RM,
    int CL, int sc_staged, void* stream) {
  return halo<OS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, B, M, H,
                  W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre, band,
                  Fa, N, S2, relu, RM, CL, sc_staged, stream);
}

// Halo layer, weight- / input-stationary (ws: `per` halo blocks a CTA);
// ws (G > 1) holds G * S2 * N * B * nbh * nbw * FSC_BP floats.
int fused_spectral_pipeline_halo_ws_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, float* ws, int B, int M, int H, int W, int K,
    int ksize, int pad, int n_th, int n_tw, int bth, int btw, int nbh,
    int nbw, int pre, int band, int Fa, int N, int S2, int relu, int RM,
    int per, int sc_staged, void* stream) {
  return halo<WS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, B, M, H,
                  W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre, band,
                  Fa, N, S2, relu, RM, per, sc_staged, stream);
}

int fused_spectral_pipeline_halo_is_f32(
    const float* x, const float* wr, const float* wi, const float* dfr,
    const float* dfi, const float* dvr, const float* dvi, const float* bias,
    float* y, const float* sc, float* ws, int B, int M, int H, int W, int K,
    int ksize, int pad, int n_th, int n_tw, int bth, int btw, int nbh,
    int nbw, int pre, int band, int Fa, int N, int S2, int relu, int RM,
    int CL, int sc_staged, void* stream) {
  return halo<IS>(x, wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, B, M, H,
                  W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw, pre, band,
                  Fa, N, S2, relu, RM, CL, sc_staged, stream);
}

// The most clusters of `cluster` output-stationary CTAs the card runs at
// once, into *count (the wrapper sizes its launch geometry by it).
int fused_spectral_pipeline_os_max_clusters(int cluster, int* count) {
  return os_max_clusters(cluster, count);
}

// The same for the input-stationary kernel (is_launch_geometry reads it).
int fused_spectral_pipeline_is_max_clusters(int cluster, int* count) {
  return is_max_clusters(cluster, count);
}

// The same for the weight-stationary kernel (ws_launch_geometry reads it).
int fused_spectral_pipeline_ws_max_clusters(int cluster, int* count) {
  return ws_max_clusters(cluster, count);
}

}  // extern "C"
