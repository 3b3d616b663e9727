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
// input-stationary kernel's.  The weight-stationary flow keeps the expand
// pass into a [S][BM][BP] window stage.  Its bound is B1's operations on
// the real tiles and the raw activation read once; idle slots (blocks past
// the tile grid, 3x3-tile blocks in 16 slots) cost time, not bytes.
//
// The weight- and input-stationary flows (entry points *_ws_f32 and
// *_is_f32, windowed and halo; replacing the TPU bodies `_kernel_ws` (:571)
// and `_kernel_is` (:591) of src/repro/kernels/fused_spectral_conv.py with
// their psum read-modify-write `_dma_rmw_start` (:487) / `_dma_rmw_finish`
// (:497)) compute the same function with another reuse.  A flow CTA owns
// one m range of RM input channels (RM a multiple of FSC_BM; G = ceil(M /
// RM) ranges) and one bin chunk of a cluster, as above:
//  * weight-stationary (reuse kernels; on the CUDA cores, f32 FMAs, TN
//    outputs x FC bins a thread): CTA = (m range, n block, chunk).  It
//    copies its plane block [FC][BN][RM] into shared memory once and walks
//    every tile block with it, so each plane element is read from device
//    memory once per layer.  Windows are re-read once per n block.
//  * input-stationary (reuse activations; `fused_is_kernel`, B1's
//    tensor-core design): CTA = (tile block, m range, chunk).  It computes
//    X~ of its windows for the whole m range once into shared memory
//    ([FC][RM][BP], the tile-FFT in 3xTF32 MMAs, the windows by TMA through
//    a three-stage mbarrier ring) and walks every n block, streaming its
//    planes by TMA boxes through the same ring into B1's Hadamard, IFFT and
//    cluster reduction; each tile-FFT is computed once per tile block.
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
#include <type_traits>

#include "cp_async.cuh"
#include "halo.cuh"
#include "mma_tf32.cuh"
#include "shortcut.cuh"
#include "sm90.cuh"
#include "split_k.cuh"

#if !defined(FSC_BN) || !defined(FSC_BP) || !defined(FSC_BM) || \
    !defined(FSC_FC) || !defined(FSC_THREADS) || !defined(FSC_OS_STAGES) || \
    !defined(FSC_OS_THREADS)
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

// Shared-memory carve-up of the weight-stationary kernel, in floats.  A
// ring stage holds the step's input (windows, or a halo block's raw rows);
// the halo path also expands the raw rows into one window stage.  The
// spatial partial of an output rectangle aliases the ring (and the window
// stage).
struct Layout {
  int df, dv, xf, res, stage, x_sz, x_stage, win, total;
  __host__ __device__ Layout(int S, int S2, int x_floats, int win_floats,
                             int RM) {
    df = 0;                                  // [S][FC] (re, im)
    dv = df + 2 * S * FC;                    // [S2][FC] (re, im)
    xf = dv + 2 * S2 * FC;                   // X~ (re, im): [FC][MP]
    res = xf + 2 * FC * MP;
    stage = res + 2 * FC * BN * RM;          // wr, wi [FC][BN][RM] of the
                                             // m range
    x_sz = align4(x_floats);
    x_stage = x_sz;
    win = stage + 2 * x_stage;               // [S][MP] expanded windows
    const int loop = 2 * x_stage + win_floats;
    const int acc = S2 * BN * BP;            // spatial partial, aliases both
    total = stage + imax(loop, acc);
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

using HaloIn = HaloPath<NT, BM, BP>;   // halo.cuh: the flows'
using HaloOs = HaloPath<ONT, BM, BP>;  // and the output-stationary kernel's

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
  const int ks = (S + 7) / 8, mt2 = (S2 + 15) / 16;

  // The tile-FFT's A: row r < 8 is Re Df[f0 + r], r >= 8 Im Df[f0 + r - 8],
  // column s; the IFFT's A: row s2, column k < 8 Re Dv[s2][f0 + k], k >= 8
  // -Im Dv[s2][f0 + k - 8].  Both split to TF32 (hi, lo) once, stored in
  // fragment order [k step][lane][a0..a3], zero outside the chunk, S, S2.
  // The FFT's k index within a step of 8 window rows is permuted (k ->
  // fft_row(k)), in A here and in B where the FFT reads the windows, so
  // that the swizzled window stage reads conflict-free.
  for (int i = tid; i < ks * 128; i += ONT) {
    const int kk = i / 128, ln = (i / 4) % 32, e = i % 4;
    const int r = ln / 4 + (e & 1) * 8;
    const int s = kk * 8 + fft_row(ln % 4 + (e & 2) * 2);
    const int f = r % 8;
    float x = 0.f;
    if (f < fc && s < S) x = (r < 8 ? dfr : dfi)[(size_t)(f0 + f) * S + s];
    split(x, s_da[i], s_da[ks * 128 + i]);
  }
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
  const int k_lo = tq ^ (gq & 4), k_hi = (tq + 4) ^ (gq & 4);
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

    // Stage 1: tile-FFT of the warp's channel; C rows gq: Re X~ of bin gq,
    // gq + 8: Im, at tiles 8 j + 2 tq (+1)
    {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint4* ah4 = reinterpret_cast<const uint4*>(s_da);
      const uint4* al4 = reinterpret_cast<const uint4*>(s_da + ks * 128);
#pragma unroll 2
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = gq * XFP + warp * XP + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(s_xr + o) = make_float2(c[j][0], c[j][1]);
        *reinterpret_cast<float2*>(s_xi + o) = make_float2(c[j][2], c[j][3]);
      }
    }
    __syncthreads();    // X~ written

    // Stage 2: complex Hadamard of bin hf over the step's BM channels:
    // A = W[hf] rows (n), k = m; B = X~[hf] (k = m, columns p)
    {
      const float* swr = sx + L.x_sz;
      const float* swi = swr + W_PLANE;
      uint32_t brh[2][2], brl[2][2], bih[2][2], bil[2][2];
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        const int o = hf * XFP + tq * XP + pt * 8 + gq;
        const float br[2] = {s_xr[o], s_xr[o + 4 * XP]};
        const float bi[2] = {s_xi[o], s_xi[o + 4 * XP]};
        split_frag(br, brh[pt], brl[pt]);
        split_frag(bi, bih[pt], bil[pt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = (hf * BN + mt * 16 + gq) * BM;
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
  const int ks = (S + 7) / 8, mt2 = (S2 + 15) / 16;
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // the cluster's bin group (clusters of C consecutive chunks) and the
  // workspace slice of (m range, bin group)
  const int H = gridDim.z / n_ranks, hg = blockIdx.z / n_ranks;
  const int slice = r * H + hg, slices = G * H;

  // the FFT's A fragments, as fused_os_kernel splits them
  for (int i = tid; i < ks * 128; i += ONT) {
    const int kk = i / 128, ln = (i / 4) % 32, e = i % 4;
    const int rr = ln / 4 + (e & 1) * 8;
    const int s = kk * 8 + fft_row(ln % 4 + (e & 2) * 2);
    const int f = rr % 8;
    float x = 0.f;
    if (f < fc && s < S) x = (rr < 8 ? dfr : dfi)[(size_t)(f0 + f) * S + s];
    split(x, s_da[i], s_da[ks * 128 + i]);
  }
  // the IFFT's A over every bin: row s2 of part h Dvr (h = 0) or -Dvi,
  // zero past S2 and Fa
  for (int i = tid; i < 2 * 16 * mt2 * IS_DVP; i += ONT) {
    const int h = i / (16 * mt2 * IS_DVP), rw = i % (16 * mt2 * IS_DVP);
    const int s2 = rw / IS_DVP, f = rw % IS_DVP;
    s_dv[i] = s2 < S2 && f < Fa
                  ? (h ? -dvi[(size_t)s2 * Fa + f] : dvr[(size_t)s2 * Fa + f])
                  : 0.f;
  }
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
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint4* ah4 = reinterpret_cast<const uint4*>(s_da);
      const uint4* al4 = reinterpret_cast<const uint4*>(s_da + ks * 128);
#pragma unroll 2
      for (int kk = 0; kk < ks; ++kk) {
        const uint4 h = ah4[kk * 32 + lane], l = al4[kk * 32 + lane];
        const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
        const uint32_t al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float b[2] = {
              io.fft_x(st, s_soff, fcol[j], kk * 8 + fft_row(tq), S),
              io.fft_x(st, s_soff, fcol[j], kk * 8 + fft_row(tq + 4), S)};
          uint32_t bh[2], bl[2];
          split_frag(b, bh, bl);
          mma3_f32(c[j], ah, al, bh, bl);
        }
      }
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
      const float* swr = st;
      const float* swi = swr + W_PLANE;
      const int k_lo = tq ^ (gq & 4), k_hi = (tq + 4) ^ (gq & 4);
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
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = (hf * BN + mt * 16 + gq) * BM;
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
        for (int pt = 0; pt < 2; ++pt) {    // this step's sum, f32 adds
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
    if (s < n_steps - 1) continue;

    // Stage 3: the n block's epilogue.  Every peer is done with its gather
    // buffer (its FFT, or the previous n block's gather: wait); the warp
    // pushes its bin's Y~ (row hf re, 8 + hf im) of each n-tile into the
    // buffer of the rank that finishes it, and the cluster meets.
    sm90::cluster_wait();
    const int lc_n = is_lc(n_ranks);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const int ct = (mt * 16 + gq + 8 * hh) * 2 + pt;   // its n-tile
          float* dst = cluster.map_shared_rank(s_rv, ct % n_ranks) +
                       rank * 16 * lc_n;
          const int lc = (ct / n_ranks) * 8 + 2 * tq;
          *reinterpret_cast<float2*>(dst + hf * lc_n + lc) =
              make_float2(are[mt][pt][2 * hh], are[mt][pt][2 * hh + 1]);
          *reinterpret_cast<float2*>(dst + (8 + hf) * lc_n + lc) =
              make_float2(aim[mt][pt][2 * hh], aim[mt][pt][2 * hh + 1]);
        }
    cluster.sync();     // every chunk's Y~ of this rank's n-tiles is here

    // the valid-row IFFT of the rank's n-tiles ct = rank + C i (columns
    // 8 ct .., n = ct / 2), warp w two of them at a time: partial[s2][col]
    // = sum over the source chunks q (rank order) of Re/Im bins 8 q ..
    const int slots = io.blocks() * BP;
    const int n_cts = (IS_NT - rank + n_ranks - 1) / n_ranks;
    for (int i0 = 2 * warp; i0 < n_cts; i0 += 2 * WARPS) {
      const bool two = i0 + 1 < n_cts;
      float d[MT2_MAX][2][4];
#pragma unroll
      for (int a = 0; a < MT2_MAX; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[a][j][e] = 0.f;
#pragma unroll 1
      for (int kq = 0; kq < 2 * n_ranks; ++kq) {   // (source, re / im)
        const int cq = kq / 2, h = kq % 2;
        const float* rb = s_rv + (cq * 16 + h * 8 + tq) * lc_n;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int lc = (i0 + (two ? j : 0)) * 8 + gq;
          const float b[2] = {rb[lc], rb[4 * lc_n + lc]};
          split_frag(b, bh[j], bl[j]);
        }
        const float* av =
            s_dv + h * 16 * mt2 * IS_DVP + (hg * n_ranks + cq) * FC + tq;
#pragma unroll
        for (int m2 = 0; m2 < MT2_MAX; ++m2) {
          if (m2 >= mt2) break;
          const float* ar = av + (m2 * 16 + gq) * IS_DVP;
          const float a[4] = {ar[0], ar[8 * IS_DVP], ar[4],
                              ar[8 * IS_DVP + 4]};
          uint32_t ah[4], al[4];
          split_frag(a, ah, al);
#pragma unroll
          for (int j = 0; j < 2; ++j) mma3_f32(d[m2][j], ah, al, bh[j],
                                               bl[j]);
        }
      }
      // the finished columns: output or workspace slice r
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
        const int ct = rank + n_ranks * (i0 + j);
        const int n = ct / 2, gn = n0 + n;
        if (gn >= N) continue;
#pragma unroll
        for (int m2 = 0; m2 < MT2_MAX; ++m2) {
          if (m2 >= mt2) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s2 = m2 * 16 + gq + (e >> 1) * 8;
            const int pp = (ct % 2) * 8 + 2 * tq + (e & 1);
            if (s2 >= S2) continue;
            float v = d[m2][j][e];
            if (slices > 1) {
              ws[(((size_t)slice * S2 + s2) * N + gn) * slots +
                 blockIdx.x * BP + pp] = v;
              continue;
            }
            const long long o = io.out_at(blk, s2, gn, N, pp);
            if (o >= 0) {
              v += bias[gn];
              if constexpr (SC == SC_GLOBAL) v += sc[o];
              if (relu) v = fmaxf(v, 0.f);
              y[o] = v;
            }
          }
        }
      }
    }
    sm90::cluster_arrive();   // this CTA's gather buffer is read
  }
  sm90::cluster_wait();     // no CTA exits while a peer may still push
}

// The weight-stationary flow (FLOW == WS) on either input path (Path), on
// the CUDA cores.  Grid (m range, n block, chunk); a cluster spans the
// chunks.  ws (the split-K workspace) is written only when the flow has
// more than one m range.  SC: none or a global shortcut, added here with
// one m range, else by the finish pass.
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
  static_assert(FLOW == WS, "output- and input-stationary: above");
  static_assert(SC == SC_NONE || SC == SC_GLOBAL, "staged: os only");
  extern __shared__ __align__(16) float smem[];
  const Layout L(S, S2, io.x_floats(S), 0, RM);
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
  const int G = gridDim.x, r = blockIdx.x;
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

  {
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

// A kernel plane [Fa][N][M] as boxes (BM channels, BN rows, FC bins): they
// land as [FC][BN][BM] with the 32-byte swizzle (a row's two 16-byte
// chunks swapped where n & 4).
bool plane_map(CUtensorMap* map, const float* w, int M, int N, int Fa) {
  return tensor_map_3d(map, w, {(cuuint64_t)M, (cuuint64_t)N,
                                (cuuint64_t)Fa},
                       {(cuuint64_t)M * 4, (cuuint64_t)N * M * 4},
                       {BM, BN, FC}, CU_TENSOR_MAP_SWIZZLE_32B);
}

// The TMA maps of a plane launch: windows (windowed path, rows 16-byte
// aligned) and planes (M % 4 == 0, 16-byte aligned) by TMA, the rest by
// the copies, which write the same layouts; false where the CUDA
// driver API refuses a map.
template <class Path>
bool os_maps(const Path& io, const float* wr, const float* wi, int S, int M,
             int N, int Fa, OsMaps& maps, int& tma_x, int& tma_w) {
  maps = {};
  tma_x = tma_w = 0;
  if constexpr (std::is_same<Path, WindowedPath>::value)
    if (io.x_pitch % 4 == 0 && aligned16(io.xt)) {
      if (!window_map(&maps.x, io.xt, io.P, S, M, io.x_pitch)) return false;
      tma_x = 1;
    }
  if (M % 4 == 0 && aligned16(wr) && aligned16(wi)) {
    if (!plane_map(&maps.wr, wr, M, N, Fa) ||
        !plane_map(&maps.wi, wi, M, N, Fa))
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

// Configure and launch one weight- / input-stationary layer on `stream`
// (and, with more than one slice, the split-K finish pass), as above: ws
// over G m ranges (a cluster over all bin chunks); is over G m ranges x
// chunks / CL bin groups (clusters of CL chunks, CL dividing them).
template <class Path, int FLOW, int SC>
int launch_flow(const Path& io, const float* wr, const float* wi,
                const float* dfr, const float* dfi, const float* dvr,
                const float* dvi, const float* bias, const float* sc,
                float* y, float* ws, int S, int M, int Fa, int N, int S2,
                int relu, int RM, int CL, void* stream) {
  if (RM < BM || RM % BM != 0) return (int)cudaErrorInvalidValue;
  const int G = (M + RM - 1) / RM;
  const int chunks = (Fa + FC - 1) / FC;
  if (FLOW == WS) CL = chunks;
  if (CL < 1 || chunks % CL != 0) return (int)cudaErrorInvalidValue;
  const int slices = G * (chunks / CL);
  if (slices > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int nb = (N + BN - 1) / BN;
  cudaError_t err;
  if constexpr (FLOW == IS) {
    if (S2 > 16 * MT2_MAX) return (int)cudaErrorInvalidValue;
    const IsLayout L(S, S2, io.x_floats(S), RM);
    const size_t smem = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_is_kernel<Path, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    OsMaps maps;
    int tma_x, tma_w;
    if (!os_maps(io, wr, wi, S, M, N, Fa, maps, tma_x, tma_w))
      return (int)cudaErrorInvalidValue;
    ClusterLaunch cl(dim3(io.blocks(), G, chunks), ONT, smem, CL, stream);
    err = cudaLaunchKernelEx(&cl.cfg, fused_is_kernel<Path, SC>, io, wr, wi,
                             dfr, dfi, dvr, dvi, bias, sc, y, ws, S, M, Fa,
                             N, S2, relu, RM, maps, tma_x, tma_w);
  } else {
    const Layout L(S, S2, io.x_floats(S), io.win_floats(S), RM);
    const size_t smem = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_flow_kernel<Path, FLOW, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ClusterLaunch cl(dim3(G, nb, chunks), NT, smem, chunks, stream);
    err = cudaLaunchKernelEx(&cl.cfg, fused_flow_kernel<Path, FLOW, SC>, io,
                             wr, wi, dfr, dfi, dvr, dvi, bias, sc, y, ws, S,
                             M, Fa, N, S2, relu, RM);
  }
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (slices > 1)
    err = launch_finish<Path, BP, SC>(io, ws, bias, sc, y, slices, S2, N,
                                      io.blocks() * BP, relu,
                                      (cudaStream_t)stream);
  return (int)err;
}

// The instantiation for the shortcut's placement, chosen on the host: none
// (sc null), global, or staged (output-stationary with one slice: the
// wrapper asks for it only then; a split launch's finish pass reads the
// shortcut globally, so a staged request there is refused).
template <class Path, int FLOW>
int dispatch(const Path& io, const float* wr, const float* wi,
             const float* dfr, const float* dfi, const float* dvr,
             const float* dvi, const float* bias, const float* sc, float* y,
             float* ws, int S, int M, int Fa, int N, int S2, int relu,
             int RM, int CL, int sc_staged, void* stream) {
  if (sc == nullptr && sc_staged) return (int)cudaErrorInvalidValue;
  if constexpr (FLOW == OS) {
    if (sc == nullptr)
      return launch_os<Path, SC_NONE>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                      CL, stream);
    if (!sc_staged)
      return launch_os<Path, SC_GLOBAL>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                        sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                        CL, stream);
    return launch_os<Path, SC_STAGED>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, S, M, Fa, N, S2, relu, RM,
                                      CL, stream);
  } else {
    if (sc_staged) return (int)cudaErrorInvalidValue;
    if (sc == nullptr)
      return launch_flow<Path, FLOW, SC_NONE>(io, wr, wi, dfr, dfi, dvr, dvi,
                                              bias, sc, y, ws, S, M, Fa, N,
                                              S2, relu, RM, CL, stream);
    return launch_flow<Path, FLOW, SC_GLOBAL>(io, wr, wi, dfr, dfi, dvr, dvi,
                                              bias, sc, y, ws, S, M, Fa, N,
                                              S2, relu, RM, CL, stream);
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
             int S2, int relu, int RM, int CL, int sc_staged, void* stream) {
  if (!windowed_ok(S, M, P, x_pitch, Fa, N, S2))
    return (int)cudaErrorInvalidValue;
  return dispatch<WindowedPath, FLOW>(WindowedPath{xt, P, x_pitch}, wr, wi,
                                      dfr, dfi, dvr, dvi, bias, sc, y, ws, S,
                                      M, Fa, N, S2, relu, RM, CL, sc_staged,
                                      stream);
}

template <int FLOW>
int halo(const float* x, const float* wr, const float* wi, const float* dfr,
         const float* dfi, const float* dvr, const float* dvi,
         const float* bias, const float* sc, float* y, float* ws, int B,
         int M, int H, int W, int K, int ksize, int pad, int n_th, int n_tw,
         int bth, int btw, int nbh, int nbw, int pre, int band, int Fa,
         int N, int S2, int relu, int RM, int CL, int sc_staged,
         void* stream) {
  // the tensor-core kernels (output- and input-stationary) run their own
  // thread count
  typename std::conditional<FLOW == WS, HaloIn, HaloOs>::type io{x, {}};
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > BP || S2 != io.g.t * io.g.t || Fa < 1 ||
      Fa > MAX_CLUSTER * FC || N < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<decltype(io), FLOW>(io, wr, wi, dfr, dfi, dvr, dvi, bias,
                                      sc, y, ws, K * K, M, Fa, N, S2, relu,
                                      RM, CL, sc_staged, stream);
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
                      P, x_pitch, Fa, N, S2, relu, RM, 0, sc_staged, stream);
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
                  Fa, N, S2, relu, RM, 0, sc_staged, stream);
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

}  // extern "C"
