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
// same function with another reuse, on the output-stationary kernel's
// pieces (`fused_sched_flow_kernel`, 512 threads, 8 tiles and one 32-lane
// half of a kernel group at a time, the psum [64 bins][32 lanes][8 tiles]
// in registers, the tile-FFT and the valid-row IFFT in 3xTF32, the tables
// expanded into W a channel).  A flow CTA owns one m range of RM input
// channels (G = ceil(M / RM) ranges), summed in ascending order, and no
// cluster:
//  * weight-stationary (reuse kernels): CTA = (chunk of tile blocks, group
//    half, m range).  It copies the compact table rows of its 32 lanes for
//    every channel of its range into shared memory once (idx [T][R], then
//    sel, vr, vi [T][32]: ~9 KB a channel at T = 21, R = 10) and walks
//    the tile blocks bx = chunk, chunk + chunks, ... of 8 tiles with them:
//    per block one channel step per channel (tile-FFT beside the
//    expansion of the resident rows into W, the MACs of the channel
//    before), windows through a cp.async ring that runs ahead across
//    channel steps and tile blocks.  The chunk count is the host's launch
//    rule (fsc.sched_flow_geometry), which fills the card: each table
//    entry is read from device memory once, then from L2 by the other
//    chunks.
//  * input-stationary (reuse activations): CTA = (tile block, m range, a
//    share of the group walk).  It computes X~ of its 8 tiles for every
//    channel of the range once (two channels a step, warps 0-7 and 8-15),
//    kept in shared memory ([RM][64 bins][8 tiles] complex, 4 KB a
//    channel), then walks its (kernel group, lane half) share: per channel
//    step the table rows arrive through the ring (which runs ahead across
//    the walk), all 512 threads expand them into W and run the MACs of the
//    channel before.  The host's launch rule splits the walk over Q CTAs
//    where tile blocks x ranges would not fill the card; each (group,
//    half) stays within one CTA, so no sum changes order.
// After each (tile block, group half) the psum goes through the valid-row
// IFFT on the tensor cores in four rounds: round b stages bin 4 w + b of
// every warp w (re and im, [32][YP], 33 KB) and runs its four k steps (A
// = [Dvr | -Dvi] in that k order, kept in f32 in fragment order and split
// as it is read).  is keeps the accumulators in registers across the
// rounds; ws, whose psum, FFT and resident tables leave fewer registers,
// sums each round into a partial in shared memory, one n-tile pass at a
// time.  The range's partial goes to slice r of the split-K workspace [G,
// S2, N, slots], and the finish pass of split_k.cuh sums the slices in
// ascending r and applies bias, shortcut and ReLU (no atomics; with one m
// range it adds them to the one slice, as the output-stationary flush
// would).  Bound: the os kernel's operations plus the IFFT per m range,
// and its bytes plus the workspace written and read once.
//
// Every entry point takes an optional residual shortcut `sc` laid out like
// y (B6 residual, shortcut.cuh), added after the bias and before the ReLU
// where the output is stored: B4/B5's flush or the flows' finish pass.
// B4/B5 read it from device memory at the flush or, with `sc_staged`,
// prefetch cluster rank r's flush rows r, r + C, ... of the CTA's 8
// tiles x 32 lanes into shared memory before the channel loop
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

#if !defined(SCH_BN) || !defined(SCH_OS_THREADS) || !defined(SCH_FIXED_STEPS)
#error "build through repro_torch.kernels._build (defines SCH_* block sizes)"
#endif

namespace cg = cooperative_groups;

namespace {

using namespace repro_torch;

constexpr int BN = SCH_BN;        // most PE lanes (output channels) a group
constexpr int FMAX = 64;          // bins per CTA (all active bins)
constexpr int MAX_CLUSTER = 8;    // portable cluster size

// Every kernel here takes OBP tiles and one half (OLN lanes) of a kernel
// group, all FMAX bins, with ONT threads: warp w (of 16) keeps the psum of
// bins 4 w .. 4 w + 3 for lane `lane` in registers; in the tile-FFT, warp
// w < 8 takes bins 8 w .. 8 w + 7 (re, then im: the 16 rows of an
// m16n8k8 A fragment).
constexpr int OBP = 8;
constexpr int OLN = 32;
constexpr int ONT = SCH_OS_THREADS;
constexpr int OWARPS = ONT / 32;
constexpr int OBINS = FMAX / OWARPS;      // psum bins a warp keeps
constexpr int YP = OLN * OBP + 8;         // Y~ / partial row pitch (8 mod 32)
constexpr int OS_STAGES = 5;              // the deepest ring tried
constexpr int FLOW_STAGES_MIN = 3;        // the flows' shallowest ring
constexpr int MT2_MAX = 4;                // IFFT row tiles: S2 <= 64
constexpr int KS2 = 2 * FMAX / 8;         // IFFT k steps (re, im bins)
constexpr int FA_WORDS = 8 * 8 * 128;     // the tile-FFT's A fragments
// The flows' tile-FFT unrolls this many k steps: their register budget
// (128 a thread at 512 threads) leaves no room for all 8 without a spill
constexpr int FLOW_FFT_UNROLL = 2;
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a CTA
// The cluster rule's price of a CTA's set-up, IFFT and reduction, in
// channel steps (os_cluster; fsc.SCHED_FIXED_STEPS mirrors it).
constexpr int FIXED_STEPS = SCH_FIXED_STEPS;
static_assert(ONT == 512 && OWARPS == 16 && OBINS == 4 && OLN == 32 &&
                  FMAX == 8 * (OWARPS / 2) && BN % OLN == 0,
              "16 warps, 4 psum bins a warp, the tile-FFT on 8 warps");

// the reuse flows
constexpr int OS = 0;   // output-stationary: channels split over a cluster
constexpr int WS = 1;   // weight-stationary: table rows of an m range
constexpr int IS = 2;   // input-stationary: X~ of an m range resident

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

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
    xf = fa + 2 * FA_WORDS;
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

// Shared-memory carve-up of the flows, in floats (every array 16-byte
// aligned).  Both keep the valid-row IFFT's A in f32 in fragment order
// ([mt2][KS2][32 lanes][4], k in the four rounds' order) for the CTA's
// life, and a ring of `stages` slots (five where they fit, at least
// three).
//  * ws: the tile-FFT's A in f32 ([8][8][32][4]), X~ and W of two channels
//    (double-buffered, as the output-stationary kernel's), and in the
//    place of all three after each tile block the IFFT's round stage
//    [32][YP] and partial [S2][YP] (the A is written again), the window
//    offsets, the m range's table rows (RM slots of idx [T][R] + sel, vr,
//    vi [T][OLN]), then the ring of one channel's input a slot.
//  * is: X~ of the range ([RM][re, im][FMAX][OBP]), one region that holds
//    the tile-FFT's A while X~ is built, then W (two channels), and after
//    each (group, half) the IFFT's round stage [32][YP], then its partial
//    [S2][YP], the window offsets, then the ring: two channels' inputs a
//    slot while X~ is built, one channel's table rows while the groups
//    are walked.
struct FlowLayout {
  int va, fa, xf, wd, ys, part, soff, tab, ring, x_sz, idx_sz, tab_sz,
      tslot, slot, stages, total;
  __host__ __device__ FlowLayout(int flow, int S, int S2, int T, int R,
                                 int x_floats, int RM) {
    x_sz = align4(x_floats);
    idx_sz = align4(T * R);
    tab_sz = T * OLN;
    tslot = idx_sz + 3 * tab_sz;
    va = 0;
    const int head = va + ((S2 + 15) / 16) * KS2 * 128;
    if (flow == WS) {
      fa = ys = head;
      xf = fa + FA_WORDS;
      wd = xf + 2 * 2 * FMAX * OBP;
      part = ys + 32 * YP;
      soff = fa + imax(FA_WORDS + 2 * 2 * FMAX * OBP + 2 * 2 * FMAX * OLN,
                       (32 + S2) * YP);
      tab = soff + align4(S);
      ring = tab + RM * tslot;
      slot = x_sz;
    } else {
      xf = head;
      fa = wd = ys = part = xf + RM * 2 * FMAX * OBP;
      soff = fa + imax(imax(FA_WORDS, 2 * 2 * FMAX * OLN),
                       imax(32 * YP, S2 * YP));
      tab = 0;
      ring = soff + align4(S);
      slot = imax(2 * x_sz, tslot);
    }
    for (stages = OS_STAGES;; --stages) {
      total = ring + stages * slot;
      if (stages <= FLOW_STAGES_MIN || 4 * total <= SMEM_MAX) break;
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
  __device__ Blk block(int bx, int) const {
    return {bx * TP, x_pitch % 4 == 0 && (size_t)xt % 16 == 0};
  }
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
using WindowedOs = WinPath<OBP, ONT>;     // every kernel's windowed path
using HaloOs = HaloPath<ONT, 1, OBP>;     // and its halo path (halo.cuh)

// copy `count` contiguous 4-byte words, 16 bytes at a time when aligned
// (ONT threads)
__device__ __forceinline__ void stage_words(float* dst, const float* src,
                                            int count, int tid) {
  int done = 0;
  if (((size_t)src & 15) == 0) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * ONT)
      cp_async16(dst + i, src + i, 16);
  }
  for (int i = done + tid; i < count; i += ONT)
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

// One (group, channel)'s table rows into dst: idx [T][R] (idx_sz floats
// apart from the rest), then lanes l0 .. l0 + OLN of sel, vr, vi [T][OLN]
// (tab_sz floats apart; vec: 16-byte copies)
__device__ __forceinline__ void stage_tables(
    float* dst, const int* idx, const int* sel, const float* vr,
    const float* vi, size_t gm, int T, int R, int NP, int l0, int idx_sz,
    int tab_sz, bool vec, int tid) {
  stage_words(dst, reinterpret_cast<const float*>(idx) + gm * T * R, T * R,
              tid);
  dst += idx_sz;
  const size_t row = gm * T * NP;
  stage_lanes(dst, reinterpret_cast<const float*>(sel) + row, T, NP, l0, vec,
              tid);
  stage_lanes(dst + tab_sz, vr + row, T, NP, l0, vec, tid);
  stage_lanes(dst + 2 * tab_sz, vi + row, T, NP, l0, vec, tid);
}

// Element i of the tile-FFT's A in fragment order [8 row tiles w][8 k
// steps kk][32 lanes][4]: row r < 8 of tile w is Re Df[8 w + r], r >= 8
// Im Df[8 w + r - 8], column (window row) kk * 8 + the lane's column;
// zero past Fa and S.
__device__ __forceinline__ float fft_a(const float* dfr, const float* dfi,
                                       int i, int Fa, int S) {
  const int w = i / 1024, kk = (i / 128) % 8, ln = (i / 4) % 32, e = i % 4;
  const int r = ln / 4 + (e & 1) * 8;
  const int sw = kk * 8 + ln % 4 + (e & 2) * 2;
  const int f = 8 * w + r % 8;
  return f < Fa && sw < S ? (r < 8 ? dfr : dfi)[(size_t)f * S + sw] : 0.f;
}

// Element i of the valid-row IFFT's A = [Dvr | -Dvi] in fragment order
// [mt2 row tiles][KS2 k steps][32 lanes][4], its k in the order
// `stage_psum` stages the psum: rounds of BPR bins a warp, round b's 4 BPR
// k steps holding Re of bin 4 w + b BPR + bb as row w BPR + bb, then the
// Im rows; zero past S2 and Fa.  One round (BPR 4) is plain bin order.
template <int BPR>
__device__ __forceinline__ float ifft_a(const float* dvr, const float* dvi,
                                        int i, int Fa, int S2) {
  constexpr int KSR = 4 * BPR;              // k steps a round
  const int kq = (i / 128) % KS2, m2 = i / (128 * KS2);
  const int ln = (i / 4) % 32, e = i % 4;
  const int s2 = m2 * 16 + ln / 4 + (e & 1) * 8;
  const int j = (kq % KSR) * 8 + ln % 4 + (e & 2) * 2;
  const int jr = j % (16 * BPR);
  const int f = 4 * (jr / BPR) + (kq / KSR) * BPR + jr % BPR;
  if (s2 >= S2 || f >= Fa) return 0.f;
  return j < 16 * BPR ? dvr[(size_t)s2 * Fa + f] : -dvi[(size_t)s2 * Fa + f];
}

// A split fragment from four f32 values in fragment order (the flows keep
// their operators in f32 and split them as they read them)
__device__ __forceinline__ void split_f32x4(const float4 v, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  split_frag(x, hi, lo);
}

// The tile-FFT of one channel on the tensor cores (3xTF32): X~ of bins
// 8 fw .. 8 fw + 7 on the OBP tile slots (the 8 columns) of the staged
// input `st`, into x (re [FMAX][OBP], then im).  a(fw, kk, ah, al) gives
// A's split fragment; all 8 k steps run (A is zero past S, and fft_x
// reads nothing there), UNROLL of them unrolled (0: all).
template <int UNROLL, class Path, class LoadA>
__device__ __forceinline__ void tile_fft(const Path& io, const float* st,
                                         const int* soff,
                                         typename Path::FftCol fcol,
                                         const LoadA& a, float* x, int S,
                                         int fw, int lane) {
  const int gq = lane / 4, tq = lane % 4;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  auto step = [&](int kk) {
    uint32_t ah[4], al[4];
    a(fw, kk, ah, al);
    const float b[2] = {io.fft_x(st, soff, fcol, kk * 8 + tq, S),
                        io.fft_x(st, soff, fcol, kk * 8 + tq + 4, S)};
    uint32_t bh[2], bl[2];
    split_frag(b, bh, bl);
    mma3_f32(c, ah, al, bh, bl);
  };
  if constexpr (UNROLL == 0) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) step(kk);
  } else {
#pragma unroll UNROLL
    for (int kk = 0; kk < 8; ++kk) step(kk);
  }
  const int o = (8 * fw + gq) * OBP + 2 * tq;
  *reinterpret_cast<float2*>(x + o) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(x + FMAX * OBP + o) = make_float2(c[2], c[3]);
}

// One channel's table rows `tab` (as stage_tables lays them) expanded into
// W[bin][lane] (re, im), entries e0, e0 + stride, ...: each entry decoded
// once, bin = idx[t][sel[t][n]]; the exact cover gives every (bin, lane)
// at most one entry a channel.
__device__ __forceinline__ void expand_tables(float2* w, const float* tab,
                                              int idx_sz, int tab_sz, int T,
                                              int R, int Fa, int e0,
                                              int stride) {
  const int* s_idx = reinterpret_cast<const int*>(tab);
  const int* s_sel = s_idx + idx_sz;
  const float* s_vr = reinterpret_cast<const float*>(s_sel) + tab_sz;
  const float* s_vi = s_vr + tab_sz;
  for (int e = e0; e < T * OLN; e += stride) {
    const float w_r = s_vr[e], w_i = s_vi[e];
    const int rr = s_sel[e];
    if ((w_r == 0.f && w_i == 0.f) || (unsigned)rr >= (unsigned)R) continue;
    const int f = s_idx[(e / OLN) * R + rr];
    if ((unsigned)f < (unsigned)Fa) w[f * OLN + e % OLN] = make_float2(w_r, w_i);
  }
}

// One channel's MACs: psum[f][n][p] += W[f][n] X~[f][p] for bins 4 warp ..
// 4 warp + 3 of lane `lane`, all OBP tiles, in registers (X~ re [FMAX][OBP]
// at x, im after it; its row a broadcast), zeroing the W cells read for
// the channel after next.
__device__ __forceinline__ void mac_channel(float (&pr)[OBINS][OBP],
                                            float (&pi)[OBINS][OBP],
                                            const float* x, float2* w,
                                            int warp, int lane) {
  const float* xi = x + FMAX * OBP;
#pragma unroll
  for (int b = 0; b < OBINS; ++b) {
    const int f = OBINS * warp + b;
    const float2 wv = w[f * OLN + lane];
    w[f * OLN + lane] = make_float2(0.f, 0.f);
    const float4 r0 = *reinterpret_cast<const float4*>(x + f * OBP);
    const float4 r1 = *reinterpret_cast<const float4*>(x + f * OBP + 4);
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
}

// Round B of the psum into the IFFT's stage (rows of YP floats): bins
// 4 warp + B BPR + bb (bb < BPR) of lane `lane`, all OBP tiles, as Re row
// warp BPR + bb and Im row 16 BPR + warp BPR + bb (ifft_a<BPR>'s k order).
template <int BPR, int B>
__device__ __forceinline__ void stage_psum(const float (&pr)[OBINS][OBP],
                                           const float (&pi)[OBINS][OBP],
                                           float* s_y, int warp, int lane) {
#pragma unroll
  for (int bb = 0; bb < BPR; ++bb) {
    const int q = B * BPR + bb;
    float* yr = s_y + (warp * BPR + bb) * YP + lane * OBP;
    float* yi = yr + 16 * BPR * YP;
    *reinterpret_cast<float4*>(yr) =
        make_float4(pr[q][0], pr[q][1], pr[q][2], pr[q][3]);
    *reinterpret_cast<float4*>(yr + 4) =
        make_float4(pr[q][4], pr[q][5], pr[q][6], pr[q][7]);
    *reinterpret_cast<float4*>(yi) =
        make_float4(pi[q][0], pi[q][1], pi[q][2], pi[q][3]);
    *reinterpret_cast<float4*>(yi + 4) =
        make_float4(pi[q][4], pi[q][5], pi[q][6], pi[q][7]);
  }
}

// The valid-row IFFT's products over KS staged k steps (A's k steps kq0
// ..): acc[m2][j] += A[row tile m2] Y~[n-tile n0 + 16 j] for m2 < mt2,
// j < NJ, each k step in fresh accumulators added in f32 (mma3_f32);
// a(m2, kq, ah, al) gives A's split fragment; UNROLL k steps unrolled.
// The 32 n-tiles are the CTA's lanes, 8 tiles each.
template <int KS, int UNROLL, int NJ, class LoadA>
__device__ __forceinline__ void ifft_mma(float (&acc)[MT2_MAX][NJ][4],
                                         const float* s_y, const LoadA& a,
                                         int kq0, int mt2, int n0,
                                         int lane) {
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll UNROLL
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* col = s_y + (kk * 8 + tq) * YP + (n0 + 16 * j) * 8 + gq;
      const float b[2] = {col[0], col[4 * YP]};
      split_frag(b, bh[j], bl[j]);
    }
#pragma unroll
    for (int m2 = 0; m2 < MT2_MAX; ++m2) {
      if (m2 >= mt2) break;
      uint32_t ah[4], al[4];
      a(m2, kq0 + kk, ah, al);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma3_f32(acc[m2][j], ah, al, bh[j], bl[j]);
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

  // the tile-FFT's A, split once in fragment order; W zeroed
  for (int i = tid; i < FA_WORDS; i += ONT)
    split(fft_a(dfr, dfi, i, Fa, S), s_fa[i], s_fa[FA_WORDS + i]);
  for (int i = tid; i < 2 * FMAX * OLN; i += ONT)
    s_w[i] = make_float2(0.f, 0.f);
  io.fft_offsets(s_soff, tid);
  const uint4* fa4 = reinterpret_cast<const uint4*>(s_fa);
  auto fft_frag = [&](int w, int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const uint4 h = fa4[w * 256 + kk * 32 + lane];
    const uint4 l = fa4[FA_WORDS / 4 + w * 256 + kk * 32 + lane];
    ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
    al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
  };

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
  auto load_step = [&](int slot, int m) {
    float* st = ring + slot * L.slot;
    io.load(blk, st, S, M, m, tid);
    stage_tables(st + L.x_sz, idx, sel, vr, vi, (size_t)g * Mp + m, T, R,
                 NP, l0, L.idx_sz, L.tab_sz, vec_t, tid);
  };

  // the psum of bins 4 warp .. 4 warp + 3, lane `lane`, all tiles
  float pr[OBINS][OBP], pi[OBINS][OBP];
#pragma unroll
  for (int b = 0; b < OBINS; ++b)
#pragma unroll
    for (int p = 0; p < OBP; ++p) pr[b][p] = pi[b][p] = 0.f;

  // The channel loop: step i's tile-FFT (warps 0-7) and table expansion
  // (warps 8-15) beside step i - 1's MACs (all warps; X~ and W buffer
  // (i - 1) & 1, the W cells read zeroed for step i + 1); the copies run
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
      if (warp < 8)     // Stage 1: X~ of bins 8 warp .. on the 8 tile slots
        tile_fft<0>(io, st, s_soff, fcol, fft_frag,
                    s_x + (i & 1) * 2 * FMAX * OBP, S, warp, lane);
      else              // Stage 2: the channel's tables into W
        expand_tables(s_w + (i & 1) * FMAX * OLN, st + L.x_sz, L.idx_sz,
                      L.tab_sz, T, R, Fa, tid - ONT / 2, ONT / 2);
    }
    if (i > 0)          // Stage 3
      mac_channel(pr, pi, s_x + ((i - 1) & 1) * 2 * FMAX * OBP,
                  s_w + ((i - 1) & 1) * FMAX * OLN, warp, lane);
  }

  // Stage 4: Y~ [2 FMAX][YP] (re rows, then im) from the registers, the
  // IFFT's A split into fragment order, then partial[s2][(n, p)] = sum_k
  // A[s2][k] Y~[k][(n, p)] on the tensor cores, warp w n-tiles w, w + 16
  __syncthreads();      // the loop's shared memory is free
  float* s_y = smem + L.ys;
  stage_psum<OBINS, 0>(pr, pi, s_y, warp, lane);
  uint32_t* s_va = reinterpret_cast<uint32_t*>(smem + L.va);
  for (int i = tid; i < mt2 * KS2 * 128; i += ONT)
    split(ifft_a<OBINS>(dvr, dvi, i, Fa, S2), s_va[i],
          s_va[mt2 * KS2 * 128 + i]);
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
  ifft_mma<KS2, 2, 2>(acc, s_y,
                [&](int m2, int kq, uint32_t (&ah)[4], uint32_t (&al)[4]) {
                  const uint4 h = vh4[(m2 * KS2 + kq) * 32 + lane];
                  const uint4 l = vl4[(m2 * KS2 + kq) * 32 + lane];
                  ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
                  al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
                },
                0, mt2, warp, lane);
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
// (Path).  Grid: ws (chunk, kernel group x lane half, m range), the chunk
// taking tile blocks chunk, chunk + chunks, ...; is (tile block, m range,
// share q of Q of the (group, half) walk).  Per (tile block, group half)
// the psum is folded by the IFFT in four rounds, and the m range's partial
// stored to its slice of the split-K workspace ws; the finish pass sums
// the slices (one, with one m range) and applies bias, shortcut and ReLU.
template <class Path, int FLOW>
__global__ void __launch_bounds__(ONT, 1)
fused_sched_flow_kernel(const Path io, const int* __restrict__ idx,
                        const int* __restrict__ sel,
                        const float* __restrict__ vr,
                        const float* __restrict__ vi,
                        const float* __restrict__ dfr,
                        const float* __restrict__ dfi,
                        const float* __restrict__ dvr,
                        const float* __restrict__ dvi,
                        float* __restrict__ ws, int S, int M, int Mp, int T,
                        int R, int NP, int Fa, int N, int S2, int RM,
                        int halves) {
  static_assert(FLOW != OS, "output-stationary: above");
  extern __shared__ __align__(16) float smem[];
  const FlowLayout L(FLOW, S, S2, T, R, io.x_floats(S), RM);
  float* s_va = smem + L.va;
  float* s_fa = smem + L.fa;
  float2* s_w = reinterpret_cast<float2*>(smem + L.wd);   // [2][FMAX][OLN]
  int* s_soff = reinterpret_cast<int*>(smem + L.soff);
  float* ring = smem + L.ring;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // MMA fragment coordinates
  const int mt2 = (S2 + 15) / 16;
  const int slots = io.blocks() * OBP;      // workspace tile columns
  // this CTA's channels: m range r
  const int r = FLOW == WS ? blockIdx.z : blockIdx.y;
  const int m_lo = r * RM, m_hi = m_lo + RM < M ? m_lo + RM : M;
  const int n_ch = m_hi - m_lo;

  // the operators in f32, fragment order (split where they are read): the
  // IFFT's A in the rounds' k order, the tile-FFT's A; W zeroed (ws; the
  // input-stationary W takes the FFT's place once X~ is built)
  for (int i = tid; i < mt2 * KS2 * 128; i += ONT)
    s_va[i] = ifft_a<1>(dvr, dvi, i, Fa, S2);
  auto fill_fa = [&]() {
#pragma unroll 1
    for (int i = tid; i < FA_WORDS; i += ONT)
      s_fa[i] = fft_a(dfr, dfi, i, Fa, S);
  };
  auto zero_w = [&]() {
    for (int i = tid; i < 2 * FMAX * OLN; i += ONT)
      s_w[i] = make_float2(0.f, 0.f);
  };
  fill_fa();
  if constexpr (FLOW == WS) zero_w();
  io.fft_offsets(s_soff, tid);
  const float4* fa4 = reinterpret_cast<const float4*>(s_fa);
  const float4* va4 = reinterpret_cast<const float4*>(s_va);
  auto fft_frag = [&](int w, int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    split_f32x4(fa4[w * 256 + kk * 32 + lane], ah, al);
  };
  auto ifft_frag = [&](int m2, int kq, uint32_t (&ah)[4],
                       uint32_t (&al)[4]) {
    split_f32x4(va4[(m2 * KS2 + kq) * 32 + lane], ah, al);
  };
  auto wait_ring = [&]() {      // every step up to the one consumed next
    if (L.stages >= 5)
      cp_async_wait<3>();
    else if (L.stages == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
  };
  const bool vec_t = NP % 4 == 0 && (size_t)sel % 16 == 0 &&
                     (size_t)vr % 16 == 0 && (size_t)vi % 16 == 0;

  // the psum of bins 4 warp .. 4 warp + 3, lane `lane`, all tiles, zeroed
  // before each (tile block, group half)
  float pr[OBINS][OBP], pi[OBINS][OBP];
  auto zero_psum = [&]() {
#pragma unroll
    for (int b = 0; b < OBINS; ++b)
#pragma unroll
      for (int p = 0; p < OBP; ++p) pr[b][p] = pi[b][p] = 0.f;
  };

  // After the MACs of a (tile block bx, group g, lanes l0 ..): the IFFT in
  // four rounds of the psum through the stage (round b: bin 4 w + b of
  // every warp w), summed into the partial [S2][YP]: ws in shared memory
  // round by round, one (row tile, n-tile) accumulator at a time (beside
  // the psum, the FFT and the resident tables' state, no more fits in
  // registers); is in registers across the rounds, written to the partial
  // after the last.  Then slice r of the workspace.  Leaves W zero (and
  // ws's FFT A written again).
  auto finish_rect = [&](int bx, int g, int l0) {
    float* s_y = smem + L.ys;
    float* s_part = smem + L.part;
    if constexpr (FLOW == WS) {
      auto round = [&](auto bc) {
        constexpr int B = decltype(bc)::value;
        __syncthreads();        // the last MACs / the last round are read
        stage_psum<1, B>(pr, pi, s_y, warp, lane);
        __syncthreads();
        // one pass an n-tile (warp, then warp + 16)
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          const int n0 = warp + 16 * j;
          float acc[MT2_MAX][1][4];
#pragma unroll
          for (int m2 = 0; m2 < MT2_MAX; ++m2)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m2][0][e] = 0.f;
          ifft_mma<4, 1, 1>(acc, s_y, ifft_frag, 4 * B, mt2, n0, lane);
#pragma unroll
          for (int m2 = 0; m2 < MT2_MAX; ++m2)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int s2 = m2 * 16 + gq + 8 * h2;
              if (m2 >= mt2 || s2 >= S2) continue;
              float2* d = reinterpret_cast<float2*>(s_part + s2 * YP +
                                                    n0 * 8 + 2 * tq);
              const float2 v = make_float2(acc[m2][0][2 * h2],
                                           acc[m2][0][2 * h2 + 1]);
              if constexpr (B == 0) {
                *d = v;
              } else {
                const float2 u = *d;
                *d = make_float2(u.x + v.x, u.y + v.y);
              }
            }
        }
      };
      round(std::integral_constant<int, 0>{});
      round(std::integral_constant<int, 1>{});
      round(std::integral_constant<int, 2>{});
      round(std::integral_constant<int, 3>{});
    } else {
      float acc[MT2_MAX][2][4];
#pragma unroll
      for (int a = 0; a < MT2_MAX; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
      auto round = [&](auto bc) {
        constexpr int B = decltype(bc)::value;
        __syncthreads();        // the last MACs / the last round are read
        stage_psum<1, B>(pr, pi, s_y, warp, lane);
        __syncthreads();
        ifft_mma<4, 1, 2>(acc, s_y, ifft_frag, 4 * B, mt2, warp, lane);
      };
      round(std::integral_constant<int, 0>{});
      round(std::integral_constant<int, 1>{});
      round(std::integral_constant<int, 2>{});
      round(std::integral_constant<int, 3>{});
      __syncthreads();          // the stage is read: the partial replaces it
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
    }
    __syncthreads();            // the partial is complete
    for (int i = tid; i < S2 * OLN * OBP; i += ONT) {
      const int s2 = i / (OLN * OBP), n = i / OBP % OLN;
      const int gn = g * NP + l0 + n;
      if (l0 + n < NP && gn < N)
        ws[(((size_t)r * S2 + s2) * N + gn) * slots + bx * OBP + i % OBP] =
            s_part[s2 * YP + i % (OLN * OBP)];
    }
    __syncthreads();            // the partial is read: W may be zeroed
    zero_w();
    if constexpr (FLOW == WS) fill_fa();
  };

  if constexpr (FLOW == WS) {
    // every channel's table rows resident, then the chunk's tile blocks
    const int chunks = gridDim.x, chunk = blockIdx.x;
    const int g = blockIdx.y / halves;
    const int l0 = (blockIdx.y - g * halves) * OLN;
    const int n_blk =
        chunk < io.blocks() ? (io.blocks() - 1 - chunk) / chunks + 1 : 0;
    const int total = n_blk * n_ch;           // channel steps
    float* s_tab = smem + L.tab;
    for (int c = 0; c < n_ch; ++c)
      stage_tables(s_tab + c * L.tslot, idx, sel, vr, vi,
                   (size_t)g * Mp + m_lo + c, T, R, NP, l0, L.idx_sz,
                   L.tab_sz, vec_t, tid);
    cp_async_commit();          // waited for with the first step
    // step s: channel m_lo + s % n_ch of the chunk's block s / n_ch
    auto load_step = [&](int s) {
      const int k = s / n_ch;
      io.load(io.block(chunk + k * chunks, tid), ring + (s % L.stages) * L.slot,
              S, M, m_lo + s - k * n_ch, tid);
    };
    for (int st = 0; st < L.stages - 1; ++st) {
      if (st < total) load_step(st);
      cp_async_commit();
    }
    __syncthreads();            // the operators, W and the offsets are ready
    for (int k = 0; k < n_blk; ++k) {
      const int bx = chunk + k * chunks;
      const typename Path::FftCol fcol =
          io.fft_col(io.block(bx, tid), gq, tq);
      zero_psum();
      // channel i's tile-FFT (warps 0-7) and expansion (warps 8-15) beside
      // channel i - 1's MACs (all warps)
      for (int i = 0; i <= n_ch; ++i) {
        const int s = k * n_ch + i;
        if (i < n_ch) wait_ring();
        __syncthreads();        // step s landed; channel i - 1 is ready
        if (i < n_ch) {
          if (s + L.stages - 1 < total) load_step(s + L.stages - 1);
          cp_async_commit();
          const float* st = ring + (s % L.stages) * L.slot;
          if (warp < 8)
            tile_fft<FLOW_FFT_UNROLL>(io, st, s_soff, fcol, fft_frag,
                                      smem + L.xf + (i & 1) * 2 * FMAX * OBP,
                                      S, warp, lane);
          else
            expand_tables(s_w + (i & 1) * FMAX * OLN, s_tab + i * L.tslot,
                          L.idx_sz, L.tab_sz, T, R, Fa, tid - ONT / 2,
                          ONT / 2);
        }
        if (i > 0)
          mac_channel(pr, pi, smem + L.xf + ((i - 1) & 1) * 2 * FMAX * OBP,
                      s_w + ((i - 1) & 1) * FMAX * OLN, warp, lane);
      }
      finish_rect(bx, g, l0);
    }
  } else {
    {
      // X~ of the range on the block's tiles, two channels a step (warps
      // 0-7: channel 2 j, warps 8-15: 2 j + 1), kept in shared memory
      const typename Path::Blk blk = io.block(blockIdx.x, tid);
      const typename Path::FftCol fcol = io.fft_col(blk, gq, tq);
      const int pairs = (n_ch + 1) / 2;
      auto load_pair = [&](int j) {
        float* st = ring + (j % L.stages) * L.slot;
        io.load(blk, st, S, M, m_lo + 2 * j, tid);
        if (2 * j + 1 < n_ch)
          io.load(blk, st + L.x_sz, S, M, m_lo + 2 * j + 1, tid);
      };
      for (int st = 0; st < L.stages - 1; ++st) {
        if (st < pairs) load_pair(st);
        cp_async_commit();
      }
      __syncthreads();          // the operators and the offsets are ready
      for (int j = 0; j < pairs; ++j) {
        wait_ring();
        __syncthreads();        // pair j landed
        if (j + L.stages - 1 < pairs) load_pair(j + L.stages - 1);
        cp_async_commit();
        const int c = 2 * j + warp / 8;
        if (c < n_ch)
          tile_fft<FLOW_FFT_UNROLL>(
              io, ring + (j % L.stages) * L.slot + (warp / 8) * L.x_sz,
              s_soff, fcol, fft_frag, smem + L.xf + c * 2 * FMAX * OBP, S,
              warp % 8, lane);
      }
    }
    __syncthreads();            // X~ is complete: W takes the FFT's place
    zero_w();
    // the walk: (group, half) h0 .. h1 - 1, table rows through the ring
    const int n_h = (N + NP - 1) / NP * halves;
    const int q = blockIdx.z, Q = gridDim.z;
    const int h0 = q * n_h / Q, h1 = (q + 1) * n_h / Q;
    const int total = (h1 - h0) * n_ch;
    auto load_tab = [&](int s) {
      const int h = h0 + s / n_ch, g = h / halves;
      stage_tables(ring + (s % L.stages) * L.slot, idx, sel, vr, vi,
                   (size_t)g * Mp + m_lo + s % n_ch, T, R, NP,
                   (h - g * halves) * OLN, L.idx_sz, L.tab_sz, vec_t, tid);
    };
    for (int st = 0; st < L.stages - 1; ++st) {
      if (st < total) load_tab(st);
      cp_async_commit();
    }
    for (int h = h0; h < h1; ++h) {
      const int g = h / halves, l0 = (h - g * halves) * OLN;
      zero_psum();
      // channel i's expansion (all warps) beside channel i - 1's MACs
      for (int i = 0; i <= n_ch; ++i) {
        const int s = (h - h0) * n_ch + i;
        if (i < n_ch) wait_ring();
        __syncthreads();        // step s landed; channel i - 1 is ready
        if (i < n_ch) {
          if (s + L.stages - 1 < total) load_tab(s + L.stages - 1);
          cp_async_commit();
          expand_tables(s_w + (i & 1) * FMAX * OLN,
                        ring + (s % L.stages) * L.slot, L.idx_sz, L.tab_sz,
                        T, R, Fa, tid, ONT);
        }
        if (i > 0)
          mac_channel(pr, pi, smem + L.xf + (i - 1) * 2 * FMAX * OBP,
                      s_w + ((i - 1) & 1) * FMAX * OLN, warp, lane);
      }
      finish_rect(blockIdx.x, g, l0);
    }
  }
  cp_async_wait_all();          // nothing in flight at exit
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
// channels (os_cluster).  The flows: grid ws (split chunks, GN x lane
// halves, G m ranges), is (tile blocks, G, split shares of the walk), the
// split chosen by the host's launch rule (fsc.sched_flow_geometry).  Sizes
// whose shared memory exceeds the per-block limit fail
// cudaFuncSetAttribute.
template <class Path, int FLOW, int SC>
int launch(const Path& io, const int* idx, const int* sel, const float* vr,
           const float* vi, const float* dfr, const float* dfi,
           const float* dvr, const float* dvi, const float* bias,
           const float* sc, float* y, float* ws, int S, int M, int GN,
           int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
           int RM, int split, void* stream) {
  if (Fa < 1 || Fa > FMAX || S < 1 || S > 64 || M < 1 || Mp < M || GN < 1 ||
      T < 1 || R < 1 || NP < 1 || NP > BN || N < 1 || N > GN * NP ||
      S2 < 1 || S2 > 16 * MT2_MAX || RM < 1 || split < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(ONT);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int halves = (NP + OLN - 1) / OLN;
  if constexpr (FLOW == OS) {
    const int* cap = nullptr;
    const int e = os_capacity(&cap);
    if (e != 0) return e;
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
    attr[0].val.clusterDim.z = C;
    err = cudaLaunchKernelEx(&cfg, fused_sched_os_kernel<Path, SC>, io, idx,
                             sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, S,
                             M, Mp, T, R, NP, Fa, N, S2, relu, halves);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  } else {
    const int G = (M + RM - 1) / RM;
    if (ws == nullptr || G > 65535 ||
        split > (FLOW == WS ? io.blocks() : GN * halves))
      return (int)cudaErrorInvalidValue;
    const FlowLayout L(FLOW, S, S2, T, R, io.x_floats(S), RM);
    cfg.dynamicSmemBytes = (size_t)L.total * sizeof(float);
    err = cudaFuncSetAttribute(fused_sched_flow_kernel<Path, FLOW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = FLOW == WS ? dim3(split, GN * halves, G)
                             : dim3(io.blocks(), G, split);
    err = cudaLaunchKernelEx(&cfg, fused_sched_flow_kernel<Path, FLOW>, io,
                             idx, sel, vr, vi, dfr, dfi, dvr, dvi, ws, S, M,
                             Mp, T, R, NP, Fa, N, S2, RM, halves);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)launch_finish<Path, OBP, SC>(io, ws, bias, sc, y, G, S2, N,
                                             io.blocks() * OBP, relu,
                                             (cudaStream_t)stream);
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
             int RM, int split, int sc_staged, void* stream) {
  if (sc == nullptr) {
    if (sc_staged) return (int)cudaErrorInvalidValue;
    return launch<Path, FLOW, SC_NONE>(io, idx, sel, vr, vi, dfr, dfi, dvr,
                                       dvi, bias, sc, y, ws, S, M, GN, Mp, T,
                                       R, NP, Fa, N, S2, relu, RM, split,
                                       stream);
  }
  if (!sc_staged)
    return launch<Path, FLOW, SC_GLOBAL>(io, idx, sel, vr, vi, dfr, dfi,
                                         dvr, dvi, bias, sc, y, ws, S, M, GN,
                                         Mp, T, R, NP, Fa, N, S2, relu, RM,
                                         split, stream);
  if constexpr (FLOW == OS)
    return launch<Path, OS, SC_STAGED>(io, idx, sel, vr, vi, dfr, dfi, dvr,
                                       dvi, bias, sc, y, ws, S, M, GN, Mp, T,
                                       R, NP, Fa, N, S2, relu, RM, split,
                                       stream);
  else
    return (int)cudaErrorInvalidValue;
}

template <int FLOW>
int windowed(const float* xt, const int* idx, const int* sel,
             const float* vr, const float* vi, const float* dfr,
             const float* dfi, const float* dvr, const float* dvi,
             const float* bias, const float* sc, float* y, float* ws, int S,
             int M, int P, int x_pitch, int GN, int Mp, int T, int R, int NP,
             int Fa, int N, int S2, int relu, int RM, int split,
             int sc_staged, void* stream) {
  if (P < 1 || x_pitch < P) return (int)cudaErrorInvalidValue;
  return dispatch<WindowedOs, FLOW>(WindowedOs{xt, P, x_pitch}, idx, sel, vr,
                                    vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                                    S, M, GN, Mp, T, R, NP, Fa, N, S2, relu,
                                    RM, split, sc_staged, stream);
}

template <int FLOW>
int halo(const float* x, const int* idx, const int* sel, const float* vr,
         const float* vi, const float* dfr, const float* dfi,
         const float* dvr, const float* dvi, const float* bias,
         const float* sc, float* y, float* ws, int B, int M, int H, int W,
         int K, int ksize, int pad, int n_th, int n_tw, int bth, int btw,
         int nbh, int nbw, int pre, int band, int Mp, int T, int R, int NP,
         int Fa, int N, int S2, int relu, int RM, int split, int sc_staged,
         void* stream) {
  HaloOs io{x, {}};
  if (!make_halo_geo(io.g, B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw,
                     nbh, nbw, pre, band) ||
      bth * btw > OBP || S2 != io.g.t * io.g.t || NP < 1)
    return (int)cudaErrorInvalidValue;
  const int GN = (N + NP - 1) / NP;
  return dispatch<HaloOs, FLOW>(io, idx, sel, vr, vi, dfr, dfi, dvr, dvi,
                                bias, sc, y, ws, K * K, M, GN, Mp, T, R, NP,
                                Fa, N, S2, relu, RM, split, sc_staged,
                                stream);
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
                      relu, 1, 1, sc_staged, stream);
}

// Windowed layer, weight- / input-stationary over m ranges of RM channels;
// ws is a workspace of G * S2 * N * ceil(P / 8) * 8 floats, G = ceil(M / RM)
// (the finish pass applies bias, shortcut and ReLU, with G = 1 too).  split: ws, the chunks of tile
// blocks (at most ceil(P / 8)); is, the shares of the (group, half) walk
// (at most GN x ceil(NP / 32)).
int fused_spectral_pipeline_scheduled_ws_f32(
    const float* xt, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int S, int M, int P, int x_pitch, int GN, int Mp, int T,
    int R, int NP, int Fa, int N, int S2, int relu, int RM, int split,
    int sc_staged, void* stream) {
  return windowed<WS>(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                      ws, S, M, P, x_pitch, GN, Mp, T, R, NP, Fa, N, S2,
                      relu, RM, split, sc_staged, stream);
}

int fused_spectral_pipeline_scheduled_is_f32(
    const float* xt, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int S, int M, int P, int x_pitch, int GN, int Mp, int T,
    int R, int NP, int Fa, int N, int S2, int relu, int RM, int split,
    int sc_staged, void* stream) {
  return windowed<IS>(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y,
                      ws, S, M, P, x_pitch, GN, Mp, T, R, NP, Fa, N, S2,
                      relu, RM, split, sc_staged, stream);
}

// Halo layer: x [B, M, H, W] contiguous, y and sc [B, N, H_out, W_out]; the
// tile grid (n_th x n_tw, spectral.make_geometry) in blocks of bth x btw <=
// 8 tiles (spectral.halo_block_geometry); tables as for the windowed layer.
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
                  nbh, nbw, pre, band, Mp, T, R, NP, Fa, N, S2, relu, 1, 1,
                  sc_staged, stream);
}

// Halo layer, weight- / input-stationary; ws holds
// G * S2 * N * B * nbh * nbw * 8 floats; split as for the windowed layer
// (ws: at most B * nbh * nbw chunks).
int fused_spectral_pipeline_scheduled_halo_ws_f32(
    const float* x, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int B, int M, int H, int W, int K, int ksize, int pad,
    int n_th, int n_tw, int bth, int btw, int nbh, int nbw, int pre,
    int band, int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
    int RM, int split, int sc_staged, void* stream) {
  return halo<WS>(x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                  B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw,
                  pre, band, Mp, T, R, NP, Fa, N, S2, relu, RM, split,
                  sc_staged, stream);
}

int fused_spectral_pipeline_scheduled_halo_is_f32(
    const float* x, const int* idx, const int* sel, const float* vr,
    const float* vi, const float* dfr, const float* dfi, const float* dvr,
    const float* dvi, const float* bias, float* y, const float* sc,
    float* ws, int B, int M, int H, int W, int K, int ksize, int pad,
    int n_th, int n_tw, int bth, int btw, int nbh, int nbw, int pre,
    int band, int Mp, int T, int R, int NP, int Fa, int N, int S2, int relu,
    int RM, int split, int sc_staged, void* stream) {
  return halo<IS>(x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, sc, y, ws,
                  B, M, H, W, K, ksize, pad, n_th, n_tw, bth, btw, nbh, nbw,
                  pre, band, Mp, T, R, NP, Fa, N, S2, relu, RM, split,
                  sc_staged, stream);
}

// The most clusters of `cluster` output-stationary CTAs the card runs at
// once, into *count (the wrapper mirrors the launch's cluster rule by it).
int fused_spectral_pipeline_scheduled_os_max_clusters(int cluster,
                                                      int* count) {
  return os_max_clusters(cluster, count);
}

}  // extern "C"
