// The halo input path shared by the port's fused kernels: the plane
// kernel's `fused_spectral_pipeline_halo_f32` (fused_spectral_conv.cu)
// and the scheduled kernel's `fused_spectral_pipeline_scheduled_halo_f32`
// (fused_spectral_conv_scheduled.cu).  They replace the TPU kernels
// `fused_spectral_pipeline_halo` and `fused_spectral_pipeline_scheduled_halo`
// (src/repro/kernels/fused_spectral_conv.py; helpers `_halo_windows`,
// `_halo_specs`, `_CanvasSink`, `_crop_canvas`).
//
// A CTA's tile block is one halo block: image b, block row ib, block col jb
// of `bth x btw` tiles (spectral.halo_block_geometry), so a block never
// spans two images.  Two pieces:
//
//  * Raw-block input stage.  Per channel step the CTA copies the raw rows
//    ib*bth*t - (k-1) ... + bth*t + k - 1 and the matching columns of the
//    NCHW activation into shared memory with 4-byte cp.async copies (a
//    block's first column is jb*btw*t - 2, so rows are not 16-byte aligned
//    and TMA's 16-byte strides rule it out at 14-float rows).  Coordinates
//    outside the image get a zero source size: that zero fill IS the 'same'
//    padding and the tile-grid padding.  The TPU clamps its block starts to
//    stay in bounds and re-aligns with one-hot selectors; reading at the
//    unclamped start with zero fill gives the same windows.  The kernels'
//    tile-FFT reads each window element from the raw stage by offset
//    (`HaloPath::fft_x`), so the FFT, Hadamard and IFFT bodies (and their
//    arithmetic order per tile) are those of the windowed kernels.
//  * Canvas output store.  Output element (s2 = (u, v), n, tile slot (ii,
//    jj)) goes to y[b, n, (ib*bth + ii)*t + u - c, (jb*btw + jj)*t + v - c]
//    with c = k - 1 - pad, for real tiles and inside [0, H_out) x [0, W_out)
//    only.  That folds the reference's canvas relayout and 'same' crop into
//    the flush: y is contiguous NCHW, the next layer's raw input after a
//    pool.
//
// Band mode (B6 band, the reference's `execute_band_plan` with
// `_band_conv_halo` / `_band_conv_scheduled_halo`): x is one shard's
// extended band, whose top `pre` = k - 1 rows are real data (the upper
// neighbour's last rows, or zeros on the first shard), so every block's raw
// stage starts `pre` rows lower; and the store writes the UNCROPPED band
// canvas y[B, N, n_th*t, n_tw*t] (c = 0), because the 'same' crop is global
// and runs once after the bands are joined.  With pre = 0 and band mode off
// every offset is what it was.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "cp_async.cuh"

namespace repro_torch {

// Geometry of one halo layer (all ints, filled on the host).
struct HaloGeo {
  int B, M, H, W;           // raw input x [B, M, H, W], contiguous f32
  int K, t, ov;             // FFT size, tile K - k + 1, halo k - 1
  int pre;                  // top halo rows already in x (a band: k - 1)
  int n_th, n_tw;           // tile grid
  int bth, btw, nbh, nbw;   // tiles per block, blocks per axis
  int H_out, W_out, crop;   // output [B, N, H_out, W_out]; crop k - 1 - pad
                            // (band mode: the n_th*t x n_tw*t canvas, 0)
  int rows, cols, chan;     // raw stage of a channel: rows x cols at an odd
                            // channel pitch (spreads channels over banks)
};

// Fill `g`; false for a geometry the kernels cannot take (the tile grid
// must cover the output and the blocks the grid, with no empty block; a
// top halo in x only in band mode, at most k - 1 rows).
inline bool make_halo_geo(HaloGeo& g, int B, int M, int H, int W, int K,
                          int ksize, int pad, int n_th, int n_tw, int bth,
                          int btw, int nbh, int nbw, int pre, int band) {
  g.B = B; g.M = M; g.H = H; g.W = W; g.K = K;
  g.t = K - ksize + 1; g.ov = ksize - 1; g.pre = pre;
  g.n_th = n_th; g.n_tw = n_tw;
  g.bth = bth; g.btw = btw; g.nbh = nbh; g.nbw = nbw;
  g.H_out = band ? n_th * g.t : H + 2 * pad - ksize + 1;
  g.W_out = band ? n_tw * g.t : W + 2 * pad - ksize + 1;
  g.crop = band ? 0 : ksize - 1 - pad;
  g.rows = bth * g.t + g.ov;
  g.cols = btw * g.t + g.ov;
  g.chan = (g.rows * g.cols) | 1;
  return B >= 1 && M >= 1 && H >= 1 && W >= 1 && ksize >= 1 && g.t >= 1 &&
         pad >= 0 && g.crop >= 0 && g.H_out >= 1 && g.W_out >= 1 &&
         pre >= 0 && pre <= g.ov && (band || pre == 0) &&
         bth >= 1 && btw >= 1 && n_th * g.t >= g.H_out + g.crop &&
         n_tw * g.t >= g.W_out + g.crop && (nbh - 1) * bth < n_th &&
         nbh * bth >= n_th && (nbw - 1) * btw < n_tw && nbw * btw >= n_tw;
}

// One CTA's halo block: image b, block row ib / col jb, and the raw
// coordinates of its stage's first row and column (unclamped; the rows
// shifted down by the band's in-buffer halo).
struct HaloBlock {
  int b, ib, jb, r0, c0;

  __device__ __forceinline__ static HaloBlock of(const HaloGeo& g, int blk) {
    HaloBlock hb;
    const int nb = g.nbh * g.nbw;
    hb.b = blk / nb;
    const int q = blk - hb.b * nb;
    hb.ib = q / g.nbw;
    hb.jb = q - hb.ib * g.nbw;
    hb.r0 = hb.ib * g.bth * g.t - g.ov + g.pre;
    hb.c0 = hb.jb * g.btw * g.t - g.ov;
    return hb;
  }
  // tile slot p (bth-major) holds a tile of the grid
  __device__ __forceinline__ bool real(const HaloGeo& g, int p) const {
    if (p >= g.bth * g.btw) return false;
    const int ii = p / g.btw, jj = p - ii * g.btw;
    return ib * g.bth + ii < g.n_th && jb * g.btw + jj < g.n_tw;
  }
};

// Stage channels [m0, m0 + BM) of the block's raw rows into
// dst[m * g.chan + r * g.cols + c]; zero outside the image and past M.
// The NT / 32 warps split evenly over the BM channels (compile-time), a
// warp's lanes run along a row (contiguous global reads) and its rows
// advance by a running pointer: no division per row or element.
template <int NT, int BM>
__device__ __forceinline__ void halo_load_raw(float* dst,
                                              const float* __restrict__ x,
                                              const HaloGeo& g,
                                              const HaloBlock& hb, int m0,
                                              int tid) {
  constexpr int WPC = NT / 32 / BM;            // warps per channel
  static_assert(NT % 32 == 0 && (NT / 32) % BM == 0,
                "whole warps, split evenly over the channels");
  const int lane = tid % 32, warp = tid / 32;
  const int m = warp / WPC, r_first = warp % WPC;
  const bool m_ok = m0 + m < g.M;
  const float* plane = x + ((size_t)hb.b * g.M + (m_ok ? m0 + m : 0)) *
                               g.H * g.W;
  float* d = dst + m * g.chan;
  for (int r = r_first; r < g.rows; r += WPC) {
    const int gr = hb.r0 + r;
    const bool row_ok = m_ok && (unsigned)gr < (unsigned)g.H;
    const float* src = row_ok ? plane + (size_t)gr * g.W + hb.c0 : x;
    float* dr = d + r * g.cols;
    for (int c = lane; c < g.cols; c += 32) {
      const bool ok = row_ok && (unsigned)(hb.c0 + c) < (unsigned)g.W;
      cp_async4(dr + c, ok ? src + c : x, ok);
    }
  }
}

// soff[s] = raw offset of window element s = u*K + v: u*cols + v (once
// per CTA, S entries)
template <int NT>
__device__ __forceinline__ void halo_window_offsets(int* soff,
                                                    const HaloGeo& g,
                                                    int tid) {
  for (int s = tid; s < g.K * g.K; s += NT)
    soff[s] = (s / g.K) * g.cols + s % g.K;
}

// Offset of output element (s2, n, tile slot p) of the block in
// y[B, N, H_out, W_out], or -1 where nothing is stored (the slot holds no
// tile, or the position lies in the 'same'-crop margin).
__device__ __forceinline__ long long halo_out_offset(const HaloGeo& g,
                                                     const HaloBlock& hb,
                                                     int N, int s2, int n,
                                                     int p) {
  if (!hb.real(g, p)) return -1;
  const int ii = p / g.btw, jj = p - ii * g.btw;
  const int u = s2 / g.t, v = s2 - u * g.t;
  const int row = (hb.ib * g.bth + ii) * g.t + u - g.crop;
  const int col = (hb.jb * g.btw + jj) * g.t + v - g.crop;
  if ((unsigned)row >= (unsigned)g.H_out ||
      (unsigned)col >= (unsigned)g.W_out)
    return -1;
  return (((long long)hb.b * N + n) * g.H_out + row) * g.W_out + col;
}

// The halo input path of a kernel whose CTA takes BM channels per step
// into BP tile slots with NT threads: the raw activation x [B, M, H, W]
// in, one halo block per CTA (tile block), output y [B, N, H_out, W_out].
// The ring stage holds the block's raw rows, which the tile-FFT reads by
// offset (the S window offsets in shared memory).
template <int NT, int BM, int BP>
struct HaloPath {
  const float* x;
  HaloGeo g;
  struct Blk {
    HaloBlock hb;
  };
  __host__ __device__ int blocks() const { return g.B * g.nbh * g.nbw; }
  __host__ __device__ int x_floats(int) const { return BM * g.chan; }
  __device__ Blk block(int bx, int) const { return {HaloBlock::of(g, bx)}; }
  __device__ void load(const Blk& k, float* sx, int, int, int m0,
                       int tid) const {
    halo_load_raw<NT, BM>(sx, x, g, k.hb, m0, tid);
  }
  __device__ long long out_at(const Blk& k, int s2, int n, int N,
                              int p) const {
    return halo_out_offset(g, k.hb, N, s2, n, p);
  }
  // The tile-FFT reads its B operand straight from the raw rows: window
  // element s of (channel, slot) column `col` is raw[base + soff[s]], 0 in
  // a slot that holds no tile.
  struct FftCol {
    int base;
    bool real;
  };
  template <int T>
  __device__ void load_os(const Blk& k, float* sx, int S, int M, int m0,
                          int tid) const {
    static_assert(T == NT, "the path's own thread count");
    load(k, sx, S, M, m0, tid);
  }
  __device__ void fft_offsets(int* soff, int tid) const {
    halo_window_offsets<NT>(soff, g, tid);
  }
  __device__ FftCol fft_col(const Blk& k, int col, int) const {
    const int m = col / BP, p = col - m * BP;
    const int ii = p / g.btw, jj = p - ii * g.btw;
    return {m * g.chan + ii * g.t * g.cols + jj * g.t, k.hb.real(g, p)};
  }
  __device__ float fft_x(const float* raw, const int* soff, FftCol c, int s,
                         int S) const {
    return c.real && s < S ? raw[c.base + soff[s]] : 0.f;
  }
};

}  // namespace repro_torch
