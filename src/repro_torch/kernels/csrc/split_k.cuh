// The split-K finish pass shared by the port's weight- and input-stationary
// kernels (fused_spectral_conv.cu, fused_spectral_conv_scheduled.cu).  They
// replace the TPU kernels' spatial-psum read-modify-write
// (`_dma_rmw_start` :487 / `_dma_rmw_finish` :497 in
// src/repro/kernels/fused_spectral_conv.py).
//
// On the TPU the ws/is grids carry the spatial psum of an output rectangle
// across an "arbitrary" m axis that runs in order on one core: the first m
// visit writes it, later visits add to it, the last applies the epilogue.
// CUDA CTAs run in no order and nothing outlives a CTA, so the m ranges of a
// layer are split over CTAs instead: the CTA of m range g writes its partial
// (the valid-row IFFT of its channels' Hadamard sum, no bias) to slice g of
// a workspace [G, S2, N, slots] in device memory, and this second launch sums
// the G slices in ascending g, adds the bias, applies ReLU and stores the
// finished element through the input path's output map (windowed tiles
// [S2, N, P], or the halo path's NCHW output through halo_out_offset).  No
// atomics: a launch gives the same bits every time.  With a residual
// shortcut (SC_GLOBAL, shortcut.cuh) it adds sc[o] after the bias and
// before the ReLU, o being the output offset it stores to.
//
// `slots` is the workspace's tile axis: tile-block bx, slot p of the
// kernel's BP tile slots is column bx * BP + p (padding slots, which no
// output maps to, are written by the main kernel and skipped here).
//
// Bound: bytes, 4 * (G + 1) * S2 * N * slots (each slice read once, each
// output written once; the shortcut adds one output-sized read).
#pragma once

#include <cuda_runtime.h>

#include "shortcut.cuh"

namespace repro_torch {

template <class Path, int BP, int SC>
__global__ void __launch_bounds__(256)
finish_partials_kernel(const Path io, const float* __restrict__ ws,
                       const float* __restrict__ bias,
                       const float* __restrict__ sc, float* __restrict__ y,
                       int G, int S2, int N, int slots, int relu) {
  static_assert(SC == SC_NONE || SC == SC_GLOBAL, "no staged shortcut here");
  const long long plane = (long long)S2 * N * slots;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < plane; i += (long long)gridDim.x * blockDim.x) {
    const int slot = (int)(i % slots);
    const long long sn = i / slots;
    const int n = (int)(sn % N), s2 = (int)(sn / N);
    const long long o =
        io.out_at(io.block(slot / BP, 0), s2, n, N, slot % BP);
    if (o < 0) continue;
    float v = ws[i];
    for (int g = 1; g < G; ++g) v += ws[g * plane + i];
    v += bias[n];
    if constexpr (SC == SC_GLOBAL) v += sc[o];
    if (relu) v = fmaxf(v, 0.f);
    y[o] = v;
  }
}

// Launch the finish pass on `stream` (grid-stride, at most 8 CTAs a SM).
template <class Path, int BP, int SC>
cudaError_t launch_finish(const Path& io, const float* ws, const float* bias,
                          const float* sc, float* y, int G, int S2, int N,
                          int slots, int relu, cudaStream_t stream) {
  const long long plane = (long long)S2 * N * slots;
  long long blocks = (plane + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  finish_partials_kernel<Path, BP, SC><<<(unsigned)blocks, 256, 0, stream>>>(
      io, ws, bias, sc, y, G, S2, N, slots, relu);
  return cudaGetLastError();
}

}  // namespace repro_torch
