// The split-K finish pass of the staged kernels (spectral_hadamard.cu,
// sparse_hadamard.cu).  Their CTAs each sum one m range g of the input
// channels and write the complex partial to slice g of a workspace
// [G][2][plane] (re, im slices of `plane` floats); this second launch sums
// the slices in ascending g into yr/yi.  No atomics: a launch gives the same
// bits every time.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// float4 loads and stores where `plane` is a multiple of 4 (the
// workspace and outputs come from torch.empty, 256-byte aligned); the
// slice loop is unrolled so that a thread's loads are in flight together
// (G is 32 at VGG16's conv5 in the table executor).  Bound: bytes,
// 8 * (G + 1) * plane.
__global__ void __launch_bounds__(256)
sum_complex_slices_kernel(const float* __restrict__ ws, float* __restrict__ yr,
                          float* __restrict__ yi, long long plane, int G) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (plane % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    const long long q = plane / 4;
    for (long long i = first; i < q; i += stride) {
      float4 re = w4[i], im = w4[q + i];
#pragma unroll 8
      for (int g = 1; g < G; ++g) {
        const float4 a = w4[2LL * g * q + i], b = w4[(2LL * g + 1) * q + i];
        re.x += a.x; re.y += a.y; re.z += a.z; re.w += a.w;
        im.x += b.x; im.y += b.y; im.z += b.z; im.w += b.w;
      }
      reinterpret_cast<float4*>(yr)[i] = re;
      reinterpret_cast<float4*>(yi)[i] = im;
    }
    return;
  }
  for (long long i = first; i < plane; i += stride) {
    float re = ws[i], im = ws[plane + i];
#pragma unroll 8
    for (int g = 1; g < G; ++g) {
      re += ws[2LL * g * plane + i];
      im += ws[(2LL * g + 1) * plane + i];
    }
    yr[i] = re;
    yi[i] = im;
  }
}

// Launch it on `stream` (grid-stride, at most 8 CTAs a SM).
inline cudaError_t launch_sum_slices(const float* ws, float* yr, float* yi,
                                     long long plane, int G,
                                     cudaStream_t stream) {
  long long blocks = (plane / (plane % 4 == 0 ? 4 : 1) + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sum_complex_slices_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      ws, yr, yi, plane, G);
  return cudaGetLastError();
}

}  // namespace repro_torch
