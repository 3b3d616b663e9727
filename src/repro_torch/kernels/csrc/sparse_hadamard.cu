// The standalone Alg-2 table executor (the paper's Fig-6 datapath) for one
// PE group of N' sparse kernels over all input channels, for Hopper
// (sm_90a):
//
//   per channel m, cycle t, PE lane n:
//     bin    = idx[m, t, sel[m, t, n]]             (replica read + route)
//     Y[n, oidx[m, t, n], p] += valid * (vr + i vi)[m, t, n] * X[m, bin, p]
//
//   idx [M, T, R] int32; sel, oidx [M, T, N'] int32;
//   valid, vr, vi [M, T, N'] f32; xr/xi [M, F, P] f32 -> yr/yi [N', F, P]
//
// Replaces the TPU kernel `scheduled_sparse_hadamard` (body `_kernel`) of
// src/repro/kernels/sparse_hadamard.py, which `ops.scheduled_sparse_conv_
// group` wraps.  On the TPU the gather, the route and the scatter are
// one-hot matmuls; here they are indexed shared-memory reads and writes.
//
// Bound on an H100 SXM: bytes.  Every table entry (6 words a lane and
// cycle, plus R replica words a cycle) is read once and feeds one complex
// MAC for each of P tiles (8 flops), X and Y are read and written once:
// well under a flop a byte at batch 1 (P = T tiles of one image).
//
// Design (fp32 FMA on CUDA cores):
//  * A CTA owns BP = 4 tiles for every lane and every bin: its complex
//    accumulator [N'][F][4] lives in shared memory (128 KB at N' = F = 64,
//    each lane's row padded by 4 floats against bank conflicts).  Thread
//    (lane n, tile p) owns accumulator column (n, :, p) for the whole run,
//    so each of its adds is its own read-modify-write: no race, no atomic.
//  * The CTA walks the channels in order and, within a channel, the
//    cycles in order, as the TPU kernel's grid and fori_loop do: every
//    accumulator sees its adds in the reference's order.
//  * A step is one channel's next TC cycles (TC <= 32, the most that fit
//    beside the accumulator; usually a whole channel): the step's table
//    rows (idx [TC][R], sel / valid / vr / vi / oidx [TC][N']) and the
//    channel's X rows of the CTA's 4 tiles ([F][4], complex) arrive by
//    4-byte cp.async into a two-slot ring while the previous step
//    computes, so a lane's cycle reads only shared memory.  (The first
//    version read each entry from device memory in the cycle loop: 89 ms
//    for VGG16's 13 layers, latency-bound with 3 to 361 CTAs.)
//  * Padded cycles (stack_tables pads a channel to the longest cycle
//    count) have valid = 0 and weight 0: a lane skips an entry whose valid
//    is 0, so they stay inert.
//  * Ragged P: tiles past P are zero-filled on the stage and not stored.
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait_all;
using repro_torch::cp_async_wait_prev;

constexpr int BP = 4;              // tiles per CTA
constexpr int NT = 256;            // threads: up to 64 lanes x 4 tiles
constexpr int MAX_NP = NT / BP;    // most PE lanes a group may have
constexpr int TC_MAX = 32;         // most cycles a step stages

// Floats of one ring slot: X [2][F][BP], then per cycle N' words of each
// of valid, vr, vi, sel, oidx and R words of idx.
__host__ __device__ inline int slot_floats(int NP, int F, int R, int TC) {
  return 2 * F * BP + TC * (5 * NP + R);
}

__host__ __device__ inline int smem_floats(int NP, int F, int R, int TC) {
  return 2 * NP * (F * BP + 4) + 2 * slot_floats(NP, F, R, TC);
}

// Start the copies of step (m, t0) into `slot` (tc cycles from t0).
__device__ __forceinline__ void stage(
    float* slot, const int* idx, const int* sel, const float* valid,
    const float* vr, const float* vi, const int* oidx, const float* xr,
    const float* xi, int m, int t0, int tc, int T, int R, int NP, int F,
    int P, long long p0) {
  float* x = slot;
  for (int e = threadIdx.x; e < 2 * F * BP; e += NT) {
    const int part = e / (F * BP), f = (e / BP) % F, q = e % BP;
    const bool in = p0 + q < P;
    const long long src = in ? ((long long)m * F + f) * P + p0 + q : 0;
    cp_async4(x + e, (part ? xi : xr) + src, in);
  }
  float* lanes = slot + 2 * F * BP;
  const long long row = (long long)m * T + t0;
  const float* planes[5] = {valid, vr, vi,
                            reinterpret_cast<const float*>(sel),
                            reinterpret_cast<const float*>(oidx)};
  for (int e = threadIdx.x; e < 5 * tc * NP; e += NT) {
    const int k = e / (tc * NP), i = e % (tc * NP);
    cp_async4(lanes + k * TC_MAX * NP + i, planes[k] + row * NP + i, true);
  }
  float* reps = lanes + 5 * TC_MAX * NP;
  for (int e = threadIdx.x; e < tc * R; e += NT)
    cp_async4(reps + e, reinterpret_cast<const float*>(idx) + row * R + e,
              true);
}

__global__ void __launch_bounds__(NT)
sparse_hadamard_kernel(const int* __restrict__ idx,
                       const int* __restrict__ sel,
                       const float* __restrict__ valid,
                       const float* __restrict__ vr,
                       const float* __restrict__ vi,
                       const int* __restrict__ oidx,
                       const float* __restrict__ xr,
                       const float* __restrict__ xi, float* __restrict__ yr,
                       float* __restrict__ yi, int M, int T, int R, int NP,
                       int F, int P) {
  extern __shared__ __align__(16) float smem[];
  const int LS = F * BP + 4;                 // one lane's accumulator row
  float* acc_r = smem;                       // [NP][LS]
  float* acc_i = acc_r + NP * LS;
  float* ring = acc_i + NP * LS;             // two slots
  const int slot_sz = slot_floats(NP, F, R, TC_MAX);
  const int n = threadIdx.x / BP, p = threadIdx.x % BP;
  const long long p0 = (long long)blockIdx.x * BP;
  const bool live = n < NP && p0 + p < P;
  for (int e = threadIdx.x; e < 2 * NP * LS; e += NT) acc_r[e] = 0.f;
  float* ar = acc_r + n * LS + p;
  float* ai = acc_i + n * LS + p;
  const int chunks = (T + TC_MAX - 1) / TC_MAX;
  const int steps = M * chunks;
  auto fetch = [&](int s) {
    const int m = s / chunks, t0 = (s % chunks) * TC_MAX;
    const int tc = T - t0 < TC_MAX ? T - t0 : TC_MAX;
    stage(ring + (s & 1) * slot_sz, idx, sel, valid, vr, vi, oidx, xr, xi,
          m, t0, tc, T, R, NP, F, P, p0);
    cp_async_commit();
  };
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      fetch(s + 1);
      cp_async_wait_prev();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();               // step s has landed for every thread
    const float* slot = ring + (s & 1) * slot_sz;
    const float* x_r = slot;
    const float* x_i = slot + F * BP;
    const float* lanes = slot + 2 * F * BP;
    const int* reps = reinterpret_cast<const int*>(lanes + 5 * TC_MAX * NP);
    const int t0 = (s % chunks) * TC_MAX;
    const int tc = T - t0 < TC_MAX ? T - t0 : TC_MAX;
    if (live) {
      for (int t = 0; t < tc; ++t) {
        const int e = t * NP + n;
        const float v = lanes[e];
        if (v == 0.f) continue;
        const float wr = lanes[TC_MAX * NP + e];
        const float wi = lanes[2 * TC_MAX * NP + e];
        const int s_ = reinterpret_cast<const int*>(lanes)[3 * TC_MAX * NP
                                                           + e];
        const int out = reinterpret_cast<const int*>(lanes)[4 * TC_MAX * NP
                                                            + e];
        const int bin = reps[t * R + s_];
        const float in_r = x_r[bin * BP + p], in_i = x_i[bin * BP + p];
        ar[out * BP] += v * (wr * in_r - wi * in_i);
        ai[out * BP] += v * (wr * in_i + wi * in_r);
      }
    }
    __syncthreads();               // slot s & 1 is free for step s + 2
  }
  if (!live) return;
  for (int f = 0; f < F; ++f) {
    const long long o = ((long long)n * F + f) * P + p0 + p;
    yr[o] = ar[f * BP];
    yi[o] = ai[f * BP];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA needs for NP lanes, F bins and R
// replicas: the accumulator and two ring slots of TC_MAX cycles; -1 where
// the kernel takes no such group (NP outside [1, MAX_NP]).
int sparse_hadamard_smem_bytes(int NP, int F, int R) {
  if (NP < 1 || NP > MAX_NP) return -1;
  return 4 * smem_floats(NP, F, R, TC_MAX);
}

// Tables and planes as above (contiguous; NP <= 64; every idx entry in
// [0, F), every sel in [0, R), every oidx in [0, F)).  The caller checks
// shapes, devices, layouts and the shared-memory size.
int scheduled_sparse_hadamard_f32(const int* idx, const int* sel,
                                  const float* valid, const float* vr,
                                  const float* vi, const int* oidx,
                                  const float* xr, const float* xi, float* yr,
                                  float* yi, int M, int T, int R, int NP,
                                  int F, int P, void* stream) {
  if (NP < 1 || NP > MAX_NP || F < 1 || P < 1 || M < 1 || T < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const int bytes = sparse_hadamard_smem_bytes(NP, F, R);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_hadamard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((P + BP - 1) / BP);
  sparse_hadamard_kernel<<<blocks, NT, bytes, (cudaStream_t)stream>>>(
      idx, sel, valid, vr, vi, oidx, xr, xi, yr, yi, M, T, R, NP, F, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
