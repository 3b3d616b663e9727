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
// MAC for each of P tiles (8 flops); X [M, F, P] and Y [N', F, P] (complex)
// are read and written once: well under a flop a byte at batch 1 (P = the
// tiles of one image).  At VGG16's conv5 (M 512, T 19, P 9) the tables are
// 13 MB of a layer's 15 MB.
//
// Design (fp32 on CUDA cores; warp-specialised, channel-parallel):
//  * The grid is (tile block x lane block x channel range g).  A CTA has
//    8 consumer warps, warp w PE lane n0 + w and its thread i tile p0 + i
//    (BP = 32 tiles a CTA), and 6 producer warps that stage the operands.
//    It runs the channels [g RM, (g + 1) RM) in (channel, cycle) order.
//    The ranges spread the channels over the card (conv5 at batch 1: 17
//    ranges of 31 channels; the TPU grid, and the first CUDA version,
//    walked all 512 in one CTA).  With G ranges > 1 each CTA writes its
//    partial to slice g of a workspace [G][2][N'][F][P] and a second
//    launch (`sum_slices.cuh`) sums the slices in ascending g: no atomics,
//    the same bits every launch.  With G = 1 the CTA stores Y.
//  * A warp's 32 threads share one lane, so every table read is a
//    broadcast and the bin a cycle adds into (oidx) is the same across the
//    warp: each thread's accumulator column acc[0 .. F][its tile] (complex,
//    in shared memory; row F takes the masked entries' adds and is never
//    stored) is read, added to and written with no bank conflict, and X
//    rows are read the same way.  8 lanes x 32 tiles x (F + 1) bins take
//    133 KB at F = 64, so with the ring one CTA (14 warps) fits an SM, not
//    two: the accumulator costs 520 bytes a lane and tile whatever the CTA
//    shape, and fewer lanes a CTA would stage each X row for fewer lanes.
//    (Accumulators in registers, picked by a warp-uniform switch on the
//    bin, cost an indirect branch a cycle, and ran slower.)
//  * A step is one channel's next TC cycles (TC <= 32; the wrapper's tables
//    pad every channel to the same T, usually one step a channel).  The
//    producers copy its X (for P <= 32 the channel's [F][P] block in
//    16-byte copies; else each row's 32 tiles as nine 16-byte copies from
//    the 16-byte boundary at or below the first, for any P, the row's
//    shift applied on the read), its five table planes ([TC][8] lanes
//    each, 16-byte copies where N' % 4 == 0) and its replica rows ([TC][R],
//    16-byte copies of the aligned window) into a three-slot ring;
//    `cp.async.mbarrier.arrive.noinc` completes the slot's `full` mbarrier
//    when the copies land, and the consumers release it on `empty`.  The
//    copies and their address arithmetic run beside the adds, not before
//    them (behind a CTA-wide barrier they took as long as the adds).
//  * A consumer warp first resolves the step's cycles in parallel (thread
//    i: cycle i's weight times its mask, the X offset of its bin and its
//    accumulator row, into a float4), then adds the cycles in pairs; the
//    entries of pair k + 2 and the X values of pair k + 1 are loaded before
//    pair k adds.  Each add is the plain version's own arithmetic, v (wr
//    x_r - wi x_i) rounded as written (v folded into the weight, exact for
//    the scheduler's 0 / 1 masks), so with the same channel ranges the two
//    agree bit for bit.
//  * Ragged P: tiles past P read what the staged row holds and are not
//    stored; lanes past N' are zero-filled (valid 0) and not stored.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "sm90.cuh"
#include "sum_slices.cuh"

namespace {

using repro_torch::clamp_bytes;
using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::sm90::mbar_arrive;
using repro_torch::sm90::mbar_init;
using repro_torch::sm90::mbar_wait;
using repro_torch::sm90::smem_addr;

constexpr int BP = 32;             // tiles a CTA: one a thread of a warp
constexpr int XW = BP + 4;         // floats of a staged X row: 9 copies
constexpr int WARPS = 8;           // consumer warps: PE lanes a CTA
constexpr int PRODUCERS = 6;       // producer warps
constexpr int NT = 32 * (WARPS + PRODUCERS);
constexpr int STAGES = 3;          // ring slots
constexpr int TC_MAX = 32;         // most cycles a step stages
constexpr int ENT = TC_MAX + 8;    // resolved entries a warp keeps
constexpr int SMEM_MAX = 232448;   // bytes a CTA may take

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of one ring slot: X [2][F][XW], five planes [TC][WARPS], and the
// replica rows' aligned window (TC R + 3 words).
__host__ __device__ inline int slot_floats(int F, int R, int TC) {
  return round4(2 * F * XW + 5 * TC * WARPS + TC * R + 3);
}

// Floats of one warp's accumulators: [2][F + 1][BP].
__host__ __device__ inline int acc_floats(int F) { return 2 * (F + 1) * BP; }

// Bytes of a CTA's shared memory with TC cycles a step: the accumulators,
// the ring, each consumer warp's resolved entries and the 2 x STAGES
// mbarriers.
__host__ __device__ inline int smem_bytes_at(int F, int R, int TC) {
  return 4 * (WARPS * acc_floats(F) + STAGES * slot_floats(F, R, TC)) +
         16 * ENT * WARPS + 8 * 2 * STAGES;
}

// The cycles a step stages: the most (<= min(T, TC_MAX)) that fit a CTA.
int cycles_per_step(int F, int R, int T) {
  for (int tc = T < TC_MAX ? T : TC_MAX; tc > 1; --tc)
    if (smem_bytes_at(F, R, tc) <= SMEM_MAX) return tc;
  return 1;
}

int smem_bytes(int F, int R, int T) {
  return smem_bytes_at(F, R, cycles_per_step(F, R, T));
}

// Arrive on `bar` once this thread's cp.async copies so far have landed
// (the barrier's count includes the arrival: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__global__ void __launch_bounds__(NT)
table_kernel(const int* __restrict__ idx, const int* __restrict__ sel,
             const float* __restrict__ valid, const float* __restrict__ vr,
             const float* __restrict__ vi, const int* __restrict__ oidx,
             const float* __restrict__ xr, const float* __restrict__ xi,
             float* __restrict__ yr, float* __restrict__ yi,
             float* __restrict__ ws, int M, int T, int R, int NP, int F,
             int P, int TC, int RM, int G, int vec_t, int contig) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + WARPS * acc_floats(F);
  const int slot_sz = slot_floats(F, R, TC);
  float4* ents = reinterpret_cast<float4*>(ring + STAGES * slot_sz);
  uint64_t* full = reinterpret_cast<uint64_t*>(ents + ENT * WARPS);
  uint64_t* empty = full + STAGES;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * WARPS;
  const long long p0 = (long long)blockIdx.x * BP;
  const int g = blockIdx.z;
  const int mlo = g * RM, mhi = min(M, mlo + RM);
  const int chunks = (T + TC - 1) / TC;
  const int steps = (mhi - mlo) * chunks;
  const int hi = (int)(P - p0 < BP ? P - p0 : BP);  // live tiles
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32 * PRODUCERS);
      mbar_init(&empty[i], WARPS);
    }
    repro_torch::sm90::mbar_fence_init();
  }
  __syncthreads();

  if (w >= WARPS) {                // a producer: stage every step in turn
    const int pt = threadIdx.x - 32 * WARPS;
    const float* planes[5] = {valid, vr, vi,
                              reinterpret_cast<const float*>(sel),
                              reinterpret_cast<const float*>(oidx)};
    const float* xs[2] = {xr, xi};
    for (int s = 0; s < steps; ++s) {
      const int slot_i = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[slot_i], (s / STAGES - 1) & 1);
      const int m = mlo + s / chunks, t0 = (s % chunks) * TC;
      const int tc = T - t0 < TC ? T - t0 : TC;
      float* slot = ring + slot_i * slot_sz;
      if (contig) {
        // P <= BP: the channel's X is one aligned block [F][P] a part
        const int q = F * P / 4;
        for (int j = pt; j < 2 * q; j += 32 * PRODUCERS) {
          const int part = j >= q, c = j - part * q;
          cp_async16(slot + part * F * XW + 4 * c,
                     xs[part] + (long long)m * F * P + 4 * c, 16);
        }
      } else {
        // X row f: tiles [p0, p0 + BP) from the 16-byte boundary at or
        // below p0; bytes past the row's live tiles are not read
        const long long chan = (long long)m * F * P + p0;
        const int head = (int)(chan & 3);
        const float* x0 = xr + (chan - head);
        const float* x1 = xi + (chan - head);
        for (int j = pt; j < 2 * F * (XW / 4); j += 32 * PRODUCERS) {
          const int row = j / (XW / 4), c = j - row * (XW / 4);
          const int part = row >= F, f = row - part * F;
          const int lo = head + f * P;           // from x0 / x1
          const int start = (lo & ~3) + 4 * c;
          const int bytes = clamp_bytes(lo + hi - start);
          if (bytes)
            cp_async16(slot + row * XW + 4 * c, (part ? x1 : x0) + start,
                       bytes);
        }
      }
      float* lanes = slot + 2 * F * XW;
      const long long row0 = (long long)m * T + t0;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float* dst = lanes + k * TC * WARPS;
        if (vec_t) {
          for (int j = pt; j < 2 * tc; j += 32 * PRODUCERS) {
            const int t = j / 2, c = j % 2;
            const int bytes = clamp_bytes(NP - n0 - 4 * c);
            cp_async16(dst + t * WARPS + 4 * c,
                       bytes ? planes[k] + (row0 + t) * NP + n0 + 4 * c
                             : planes[k],
                       bytes);
          }
        } else {
          for (int j = pt; j < tc * WARPS; j += 32 * PRODUCERS) {
            const int t = j / WARPS, c = j % WARPS;
            const bool in = n0 + c < NP;
            cp_async4(dst + j, in ? planes[k] + (row0 + t) * NP + n0 + c
                                  : planes[k], in);
          }
        }
      }
      // replica rows [row0 R, (row0 + tc) R): their aligned window
      const long long r0 = row0 * R, r1 = r0 + (long long)tc * R;
      float* reps = lanes + 5 * TC * WARPS;
      const float* src = reinterpret_cast<const float*>(idx);
      for (int j = pt; 4LL * j < r1 - (r0 & ~3LL); j += 32 * PRODUCERS) {
        const long long start = (r0 & ~3LL) + 4 * j;
        const int bytes = clamp_bytes((int)(r1 - start));
        cp_async16(reps + 4 * j, src + start, bytes);
      }
      cp_async_arrive(&full[slot_i]);
    }
    repro_torch::cp_async_wait_all();
    return;
  }

  // a consumer: lane n0 + w, tile p0 + lane
  float* acc_r = smem + w * acc_floats(F) + lane;
  float* acc_i = acc_r + (F + 1) * BP;
  for (int k = 0; k <= F; ++k) acc_r[k * BP] = acc_i[k * BP] = 0.f;
  // this warp's resolved entries of the current step: per cycle (v wr,
  // v wi, X offset, accumulator row); masked (v == 0) and padding cycles
  // add into row F
  float4* ent = ents + w * ENT;
  for (int s = 0; s < steps; ++s) {
    const int slot_i = s % STAGES;
    mbar_wait(&full[slot_i], (s / STAGES) & 1);
    const float* slot = ring + slot_i * slot_sz;
    const int m = mlo + s / chunks, t0 = (s % chunks) * TC;
    const int tc = T - t0 < TC ? T - t0 : TC;
    const int* reps = reinterpret_cast<const int*>(
        slot + 2 * F * XW + 5 * TC * WARPS) +
        (int)(((long long)m * T + t0) * R & 3);
    // X row b of the slot starts at b * xp (+ its 16-byte shift)
    const int base = contig ? 0 : (int)((((long long)m * F) * P + p0) & 3);
    const int xp = contig ? P : XW, pm = contig ? 0 : P & 3;
    if (lane < tc) {  // thread i resolves cycle i's route, in parallel
      const float* pl = slot + 2 * F * XW + lane * WARPS + w;
      const int* il = reinterpret_cast<const int*>(pl);
      const float v = pl[0];
      const int b = reps[lane * R + il[3 * TC * WARPS]];
      const int out = v != 0.f ? il[4 * TC * WARPS] : F;
      // the weight times the mask (exact for the scheduler's 0 / 1), the
      // X offset of bin b, the accumulator row of bin out
      ent[lane] = make_float4(v * pl[TC * WARPS], v * pl[2 * TC * WARPS],
                              __int_as_float(b * xp + ((base + b * pm) & 3)),
                              __int_as_float(out * BP));
    }
    if (lane < ENT - TC_MAX)       // padding cycles past tc
      ent[tc + lane] = make_float4(0.f, 0.f, 0.f, __int_as_float(F * BP));
    __syncwarp();
    const float* x_r = slot + lane;
    const float* x_i = x_r + F * XW;
    float4 ea = ent[0], eb = ent[1], ec = ent[2], ed = ent[3];
    float xar = x_r[__float_as_int(ea.z)], xai = x_i[__float_as_int(ea.z)];
    float xbr = x_r[__float_as_int(eb.z)], xbi = x_i[__float_as_int(eb.z)];
#pragma unroll 2
    for (int t = 0; t < tc; t += 2) {
      const float4 ee = ent[t + 4], ef = ent[t + 5];
      const float xcr = x_r[__float_as_int(ec.z)];
      const float xci = x_i[__float_as_int(ec.z)];
      const float xdr = x_r[__float_as_int(ed.z)];
      const float xdi = x_i[__float_as_int(ed.z)];
      // the plain version's arithmetic, v (wr x_r - wi x_i), as written
      const float dar = __fsub_rn(__fmul_rn(ea.x, xar), __fmul_rn(ea.y, xai));
      const float dai = __fadd_rn(__fmul_rn(ea.x, xai), __fmul_rn(ea.y, xar));
      const float dbr = __fsub_rn(__fmul_rn(eb.x, xbr), __fmul_rn(eb.y, xbi));
      const float dbi = __fadd_rn(__fmul_rn(eb.x, xbi), __fmul_rn(eb.y, xbr));
      const int oa = __float_as_int(ea.w), ob = __float_as_int(eb.w);
      float ar = acc_r[oa], ai = acc_i[oa];
      float br = acc_r[ob], bi = acc_i[ob];
      ar += dar;
      ai += dai;
      if (oa == ob) {              // one bin twice: add in cycle order
        br = ar;
        bi = ai;
      }
      br += dbr;
      bi += dbi;
      acc_r[oa] = ar;
      acc_i[oa] = ai;
      acc_r[ob] = br;              // stored last: wins where oa == ob
      acc_i[ob] = bi;
      ea = ec;
      eb = ed;
      ec = ee;
      ed = ef;
      xar = xcr;
      xai = xci;
      xbr = xdr;
      xbi = xdi;
    }
    __syncwarp();                  // the slot and ent are done with
    if (lane == 0) mbar_arrive(&empty[slot_i]);
  }
  if (n0 + w >= NP || p0 + lane >= P) return;
  const long long plane = (long long)NP * F * P;
  const long long o = (long long)(n0 + w) * F * P + p0 + lane;
  float* outr = (G > 1 ? ws + 2LL * g * plane : yr) + o;
  float* outi = (G > 1 ? ws + (2LL * g + 1) * plane : yi) + o;
  for (int k = 0; k < F; ++k) {
    outr[(long long)k * P] = acc_r[k * BP];
    outi[(long long)k * P] = acc_i[k * BP];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

int launch(const int* idx, const int* sel, const float* valid,
           const float* vr, const float* vi, const int* oidx, const float* xr,
           const float* xi, float* yr, float* yi, float* ws, int M, int T,
           int R, int NP, int F, int P, int RM, cudaStream_t stream) {
  const int G = (M + RM - 1) / RM;
  if (G > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const long long lane_blocks = (NP + WARPS - 1) / WARPS;
  if (lane_blocks > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(F, R, T);
  const int TC = cycles_per_step(F, R, T);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (!aligned16(xr) || !aligned16(xi) || !aligned16(idx))
    return (int)cudaErrorInvalidValue;
  const int contig = P <= BP && F * P % 4 == 0;
  const int vec_t = NP % 4 == 0 && aligned16(valid) && aligned16(vr) &&
                    aligned16(vi) && aligned16(sel) && aligned16(oidx);
  const dim3 grid((unsigned)((P + BP - 1) / BP), (unsigned)lane_blocks,
                  (unsigned)G);
  table_kernel<<<grid, NT, bytes, stream>>>(
      idx, sel, valid, vr, vi, oidx, xr, xi, yr, yi, ws, M, T, R, NP, F, P,
      TC, RM, G, vec_t, contig);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return (int)err;
  return (int)repro_torch::launch_sum_slices(ws, yr, yi,
                                             (long long)NP * F * P, G,
                                             stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA needs for F bins, R replicas and T
// cycles a channel: the accumulators, the table ring and the resolved
// entries, with the cycles a step stages sized as the launch sizes them.
int sparse_hadamard_smem_bytes(int F, int R, int T) {
  return smem_bytes(F, R, T);
}

// Tables and planes as above (contiguous; every idx entry in [0, F), every
// sel in [0, R), every oidx in [0, F)); m ranges of RM channels, with G =
// ceil(M / RM) > 1 ranges ws is a workspace of G * 2 * N' * F * P floats.
// The caller checks shapes, devices, layouts and the shared-memory size.
int scheduled_sparse_hadamard_f32(const int* idx, const int* sel,
                                  const float* valid, const float* vr,
                                  const float* vi, const int* oidx,
                                  const float* xr, const float* xi, float* yr,
                                  float* yi, float* ws, int M, int T, int R,
                                  int NP, int F, int P, int RM,
                                  void* stream) {
  if (NP < 1 || F < 1 || P < 1 || M < 1 || T < 1 || R < 1 || RM < 1)
    return (int)cudaErrorInvalidValue;
  return launch(idx, sel, valid, vr, vi, oidx, xr, xi, yr, yi, ws, M, T, R,
                NP, F, P, RM, (cudaStream_t)stream);
}

}  // extern "C"
