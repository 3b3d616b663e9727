// Blocked online-softmax (flash) attention in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// `flash_attention` (body `_attn_kernel`) for f32 inputs, the attention
// of every layer of an f32 LM prefill at S >= 4096 (bf16 inputs run
// flash_attention_bf16.cu).  For each query row q of head h, with KV head
// g = h / (Hq / Hkv):
//
//   s[k]  = (q . k_k) * D^-0.5                  in f32 from f32 inputs
//   s[k]  = -1e30 unless  k < S,  k <= q (causal),  k > q - window
//   o     = sum_k softmax(s)[k] v_k, streamed over KV tiles with a running
//           (max m, denominator l, accumulator acc) in f32; a row that has
//           seen no unmasked key keeps p = 0 (the exp(-1e30 + 1e30) = 1
//           trap); o = acc / max(l, 1e-30).
//
//   flash_attention_f32:  q [B, Hq, S, D], k, v [B, Hkv, S, D] f32 -> o
//
// Bound on an H100 SXM: operations.  A causal layer does 4 D flops per
// unmasked (q, k) pair (two products) against 2 S D bytes per head of
// each of q, k, v, o: at S = 4096, D = 128 that is ~1000 flops a byte.
// The reference's arithmetic is f32; f32 FMAs on the CUDA cores peak at
// 67 TFLOP/s, so both products run on the tensor cores in 3xTF32
// (mma_tf32.cuh: each operand split into TF32 hi + lo, lo*hi + hi*lo +
// hi*hi, lo left to the tensor cores' truncation, f32-level error) at up
// to 495 / 3 TFLOP/s, with the softmax in f32
// registers.  A KV tile's P V goes to fresh accumulators that are added
// to the running output in f32: a 4096-key sum left in the tensor cores'
// accumulator, which truncates, loses several times f32's error:
//  * One CTA of 8 warps per (batch x query head, 128-row query tile), a
//    warp owning 16 query rows; the heaviest causal tiles launch first.
//    The Q tile stays in shared memory; K and V tiles of 64 rows stream
//    through a two-stage cp.async ring (16-byte copies where D % 4 == 0
//    and the operands are aligned), so the next tile's loads overlap this
//    tile's products.  Q and K rows lie at a pitch of D + 8 floats, V rows
//    at D + 4 (D padded to 16): every fragment read is conflict-free, and
//    Q K^T's k order within 8 columns of d is permuted so that a lane's
//    A and B values are 8-byte pairs.  ~202 KB a CTA at D = 128: one CTA
//    an SM.
//  * S = Q K^T by `mma.sync.m16n8k8`: a warp's 16 x 64 scores are eight
//    accumulator tiles; the row max and sum of the online softmax reduce
//    over the four lanes of a quad with two shuffles.
//  * P leaves the accumulator in the C layout, where lane (gq, tq) holds
//    keys 2 tq and 2 tq + 1 of its rows; the TF32 A layout wants keys tq
//    and tq + 4.  Instead of moving P, the P V product takes its k index
//    permuted (k = tq <-> key 2 tq, k = tq + 4 <-> key 2 tq + 1): the C
//    registers are the A fragment as they stand, and the B fragment reads
//    V rows 2 tq and 2 tq + 1.  No shuffle and no shared-memory pass.
//  * KV tiles wholly above the causal diagonal or wholly outside the
//    window are skipped: for every row of the tile they would add p = 0
//    with alpha = 1, an exact no-op.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;
constexpr int BQ = 16 * WARPS;    // query rows per CTA
constexpr int BK = 64;            // key rows per streamed tile
constexpr int NT = 32 * WARPS;
constexpr int KN = BK / 8;        // score tiles (8 keys) a warp holds
constexpr float NEG_INF = -1e30f;

// Shared floats of one CTA for a head dim padded to DP: the Q tile and two
// stages of K and V; Q and K rows at a pitch of DP + 8 (a float2 per lane
// covers 32 banks), V rows at DP + 4.
constexpr size_t smem_floats(int dp) {
  return (size_t)(BQ + 2 * BK) * (dp + 8) + (size_t)2 * BK * (dp + 4);
}

// Rows [row0, row0 + rows) of a [s][d] matrix into dst[r][PITCH],
// zero-filled past s and d.
template <int DP, int PITCH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int row0, int s, int d,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int e = tid; e < rows * C4; e += NT) {
      const int r = e / C4, c = 4 * (e % C4);
      const int bytes = row0 + r < s ? clamp_bytes(d - c) : 0;
      cp_async16(dst + r * PITCH + c,
                 bytes ? src + (long long)(row0 + r) * d + c : src, bytes);
    }
  } else {
    for (int e = tid; e < rows * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      const bool in = row0 + r < s && c < d;
      cp_async4(dst + r * PITCH + c,
                in ? src + (long long)(row0 + r) * d + c : src, in);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int hq, int group, int s, int d, float scale,
                       int causal, int use_window, int window, int vec) {
  constexpr int QP = DP + 8, VP = DP + 4;   // row pitches
  constexpr int STAGE = BK * (QP + VP);
  constexpr int DK = DP / 8;      // k steps of Q K^T, output tiles of P V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BQ][QP]
  float* kv = qs + BQ * QP;       // 2 stages of K [BK][QP], V [BK][VP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int n_q = (s + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;
  const long long bh = blockIdx.y;            // b * hq + h
  const long long kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const float* kg = k + kvh * s * d;
  const float* vg = v + kvh * s * d;

  // KV tiles this query tile can see.
  const int q_last = min(q0 + BQ, s) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (s + BK - 1) / BK;
  int kt_begin = 0;
  if (use_window) {
    const long long lo = (long long)q0 - window + 1;   // first key row 0 sees
    kt_begin = lo <= 0 ? 0 : (int)min(lo / BK, (long long)kt_end);
  }
  auto fetch = [&](int kt, int slot) {
    float* ks = kv + slot * STAGE;
    load_rows<DP, QP>(ks, kg, BK, kt * BK, s, d, vec, tid);
    load_rows<DP, VP>(ks + BK * QP, vg, BK, kt * BK, s, d, vec, tid);
  };
  load_rows<DP, QP>(qs, q + bh * s * d, BQ, q0, s, d, vec, tid);
  if (kt_begin < kt_end) fetch(kt_begin, 0);
  cp_async_commit();

  // rows r0 and r0 + 8 of the warp's 16: (m, l) and the output tiles
  const int r0 = q0 + warp * 16 + gq;
  const float* qw = qs + (warp * 16 + gq) * QP + 2 * tq;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DK][4];
#pragma unroll
  for (int n = 0; n < DK; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int slot = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) fetch(kt + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait_prev();         // this tile (and Q) have landed
    __syncthreads();
    const float* ks = kv + slot * STAGE;
    const float* vs = ks + BK * QP;

    // S = Q K^T: the warp's 16 rows x 64 keys; within each 8 columns of
    // d the k index is permuted (k = tq <-> d = 2 tq, k = tq + 4 <-> d =
    // 2 tq + 1), so a lane's two A and two B values are adjacent: one
    // 8-byte load each
    float sc[KN][4];
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DK; ++kk) {
      const float2 q_lo = *reinterpret_cast<const float2*>(qw + kk * 8);
      const float2 q_hi =
          *reinterpret_cast<const float2*>(qw + 8 * QP + kk * 8);
      const float a[4] = {q_lo.x, q_hi.x, q_lo.y, q_hi.y};
      uint32_t ah[4], al[4];
      split_frag_raw_lo(a, ah, al);
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float2 kv2 = *reinterpret_cast<const float2*>(
            ks + (j * 8 + gq) * QP + kk * 8 + 2 * tq);
        const float b[2] = {kv2.x, kv2.y};
        uint32_t bh_[2], bl[2];
        split_frag_raw_lo(b, bh_, bl);
        mma3(sc[j], ah, al, bh_, bl);
      }
    }

    // mask, online softmax (rows r0 + 8 h; lane columns 8 j + 2 tq + e)
    const int k0 = kt * BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = r0 + 8 * h;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ki = k0 + j * 8 + 2 * tq + e;
          bool ok = ki < s;
          if (causal) ok = ok && ki <= qi;
          if (use_window) ok = ok && (long long)ki > (long long)qi - window;
          float& x = sc[j][2 * h + e];
          x = ok ? x * scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const bool live = m_new > NEG_INF / 2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * h + e];
          x = live ? expf(x - m_new) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[h] - m_new);
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DK; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
      m[h] = m_new;
    }

    // acc += P V, k permuted within each 8-key tile (see above); the
    // tile's sum in fresh accumulators, half the output columns at a time,
    // then added to acc in f32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float t[DK / 2][4];
#pragma unroll
      for (int n = 0; n < DK / 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) t[n][r] = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float a[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
        uint32_t ah[4], al[4];
        split_frag_raw_lo(a, ah, al);
        const float* vp = vs + (j * 8 + 2 * tq) * VP + half * DP / 2 + gq;
#pragma unroll
        for (int n = 0; n < DK / 2; ++n) {
          const float b[2] = {vp[n * 8], vp[VP + n * 8]};
          uint32_t bh_[2], bl[2];
          split_frag_raw_lo(b, bh_, bl);
          mma3(t[n], ah, al, bh_, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < DK / 2; ++n) add4(acc[half * DK / 2 + n], t[n]);
    }
    __syncthreads();              // the slot is free for the next fetch
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    if (qi >= s) continue;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = o + (bh * s + qi) * d;
#pragma unroll
    for (int n = 0; n < DK; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c < d) orow[c] = acc[n][2 * h] / den;
      if (c + 1 < d) orow[c + 1] = acc[n][2 * h + 1] / den;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int b, int hq, int hkv, int s, int d, float scale,
                   int causal, int use_window, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(DP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v);
  const dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<DP><<<grid, NT, smem, stream>>>(
      q, k, v, o, hq, hq / hkv, s, d, scale, causal, use_window, window,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int s, int d, float scale,
                                   int causal, int use_window, int window,
                                   void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || s < 1 || d < 1 || d > 128
      || (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define FA_CASE(DJ)                                                       \
  case DJ:                                                                \
    return (int)launch<16 * DJ>(qf, kf, vf, of, b, hq, hkv, s, d, scale,  \
                                causal, use_window, window, st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4)
    FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
