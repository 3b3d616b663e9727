// Blocked online-softmax (flash) attention in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// `flash_attention` (body `_attn_kernel`) for f32 inputs, the attention
// of every layer of an f32 LM prefill at S >= 4096 (bf16 inputs run
// flash_attention_bf16.cu, on the tensor cores).  For each query row q
// of head h, with KV head g = h / (Hq / Hkv):
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
// each of q, k, v, o: at S = 4096, D = 128 that is ~1000 flops a byte,
// fifty times the card's f32 balance (67 TFLOP/s over 3.35 TB/s).  The
// reference's arithmetic is f32, so the work runs as f32 FMAs on the CUDA
// cores (no tensor cores in this first kernel), and the design keeps the
// FMA pipes fed from registers and shared memory:
//  * One CTA of 256 threads per (batch x query head, 64-row query tile);
//    the heaviest causal tiles launch first.  The Q tile sits in shared
//    memory transposed ([D][64], read as float4 of a thread's four rows);
//    K and V tiles of 64 rows stream through shared memory in f32.
//    About 112 KB a CTA at D = 128, so two CTAs share an SM.
//  * Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3:
//    the S tile's columns tx + 16 j (j < 4) and the output's columns
//    tx + 16 j (j < D / 16).  The row max and sum of the online softmax
//    are reduced over the 16 lanes of a row group with warp shuffles, so
//    the running state stays in registers with no shared-memory pass.
//  * P goes through shared memory transposed, in float4 groups of four
//    rows XOR-swizzled by column, so both its stores and the P.V loads
//    are free of bank conflicts; K rows are padded by one float.
//  * KV tiles wholly above the causal diagonal or wholly outside the
//    window are skipped: for every row of the tile they would add p = 0
//    with alpha = 1, an exact no-op.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // key rows per streamed tile
constexpr int NT = 256;           // threads: 16 row groups x 16 lanes
constexpr int RG = BQ / 16;       // query rows per thread
constexpr int CJ = BK / 16;       // S-tile columns per thread
constexpr float NEG_INF = -1e30f;
static_assert(RG == 4, "a thread's rows are one float4 of the Q/P tiles");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Shared floats of one CTA for head dims up to DP = 16 DJ.
constexpr size_t smem_floats(int dp) {
  return (size_t)dp * BQ + (size_t)BK * (dp + 1) + (size_t)BK * dp
         + (size_t)BK * BQ;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DJ>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int group, int s, int d, float scale, int causal,
                       int use_window, int window) {
  constexpr int DP = 16 * DJ;     // head dim padded to the lane grid
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [DP][BQ]   Q transposed
  float* ks = qt + DP * BQ;       // [BK][DP+1] K, rows padded
  float* vs = ks + BK * (DP + 1); // [BK][DP]   V
  float* pt = vs + BK * DP;       // [BK][BQ]   P transposed, swizzled

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_q = (s + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;
  const long long bh = blockIdx.y;            // b * hq + h
  const long long kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const T* qg = q + (bh * s + q0) * d;
  const T* kg = k + kvh * s * d;
  const T* vg = v + kvh * s * d;

  // Q tile, transposed; rows past S and columns past D are zero.
  // Consecutive threads take consecutive rows: conflict-free stores.
  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e % BQ, c = e / BQ;
    float x = 0.f;
    if (q0 + r < s && c < d) x = to_f32(qg[(long long)r * d + c]);
    qt[c * BQ + r] = x;
  }

  // KV tiles this query tile can see.
  const int q_last = min(q0 + BQ, s) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (s + BK - 1) / BK;
  int kt_begin = 0;
  if (use_window) {
    const long long lo = (long long)q0 - window + 1;   // first key row 0 sees
    kt_begin = lo <= 0 ? 0 : (int)min(lo / BK, (long long)kt_end);
  }

  float m[RG], l[RG], acc[RG][DJ];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the last tile's K, V and P are read
    for (int e = tid; e < BK * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < s && c < d) {
        const long long off = (long long)(k0 + r) * d + c;
        kx = to_f32(kg[off]);
        vx = to_f32(vg[off]);
      }
      ks[r * (DP + 1) + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows 4 ty + i, columns tx + 16 j
    float sc[RG][CJ];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[c * BQ + ty * RG]);
      const float qr[RG] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float kx = ks[(tx + 16 * j) * (DP + 1) + c];
#pragma unroll
        for (int i = 0; i < RG; ++i) sc[i][j] = fmaf(qr[i], kx, sc[i][j]);
      }
    }

    // mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int qi = q0 + ty * RG + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int ki = k0 + tx + 16 * j;
        bool ok = ki < s;
        if (causal) ok = ok && ki <= qi;
        if (use_window) ok = ok && (long long)ki > (long long)qi - window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      const bool live = m_new > NEG_INF / 2;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        sc[i][j] = live ? expf(sc[i][j] - m_new) : 0.f;
        row_sum += sc[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(row_sum);
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      *reinterpret_cast<float4*>(&pt[c * BQ + ((ty ^ (c & 7)) << 2)]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

    // acc += P V for rows 4 ty + i, columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < BK; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(
          &pt[r * BQ + ((ty ^ (r & 7)) << 2)]);
      const float pr[RG] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vx = vs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[i][j] = fmaf(pr[i], vx, acc[i][j]);
      }
    }
  }

  T* og = o + (bh * s + q0) * d;
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int r = ty * RG + i;
    if (q0 + r >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(&og[(long long)r * d + c], acc[i][j] / den);
    }
  }
}

template <typename T, int DJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int s, int d, float scale,
                   int causal, int use_window, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(16 * DJ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, DJ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hq / hkv, s, d,
      scale, causal, use_window, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int d, float scale, int causal,
             int use_window, int window, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || s < 1 || d < 1 || d > 128
      || (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define FA_CASE(DJ)                                                         \
  case DJ:                                                                  \
    return (int)launch<T, DJ>(q, k, v, o, b, hq, hkv, s, d, scale, causal,  \
                              use_window, window, st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4)
    FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int s, int d, float scale,
                                   int causal, int use_window, int window,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, b, hq, hkv, s, d, scale, causal,
                         use_window, window, stream);
}
