// Blocked online-softmax (flash) attention in bf16 on Hopper's tensor
// cores (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// `flash_attention` (body `_attn_kernel`) for bf16 inputs, the attention
// of every layer of an LM prefill at S >= 4096.  For each query row q of
// head h, with KV head g = h / (Hq / Hkv):
//
//   s[k]  = (q . k_k) * D^-0.5        bf16 products summed in f32
//   s[k]  = -1e30 unless  k < S,  k <= q (causal),  k > q - window
//   o     = sum_k softmax(s)[k] v_k, streamed over KV tiles with a running
//           (max m, denominator l, accumulator acc) in f32; a row that has
//           seen no unmasked key keeps p = 0 (the exp(-1e30 + 1e30) = 1
//           trap); o = acc / max(l, 1e-30), rounded to bf16.
//
//   flash_attention_bf16: q [B, Hq, S, D], k, v [B, Hkv, S, D] bf16 -> o
//   (D <= 128, a multiple of 8; every operand 16-byte aligned)
//
// Numbers: a bf16 x bf16 product is exact in f32, so S = Q K^T on the
// tensor cores with f32 accumulation is the reference's arithmetic
// (`preferred_element_type=f32`) up to the order of the sum.  The one new
// rounding is P to bf16 before P V (at most 2^-9 relative a term, the size
// of the output's own bf16 rounding); l sums the f32 p.
//
// Bound on an H100 SXM: operations.  4 D flops per unmasked (q, k) pair
// at the 989 TFLOP/s bf16 tensor-core rate, against 2 S D bytes per head
// of each of q, k, v, o (~1000 flops a byte at S = 4096, three times the
// card's bf16 balance).  The design keeps the tensor cores fed:
//  * One CTA of three warpgroups per (batch x query head, 128-row query
//    tile), heaviest causal tiles first (grid x: batch x head, y: tile, so
//    every head's heaviest tile launches before any lighter one).  Two
//    consumer warpgroups own 64 query rows each; the third, the producer,
//    gives up its registers (setmaxnreg) and one of its threads issues
//    every TMA load.
//  * TMA loads from 3-D tensor maps over [B*H, S, D] with 128-byte swizzle,
//    boxes 64 columns x 128 rows (two at D > 64): the S tail and the
//    columns past D arrive as zeros, and a box never reads the next head.
//    Q loads once; K and V stream through a two-stage ring, each tile with
//    its own full and empty mbarrier, so S = Q K^T starts before V lands.
//  * S = Q K^T: wgmma m64n128k16, both operands from shared memory (K-major
//    descriptors), D/16 k-steps, f32 accumulators in registers.
//  * The online softmax runs on the accumulator registers: a row lives in a
//    quad of threads (shuffles 1 and 2); masks only on tiles that cross the
//    diagonal, the window edge or the S tail; tiles wholly masked for the
//    CTA are not loaded (for every row they would add p = 0 with alpha = 1,
//    an exact no-op).  The running max stays unscaled, so p = 2^(s c - m c)
//    is one FFMA and one ex2 an element (c = D^-0.5 log2 e); a row that has
//    seen no key takes m c = +inf, so its p are 0 with no select.  The
//    softmax's instruction count, not the tensor cores, bounds this kernel,
//    hence the one-FFMA form.
//  * O += P V: wgmma RS.  The S accumulator of two n8 blocks is the A
//    fragment of one k16 slab, so P goes to bf16 in registers with no
//    shared-memory round trip; V is the MN-major B operand (transpose bit).
//  * 160 KB of shared memory at D = 128 (Q 32 + 2 x (K 32 + V 32)): one CTA
//    an SM, 1024 CTAs at qwen3-8b's 32 heads x 4096 tokens.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace repro_torch::sm90;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;               // query rows per CTA (2 x 64)
constexpr int BK = 128;               // key rows per streamed tile
constexpr int NT = 384;               // two consumer warpgroups + producer
constexpr int STAGES = 2;             // K/V ring depth
constexpr int BOX = 128 * 128;        // bytes of one box: 128 rows x 64 bf16
constexpr int MAX_Q_TILES = 65535;    // grid y

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
struct alignas(1024) Smem {
  bf16 q[DP / 64][128 * 64];            // [box][row][64], swizzled
  bf16 k[STAGES][DP / 64][128 * 64];
  bf16 v[STAGES][DP / 64][128 * 64];
  uint64_t q_full, k_full[STAGES], k_empty[STAGES], v_full[STAGES],
      v_empty[STAGES];
};

struct Shape {
  int hq, group, s, d, causal, use_window, window;
  float scale_log2;                   // D^-0.5 * log2(e)
};

// One consumer warpgroup: 64 query rows from q_lo, all KV tiles.
template <int DP>
__device__ __forceinline__ void consume(Smem<DP>& sm, bf16* __restrict__ o,
                                        const Shape& p, int bh, int q_lo,
                                        int wg, int kt_begin, int kt_end) {
  constexpr int OA = DP / 2;          // O accumulator floats a thread
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int r0 = q_lo + 16 * warp + g, r1 = r0 + 8;   // this thread's rows

  float oacc[OA];
#pragma unroll
  for (int i = 0; i < OA; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(&sm.q_full, 0);
  const uint32_t q_base = smem_addr(sm.q[0]) + wg * 64 * 128;

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;

    // S = Q K^T
    float sacc[BK / 2];
    mbar_wait(&sm.k_full[st], ph);
    const uint32_t k_base = smem_addr(sm.k[st][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_ss_m64n128(sacc, desc_sw128(q_base + off, 16, 1024),
                       desc_sw128(k_base + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) fence_reg(sacc[j]);
    if (lane == 0) mbar_arrive(&sm.k_empty[st]);

    // mask (edge tiles only), online softmax in the log2 domain: p =
    // 2^(s c - m c) with c = D^-0.5 log2(e), one FFMA an element; a row
    // that has seen no key takes m c = +inf, so its every p is 0
    const int k0 = kt * BK;
    const bool edge = k0 + BK > p.s || (p.causal && k0 + BK - 1 > q_lo)
                      || (p.use_window && k0 <= q_lo + 63 - p.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * c4 + e;
          bool ok0 = key < p.s, ok1 = ok0;
          if (p.causal) {
            ok0 = ok0 && key <= r0;
            ok1 = ok1 && key <= r1;
          }
          if (p.use_window) {
            ok0 = ok0 && key > r0 - p.window;
            ok1 = ok1 && key > r1 - p.window;
          }
          if (!ok0) sacc[4 * j + e] = NEG_INF;
          if (!ok1) sacc[4 * j + 2 + e] = NEG_INF;
        }
      }
    }
    float mx0 = m0, mx1 = m1;         // raw (unscaled) running maxima
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = ex2((m0 - mx0) * p.scale_log2);
    const float al1 = ex2((m1 - mx1) * p.scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 > NEG_INF / 2 ? mx0 * p.scale_log2 : CUDART_INF_F;
    const float mc1 = mx1 > NEG_INF / 2 ? mx1 * p.scale_log2 : CUDART_INF_F;
    // P in bf16 pairs: pf[2 j] row r0, pf[2 j + 1] row r1 of n8 block j,
    // so pf[4 kk .. 4 kk + 3] is the A fragment of keys 16 kk .. 16 kk + 15
    uint32_t pf[BK / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p00 = ex2(fmaf(sacc[4 * j], p.scale_log2, -mc0));
      const float p01 = ex2(fmaf(sacc[4 * j + 1], p.scale_log2, -mc0));
      const float p10 = ex2(fmaf(sacc[4 * j + 2], p.scale_log2, -mc1));
      const float p11 = ex2(fmaf(sacc[4 * j + 3], p.scale_log2, -mc1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pf[2 * j] = pack_bf16(p00, p01);
      pf[2 * j + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * al0 + sum0;             // per-thread partial sums of the row
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      oacc[4 * j] *= al0;
      oacc[4 * j + 1] *= al0;
      oacc[4 * j + 2] *= al1;
      oacc[4 * j + 3] *= al1;
    }

    // O += P V
    mbar_wait(&sm.v_full[st], ph);
    const uint32_t v_base = smem_addr(sm.v[st][0]);
#pragma unroll
    for (int j = 0; j < OA; ++j) fence_reg(oacc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(v_base + kk * 16 * 128, BOX, 1024);
      if constexpr (DP == 128)
        wgmma_rs_m64n128(oacc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                         pf[4 * kk + 3], db);
      else
        wgmma_rs_m64n64(oacc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                        pf[4 * kk + 3], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < OA; ++j) fence_reg(oacc[j]);
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) fence_reg(pf[j]);
    if (lane == 0) mbar_arrive(&sm.v_empty[st]);
  }

  // epilogue: O / max(l, 1e-30) in bf16, rows < S, columns < D
  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
  bf16* og = o + (long long)bh * p.s * p.d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * c4;
    if (col >= p.d) continue;
    if (r0 < p.s)
      *reinterpret_cast<uint32_t*>(og + (long long)r0 * p.d + col) =
          pack_bf16(oacc[4 * j] / den0, oacc[4 * j + 1] / den0);
    if (r1 < p.s)
      *reinterpret_cast<uint32_t*>(og + (long long)r1 * p.d + col) =
          pack_bf16(oacc[4 * j + 2] / den1, oacc[4 * j + 3] / den1);
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ o, const Shape p) {
  extern __shared__ unsigned char raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(
      raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));

  const int bh = blockIdx.x;                           // b * hq + h
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  const int kvh = (bh / p.hq) * (p.hq / p.group) + (bh % p.hq) / p.group;

  // KV tiles this query tile can see
  const int q_last = min(q0 + BQ, p.s) - 1;
  const int kt_end = p.causal ? q_last / BK + 1 : (p.s + BK - 1) / BK;
  int kt_begin = 0;
  if (p.use_window) {
    const long long lo = (long long)q0 - p.window + 1;  // first key row 0 sees
    kt_begin = lo <= 0 ? 0 : (int)min(lo / BK, (long long)kt_end);
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.k_empty[st], 8);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[st], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {                      // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      constexpr uint32_t TILE = DP / 64 * BOX;
      mbar_expect_tx(&sm.q_full, TILE);
      for (int b = 0; b < DP / 64; ++b)
        tma_load_3d(sm.q[b], &tq, &sm.q_full, 64 * b, q0, bh);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        mbar_wait(&sm.k_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.k_full[st], TILE);
        for (int b = 0; b < DP / 64; ++b)
          tma_load_3d(sm.k[st][b], &tk, &sm.k_full[st], 64 * b, kt * BK, kvh);
        mbar_wait(&sm.v_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.v_full[st], TILE);
        for (int b = 0; b < DP / 64; ++b)
          tma_load_3d(sm.v[st][b], &tv, &sm.v_full[st], 64 * b, kt * BK, kvh);
      }
    }
  } else {                            // consumers: rows q0 + 64 wg ..
    regs_alloc<232>();
    consume<DP>(sm, o, p, bh, q0 + 64 * wg, wg, kt_begin, kt_end);
  }
}

// [heads, s, d] bf16, boxes of 64 columns x 128 rows x 1 head
bool tensor_map(CUtensorMap* map, const void* base, long long heads, int s,
                int d) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, const Shape& p,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, (long long)b * hq, p.s, p.d)
      || !tensor_map(&tk, k, (long long)b * hkv, p.s, p.d)
      || !tensor_map(&tv, v, (long long)b * hkv, p.s, p.d))
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<DP>) + 1024;   // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * hq), (unsigned)((p.s + BQ - 1) / BQ));
  flash_attention_bf16_kernel<DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int hq,
                                    int hkv, int s, int d, float scale,
                                    int causal, int use_window, int window,
                                    void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || s < 1 || d < 8 || d > 128
      || d % 8 || (long long)b * hq > 0x7fffffffLL
      || (s + BQ - 1) / BQ > MAX_Q_TILES || !aligned16(q) || !aligned16(k)
      || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const Shape p{hq, hq / hkv, s, d, causal, use_window, window,
                scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d <= 64 ? launch<64>(q, k, v, o, b, hq, hkv, p, st)
                       : launch<128>(q, k, v, o, b, hq, hkv, p, st));
}
