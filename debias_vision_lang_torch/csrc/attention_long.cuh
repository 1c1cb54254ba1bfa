// The two-pass long attention route on Hopper's wgmma, fed by TMA, shared
// by the kernels that compute softmax attention where a score row no longer
// fits in registers:
//   * K5, dvl_attention (csrc/attention.cu): heads-first q, k, v [BH, S,
//     hdp] (hdp = any multiple of 64 after the wrapper's zero padding),
//     bf16 or f32, an additive f32 mask read through a ring of its own;
//     past hdp 192 the wide-head mode (attention_wide_kernel, below);
//   * K1, dvl_attention_block (csrc/fused_block.cu), and K3,
//     dvl_attention_block_q (csrc/fused_block_q.cu), past the register core's
//     320 keys or past head dim 128 (attention_wgmma.cuh): packed qkv [B*S,
//     ld] read through one 3-d tensor map over [ld, S, B] (head h's q, k and
//     v at columns h hdp, DA + h hdp and 2 DA + h hdp, DA = heads hdp, hdp
//     the head dim zero-padded to 64 cq; the row dimension ends at S, so the
//     last query tile of an image reads zeros, never the next image's rows),
//     attn [B*S, DA] written at column h hdp with leading dimension DA, any
//     head dim, bf16; CLIP's causal -inf generated from a flag for a key past
//     the query's row within its image, and no mask read at all.
// Each library that includes this header builds its own copy (everything
// here has internal linkage).  K5's wrapper lives in csrc/attention.cu
// (launch_long_hdp); K1's and K3's is launch_long_packed below, which the
// core's launch_attention_wgmma calls past 320 keys or head dim 128.
//
// The long route: any S >= 1, and any head dim once the wrapper has
// zero-padded it to hdp = 64 cq: the whole head a block at cq = 1 or 2 (and
// cq = 3 for K5: attention_long_kernel), the wide-head mode past it.
// A score row no longer fits in registers (at 785 keys a 64-query tile's
// f32 scores are 213 KB), so the kernel walks 64-key tiles twice, keeping
// only the row max m and the row sum l between tiles:
//   1. per tile, the scores fadd(fmul(s, scale), mask), then m_new = max(m,
//      tile max) and l = l * exp(m - m_new) + sum(exp(s - m_new)): the
//      twin's max, and its sum in another order;
//   2. per tile, the same scores again (the same products in the same order,
//      so bit-identical to pass 1's), p = exp(s - m) * (1 / l) rounded to the
//      input dtype, and O += p V in f32; one output rounding at the store.
// p is normalised before P @ V and no partial output is ever rescaled: the
// twin's rounding points (an online softmax is another function at bf16).
// Two Q K^T and one P V: 1.5x the minimum products.
//
// Block: NWG consumer warpgroups of 64 query rows each, then one producer
// warp whose lane 0 issues every TMA load; grid (BH, ceil(S / 64 NWG)), each
// block over the whole head dim.  Q comes in once, through a 3-d map over
// [BH, S, hdp] whose row dimension ends at S (rows past S arrive as zeros).
// K and V stream in 64-key x 64-dim chunks, the f32 mask in [64 NWG rows x 64
// keys] tiles, each through a ring of its own on full / empty mbarriers, in
// the order the consumers take them: per key tile the mask, the K chunks
// and, in pass 2, the V chunks.  A consumer frees a slot when its products
// on it have completed (one arrive per warp).  The mask comes through a 2-d
// map whose columns the wrapper pads to a multiple of 64 with -inf (the TMA
// needs 16-byte row strides, S = 785 has none, and the -inf columns mask the
// keys past S, so no key index is tested), 128-byte swizzled so the
// consumers' float2 reads of it hit 32 banks.
//   * bf16: Q K^T is an SS-wgmma m64n64k16 per 16 dims; p is packed from the
//     accumulator layout into A fragments of an RS-wgmma m64n64k16 per 16
//     keys with V as an MN-major operand (the transpose bit), as in the wgmma
//     core.  NWG = 2: each K / V chunk serves 128 queries; at hd 64 two
//     blocks share an SM (104 KB each, shallow rings): the softmax, not the
//     loads, holds the kernel, and it needs the warps.
//   * f32 (3xTF32, as the short route): once a chunk of K (or the Q tile) has
//     landed, the consumers split it in place into big = tf32(x) and, beside
//     it, small = tf32(x - big); Q K^T is three tf32 SS-wgmma m64n64k8 per 8
//     dims (small.big, big.small, big.big).  tf32 wgmma takes B only K-major
//     and V arrives MN-major, so the consumers transpose each V chunk in
//     place into big and small halves of V^T (transpose_split_v), with the
//     keys of each 8-group in the k order of p's A fragments: P @ V is then
//     three tf32 RS-wgmma m64n64k8 per 8 keys, p split in registers (the
//     mma.sync 3xTF32 helpers would load and split V per fragment).  Shared
//     memory decides NWG: Q's big and small halves are 64 KB per 64 dims at
//     128 queries, so NWG = 2 only at hdp 64 and 1 above (rings of 1-2
//     slots).
//   * packed (K1 / K3, PACKED = true): bf16; no mask ring (41 KB of shared
//     memory a block at hdp 64, 113 KB at 128); the scores are s * scale,
//     -inf for a key past S or, under the causal flag, past the query's row
//     in its image (q0 + the row in the block, never the row in the tile).
// Bound at B=8 H=12 S=785 hd 64 on an H100: the operations (bf16 0.0153 ms,
// f32 3xTF32 0.0918 ms); the bytes moved once are 4 x 4.8 MB + 2.5 MB.  K1 /
// K3's core at B=32 D=768 H=12 S=785: 60.6 GFLOP of minimum products (0.061
// ms at the bf16 peak) against 154 MB of qkv read and attn written (0.046
// ms): the operations.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, 13 low mantissa
// bits cleared) as two integer operations on the bit pattern: the same bits
// for every finite x, where ptxas expands the cvt itself into a compare,
// select and integer sequence per value (the kernel ran markedly slower
// with it on the H100).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + rest, both TF32 (rest = the "small" half); x - big is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& rest) {
  big = tf32_rna(x);
  rest = tf32_rna(x - __uint_as_float(big));
}

constexpr int LT = 64;  // keys per tile, rows per consumer warpgroup, dims per chunk
// norm_after of the packed cores (here and attention_wgmma.cuh): the softmax
// off, p = bf16(s * scale) into P @ V (the "mxu" attention of benchmarks/
// q_attribution.py); the long route then skips its first pass
constexpr int NORM_OFF = 3;

template <typename T, int C, bool PACKED = false>
struct LongCfg {
  static_assert(!PACKED || (sizeof(T) == 2 && C <= 2), "packed: bf16, 1 or 2 output chunks");
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NWG = (F32 && C > 1) ? 1 : 2;  // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;
  // blocks per SM: two at bf16 hd 64, where the softmax's latency, not the
  // loads, holds the kernel (one block with deeper rings was 37% slower:
  // benchmarks_torch/long_route_ablation.py)
  static constexpr int BLOCKS = (!F32 && C == 1) ? 2 : 1;
  static constexpr int ROWS = NWG * LT;               // query rows per block
  static constexpr int SPLIT = F32 ? 2 : 1;           // big (+ small) halves
  static constexpr int BOX = F32 ? 32 : 64;           // elements per 128-byte row
  static constexpr int Q_BYTES = ROWS * LT * C * (int)sizeof(T);  // as loaded
  static constexpr int K_BYTES = LT * LT * (int)sizeof(T);        // one chunk, as loaded
  static constexpr int V_BYTES = K_BYTES;
  static constexpr int V_SLOT = V_BYTES * SPLIT;
  static constexpr int M_BYTES = ROWS * LT * 4;
  static constexpr int K_SLOT = K_BYTES * SPLIT;
  // ring depths (slots), to fit 227 KB; no mask ring for the packed source
  static constexpr int DM = PACKED ? 0 : F32 ? 2 : (C == 1 ? 2 : 3);
  static constexpr int DK = F32 ? 2 : (C == 1 ? 2 : 6);
  static constexpr int DV = F32 ? (C == 2 ? 2 : 1) : (C == 1 ? 1 : C == 2 ? 4 : 3);
  static constexpr int Q_OFF = 0;
  static constexpr int M_OFF = Q_OFF + Q_BYTES * SPLIT;
  static constexpr int K_OFF = M_OFF + DM * M_BYTES;
  static constexpr int V_OFF = K_OFF + DK * K_SLOT;
  static constexpr int SMEM = V_OFF + DV * V_SLOT + 1024;  // + 1 KB for alignment
  // 227 KB a block; 228 KB an SM, with 1 KB reserved and the barriers per block
  static_assert(SMEM <= 232448 && BLOCKS * (SMEM + 1024 + 256) <= 233472,
                "long route: shared memory over the SM's");
};

// Byte offset of element (row r, column c < BOX) in a 128-byte-swizzled box.
__device__ __forceinline__ int swz(int r, int cbytes) {
  return r * 128 + ((((cbytes >> 4) ^ (r & 7))) << 4) + (cbytes & 15);
}

// In place: x -> big = tf32(x); beside it (`small_off` bytes on) tf32(x -
// big); `n4` float4s over `nthreads` consumer threads.  Then order the
// writes before the wgmma reads (async proxy) and wait for every consumer.
__device__ __forceinline__ void split_tile(unsigned char* p, int small_off, int n4, int ct,
                                           int nthreads) {
  float4* big = reinterpret_cast<float4*>(p);
  float4* small = reinterpret_cast<float4*>(p + small_off);
  for (int i = ct; i < n4; i += nthreads) {
    const float4 x = big[i];
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    big[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                         __uint_as_float(b[3]));
    small[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                           __uint_as_float(s[3]));
  }
  fence_proxy_async();
  named_barrier(1, nthreads);
}

// e^x as 2^hi * (1 + lo ln 2), where hi + lo = x log2(e) to ~2^-48 (a
// two-term constant and an FMA residual) and 2^hi is ex2.approx (<= 2 ulp):
// within ~2 ulp of expf in fewer instructions than its libm sequence.
// Results below 2^-126 flush to 0: such a probability is below every
// rounding of p and of the output.
__device__ __forceinline__ float exp_acc(float x) {
  constexpr float L = 1.44269502f, L_LO = 1.92596303e-8f;  // log2(e) = L + L_LO
  const float hi = x * L;
  const float lo = fmaf(x, L_LO, fmaf(x, L, -hi));
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(hi));
  return p * fmaf(lo, 0.693147181f, 1.0f);
}

// f32 P @ V takes V^T as a K-major tf32 operand.  In place, over NCT
// consumer threads: a V chunk as loaded (two [64 keys][32 dims] boxes) ->
// V^T as two [64 dims][32 keys] boxes, big halves where the chunk was and
// small halves 16 KB on, the keys of each 8-group at positions 0, 4, 1, 5,
// 2, 6, 3, 7 (key 2t at t, key 2t + 1 at t + 4: the k order of p's A
// fragments).  Each thread moves 8 keys x 2 dims: the reads of a warp cover
// whole rows, its 16-byte writes hit 4 of 8 chunk positions.
template <int NCT>
__device__ __forceinline__ void transpose_split_v(unsigned char* p, int ct) {
  constexpr int UPT = 256 / NCT;  // (8-key group, dim pair) units per thread
  float2 x[UPT][8];
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int unit = ct + u * NCT, dp = unit & 31, kg = unit >> 5;
    const unsigned char* src = p + (dp >> 4) * (LT * 128);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[u][i] = *reinterpret_cast<const float2*>(src + swz(kg * 8 + i, (dp & 15) * 8));
  }
  named_barrier(1, NCT);  // every read is done before the chunk is overwritten
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int unit = ct + u * NCT, dp = unit & 31, kg = unit >> 5;
    unsigned char* dst = p + (kg >> 2) * (LT * 128);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * dp + e;
      uint32_t b[8], sm[8];
#pragma unroll
      for (int pos = 0; pos < 8; ++pos) {
        const float2 v = x[u][pos < 4 ? 2 * pos : 2 * (pos - 4) + 1];
        split_tf32(e ? v.y : v.x, b[pos], sm[pos]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = swz(d, ((kg & 3) * 2 + h) * 16);
        *reinterpret_cast<uint4*>(dst + off) = make_uint4(b[4 * h], b[4 * h + 1], b[4 * h + 2],
                                                          b[4 * h + 3]);
        *reinterpret_cast<uint4*>(dst + LT * LT * 4 + off) =
            make_uint4(sm[4 * h], sm[4 * h + 1], sm[4 * h + 2], sm[4 * h + 3]);
      }
    }
  }
  fence_proxy_async();
  named_barrier(1, NCT);
}

// e^(x - m) of the softmax, 0 for x = -inf (m finite); x - m is the
// twin's f32 difference (folding m into an FMA with log2 e instead cancels
// badly once |m| is large).  ACC (f32, whose bar is 2e-5 of the output):
// exp_acc, its argument clamped rather than tested (e^-104 is 0 in f32; a
// branch per element made the f32 kernel 30% slower:
// benchmarks_torch/long_route_ablation.py).  bf16: ex2.approx of (x - m)
// log2 e, within ~6e-6 relatively for |x - m| < 100, far below p's bf16
// rounding (2^-9), at half of exp_acc's instructions (exp_acc made the bf16
// kernel 25% slower).  The packed source (K1 / K3) takes the bf16 form too:
// with expf and p = e / l, as the twin computes them, K3's int8 codes of the
// attention rows differed from the twin's as often (their differences come
// from the f32 order of P @ V) and its core took 0.7385 ms against 0.4162 at
// B=32 S=785 (H100, PERF.md section 6, PR 13).
template <bool ACC>
__device__ __forceinline__ float expm(float x, float m) {
  constexpr float LOG2E = 1.44269504f;
  if constexpr (ACC) {
    return exp_acc(fmaxf(x - m, -104.f));
  } else {
    float p;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"((x - m) * LOG2E));
    return p;
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Pass 1 over one key tile's scores: m = the row max so far, l = l * exp(m
// - m_new) + sum(exp(s - m_new)), per thread over its own columns with the
// max shared by the row's quad; a row that has seen only -inf keeps l = 0
// (its max stands in as 0).
template <bool F32>
__device__ __forceinline__ void row_stats_tile(const float (&sc)[32], float& m_lo, float& m_hi,
                                               float& l_lo, float& l_hi) {
  float t_lo = -INFINITY, t_hi = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    t_lo = fmaxf(t_lo, fmaxf(sc[nt * 4], sc[nt * 4 + 1]));
    t_hi = fmaxf(t_hi, fmaxf(sc[nt * 4 + 2], sc[nt * 4 + 3]));
  }
  const float n_lo = fmaxf(m_lo, quad_max(t_lo)), n_hi = fmaxf(m_hi, quad_max(t_hi));
  const float s_lo = n_lo == -INFINITY ? 0.f : n_lo, s_hi = n_hi == -INFINITY ? 0.f : n_hi;
  l_lo *= expm<F32>(m_lo, s_lo);
  l_hi *= expm<F32>(m_hi, s_hi);
  m_lo = n_lo;
  m_hi = n_hi;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    l_lo += expm<F32>(sc[nt * 4], s_lo) + expm<F32>(sc[nt * 4 + 1], s_lo);
    l_hi += expm<F32>(sc[nt * 4 + 2], s_hi) + expm<F32>(sc[nt * 4 + 3], s_hi);
  }
}

// Pass 2's p in place: exp(s - m) * p_s (p_s = 1 / l, or 1 under
// norm_after), or under NORM_OFF the scaled scores themselves, 0 where
// masked.
template <bool F32>
__device__ __forceinline__ void probs_tile(float (&sc)[32], float m_lo, float m_hi, float p_lo,
                                           float p_hi, int norm_after) {
  if (norm_after == NORM_OFF) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = sc[i] == -INFINITY ? 0.f : sc[i];
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt * 4] = expm<F32>(sc[nt * 4], m_lo) * p_lo;
      sc[nt * 4 + 1] = expm<F32>(sc[nt * 4 + 1], m_lo) * p_lo;
      sc[nt * 4 + 2] = expm<F32>(sc[nt * 4 + 2], m_hi) * p_hi;
      sc[nt * 4 + 3] = expm<F32>(sc[nt * 4 + 3], m_hi) * p_hi;
    }
  }
}

// One 64-dim output chunk's accumulators to rows row_lo / row_hi (those
// below S) at column col of ob (this thread's first column, rows ld
// apart): scaled by 1 / l (norm_after 1), divided by l (norm_after 2), else
// as summed; one rounding to T.
template <typename T>
__device__ __forceinline__ void store_chunk(T* ob, const float (&o)[32], int col, int row_lo,
                                            int row_hi, int S, long long ld, int norm_after,
                                            float sum_lo, float sum_hi) {
  const float inv_lo = 1.0f / sum_lo, inv_hi = 1.0f / sum_hi;
  const float o_lo = norm_after == 1 ? inv_lo : 1.f, o_hi = norm_after == 1 ? inv_hi : 1.f;
  auto fin = [norm_after](float v, float o_s, float sum) {
    return norm_after == 2 ? __fdiv_rn(v, sum) : v * o_s;
  };
#pragma unroll
  for (int on = 0; on < 8; ++on) {
    if (row_lo < S)
      store_pair(ob + row_lo * ld + col + on * 8, fin(o[on * 4], o_lo, sum_lo),
                 fin(o[on * 4 + 1], o_lo, sum_lo));
    if (row_hi < S)
      store_pair(ob + row_hi * ld + col + on * 8, fin(o[on * 4 + 2], o_hi, sum_hi),
                 fin(o[on * 4 + 3], o_hi, sum_hi));
  }
}

// The scores of key tile kt from the products s in the accumulator layout
// (thread rows r_lo and r_hi = r_lo + 8 of its block, columns 8 nt + 2t,
// +1).  Packed: s * scale, -inf for a key past S or, if causal, past the
// query's row within its image (q0 + the row in the block, never the row in
// the tile).  Heads-first: fadd(fmul(s, scale), mask) with the mask from the
// f32 tile at mp ([rows x 64 keys], two 128-byte-swizzled boxes of 32 keys):
// no FMA contraction, the twin rounds the product; keys past S meet the
// -inf columns the wrapper pads the mask with.
template <bool PACKED>
__device__ __forceinline__ void score_epilogue(float (&sc)[32], const unsigned char* mp, int rows,
                                               int r_lo, int r_hi, int q0, int kt, int t, int S,
                                               int causal, float scale) {
  if constexpr (PACKED) {
    const int qlo = q0 + r_lo, qhi = q0 + r_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * LT + nt * 8 + 2 * t + e;
        float& lo = sc[nt * 4 + e];
        float& hi = sc[nt * 4 + 2 + e];
        lo = (key < S && (!causal || key <= qlo)) ? __fmul_rn(lo, scale) : -INFINITY;
        hi = (key < S && (!causal || key <= qhi)) ? __fmul_rn(hi, scale) : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int kc = nt * 8 + 2 * t;
      const unsigned char* mb = mp + (kc >> 5) * rows * 128;
      const int cb = (kc & 31) * 4;
      const float2 mlo = *reinterpret_cast<const float2*>(mb + swz(r_lo, cb));
      const float2 mhi = *reinterpret_cast<const float2*>(mb + swz(r_hi, cb));
      sc[nt * 4] = __fadd_rn(__fmul_rn(sc[nt * 4], scale), mlo.x);
      sc[nt * 4 + 1] = __fadd_rn(__fmul_rn(sc[nt * 4 + 1], scale), mlo.y);
      sc[nt * 4 + 2] = __fadd_rn(__fmul_rn(sc[nt * 4 + 2], scale), mhi.x);
      sc[nt * 4 + 3] = __fadd_rn(__fmul_rn(sc[nt * 4 + 3], scale), mhi.y);
    }
  }
}

// `da`, `heads` and `causal` are the packed source's (attention row width,
// heads x hdp; heads per image; CLIP's causal flag); the heads-first source
// reads the mask `tm_m`.  The whole head, hdp = 64 C, is resident: Q K^T
// and P @ V run over its C 64-dim chunks (wider heads take the wide-head
// mode, attention_wide_kernel below).
// `norm_after` (KB (a) 6's function, attention_wgmma.cuh): p = exp(s - m)
// unnormalised, rounded for P @ V, and O scaled by 1 / l before the store
// (norm_after = 2: O divided by l; NORM_OFF: p = s * scale, 0 past S and
// past the causal mask, and no first pass: the producer loads pass 2's
// tiles only).
template <typename T, int C, bool PACKED>
__global__ void __launch_bounds__(LongCfg<T, C, PACKED>::THREADS, LongCfg<T, C, PACKED>::BLOCKS)
attention_long_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_m, T* __restrict__ out, int S,
                      float scale, int da, int heads, int causal, int norm_after) {
  using Cfg = LongCfg<T, C, PACKED>;
  constexpr bool F32 = Cfg::F32;
  constexpr int NWG = Cfg::NWG, NCT = NWG * 128;  // consumer warpgroups, threads
  constexpr int KSLOT = Cfg::K_SLOT;
  constexpr int q_bytes = Cfg::Q_BYTES;
  __shared__ uint64_t bars[1 + 2 * (Cfg::DM + Cfg::DK + Cfg::DV)];
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on smem_raw, so the compiler still knows
  // every derived pointer is shared memory (LDS, not generic loads)
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* Qs = sm + Cfg::Q_OFF;
  unsigned char* Ms = Qs + q_bytes * Cfg::SPLIT;
  unsigned char* Ks = Ms + Cfg::DM * Cfg::M_BYTES;
  unsigned char* Vs = Ks + Cfg::DK * KSLOT;
  uint64_t* qbar = &bars[0];
  Ring<(Cfg::DM > 0 ? Cfg::DM : 1)> rm{&bars[1], &bars[1 + Cfg::DM]};  // unused when packed
  Ring<Cfg::DK> rk{&bars[1 + 2 * Cfg::DM], &bars[1 + 2 * Cfg::DM + Cfg::DK]};
  Ring<Cfg::DV> rv{&bars[1 + 2 * (Cfg::DM + Cfg::DK)],
                   &bars[1 + 2 * (Cfg::DM + Cfg::DK) + Cfg::DV]};

  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.y * Cfg::ROWS;
  const int nkt = (S + LT - 1) / LT;
  // the outer TMA coordinate (image or slice), the q / k / v columns of this
  // head, and the output's first element and row stride
  constexpr int hdp = C * LT;
  int z, col_q = 0, col_k = 0, col_v = 0;
  long long obase, ld;
  if constexpr (PACKED) {  // blockIdx.x = image x heads + head
    const int h = blockIdx.x % heads;
    z = blockIdx.x / heads;
    col_q = h * hdp, col_k = da + h * hdp, col_v = 2 * da + h * hdp;
    obase = (long long)z * S * da + h * hdp, ld = da;
  } else {  // [BH, S, hdp]
    z = blockIdx.x;
    obase = (long long)z * S * hdp, ld = hdp;
  }

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < Cfg::DM; ++i) mbar_init(&rm.full[i], 1), mbar_init(&rm.empty[i], NWG * 4);
    for (int i = 0; i < Cfg::DK; ++i) mbar_init(&rk.full[i], 1), mbar_init(&rk.empty[i], NWG * 4);
    for (int i = 0; i < Cfg::DV; ++i) mbar_init(&rv.full[i], 1), mbar_init(&rv.empty[i], NWG * 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCT) {  // the producer warp
    if (lane != 0) return;
    mbar_expect_tx(qbar, q_bytes);
    for (int c = 0; c < C * (LT / Cfg::BOX); ++c)
      tma_load_3d(Qs + c * Cfg::ROWS * 128, &tm_q, qbar, col_q + c * Cfg::BOX, q0, z);
    for (int pass = norm_after == NORM_OFF ? 1 : 0; pass < 2; ++pass) {
      for (int kt = 0; kt < nkt; ++kt) {
        if constexpr (!PACKED) {
          const int s = rm.put(Cfg::M_BYTES);
          for (int h = 0; h < 2; ++h)
            tma_load_2d(Ms + s * Cfg::M_BYTES + h * Cfg::ROWS * 128, &tm_m, &rm.full[s],
                        kt * LT + h * 32, q0);
        }
        for (int c = 0; c < C; ++c) {
          const int s = rk.put(Cfg::K_BYTES);
          for (int b = 0; b < LT / Cfg::BOX; ++b)
            tma_load_3d(Ks + s * KSLOT + b * LT * 128, &tm_k, &rk.full[s],
                        col_k + c * LT + b * Cfg::BOX, kt * LT, z);
        }
        if (pass == 1) {
          for (int c = 0; c < C; ++c) {
            const int s = rv.put(Cfg::V_BYTES);
            for (int b = 0; b < LT / Cfg::BOX; ++b)
              tma_load_3d(Vs + s * Cfg::V_SLOT + b * LT * 128, &tm_v, &rv.full[s],
                          col_v + c * LT + b * Cfg::BOX, kt * LT, z);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63; thread (warp
  // w of it, g = lane / 4, t = lane % 4) holds rows r_lo = 64 wg + 16 w + g
  // and r_lo + 8 of every accumulator, at columns 8 j + 2t, +1
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r_lo = wg * LT + warp * 16 + g, r_hi = r_lo + 8;

  mbar_wait(qbar, 0);
  if constexpr (F32) split_tile(Qs, Cfg::Q_BYTES, Cfg::Q_BYTES / 16, tid, NCT);
  // this warpgroup's Q rows in box b (BOX elements of every row) start at
  // Qs + b * ROWS * 128 + wg * 8 KB; the small halves Q_BYTES on
  const uint64_t dq = desc_sw128(Qs + wg * LT * 128);
  constexpr int QBOX16 = Cfg::ROWS * 128 >> 4;       // descriptor step per box
  constexpr int QSMALL16 = q_bytes >> 4;

  // sc = the scores of key tile kt, as fadd(fmul(s, scale), mask), -inf past
  // S (packed: s * scale, -inf past S and, if causal, past the query's row)
  auto scores = [&](float (&sc)[32], int kt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = rk.take_next();
      unsigned char* kp = Ks + s * KSLOT;
      if constexpr (F32) split_tile(kp, Cfg::K_BYTES, Cfg::K_BYTES / 16, tid, NCT);
      const uint64_t dk = desc_sw128(kp);
      const uint64_t dqc = dq + (F32 ? 2 : 1) * c * QBOX16;  // this warpgroup's Q rows of chunk c
      fence_regs(sc);
      wgmma_fence();
      if constexpr (F32) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qb = dqc + b * QBOX16 + 2 * kk;
            const uint64_t kb = dk + b * (LT * 128 >> 4) + 2 * kk;
            wgmma_ss_tf32_n64(sc, qb + QSMALL16, kb);
            wgmma_ss_tf32_n64(sc, qb, kb + (Cfg::K_BYTES >> 4));
            wgmma_ss_tf32_n64(sc, qb, kb);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<64>(sc, dqc + 2 * kk, dk + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      rk.free_slot(s, lane);
    }
    const int smk = PACKED ? 0 : rm.take_next();  // the mask tile's slot
    score_epilogue<PACKED>(sc, Ms + smk * Cfg::M_BYTES, Cfg::ROWS, r_lo, r_hi, q0, kt, t, S,
                           causal, scale);
    if constexpr (!PACKED) rm.free_slot(smk, lane);
  };

  // 1. row max and rescaled row sum
  float sc[32];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int kt = 0; kt < (norm_after == NORM_OFF ? 0 : nkt); ++kt) {
    scores(sc, kt);
    row_stats_tile<F32>(sc, m_lo, m_hi, l_lo, l_hi);
  }
  const float sum_lo = quad_sum(l_lo), sum_hi = quad_sum(l_hi);
  const float inv_lo = 1.0f / sum_lo, inv_hi = 1.0f / sum_hi;
  const float p_lo = norm_after ? 1.f : inv_lo, p_hi = norm_after ? 1.f : inv_hi;

  // 2. p = exp(s - m) / l, rounded to T, and O += p V
  float o[C][32];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(sc, kt);
    probs_tile<F32>(sc, m_lo, m_hi, p_lo, p_hi, norm_after);
    if constexpr (F32) {
      // step j (8 keys) takes score chunk j as it lies, split into TF32
      // halves: a0 / a1 key 8j + 2t (rows lo / hi), a2 / a3 key 8j + 2t + 1,
      // which V^T holds at positions t and t + 4 of its 8-key group
      uint32_t pb[32], ps[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split_tf32(sc[j * 4], pb[j * 4], ps[j * 4]);
        split_tf32(sc[j * 4 + 2], pb[j * 4 + 1], ps[j * 4 + 1]);
        split_tf32(sc[j * 4 + 1], pb[j * 4 + 2], ps[j * 4 + 2]);
        split_tf32(sc[j * 4 + 3], pb[j * 4 + 3], ps[j * 4 + 3]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int sv = rv.take_next();
        unsigned char* vp = Vs + sv * Cfg::V_SLOT;
        transpose_split_v<NCT>(vp, tid);
        const uint64_t dvt = desc_sw128(vp);
        fence_regs(o[c]);
        fence_regs(pb);
        fence_regs(ps);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint64_t db = dvt + (j >> 2) * (LT * 128 >> 4) + 2 * (j & 3);
          const uint32_t(&ab)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pb[4 * j]);
          const uint32_t(&as)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&ps[4 * j]);
          wgmma_rs_tf32_n64(o[c], as, db);
          wgmma_rs_tf32_n64(o[c], ab, db + (Cfg::V_BYTES >> 4));
          wgmma_rs_tf32_n64(o[c], ab, db);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o[c]);
        fence_regs(pb);
        fence_regs(ps);
        rv.free_slot(sv, lane);
      }
    } else {
      // step j takes score chunks 2j (a0, a1) and 2j + 1 (a2, a3)
      uint32_t pa[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        pa[2 * nt] = pack_bf16(sc[nt * 4], sc[nt * 4 + 1]);
        pa[2 * nt + 1] = pack_bf16(sc[nt * 4 + 2], sc[nt * 4 + 3]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int sv = rv.take_next();
        const uint64_t dv = desc_sw128(Vs + sv * Cfg::V_SLOT, 1024);
        fence_regs(o[c]);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_rs_n64_tb(o[c], *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * j]),
                          dv + j * (16 * 128 >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o[c]);
        fence_regs(pa);
        rv.free_slot(sv, lane);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c)
    store_chunk(out + obase + 2 * t, o[c], c * LT, q0 + r_lo, q0 + r_hi, S, ld, norm_after,
                sum_lo, sum_hi);
}

// ---------------------------------------------------------------------------
// The wide-head mode: any hdp = 64 cq past the resident instantiations
// ---------------------------------------------------------------------------
//
// A 64 x hdp f32 output tile does not fit one warpgroup's registers past a
// few chunks, and Q K^T runs over every chunk of the head, so the head's
// output chunks are cut into ng = ceil(cq / WIDE_G) groups of at most
// WIDE_G (= 4) chunks, balanced (group g: chunks g cq / ng up to (g + 1) cq
// / ng; ops/attention.py::_wide_groups is the same plan), and a block owns
// one group of one 64-query tile: O for its chunks stays in registers (4 x
// 32 f32 a thread).  The scores of a tile are then computed 1 + ng times (K5)
// instead of 2 cq times (one output chunk a block, the design this replaced):
//   * ng = 1 (hdp <= 256): one launch, each block both passes (mode
//     WIDE_BOTH): 2 Q K^T and 1 P V, as the resident route;
//   * ng > 1 (K5): a statistics launch (WIDE_STATS, one block per query
//     tile) runs pass 1 once and writes each row's final max m and sum l to
//     an f32 workspace [BH, S] x 2 the wrapper allocates; then the output
//     launch (WIDE_OUT) runs pass 2 in every group with those m and l.  Pass
//     1's arithmetic and order are the two-pass kernel's, so p, and the
//     output, are what one block over the whole head would compute: on the
//     H100 every output of chip_smoke.py's phase 27 is bit-identical to the
//     one-chunk-a-block design's (its digests, WIDE_K5_PARENT).  At hd 800
//     (cq 13, ng 4): 5 Q K^T and 1 P V, against 26 and 1;
//   * the packed source (K1 / K3 past hdp 128) has no workspace in its
//     callers' scratch, so its groups each run both passes: 2 ng Q K^T (8
//     at hd 800).
// Block: one consumer warpgroup of 64 query rows and a producer warp.  Q is
// resident when all of its chunks fit beside the rings (bf16: up to 16
// chunks, hd 1024; loaded once, never released), else it streams through a
// Q ring of its own beside K, per key tile (f32, where a chunk's two TF32
// halves take 32 KB).  The wgmma of one chunk is in flight while the next
// chunk's slots are awaited (wait_group 1), and the products of a group's
// output chunks are issued back to back.
// At f32 the operands come split once per call: a pre-pass
// (split_tf32_kernel) writes Q's and K's big and small TF32 halves, and V^T's
// ([hdp, S rounded up to 64], the keys of each 8-group in the k order of p's
// A fragments, zero past S), to the workspace, so no chunk is split or
// transposed in shared memory after it lands and the consumers wait on no
// named barrier.  The halves are the ones split_tile and transpose_split_v
// make, at the same places in shared memory, so the products and their
// order are the two-pass kernel's.
// Bound (K5, B=8 H=12 S=785 hd 800): the operations, 0.1914 ms at bf16 and
// 1.148 ms at f32 (three TF32 products each; q, k, v, out and the mask move
// in 0.145 / 0.289 ms).  The f32 pre-pass moves 2.3 GB (~0.7 ms at 3.35
// TB/s) and the output launch reads Q, K and V^T in halves, Q again per key
// tile where it streams.
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; benchmarks_torch/
// k5_head_dim_times.py, B=8 H=12 S=785): 2.2-3.5x faster than the design it
// replaced, and at 4.8-12.5% of the bound.  What holds it back: one consumer
// warpgroup a block and one block an SM (228 registers a thread at bf16, 246
// at f32, O's four chunks 128 of them; 200-225 KB of shared memory), so the
// softmax and the loads' latency are not hidden behind wgmma; Q K^T as
// m64n64 SS-wgmma, whose operand reads and the TMA's writes exceed the
// SM's shared-memory bandwidth; at f32 Q streams from L2 per key tile.
// hdp 192 stays on the resident attention_long_kernel<T, 3>: the wide mode
// took 0.478 / 1.97 ms there against its 0.317 / 1.47 (bf16 / f32, the same
// call), the resident block holding 128 queries at bf16 against 64 here
// and Q resident at f32 against streamed here.
constexpr int WIDE_G = 4;  // output chunks a group at most
constexpr int WIDE_BOTH = 0, WIDE_STATS = 1, WIDE_OUT = 2;

template <typename T, bool PACKED>
struct WideCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int THREADS = 128 + 32;
  static constexpr int SPLIT = F32 ? 2 : 1;
  static constexpr int BOX = F32 ? 32 : 64;             // elements per 128-byte row
  static constexpr int BOX_BYTES = LT * 128;            // one [64 rows x 128 B] box
  static constexpr int HALF = LT * LT * (int)sizeof(T);  // a chunk as loaded (f32: big)
  static constexpr int CH = HALF * SPLIT;               // a chunk's slot (f32: + small)
  static constexpr int M_BYTES = LT * LT * 4;
  static constexpr int DM = PACKED ? 0 : 2;
  static constexpr int DK = F32 ? 2 : 4;
  static constexpr int DV = F32 ? 2 : 4;
  static constexpr int RINGS = DM * M_BYTES + (DK + DV) * CH;
  // Q's slots: all of Q when cq <= DQ, else a ring of DQ
  static constexpr int DQ = (232448 - 1024 - RINGS) / CH;
  static_assert(DQ >= 2, "wide-head mode: no room for Q");
  static int smem(int cq) { return RINGS + (cq < DQ ? cq : DQ) * CH + 1024; }
};

// The f32 pre-pass: q, k [BH, S, hdp] -> qh, kh [2][BH][S][hdp] (big, then
// small TF32 halves); v [BH, S, hdp] -> vh [2][BH][hdp][Sp] (V^T; at key
// position 8j + p key 8j + 2p for p < 4 and 8j + 2(p - 4) + 1 for p >= 4;
// zero past S).  Blocks [0, nqk) take Q and K four floats a thread, the rest
// V^T one (dim, 8-key group) a thread: a warp reads 32 consecutive dims of a
// key row and writes 32-byte runs.
__global__ void __launch_bounds__(256) split_tf32_kernel(const float* __restrict__ q,
                                                         const float* __restrict__ k,
                                                         const float* __restrict__ v,
                                                         float* __restrict__ qh,
                                                         float* __restrict__ kh,
                                                         float* __restrict__ vh, int BH, int S,
                                                         int Sp, int hdp, int nqk) {
  const long long n = (long long)BH * S * hdp;
  if ((int)blockIdx.x < nqk) {
    const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
    if (i >= 2 * n) return;
    const bool isk = i >= n;
    const long long j = isk ? i - n : i;
    const float4 x = *reinterpret_cast<const float4*>((isk ? k : q) + j);
    float* dst = isk ? kh : qh;
    uint32_t b[4], r[4];
    split_tf32(x.x, b[0], r[0]);
    split_tf32(x.y, b[1], r[1]);
    split_tf32(x.z, b[2], r[2]);
    split_tf32(x.w, b[3], r[3]);
    *reinterpret_cast<uint4*>(dst + j) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(dst + n + j) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
  const long long u = (long long)(blockIdx.x - nqk) * 256 + threadIdx.x;
  const int d = (int)(u % hdp);
  const long long rest = u / hdp;
  const int kg = (int)(rest % (Sp / 8)), z = (int)(rest / (Sp / 8));
  if (z >= BH) return;
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = kg * 8 + i;
    x[i] = key < S ? v[((long long)z * S + key) * hdp + d] : 0.f;
  }
  uint32_t b[8], r[8];
#pragma unroll
  for (int pos = 0; pos < 8; ++pos)
    split_tf32(x[pos < 4 ? 2 * pos : 2 * (pos - 4) + 1], b[pos], r[pos]);
  float* big = vh + ((long long)z * hdp + d) * Sp + kg * 8;
  float* small = big + (long long)BH * hdp * Sp;
  reinterpret_cast<uint4*>(big)[0] = make_uint4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<uint4*>(big)[1] = make_uint4(b[4], b[5], b[6], b[7]);
  reinterpret_cast<uint4*>(small)[0] = make_uint4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<uint4*>(small)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// Maps: bf16 heads-first q, k, v over [hdp, S, BH]; f32 heads-first the
// pre-pass's qh, kh over [hdp, S, 2 BH] and vh over [Sp, hdp, 2 BH] (the
// small halves at z + zs, zs = BH); packed: tm_q = tm_k = tm_v over [ld, S,
// B].  Every box is [64 rows x 128 B].  `stats` [BH, S] (m, l): written by
// WIDE_STATS, read by WIDE_OUT.  `norm_after` and the packed arguments are
// attention_long_kernel's.  Grid: (BH ng, ceil(S / 64)) (packed: (B heads
// ng, ...), blockIdx.x = (image x heads + head) x ng + group); WIDE_STATS
// (BH, ceil(S / 64)).
template <typename T, bool PACKED>
__global__ void __launch_bounds__(WideCfg<T, PACKED>::THREADS, 1)
attention_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_m, T* __restrict__ out,
                      float2* __restrict__ stats, int S, float scale, int da, int heads,
                      int causal, int norm_after, int cq, int mode, int zs) {
  using Cfg = WideCfg<T, PACKED>;
  constexpr bool F32 = Cfg::F32;
  constexpr int CH = Cfg::CH, DQ = Cfg::DQ;
  __shared__ uint64_t bars[2 * (DQ + Cfg::DM + Cfg::DK + Cfg::DV) + 2];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const bool q_res = cq <= DQ;  // Q resident: loaded once into slots 0 .. cq - 1
  unsigned char* Qs = sm;
  unsigned char* Ms = Qs + (q_res ? cq : DQ) * CH;
  unsigned char* Ks = Ms + Cfg::DM * Cfg::M_BYTES;
  unsigned char* Vs = Ks + Cfg::DK * CH;
  Ring<DQ> rq{&bars[0], &bars[DQ]};
  Ring<(Cfg::DM > 0 ? Cfg::DM : 1)> rm{&bars[2 * DQ], &bars[2 * DQ + Cfg::DM]};
  Ring<Cfg::DK> rk{&bars[2 * (DQ + Cfg::DM)], &bars[2 * (DQ + Cfg::DM) + Cfg::DK]};
  Ring<Cfg::DV> rv{&bars[2 * (DQ + Cfg::DM + Cfg::DK)],
                   &bars[2 * (DQ + Cfg::DM + Cfg::DK) + Cfg::DV]};

  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.y * LT, nkt = (S + LT - 1) / LT, hdp = cq * LT;
  const int ng = (cq + WIDE_G - 1) / WIDE_G;
  const int grp = mode == WIDE_STATS ? 0 : blockIdx.x % ng;
  const int hz = mode == WIDE_STATS ? blockIdx.x : blockIdx.x / ng;
  const int c0 = grp * cq / ng, nc = (grp + 1) * cq / ng - c0;  // this block's output chunks
  int z, col_q = 0, col_k = 0, col_v = 0;
  long long obase, ld;
  if constexpr (PACKED) {
    const int h = hz % heads;
    z = hz / heads;
    col_q = h * hdp, col_k = da + h * hdp, col_v = 2 * da + h * hdp;
    obase = (long long)z * S * da + h * hdp, ld = da;
  } else {
    z = hz;
    obase = (long long)z * S * hdp, ld = hdp;
  }
  // the passes this block runs: 0 (statistics), 1 (output)
  const int p0 = (mode == WIDE_OUT || norm_after == NORM_OFF) ? 1 : 0;
  const int p1 = mode == WIDE_STATS ? 1 : 2;

  if (tid == 0) {
    for (int i = 0; i < DQ; ++i) mbar_init(&rq.full[i], 1), mbar_init(&rq.empty[i], 4);
    for (int i = 0; i < Cfg::DM; ++i) mbar_init(&rm.full[i], 1), mbar_init(&rm.empty[i], 4);
    for (int i = 0; i < Cfg::DK; ++i) mbar_init(&rk.full[i], 1), mbar_init(&rk.empty[i], 4);
    for (int i = 0; i < Cfg::DV; ++i) mbar_init(&rv.full[i], 1), mbar_init(&rv.empty[i], 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    if (lane != 0) return;
    // one 64 x 64 chunk at inner coordinate x (f32: both halves, the small
    // one from z + zs)
    auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
#pragma unroll
      for (int b = 0; b < LT / Cfg::BOX; ++b) {
        tma_load_3d(dst + b * Cfg::BOX_BYTES, map, bar, x + b * Cfg::BOX, y, z);
        if constexpr (F32)
          tma_load_3d(dst + Cfg::HALF + b * Cfg::BOX_BYTES, map, bar, x + b * Cfg::BOX, y,
                      z + zs);
      }
    };
    if (q_res)
      for (int c = 0; c < cq; ++c) {
        const int s = rq.put(CH);
        load(Qs + s * CH, &tm_q, &rq.full[s], col_q + c * LT, q0);
      }
    for (int pass = p0; pass < p1; ++pass) {
      for (int kt = 0; kt < nkt; ++kt) {
        if constexpr (!PACKED) {
          const int s = rm.put(Cfg::M_BYTES);
          for (int h = 0; h < 2; ++h)
            tma_load_2d(Ms + s * Cfg::M_BYTES + h * Cfg::BOX_BYTES, &tm_m, &rm.full[s],
                        kt * LT + h * 32, q0);
        }
        for (int c = 0; c < cq; ++c) {
          if (!q_res) {
            const int s = rq.put(CH);
            load(Qs + s * CH, &tm_q, &rq.full[s], col_q + c * LT, q0);
          }
          const int s = rk.put(CH);
          load(Ks + s * CH, &tm_k, &rk.full[s], col_k + c * LT, kt * LT);
        }
        if (pass == 1)
          for (int c = 0; c < nc; ++c) {
            const int s = rv.put(CH);
            if constexpr (F32)  // V^T: keys inner
              load(Vs + s * CH, &tm_v, &rv.full[s], kt * LT, (c0 + c) * LT);
            else
              load(Vs + s * CH, &tm_v, &rv.full[s], col_v + (c0 + c) * LT, kt * LT);
          }
      }
    }
    return;
  }

  // consumers: thread (warp w, g = lane / 4, t = lane % 4) holds rows r_lo =
  // 16 w + g and r_lo + 8 of every accumulator, at columns 8 j + 2t, +1
  const int warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  constexpr int HALF16 = Cfg::HALF >> 4, BOX16 = Cfg::BOX_BYTES >> 4;

  // sc = the scores of key tile kt; chunk c's products run while chunk c +
  // 1's slots are awaited
  auto scores = [&](float (&sc)[32], int kt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    int prev_q = -1, prev_k = -1;
    for (int c = 0; c < cq; ++c) {
      int sq;
      if (q_res) {
        sq = c;
        mbar_wait(&rq.full[c], 0);
      } else {
        sq = rq.take_next();
      }
      const int sk = rk.take_next();
      const uint64_t dq = desc_sw128(Qs + sq * CH), dk = desc_sw128(Ks + sk * CH);
      wgmma_fence();
      if constexpr (F32) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qb = dq + b * BOX16 + 2 * kk, kb = dk + b * BOX16 + 2 * kk;
            wgmma_ss_tf32_n64(sc, qb + HALF16, kb);
            wgmma_ss_tf32_n64(sc, qb, kb + HALF16);
            wgmma_ss_tf32_n64(sc, qb, kb);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<64>(sc, dq + 2 * kk, dk + 2 * kk);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        rk.free_slot(prev_k, lane);
        if (!q_res) rq.free_slot(prev_q, lane);
      }
      prev_q = sq, prev_k = sk;
    }
    wgmma_wait<0>();
    fence_regs(sc);
    rk.free_slot(prev_k, lane);
    if (!q_res) rq.free_slot(prev_q, lane);
    const int smk = PACKED ? 0 : rm.take_next();  // the mask tile's slot
    score_epilogue<PACKED>(sc, Ms + smk * Cfg::M_BYTES, LT, r_lo, r_hi, q0, kt, t, S, causal,
                           scale);
    if constexpr (!PACKED) rm.free_slot(smk, lane);
  };

  // 1. row max and rescaled row sum: attention_long_kernel's pass 1
  float sc[32];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int kt = 0; kt < (p0 == 0 ? nkt : 0); ++kt) {
    scores(sc, kt);
    row_stats_tile<F32>(sc, m_lo, m_hi, l_lo, l_hi);
  }
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  float sum_lo = quad_sum(l_lo), sum_hi = quad_sum(l_hi);
  if (mode == WIDE_STATS) {
    if (t == 0) {
      if (row_lo < S) stats[(long long)z * S + row_lo] = make_float2(m_lo, sum_lo);
      if (row_hi < S) stats[(long long)z * S + row_hi] = make_float2(m_hi, sum_hi);
    }
    return;
  }
  if (mode == WIDE_OUT) {  // the statistics launch's m and l (rows past S: never stored)
    const float2 a = row_lo < S ? stats[(long long)z * S + row_lo] : make_float2(0.f, 1.f);
    const float2 b = row_hi < S ? stats[(long long)z * S + row_hi] : make_float2(0.f, 1.f);
    m_lo = a.x, sum_lo = a.y, m_hi = b.x, sum_hi = b.y;
  }
  const float inv_lo = 1.0f / sum_lo, inv_hi = 1.0f / sum_hi;
  const float p_lo = norm_after ? 1.f : inv_lo, p_hi = norm_after ? 1.f : inv_hi;

  // 2. p = exp(s - m) / l, rounded to T, and O += p V for this group's chunks
  float o[WIDE_G][32];
#pragma unroll
  for (int c = 0; c < WIDE_G; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(sc, kt);
    probs_tile<F32>(sc, m_lo, m_hi, p_lo, p_hi, norm_after);
    int prev = -1;
    if constexpr (F32) {
      uint32_t pb[32], ps[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split_tf32(sc[j * 4], pb[j * 4], ps[j * 4]);
        split_tf32(sc[j * 4 + 2], pb[j * 4 + 1], ps[j * 4 + 1]);
        split_tf32(sc[j * 4 + 1], pb[j * 4 + 2], ps[j * 4 + 2]);
        split_tf32(sc[j * 4 + 3], pb[j * 4 + 3], ps[j * 4 + 3]);
      }
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int c = 0; c < WIDE_G; ++c) {
        if (c < nc) {
          const int sv = rv.take_next();
          const uint64_t dvt = desc_sw128(Vs + sv * CH);
          fence_regs(o[c]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint64_t db = dvt + (j >> 2) * BOX16 + 2 * (j & 3);
            const uint32_t(&ab)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pb[4 * j]);
            const uint32_t(&as)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&ps[4 * j]);
            wgmma_rs_tf32_n64(o[c], as, db);
            wgmma_rs_tf32_n64(o[c], ab, db + HALF16);
            wgmma_rs_tf32_n64(o[c], ab, db);
          }
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();
            rv.free_slot(prev, lane);
          }
          prev = sv;
        }
      }
      wgmma_wait<0>();
      fence_regs(pb);
      fence_regs(ps);
    } else {
      uint32_t pa[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        pa[2 * nt] = pack_bf16(sc[nt * 4], sc[nt * 4 + 1]);
        pa[2 * nt + 1] = pack_bf16(sc[nt * 4 + 2], sc[nt * 4 + 3]);
      }
      fence_regs(pa);
#pragma unroll
      for (int c = 0; c < WIDE_G; ++c) {
        if (c < nc) {
          const int sv = rv.take_next();
          const uint64_t dv = desc_sw128(Vs + sv * CH, 1024);
          fence_regs(o[c]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_rs_n64_tb(o[c], *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * j]),
                            dv + j * (16 * 128 >> 4));
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();
            rv.free_slot(prev, lane);
          }
          prev = sv;
        }
      }
      wgmma_wait<0>();
      fence_regs(pa);
    }
#pragma unroll
    for (int c = 0; c < WIDE_G; ++c) fence_regs(o[c]);
    rv.free_slot(prev, lane);
  }

#pragma unroll
  for (int c = 0; c < WIDE_G; ++c)
    if (c < nc)
      store_chunk(out + obase + 2 * t, o[c], (c0 + c) * LT, row_lo, row_hi, S, ld, norm_after,
                  sum_lo, sum_hi);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The mask's rows are `ldm` floats apart: S rounded up to a multiple of 64,
// the columns past S holding -inf.  The whole head (hdp = 64 C) a block, Q
// resident.
template <typename T, int C>
cudaError_t launch_long(const T* q, const T* k, const T* v, const float* mask, T* out, int BH,
                        int S, float scale, cudaStream_t st) {
  using Cfg = LongCfg<T, C, false>;
  constexpr int ES = (int)sizeof(T), hdp = C * LT;
  constexpr CUtensorMapDataType DT =
      Cfg::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int ldm = (S + LT - 1) & ~(LT - 1);
  CUtensorMap tm[4];
  const uint64_t dims[3] = {(uint64_t)hdp, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)hdp * ES, (uint64_t)S * hdp * ES};
  const uint32_t box_q[3] = {Cfg::BOX, Cfg::ROWS, 1}, box_kv[3] = {Cfg::BOX, LT, 1};
  const T* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t e = make_tensor_map(&tm[i], src[i], 3, dims, strides, i == 0 ? box_q : box_kv, DT);
    if (e != cudaSuccess) return e;
  }
  const uint64_t mdims[2] = {(uint64_t)ldm, (uint64_t)S};
  const uint64_t mstrides[1] = {(uint64_t)ldm * 4};
  const uint32_t mbox[2] = {32, Cfg::ROWS};
  cudaError_t e = make_tensor_map(&tm[3], mask, 2, mdims, mstrides, mbox,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attention_long_kernel<T, C, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (S + Cfg::ROWS - 1) / Cfg::ROWS);
  attention_long_kernel<T, C, false><<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      tm[0], tm[1], tm[2], tm[3], out, S, scale, 0, 1, 0, 0);
  return cudaGetLastError();
}

// The wide-head mode's workspace for K5 (bytes): at f32 the pre-pass's
// halves (Q and K [2][BH][S][hdp], V^T [2][BH][hdp][Sp], Sp = S rounded up
// to 64), then, with more than one output group, the row statistics [BH,
// S] x 2 f32.  ops/attention.py::_wide_workspace_bytes is the same sum.
inline size_t wide_ws_bytes(bool f32, int BH, int S, int hdp) {
  const int cq = hdp / LT, ng = (cq + WIDE_G - 1) / WIDE_G, Sp = (S + LT - 1) & ~(LT - 1);
  const size_t split = f32 ? 4 * (size_t)BH * hdp * (2 * (size_t)S + Sp) * 2 : 0;
  return split + (ng > 1 ? (size_t)BH * S * 8 : 0);
}

// K5's wide-head mode, any hdp = 64 cq (csrc/attention.cu routes hdp past
// 192 here): at f32 the split pre-pass, with ng > 1 the statistics launch,
// then the output launch, all on `st`; ws of at least wide_ws_bytes.
template <typename T>
cudaError_t launch_wide(const T* q, const T* k, const T* v, const float* mask, T* out, int BH,
                        int S, int hdp, float scale, void* ws, size_t ws_bytes, cudaStream_t st) {
  using Cfg = WideCfg<T, false>;
  constexpr bool F32 = Cfg::F32;
  constexpr int ES = (int)sizeof(T);
  const int cq = hdp / LT, ng = (cq + WIDE_G - 1) / WIDE_G, Sp = (S + LT - 1) & ~(LT - 1);
  if (ws_bytes < wide_ws_bytes(F32, BH, S, hdp) || (ws_bytes > 0 && ws == nullptr))
    return cudaErrorInvalidValue;
  constexpr CUtensorMapDataType DT =
      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box[3] = {Cfg::BOX, LT, 1};
  CUtensorMap tm[4];
  cudaError_t e;
  unsigned char* w = static_cast<unsigned char*>(ws);
  if constexpr (F32) {
    const size_t n = (size_t)BH * S * hdp;
    float *qh = reinterpret_cast<float*>(w), *kh = qh + 2 * n, *vh = kh + 2 * n;
    w = reinterpret_cast<unsigned char*>(vh + 2 * (size_t)BH * hdp * Sp);
    const int nqk = (int)((2 * n / 4 + 255) / 256);
    const int nv = (int)(((size_t)BH * (Sp / 8) * hdp + 255) / 256);
    split_tf32_kernel<<<nqk + nv, 256, 0, st>>>(reinterpret_cast<const float*>(q),
                                                reinterpret_cast<const float*>(k),
                                                reinterpret_cast<const float*>(v), qh, kh, vh, BH,
                                                S, Sp, hdp, nqk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const uint64_t dims[3] = {(uint64_t)hdp, (uint64_t)S, 2 * (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)hdp * 4, (uint64_t)S * hdp * 4};
    const uint64_t vdims[3] = {(uint64_t)Sp, (uint64_t)hdp, 2 * (uint64_t)BH};
    const uint64_t vstrides[2] = {(uint64_t)Sp * 4, (uint64_t)hdp * Sp * 4};
    if ((e = make_tensor_map(&tm[0], qh, 3, dims, strides, box, DT)) != cudaSuccess) return e;
    if ((e = make_tensor_map(&tm[1], kh, 3, dims, strides, box, DT)) != cudaSuccess) return e;
    if ((e = make_tensor_map(&tm[2], vh, 3, vdims, vstrides, box, DT)) != cudaSuccess) return e;
  } else {
    const uint64_t dims[3] = {(uint64_t)hdp, (uint64_t)S, (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)hdp * ES, (uint64_t)S * hdp * ES};
    const T* src[3] = {q, k, v};
    for (int i = 0; i < 3; ++i)
      if ((e = make_tensor_map(&tm[i], src[i], 3, dims, strides, box, DT)) != cudaSuccess)
        return e;
  }
  const uint64_t mdims[2] = {(uint64_t)Sp, (uint64_t)S};
  const uint64_t mstrides[1] = {(uint64_t)Sp * 4};
  const uint32_t mbox[2] = {32, LT};
  e = make_tensor_map(&tm[3], mask, 2, mdims, mstrides, mbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return e;
  const int smem = Cfg::smem(cq);
  e = cudaFuncSetAttribute(attention_wide_kernel<T, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  float2* stats = reinterpret_cast<float2*>(w);
  const int rows = (S + LT - 1) / LT;
  if (ng > 1) {
    attention_wide_kernel<T, false><<<dim3(BH, rows), Cfg::THREADS, smem, st>>>(
        tm[0], tm[1], tm[2], tm[3], out, stats, S, scale, 0, 1, 0, 0, cq, WIDE_STATS, BH);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  attention_wide_kernel<T, false><<<dim3(BH * ng, rows), Cfg::THREADS, smem, st>>>(
      tm[0], tm[1], tm[2], tm[3], out, stats, S, scale, 0, 1, 0, 0, cq,
      ng > 1 ? WIDE_OUT : WIDE_BOTH, BH);
  return cudaGetLastError();
}

// One packed resident instantiation: the whole head, C = 1 or 2 chunks, a block.
template <int C>
cudaError_t launch_long_packed_c(const CUtensorMap& tm_q, const CUtensorMap& tm_kv, bf16* attn,
                                 int B, int S, int heads, int causal, cudaStream_t st,
                                 float scale, int norm_after) {
  using Cfg = LongCfg<bf16, C, true>;
  constexpr int smem = Cfg::SMEM;
  cudaError_t e = cudaFuncSetAttribute(attention_long_kernel<bf16, C, true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * heads, (S + Cfg::ROWS - 1) / Cfg::ROWS);
  // tm_m is not read by the packed source: any valid map stands in
  attention_long_kernel<bf16, C, true><<<grid, Cfg::THREADS, smem, st>>>(
      tm_q, tm_kv, tm_kv, tm_q, attn, S, scale, heads * C * LT, heads, causal, norm_after);
  return cudaGetLastError();
}

// K1 / K3: qkv [B*S, ld] bf16 (q | k | v, heads x hdp columns each, in its
// first 3 heads hdp) -> attn [B*S, heads hdp] bf16 through the packed
// source; hdp = 64 cq, the head dim zero-padded by the operand plan; any S >=
// 1.  hdp 64 and 128 run one block per (image, head, row tile) over the
// whole head; a wider head the wide-head mode, one block per (image, head,
// output group, 64-query tile), each group over both passes (no workspace):
// any head dim.  K1 and K3 pass scale = hd^-0.5 of the true head dim (see
// launch_attention_wgmma for the other callers).
cudaError_t launch_long_packed(const bf16* qkv, bf16* attn, int B, int S, int heads, int hdp,
                               int causal, cudaStream_t st, int ld, float scale,
                               int norm_after) {
  const int cq = hdp / LT;
  if (S < 1 || B < 1 || heads < 1 || hdp % LT || cq < 1 || ld < 3 * heads * hdp || ld % 8)
    return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_kv;
  const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)S * ld * 2};
  const uint32_t box_q[3] = {LT, LongCfg<bf16, 1, true>::ROWS, 1}, box_kv[3] = {LT, LT, 1};
  cudaError_t e = make_tensor_map(&tm_kv, qkv, 3, dims, strides, box_kv);
  if (e != cudaSuccess) return e;
  if (cq > 2) {  // the wide-head mode: 64-query boxes for Q too
    using Cfg = WideCfg<bf16, true>;
    const int ng = (cq + WIDE_G - 1) / WIDE_G, smem = Cfg::smem(cq);
    e = cudaFuncSetAttribute(attention_wide_kernel<bf16, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * heads * ng, (S + LT - 1) / LT);
    attention_wide_kernel<bf16, true><<<grid, Cfg::THREADS, smem, st>>>(
        tm_kv, tm_kv, tm_kv, tm_kv, attn, nullptr, S, scale, heads * hdp, heads, causal,
        norm_after, cq, WIDE_BOTH, 0);
    return cudaGetLastError();
  }
  e = make_tensor_map(&tm_q, qkv, 3, dims, strides, box_q);
  if (e != cudaSuccess) return e;
  if (cq == 1)
    return launch_long_packed_c<1>(tm_q, tm_kv, attn, B, S, heads, causal, st, scale, norm_after);
  return launch_long_packed_c<2>(tm_q, tm_kv, attn, B, S, heads, causal, st, scale, norm_after);
}

}  // namespace
