// The bf16 attention core on Hopper's wgmma, fed by TMA, shared by three
// kernels that compute the same function from other operands:
//   * K1, dvl_attention_block (csrc/fused_block.cu), and K3,
//     dvl_attention_block_q (csrc/fused_block_q.cu): packed qkv [B*S, ld]
//     (q | k | v, head h at columns h hdp .. h hdp + hdp - 1 of each third,
//     hdp = 64 or 128: the head dim zero-padded by the operand plan) -> attn
//     [B*S, heads hdp], CLIP's causal mask generated from a flag;
//   * K5, dvl_attention (csrc/attention.cu): heads-first q, k, v [B*H, S,
//     64] -> out [B*H, S, 64], an additive f32 [S, S] mask read from memory
//     (L2-resident: 155 KB at S = 197) and added as fadd(fmul(s, scale),
//     mask), the twin's two roundings.
// The function: f32 scores * scale (+ the mask), row max, exp, normalised by
// the f32 row sum and rounded to bf16 BEFORE P @ V (not an online softmax:
// at bf16 that is another function), P @ V accumulated in f32, one rounding.
// The packed source also computes KB (a) 6's function (attention_block_hgrid,
// benchmarks/attn_variants.py: q pre-scaled by hd^-0.5 log2 e, exp2): the
// caller passes scale = ln 2, so exp(s ln 2 - m ln 2) is exp2(s - m) to f32
// rounding, and norm_after, which rounds the unnormalised exponentials to
// bf16 for P @ V and scales the f32 output rows by 1 / row sum after it;
// norm_after = 2 (KB (a) 4, attn_q_kernel_var of benchmarks/
// q_kernel_variants.py, at scale 1/8: exp(s / 8 - m / 8) is its exp2 at
// 8^-1 log2 e to f32 rounding) divides them by the row sum instead.
// norm_after = NORM_OFF (the "mxu" attention of benchmarks/
// q_attribution.py, packed source only) turns the softmax off: p =
// bf16(s * scale), 0 past S and past the causal mask, straight into P @ V,
// with no row max, exp, row sum or division.  It runs instantiations of its
// own (SOFTMAX = 0), so the softmax kernels K1 and K3 run keep their
// registers.  launch_attention_wgmma<true> (q_ilp4.py's head-pair packed
// kernel, attention_block_q_postdiv) runs norm_after = 2's function on
// instantiations of its own (SOFTMAX = 2): the division is the compile-time
// path, and each quotient is qq_div's corrected reciprocal product in place
// of __fdiv_rn's range check and slow path.  Both give the IEEE quotient: a
// zero is kept as it is, and a thread whose outputs hold a nonzero value
// below 2^-100, an inf or a NaN, or whose row sums are not finite, divides
// by __fdiv_rn.  Past the register core's shapes it runs the long route's
// norm_after = 2.  Only a library that launches it builds it.
// The packed qkv's rows are `ld` elements apart (3D, or a tensor-parallel
// slot's q | k | v slice padded to the GEMM's 128-column tile).
//
// One block (one warpgroup, 128 threads) per (head, image):
//   * thread 0 asks the TMA for the head's K and V once (boxes of up to 256
//     keys x 64 dims through a 3-d tensor map whose key dimension ends at S,
//     so keys past S arrive as zeros) and for the first two query tiles (64
//     rows each, double buffered); K, V and each query buffer land on
//     mbarriers of their own, so the first Q K^T starts while V is still in
//     flight;
//   * the warpgroup walks the query tiles: Q K^T is an SS-wgmma m64nNKk16
//     (NK = the key count rounded up to a bucket: 32, 80, 200, 256, or 256 +
//     64 up to 320) whose f32 accumulators hold each query's whole score row
//     in registers; the softmax runs on them (a row is spread over the four
//     threads of a quad; a warp whose 16 rows all lie past S skips it); the
//     probabilities, scaled by the reciprocal of the f32 row sum and rounded
//     to bf16, are packed from the accumulator layout into the A fragments
//     of an RS-wgmma m64n64k16 per 16 keys, with V read from shared memory
//     as an MN-major operand (the transpose bit), so V is never transposed
//     by hand.  The reciprocal differs from the twin's division by at most
//     one f32 ulp before the bf16 rounding.
// Bound on an H100 at ViT-B/16 B=256 (K1): 30.5 GFLOP of products (0.031 ms
// at the bf16 peak) against 0.31 GB of qkv read and attn written (0.093 ms
// at 3.35 TB/s): bytes; K5 at B=64 H=12 S=197 likewise (0.023 ms of bytes).
// What this design does about it: each head's K and V are read from device
// memory once (not once per 64 queries), and no product waits for a load
// it does not need.

#pragma once

#include "attention_long.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CORE_THREADS = 128;
constexpr int CORE_QBOX = 64 * 64;  // bf16 elements of one 64-query x 64-dim tile (8 KB)
constexpr int CORE_MAX_SEQ = 320;  // keys of the register core; K1 / K3 go long past it
constexpr int CORE_MAX_C = 2;      // 64-dim chunks of a head the register core holds (hdp 128)

// Where the core reads its operands and writes its output.
enum CoreSource {
  CORE_PACKED = 0,  // K1: one [B, S, ld] map for q, k and v; block (h, b); causal flag
  CORE_HEADS = 1,   // K5: a [B*H, S, 64] map each; block (b*H + h); additive mask
};

// wgmma N of Q K^T: the key count rounded up to the compiled bucket.
__host__ inline int core_keys(int s) {
  return s <= 32 ? 32 : s <= 80 ? 80 : s <= 200 ? 200 : s <= 256 ? 256 : CORE_MAX_SEQ;
}

// Keys per K / V box: all NK in one box up to the TMA's 256, else two.
__host__ __device__ constexpr int core_kv_box(int nk) { return nk <= 256 ? nk : nk / 2; }

// K and V (NK keys x 64 C dims each), two query tiles of 64 C dims, 1 KB
// for alignment (C = 2 at 320 keys: 193 KB).
__host__ inline size_t core_smem_bytes(int nk, int c) {
  return (size_t)(2 * c * nk * 64 + 2 * c * CORE_QBOX) * 2 + 1024;
}

template <int NK>
__device__ __forceinline__ void qk_wgmma(float (&sc)[NK / 2], uint64_t dq, uint64_t dk) {
  if constexpr (NK <= 256) {
    wgmma_ss<NK>(sc, dq, dk);
  } else {  // keys 0..255, then 256..NK-1 (1024 B per 8 keys)
    wgmma_ss<256>(*reinterpret_cast<float(*)[128]>(&sc[0]), dq, dk);
    wgmma_ss<NK - 256>(*reinterpret_cast<float(*)[NK / 2 - 128]>(&sc[128]), dq,
                       dk + (256 / 8) * (1024 >> 4));
  }
}

// Up to 200 keys at head dim 64, three blocks share an SM (68 KB of shared
// memory each): hold the registers to that.  C is the head's 64-dim chunks
// (packed source: the head dim zero-padded to hdp = 64 C by the operand
// plan; K5's heads-first source C = 1): Q K^T sums the chunks' products into
// one score row, and P @ V runs once per chunk of V on the same P.  `da` is
// the packed attention row's width, heads x hdp (K1; unused by K5), `mask`
// K5's [S, S] additive mask, `causal` K1's flag; SOFTMAX = 0 is the packed
// source's NORM_OFF mode.
template <int NK, int SRC, int SOFTMAX, int C>
__global__ void __launch_bounds__(CORE_THREADS, (C == 1 && NK <= 200) ? 3 : 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out_base,
                       const float* __restrict__ mask, int S, int da, float scale, int causal,
                       int norm_after) {
  constexpr int KB = core_kv_box(NK);  // keys per K / V box
  constexpr int NT = NK / 8;           // 8-key column chunks of a score row
  constexpr int NJ = (NK + 15) / 16;   // 16-key steps of P @ V
  constexpr int HDP = 64 * C;
  __shared__ uint64_t bars[4];         // K, V, query buffers 0 and 1
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));  // [C][NK][64]
  bf16* Vs = Ks + C * NK * 64;                              // [C][NK][64]
  bf16* Qs = Vs + C * NK * 64;                              // [2][C][64][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (S + 63) / 64;
  // TMA columns of q, k, v, the outer (image or slice) coordinate, and the
  // output's first element and row stride
  int col_q, col_k, col_v, z, ld;
  long long obase;
  if constexpr (SRC == CORE_PACKED) {
    const int h = blockIdx.x;
    z = blockIdx.y;
    col_q = h * HDP, col_k = da + h * HDP, col_v = 2 * da + h * HDP;
    obase = (long long)z * S * da + h * HDP, ld = da;
  } else {
    z = blockIdx.x;
    col_q = col_k = col_v = 0;
    obase = (long long)z * S * 64, ld = 64;
  }

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], C * NK * 64 * 2);
    for (int c = 0; c < C; ++c)
      for (int i = 0; i < NK / KB; ++i)
        tma_load_3d(Ks + c * NK * 64 + i * KB * 64, &tm_k, &bars[0], col_k + 64 * c, i * KB, z);
    for (int i = 0; i < 2 && i < nq; ++i) {
      mbar_expect_tx(&bars[2 + i], C * CORE_QBOX * 2);
      for (int c = 0; c < C; ++c)
        tma_load_3d(Qs + (i * C + c) * CORE_QBOX, &tm_q, &bars[2 + i], col_q + 64 * c, i * 64, z);
    }
    mbar_expect_tx(&bars[1], C * NK * 64 * 2);
    for (int c = 0; c < C; ++c)
      for (int i = 0; i < NK / KB; ++i)
        tma_load_3d(Vs + c * NK * 64 + i * KB * 64, &tm_v, &bars[1], col_v + 64 * c, i * KB, z);
  }
  mbar_wait(&bars[0], 0);

  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    mbar_wait(&bars[2 + buf], (qt >> 1) & 1);
    const int row_lo = qt * 64 + warp * 16 + g, row_hi = row_lo + 8;

    // S = Q K^T over the whole (bucketed) key range, 4 K-steps of 16 dims
    // per chunk.
    float sc[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint64_t dq = desc_sw128(Qs + (buf * C + c) * CORE_QBOX);
      const uint64_t dk = desc_sw128(Ks + c * NK * 64);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) qk_wgmma<NK>(sc, dq + 2 * kk, dk + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // the buffer is read: bring in the query tile after next
    if (tid == 0 && qt + 2 < nq) {
      mbar_expect_tx(&bars[2 + buf], C * CORE_QBOX * 2);
      for (int c = 0; c < C; ++c)
        tma_load_3d(Qs + (buf * C + c) * CORE_QBOX, &tm_q, &bars[2 + buf], col_q + 64 * c,
                    (qt + 2) * 64, z);
    }

    // P, normalised and rounded, as the A fragments of the PV steps: step j
    // takes score chunks 2j (a0, a1) and 2j + 1 (a2, a3); chunk nt holds
    // keys nt*8 + 2t, +1 of rows g (lo) and g + 8 (hi).
    uint32_t pa[NJ * 4];
#pragma unroll
    for (int i = 0; i < NJ * 4; ++i) pa[i] = 0u;
    float l_lo = 1.f, l_hi = 1.f, r_lo = 1.f, r_hi = 1.f;  // the f32 row sums, 1 / them
    if constexpr (!SOFTMAX) {
      if (qt * 64 + warp * 16 < S) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * t + e;
            v[e] = (col < S && (!causal || col <= row_lo)) ? sc[nt * 4 + e] * scale : 0.f;
            v[2 + e] = (col < S && (!causal || col <= row_hi)) ? sc[nt * 4 + 2 + e] * scale : 0.f;
          }
          pa[2 * nt] = pack_bf16(v[0], v[1]);
          pa[2 * nt + 1] = pack_bf16(v[2], v[3]);
        }
      }
    } else if (qt * 64 + warp * 16 < S) {
      // K5: rows past S compute on row S-1's mask and are never stored
      const float *mlo = nullptr, *mhi = nullptr;
      if constexpr (SRC == CORE_HEADS) {
        mlo = mask + (long long)min(row_lo, S - 1) * S;
        mhi = mask + (long long)min(row_hi, S - 1) * S;
      }
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const bool in = col < S;
          float& lo = sc[nt * 4 + e];
          float& hi = sc[nt * 4 + 2 + e];
          if constexpr (SRC == CORE_PACKED) {
            lo = (in && (!causal || col <= row_lo)) ? lo * scale : -INFINITY;
            hi = (in && (!causal || col <= row_hi)) ? hi * scale : -INFINITY;
          } else {  // no FMA contraction: the twin rounds the product
            lo = in ? __fadd_rn(__fmul_rn(lo, scale), mlo[col]) : -INFINITY;
            hi = in ? __fadd_rn(__fmul_rn(hi, scale), mhi[col]) : -INFINITY;
          }
          m_lo = fmaxf(m_lo, lo);
          m_hi = fmaxf(m_hi, hi);
        }
      }
      m_lo = quad_max(m_lo);
      m_hi = quad_max(m_hi);
      float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& lo = sc[nt * 4 + e];
          float& hi = sc[nt * 4 + 2 + e];
          lo = lo == -INFINITY ? 0.f : expf(lo - m_lo);
          hi = hi == -INFINITY ? 0.f : expf(hi - m_hi);
          s_lo += lo;
          s_hi += hi;
        }
      }
      l_lo = quad_sum(s_lo);
      l_hi = quad_sum(s_hi);
      r_lo = 1.0f / l_lo;
      r_hi = 1.0f / l_hi;
      const bool after = SOFTMAX == 2 || norm_after;
      const float p_lo = after ? 1.f : r_lo, p_hi = after ? 1.f : r_hi;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pa[2 * nt] = pack_bf16(sc[nt * 4] * p_lo, sc[nt * 4 + 1] * p_lo);
        pa[2 * nt + 1] = pack_bf16(sc[nt * 4 + 2] * p_hi, sc[nt * 4 + 3] * p_hi);
      }
    }
    if (qt == 0) mbar_wait(&bars[1], 0);

    // O = P V over every 16-key step (P is 0 past S and past the mask), one
    // 64-dim chunk of V at a time.
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint64_t dv = desc_sw128(Vs + c * NK * 64, 1024);
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_rs_n64_tb(o, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * j]),
                        dv + j * (16 * 128 >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if constexpr (SOFTMAX == 2) {  // o / l, rows as below
        bool slow = !(l_lo < INFINITY && l_hi < INFINITY);  // NaN too
#pragma unroll
        for (int i = 0; i < 32; ++i)  // below 2^-100, inf or NaN: qq_div's steps would not be exact
          slow |= o[i] != 0.f && !(fabsf(o[i]) >= 0x1p-100f && fabsf(o[i]) < INFINITY);
        if (!slow) {
          const float rl_lo = __frcp_rn(l_lo), rl_hi = __frcp_rn(l_hi);
#pragma unroll
          for (int i = 0; i < 32; ++i)  // a zero keeps its sign, as the IEEE quotient's
            o[i] = o[i] == 0.f ? o[i]
                   : (i & 2)   ? qq_div(o[i], l_hi, rl_hi)
                               : qq_div(o[i], l_lo, rl_lo);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = __fdiv_rn(o[i], (i & 2) ? l_hi : l_lo);
        }
      } else if (norm_after == 2) {  // accumulator i holds row hi when bit 1 of i is set
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = __fdiv_rn(o[i], (i & 2) ? l_hi : l_lo);
      } else if (norm_after == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? r_hi : r_lo;
      }

      bf16* out = out_base + obase + 64 * c + 2 * t;
#pragma unroll
      for (int on = 0; on < 8; ++on) {
        if (row_lo < S)
          *reinterpret_cast<uint32_t*>(out + (long long)row_lo * ld + on * 8) =
              pack_bf16(o[on * 4], o[on * 4 + 1]);
        if (row_hi < S)
          *reinterpret_cast<uint32_t*>(out + (long long)row_hi * ld + on * 8) =
              pack_bf16(o[on * 4 + 2], o[on * 4 + 3]);
      }
    }
  }
}

template <int NK, int SRC, int SOFTMAX, int C>
cudaError_t launch_core_kernel(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                               const CUtensorMap& tm_v, bf16* out, const float* mask, int S,
                               int da, float scale, int causal, int norm_after, dim3 grid,
                               cudaStream_t st) {
  const size_t smem = core_smem_bytes(NK, C);
  cudaError_t e = cudaFuncSetAttribute(attention_wgmma_kernel<NK, SRC, SOFTMAX, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_wgmma_kernel<NK, SRC, SOFTMAX, C><<<grid, CORE_THREADS, smem, st>>>(
      tm_q, tm_k, tm_v, out, mask, S, da, scale, causal, norm_after);
  return cudaGetLastError();
}

// The softmax-off instantiation for the packed source's NORM_OFF at head
// dim 64 (K5's heads-first source and the wider heads have none), the
// divide-after one where DIV (norm_after = 2 only), the softmax one
// otherwise.
template <int NK, int SRC, int C, bool DIV = false>
cudaError_t launch_core_wgmma(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                              const CUtensorMap& tm_v, bf16* out, const float* mask, int S,
                              int da, float scale, int causal, int norm_after, dim3 grid,
                              cudaStream_t st) {
  if constexpr (DIV) {
    if (norm_after != 2) return cudaErrorInvalidValue;
    return launch_core_kernel<NK, SRC, 2, C>(tm_q, tm_k, tm_v, out, mask, S, da, scale, causal,
                                             norm_after, grid, st);
  }
  if constexpr (SRC == CORE_PACKED && C == 1) {
    if (norm_after == NORM_OFF)
      return launch_core_kernel<NK, SRC, 0, C>(tm_q, tm_k, tm_v, out, mask, S, da, scale, causal,
                                               norm_after, grid, st);
  }
  if (norm_after == NORM_OFF) return cudaErrorInvalidValue;
  return launch_core_kernel<NK, SRC, 1, C>(tm_q, tm_k, tm_v, out, mask, S, da, scale, causal,
                                           norm_after, grid, st);
}

template <int SRC, int C, bool DIV = false>
cudaError_t launch_core_bucket(int nk, const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                               const CUtensorMap& tm_v, bf16* out, const float* mask, int S,
                               int da, float scale, int causal, int norm_after, dim3 grid,
                               cudaStream_t st) {
#define DVL_CORE_BUCKET(NK)                                                              \
  launch_core_wgmma<NK, SRC, C, DIV>(tm_q, tm_k, tm_v, out, mask, S, da, scale, causal, \
                                     norm_after, grid, st)
  switch (nk) {
    case 32: return DVL_CORE_BUCKET(32);
    case 80: return DVL_CORE_BUCKET(80);
    case 200: return DVL_CORE_BUCKET(200);
    case 256: return DVL_CORE_BUCKET(256);
    default: return DVL_CORE_BUCKET(320);
  }
#undef DVL_CORE_BUCKET
}

// K1 and K3: qkv [B*S, ld] (q | k | v, each heads x hdp columns, in its
// first 3 heads hdp) -> attn [B*S, heads hdp]; hdp = 64 C, the head dim
// zero-padded by the operand plan (ops/fused_block.py::attn_plan), `scale`
// the true head dim's hd^-0.5; any S >= 1: 1 <= S <= 320 at hdp <= 128 on
// the register core above, every other shape on the two-pass long route's
// packed source (attention_long.cuh), whose whole score rows no longer fit
// in registers.  ops/fused_block.py::core_route names the same choice.  K1
// and K3 pass ld = 3 heads hdp rounded up to 128; a tensor-parallel slot
// passes its g heads at hdp 64 and its padded slice's ld; KB (a) 6 passes
// scale = ln 2 and norm_after (see the top of this file); KB (a) 4 scale =
// 1/8 with norm_after = 2; the attribution's "mxu" core scale = hd^-0.5
// with NORM_OFF (the register core's softmax-off instantiations are hdp
// 64's; a wider head takes the long route, which has the mode at any hdp);
// q_ilp4 DIV with norm_after = 2 (the divide-after instantiations).
template <bool DIV = false>
cudaError_t launch_attention_wgmma(const bf16* qkv, bf16* attn, int B, int S, int heads, int hdp,
                                   int causal, cudaStream_t st, int ld, float scale,
                                   int norm_after) {
  const int c = hdp / 64, da = heads * hdp;
  if (S < 1 || B < 1 || heads < 1 || hdp % 64 || c < 1 || ld < 3 * da || ld % 8)
    return cudaErrorInvalidValue;
  if (S > CORE_MAX_SEQ || c > CORE_MAX_C || (norm_after == NORM_OFF && c > 1))
    return launch_long_packed(qkv, attn, B, S, heads, hdp, causal, st, ld, scale, norm_after);
  const int nk = core_keys(S);
  CUtensorMap tm_q, tm_kv;
  const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)S * ld * 2};
  const uint32_t box_q[3] = {64, 64, 1}, box_kv[3] = {64, (uint32_t)core_kv_box(nk), 1};
  cudaError_t e = make_tensor_map(&tm_q, qkv, 3, dims, strides, box_q);
  if (e != cudaSuccess) return e;
  e = make_tensor_map(&tm_kv, qkv, 3, dims, strides, box_kv);
  if (e != cudaSuccess) return e;
  if (c == 1)
    return launch_core_bucket<CORE_PACKED, 1, DIV>(nk, tm_q, tm_kv, tm_kv, attn, nullptr, S, da,
                                                   scale, causal, norm_after, dim3(heads, B), st);
  return launch_core_bucket<CORE_PACKED, 2, DIV>(nk, tm_q, tm_kv, tm_kv, attn, nullptr, S, da,
                                                 scale, causal, norm_after, dim3(heads, B), st);
}

// K5: q, k, v [BH, S, 64] -> out [BH, S, 64] with the additive f32 mask
// [S, S]; 1 <= S <= 320.
cudaError_t launch_attention_wgmma_heads(const bf16* q, const bf16* k, const bf16* v,
                                         const float* mask, bf16* out, int BH, int S,
                                         cudaStream_t st) {
  if (S < 1 || S > CORE_MAX_SEQ || BH < 1) return cudaErrorInvalidValue;
  const int nk = core_keys(S);
  CUtensorMap tm[3];
  const uint64_t dims[3] = {64, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {64 * 2, (uint64_t)S * 64 * 2};
  const uint32_t box_q[3] = {64, 64, 1}, box_kv[3] = {64, (uint32_t)core_kv_box(nk), 1};
  const bf16* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t e = make_tensor_map(&tm[i], src[i], 3, dims, strides, i == 0 ? box_q : box_kv);
    if (e != cudaSuccess) return e;
  }
  return launch_core_bucket<CORE_HEADS, 1>(nk, tm[0], tm[1], tm[2], out, mask, S, 64,
                                           1.0f / sqrtf(64.0f), 0, 0, dim3(BH), st);
}

}  // namespace
