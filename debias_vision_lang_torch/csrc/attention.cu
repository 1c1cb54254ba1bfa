// Hand-written Hopper (sm_90a) attention kernels for the heads-first
// attention op, with a plain C interface bound from Python through ctypes
// (debias_vision_lang_torch/ops/attention.py::attention_pallas).
//
// Replaces the TPU Pallas kernel debias_vision_lang_tpu/ops/attention.py::
// _attention_pallas_padded (body _attn_kernel): out = softmax(q k^T * scale
// + mask) v over q, k, v [B*H, S, hd] and an additive f32 mask [S, S] read
// from memory (CLIP's causal mask holds -inf above the diagonal: those keys
// give exp = 0).  The numerics are the plain twin's, attention_kernel_math:
// scores * scale + mask (two roundings, no FMA), the row max, exp, the row
// sum and the normalisation in f32 on the CUDA cores over whole score rows,
// P rounded to the input dtype, then P @ V with one output rounding.  The
// wrapper picks one of two routes from the shape alone:
//   * short (S <= 320, hd = 64): whole score rows held in registers.
//     - bf16 inputs: the wgmma core of attention_wgmma.cuh that K1 runs,
//       read through three heads-first tensor maps: bf16 products with f32
//       accumulation, P rounded to bf16 before P @ V, one output rounding;
//     - f32 inputs: both products on the tensor cores as 3xTF32 (CUTLASS's
//       OpMultiplyAddFastF32, which PyTorch's memory-efficient attention
//       runs for float32): each operand x splits into big = tf32(x) and
//       small = tf32(x - big) (cvt.rna), and each product is big*big +
//       big*small + small*big on mma.sync m16n8k8 tf32, accumulated in f32.
//       The dropped small*small term and the split are ~2^-22 of each
//       product, far inside the twin's 2e-5 bar; a single TF32 product keeps
//       ~3 decimal digits and misses it (tests/test_torch_attention.py holds
//       both);
//   * long (any other S, any head dim): a score row no longer fits
//     in registers, so the kernel walks 64-key tiles twice -- the row max and
//     a rescaled row sum, then the same scores again, normalised, into P @ V
//     -- on TMA-fed wgmma (attention_long_kernel, csrc/attention_long.cuh,
//     which K1 and K3 share past 320 keys).  The wrapper zero-pads
//     the head dim to a multiple of 64 (zero columns change no score and add
//     zero output columns) and passes the scale of the original head dim, as
//     the JAX function pads to 128 lanes; past 192 dims the wide-head mode
//     (attention_wide_kernel): blocks of 64 queries own groups of at most
//     four 64-dim output chunks, a statistics launch computes each row's max
//     and sum once when there is more than one group, and at f32 a pre-pass
//     splits Q, K and V^T into TF32 halves once per call, all into a
//     workspace the wrapper allocates; Q streams through a ring of its own
//     where it does not fit, so no head dim is too wide for shared memory.
//     Products: bf16 wgmma with f32 accumulators, or 3xTF32 (tf32 wgmma).
// The TPU kernel's padding (S to 8/16, hd to 128 lanes, padded keys at -1e9)
// and its VMEM group budget are TPU devices and are not carried over: here
// keys past S are zero-filled on load and masked at -inf.
//
// What bounds it on an H100: at the towers' shapes (S = 197 image, S = 77
// text, hd = 64) the whole op moves q, k, v and out once (0.046 ms at
// B=64 H=12 S=197 in f32 over 3.35 TB/s) and its products, three TF32
// products per f32 one, take about as long at the TF32 peak; f32 FMAs on
// the CUDA cores (67 TFLOP/s) could not come near either.  The short f32
// design: one block per (batch, head) slice loads K and V once into shared
// memory (rows padded so the fragment loads hit 32 banks) and its eight
// warps walk the slice's 16-row query chunks; each warp keeps its chunk's
// score rows and outputs in mma.sync accumulators, and the probabilities
// feed P @ V from the accumulator layout without a shuffle: inside each
// 8-key step the k index t stands for key 2t and t + 4 for key 2t + 1, in P
// and in V alike (and likewise for the head dims of Q K^T, so each Q or K
// pair is one float2).  The long route reads K twice and V once per 128
// (bf16; f32 at hd 64) or 64 query rows, and computes Q K^T twice.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "attention_wgmma.cuh"

namespace {

constexpr int F32_THREADS = 256;  // 8 warps, 16 query rows each at a time
constexpr int LDK32 = HD + 8;     // K row stride (floats): float2 loads of rows g hit 32 banks
constexpr int LDV32 = HD + 4;     // V row stride: loads of rows 2t and 2t + 1 hit 32 banks

__host__ inline size_t f32_smem_bytes(int nk) { return (size_t)nk * (LDK32 + LDV32) * 4; }


__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two cross terms first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(d, a_small, bb0, bb1);
  mma_tf32(d, a_big, bs0, bs1);
  mma_tf32(d, a_big, bb0, bb1);
}

// One block per (batch, head) slice; NK = the key count rounded up to the
// core's bucket (32, 80, 200, 256, 320).  m16n8k8 fragments: thread (g =
// lane / 4, t = lane % 4) holds rows g and g + 8 of each accumulator tile,
// at columns 2t and 2t + 1.  Up to 200 keys two blocks share an SM (112 KB
// of shared memory each): 16 warps at the 128-register cap, with a few
// hundred bytes of spills, hid the mma.sync and load latencies better than
// 8 warps at 255 registers (measured).
// The 8-dim steps of Q K^T are a loop, not unrolled: the fully unrolled
// kernel ran out of the instruction cache.
template <int NK>
__global__ void __launch_bounds__(F32_THREADS, NK <= 200 ? 2 : 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out, int S, float scale) {
  constexpr int NT = NK / 8;  // 8-key tiles of a score row, and 8-key steps of P @ V
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [NK][LDK32]
  float* Vs = Ks + NK * LDK32;                 // [NK][LDV32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long slice = (long long)blockIdx.x * S * HD;
  const float* kb = k + slice;
  const float* vb = v + slice;

  // K and V of the slice, 16 bytes a copy; rows past S are zero-filled.
  for (int c = tid; c < NK * (HD / 4); c += F32_THREADS) {
    const int r = c >> 4, cc = (c & 15) * 4;
    const bool ok = r < S;
    cp_async16(Ks + r * LDK32 + cc, ok ? kb + r * HD + cc : kb, ok);
    cp_async16(Vs + r * LDV32 + cc, ok ? vb + r * HD + cc : vb, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* qb = q + slice;
  float* ob = out + slice + 2 * t;
  for (int chunk = warp; chunk * 16 < S; chunk += F32_THREADS / 32) {
    const int row_lo = chunk * 16 + g, row_hi = row_lo + 8;
    // rows past S compute on row S-1 and are never stored
    const float* qlo = qb + (long long)min(row_lo, S - 1) * HD + 2 * t;
    const float* qhi = qb + (long long)min(row_hi, S - 1) * HD + 2 * t;

    // S = Q K^T: per 8-dim step, k index t <-> dim 2t, t + 4 <-> dim 2t + 1.
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 xl = *reinterpret_cast<const float2*>(qlo + kk * 8);
      const float2 xh = *reinterpret_cast<const float2*>(qhi + kk * 8);
      uint32_t ab[4], as[4];
      split_tf32(xl.x, ab[0], as[0]);
      split_tf32(xh.x, ab[1], as[1]);
      split_tf32(xl.y, ab[2], as[2]);
      split_tf32(xh.y, ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv =
            *reinterpret_cast<const float2*>(Ks + (nt * 8 + g) * LDK32 + kk * 8 + 2 * t);
        mma_3xtf32(sc[nt], ab, as, kv.x, kv.y);
      }
    }

    // scores * scale + mask (no FMA contraction: the twin rounds the
    // product), keys past S at -inf; the softmax over each whole row (a row
    // is spread over the 4 threads of a quad), divided by the f32 row sum
    // before the P V loop (a division inside it, with its slow-path call,
    // stalled the loop: measured).
    const float* mlo = mask + (long long)min(row_lo, S - 1) * S;
    const float* mhi = mask + (long long)min(row_hi, S - 1) * S;
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        const bool in = col < S;
        sc[nt][e] = in ? __fadd_rn(__fmul_rn(sc[nt][e], scale), mlo[col]) : -INFINITY;
        sc[nt][2 + e] = in ? __fadd_rn(__fmul_rn(sc[nt][2 + e], scale), mhi[col]) : -INFINITY;
        m_lo = fmaxf(m_lo, sc[nt][e]);
        m_hi = fmaxf(m_hi, sc[nt][2 + e]);
      }
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = sc[nt][e] == -INFINITY ? 0.f : expf(sc[nt][e] - m_lo);
        sc[nt][2 + e] = sc[nt][2 + e] == -INFINITY ? 0.f : expf(sc[nt][2 + e] - m_hi);
        s_lo += sc[nt][e];
        s_hi += sc[nt][2 + e];
      }
    }
    s_lo = quad_sum(s_lo);
    s_hi = quad_sum(s_hi);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = __fdiv_rn(sc[nt][0], s_lo);
      sc[nt][1] = __fdiv_rn(sc[nt][1], s_lo);
      sc[nt][2] = __fdiv_rn(sc[nt][2], s_hi);
      sc[nt][3] = __fdiv_rn(sc[nt][3], s_hi);
    }

    // O = P V: step j takes score tile j as it lies (k index t <-> key
    // 8j + 2t: elements 0 and 2; t + 4 <-> key 8j + 2t + 1: elements 1 and
    // 3), and V rows 8j + 2t and 8j + 2t + 1 at column g of each 8-dim tile.
    float o[HD / 8][4];
#pragma unroll
    for (int on = 0; on < HD / 8; ++on) o[on][0] = o[on][1] = o[on][2] = o[on][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(sc[j][0], ab[0], as[0]);
      split_tf32(sc[j][2], ab[1], as[1]);
      split_tf32(sc[j][1], ab[2], as[2]);
      split_tf32(sc[j][3], ab[3], as[3]);
      const float* vr = Vs + (j * 8 + 2 * t) * LDV32 + g;
#pragma unroll
      for (int on = 0; on < HD / 8; ++on) mma_3xtf32(o[on], ab, as, vr[on * 8], vr[LDV32 + on * 8]);
    }

#pragma unroll
    for (int on = 0; on < HD / 8; ++on) {
      if (row_lo < S)
        *reinterpret_cast<float2*>(ob + (long long)row_lo * HD + on * 8) =
            make_float2(o[on][0], o[on][1]);
      if (row_hi < S)
        *reinterpret_cast<float2*>(ob + (long long)row_hi * HD + on * 8) =
            make_float2(o[on][2], o[on][3]);
    }
  }
}

template <int NK>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* mask,
                       float* out, int BH, int S, float scale, cudaStream_t st) {
  const size_t smem = f32_smem_bytes(NK);
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_f32_kernel<NK><<<BH, F32_THREADS, smem, st>>>(q, k, v, mask, out, S, scale);
  return cudaGetLastError();
}


// hdp 64, 128 and 192: the whole head a block, Q resident, the scores once
// a head (attention_long_kernel); any wider hdp (a multiple of 64): the
// wide-head mode (launch_wide), its workspace `ws`.  hdp 192 stays resident:
// see the hdp-192 note in attention_long.cuh.
template <typename T>
cudaError_t launch_long_hdp(const T* q, const T* k, const T* v, const float* mask, T* out,
                            int BH, int S, int hdp, float scale, void* ws, size_t ws_bytes,
                            cudaStream_t st) {
  if (S < 1 || BH < 1 || hdp < 64 || hdp % 64) return cudaErrorInvalidValue;
  if (hdp == 64) return launch_long<T, 1>(q, k, v, mask, out, BH, S, scale, st);
  if (hdp == 128) return launch_long<T, 2>(q, k, v, mask, out, BH, S, scale, st);
  if (hdp == 192) return launch_long<T, 3>(q, k, v, mask, out, BH, S, scale, st);
  return launch_wide<T>(q, k, v, mask, out, BH, S, hdp, scale, ws, ws_bytes, st);
}

}  // namespace

extern "C" {

// out = softmax(q k^T * scale + mask) v; q, k, v, out [BH, S, hd]
// contiguous and 16-byte aligned, bf16 (is_bf16 = 1) or f32 (0); mask f32.
// long_route = 0: the short routes, hd == 64 and 1 <= S <= 320 (the wgmma
// core's scale is 1/sqrt(64)), mask [S, S]; long_route = 1: the two-pass
// kernel, any S >= 1 and any hd a multiple of 64 (the wrapper's zero padding),
// mask [S, (S + 63) & ~63] whose columns past S hold -inf; past hd 192 `ws`
// holds at least wide_ws_bytes (attention_long.cuh; the wrapper's
// _wide_workspace_bytes) bytes, null when that is 0.
int dvl_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                  int BH, int S, int hd, int is_bf16, int long_route, float scale, void* ws,
                  long long ws_bytes, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  if (long_route) {
    if (is_bf16)
      return (int)launch_long_hdp(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                  static_cast<const bf16*>(v), mk, static_cast<bf16*>(out), BH,
                                  S, hd, scale, ws, (size_t)ws_bytes, st);
    return (int)launch_long_hdp(static_cast<const float*>(q), static_cast<const float*>(k),
                                static_cast<const float*>(v), mk, static_cast<float*>(out), BH,
                                S, hd, scale, ws, (size_t)ws_bytes, st);
  }
  if (S < 1 || S > CORE_MAX_SEQ || hd != HD || BH < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_attention_wgmma_heads(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mk, static_cast<bf16*>(out), BH, S, st);
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  switch (core_keys(S)) {
    case 32: return (int)launch_f32<32>(qq, kk, vv, mk, oo, BH, S, scale, st);
    case 80: return (int)launch_f32<80>(qq, kk, vv, mk, oo, BH, S, scale, st);
    case 200: return (int)launch_f32<200>(qq, kk, vv, mk, oo, BH, S, scale, st);
    case 256: return (int)launch_f32<256>(qq, kk, vv, mk, oo, BH, S, scale, st);
    default: return (int)launch_f32<320>(qq, kk, vv, mk, oo, BH, S, scale, st);
  }
}

}  // extern "C"
