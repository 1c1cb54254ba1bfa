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
//   * long (any other S or head dim): a score row no longer fits in
//     registers, so the kernel walks 64-key tiles three times -- row max, row
//     sum, then normalised P @ V -- recomputing the scores each time (see
//     attention_long_kernel).  The wrapper zero-pads the head dim to a
//     multiple of 64 (zero columns change no score and add zero output
//     columns) and passes the scale of the original head dim, as the JAX
//     function pads to 128 lanes.  Products: 3xTF32 (f32) or mma.sync
//     m16n8k16 bf16 with f32 accumulators.
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
// pair is one float2).  The long route is a simple kernel first: it reads K
// three times and V once per 64-query tile, and computes Q K^T three times.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "attention_wgmma.cuh"

namespace {

constexpr int F32_THREADS = 256;  // 8 warps, 16 query rows each at a time
constexpr int LDK32 = HD + 8;     // K row stride (floats): float2 loads of rows g hit 32 banks
constexpr int LDV32 = HD + 4;     // V row stride: loads of rows 2t and 2t + 1 hit 32 banks

__host__ inline size_t f32_smem_bytes(int nk) { return (size_t)nk * (LDK32 + LDV32) * 4; }

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

// ---------------------------------------------------------------------------
// The long route: any S, and any head dim once the wrapper has zero-padded it
// to hdp, a multiple of 64.  One block of four warps per (slice, 64-query
// tile, 64-wide chunk of the output head dim); warp w owns query rows 16w ..
// 16w + 15 of the tile.  The block walks the 64-key tiles of K (and, in the
// last pass, V) through shared memory, zero-filled past S, in three passes:
//   1. the f32 row max of fadd(fmul(s, scale), mask);
//   2. the f32 row sum of exp(s - max);
//   3. p = exp(s - max) / sum (IEEE division), rounded to the input dtype,
//      and O += p V with f32 accumulators; one output rounding.
// Each pass recomputes the scores over the whole head dim (one 64-dim chunk
// of Q and K at a time).  No partial output is ever rescaled, so the function
// and its rounding points are the twin's: an online softmax is another
// function at bf16.  Rows past S compute on row S-1's mask and are never
// stored.
// ---------------------------------------------------------------------------

constexpr int LONG_THREADS = 128;  // four warps of 16 query rows
constexpr int LT = 64;             // query rows, keys and head dims per tile

// Shared-memory row strides (elements): f32 Q and K rows of 72 floats put the
// float2 fragment loads of rows g on 32 banks, V rows of 68 floats the loads
// of rows 2t and 2t + 1; bf16 rows of 72 (36 words) do the same for the
// 32-bit loads.
template <typename T>
struct LongLd;
template <>
struct LongLd<float> {
  static constexpr int QK = 72, V = 68;
};
template <>
struct LongLd<bf16> {
  static constexpr int QK = 72, V = 72;
};

template <typename T>
constexpr size_t long_smem_bytes() {
  return (size_t)LT * (2 * LongLd<T>::QK + LongLd<T>::V) * sizeof(T);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values as one 32-bit fragment register, the first in the low half.
__device__ __forceinline__ uint32_t pair_u32(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// sc += Q K^T over one 64-dim chunk: this warp's 16 query rows (r0 ..) against
// the tile's 64 keys; sc[nt] is the m16n8 accumulator of keys 8nt .. 8nt + 7.
// f32: 3xTF32, k index t <-> dim 2t and t + 4 <-> 2t + 1 (one float2 each).
__device__ __forceinline__ void qk_chunk(float (&sc)[8][4], const float* Qs, const float* Ks,
                                         int r0, int g, int t) {
  constexpr int LD = LongLd<float>::QK;
  const float* qlo = Qs + (r0 + g) * LD + 2 * t;
  const float* qhi = qlo + 8 * LD;
#pragma unroll 1
  for (int kk = 0; kk < LT / 8; ++kk) {
    const float2 xl = *reinterpret_cast<const float2*>(qlo + kk * 8);
    const float2 xh = *reinterpret_cast<const float2*>(qhi + kk * 8);
    uint32_t ab[4], as[4];
    split_tf32(xl.x, ab[0], as[0]);
    split_tf32(xh.x, ab[1], as[1]);
    split_tf32(xl.y, ab[2], as[2]);
    split_tf32(xh.y, ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 kv =
          *reinterpret_cast<const float2*>(Ks + (nt * 8 + g) * LD + kk * 8 + 2 * t);
      mma_3xtf32(sc[nt], ab, as, kv.x, kv.y);
    }
  }
}

// bf16: m16n8k16 with f32 accumulators, the fragments as 32-bit pairs.
__device__ __forceinline__ void qk_chunk(float (&sc)[8][4], const bf16* Qs, const bf16* Ks,
                                         int r0, int g, int t) {
  constexpr int LD = LongLd<bf16>::QK;
  const bf16* qlo = Qs + (r0 + g) * LD + 2 * t;
  const bf16* qhi = qlo + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < LT / 16; ++kk) {
    const uint32_t qa[4] = {ld_u32(qlo + kk * 16), ld_u32(qhi + kk * 16),
                            ld_u32(qlo + kk * 16 + 8), ld_u32(qhi + kk * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* kr = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(sc[nt], qa, ld_u32(kr), ld_u32(kr + 8));
    }
  }
}

// o += P V over the tile's 64 keys and this block's 64 output dims; p holds
// the normalised probabilities in the accumulator layout of the scores.
// f32: step j takes score tile j as it lies (k index t <-> key 8j + 2t,
// t + 4 <-> key 8j + 2t + 1), as the short f32 kernel does.
__device__ __forceinline__ void pv_tile(float (&o)[8][4], const float (&p)[8][4],
                                        const float* Vs, int g, int t) {
  constexpr int LD = LongLd<float>::V;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const float* vr = Vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int on = 0; on < 8; ++on) mma_3xtf32(o[on], ab, as, vr[on * 8], vr[LD + on * 8]);
  }
}

// bf16: P rounded to bf16; step j takes score tiles 2j (a0, a1) and 2j + 1
// (a2, a3), and V rows 16j + 2t, +1, +8, +9 at column g of each 8-dim tile.
__device__ __forceinline__ void pv_tile(float (&o)[8][4], const float (&p)[8][4],
                                        const bf16* Vs, int g, int t) {
  constexpr int LD = LongLd<bf16>::V;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const bf16* vr = Vs + (j * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int on = 0; on < 8; ++on) {
      const bf16* c = vr + on * 8;
      mma_bf16(o[on], pa, pair_u32(c[0], c[LD]), pair_u32(c[8 * LD], c[9 * LD]));
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float exp_or_zero(float x, float m) {
  return x == -INFINITY ? 0.f : expf(x - m);
}

template <typename T>
__global__ void __launch_bounds__(LONG_THREADS)
attention_long_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ out, int S, int hdp,
                      float scale) {
  constexpr int LDQK = LongLd<T>::QK, LDV = LongLd<T>::V;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [64][LDQK]: one 64-dim chunk of the query tile
  T* Ks = Qs + LT * LDQK;              // [64][LDQK]: one 64-dim chunk of a key tile
  T* Vs = Ks + LT * LDQK;              // [64][LDV]: a key tile's 64 output dims

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long slice = (long long)blockIdx.x * S * hdp;
  const int q0 = blockIdx.y * LT, d0 = blockIdx.z * LT;
  const int nchunk = hdp / LT, nkt = (S + LT - 1) / LT;
  const T* qb = q + slice;
  const T* kb = k + slice;
  const T* vb = v + slice;
  const int r0 = warp * 16;
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  const float* mlo = mask + (long long)min(row_lo, S - 1) * S;
  const float* mhi = mask + (long long)min(row_hi, S - 1) * S;

  // rows r .. r + 63, columns c .. c + 63 of an [S, hdp] operand into a tile
  // of row stride ld, 16 bytes a copy; rows past S are zero-filled
  auto load = [&](T* dst, const T* src, int r, int c, int ld) {
    for (int i = tid; i < LT * (LT / EPC); i += LONG_THREADS) {
      const int rr = i / (LT / EPC), cc = (i % (LT / EPC)) * EPC;
      const bool ok = r + rr < S;
      cp_async16(dst + rr * ld + cc, ok ? src + (long long)(r + rr) * hdp + c + cc : src, ok);
    }
  };

  int q_chunk = -1;  // the head-dim chunk of the query tile now in Qs
  // the scores of key tile kt over the whole head dim, as fadd(fmul(s,
  // scale), mask) and -inf past S; with_v also brings in the tile's V
  auto scores = [&](float (&sc)[8][4], int kt, bool with_v) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      __syncthreads();  // every warp is done with the tiles about to be replaced
      if (c != q_chunk) {
        load(Qs, qb, q0, c * LT, LDQK);
        q_chunk = c;
      }
      load(Ks, kb, kt * LT, c * LT, LDQK);
      if (with_v && c == 0) load(Vs, vb, kt * LT, d0, LDV);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      qk_chunk(sc, Qs, Ks, r0, g, t);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kt * LT + nt * 8 + 2 * t + e;
        const bool in = col < S;
        sc[nt][e] = in ? __fadd_rn(__fmul_rn(sc[nt][e], scale), mlo[col]) : -INFINITY;
        sc[nt][2 + e] = in ? __fadd_rn(__fmul_rn(sc[nt][2 + e], scale), mhi[col]) : -INFINITY;
      }
    }
  };

  float sc[8][4];
  // 1. row max
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(sc, kt, false);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m_lo = fmaxf(m_lo, fmaxf(sc[nt][0], sc[nt][1]));
      m_hi = fmaxf(m_hi, fmaxf(sc[nt][2], sc[nt][3]));
    }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // 2. row sum
  float l_lo = 0.f, l_hi = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(sc, kt, false);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l_lo += exp_or_zero(sc[nt][0], m_lo) + exp_or_zero(sc[nt][1], m_lo);
      l_hi += exp_or_zero(sc[nt][2], m_hi) + exp_or_zero(sc[nt][3], m_hi);
    }
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  // 3. normalised probabilities, P @ V
  float o[8][4];
#pragma unroll
  for (int on = 0; on < 8; ++on) o[on][0] = o[on][1] = o[on][2] = o[on][3] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(sc, kt, true);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = __fdiv_rn(exp_or_zero(sc[nt][0], m_lo), l_lo);
      sc[nt][1] = __fdiv_rn(exp_or_zero(sc[nt][1], m_lo), l_lo);
      sc[nt][2] = __fdiv_rn(exp_or_zero(sc[nt][2], m_hi), l_hi);
      sc[nt][3] = __fdiv_rn(exp_or_zero(sc[nt][3], m_hi), l_hi);
    }
    pv_tile(o, sc, Vs, g, t);
  }

  T* ob = out + slice + d0 + 2 * t;
#pragma unroll
  for (int on = 0; on < 8; ++on) {
    if (row_lo < S) store_pair(ob + (long long)row_lo * hdp + on * 8, o[on][0], o[on][1]);
    if (row_hi < S) store_pair(ob + (long long)row_hi * hdp + on * 8, o[on][2], o[on][3]);
  }
}

template <typename T>
cudaError_t launch_long(const T* q, const T* k, const T* v, const float* mask, T* out, int BH,
                        int S, int hdp, float scale, cudaStream_t st) {
  if (S < 1 || BH < 1 || hdp < LT || hdp % LT) return cudaErrorInvalidValue;
  constexpr size_t smem = long_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(attention_long_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (S + LT - 1) / LT, hdp / LT);
  attention_long_kernel<T><<<grid, LONG_THREADS, smem, st>>>(q, k, v, mask, out, S, hdp, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = softmax(q k^T * scale + mask) v; q, k, v, out [BH, S, hd]
// contiguous and 16-byte aligned, bf16 (is_bf16 = 1) or f32 (0); mask
// [S, S] f32.  long_route = 0: the short routes, hd == 64 and 1 <= S <= 320
// (the wgmma core's scale is 1/sqrt(64)); long_route = 1: the three-pass
// kernel, any S >= 1 and hd a multiple of 64 (the wrapper's zero padding).
int dvl_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                  int BH, int S, int hd, int is_bf16, int long_route, float scale,
                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  if (long_route) {
    if (is_bf16)
      return (int)launch_long(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), mk, static_cast<bf16*>(out), BH, S,
                              hd, scale, st);
    return (int)launch_long(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), mk, static_cast<float*>(out), BH, S, hd,
                            scale, st);
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
