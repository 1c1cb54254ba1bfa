// Hand-written Hopper (sm_90a) attention kernel for the heads-first
// attention op, with a plain C interface bound from Python through ctypes
// (debias_vision_lang_torch/ops/attention.py::attention_pallas).
//
// Replaces the TPU Pallas kernel debias_vision_lang_tpu/ops/attention.py::
// _attention_pallas_padded (body _attn_kernel): out = softmax(q k^T * scale
// + mask) v over q, k, v [B*H, S, 64] and an additive f32 mask [S, S] read
// from memory (CLIP's causal mask holds -inf above the diagonal: those keys
// give exp = 0).  The numerics are the plain twin's, attention_kernel_math:
//   * bf16 inputs: bf16 products on the tensor cores (mma.sync m16n8k16)
//     with f32 accumulation; scores * scale + mask, the row max, exp and the
//     row sum in f32; probabilities normalised in f32 and rounded to bf16
//     BEFORE the PV product; output rounded to bf16 -- the rounding points
//     of the fused-block attention core (common.cuh), whose register-
//     resident score rows this kernel reuses.  A flash-style online softmax
//     would round elsewhere and is another function at bf16;
//   * f32 inputs: f32 FMAs on the CUDA cores, never TF32 (the twin is exact
//     f32 math, and TF32 keeps ~3 decimal digits).
// The TPU kernel's padding (S to 8/16, hd to 128 lanes, padded keys at -1e9)
// and its VMEM group budget are TPU devices and are not carried over: here
// ragged key tiles are zero-filled and masked at -inf.
//
// What bounds it on an H100: at the slice's shapes (S = 197 image, S = 77
// text, hd = 64) one (batch, head) slice is ~1.6 MFLOP per 64 query rows
// over K and V of <= 80 KB; the whole op is small against the projections
// around it, and latency-bound unless many blocks share each SM.  The f32
// variant keeps K and V of the slice in shared memory and each query row's
// scores in registers (<= 10 per lane); it is bound by shared-memory reads
// (one K or V load per FMA).  A simple, right kernel first; wgmma, TMA and a
// fused backward are later work.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: one block per (64 query rows, batch*head slice); each of the 4 warps
// owns 16 query rows and keeps their whole f32 score rows in mma.sync
// accumulator fragments (see common.cuh::attention_core_kernel).
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ mask,
                      bf16* __restrict__ out, int S, float scale) {
  constexpr int SP = NT * 8;
  constexpr int LDV = SP + 8;  // V^T row stride (keys)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + SP * LDH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * QT;
  const long long slice = (long long)blockIdx.y * S * HD;
  const bf16* qb = q + slice;
  const bf16* kb = k + slice;
  const bf16* vb = v + slice;

  // K rows (zero past S) by cp.async; V transposed through registers.
  for (int c = tid; c < SP * 8; c += ATT_THREADS) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const bool ok = r < S;
    cp_async16(Ks + r * LDH + cc, ok ? kb + r * HD + cc : kb, ok);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (ok) vv = *reinterpret_cast<const uint4*>(vb + r * HD + cc);
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(cc + i) * LDV + r] = ve[i];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = q0 + warp * 16;
  if (r0 >= S) return;
  const int row_lo = r0 + g, row_hi = r0 + g + 8;
  // rows past S compute on row S-1's mask and are never stored
  const float* mlo = mask + (long long)min(row_lo, S - 1) * S;
  const float* mhi = mask + (long long)min(row_hi, S - 1) * S;

  uint32_t qa[HD / 16][4];
  {
    const bf16* qlo = qb + (long long)min(row_lo, S - 1) * HD + 2 * t;
    const bf16* qhi = qb + (long long)min(row_hi, S - 1) * HD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = row_lo < S ? ld_u32(qlo + kk * 16) : 0u;
      qa[kk][1] = row_hi < S ? ld_u32(qhi + kk * 16) : 0u;
      qa[kk][2] = row_lo < S ? ld_u32(qlo + kk * 16 + 8) : 0u;
      qa[kk][3] = row_hi < S ? ld_u32(qhi + kk * 16 + 8) : 0u;
    }
  }

  // S = Q K^T: tile nt covers keys nt*8 .. nt*8+7; this thread holds keys
  // nt*8+2t, +1 of rows g (elements 0, 1) and g+8 (elements 2, 3).
  float sc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const bf16* kr = Ks + (nt * 8 + g) * LDH + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_16816(sc[nt], qa[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
  }

  // scores * scale + mask (no FMA contraction: the twin rounds the product),
  // keys past S at -inf; then the softmax over each whole row (a row is
  // spread over the 4 threads of a quad).
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

  // O = P V: PV step j uses score tiles 2j (a0, a1) and 2j+1 (a2, a3).
  float o[HD / 8][4];
#pragma unroll
  for (int on = 0; on < HD / 8; ++on) o[on][0] = o[on][1] = o[on][2] = o[on][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint32_t pa[4] = {
        pack_bf16(sc[2 * j][0] / s_lo, sc[2 * j][1] / s_lo),
        pack_bf16(sc[2 * j][2] / s_hi, sc[2 * j][3] / s_hi),
        pack_bf16(sc[2 * j + 1][0] / s_lo, sc[2 * j + 1][1] / s_lo),
        pack_bf16(sc[2 * j + 1][2] / s_hi, sc[2 * j + 1][3] / s_hi)};
#pragma unroll
    for (int on = 0; on < HD / 8; ++on) {
      const bf16* vr = Vt + (on * 8 + g) * LDV + j * 16 + 2 * t;
      mma_16816(o[on], pa, ld_u32(vr), ld_u32(vr + 8));
    }
  }

  bf16* ob = out + slice + 2 * t;
#pragma unroll
  for (int on = 0; on < HD / 8; ++on) {
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_lo * HD + on * 8) = pack_bf16(o[on][0], o[on][1]);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_hi * HD + on * 8) = pack_bf16(o[on][2], o[on][3]);
  }
}

template <int NT>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out,
                        int BH, int S, float scale, cudaStream_t st) {
  const size_t smem = attn_smem_bytes_sp(NT * 8);
  cudaError_t e = cudaFuncSetAttribute(attention_bf16_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + QT - 1) / QT, BH);
  attention_bf16_kernel<NT><<<grid, ATT_THREADS, smem, st>>>(q, k, v, mask, out, S, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one block per (64 query rows, batch*head slice), 8 warps, each warp
// one query row at a time.  K ([S][65], padded so that the 32 lanes reading
// 32 different keys hit 32 banks) and V ([S][64]) of the slice sit in shared
// memory; lane l scores keys l, l+32, ... (NC per lane) against the query
// row held in its registers, the warp reduces max and sum by shuffles, and
// lane l accumulates output dims l and l+32 over the keys, taking each
// probability from its owner by shuffle.
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int F32_QT = 64;
constexpr int LDK32 = HD + 1;

__host__ inline size_t f32_smem_bytes(int S) {
  return ((size_t)S * LDK32 + (size_t)S * HD) * sizeof(float);
}

template <int NC>
__global__ void __launch_bounds__(F32_THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + S * LDK32;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long slice = (long long)blockIdx.y * S * HD;
  const float* kb = k + slice;
  const float* vb = v + slice;
  for (int i = tid; i < S * HD; i += F32_THREADS) {
    Ks[(i / HD) * LDK32 + (i % HD)] = kb[i];
    Vs[i] = vb[i];
  }
  __syncthreads();

  const int row_end = min(S, (int)(blockIdx.x + 1) * F32_QT);
  for (int row = blockIdx.x * F32_QT + warp; row < row_end; row += F32_THREADS / 32) {
    const float* qr = q + slice + (long long)row * HD;
    float qv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qv[d] = qr[d];  // one broadcast line per warp
    const float* mr = mask + (long long)row * S;

    float sc[NC];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int key = c * 32 + lane;
      float acc = 0.f;
      if (key < S) {
        const float* kr = Ks + key * LDK32;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kr[d], acc);
      }
      sc[c] = key < S ? __fadd_rn(__fmul_rn(acc, scale), mr[key]) : -INFINITY;
      m = fmaxf(m, sc[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sc[c] = sc[c] == -INFINITY ? 0.f : expf(sc[c] - m);
      sum += sc[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < NC; ++c) sc[c] = sc[c] / sum;

    float o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int nk = min(32, S - c * 32);
      for (int j = 0; j < nk; ++j) {
        const float p = __shfl_sync(0xffffffffu, sc[c], j);
        const float* vr = Vs + (c * 32 + j) * HD;
        o0 = fmaf(p, vr[lane], o0);
        o1 = fmaf(p, vr[lane + 32], o1);
      }
    }
    float* orow = out + slice + (long long)row * HD;
    orow[lane] = o0;
    orow[lane + 32] = o1;
  }
}

template <int NC>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* mask,
                       float* out, int BH, int S, float scale, cudaStream_t st) {
  const size_t smem = f32_smem_bytes(S);
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel<NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + F32_QT - 1) / F32_QT, BH);
  attention_f32_kernel<NC><<<grid, F32_THREADS, smem, st>>>(q, k, v, mask, out, S, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = softmax(q k^T / sqrt(64) + mask) v; q, k, v, out [BH, S, 64]
// contiguous, bf16 (is_bf16 = 1) or f32 (0); mask [S, S] f32.  S <= 320.
int dvl_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                  int BH, int S, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)HD);
  const float* mk = static_cast<const float*>(mask);
  if (S < 1 || S > 320) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
               *vv = static_cast<const bf16*>(v);
    bf16* oo = static_cast<bf16*>(out);
    switch (attn_keys_bucket(S)) {
      case 32: return (int)launch_bf16<4>(qq, kk, vv, mk, oo, BH, S, scale, st);
      case 80: return (int)launch_bf16<10>(qq, kk, vv, mk, oo, BH, S, scale, st);
      case 208: return (int)launch_bf16<26>(qq, kk, vv, mk, oo, BH, S, scale, st);
      default: return (int)launch_bf16<40>(qq, kk, vv, mk, oo, BH, S, scale, st);
    }
  }
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  if (S <= 96) return (int)launch_f32<3>(qq, kk, vv, mk, oo, BH, S, scale, st);
  if (S <= 224) return (int)launch_f32<7>(qq, kk, vv, mk, oo, BH, S, scale, st);
  return (int)launch_f32<10>(qq, kk, vv, mk, oo, BH, S, scale, st);
}

}  // extern "C"
