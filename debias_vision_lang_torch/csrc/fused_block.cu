// Hand-written Hopper (sm_90a) kernels for the two fused transformer-block
// entry points of the ViT/text towers, with a plain C interface bound from
// Python through ctypes (debias_vision_lang_torch/ops/fused_block.py).
//
// Replaces the TPU Pallas kernels in debias_vision_lang_tpu/ops/fused_block.py:
//   dvl_attention_block  <- attention_block (_attn_block_kernel, and the
//                           bit-identical _attn_chains_kernel)
//   dvl_mlp_block        <- mlp_block (_mlp_block_kernel)
//
// Numerics follow the TPU kernels' rounding points exactly (the plain twins
// in ops/fused_block.py are the specification): LayerNorm in f32, rounded to
// bf16; every product accumulated in f32; qkv, probabilities, per-head
// attention output and the MLP hidden rounded to bf16 where the TPU kernel
// rounds them; softmax normalised (divided by the f32 row sum) and rounded
// BEFORE the PV product (two passes over a whole score row, not an online
// softmax); residual adds in f32 with one final rounding.
//
// What bounds them on an H100: at ViT-B/16 batch 256 the four projections
// (QKV, out, up, down: ~2.8 GFLOP per image per layer) are tensor-core work
// and take ~80% of a layer; LayerNorm, bias, activation and residual are
// bandwidth work on the [B*S, D] activations; the attention core is small
// (S <= 320) and bound by latency unless many warps share each SM.  The
// design (PERF.md has the measured split):
//   * one tiled GEMM (128x128x32 block tile, 8 warps of 64x32, ldmatrix +
//     mma.sync m16n8k16 bf16 with f32 accumulators, a four-stage cp.async
//     ring) whose epilogue fuses bias, activation, residual and the bf16
//     rounding on the accumulator registers, so no f32 intermediate ever
//     reaches device memory;
//   * a LayerNorm kernel (one warp per row) that writes the bf16 LN output
//     the TPU kernel keeps in VMEM -- one bf16 round trip, same rounding;
//   * an attention-core kernel per (64 query rows, head, batch item): K and
//     V^T of the head in shared memory; each warp keeps the whole f32 score
//     rows of its 16 queries in mma.sync registers (so a 197x197 f32 tile
//     never has to fit anywhere), normalises them and feeds the bf16
//     probabilities to PV straight from registers.
// wgmma, TMA and a fused LN prologue are later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// LayerNorm: y = bf16(((x - mean) * rsqrt(var + eps)) * scale + bias), f32
// math, two-pass variance (as _ln_f32).  One warp per row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias,
                                  bf16* __restrict__ y, int rows, int d,
                                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + row * d);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(y + row * d);
  const int half = d >> 1;
  float s = 0.f;
  for (int i = lane; i < half; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / (float)d;
  float ss = 0.f;
  for (int i = lane; i < half; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float a = v.x - mean, b = v.y - mean;
    ss += a * a + b * b;
  }
  const float var = warp_sum(ss) / (float)d;
  const float inv = rsqrtf(var + eps);
  for (int i = lane; i < half; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float a = (v.x - mean) * inv * scale[2 * i] + bias[2 * i];
    float b = (v.y - mean) * inv * scale[2 * i + 1] + bias[2 * i + 1];
    yr[i] = __floats2bfloat162_rn(a, b);
  }
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = epilogue(A[M, K] @ W[K, N]); A, W, C bf16 row-major, f32
// accumulation.  K % 32 == 0 and N % 8 == 0 (checked by the wrapper); the
// ragged M and N edges are zero-filled on load and masked on store.
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_BIAS = 0,        // bf16(acc + bias)                         (qkv)
  EPI_BIAS_RESID = 1,  // bf16(resid + (acc + bias))               (out-proj)
  EPI_BIAS_QGELU = 2,  // bf16(quick_gelu(acc + bias))             (mlp up)
  EPI_BIAS_GELU = 3,   // bf16(erf_gelu(acc + bias)), A&S 7.1.26   (mlp up)
  EPI_RESID_BIAS = 4,  // bf16((resid + bias) + acc)               (mlp down)
};

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int LDA_S = BK + 8;   // 40 bf16 = 80 B rows: ldmatrix rows hit distinct banks
constexpr int LDB_S = BN + 8;   // 136 bf16 = 272 B rows
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int A_STAGE = BM * LDA_S;  // elements
constexpr int B_STAGE = BK * LDB_S;
constexpr int GEMM_SMEM = STAGES * (A_STAGE + B_STAGE) * 2;  // 75,776 B: 2 blocks/SM

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;  // src-size 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l % 16), column block (l / 16) of a 16x16 tile, so r = {a0..a3} of an
// m16n8k16 A operand, or (.trans, on a row-major [k][n] tile) the B operand
// pairs {b0, b1} of n-tiles n0 and n0 + 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quick_gelu(float h) {
  return h * (1.0f / (1.0f + expf(-1.702f * h)));
}

__device__ __forceinline__ float erf_gelu(float h) {
  // same Abramowitz & Stegun 7.1.26 polynomial as fused_block._erf_gelu
  const float x = h * 0.7071067811865476f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float sgn = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float erf = sgn * (1.0f - poly * expf(-ax * ax));
  return h * 0.5f * (1.0f + erf);
}

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias, float resid) {
  if (EPI == EPI_BIAS) return acc + bias;
  if (EPI == EPI_BIAS_RESID) return resid + (acc + bias);
  if (EPI == EPI_BIAS_QGELU) return quick_gelu(acc + bias);
  if (EPI == EPI_BIAS_GELU) return erf_gelu(acc + bias);
  return (resid + bias) + acc;  // EPI_RESID_BIAS
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const bf16* __restrict__ resid,
            bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2;  // 0..1 -> 64 rows each
  const int warp_n = warp & 3;   // 0..3 -> 32 cols each
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {  // 512 chunks
      const int r = c >> 2, cc = (c & 3) * 8;
      const long long gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(as + r * LDA_S + cc, ok ? A + gm * K + k0 + cc : A, ok);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += GEMM_THREADS) {  // 512 chunks
      const int r = c >> 4, cc = (c & 15) * 8;
      const int gn = n0 + cc;
      const bool ok = gn < N;
      cp_async16(bs + r * LDB_S + cc, ok ? W + (long long)(k0 + r) * N + gn : W, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // STAGES-deep cp.async ring: one commit group per K tile (empty groups at
  // the tail keep the count uniform, so wait_group<STAGES-2> = "tile kt in").
  const int nk = K / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible to all; stage (kt-1) % STAGES free
    const int pre = kt + STAGES - 1;
    if (pre < nk) load_tile(pre, pre % STAGES);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE + (warp_m * 64 + (lane & 15)) * LDA_S +
                     (lane >> 4) * 8;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE + (lane & 15) * LDB_S + warp_n * 32 +
                     (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldsm_x4(af[mt], as + mt * 16 * LDA_S + ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm_x4_t(bfr[np], bs + ks * LDB_S + np * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue on the accumulators: thread holds columns n, n+1 of rows g and
  // g + 8 of each 16x8 tile; one bf16 pair store each.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + warp_n * 32 + nt * 8 + 2 * t;
      if (n >= N) continue;
      const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (m >= M) continue;
        float2 rr = make_float2(0.f, 0.f);
        if (EPI == EPI_BIAS_RESID || EPI == EPI_RESID_BIAS)
          rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + m * N + n));
        *reinterpret_cast<uint32_t*>(C + m * N + n) =
            pack_bf16(epilogue<EPI>(acc[mt][nt][2 * half], bb.x, rr.x),
                      epilogue<EPI>(acc[mt][nt][2 * half + 1], bb.y, rr.y));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core over packed qkv [B*S, 3D] (q | k | v, head h at columns
// h*64 .. h*64+63 of each third) -> attn [B*S, D], per (64 query rows, head,
// batch item); each warp owns 16 query rows.  Scores f32 * scale (+ the
// causal mask generated here), row max, exp, divide by the f32 row sum,
// round to bf16, then P @ V in f32 and one rounding -- exactly the TPU
// kernel's per-head loop.  Scores, probabilities and the output live in
// registers as mma.sync m16n8k16 fragments: the accumulator layout of two
// neighbouring 8-key score tiles is the A-operand layout of one 16-key PV
// step, so the probabilities feed PV without touching shared memory, which
// holds only K [keys][64] and V^T [64][keys] (~58 KB at S = 197).
// ---------------------------------------------------------------------------

constexpr int HD = 64;
constexpr int QT = 64;           // query rows per block (4 warps x 16)
constexpr int LDH = HD + 8;      // K row stride: 72 bf16 = 144 B
constexpr int ATT_THREADS = 128;

__host__ __device__ constexpr int pad16(int s) { return (s + 15) & ~15; }

// Key count the kernel is compiled for (NT = keys / 8 score tiles per row).
__host__ inline int attn_keys_bucket(int s) {
  const int sp = pad16(s);
  return sp <= 32 ? 32 : sp <= 80 ? 80 : sp <= 208 ? 208 : 320;
}

__host__ __device__ inline size_t attn_smem_bytes_sp(int sp) {
  return (size_t)sp * LDH * 2 + (size_t)HD * (sp + 8) * 2;
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int NT>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ attn,
                      int S, int D, float scale, int causal) {
  constexpr int SP = NT * 8;
  constexpr int LDV = SP + 8;  // V^T row stride (keys)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + SP * LDH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + b * S * row3;

  // K rows (zero past S) by cp.async; V transposed through registers.
  for (int c = tid; c < SP * 8; c += ATT_THREADS) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const bool ok = r < S;
    cp_async16(Ks + r * LDH + cc, ok ? base + r * row3 + D + h * HD + cc : base, ok);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (ok) vv = *reinterpret_cast<const uint4*>(base + r * row3 + 2 * D + h * HD + cc);
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
  // the causal mask hides every key past this warp's last row
  const int key_end = causal ? min(S, r0 + 16) : S;

  // Q fragments straight from global memory (rows past S are zero).
  uint32_t qa[HD / 16][4];
  {
    const bf16* qlo = base + (long long)min(row_lo, S - 1) * row3 + h * HD + 2 * t;
    const bf16* qhi = base + (long long)min(row_hi, S - 1) * row3 + h * HD + 2 * t;
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
    if (nt * 8 < key_end) {
      const bf16* kr = Ks + (nt * 8 + g) * LDH + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(sc[nt], qa[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
    }
  }

  // Softmax over each whole row (a row is spread over the 4 threads of a quad).
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e;
      const bool in = col < S;
      sc[nt][e] = (in && (!causal || col <= row_lo)) ? sc[nt][e] * scale : -INFINITY;
      sc[nt][2 + e] = (in && (!causal || col <= row_hi)) ? sc[nt][2 + e] * scale : -INFINITY;
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
    if (j * 16 >= key_end) continue;
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

  bf16* out = attn + (b * S) * D + h * HD + 2 * t;
#pragma unroll
  for (int on = 0; on < HD / 8; ++on) {
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_lo * D + on * 8) = pack_bf16(o[on][0], o[on][1]);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_hi * D + on * 8) = pack_bf16(o[on][2], o[on][3]);
  }
}

template <int NT>
cudaError_t launch_attention_core(const bf16* qkv, bf16* attn, int B, int S, int D, int heads,
                                  int causal, cudaStream_t st) {
  const size_t smem = attn_smem_bytes_sp(NT * 8);
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + QT - 1) / QT, heads, B);
  attention_core_kernel<NT><<<grid, ATT_THREADS, smem, st>>>(
      qkv, attn, S, D, 1.0f / sqrtf((float)(D / heads)), causal);
  return cudaGetLastError();
}

cudaError_t launch_attention(const bf16* qkv, bf16* attn, int B, int S, int D, int heads,
                             int causal, cudaStream_t st) {
  switch (attn_keys_bucket(S)) {
    case 32: return launch_attention_core<4>(qkv, attn, B, S, D, heads, causal, st);
    case 80: return launch_attention_core<10>(qkv, attn, B, S, D, heads, causal, st);
    case 208: return launch_attention_core<26>(qkv, attn, B, S, D, heads, causal, st);
    default: return launch_attention_core<40>(qkv, attn, B, S, D, heads, causal, st);
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* resid,
                        bf16* C, int M, int N, int K, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(A, W, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_ln(const bf16* x, const float* s, const float* b, bf16* y, int rows, int d,
                      cudaStream_t st) {
  const int rows_per_block = 8;
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, st>>>(
      x, s, b, y, rows, d, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x + (MHA(LN(x)) @ wo + bo); x, out [B, S, D] bf16; wqkv [D, 3D],
// wo [D, D] bf16; ln_s, ln_b, bo [D] and bqkv [3D] f32.  Scratch (bf16):
// xn [B*S, D], qkv [B*S, 3D], attn [B*S, D].  D == heads * 64, S <= 320.
int dvl_attention_block(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                        const void* bqkv, const void* wo, const void* bo, void* out, void* xn,
                        void* qkv, void* attn, int B, int S, int D, int heads, int causal,
                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_BIAS>(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv),
                            static_cast<const float*>(bqkv), nullptr, static_cast<bf16*>(qkv), M,
                            3 * D, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, D, heads,
                       causal, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_BIAS_RESID>(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo),
                                  static_cast<const float*>(bo), static_cast<const bf16*>(x),
                                  static_cast<bf16*>(out), M, D, D, st);
  return (int)e;
}

// out = x + b2 + act(LN(x) @ w1 + b1) @ w2; x, out [M, D] bf16; w1 [D, F],
// w2 [F, D] bf16; ln_s, ln_b, b2 [D] and b1 [F] f32.  Scratch (bf16):
// xn [M, D], hidden [M, F].  act_kind 0 = quick_gelu, 1 = erf gelu (A&S).
int dvl_mlp_block(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* out, void* xn,
                  void* hidden, int M, int D, int F, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st);
  if (e != cudaSuccess) return (int)e;
  if (act_kind == 0)
    e = launch_gemm<EPI_BIAS_QGELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                    static_cast<const float*>(b1), nullptr,
                                    static_cast<bf16*>(hidden), M, F, D, st);
  else
    e = launch_gemm<EPI_BIAS_GELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                   static_cast<const float*>(b1), nullptr,
                                   static_cast<bf16*>(hidden), M, F, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_RESID_BIAS>(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2),
                                  static_cast<const float*>(b2), static_cast<const bf16*>(x),
                                  static_cast<bf16*>(out), M, D, F, st);
  return (int)e;
}


}  // extern "C"
