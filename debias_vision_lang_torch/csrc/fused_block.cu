// Hand-written Hopper (sm_90a) kernels for the two fused transformer-block
// entry points of the ViT/text towers, with a plain C interface bound from
// Python through ctypes (debias_vision_lang_torch/ops/fused_block.py).
//
// Replaces the TPU Pallas kernels in debias_vision_lang_tpu/ops/fused_block.py:
//   dvl_attention_block  <- attention_block (_attn_block_kernel, and the
//                           bit-identical _attn_chains_kernel)
//   dvl_mlp_block        <- mlp_block (_mlp_block_kernel)
// and benchmarks/attn_variants.py:
//   dvl_attention_block_heads <- attention_block_hgrid (_attn_hgrid_kernel,
//                           KB (a) 6): K1 on a (batch, head) grid with
//                           per-head pre-scaled [D, 3 hd] blocks, exp2, and
//                           the out-projection accumulated in f32 across heads;
//   dvl_attention_block_opt <- attention_block_opt (_attn_opt_kernel, KB (a)
//                           5): K1's launches with q pre-scaled by hd^-0.5
//                           log2 e, exp2 (the core at scale ln 2) and the
//                           softmax normalised after P @ V, then K1's one
//                           out-projection over the concatenated heads.
// The same entry is a tensor-parallel slot's attention (a head group's q, k,
// v columns and wo rows, an f32 partial out), beside dvl_mlp_block_cols (a
// slot's MLP hidden columns) and dvl_tp_reduce (the row-parallel sum of the
// slots' partials, + bias + residual, rounded once): parallel/tensor.py.
//
// Numerics follow the TPU kernels' rounding points exactly (the plain twins
// in ops/fused_block.py are the specification): LayerNorm in f32, rounded to
// bf16; every product accumulated in f32; qkv, probabilities, per-head
// attention output and the MLP hidden rounded to bf16 where the TPU kernel
// rounds them; softmax normalised by the f32 row sum and rounded BEFORE the
// PV product (two passes over a whole score row, not an online softmax);
// residual adds in f32 with one final rounding.
//
// The Pallas grid of KB (a) 6 walks the heads in order and carries the
// projection in VMEM scratch; blocks here run in no order, so a head group
// is one launch of the same three stages as K1 on a slice: the QKV GEMM on
// the group's packed columns, the core on its heads, and the out GEMM whose
// K loop is the sum over the group's heads (f32 in the wgmma accumulators).
//
// What bounds them on an H100: at ViT-B/16 batch 256 the four projections
// (QKV, out, up, down: ~2.8 GFLOP per image per layer) are tensor-core work
// and take most of a layer; LayerNorm, bias, activation and residual are
// bandwidth work on the [B*S, D] activations; the attention core is bound by
// its qkv traffic.  The design (PERF.md has the measured split):
//   * one warp-specialised GEMM for the four projections: a 128x128 block
//     tile, K-step 64, a ring of 3 stages (96 KB of shared memory) that one
//     producer thread fills by TMA (128-byte swizzle, mbarrier completion),
//     two consumer warpgroups that run wgmma m64n128k16 (bf16 -> f32) on the
//     stages that have arrived and hand each stage back through a second
//     mbarrier; a producer of one warp, not a warpgroup, leaves the registers
//     to the consumers (setmaxnreg needs whole warpgroups), and two blocks
//     share an SM so that one block's epilogue overlaps the other's
//     products; the epilogue stages the f32 tile in the freed ring and
//     fuses bias, activation, residual and the bf16 rounding into coalesced
//     row stores, so no f32 intermediate reaches device memory.
//     The weights come in K-major ([N, K], a copy the wrapper keeps per
//     parameter version) so both operands are K-major; N a multiple of 128
//     and K of 64 on the padded operand layout the wrappers lay out for any
//     D, head dim and F (ops/fused_block.py::attn_plan / mlp_plan: zero
//     weights and biases in the padding, the out and down products storing
//     only the model's D columns); the ragged M edge is zero-filled by the
//     TMA and masked on store;
//   * the LayerNorm kernel of common.cuh (one warp per row, bf16 out);
//   * the wgmma attention core of attention_wgmma.cuh: one block per (head,
//     image), K and V loaded once by TMA, whole f32 score rows in wgmma
//     accumulators, P fed to an RS-wgmma from registers; past 320 keys
//     (Frozen-in-Time's joint tower: S = 785) the two-pass long route of
//     attention_long.cuh on the same packed qkv.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 on success).

#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = epilogue(A[M, K] @ Wt[N, K]^T); A, Wt, C bf16 row-major
// (Wt is the weight [K, N] stored K-major), f32 accumulation.
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_BIAS = 0,        // bf16(acc + bias)                         (qkv)
  EPI_BIAS_RESID = 1,  // bf16(resid + (acc + bias))               (out-proj)
  EPI_BIAS_QGELU = 2,  // bf16(quick_gelu(acc + bias))             (mlp up)
  EPI_BIAS_GELU = 3,   // bf16(erf_gelu(acc + bias)), A&S 7.1.26   (mlp up)
  EPI_RESID_BIAS = 4,  // bf16((resid + bias) + acc)               (mlp down)
  EPI_F32 = 5,         // f32 acc: a row-parallel slot's partial   (out, down)
};

constexpr int GBM = 128, GBN = 128, GBK = 64, GSTAGES = 3;
constexpr int G_A_BYTES = GBM * GBK * 2;  // 16 KB
constexpr int G_B_BYTES = GBN * GBK * 2;  // 16 KB
constexpr int GEMM_THREADS = 288;         // 2 consumer warpgroups + 1 producer warp
// Two blocks share an SM (97 KB of shared memory and at most 112 registers a
// thread), so one block's epilogue runs beside the other's products.
constexpr int GEMM_SMEM = GSTAGES * (G_A_BYTES + G_B_BYTES) + 1024 + 2 * GSTAGES * 8;
constexpr int GEPI_LD = GBN + 8;  // f32 row stride of the staged epilogue tile
static_assert(2 * 64 * GEPI_LD * 4 <= GSTAGES * (G_A_BYTES + G_B_BYTES), "staging fits the ring");

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias, float resid) {
  if (EPI == EPI_BIAS) return acc + bias;
  if (EPI == EPI_BIAS_RESID) return resid + (acc + bias);
  if (EPI == EPI_BIAS_QGELU) return quick_gelu(acc + bias);
  if (EPI == EPI_BIAS_GELU) return erf_gelu(acc + bias);
  return (resid + bias) + acc;  // EPI_RESID_BIAS
}

// RAGGED (the out and down products off the registry archs' widths): C and
// resid are [M, ldc] with the first ldc <= N columns stored (the padded
// operand layout's N edge: the weight's zero rows past ldc compute columns
// no one reads).  Otherwise C and resid are [M, N], every column stored.
template <int EPI, bool RAGGED>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                  const float* __restrict__ bias, const bf16* __restrict__ resid,
                  void* __restrict__ C, int M, int N, int K, int ldc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);                        // [stage][128][64]
  bf16* sB = reinterpret_cast<bf16*>(smem + GSTAGES * G_A_BYTES);  // [stage][128][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * (G_A_BYTES + G_B_BYTES));
  uint64_t* empty = full + GSTAGES;

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127;  // consumer warpgroup c
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int nk = K / GBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (c == 2) {  // the producer warp: one thread keeps the ring full
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % GSTAGES;
        mbar_wait(&empty[s], ((kt / GSTAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], G_A_BYTES + G_B_BYTES);
        tma_load_2d(sA + s * GBM * GBK, &tm_a, &full[s], kt * GBK, m0);
        tma_load_2d(sB + s * GBN * GBK, &tm_b, &full[s], kt * GBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c+63 of the tile, all columns
  float acc[GBN / 2];
#pragma unroll
  for (int i = 0; i < GBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % GSTAGES;
    mbar_wait(&full[s], (kt / GSTAGES) & 1);
    const uint64_t da = desc_sw128(sA + s * GBM * GBK + c * 64 * GBK);
    const uint64_t db = desc_sw128(sB + s * GBN * GBK);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) wgmma_ss<GBN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    fence_regs(acc);
    if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % GSTAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue.  Once both consumers are past their last product the ring is
  // free: each stages its 64 x 128 f32 half there (rows padded to 136
  // floats: a warp's float2 stores land in distinct banks), then each warp
  // finishes two rows at a time -- lane l takes columns 8(l % 16) .. +7 of
  // row 2i + l / 16, so the residual read and the bf16 store are 256
  // contiguous bytes per row -- applying bias, activation and residual in f32
  // with one rounding.  RAGGED: a lane whose 8 columns cross ldc, or rows
  // whose stride is not 16 bytes, go element by element.
  named_barrier(1, 256);
  float* stage = reinterpret_cast<float*>(smem) + c * 64 * GEPI_LD;
  {
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
    for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * half) * GEPI_LD + j * 8 + 2 * t) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
  named_barrier(2 + c, 128);
  const int col = (tid & 15) * 8, n = n0 + col;
  if (RAGGED && n >= ldc) return;
  const bool whole = !RAGGED || (n + 8 <= ldc && ldc % 8 == 0);
  const int ld = RAGGED ? ldc : N;
  float bb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (EPI != EPI_F32) {
    *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
  }
#pragma unroll 4
  for (int r = tid >> 4; r < 64; r += 8) {
    const long long m = (long long)m0 + c * 64 + r;
    if (m >= M) continue;
    float v[8], rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(stage + r * GEPI_LD + col);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(stage + r * GEPI_LD + col + 4);
    if (!whole) {  // the ragged N edge: element by element
      for (int i = 0; i < 8 && n + i < ldc; ++i) {
        if constexpr (EPI == EPI_F32) {
          static_cast<float*>(C)[m * ldc + n + i] = v[i];
        } else {
          const float ri = (EPI == EPI_BIAS_RESID || EPI == EPI_RESID_BIAS)
                               ? __bfloat162float(resid[m * ldc + n + i]) : 0.f;
          static_cast<bf16*>(C)[m * ldc + n + i] =
              __float2bfloat16_rn(epilogue<EPI>(v[i], bb[i], ri));
        }
      }
      continue;
    }
    if constexpr (EPI == EPI_F32) {
      float* out = static_cast<float*>(C) + m * ld + n;
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(v);
      *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(v + 4);
      continue;
    }
    if (EPI == EPI_BIAS_RESID || EPI == EPI_RESID_BIAS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(resid + m * ld + n);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(p[i]);
        rr[2 * i] = f2.x;
        rr[2 * i + 1] = f2.y;
      }
    }
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pw[i] = pack_bf16(epilogue<EPI>(v[2 * i], bb[2 * i], rr[2 * i]),
                        epilogue<EPI>(v[2 * i + 1], bb[2 * i + 1], rr[2 * i + 1]));
    *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + m * ld + n) = packed;
  }
}

template <int EPI, bool RAGGED>
cudaError_t launch_gemm_kernel(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const float* bias,
                               const bf16* resid, void* C, int M, int N, int K, int ldc,
                               cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_wgmma_kernel<EPI, RAGGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_wgmma_kernel<EPI, RAGGED><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(tm_a, tm_b, bias, resid,
                                                                       C, M, N, K, ldc);
  return cudaGetLastError();
}

// ldc = 0 or N: C and resid [M, N], every column stored; else (the out and
// down products and a slot's f32 partial only) [M, ldc], the first ldc
// columns stored.
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* Wt, const float* bias, const bf16* resid,
                        void* C, int M, int N, int K, cudaStream_t st, int ldc = 0) {
  constexpr bool MAY_RAG = EPI == EPI_BIAS_RESID || EPI == EPI_RESID_BIAS || EPI == EPI_F32;
  const bool ragged = ldc != 0 && ldc != N;
  if (M < 1 || N % GBN || K % GBK || K < GBK || (ragged && (!MAY_RAG || ldc > N ||
                                                             ldc <= N - GBN)))
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;  // both K-major: boxes of 64 K x 128 rows
  const uint64_t stride[1] = {(uint64_t)K * 2};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box_a[2] = {GBK, GBM}, box_b[2] = {GBK, GBN};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride, box_a);
  if (e != cudaSuccess) return e;
  e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride, box_b);
  if (e != cudaSuccess) return e;
  if constexpr (MAY_RAG) {
    if (ragged) return launch_gemm_kernel<EPI, true>(tm_a, tm_b, bias, resid, C, M, N, K, ldc, st);
  }
  return launch_gemm_kernel<EPI, false>(tm_a, tm_b, bias, resid, C, M, N, K, N, st);
}

// ---------------------------------------------------------------------------
// The tensor-parallel reduce: out[M, N] = bf16(resid + (sum_j part_j + bias))
// (the attention half, K1's out-projection order) or bf16((resid + bias) +
// sum_j part_j) (the MLP half, K2's down-projection order), the f32 partials
// summed in slot order.  One thread per 8 contiguous elements: a bandwidth
// pass over m partials, the residual and the output.  A launch takes up to
// TP_PARTS partials (their pointers ride in the kernel's parameter space, 2
// KB of its 4 KB).  N % 8 != 0 (a width off the registry's): element by
// element.
// ---------------------------------------------------------------------------

constexpr int TP_PARTS = 256;
struct TpParts {
  const float* p[TP_PARTS];
};

__device__ __forceinline__ float tp_out(float r, float b, float s, int bias_first) {
  return bias_first ? __fadd_rn(__fadd_rn(r, b), s) : __fadd_rn(r, __fadd_rn(s, b));
}

__global__ void __launch_bounds__(256)
tp_reduce_kernel(TpParts parts, int m, const float* __restrict__ bias,
                 const bf16* __restrict__ resid, bf16* __restrict__ out, long long total,
                 int N, int bias_first) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= total) return;
  if (N % 8) {  // ragged rows: element by element
    for (long long i = e; i < e + 8 && i < total; ++i) {
      float s = parts.p[0][i];
      for (int j = 1; j < m; ++j) s = __fadd_rn(s, parts.p[j][i]);
      out[i] = __float2bfloat16_rn(tp_out(__bfloat162float(resid[i]), bias[i % N], s,
                                          bias_first));
    }
    return;
  }
  const int n = (int)(e % N);
  float s[8];
  *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(parts.p[0] + e);
  *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(parts.p[0] + e + 4);
  for (int j = 1; j < m; ++j) {
    float v[8];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(parts.p[j] + e);
    *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(parts.p[j] + e + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(s[i], v[i]);
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(resid + e);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 packed;
  uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 r2 = __bfloat1622float2(rp[i]);
    pw[i] = pack_bf16(tp_out(r2.x, bias[n + 2 * i], s[2 * i], bias_first),
                      tp_out(r2.y, bias[n + 2 * i + 1], s[2 * i + 1], bias_first));
  }
  *reinterpret_cast<uint4*>(out + e) = packed;
}

// K1's launches with the core's score scale and normalisation order given,
// on the padded operand layout of ops/fused_block.py::attn_plan: xn [B*S,
// DK] (D rounded up to 64, zeros past D), qkv [B*S, NQKV] (q | k | v, heads
// x hdp columns each, hdp = the head dim rounded up to 64, zero lanes past
// it; NQKV = 3 heads hdp rounded up to 128), attn [B*S, heads hdp], and the
// out-projection's N rounded up to 128 with only D columns stored.  At D % 128
// == 0 and head dim 64 every width is the model's own.  The same launches
// serve a head group (heads = its g heads, group_plan's layout; DA = g hdp
// may be below D): out_f32 [B*S, D] (not null) receives the f32 partial
// attn_g @ wo_g and no bias or residual; else out = (x + bo) + attn @ wo when
// bias_first (KB (a) 6's order), x + (attn @ wo + bo) otherwise (K1's).
int attention_block_impl(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                         const void* bqkv, const void* wo, const void* bo, void* out, void* xn,
                         void* qkv, void* attn, int B, int S, int D, int heads, int hdp,
                         int causal, float scale, int norm_after, void* stream,
                         void* out_f32 = nullptr, int bias_first = 0) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, GBK), DA = heads * hdp, NQKV = round_up(3 * DA, GBN);
  const int NO = round_up(D, GBN);
  if (D < 1 || heads < 1 || hdp < 64 || hdp % 64) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_BIAS>(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv),
                            static_cast<const float*>(bqkv), nullptr, static_cast<bf16*>(qkv), M,
                            NQKV, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, heads,
                             hdp, causal, st, NQKV, scale, norm_after);
  if (e != cudaSuccess) return (int)e;
  const bf16 *a = static_cast<const bf16*>(attn), *w = static_cast<const bf16*>(wo);
  const float* fb = static_cast<const float*>(bo);
  const bf16* r = static_cast<const bf16*>(x);
  if (out_f32 != nullptr)
    e = launch_gemm<EPI_F32>(a, w, nullptr, nullptr, out_f32, M, NO, DA, st, D);
  else if (bias_first)
    e = launch_gemm<EPI_RESID_BIAS>(a, w, fb, r, out, M, NO, DA, st, D);
  else
    e = launch_gemm<EPI_BIAS_RESID>(a, w, fb, r, out, M, NO, DA, st, D);
  return (int)e;
}

}  // namespace

extern "C" {

// out = x + (MHA(LN(x)) @ wo + bo); x, out [B, S, D] bf16; the weights
// K-major bf16 in the padded layout of attention_block_impl: wqkv [NQKV,
// DK] and wo [D rounded up to 128, heads hdp] (the transposes of the
// parameters, zero rows and columns where the layout pads); ln_s, ln_b [D],
// bqkv [NQKV] and bo [D rounded up to 128] f32.  Scratch (bf16): xn [B*S,
// DK], qkv [B*S, NQKV], attn [B*S, heads hdp].  scale = hd^-0.5 of the true
// head dim; S >= 1 (the core's register route up to 320 keys at hdp <= 128,
// its long route otherwise).
int dvl_attention_block(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                        const void* bqkv, const void* wo, const void* bo, void* out, void* xn,
                        void* qkv, void* attn, int B, int S, int D, int heads, int hdp,
                        int causal, float scale, void* stream) {
  return attention_block_impl(x, ln_s, ln_b, wqkv, bqkv, wo, bo, out, xn, qkv, attn, B, S, D,
                              heads, hdp, causal, scale, 0, stream);
}

// KB (a) 5, attention_block_opt: dvl_attention_block's arguments and padded
// layout (no causal mask) with wqkv's q columns and bqkv's q entries
// pre-scaled by hd^-0.5 log2 e (prescale_qkv, on the true head dim): the
// core at scale ln 2 (exp(s ln 2 - m ln 2) is exp2(s - m) to f32 rounding),
// the unnormalised exponentials rounded to bf16 for P @ V and the f32 rows
// scaled by 1 / row sum after it.
int dvl_attention_block_opt(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                            const void* bqkv, const void* wo, const void* bo, void* out, void* xn,
                            void* qkv, void* attn, int B, int S, int D, int heads, int hdp,
                            void* stream) {
  return attention_block_impl(x, ln_s, ln_b, wqkv, bqkv, wo, bo, out, xn, qkv, attn, B, S, D,
                              heads, hdp, 0, logf(2.0f), 1, stream);
}

// out = x + b2 + act(LN(x) @ w1 + b1) @ w2; x, out [M, D] bf16; the weights
// K-major bf16 in the padded layout of ops/fused_block.py::mlp_plan: w1
// [Fp, DK] and w2 [D rounded up to 128, Fp] (the transposes of the
// parameters, zero past F and D; Fp = F rounded up to 128, DK = D rounded up
// to 64); ln_s, ln_b [D], b1 [Fp] and b2 [D rounded up to 128] f32, zeros
// past F and D.  Scratch (bf16): xn [M, DK], hidden [M, Fp] (act(0) = 0 in
// the padded lanes).  act_kind 0 = quick_gelu, 1 = erf gelu (A&S).
int dvl_mlp_block(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* out, void* xn,
                  void* hidden, int M, int D, int Fp, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, GBK);
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
  if (e != cudaSuccess) return (int)e;
  if (act_kind == 0)
    e = launch_gemm<EPI_BIAS_QGELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                    static_cast<const float*>(b1), nullptr,
                                    static_cast<bf16*>(hidden), M, Fp, DK, st);
  else
    e = launch_gemm<EPI_BIAS_GELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                   static_cast<const float*>(b1), nullptr,
                                   static_cast<bf16*>(hidden), M, Fp, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_RESID_BIAS>(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2),
                                  static_cast<const float*>(b2), static_cast<const bf16*>(x),
                                  static_cast<bf16*>(out), M, round_up(D, GBN), Fp, st, D);
  return (int)e;
}

// A head group's share of the attention block (attention_block_impl on the
// group's layout, ops/fused_block.py::group_plan): LN -> the group's QKV
// GEMM -> the core on its g heads -> the out GEMM over the group's wo rows.
// Given `out` (bf16), out = (x + bo) + attn_g @ wo_g (with g = heads and the
// hgrid scale, KB (a) 6's function); else out_f32 [M, D] = attn_g @ wo_g, a
// tensor-parallel slot's partial.  x [B, S, D] bf16; wqkv [NQKV, DK]
// K-major bf16: the group's q, k, v columns (g heads of hdp lanes each, zero
// past each head's hd), zero rows up to NQKV = 3 g hdp rounded up to 128;
// bqkv [NQKV] f32; wo [D rounded up to 128, g hdp] K-major bf16 (zero past
// D and in the padded lanes); bo [D rounded up to 128] f32.  Scratch (bf16):
// xn [B*S, DK], qkv [B*S, NQKV], attn [B*S, g hdp].  scale multiplies the
// scores (hd^-0.5 of the true head dim, or ln 2 on KB's pre-scaled q);
// norm_after normalises after P @ V (KB's order).
int dvl_attention_block_heads(const void* x, const void* ln_s, const void* ln_b,
                              const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                              void* out, void* out_f32, void* xn, void* qkv, void* attn, int B,
                              int S, int D, int g, int hdp, int causal, float scale,
                              int norm_after, void* stream) {
  if ((out == nullptr) == (out_f32 == nullptr)) return (int)cudaErrorInvalidValue;
  return attention_block_impl(x, ln_s, ln_b, wqkv, bqkv, wo, bo, out, xn, qkv, attn, B, S, D, g,
                              hdp, causal, scale, norm_after, stream, out_f32, 1);
}

// A tensor-parallel slot's MLP: out_f32 [M, D] = act(LN(x) @ w1_j + b1_j) @
// w2_j over the slot's hidden columns (no b2, no residual: dvl_tp_reduce
// adds them once), on mlp_plan's layout of the slot's Fj columns: w1 [Fp,
// DK] and w2 [D rounded up to 128, Fp] K-major bf16, b1 [Fp] f32, zero past
// Fj (Fp = Fj rounded up to 128) and past D.  Scratch (bf16): xn [M, DK],
// hidden [M, Fp].
int dvl_mlp_block_cols(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, void* out_f32, void* xn, void* hidden,
                       int M, int D, int Fp, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, GBK), NO = round_up(D, GBN);
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
  if (e != cudaSuccess) return (int)e;
  if (act_kind == 0)
    e = launch_gemm<EPI_BIAS_QGELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                    static_cast<const float*>(b1), nullptr, hidden, M, Fp, DK, st);
  else
    e = launch_gemm<EPI_BIAS_GELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                   static_cast<const float*>(b1), nullptr, hidden, M, Fp, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_F32>(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2), nullptr,
                           nullptr, out_f32, M, NO, Fp, st, D);
  return (int)e;
}

// out [M, N] bf16 from 1 <= m <= TP_PARTS f32 partials [M, N] (a host array
// of device pointers), bias [N] f32 and resid [M, N] bf16; bias_first picks
// the MLP half's order.
int dvl_tp_reduce(const void* const* parts, int m, const void* bias, const void* resid,
                  void* out, int M, int N, int bias_first, void* stream) {
  if (m < 1 || m > TP_PARTS || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  TpParts pp{};
  for (int j = 0; j < m; ++j) pp.p[j] = static_cast<const float*>(parts[j]);
  const long long total = (long long)M * N;
  const int threads = 256;
  tp_reduce_kernel<<<(unsigned)((total / 8 + threads) / threads), threads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      pp, m, static_cast<const float*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(out), total, N, bias_first);
  return (int)cudaGetLastError();
}

}  // extern "C"
