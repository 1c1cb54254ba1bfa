// Hand-written Hopper (sm_90a) kernels for the two int8 fused transformer-
// block entry points of the ViT/text towers, with a plain C interface bound
// from Python through ctypes (debias_vision_lang_torch/ops/fused_block_q.py).
//
// Replaces the TPU Pallas kernels in debias_vision_lang_tpu/ops/fused_block_q.py:
//   dvl_attention_block_q  <- attention_block_q (_attn_q_kernel, and the
//                             bit-identical _attn_q_chains_kernel)
//   dvl_mlp_block_q        <- mlp_block_q (_mlp_q_kernel, and the chain
//                             variant _mlp_q_pipe_kernel); k F-chunks when
//                             fb < F (KB (a) 7 below)
// and their tensor-parallel shares (parallel/tensor.py): a slot's head group
// (dvl_attention_block_q_heads) or hidden columns (dvl_mlp_block_q_cols) up
// to the row amax of its slice of the row-parallel input; the slots' amaxes
// maxed, that input quantized with the row's global scale and multiplied
// into a raw int32 partial (dvl_rows_q_partial); the partials summed exactly
// and dequantized once (dvl_tp_reduce_q).  The codes are the unsharded
// block's (the same global row scale) and the int32 sum is the unsharded K
// loop's, so a tensor-parallel block is bit-equal to K3 / K4.
//
// And the int8 kernel experiments of benchmarks/ (KB (a) 1-4), each K3's or
// K4's launch sequence with one change (attention_block_q_impl /
// mlp_block_q_impl):
//   dvl_attention_block_qq     <- attn_int8_cores.py::attention_block_qq
//                                 (_attn_qq_kernel): qkv kept f32 (the
//                                 EQ_BIAS_F32 epilogue) into the int8 core
//                                 of attention_qq.cuh (dvl_attention_qq_core
//                                 alone): Q K^T and P V on s8 wgmma;
//   dvl_mlp_block_q_kb         <- q_mlp_bf16h.py::tower (pipe_kernel, bf16h):
//                                 bf16(deq + b1) (EQ_BIAS) with quick_gelu in
//                                 the hidden's quantize pass (2 bytes read a
//                                 value, not 4); q_kernel_variants.py::
//                                 make_mlp_var (mlp_q_kernel_var): the
//                                 reciprocal quantizer, the bf16 quick_gelu in
//                                 EQ_BIAS_QGELU_BF16;
//   dvl_attention_block_q_var  <- q_kernel_variants.py::make_attn_var
//                                 (attn_q_kernel_var, both packings): the
//                                 reciprocal quantizer, the wgmma core at
//                                 1/8 on exp dividing by the row sum after P V;
//   dvl_mlp_block_q, k > 1     <- mlp_block_q with fb < F (_mlp_q_kernel over
//                                 F tiles) and q_ilp.py::make_fsplit(k)
//                                 (mlp_fsplit_kernel, KB (a) 7): each F-chunk
//                                 of the hidden quantized with its own row
//                                 scales, the down product folding each
//                                 chunk's int32 sum into an f32 sum
//                                 (EQ_RESID_BIAS_CHUNK);
//   dvl_fused_layer_q          <- q_layer_fused.py::tower (layer_kernel, every
//                                 mode): K3 then K4 with the attention half's
//                                 x + proj kept f32 (EQ_BIAS_RESID_Y) and added
//                                 by the down product (EQ_RESID32_BIAS);
//   dvl_attention_block_q_postdiv <- q_ilp4.py::make_call (the head-pair
//                                 packed kernel): K3's quantizer, the row sum
//                                 divided out after P V as AQ_VAR's core.
// And the two blocks of benchmarks/q_attribution.py (KB (c)), which time a
// block with one side of it stubbed out, in K3's / K4's launch sequences:
//   dvl_attention_block_q_attr_mxu <- make_attn("mxu") (attn_kernel): the
//                                 products only: x's static int8 cast
//                                 (cast_s8_kernel), the QKV GEMM, the wgmma
//                                 core with its softmax off (NORM_OFF), the
//                                 attention rows' saturating cast in the
//                                 quantize pass's slot, the out GEMM;
//   dvl_attention_block_q_attr_vpu <- make_attn("vpu"): the elementwise
//                                 chain only: K3's LayerNorm and quantize
//                                 passes, each product a broadcast of the
//                                 row's first code (bcast_rows_kernel), the
//                                 core a softmax over broadcast scores
//                                 (attention_vpu_core_kernel);
//   dvl_mlp_block_q_kb, MQ_ATTR_MXU <- make_mlp("mxu") (mlp_kernel): the
//                                 static cast, the up GEMM writing the int8
//                                 hidden itself (EQ_BIAS_S8: no f32 hidden),
//                                 the down GEMM;
//   dvl_mlp_block_q_kb, MQ_ATTR_VPU <- make_mlp("vpu"): K4's LayerNorm and
//                                 quantize passes, the products broadcasts
//                                 (quick_gelu in the up one's epilogue).
// The casts are XLA's float-to-int8 conversion (s8_trunc: toward zero,
// saturated, NaN to 0), never quant_rows's rounding.
//
// Numerics are the TPU kernels' (the plain twins in ops/fused_block_q.py are
// the specification):
//   * per-row dynamic int8 (_quant_rows): scale = max(amax / 127, 1e-8) over
//     the WHOLE row -- D for the LN output, D across all heads for the
//     attention output, F for the MLP hidden -- and q = clip(rint(x / scale),
//     -127, 127): IEEE division, round half to even;
//   * int8 x int8 -> int32 products (exact), dequantized as
//     (acc * row_scale) * channel_scale, then the bias; every epilogue step is
//     written with __fmul_rn / __fadd_rn so nvcc cannot contract it into an
//     FMA that the twin does not do (the MLP hidden is quantized from these
//     f32 values, so their last bit can move a code);
//   * the LN output and qkv rounded to bf16, the attention core computes
//     K1's function (bf16 in, f32 softmax normalised before PV, bf16 out), the
//     MLP hidden stays f32 until it is quantized, residual adds in f32 with
//     one final rounding.
//
// What bounds them on an H100: the four products (~2.8 GOP per image per
// layer at ViT-B/16) are tensor-core work at up to 1,979 TOP/s dense int8;
// LayerNorm, the four quantize passes, the attention core's qkv traffic and
// the f32 MLP hidden (B*S x F x 4 bytes: 620 MB at B=256, written once by the
// up-projection and read once by its quantize pass) are bandwidth work.  The
// design (PERF.md has the measured split):
//   * all four products run one TMA-fed, warp-specialised s8 wgmma GEMM, the
//     bf16 GEMM of csrc/fused_block.cu in 8-bit operands: a 128x128 block
//     tile, a K step of 128 int8 (128 B: the same 16 KB per operand tile and
//     the same 128-byte swizzle), a 3-stage ring filled by one producer warp,
//     two consumer warpgroups on wgmma m64n128k32 s8 with s32 accumulators,
//     two blocks per SM.  8-bit wgmma takes K-major operands only, which
//     both are: the activations [M, K] and the weight copy transposed to
//     [out, in] that the caller keeps.  The epilogue stages the s32 tile in
//     the freed ring and dequantizes, adds the bias and applies the
//     activation (f32 hidden), or adds the residual (bf16 out), or neither
//     (bf16 qkv), on coalesced rows, in the operation order above.  N a
//     multiple of 128 and K of 16 on the padded operand layout of
//     ops/fused_block.py::attn_plan / mlp_plan (any D, head dim, F and
//     F-split: zero weights, scales and biases in the padding, the out and
//     down products storing only the model's D columns); the TMA zero-fills
//     the ragged M edge and a K past the last 128;
//   * the attention block's core is the wgmma core of attention_wgmma.cuh
//     that K1 runs, on the same packed [B*S, 3D] qkv: each head's K and V
//     loaded once by TMA, whole f32 score rows in wgmma accumulators, P fed
//     to an RS-wgmma from registers (it scales by the reciprocal of the f32
//     row sum where the twin divides: at most one f32 ulp before the bf16
//     rounding); past 320 keys (the int8 joint Frozen-in-Time tower, S =
//     785) the two-pass long route of attention_long.cuh on the same qkv;
//   * a quantize pass, one block per row with the row in registers: amax,
//     scale and codes from a single read; past 4,096 values a row (ViT-H/14's
//     F = 5,120) two reads of it, the amax then the codes;
//   * the LayerNorm kernel of common.cuh.
// Quantizing inside the GEMMs (an epilogue taking the row amax, a producer
// quantizing on load) and fusing LN with the quantize pass are later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "attention_qq.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Per-row int8 quantization: q [rows, n] int8 and scale [rows] f32 from x
// [rows, n] (bf16 or f32).  One block per row; each thread holds PER values.
// ---------------------------------------------------------------------------

constexpr int QR_THREADS = 128;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// RECIP (KB (a) 3 / 4's _quant_rows_recip): code = rint(x * inv) with inv =
// 1 / scale, one IEEE reciprocal per row and a rounded product, in place of
// the IEEE division per element.  QGELU (KB (a) 2): the row is quick_gelu of
// the (bf16) input, applied here after the load, and written to act_out as
// f32 when act_out is not null.
template <typename T, int PER, bool RECIP, bool QGELU>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                  float* __restrict__ act_out, int n) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    v[j] = i < n ? to_f32(xr[i]) : 0.f;
    if constexpr (QGELU) {
      if (i < n) {
        v[j] = quick_gelu(v[j]);
        if (act_out) act_out[row * n + i] = v[j];
      }
    }
    amax = fmaxf(amax, fabsf(v[j]));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  const float inv = __frcp_rn(s);
  int8_t* qr = q + row * n;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    const float y = RECIP ? __fmul_rn(v[j], inv) : __fdiv_rn(v[j], s);
    if (i < n) qr[i] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(y), -127.f), 127.f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

// Rows wider than the registers hold (QR_WIDE: ViT-H/14's F = 5,120,
// bigG/14's 8,192): the same scale and codes from two passes over the row,
// the amax, then the codes from a second read (L1 / L2-resident: one row is
// at most a few tens of KB); QGELU applies the activation on both reads.
constexpr int QR_WIDE = 32 * QR_THREADS;

template <typename T, bool RECIP, bool QGELU>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_wide_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                       float* __restrict__ act_out, int n) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += QR_THREADS) {
    float v = to_f32(xr[i]);
    if constexpr (QGELU) {
      v = quick_gelu(v);
      if (act_out) act_out[row * n + i] = v;
    }
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  const float inv = __frcp_rn(s);
  int8_t* qr = q + row * n;
  for (int i = threadIdx.x; i < n; i += QR_THREADS) {
    float v = to_f32(xr[i]);
    if constexpr (QGELU) v = quick_gelu(v);
    const float y = RECIP ? __fmul_rn(v, inv) : __fdiv_rn(v, s);
    qr[i] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(y), -127.f), 127.f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <bool RECIP, bool QGELU, typename T>
cudaError_t launch_quant_rows_mode(const T* x, int8_t* q, float* scale, float* act_out, int rows,
                                   int n, cudaStream_t st) {
  if (n <= 8 * QR_THREADS)
    quant_rows_kernel<T, 8, RECIP, QGELU><<<rows, QR_THREADS, 0, st>>>(x, q, scale, act_out, n);
  else if (n <= QR_WIDE)
    quant_rows_kernel<T, 32, RECIP, QGELU><<<rows, QR_THREADS, 0, st>>>(x, q, scale, act_out, n);
  else
    quant_rows_wide_kernel<T, RECIP, QGELU><<<rows, QR_THREADS, 0, st>>>(x, q, scale, act_out, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant_rows(const T* x, int8_t* q, float* scale, int rows, int n,
                              cudaStream_t st) {
  return launch_quant_rows_mode<false, false>(x, q, scale, nullptr, rows, n, st);
}

// XLA's float-to-int8 conversion (ops/fused_block_q.py::to_s8_sat): toward
// zero, clamped to [lo, 127], NaN to 0.  lo = -128 is the saturating cast;
// lo = -127 with v = x 16 is the "mxu" bodies' int8(clip(x 16, -127, 127)).
__device__ __forceinline__ uint32_t s8_trunc(float v, int lo) {
  return v != v ? 0u : (uint32_t)(uint8_t)(int8_t)max(lo, min(127, __float2int_rz(v)));
}

// The attribution's "mxu" casts of a bf16 row set [rows, n] (n % 8 == 0) to
// int8, 8 values a thread: STATIC16 x's codes s8_trunc(x 16, -127) with the
// row scale 1/16, else the attention rows' s8_trunc(a, -128) with the row
// scale 1; the thread of a row's first 8 columns writes its scale.
template <bool STATIC16>
__global__ void __launch_bounds__(256)
cast_s8_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
               long long total8, int n) {
  const long long i8 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i8 >= total8) return;
  const long long e = i8 * 8;
  const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    const float v[2] = {f.x, f.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = 2 * i + k;
      const uint32_t code = STATIC16 ? s8_trunc(__fmul_rn(v[k], 16.0f), -127) : s8_trunc(v[k], -128);
      w[c >> 2] |= code << (8 * (c & 3));
    }
  }
  *reinterpret_cast<uint2*>(q + e) = make_uint2(w[0], w[1]);
  if (e % n == 0) scale[e / n] = STATIC16 ? 0.0625f : 1.0f;
}

// The same casts of x [rows, n] into q [rows, ldq], ldq >= n (the padded
// operand layout's K edge), zero codes past n; one value a thread.
template <bool STATIC16>
__global__ void __launch_bounds__(256)
cast_s8_ragged_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scale, long long total, int n, int ldq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / ldq;
  const int c = (int)(i % ldq);
  uint32_t code = 0u;
  if (c < n) {
    const float v = __bfloat162float(x[r * n + c]);
    code = STATIC16 ? s8_trunc(__fmul_rn(v, 16.0f), -127) : s8_trunc(v, -128);
  }
  q[i] = (int8_t)(uint8_t)code;
  if (c == 0) scale[r] = STATIC16 ? 0.0625f : 1.0f;
}

template <bool STATIC16>
cudaError_t launch_cast_s8(const bf16* x, int8_t* q, float* scale, int rows, int n,
                           cudaStream_t st, int ldq = 0) {
  if (ldq == 0) ldq = n;
  if (ldq < n) return cudaErrorInvalidValue;
  if (n % 8 || ldq != n) {
    const long long total = (long long)rows * ldq;
    cast_s8_ragged_kernel<STATIC16><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        x, q, scale, total, n, ldq);
    return cudaGetLastError();
  }
  const long long total8 = (long long)rows * n / 8;
  cast_s8_kernel<STATIC16><<<(unsigned)((total8 + 255) / 256), 256, 0, st>>>(x, q, scale, total8,
                                                                            n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// s8 wgmma GEMM (all four products): C[M, N] = epilogue(A[M, K] @ Wt[N,
// K]^T), A and Wt int8 row-major (both K-major), s32 accumulation.  The bf16
// GEMM of fused_block.cu with a K step of 128 int8.
// ---------------------------------------------------------------------------

enum EpilogueQ {
  EQ_BIAS = 0,        // bf16(deq + bias)                           (qkv)
  EQ_BIAS_RESID = 1,  // bf16(resid + (deq + bias))                 (out-proj)
  EQ_BIAS_QGELU = 2,  // f32 quick_gelu(deq + bias)                 (mlp up)
  EQ_BIAS_GELU = 3,   // f32 erf_gelu_rn(deq + bias), A&S 7.1.26    (mlp up)
  EQ_RESID_BIAS = 4,  // bf16((resid + bias) + deq)                 (mlp down)
  EQ_I32 = 5,         // int32 acc: a row-parallel slot's partial   (out, down)
  EQ_BIAS_F32 = 6,    // f32 deq + bias                             (KB (a) 1's qkv)
  EQ_BIAS_QGELU_BF16 = 7,  // f32 quick_gelu_bf16(deq + bias)       (KB (a) 3's mlp up)
  EQ_BIAS_RESID_Y = 8,     // f32 y = resid + (deq + bias), bf16(y) to C2 (the layer's out-proj)
  EQ_RESID32_BIAS = 9,     // bf16((resid32 + bias) + deq), resid f32 (the layer's mlp down)
  EQ_RESID_BIAS_CHUNK = 10,  // bf16((resid + bias) + sum_c deq_c)     (mlp down, F-split)
  EQ_BIAS_S8 = 11,     // int8 s8_trunc(deq + bias, -128), row scale 1 to C2 (the "mxu" mlp up)
};                    // deq = (acc * row_scale) * channel_scale
// KB (a) 2's bf16 pre-activation bf16(deq + b1) is EQ_BIAS's output.
// EQ_RESID_BIAS_CHUNK: the K loop is cut into chunks of chunk_steps K steps
// (the hidden's F-chunks, each quantized with its own row scales);
// deq_c = (acc_c * row_scale[m, c]) * channel_scale, acc_c the chunk's
// exact int32 sum, and the chunks' deq_c are summed in f32 in chunk order.
// EQ_BIAS_S8: the blocks of column tile 0 write each row's scale, 1, to C2
// [M] f32, so the down GEMM reads the codes and their scales as K4's.

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// mlp_q_kernel_var's bf16 quick_gelu as XLA evaluates it (the twin
// quick_gelu_bf16): hb = bf16(h); hb / bf16(1 + bf16(exp(bf16(bf16(-1.702)
// hb)))), the last division in f32.
__device__ __forceinline__ float quick_gelu_bf16(float h) {
  const float hb = bf16_round(h);
  const float e = bf16_round(expf(bf16_round(__fmul_rn(-1.703125f, hb))));
  return __fdiv_rn(hb, bf16_round(__fadd_rn(1.0f, e)));
}

// The A&S 7.1.26 erf gelu of common.cuh with every operation rounded on its
// own, in the order the twin's torch ops evaluate it.
__device__ __forceinline__ float erf_gelu_rn(float h) {
  const float x = __fmul_rn(h, 0.7071067811865476f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(ax, 0.3275911f)));
  float poly = __fadd_rn(__fmul_rn(t, 1.061405429f), -1.453152027f);
  poly = __fadd_rn(__fmul_rn(t, poly), 1.421413741f);
  poly = __fadd_rn(__fmul_rn(t, poly), -0.284496736f);
  poly = __fadd_rn(__fmul_rn(t, poly), 0.254829592f);
  poly = __fmul_rn(t, poly);
  const float sgn = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float erf = __fmul_rn(sgn, __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))));
  return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.0f, erf));
}

constexpr int SBM = 128, SBN = 128, SBK = 128, SSTAGES = 3;  // SBK in int8 (= bytes)
constexpr int S_TILE = SBM * SBK;                            // 16 KB per operand tile
constexpr int SGEMM_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int SGEMM_SMEM = SSTAGES * 2 * S_TILE + 1024 + 2 * SSTAGES * 8;
constexpr int SEPI_LD = SBN + 8;  // s32 row stride of the staged epilogue tile
static_assert(2 * 64 * SEPI_LD * 4 <= SSTAGES * 2 * S_TILE, "staging fits the ring");

// The chunked mode holds an f32 sum beside the int32 accumulators (64 more
// registers a thread), so it runs one block per SM, the others two.
// RAGGED (the out and down products off the registry archs' widths: bf16,
// the layer's f32 y and residual, a slot's int32 partial): C (C2) and resid
// are [M, ldc], the first ldc <= N columns stored (the padded layout's N
// edge); otherwise [M, N].
template <int EPI, bool RAGGED>
__global__ void __launch_bounds__(SGEMM_THREADS, EPI == EQ_RESID_BIAS_CHUNK ? 1 : 2)
gemm_s8_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const void* __restrict__ resid,
               void* __restrict__ C, void* __restrict__ C2, int M, int N, int K,
               int chunk_steps, int ldc) {
  constexpr bool CHUNK = EPI == EQ_RESID_BIAS_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem);                     // [stage][128][128]
  int8_t* sB = reinterpret_cast<int8_t*>(smem + SSTAGES * S_TILE);  // [stage][128][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SSTAGES * 2 * S_TILE);
  uint64_t* empty = full + SSTAGES;

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127;  // consumer warpgroup c
  const int n0 = blockIdx.x * SBN, m0 = blockIdx.y * SBM;
  const int nk = (K + SBK - 1) / SBK;  // a ragged last K step arrives zero-filled
  if (threadIdx.x == 0) {
    for (int s = 0; s < SSTAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (c == 2) {  // the producer warp: one thread keeps the ring full
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % SSTAGES;
        mbar_wait(&empty[s], ((kt / SSTAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S_TILE);
        tma_load_2d(sA + s * S_TILE, &tm_a, &full[s], kt * SBK, m0);
        tma_load_2d(sB + s * S_TILE, &tm_b, &full[s], kt * SBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c+63 of the tile, all columns
  int acc[SBN / 2];
  float facc[CHUNK ? SBN / 2 : 1];  // CHUNK: the f32 sum of the finished chunks
#pragma unroll
  for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
  if constexpr (CHUNK) {
#pragma unroll
    for (int i = 0; i < SBN / 2; ++i) facc[i] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % SSTAGES;
    mbar_wait(&full[s], (kt / SSTAGES) & 1);
    const uint64_t da = desc_sw128(sA + s * S_TILE + c * 64 * SBK);
    const uint64_t db = desc_sw128(sB + s * S_TILE);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    fence_regs(acc);
    if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % SSTAGES]);
    if constexpr (CHUNK) {
      if ((kt + 1) % chunk_steps == 0) {
        // the chunk's last products: wait for them, fold the exact int32
        // chunk sum into the f32 sum as (acc * row scale of this chunk) *
        // channel scale, and start the next chunk from zero.  The ring is
        // not touched: the producer keeps loading the next chunk's stages.
        wgmma_wait<0>();
        fence_regs(acc);
        const int chunk = kt / chunk_steps, nchunks = nk / chunk_steps;
        const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
        const long long r0 = (long long)m0 + c * 64 + warp * 16 + g;
        const float gs0 = r0 < M ? a_scale[r0 * nchunks + chunk] : 0.f;
        const float gs1 = r0 + 8 < M ? a_scale[(r0 + 8) * nchunks + chunk] : 0.f;
#pragma unroll
        for (int j = 0; j < SBN / 8; ++j) {
          const float2 ws = *reinterpret_cast<const float2*>(w_scale + n0 + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a = 4 * j + i;
            const float p = __fmul_rn(__fmul_rn(__int2float_rn(acc[a]), (i & 2) ? gs1 : gs0),
                                      (i & 1) ? ws.y : ws.x);
            facc[a] = __fadd_rn(facc[a], p);
            acc[a] = 0;
          }
        }
        fence_regs(acc);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue.  Once both consumers are past their last product the ring is
  // free: each stages its 64 x 128 s32 half there (rows padded to 136), then
  // each warp finishes two rows at a time -- lane l takes columns 8(l % 16)
  // .. +7 of row 2i + l / 16 -- dequantizing and applying bias, activation
  // and residual in the twin's operation order, with coalesced row stores
  // (32 B of f32 hidden or 16 B of bf16 output a lane).
  named_barrier(1, 256);
  int* stage = reinterpret_cast<int*>(smem) + c * 64 * SEPI_LD;
  {
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        int2* dst = reinterpret_cast<int2*>(stage + (warp * 16 + g + 8 * half) * SEPI_LD + j * 8 +
                                            2 * t);
        if constexpr (CHUNK)
          *dst = make_int2(__float_as_int(facc[i]), __float_as_int(facc[i + 1]));
        else
          *dst = make_int2(acc[i], acc[i + 1]);
      }
  }
  named_barrier(2 + c, 128);
  const int col = (tid & 15) * 8, n = n0 + col;
  if (RAGGED && n >= ldc) return;
  // the padded layout's ragged N edge: element by element
  const bool whole = !RAGGED || (n + 8 <= ldc && ldc % 8 == 0);
  const int ld = RAGGED ? ldc : N;
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (EPI != EQ_I32) {
    *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(w_scale + n);
    *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(w_scale + n + 4);
    *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
  }
#pragma unroll 2
  for (int r = tid >> 4; r < 64; r += 8) {
    const long long m = (long long)m0 + c * 64 + r;
    if (m >= M) continue;
    int a[8];
    *reinterpret_cast<int4*>(a) = *reinterpret_cast<const int4*>(stage + r * SEPI_LD + col);
    *reinterpret_cast<int4*>(a + 4) = *reinterpret_cast<const int4*>(stage + r * SEPI_LD + col + 4);
    if constexpr (EPI == EQ_BIAS_RESID || EPI == EQ_RESID_BIAS || CHUNK || EPI == EQ_I32 ||
                  EPI == EQ_BIAS_RESID_Y || EPI == EQ_RESID32_BIAS) {
      if (!whole) {
        const float rs = (CHUNK || EPI == EQ_I32) ? 0.f : a_scale[m];
        for (int i = 0; i < 8 && n + i < ldc; ++i) {
          const long long at = m * ldc + n + i;
          if constexpr (EPI == EQ_I32) {
            static_cast<int*>(C)[at] = a[i];
            continue;
          }
          const float d = CHUNK ? __int_as_float(a[i])
                                : __fmul_rn(__fmul_rn(__int2float_rn(a[i]), rs), cs[i]);
          const float r = EPI == EQ_RESID32_BIAS
                              ? static_cast<const float*>(resid)[at]
                              : __bfloat162float(static_cast<const bf16*>(resid)[at]);
          const float o = (EPI == EQ_BIAS_RESID || EPI == EQ_BIAS_RESID_Y)
                              ? __fadd_rn(r, __fadd_rn(d, bb[i]))
                              : __fadd_rn(__fadd_rn(r, bb[i]), d);
          if constexpr (EPI == EQ_BIAS_RESID_Y) {
            static_cast<float*>(C)[at] = o;
            static_cast<bf16*>(C2)[at] = __float2bfloat16_rn(o);
          } else {
            static_cast<bf16*>(C)[at] = __float2bfloat16_rn(o);
          }
        }
        continue;
      }
    }
    if constexpr (EPI == EQ_I32) {
      int* out = static_cast<int*>(C) + m * ld + n;
      *reinterpret_cast<int4*>(out) = *reinterpret_cast<const int4*>(a);
      *reinterpret_cast<int4*>(out + 4) = *reinterpret_cast<const int4*>(a + 4);
      continue;
    }
    float d[8];
    if constexpr (CHUNK) {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = __int_as_float(a[i]);  // the chunks' f32 sum
    } else {
      const float rs = a_scale[m];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = __fmul_rn(__fmul_rn(__int2float_rn(a[i]), rs), cs[i]);
    }
    if constexpr (EPI == EQ_BIAS_S8) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i >> 2] |= s8_trunc(__fadd_rn(d[i], bb[i]), -128) << (8 * (i & 3));
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(C) + m * N + n) = make_uint2(w[0], w[1]);
      if (n == 0) static_cast<float*>(C2)[m] = 1.0f;
    } else if constexpr (EPI == EQ_BIAS_QGELU || EPI == EQ_BIAS_GELU || EPI == EQ_BIAS_F32 ||
                         EPI == EQ_BIAS_QGELU_BF16) {
      float hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pre = __fadd_rn(d[i], bb[i]);
        if constexpr (EPI == EQ_BIAS_QGELU) hv[i] = quick_gelu(pre);
        else if constexpr (EPI == EQ_BIAS_GELU) hv[i] = erf_gelu_rn(pre);
        else if constexpr (EPI == EQ_BIAS_QGELU_BF16) hv[i] = quick_gelu_bf16(pre);
        else hv[i] = pre;
      }
      float* out = static_cast<float*>(C) + m * N + n;
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(hv);
      *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(hv + 4);
    } else {
      float rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if constexpr (EPI == EQ_RESID32_BIAS) {
        const float* r32 = static_cast<const float*>(resid) + m * ld + n;
        *reinterpret_cast<float4*>(rr) = *reinterpret_cast<const float4*>(r32);
        *reinterpret_cast<float4*>(rr + 4) = *reinterpret_cast<const float4*>(r32 + 4);
      } else if constexpr (EPI != EQ_BIAS) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(static_cast<const bf16*>(resid) + m * ld + n);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f2 = __bfloat1622float2(p[i]);
          rr[2 * i] = f2.x;
          rr[2 * i + 1] = f2.y;
        }
      }
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (EPI == EQ_BIAS)
          o[i] = __fadd_rn(d[i], bb[i]);
        else if constexpr (EPI == EQ_BIAS_RESID || EPI == EQ_BIAS_RESID_Y)
          o[i] = __fadd_rn(rr[i], __fadd_rn(d[i], bb[i]));
        else  // EQ_RESID_BIAS, EQ_RESID32_BIAS, EQ_RESID_BIAS_CHUNK
          o[i] = __fadd_rn(__fadd_rn(rr[i], bb[i]), d[i]);
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) pw[i] = pack_bf16(o[2 * i], o[2 * i + 1]);
      if constexpr (EPI == EQ_BIAS_RESID_Y) {  // f32 y to C, its bf16 rounding to C2
        float* out = static_cast<float*>(C) + m * ld + n;
        *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(o);
        *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(o + 4);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(C2) + m * ld + n) = packed;
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + m * ld + n) = packed;
      }
    }
  }
}

// EQ_BIAS_RESID_Y writes its bf16 copy to C2, EQ_BIAS_S8 its row scales;
// EQ_RESID_BIAS_CHUNK takes
// a_scale [M, K / (128 chunk_steps)] (a row's scale per chunk) and K a
// multiple of 128 chunk_steps.  ldc (the out and down products and the int32
// partial only): C and resid are [M, ldc], columns ldc .. N-1 (the weight's
// zero rows of the padded layout) not stored; 0 or N: [M, N].
template <int EPI, bool RAGGED>
cudaError_t launch_gemm_s8_kernel(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                                  const float* a_scale, const float* w_scale, const float* bias,
                                  const void* resid, void* C, void* C2, int M, int N, int K,
                                  int chunk_steps, int ldc, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_s8_kernel<EPI, RAGGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SGEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(N / SBN, (M + SBM - 1) / SBM);
  gemm_s8_kernel<EPI, RAGGED><<<grid, SGEMM_THREADS, SGEMM_SMEM, st>>>(
      tm_a, tm_b, a_scale, w_scale, bias, resid, C, C2, M, N, K, chunk_steps, ldc);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm_s8(const int8_t* A, const float* a_scale, const int8_t* Wt,
                           const float* w_scale, const float* bias, const void* resid, void* C,
                           int M, int N, int K, cudaStream_t st, void* C2 = nullptr,
                           int chunk_steps = 0, int ldc = 0) {
  constexpr bool MAY_RAG = EPI == EQ_BIAS_RESID || EPI == EQ_RESID_BIAS ||
                           EPI == EQ_RESID_BIAS_CHUNK || EPI == EQ_I32 ||
                           EPI == EQ_BIAS_RESID_Y || EPI == EQ_RESID32_BIAS;
  const bool ragged = ldc != 0 && ldc != N;
  if (ragged && (!MAY_RAG || ldc > N || ldc <= N - SBN)) return cudaErrorInvalidValue;
  // K % 16: the TMA's 16-byte row stride; a K past the last 128 zero-fills
  if (M < 1 || N % SBN || K % 16 || K < 16) return cudaErrorInvalidValue;
  if (EPI == EQ_RESID_BIAS_CHUNK && (chunk_steps < 1 || K % (SBK * chunk_steps)))
    return cudaErrorInvalidValue;
  if ((EPI == EQ_BIAS_RESID_Y || EPI == EQ_BIAS_S8) && C2 == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;  // both K-major: boxes of 128 K x 128 rows
  const uint64_t stride[1] = {(uint64_t)K};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box[2] = {SBK, SBM};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return e;
  e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return e;
  if constexpr (MAY_RAG) {
    if (ragged)
      return launch_gemm_s8_kernel<EPI, true>(tm_a, tm_b, a_scale, w_scale, bias, resid, C, C2, M,
                                              N, K, chunk_steps, ldc, st);
  }
  return launch_gemm_s8_kernel<EPI, false>(tm_a, tm_b, a_scale, w_scale, bias, resid, C, C2, M, N,
                                           K, chunk_steps, N, st);
}

// ---------------------------------------------------------------------------
// The tensor-parallel pieces: a row's amax over one slot's slice, the codes
// of that slice at the row's global scale, and the exact int32 reduce.
// ---------------------------------------------------------------------------

constexpr int TP_PARTS = 256;  // slots one launch takes (2 KB of the 4 KB parameter space)
struct TpPtrs {
  const void* p[TP_PARTS];
};

template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
row_amax_kernel(const T* __restrict__ x, float* __restrict__ amax, int n) {
  __shared__ float red[QR_THREADS / 32];
  const T* xr = x + (long long)blockIdx.x * n;
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += QR_THREADS) a = fmaxf(a, fabsf(to_f32(xr[i])));
  a = warp_max(a);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < QR_THREADS / 32; ++w) a = fmaxf(a, red[w]);
    amax[blockIdx.x] = fmaxf(red[0], a);
  }
}

template <typename T>
cudaError_t launch_row_amax(const T* x, float* amax, int rows, int n, cudaStream_t st) {
  row_amax_kernel<T><<<rows, QR_THREADS, 0, st>>>(x, amax, n);
  return cudaGetLastError();
}

// q, scale from x [rows, n] at amax = max over the m slots' row amaxes:
// quant_rows_kernel's scale and codes, the row's amax given.
template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_given_amax_kernel(const T* __restrict__ x, TpPtrs amaxes, int m,
                             int8_t* __restrict__ q, float* __restrict__ scale, int n) {
  const long long row = blockIdx.x;
  float amax = static_cast<const float*>(amaxes.p[0])[row];
  for (int j = 1; j < m; ++j) amax = fmaxf(amax, static_cast<const float*>(amaxes.p[j])[row]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  const T* xr = x + row * n;
  int8_t* qr = q + row * n;
  for (int i = threadIdx.x; i < n; i += QR_THREADS)
    qr[i] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(to_f32(xr[i]), s)), -127.f), 127.f));
  if (threadIdx.x == 0) scale[row] = s;
}

__device__ __forceinline__ float tp_out_q(int acc, float rs, float ws, float b, float r,
                                          int bias_first) {
  const float d = __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), ws);
  return bias_first ? __fadd_rn(__fadd_rn(r, b), d) : __fadd_rn(r, __fadd_rn(d, b));
}

// out = resid + (deq + bias) (attention) or (resid + bias) + deq (MLP), deq
// = (sum_j part_j * row scale) * channel scale, the int32 sum exact: the
// out-projection epilogues of gemm_s8_kernel, operation for operation.
// N % 8 != 0: element by element.
__global__ void __launch_bounds__(256)
tp_reduce_q_kernel(TpPtrs parts, int m, const float* __restrict__ a_scale,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   const bf16* __restrict__ resid, bf16* __restrict__ out, long long total,
                   int N, int bias_first) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= total) return;
  if (N % 8) {
    for (long long i = e; i < e + 8 && i < total; ++i) {
      int acc = static_cast<const int*>(parts.p[0])[i];
      for (int j = 1; j < m; ++j) acc += static_cast<const int*>(parts.p[j])[i];
      const int n = (int)(i % N);
      out[i] = __float2bfloat16_rn(tp_out_q(acc, a_scale[i / N], w_scale[n], bias[n],
                                            __bfloat162float(resid[i]), bias_first));
    }
    return;
  }
  const int n = (int)(e % N);
  const float rs = a_scale[e / N];
  int acc[8];
  *reinterpret_cast<int4*>(acc) = *reinterpret_cast<const int4*>(static_cast<const int*>(parts.p[0]) + e);
  *reinterpret_cast<int4*>(acc + 4) =
      *reinterpret_cast<const int4*>(static_cast<const int*>(parts.p[0]) + e + 4);
  for (int j = 1; j < m; ++j) {
    int v[8];
    *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(static_cast<const int*>(parts.p[j]) + e);
    *reinterpret_cast<int4*>(v + 4) =
        *reinterpret_cast<const int4*>(static_cast<const int*>(parts.p[j]) + e + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += v[i];
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(resid + e);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 r2 = __bfloat1622float2(rp[i]);
    const float rr[2] = {r2.x, r2.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = 2 * i + k;
      o[c] = tp_out_q(acc[c], rs, w_scale[n + c], bias[n + c], rr[k], bias_first);
    }
  }
  uint4 packed;
  uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = pack_bf16(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(out + e) = packed;
}

// ---------------------------------------------------------------------------
// The attribution's "vpu" stubs (benchmarks/q_attribution.py): each stands
// in for a product, or for the attention core's products, and does the
// elementwise work of the stubbed shape, as the TPU body's broadcasts do.
// ---------------------------------------------------------------------------

// d = codes[m, 0] * rs[m] (the row's first code: codes [M, K] row-major),
// the same for every column n of the row, then the GEMM epilogue EPI's
// bias, activation and residual in its operation order: EQ_BIAS bf16
// (qkv), EQ_BIAS_QGELU f32 (the MLP hidden), EQ_RESID_BIAS bf16 (the MLP
// output), EQ_BIAS_RESID bf16 (the attention output).  8 columns a thread;
// N % 8 == 0.
// A column n with n % chunk >= valid (the padded lanes of the MLP hidden,
// mlp_plan's layout) is written 0, as its zero weights would make it.
template <int EPI>
__device__ __forceinline__ float bcast_one(float d, float b, float r) {
  if constexpr (EPI == EQ_BIAS_QGELU) return quick_gelu(__fadd_rn(d, b));
  else if constexpr (EPI == EQ_BIAS) return __fadd_rn(d, b);
  else if constexpr (EPI == EQ_BIAS_RESID) return __fadd_rn(r, __fadd_rn(d, b));
  else return __fadd_rn(__fadd_rn(r, b), d);  // EQ_RESID_BIAS
}

template <int EPI>
__global__ void __launch_bounds__(256)
bcast_rows_ragged_kernel(const int8_t* __restrict__ codes, const float* __restrict__ rs, int K,
                         const float* __restrict__ bias, const bf16* __restrict__ resid,
                         void* __restrict__ out, long long total, int N, int chunk, int valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long m = i / N;
  const int n = (int)(i % N);
  const float d = __fmul_rn((float)codes[m * K], rs[m]);
  const float r = (EPI == EQ_BIAS_RESID || EPI == EQ_RESID_BIAS) ? __bfloat162float(resid[i]) : 0.f;
  const float v = n % chunk < valid ? bcast_one<EPI>(d, bias[n], r) : 0.f;
  if constexpr (EPI == EQ_BIAS_QGELU) static_cast<float*>(out)[i] = v;
  else static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
}

template <int EPI>
__global__ void __launch_bounds__(256)
bcast_rows_kernel(const int8_t* __restrict__ codes, const float* __restrict__ rs, int K,
                  const float* __restrict__ bias, const bf16* __restrict__ resid,
                  void* __restrict__ out, long long total8, int N) {
  const long long i8 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i8 >= total8) return;
  const long long e = i8 * 8, m = e / N;
  const int n = (int)(e % N);
  const float d = __fmul_rn((float)codes[m * K], rs[m]);
  float bb[8];
  *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
  *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
  if constexpr (EPI == EQ_BIAS_QGELU) {
    float hv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) hv[i] = quick_gelu(__fadd_rn(d, bb[i]));
    float* o = static_cast<float*>(out) + e;
    *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(hv);
    *reinterpret_cast<float4*>(o + 4) = *reinterpret_cast<const float4*>(hv + 4);
  } else {
    float rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (EPI != EQ_BIAS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(resid + e);
      const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(rp[i]);
        rr[2 * i] = f2.x;
        rr[2 * i + 1] = f2.y;
      }
    }
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (EPI == EQ_BIAS)
        o[i] = __fadd_rn(d, bb[i]);
      else if constexpr (EPI == EQ_BIAS_RESID)
        o[i] = __fadd_rn(rr[i], __fadd_rn(d, bb[i]));
      else  // EQ_RESID_BIAS
        o[i] = __fadd_rn(__fadd_rn(rr[i], bb[i]), d);
    }
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) pw[i] = pack_bf16(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + e) = packed;
  }
}

// chunk / valid: the columns past `valid` of every `chunk` are written 0
// (0: every column holds its value).
template <int EPI>
cudaError_t launch_bcast_rows(const int8_t* codes, const float* rs, int K, const float* bias,
                              const void* resid, void* out, int M, int N, cudaStream_t st,
                              int chunk = 0, int valid = 0) {
  if (N % 8 || (chunk != 0 && valid < chunk)) {
    const long long total = (long long)M * N;
    bcast_rows_ragged_kernel<EPI><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        codes, rs, K, bias, static_cast<const bf16*>(resid), out, total, N,
        chunk == 0 ? N : chunk, chunk == 0 ? N : valid);
    return cudaGetLastError();
  }
  const long long total8 = (long long)M * N / 8;
  bcast_rows_kernel<EPI><<<(unsigned)((total8 + 255) / 256), 256, 0, st>>>(
      codes, rs, K, bias, static_cast<const bf16*>(resid), out, total8, N);
  return cudaGetLastError();
}

// The "vpu" attention core: one block per (head, image), one warp per query
// row i at a time, the row's keys strided over the lanes.  Every one of the
// S scores is q[i, 0] * scale -- the head's first q element, made a value
// of its own at each key (an empty asm), since the TPU body materialises the
// broadcast score row and the stub exists to time the work on it -- then
// K3's softmax of the row: the max, an exp per score (kept in shared memory,
// S floats a warp), the f32 sum, an IEEE division per score and its bf16
// rounding.  The head's output row is p[i, 0] in its hd columns, 0 in the
// padded lanes up to hdp (the packed layout of attention_block_q_impl: qkv
// rows ld apart, head h at column h hdp, attn rows da apart).
constexpr int VPU_CORE_WARPS = 4;

__global__ void __launch_bounds__(VPU_CORE_WARPS * 32)
attention_vpu_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ attn, int S, int ld,
                          int da, int hd, int hdp, float scale) {
  extern __shared__ float ex[];
  const int h = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* e = ex + warp * S;
  for (int i = warp; i < S; i += VPU_CORE_WARPS) {
    const long long row = (long long)blockIdx.y * S + i;
    const float q = __bfloat162float(qkv[row * ld + h * hdp]);
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      float sc = __fmul_rn(q, scale);
      asm volatile("" : "+f"(sc));
      e[j] = sc;
      m = fmaxf(m, sc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float x = expf(e[j] - m);
      e[j] = x;
      l += x;
    }
    l = warp_sum(l);
    float p0 = 0.f;
    for (int j = lane; j < S; j += 32) {
      const bf16 p = __float2bfloat16_rn(__fdiv_rn(e[j], l));
      asm volatile("" ::"h"(__bfloat16_as_ushort(p)));  // every p is computed
      if (j == 0) p0 = __bfloat162float(p);
    }
    p0 = __shfl_sync(0xffffffffu, p0, 0);
    for (int c = 2 * lane; c < hdp; c += 64)
      *reinterpret_cast<uint32_t*>(attn + row * da + h * hdp + c) =
          pack_bf16(c < hd ? p0 : 0.f, c + 1 < hd ? p0 : 0.f);
  }
}

cudaError_t launch_attention_vpu_core(const bf16* qkv, bf16* attn, int B, int S, int heads, int hd,
                                      int hdp, int ld, float scale, cudaStream_t st) {
  if (S < 1 || hd < 1 || hdp < hd || hdp % 64 || ld < 3 * heads * hdp) return cudaErrorInvalidValue;
  const size_t smem = (size_t)VPU_CORE_WARPS * S * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_vpu_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attention_vpu_core_kernel<<<dim3(heads, B), VPU_CORE_WARPS * 32, smem, st>>>(
      qkv, attn, S, ld, heads * hdp, hd, hdp, scale);
  return cudaGetLastError();
}

// The attention block's variants: K3, KB (a) 1 (qq), KB (a) 4 (var), the
// head-pair packed kernel of benchmarks/q_ilp4.py (postdiv) and the
// attribution's two stubbed blocks (attr_mxu, attr_vpu).
enum AttnQVariant {
  AQ_K3 = 0, AQ_QQ = 1, AQ_VAR = 2, AQ_POSTDIV = 3, AQ_ATTR_MXU = 4, AQ_ATTR_VPU = 5
};

// out = x + (deq(q(attn) @ wo_q) + bo), attn = MHA over
// bf16(deq(q(bf16(LN(x))) @ wqkv_q) + bqkv), on the padded operand layout of
// ops/fused_block.py::attn_plan (csrc/fused_block.cu's attention_block_impl
// in int8), every variant: x, out [B, S, D] bf16; xn, xq [B*S, DK] (D
// rounded up to 64, zeros past D: the same amax, the same codes), wqkv_t
// [NQKV, DK] int8 with sqkv and bqkv [NQKV] f32 (zero past each head's hd of
// hdp lanes, and past 3 heads hdp up to NQKV, a multiple of 128), qkv [B*S,
// NQKV] bf16 (AQ_QQ: f32), attn and aq [B*S, heads hdp] (the padded lanes
// are P @ 0 = 0: the same amax, the same codes), wo_t [D rounded up to 128,
// heads hdp] int8 with so and bo zero past D; ln_s, ln_b [D] f32; xs, ascale
// [B*S] f32.  `scale` is the true head dim's hd^-0.5 (hd = D / heads).  At
// D % 128 == 0 and head dim 64 every width is the model's own.  S >= 1 (the
// core's whole score rows up to 320 keys, its long route past).
// AQ_QQ: qkv kept f32 (EQ_BIAS_F32) into the int8 core of attention_qq.cuh
// (qq_ws: its workspace, qq_ws_bytes, on both of its routes).
// AQ_VAR: the reciprocal quantizer on x and attn, the wgmma core dividing by
// the row sum after P V (norm_after = 2).  AQ_POSTDIV: K3's quantizer and
// AQ_VAR's core.  AQ_ATTR_MXU: x's static cast in place of LayerNorm and
// its quantize pass (xn not written, xs = 1/16), the core with its softmax
// off, the attention rows' saturating cast in place of their quantize pass
// (ascale = 1).  AQ_ATTR_VPU: K3's LayerNorm and quantize passes, the
// products and the core's products broadcasts (bcast_rows_kernel,
// attention_vpu_core_kernel).  None of these takes the causal mask.
// y32 (K3 only), if not null: the out-projection writes f32 y = x + (deq +
// bo) [B*S, D] there and bf16(y) to out (EQ_BIAS_RESID_Y: K3's output, and
// the residual kept f32 for the layer's MLP half).
int attention_block_q_impl(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                           const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                           const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                           void* attn, void* aq, void* ascale, int B, int S, int D, int heads,
                           int hdp, float scale, int causal, int variant, void* stream,
                           void* y32 = nullptr, void* qq_ws = nullptr) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, 64), DA = heads * hdp, NQKV = round_up(3 * DA, SBN);
  const int NO = round_up(D, SBN);
  if (variant != AQ_K3 && (causal || y32 != nullptr)) return (int)cudaErrorInvalidValue;
  if (D < 1 || heads < 1 || D % heads || hdp < 64 || hdp % 64 || DA < D)
    return (int)cudaErrorInvalidValue;
  const bool recip = variant == AQ_VAR, mxu = variant == AQ_ATTR_MXU, vpu = variant == AQ_ATTR_VPU;
  cudaError_t e;
  if (mxu) {
    e = launch_cast_s8<true>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                             static_cast<float*>(xs), M, D, st, DK);
  } else {
    e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
    if (e != cudaSuccess) return (int)e;
    e = recip ? launch_quant_rows_mode<true, false>(static_cast<const bf16*>(xn),
                                                    static_cast<int8_t*>(xq),
                                                    static_cast<float*>(xs), nullptr, M, DK, st)
              : launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                                  static_cast<float*>(xs), M, DK, st);
  }
  if (e != cudaSuccess) return (int)e;
  if (vpu) {
    e = launch_bcast_rows<EQ_BIAS>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                                   DK, static_cast<const float*>(bqkv), nullptr, qkv, M, NQKV, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_attention_vpu_core(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S,
                                  heads, D / heads, hdp, NQKV, scale, st);
  } else if (variant == AQ_QQ) {
    e = launch_gemm_s8<EQ_BIAS_F32>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                                    static_cast<const int8_t*>(wqkv_t),
                                    static_cast<const float*>(sqkv),
                                    static_cast<const float*>(bqkv), nullptr, qkv, M, NQKV, DK,
                                    st);
    if (e != cudaSuccess) return (int)e;
    e = launch_attention_qq(static_cast<const float*>(qkv), static_cast<bf16*>(attn), nullptr,
                            nullptr, nullptr, qq_ws, B, S, heads, hdp, NQKV, scale, st);
  } else {
    e = launch_gemm_s8<EQ_BIAS>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                                static_cast<const int8_t*>(wqkv_t),
                                static_cast<const float*>(sqkv), static_cast<const float*>(bqkv),
                                nullptr, qkv, M, NQKV, DK, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S,
                               heads, hdp, causal, st, NQKV, scale,
                               variant == AQ_K3 ? 0 : mxu ? NORM_OFF : 2);
  }
  if (e != cudaSuccess) return (int)e;
  if (mxu)
    e = launch_cast_s8<false>(static_cast<const bf16*>(attn), static_cast<int8_t*>(aq),
                              static_cast<float*>(ascale), M, DA, st);
  else if (recip)
    e = launch_quant_rows_mode<true, false>(static_cast<const bf16*>(attn),
                                            static_cast<int8_t*>(aq),
                                            static_cast<float*>(ascale), nullptr, M, DA, st);
  else
    e = launch_quant_rows(static_cast<const bf16*>(attn), static_cast<int8_t*>(aq),
                          static_cast<float*>(ascale), M, DA, st);
  if (e != cudaSuccess) return (int)e;
  if (vpu)
    e = launch_bcast_rows<EQ_BIAS_RESID>(static_cast<const int8_t*>(aq),
                                         static_cast<const float*>(ascale), DA,
                                         static_cast<const float*>(bo), x, out, M, D, st);
  else if (y32 != nullptr)
    e = launch_gemm_s8<EQ_BIAS_RESID_Y>(static_cast<const int8_t*>(aq),
                                        static_cast<const float*>(ascale),
                                        static_cast<const int8_t*>(wo_t),
                                        static_cast<const float*>(so),
                                        static_cast<const float*>(bo), x, y32, M, NO, DA, st, out,
                                        0, D);
  else
    e = launch_gemm_s8<EQ_BIAS_RESID>(static_cast<const int8_t*>(aq),
                                      static_cast<const float*>(ascale),
                                      static_cast<const int8_t*>(wo_t),
                                      static_cast<const float*>(so), static_cast<const float*>(bo),
                                      x, out, M, NO, DA, st, nullptr, 0, D);
  return (int)e;
}

// The MLP block's variants: K4, KB (a) 2 (bf16h), KB (a) 3 (var, with or
// without the bf16 quick_gelu) and the attribution's two stubbed blocks.
enum MlpQVariant {
  MQ_K4 = 0, MQ_BF16H = 1, MQ_VAR = 2, MQ_VAR_BF16_GELU = 3, MQ_ATTR_MXU = 4, MQ_ATTR_VPU = 5
};

// out = (x + b2) + deq(q(h) @ w2_q), h = act(deq(q(bf16(LN(x))) @ w1_q) + b1)
// in f32.  x, out [M, D] bf16; w1_t [F, D], w2_t [D, F] int8 (transposed);
// s1, b1 [F], s2, b2, ln_s, ln_b [D] f32.  Scratch: xn [M, D] bf16, xq
// [M, D] int8, xs [M] f32, h [M, F] f32, hq [M, F] int8, hs [M] f32.
// act_kind 0 = quick_gelu, 1 = erf gelu (A&S); the padded layout's widths
// below for every variant.
// MQ_BF16H: h [M, F] bf16 holds bf16(deq + b1) (EQ_BIAS) and the hidden's
// quantize pass applies quick_gelu (g, if not null, [M, F] f32 receives
// it).  MQ_VAR / MQ_VAR_BF16_GELU: the reciprocal quantizer on x and h,
// quick_gelu in f32 (EQ_BIAS_QGELU) or bf16 (EQ_BIAS_QGELU_BF16).
// MQ_ATTR_MXU: x's static cast in place of LayerNorm and its quantize pass
// (xn not written, xs = 1/16), the up GEMM writing hq itself with hs = 1
// (EQ_BIAS_S8; h is not written and may be null), K4's down GEMM.
// MQ_ATTR_VPU: K4's LayerNorm and quantize passes, the products broadcasts
// (bcast_rows_kernel: quick_gelu in the up one, h f32).  These five run
// quick_gelu only.
// K4 only: k > 1 splits F into k chunks of F / k (a multiple of 128) as the
// TPU kernel's F-split does: each row of each chunk quantized on its own
// (the quantize pass over the [M k, F / k] view of h; hs [M, k]), and the
// down product's K loop folding each chunk's int32 sum into an f32 sum with
// that chunk's row scales (EQ_RESID_BIAS_CHUNK).  resid32, if not null, is
// the f32 residual [M, D] the down product adds in place of x (the layer's
// y; x then is bf16(y), LayerNorm's input); k == 1 with it.
// Every variant runs any D and F on the padded operand layout of
// ops/fused_block.py::mlp_plan: F here is the padded hidden width, each of
// the k chunks of the model's F / k hidden columns rounded up to 128 with
// zero columns of w1_t (rows of [F, DK]), s1 and b1 (gelu(0) = 0: the same
// amax, the same codes) and zero columns of w2_t [D rounded up to 128, F];
// xn, xq [M, DK] (D rounded up to 64, zeros past D); s2, b2 zero past D.
// fv: the model's hidden width (k == 1; the "vpu" broadcast writes 0 past
// it, where the zero weights would).
int mlp_block_q_impl(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                     const void* s1, const void* b1, const void* w2_t, const void* s2,
                     const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                     void* hs, void* g, int M, int D, int F, int act_kind, int variant,
                     void* stream, int k = 1, const float* resid32 = nullptr, int fv = 0) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, 64), NO = round_up(D, SBN);
  if (variant != MQ_K4 && act_kind != 0) return (int)cudaErrorInvalidValue;
  if (k < 1 || F % k || (F / k) % SBK) return (int)cudaErrorInvalidValue;
  if ((k > 1 || resid32 != nullptr) && variant != MQ_K4) return (int)cudaErrorInvalidValue;
  if (k > 1 && resid32 != nullptr) return (int)cudaErrorInvalidValue;
  const bool recip = variant == MQ_VAR || variant == MQ_VAR_BF16_GELU;
  const bool mxu = variant == MQ_ATTR_MXU, vpu = variant == MQ_ATTR_VPU;
  const int8_t* w1 = static_cast<const int8_t*>(w1_t);
  const float *fs1 = static_cast<const float*>(s1), *fb1 = static_cast<const float*>(b1);
  const float* fxs = static_cast<const float*>(xs);
  const int8_t* ixq = static_cast<const int8_t*>(xq);
  cudaError_t e;
  if (mxu) {
    e = launch_cast_s8<true>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                             static_cast<float*>(xs), M, D, st, DK);
  } else {
    e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
    if (e != cudaSuccess) return (int)e;
    e = recip ? launch_quant_rows_mode<true, false>(static_cast<const bf16*>(xn),
                                                    static_cast<int8_t*>(xq),
                                                    static_cast<float*>(xs), nullptr, M, DK, st)
              : launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                                  static_cast<float*>(xs), M, DK, st);
  }
  if (e != cudaSuccess) return (int)e;
  switch (variant) {
    case MQ_ATTR_MXU:
      e = launch_gemm_s8<EQ_BIAS_S8>(ixq, fxs, w1, fs1, fb1, nullptr, hq, M, F, DK, st, hs);
      break;
    case MQ_ATTR_VPU:
      e = launch_bcast_rows<EQ_BIAS_QGELU>(ixq, fxs, DK, fb1, nullptr, h, M, F, st, F,
                                           fv == 0 ? F : fv);
      break;
    case MQ_BF16H:
      e = launch_gemm_s8<EQ_BIAS>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, F, DK, st);
      break;
    case MQ_VAR_BF16_GELU:
      e = launch_gemm_s8<EQ_BIAS_QGELU_BF16>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, F, DK, st);
      break;
    default:
      e = act_kind == 0 ? launch_gemm_s8<EQ_BIAS_QGELU>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, F, DK, st)
                        : launch_gemm_s8<EQ_BIAS_GELU>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, F, DK, st);
  }
  if (e != cudaSuccess) return (int)e;
  if (mxu)
    e = cudaSuccess;  // the up GEMM wrote hq and hs
  else if (variant == MQ_BF16H)
    e = launch_quant_rows_mode<false, true>(static_cast<const bf16*>(h), static_cast<int8_t*>(hq),
                                            static_cast<float*>(hs), static_cast<float*>(g), M, F,
                                            st);
  else if (recip)
    e = launch_quant_rows_mode<true, false>(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                                            static_cast<float*>(hs), nullptr, M, F, st);
  else  // k rows of F / k per row of h (k == 1: the whole row)
    e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                          static_cast<float*>(hs), M * k, F / k, st);
  if (e != cudaSuccess) return (int)e;
  const int8_t* ihq = static_cast<const int8_t*>(hq);
  const float *fhs = static_cast<const float*>(hs), *fs2 = static_cast<const float*>(s2),
              *fb2 = static_cast<const float*>(b2);
  const int8_t* w2 = static_cast<const int8_t*>(w2_t);
  if (vpu)
    e = launch_bcast_rows<EQ_RESID_BIAS>(ihq, fhs, F, fb2, x, out, M, D, st);
  else if (k > 1)
    e = launch_gemm_s8<EQ_RESID_BIAS_CHUNK>(ihq, fhs, w2, fs2, fb2, x, out, M, NO, F, st, nullptr,
                                            F / k / SBK, D);
  else if (resid32 != nullptr)
    e = launch_gemm_s8<EQ_RESID32_BIAS>(ihq, fhs, w2, fs2, fb2, resid32, out, M, NO, F, st,
                                        nullptr, 0, D);
  else
    e = launch_gemm_s8<EQ_RESID_BIAS>(ihq, fhs, w2, fs2, fb2, x, out, M, NO, F, st, nullptr, 0, D);
  return (int)e;
}

}  // namespace

extern "C" {

// K3 (attention_block_q_impl's AQ_K3) on the padded layout at head dim
// hdp (64 ceil(hd / 64)) with the true head dim's scale hd^-0.5.
int dvl_attention_block_q(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                          const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                          const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                          void* attn, void* aq, void* ascale, int B, int S, int D, int heads,
                          int hdp, int causal, float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal, AQ_K3,
                                stream);
}

// The KB variants (attention_block_q_impl's AQ_*): K3's arguments and
// padded layout, causal 0.  KB (a) 1, attention_block_qq: qkv [B*S, NQKV]
// f32, ws the int8 core's workspace (qq_ws_bytes).  KB (a) 4,
// attn_q_kernel_var.  benchmarks/q_ilp4.py's head-pair packed kernel
// (make_kernel): the row sum divided out after P V.
// benchmarks/q_attribution.py's attn_kernel, modes "mxu" (xn unwritten) and
// "vpu".
int dvl_attention_block_qq(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                           const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                           const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                           void* attn, void* aq, void* ascale, void* ws, int B, int S, int D,
                           int heads, int hdp, int causal, float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal, AQ_QQ,
                                stream, nullptr, ws);
}

int dvl_attention_block_q_var(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                              const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                              const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                              void* attn, void* aq, void* ascale, int B, int S, int D, int heads,
                              int hdp, int causal, float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal,
                                AQ_VAR, stream);
}

int dvl_attention_block_q_postdiv(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv_t, const void* sqkv, const void* bqkv,
                                  const void* wo_t, const void* so, const void* bo, void* out,
                                  void* xn, void* xq, void* xs, void* qkv, void* attn, void* aq,
                                  void* ascale, int B, int S, int D, int heads, int hdp, int causal,
                                  float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal,
                                AQ_POSTDIV, stream);
}

int dvl_attention_block_q_attr_mxu(const void* x, const void* ln_s, const void* ln_b,
                                   const void* wqkv_t, const void* sqkv, const void* bqkv,
                                   const void* wo_t, const void* so, const void* bo, void* out,
                                   void* xn, void* xq, void* xs, void* qkv, void* attn, void* aq,
                                   void* ascale, int B, int S, int D, int heads, int hdp,
                                   int causal, float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal,
                                AQ_ATTR_MXU, stream);
}

int dvl_attention_block_q_attr_vpu(const void* x, const void* ln_s, const void* ln_b,
                                   const void* wqkv_t, const void* sqkv, const void* bqkv,
                                   const void* wo_t, const void* so, const void* bo, void* out,
                                   void* xn, void* xq, void* xs, void* qkv, void* attn, void* aq,
                                   void* ascale, int B, int S, int D, int heads, int hdp,
                                   int causal, float scale, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal,
                                AQ_ATTR_VPU, stream);
}

// KB (a) 1's int8 core alone: qkv [B*S, 3 heads hdp] f32 (head h's q, k, v
// at columns h hdp, DA + h hdp, 2 DA + h hdp, zero lanes past its hd) ->
// out [B*S, heads hdp] bf16; p_out [B, H, S, S] f32, pq_out [B, H, S, S]
// int8 and psc_out [B, H, S] f32 may be null; ws: qq_ws_bytes(B, S, heads,
// hdp) bytes, 256-byte aligned.  Any S >= 1.
int dvl_attention_qq_core(const void* qkv, void* out, void* p_out, void* pq_out, void* psc_out,
                          void* ws, int B, int S, int heads, int hdp, float scale, void* stream) {
  return (int)launch_attention_qq(static_cast<const float*>(qkv), static_cast<bf16*>(out),
                                  static_cast<float*>(p_out), static_cast<int8_t*>(pq_out),
                                  static_cast<float*>(psc_out), ws, B, S, heads, hdp,
                                  3 * heads * hdp, scale, reinterpret_cast<cudaStream_t>(stream));
}

// The int8 core's workspace in bytes (both routes), as launch_attention_qq
// lays it out.
long long dvl_qq_ws_bytes(int B, int S, int heads, int hdp) {
  return qq_ws_bytes(B, S, heads, hdp);
}

// K4 (mlp_block_q_impl's MQ_K4), its hidden in k F-chunks (k = 1: the
// whole row; k > 1: mlp_block_q(fb=F / k), KB (a) 7's make_fsplit(k); hs
// [M, k]); F is the padded hidden width, k chunks of fb rounded up to 128.
int dvl_mlp_block_q(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                    const void* s1, const void* b1, const void* w2_t, const void* s2,
                    const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                    void* hs, int M, int D, int F, int act_kind, int k, void* stream) {
  return mlp_block_q_impl(x, ln_s, ln_b, w1_t, s1, b1, w2_t, s2, b2, out, xn, xq, xs, h, hq, hs,
                          nullptr, M, D, F, act_kind, MQ_K4, stream, k);
}

// The one-call int8 layer of benchmarks/q_layer_fused.py (layer_kernel):
// K3's launches with the out-projection keeping y = x + (deq + bo) in f32
// (y32 [B*S, D]) beside its bf16 rounding yb, then K4's on LN(yb) with the
// down product adding the f32 y: out = bf16((y + b2) + deq), quick_gelu as
// the script's.  The attention half's arguments and scratch are K3's (a_*,
// at hdp and scale), the MLP half's K4's (m_*, F the padded hidden width),
// both on their padded layouts.
int dvl_fused_layer_q(const void* x, const void* ln1_s, const void* ln1_b, const void* wqkv_t,
                      const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                      const void* bo, const void* ln2_s, const void* ln2_b, const void* w1_t,
                      const void* s1, const void* b1, const void* w2_t, const void* s2,
                      const void* b2, void* out, void* a_xn, void* a_xq, void* a_xs, void* qkv,
                      void* attn, void* aq, void* ascale, void* y32, void* yb, void* m_xn,
                      void* m_xq, void* m_xs, void* h, void* hq, void* hs, int B, int S, int D,
                      int F, int heads, int hdp, float scale, void* stream) {
  int e = attention_block_q_impl(x, ln1_s, ln1_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, yb, a_xn,
                                 a_xq, a_xs, qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, 0,
                                 AQ_K3, stream, y32);
  if (e != 0) return e;
  return mlp_block_q_impl(yb, ln2_s, ln2_b, w1_t, s1, b1, w2_t, s2, b2, out, m_xn, m_xq, m_xs, h,
                          hq, hs, nullptr, B * S, D, F, 0, MQ_K4, stream, 1,
                          static_cast<const float*>(y32));
}

// KB (a) 2 / 3 and the attribution's MLP: K4's arguments, g (MQ_BF16H's
// f32 activation, or null) before M, and the variant (1 bf16h, 2 reciprocal
// quantizer, 3 reciprocal quantizer and bf16 quick_gelu, 4 q_attribution.py's
// "mxu", 5 its "vpu") in place of act_kind; F the padded hidden width, fv
// the model's.
int dvl_mlp_block_q_kb(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                       const void* s1, const void* b1, const void* w2_t, const void* s2,
                       const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                       void* hs, void* g, int M, int D, int F, int fv, int variant, void* stream) {
  if (variant < MQ_BF16H || variant > MQ_ATTR_VPU) return (int)cudaErrorInvalidValue;
  return mlp_block_q_impl(x, ln_s, ln_b, w1_t, s1, b1, w2_t, s2, b2, out, xn, xq, xs, h, hq, hs,
                          g, M, D, F, 0, variant, stream, 1, nullptr, fv);
}

// A tensor-parallel slot's int8 attention up to its out-projection, on the
// group's padded layout (ops/fused_block.py::group_plan): LN -> quantize x
// (every slot of a row quantizes the same x: the same codes) -> s8 QKV GEMM
// on the slot's columns -> the core on its g heads -> the row amax of its
// attention rows (amax [B*S] f32; the padded lanes are 0).  wqkv_t [NQKV,
// DK] int8 (the group's q, k, v output channels at hdp lanes a head, zero
// rows up to NQKV = 3 g hdp rounded up to 128), sqkv and bqkv [NQKV] f32.
// Scratch: xn [B*S, DK] bf16, xq [B*S, DK] int8, xs [B*S] f32, qkv [B*S,
// NQKV] bf16, attn [B*S, g hdp] bf16.  scale: the true head dim's hd^-0.5.
int dvl_attention_block_q_heads(const void* x, const void* ln_s, const void* ln_b,
                                const void* wqkv_t, const void* sqkv, const void* bqkv, void* xn,
                                void* xq, void* xs, void* qkv, void* attn, void* amax, int B,
                                int S, int D, int g, int hdp, int causal, float scale,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, 64), DA = g * hdp, NQKV = round_up(3 * DA, SBN);
  if (g < 1 || hdp < 64 || hdp % 64) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), M, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_BIAS>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                              static_cast<const int8_t*>(wqkv_t), static_cast<const float*>(sqkv),
                              static_cast<const float*>(bqkv), nullptr, qkv, M, NQKV, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, g, hdp,
                             causal, st, NQKV, scale, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_row_amax(static_cast<const bf16*>(attn), static_cast<float*>(amax), M, DA, st);
}

// A tensor-parallel slot's int8 MLP up to its down-projection, on mlp_plan's
// layout of its hidden columns: LN -> quantize x -> s8 up GEMM with the
// activation (h [M, Fp] f32, zero past the slot's Fj columns) -> the row
// amax of h (amax [M] f32).  w1_t [Fp, DK] int8, s1 and b1 [Fp] f32 (zero
// past Fj).  Scratch: xn [M, DK] bf16, xq [M, DK] int8, xs [M] f32.
int dvl_mlp_block_q_cols(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                         const void* s1, const void* b1, void* xn, void* xq, void* xs, void* h,
                         void* amax, int M, int D, int Fp, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, 64);
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st, DK);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), M, DK, st);
  if (e != cudaSuccess) return (int)e;
  if (act_kind == 0)
    e = launch_gemm_s8<EQ_BIAS_QGELU>(static_cast<const int8_t*>(xq),
                                     static_cast<const float*>(xs),
                                     static_cast<const int8_t*>(w1_t),
                                     static_cast<const float*>(s1),
                                     static_cast<const float*>(b1), nullptr, h, M, Fp, DK, st);
  else
    e = launch_gemm_s8<EQ_BIAS_GELU>(static_cast<const int8_t*>(xq),
                                    static_cast<const float*>(xs),
                                    static_cast<const int8_t*>(w1_t),
                                    static_cast<const float*>(s1),
                                    static_cast<const float*>(b1), nullptr, h, M, Fp, DK, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_row_amax(static_cast<const float*>(h), static_cast<float*>(amax), M, Fp, st);
}

// The row-parallel product of one slot: a [M, K] (bf16 if a_f32 == 0, else
// f32) quantized at the row scale max_j(amaxes[j]) / 127 (clamped at 1e-8)
// into aq [M, K] int8 and ascale [M] f32, then out [M, ldc] int32 = aq @
// wt^T, wt [N, K] int8 (the slot's input rows of the weight, transposed; N
// a multiple of 128, its rows past ldc zero).  amaxes: a host array of 1 <=
// m <= TP_PARTS device pointers to [M] f32.  K % 16 == 0.
int dvl_rows_q_partial(const void* a, int a_f32, const void* const* amaxes, int m,
                       const void* wt, void* aq, void* ascale, void* out, int M, int N, int K,
                       int ldc, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m < 1 || m > TP_PARTS) return (int)cudaErrorInvalidValue;
  TpPtrs am{};
  for (int j = 0; j < m; ++j) am.p[j] = amaxes[j];
  if (a_f32)
    quant_rows_given_amax_kernel<float><<<M, QR_THREADS, 0, st>>>(
        static_cast<const float*>(a), am, m, static_cast<int8_t*>(aq), static_cast<float*>(ascale),
        K);
  else
    quant_rows_given_amax_kernel<bf16><<<M, QR_THREADS, 0, st>>>(
        static_cast<const bf16*>(a), am, m, static_cast<int8_t*>(aq), static_cast<float*>(ascale),
        K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm_s8<EQ_I32>(static_cast<const int8_t*>(aq), nullptr,
                                     static_cast<const int8_t*>(wt), nullptr, nullptr, nullptr, out,
                                     M, N, K, st, nullptr, 0, ldc);
}

// out [M, N] bf16 from 1 <= m <= TP_PARTS int32 partials (a host array of
// device pointers), summed exactly, dequantized with ascale [M] and w_scale
// [N], + bias [N] + resid [M, N] bf16 in the order bias_first picks (0: the
// attention half's, 1: the MLP half's).
int dvl_tp_reduce_q(const void* const* parts, int m, const void* ascale, const void* w_scale,
                    const void* bias, const void* resid, void* out, int M, int N,
                    int bias_first, void* stream) {
  if (m < 1 || m > TP_PARTS || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  TpPtrs pp{};
  for (int j = 0; j < m; ++j) pp.p[j] = parts[j];
  const long long total = (long long)M * N;
  const int threads = 256;
  tp_reduce_q_kernel<<<(unsigned)((total / 8 + threads) / threads), threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      pp, m, static_cast<const float*>(ascale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(resid), static_cast<bf16*>(out),
      total, N, bias_first);
  return (int)cudaGetLastError();
}

}  // extern "C"
