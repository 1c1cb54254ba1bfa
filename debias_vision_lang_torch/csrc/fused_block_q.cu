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
// loop's, so a tensor-parallel block is bit-equal to K3 / K4.  A slot opens
// with one pass that normalises x and quantizes it (ln_quant_rows_kernel:
// LayerNorm's bf16 rows, bit for bit, never written); the attention slot
// then runs K3's QKV GEMM and core on its heads and a row-amax pass (one
// warp a row), four launches; the MLP slot's up GEMM takes the row amax in
// its epilogue (EQ_BIAS_QGELU_AMAX / EQ_BIAS_GELU_AMAX: an integer atomicMax
// on the bits of each tile's row max), two launches.
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
//                                 bf16(deq + b1) with quick_gelu in the
//                                 hidden's quantize pass (2 bytes read a
//                                 value, not 4), four launches: LayerNorm and
//                                 the quantize of x in one, the up product on
//                                 the persistent TMA-store GEMM, the
//                                 gelu-and-quantize pass 16 bytes a load
//                                 (qgelu_quant_rows_kernel); q_kernel_variants.py::
//                                 make_mlp_var (mlp_q_kernel_var): the
//                                 reciprocal quantizer, the bf16 quick_gelu in
//                                 EQ_BIAS_QGELU_BF16; four launches:
//                                 LayerNorm and the reciprocal quantize of x in
//                                 one (ln_quant_recip_rows_kernel), then K4's;
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
//                                 (EQ_RESID_BIAS_CHUNK), four launches:
//                                 LayerNorm and the quantize of x in one,
//                                 chunks past 1,024 columns quantized 16
//                                 bytes a load (quant_rows_x4_kernel), the
//                                 fold on the epilogue warpgroups of
//                                 gemm_s8_epi_chunk_kernel (fsplit_down_fits);
//   dvl_fused_layer_q          <- q_layer_fused.py::tower (layer_kernel, every
//                                 mode): K3 then K4 with the attention half's
//                                 x + proj kept f32 (EQ_BIAS_RESID_Y) and added
//                                 by the down product (EQ_RESID32_BIAS), in
//                                 nine launches: LayerNorm and the quantize
//                                 pass in one at both norms
//                                 (ln_quant_rows_kernel), the QKV product on
//                                 the persistent TMA-store GEMM
//                                 (gemm_s8_tma_kernel), the down product on
//                                 its epilogue-warpgroup form
//                                 (gemm_s8_epi_kernel, below);
//   dvl_attention_block_q_postdiv <- q_ilp4.py::make_call (the head-pair
//                                 packed kernel): K3's quantizer, the row sum
//                                 divided out after P V as AQ_VAR's core; five
//                                 launches: LayerNorm and the quantize of x in
//                                 one, the QKV product on gemm_s8_tma_kernel,
//                                 the core's divide-after instantiation
//                                 (launch_attention_wgmma<true>: qq_div's IEEE
//                                 quotient).
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
//   * all four products of K3 / K4 run one TMA-fed, warp-specialised s8
//     wgmma GEMM, the bf16 GEMM of csrc/fused_block.cu in 8-bit operands: a 128x128 block
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
//   * the one-call layer's QKV product on a persistent s8 wgmma GEMM
//     (gemm_s8_tma_kernel): one block an SM walks many output tiles, a
//     producer thread streams the next tile's K steps through a 6-stage ring
//     while the consumers finish this one, and the epilogue stages its bf16
//     tile in a swizzled buffer of its own, sent out by TMA stores; its down
//     product (K = 3,072, the f32 y read) on the same walk with the epilogue
//     on two warpgroups of its own (gemm_s8_epi_kernel), so the consumers go
//     on to the next tile's products.  At ViT-B/16 B=256 on an NVIDIA H100
//     80GB HBM3 at 700 W: 0.189 and 0.216 ms against this GEMM's 0.244 and
//     0.258 (PERF.md, the one-call layer); the layer's out and up products
//     keep this GEMM, whose two blocks an SM hid their epilogues better than
//     either persistent design;
//   * a tensor-parallel slot's row-parallel product (dvl_rows_q_partial) at
//     a narrow K on the row-strip kernel rows_strip_q_kernel: the codes
//     made in shared memory, every N tile of the weight walked on them by
//     s8 wgmma, the int32 tiles stored by TMA (below); wider K on a
//     warp-a-row quantize pass and this GEMM;
//   * the LayerNorm kernel of common.cuh.
// K3 and K4 keep these launches; the tensor-parallel slots and the one-call
// layer fuse LayerNorm with the quantize pass, the MLP slot takes its row
// amax in the up GEMM's epilogue (above).  A producer quantizing on load is
// later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <atomic>

#include "attention_qq.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Per-row int8 quantization: q [rows, n] int8 and scale [rows] f32 from x
// [rows, n] (bf16 or f32).  One block per row; each thread holds PER values.
// The amax and the scale's clamp propagate a NaN (fmax_nan, as jnp.max and
// jnp.maximum), and a NaN quotient converts to 0: a row holding a NaN gets
// a NaN scale and codes 0, as the JAX function's.
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
    amax = fmax_nan(amax, fabsf(v[j]));
  }
  amax = warp_max_nan(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmax_nan(amax, red[w]);
  const float s = q_scale_nan(amax);
  const float inv = __frcp_rn(s);
  int8_t* qr = q + row * n;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    const float y = RECIP ? __fmul_rn(v[j], inv) : __fdiv_rn(v[j], s);
    if (i < n) qr[i] = (int8_t)__float2int_rn(fmin_nan(fmax_nan(rintf(y), -127.f), 127.f));
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
    amax = fmax_nan(amax, fabsf(v));
  }
  amax = warp_max_nan(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmax_nan(amax, red[w]);
  const float s = q_scale_nan(amax);
  const float inv = __frcp_rn(s);
  int8_t* qr = q + row * n;
  for (int i = threadIdx.x; i < n; i += QR_THREADS) {
    float v = to_f32(xr[i]);
    if constexpr (QGELU) v = quick_gelu(v);
    const float y = RECIP ? __fmul_rn(v, inv) : __fdiv_rn(v, s);
    qr[i] = (int8_t)__float2int_rn(fmin_nan(fmax_nan(rintf(y), -127.f), 127.f));
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
  EQ_BIAS_QGELU_AMAX = 12,  // EQ_BIAS_QGELU, each row's max |h| into C2 (a TP slot's mlp up)
  EQ_BIAS_GELU_AMAX = 13,   // EQ_BIAS_GELU, the same
};                    // deq = (acc * row_scale) * channel_scale
// KB (a) 2's bf16 pre-activation bf16(deq + b1) is EQ_BIAS's output.
// EQ_RESID_BIAS_CHUNK: the K loop is cut into chunks of chunk_steps K steps
// (the hidden's F-chunks, each quantized with its own row scales);
// deq_c = (acc_c * row_scale[m, c]) * channel_scale, acc_c the chunk's
// exact int32 sum, and the chunks' deq_c are summed in f32 in chunk order.
// EQ_BIAS_S8: the blocks of column tile 0 write each row's scale, 1, to C2
// [M] f32, so the down GEMM reads the codes and their scales as K4's.
// EQ_BIAS_*_AMAX: C2 [M] f32 holds 0 before the launch; each block folds
// the max |h| of its tile's part of a row into it with an integer atomicMax
// on the bit pattern (non-negative floats order as their bits; a NaN's bits
// are past inf's, so a row holding one gets a NaN, as torch's amax does).

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
                         EPI == EQ_BIAS_QGELU_BF16 || EPI == EQ_BIAS_QGELU_AMAX ||
                         EPI == EQ_BIAS_GELU_AMAX) {
      float hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pre = __fadd_rn(d[i], bb[i]);
        if constexpr (EPI == EQ_BIAS_QGELU || EPI == EQ_BIAS_QGELU_AMAX) hv[i] = quick_gelu(pre);
        else if constexpr (EPI == EQ_BIAS_GELU || EPI == EQ_BIAS_GELU_AMAX) hv[i] = erf_gelu_rn(pre);
        else if constexpr (EPI == EQ_BIAS_QGELU_BF16) hv[i] = quick_gelu_bf16(pre);
        else hv[i] = pre;
      }
      float* out = static_cast<float*>(C) + m * N + n;
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(hv);
      *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(hv + 4);
      if constexpr (EPI == EQ_BIAS_QGELU_AMAX || EPI == EQ_BIAS_GELU_AMAX) {
        // the row's max |h| over this tile's 128 columns: the 16 lanes that
        // share row r (lanes 0-15 or 16-31 of the warp) fold their 8 values,
        // then one of them folds the tile's into the row's amax
        unsigned bits = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) bits = max(bits, __float_as_uint(fabsf(hv[i])));
        const unsigned row_lanes = 0xffffu << (threadIdx.x & 16);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) bits = max(bits, __shfl_xor_sync(row_lanes, bits, o));
        if ((tid & 15) == 0) atomicMax(static_cast<unsigned*>(C2) + m, bits);
      }
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

// EQ_BIAS_RESID_Y writes its bf16 copy to C2, EQ_BIAS_S8 its row scales,
// EQ_BIAS_*_AMAX its row amaxes (C2 zeroed by the caller);
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
  if ((EPI == EQ_BIAS_RESID_Y || EPI == EQ_BIAS_S8 || EPI == EQ_BIAS_QGELU_AMAX ||
       EPI == EQ_BIAS_GELU_AMAX) && C2 == nullptr)
    return cudaErrorInvalidValue;
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

// A slot's LayerNorm and the quantize pass of its output in one launch: xq
// [rows, ldq] (zero codes past d) and xs [rows] are quant_rows_kernel's
// codes and scales of the bf16 rows layer_norm_kernel (common.cuh) would
// write, and those rows never reach device memory.  One warp per row, as
// layer_norm_kernel: each lane takes the pairs (at an odd d, the values)
// that kernel's lane takes, sums them in the same order and normalises each
// with the same expression, so every value rounds to the same bf16; then
// the amax over those values (a max: any order gives it), the scale
// max(amax / 127, 1e-8) and the codes rint(v / scale) clamped to +-127, from
// the quotients quant_rows_kernel's IEEE divisions give (q_code).  PP > 0: a
// lane keeps its PP pairs in registers (d even, d <= 64 PP): x is read once;
// PP == 0: the row is read again for the variance, the amax and the codes
// (2 d bytes, L1- or L2-resident).  FULL (d = 64 PP: D = 512, 768, 1,024,
// 1,280, 2,048) drops the per-pair guards, which nvcc turns into a branch a
// pair.  amax0, if not null, gets 0 at each row: the up GEMM's
// EQ_BIAS_*_AMAX folds the hidden's row amax into it.
constexpr int LNQ_ROWS = 8;  // rows (warps) a block

__device__ __forceinline__ float2 ln_pair(float2 v, float mean, float inv,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias, int i) {
  const float2 sc = reinterpret_cast<const float2*>(scale)[i];
  const float2 bi = reinterpret_cast<const float2*>(bias)[i];
  const float a = (v.x - mean) * inv * sc.x + bi.x;
  const float b = (v.y - mean) * inv * sc.y + bi.y;
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float ln_one(float v, float mean, float inv,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, int i) {
  return __bfloat162float(__float2bfloat16_rn((v - mean) * inv * scale[i] + bias[i]));
}

// quant_rows_kernel's code of v at the row scale s, as a byte: the IEEE
// quotient v / s from the corrected reciprocal product of attention_qq.cuh's
// qq_div (rs = 1 / s; exact while |v| >= 2^-100, and past that the quotient
// is far below 1/2 either way: the code is 0), or, for a row whose amax is
// not finite (FAST false), __fdiv_rn itself; then clamped to +-127 and
// rounded half to even by the 1.5 2^23 add (rounding and clamping commute at
// integer bounds); a NaN quotient (a NaN row's, whose scale is NaN) gives 0,
// XLA's conversion of NaN.
template <bool FAST>
__device__ __forceinline__ uint32_t q_code(float v, float s, float rs) {
  const float y = FAST ? qq_div(v, s, rs) : __fdiv_rn(v, s);
  if (!FAST && isnan(y)) return 0u;
  const float c = fminf(fmaxf(y, -127.f), 127.f);
  return (uint32_t)(__float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000) & 0xffu;
}

template <bool FAST>
__device__ __forceinline__ uint16_t q_pair(float2 v, float s, float rs) {
  return (uint16_t)(q_code<FAST>(v.x, s, rs) | q_code<FAST>(v.y, s, rs) << 8);
}

// KB (a) 3's reciprocal quantizer (quant_rows_kernel's RECIP): the code of v
// at 1 / scale = inv, rint(v inv) clamped to +-127 and a NaN to 0, in that
// kernel's own expression.
__device__ __forceinline__ uint32_t q_code_recip(float v, float inv) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(
      fmin_nan(fmax_nan(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

__device__ __forceinline__ uint16_t q_pair_recip(float2 v, float inv) {
  return (uint16_t)(q_code_recip(v.x, inv) | q_code_recip(v.y, inv) << 8);
}

// The kernel's body; RECIP: quant_rows_kernel<..., RECIP>'s codes (KB (a)
// 3: ln_quant_recip_rows_kernel), else quant_rows_kernel's.
template <int PP, bool FULL, bool RECIP>
__device__ __forceinline__ void ln_quant_rows(const bf16* __restrict__ x,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              int8_t* __restrict__ q, float* __restrict__ qs,
                                              float* __restrict__ amax0, int rows, int d,
                                              int ldq, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNQ_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xs = x + row * d;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(xs);
  uint16_t* q2 = reinterpret_cast<uint16_t*>(q + row * ldq);  // a pair's two codes
  const int half = d >> 1;
  float amax = 0.f, sc;
  if constexpr (PP > 0) {
    // FULL: d = 64 PP, every lane holds PP pairs (no guard, no branch a pair)
    float2 v[PP];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int i = lane + 32 * j;
      const bool in = FULL || i < half;
      v[j] = in ? __bfloat1622float2(xr[i]) : make_float2(0.f, 0.f);
      if (in) s += v[j].x + v[j].y;
    }
    const float mean = warp_sum(s) / (float)d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      if (FULL || lane + 32 * j < half) {
        float a = v[j].x - mean, b = v[j].y - mean;
        ss += a * a + b * b;
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int i = lane + 32 * j;
      if (FULL || i < half) {
        v[j] = ln_pair(v[j], mean, inv, scale, bias, i);
        amax = fmax_nan(amax, fmax_nan(fabsf(v[j].x), fabsf(v[j].y)));
      }
    }
    amax = warp_max_nan(amax);
    sc = q_scale_nan(amax);
    const float rs = __frcp_rn(sc);
    if constexpr (RECIP) {
#pragma unroll
      for (int j = 0; j < PP; ++j)
        if (FULL || lane + 32 * j < half) q2[lane + 32 * j] = q_pair_recip(v[j], rs);
    } else if (amax < INFINITY) {  // the branch a row, not a value: the codes' chains interleave
#pragma unroll
      for (int j = 0; j < PP; ++j)
        if (FULL || lane + 32 * j < half) q2[lane + 32 * j] = q_pair<true>(v[j], sc, rs);
    } else {
#pragma unroll
      for (int j = 0; j < PP; ++j)
        if (FULL || lane + 32 * j < half) q2[lane + 32 * j] = q_pair<false>(v[j], sc, rs);
    }
  } else {  // an odd d (value by value, as layer_norm_kernel) or a row past 64 x 32 pairs
    const bool pairs = !(d & 1);
    float s = 0.f;
    if (pairs) {
      for (int i = lane; i < half; i += 32) {
        float2 v = __bfloat1622float2(xr[i]);
        s += v.x + v.y;
      }
    } else {
      for (int i = lane; i < d; i += 32) s += __bfloat162float(xs[i]);
    }
    const float mean = warp_sum(s) / (float)d;
    float ss = 0.f;
    if (pairs) {
      for (int i = lane; i < half; i += 32) {
        float2 v = __bfloat1622float2(xr[i]);
        float a = v.x - mean, b = v.y - mean;
        ss += a * a + b * b;
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float a = __bfloat162float(xs[i]) - mean;
        ss += a * a;
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);
    if (pairs) {
      for (int i = lane; i < half; i += 32) {
        const float2 y = ln_pair(__bfloat1622float2(xr[i]), mean, inv, scale, bias, i);
        amax = fmax_nan(amax, fmax_nan(fabsf(y.x), fabsf(y.y)));
      }
    } else {
      for (int i = lane; i < d; i += 32)
        amax = fmax_nan(amax, fabsf(ln_one(__bfloat162float(xs[i]), mean, inv, scale, bias, i)));
    }
    amax = warp_max_nan(amax);
    sc = q_scale_nan(amax);
    const float rs = __frcp_rn(sc);
    const bool fast = amax < INFINITY;
    if (pairs) {
      for (int i = lane; i < half; i += 32) {
        const float2 y = ln_pair(__bfloat1622float2(xr[i]), mean, inv, scale, bias, i);
        q2[i] = RECIP ? q_pair_recip(y, rs) : fast ? q_pair<true>(y, sc, rs) : q_pair<false>(y, sc, rs);
      }
    } else {
      int8_t* qr = q + row * ldq;
      for (int i = lane; i < d; i += 32) {
        const float y = ln_one(__bfloat162float(xs[i]), mean, inv, scale, bias, i);
        qr[i] = (int8_t)(RECIP  ? q_code_recip(y, rs)
                         : fast ? q_code<true>(y, sc, rs)
                                : q_code<false>(y, sc, rs));
      }
    }
  }
  for (int i = d + lane; i < ldq; i += 32) q[row * ldq + i] = 0;  // the padded K edge
  if (lane == 0) {
    qs[row] = sc;
    if (amax0 != nullptr) amax0[row] = 0.f;
  }
}

template <int PP, bool FULL>
__global__ void __launch_bounds__(32 * LNQ_ROWS)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, int8_t* __restrict__ q,
                     float* __restrict__ qs, float* __restrict__ amax0, int rows, int d, int ldq,
                     float eps) {
  ln_quant_rows<PP, FULL, false>(x, scale, bias, q, qs, amax0, rows, d, ldq, eps);
}

template <int PP, bool FULL>
__global__ void __launch_bounds__(32 * LNQ_ROWS)
ln_quant_recip_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, int8_t* __restrict__ q,
                           float* __restrict__ qs, float* __restrict__ amax0, int rows, int d,
                           int ldq, float eps) {
  ln_quant_rows<PP, FULL, true>(x, scale, bias, q, qs, amax0, rows, d, ldq, eps);
}

using LnQuantFn = void (*)(const bf16*, const float*, const float*, int8_t*, float*, float*, int,
                           int, int, float);

template <int PP, bool FULL, bool RECIP>
LnQuantFn ln_quant_fn() {
  if constexpr (RECIP) return ln_quant_recip_rows_kernel<PP, FULL>;
  else return ln_quant_rows_kernel<PP, FULL>;
}

// xq [rows, ldq], xs [rows] from x [rows, d] (ldq even, >= d); RECIP: the
// reciprocal quantizer's codes.
template <bool RECIP = false>
cudaError_t launch_ln_quant(const bf16* x, const float* s, const float* b, int8_t* xq, float* xs,
                            float* amax0, int rows, int d, int ldq, cudaStream_t st) {
  if (d < 1 || ldq < d || (ldq & 1)) return cudaErrorInvalidValue;
  const dim3 grid((rows + LNQ_ROWS - 1) / LNQ_ROWS), block(32 * LNQ_ROWS);
  const int half = d / 2;
  // the fewest pairs a lane that hold the row; FULL where they hold it exactly
  LnQuantFn k = ln_quant_fn<0, false, RECIP>();
  if (!(d & 1)) {
    if (half < 32 * 4) k = ln_quant_fn<4, false, RECIP>();
    else if (half == 32 * 4) k = ln_quant_fn<4, true, RECIP>();
    else if (half < 32 * 8) k = ln_quant_fn<8, false, RECIP>();
    else if (half == 32 * 8) k = ln_quant_fn<8, true, RECIP>();
    else if (half < 32 * 12) k = ln_quant_fn<12, false, RECIP>();
    else if (half == 32 * 12) k = ln_quant_fn<12, true, RECIP>();
    else if (half < 32 * 16) k = ln_quant_fn<16, false, RECIP>();
    else if (half == 32 * 16) k = ln_quant_fn<16, true, RECIP>();
    else if (half < 32 * 20) k = ln_quant_fn<20, false, RECIP>();
    else if (half == 32 * 20) k = ln_quant_fn<20, true, RECIP>();
    else if (half < 32 * 32) k = ln_quant_fn<32, false, RECIP>();
    else if (half == 32 * 32) k = ln_quant_fn<32, true, RECIP>();
  }
  k<<<grid, block, 0, st>>>(x, s, b, xq, xs, amax0, rows, d, ldq, 1e-5f);
  return cudaGetLastError();
}

// A slot's attention rows' amax: amax [rows] f32 from x [rows, n] bf16 (n %
// 8 == 0, rows 16-byte aligned).  One warp per row, 16-byte loads, LNQ_ROWS
// rows a block.  The max is taken over |x|'s bit patterns (a bf16's f32 is
// its bits shifted by 16; non-negative floats order as their bits), so a
// NaN, whose bits are past inf's, gives the row a NaN, as torch's amax does.
__global__ void __launch_bounds__(32 * LNQ_ROWS)
row_amax_kernel(const bf16* __restrict__ x, float* __restrict__ amax, int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNQ_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
  unsigned bits = 0u;
  for (int i = lane; i < n / 8; i += 32) {
    const uint4 r = xr[i];
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) bits = max(bits, max(w[k] & 0x7fffu, (w[k] >> 16) & 0x7fffu));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, o));
  if (lane == 0) amax[row] = __uint_as_float(bits << 16);
}

cudaError_t launch_row_amax(const bf16* x, float* amax, int rows, int n, cudaStream_t st) {
  if (n % 8) return cudaErrorInvalidValue;
  row_amax_kernel<<<(rows + LNQ_ROWS - 1) / LNQ_ROWS, 32 * LNQ_ROWS, 0, st>>>(x, amax, rows,
                                                                                   n);
  return cudaGetLastError();
}

// 16 bytes of a row (8 bf16 or 4 f32 values) -> their codes at the row
// scale s, packed in order: quant_rows_kernel's IEEE division, rint and
// clamp, a NaN to 0 (q_code; rs = 1 / s).  Where s is finite (the row's
// amax is), the quotient comes from the corrected reciprocal product
// (qq_div: the IEEE quotient itself, without the division's range check
// and slow-path branch on each value); else from __fdiv_rn.
template <typename T, bool FAST>
__device__ __forceinline__ uint2 q_chunk_as(uint4 raw, float s, float rs) {
  uint32_t w[2] = {0u, 0u};
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      w[i >> 1] |= (q_code<FAST>(f.x, s, rs) | q_code<FAST>(f.y, s, rs) << 8) << (16 * (i & 1));
    }
  } else {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[0] |= q_code<FAST>(f[i], s, rs) << (8 * i);
  }
  return make_uint2(w[0], w[1]);
}

template <typename T>
__device__ __forceinline__ uint2 q_chunk(uint4 raw, float s, float rs) {
  return s < INFINITY ? q_chunk_as<T, true>(raw, s, rs) : q_chunk_as<T, false>(raw, s, rs);
}

// The row scale max(max_j amaxes[j][row] / 127, 1e-8), a NaN amax to NaN.
__device__ __forceinline__ float tp_row_scale(const TpPtrs& amaxes, int m, long long row) {
  float amax = static_cast<const float*>(amaxes.p[0])[row];
  for (int j = 1; j < m; ++j) amax = fmax_nan(amax, static_cast<const float*>(amaxes.p[j])[row]);
  return q_scale_nan(amax);
}

// q [rows, n], scale [rows] from x [rows, n] at the row scale of the m
// slots' amaxes (tp_row_scale): quant_rows_kernel's scale and codes, the
// row's amax given.  One warp a row, LNQ_ROWS rows a block, 16-byte loads
// (n a multiple of 16, rows 16-byte aligned); the warp reads the m amaxes
// once.
template <typename T>
__global__ void __launch_bounds__(32 * LNQ_ROWS)
quant_rows_given_amax_kernel(const T* __restrict__ x, const __grid_constant__ TpPtrs amaxes,
                             int m, int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                             int n) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNQ_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float s = tp_row_scale(amaxes, m, row), rs = __frcp_rn(s);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
  int8_t* qr = q + row * n;
  for (int i = lane; i < n / VEC; i += 32) {
    const uint2 c = q_chunk<T>(xr[i], s, rs);
    if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(qr + 8 * i) = c;
    else
      *reinterpret_cast<uint32_t*>(qr + 4 * i) = c.x;
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
cudaError_t launch_quant_given_amax(const T* x, const TpPtrs& am, int m, int8_t* q, float* scale,
                                    int rows, int n, cudaStream_t st) {
  if (n % 16) return cudaErrorInvalidValue;
  quant_rows_given_amax_kernel<T><<<(rows + LNQ_ROWS - 1) / LNQ_ROWS, 32 * LNQ_ROWS, 0, st>>>(
      x, am, m, q, scale, rows, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A tensor-parallel slot's row-parallel int8 product from a row strip
// quantized into shared memory: aq [M, K] int8 and ascale [M] f32 (the codes
// and scales of quant_rows_given_amax_kernel) and out [M, ldc] int32 = aq @
// Wt[N, K]^T, for a narrow K (K % 64 == 0, K <= 384: a head group's g hdp
// attention columns, a slot's Fp hidden columns).
//
// The s8 GEMM gives each 128x128 output tile a block of its own: at K =
// 64-384 that block runs one to three K steps, then stages 64 KB of int32
// and stores it from the threads while its products wait, and the codes
// took a launch of their own before it.  Here a persistent block owns 128
// rows at a time, in three roles:
//   * two quantizer warpgroups (64 rows each) read the rows of `a` (16-byte
//     loads, eight in flight a thread; the m amaxes read once a row into a
//     scale in shared memory) and write their codes straight into one of
//     two strip buffers, ceil(K / 128) tiles of [128 rows][128 B] under the
//     128-byte swizzle that the TMA would write and the s8 wgmma descriptor
//     reads (the codes past K zero), and the codes and scales out to aq /
//     ascale;
//   * a producer thread streams the weight's tiles, N tile after N tile,
//     through a ring by TMA;
//   * two consumer warpgroups (64 rows each) walk every N tile on their
//     half of the strip (wgmma m64n128k32 s8) and send each finished int32
//     tile out by TMA stores in two halves of 64 columns through a swizzled
//     staging buffer of their own (gemm_strip_f32_kernel's, in
//     fused_block.cu), under an L2 evict-first policy (the partial is read
//     back only by the reduce, after every slot's).
// Quantizer q feeds consumer q alone (an mbarrier pair per half and
// buffer), one strip ahead: the next strip is quantized while this one is
// multiplied and stored, so the reads of `a`, the products and the int32
// stores (the bound at these K) run together.  The codes are q_chunk's
// (the IEEE quotient), the int32 sums exact: codes, scales and partial are
// the quantize pass's and the GEMM's bit for bit.
// ---------------------------------------------------------------------------

constexpr int RSTRIP_MAX_KB = 3;               // 128-byte K steps a strip holds: K <= 384
constexpr int RSTRIP_STAGE_OUT = 64 * 64 * 4;  // a warpgroup's int32 staging: half a tile, 16 KB
constexpr int RSTRIP_THREADS = 544;  // 2 consumer and 2 quantizer warpgroups, a producer warp
constexpr int RSMEM_MAX = 227 * 1024;

// the weight ring's stages: as many as fit beside the two strips and the
// staging, at most 8
__host__ __device__ constexpr int rstrip_stages(int kb) {
  return (RSMEM_MAX - 2 * kb * S_TILE - 2 * RSTRIP_STAGE_OUT - 3072) / S_TILE < 8
             ? (RSMEM_MAX - 2 * kb * S_TILE - 2 * RSTRIP_STAGE_OUT - 3072) / S_TILE
             : 8;
}
constexpr int rstrip_smem(int kb) {
  return 2 * kb * S_TILE + rstrip_stages(kb) * S_TILE + 2 * RSTRIP_STAGE_OUT + 1024 +
         (2 * rstrip_stages(kb) + 8) * 8 + 2 * SBM * 4;
}
static_assert(rstrip_smem(RSTRIP_MAX_KB) <= RSMEM_MAX, "the row-strip kernel fits an SM");
static_assert(rstrip_stages(RSTRIP_MAX_KB) >= 2 * RSTRIP_MAX_KB,
              "the ring holds two tiles' K steps");

template <typename T, int KB>
__global__ void __launch_bounds__(RSTRIP_THREADS, 1)
rows_strip_q_kernel(const T* __restrict__ a, const __grid_constant__ TpPtrs amaxes, int m,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, int8_t* __restrict__ aq,
                    float* __restrict__ ascale, int M, int N, int K, int ldc, int groups) {
  constexpr int RS = rstrip_stages(KB);
  constexpr int STRIP = KB * S_TILE;   // one strip buffer
  constexpr int VEC = 16 / sizeof(T);  // values a 16-byte load brings
  constexpr int UNR = 8;               // loads a quantizer thread keeps in flight
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* strips = smem;                      // [2][KB][128][128] codes, swizzled
  unsigned char* ring = strips + 2 * STRIP;          // [stage][128][128] weight tiles
  unsigned char* staging = ring + RS * S_TILE;       // [2][2][64][32] int32, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * RSTRIP_STAGE_OUT);
  uint64_t* empty = full + RS;
  uint64_t* sfull = empty + RS;    // [buffer][half]: the half's codes are in
  uint64_t* sempty = sfull + 4;    // [buffer][half]: its products are done
  float* row_scale = reinterpret_cast<float*>(sempty + 4);  // [128]: the scale
  float* row_rcp = row_scale + SBM;                          // [128]: its reciprocal

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int nt = N / SBN, per = nt / groups, units = ((M + SBM - 1) / SBM) * groups;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(&sfull[i], 1);
      mbar_init(&sempty[i], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (c == 4) {  // the producer warp: one thread keeps the ring full
    if (tid != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n_lo = (u % groups) * per;
      for (int n = n_lo; n < n_lo + per; ++n)
        for (int kt = 0; kt < KB; ++kt, ++it) {
          const int s = it % RS;
          if (it >= RS) mbar_wait(&empty[s], ((it / RS) - 1) & 1);
          mbar_expect_tx(&full[s], S_TILE);
          tma_load_2d(ring + s * S_TILE, &tm_b, &full[s], kt * SBK, n * SBN);
        }
    }
    return;
  }

  if (c >= 2) {  // quantizer warpgroup q: rows 64 q .. 64 q + 63 of the strip
    const int q = c - 2, cpr = K / VEC;  // 16-byte loads a row
    float* sc = row_scale + 64 * q;
    float* rc = row_rcp + 64 * q;
    if (K % SBK) {  // the last K step's codes past K stay zero: 64 B of each row
      for (int i = tid; i < 2 * 64 * 4; i += 128) {
        const int b = i / 256, r = 64 * q + (i / 4) % 64, ch = 4 + i % 4;
        *reinterpret_cast<uint4*>(strips + b * STRIP + (KB - 1) * S_TILE + r * 128 +
                                  ((ch ^ (r & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    int ua = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ua) {
      const int b = ua & 1, r0 = (u / groups) * SBM + 64 * q, nrows = min(64, M - r0);
      const bool writer = u % groups == 0;  // the strip's codes and scales leave once
      unsigned char* strip = strips + b * STRIP + q * 64 * 128;
      if (ua >= 2) mbar_wait(&sempty[2 * b + q], ((ua >> 1) - 1) & 1);  // its products are done
      // rows past M (nrows < 64) keep stale codes: their products only
      // reach rows the stores clip
      if (tid < nrows) {
        const float s = tp_row_scale(amaxes, m, r0 + tid);
        sc[tid] = s;
        rc[tid] = __frcp_rn(s);
        if (writer) ascale[r0 + tid] = s;
      }
      named_barrier(3 + q, 128);
      const uint4* src = reinterpret_cast<const uint4*>(a + (long long)r0 * K);
      int8_t* dst = aq + (long long)r0 * K;
      const int total = max(nrows, 0) * cpr;
      for (int i0 = tid; i0 < total; i0 += 128 * UNR) {
        uint4 raw[UNR];
#pragma unroll
        for (int v = 0; v < UNR; ++v)
          if (i0 + 128 * v < total) raw[v] = src[i0 + 128 * v];
#pragma unroll
        for (int v = 0; v < UNR; ++v) {
          const int i = i0 + 128 * v;
          if (i >= total) break;
          const int r = i / cpr, k0 = (i - r * cpr) * VEC;
          const uint2 code = q_chunk<T>(raw[v], sc[r], rc[r]);
          // code byte k0 of row 64 q + r: K step k0 / 128, 16-byte chunk
          // (k0 % 128) / 16 at chunk ^ (r % 8) of the row's 128 B
          unsigned char* at = strip + (k0 >> 7) * S_TILE + r * 128 +
                              (((((k0 & 127) >> 4) ^ r) & 7) << 4) + (k0 & 15);
          if constexpr (VEC == 8) {
            *reinterpret_cast<uint2*>(at) = code;
            if (writer) *reinterpret_cast<uint2*>(dst + (long long)r * K + k0) = code;
          } else {
            *reinterpret_cast<uint32_t*>(at) = code.x;
            if (writer) *reinterpret_cast<uint32_t*>(dst + (long long)r * K + k0) = code.x;
          }
        }
      }
      fence_proxy_async();  // the codes, before consumer q's wgmma reads them
      named_barrier(3 + q, 128);
      if (tid == 0) mbar_arrive(&sfull[2 * b + q]);
    }
    return;
  }

  // consumer warpgroup c: rows 64 c .. 64 c + 63 of the strip
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  unsigned char* out_stage = staging + c * RSTRIP_STAGE_OUT;
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(evict_first));
  int it = 0, ua = 0;
  int acc[SBN / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ua) {
    const int b = ua & 1, n_lo = (u % groups) * per;
    const int r0 = (u / groups) * SBM + 64 * c;
    mbar_wait(&sfull[2 * b + c], (ua >> 1) & 1);
    for (int n = n_lo; n < n_lo + per; ++n) {
#pragma unroll
      for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
      int prev = -1;
#pragma unroll
      for (int kt = 0; kt < KB; ++kt) {
        const int s = it % RS;
        mbar_wait(&full[s], (it / RS) & 1);
        ++it;
        const uint64_t da = desc_sw128(strips + b * STRIP + kt * S_TILE + c * 64 * SBK);
        const uint64_t db = desc_sw128(ring + s * S_TILE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) {
        mbar_arrive(&empty[prev]);
        if (n == n_lo + per - 1) mbar_arrive(&sempty[2 * b + c]);  // the half may take new rows
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // columns 64 hf .. 64 hf + 63
        if (tid == 0) tma_store_wait<true>();  // the staging's last stores have read it
        named_barrier(1 + c, 128);
        // element (r, col) of the half: box col / 32, its 16-byte chunk
        // (col % 32) / 4 of row r's 128 bytes at chunk ^ (r % 8)
#pragma unroll
        for (int j = 8 * hf; j < 8 * hf + 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h, cc = (j & 3) * 8 + 2 * t;
            *reinterpret_cast<int2*>(out_stage + ((j >> 2) & 1) * (64 * 128) + r * 128 +
                                     ((((cc >> 2) ^ r) & 7) << 4) + (cc & 3) * 4) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        fence_proxy_async();
        named_barrier(1 + c, 128);
        if (tid == 0) {
#pragma unroll
          for (int bx = 0; bx < 2; ++bx) {  // boxes past ldc hold only the padded N edge
            const int col0 = n * SBN + 64 * hf + 32 * bx;
            if (col0 < ldc)
              tma_store_2d_hint(&tm_c, out_stage + bx * (64 * 128), col0, r0, evict_first);
          }
          tma_store_commit();
        }
      }
    }
  }
  if (tid == 0) tma_store_wait<false>();
}

int g_sm_count = 0;

// The persistent grid: one block an SM at most; units of 128 rows and
// `groups` runs of the N tiles (more than one only where the rows alone
// would leave SMs idle in the last round).
template <typename T, int KB>
cudaError_t launch_rows_strip_kernel(const T* a, const TpPtrs& am, int m, const CUtensorMap& tm_b,
                                     const CUtensorMap& tm_c, int8_t* aq, float* ascale, int M,
                                     int N, int K, int ldc, cudaStream_t st) {
  constexpr int smem = rstrip_smem(KB);
  static std::atomic<unsigned> sized{0};  // the devices this instantiation's size is set on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(sized.load(std::memory_order_relaxed) >> dev & 1u)) {
    e = cudaFuncSetAttribute(rows_strip_q_kernel<T, KB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized.fetch_or(1u << dev, std::memory_order_relaxed);
  }
  if (g_sm_count == 0) {
    e = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int mt = (M + SBM - 1) / SBM, nt = N / SBN;
  int groups = 1;
  while (groups < nt && mt * groups < 2 * g_sm_count) {
    int next = groups + 1;
    while (nt % next) ++next;
    groups = next;
  }
  const int units = mt * groups;
  rows_strip_q_kernel<T, KB><<<units < g_sm_count ? units : g_sm_count, RSTRIP_THREADS, smem, st>>>(
      a, am, m, tm_b, tm_c, aq, ascale, M, N, K, ldc, groups);
  return cudaGetLastError();
}

// Whether a slot's row-parallel product, K columns of codes into int32 rows
// of ldc, takes the row-strip kernel: K in whole 64-wide steps the strip
// holds (at most RSTRIP_MAX_KB 128-byte steps) and int32 rows of whole
// 16-byte units for the TMA stores.  The one statement of the rule:
// ops/fused_block_q.py::rows_route asks it (dvl_rows_strip_fits).
bool rows_strip_fits(int K, int ldc) {
  return K >= 64 && K % 64 == 0 && K <= RSTRIP_MAX_KB * SBK && ldc >= 1 && ldc % 4 == 0;
}

template <typename T>
cudaError_t launch_rows_strip(const T* a, const TpPtrs& am, int m, const int8_t* wt, int8_t* aq,
                              float* ascale, int* out, int M, int N, int K, int ldc,
                              cudaStream_t st) {
  if (M < 1 || N % SBN || !rows_strip_fits(K, ldc) || ldc > N || ldc <= N - SBN)
    return cudaErrorInvalidValue;
  CUtensorMap tm_b, tm_c;
  const uint64_t stride_b[1] = {(uint64_t)K}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box_b[2] = {SBK, SBN};
  const uint64_t stride_c[1] = {(uint64_t)ldc * 4}, dims_c[2] = {(uint64_t)ldc, (uint64_t)M};
  const uint32_t box_c[2] = {32, 64};
  cudaError_t e = make_tensor_map(&tm_b, wt, 2, dims_b, stride_b, box_b,
                                  CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess)
    e = make_tensor_map(&tm_c, out, 2, dims_c, stride_c, box_c, CU_TENSOR_MAP_DATA_TYPE_INT32);
  if (e != cudaSuccess) return e;
  const int kb = (K + SBK - 1) / SBK;
  if (kb == 1)
    return launch_rows_strip_kernel<T, 1>(a, am, m, tm_b, tm_c, aq, ascale, M, N, K, ldc, st);
  if (kb == 2)
    return launch_rows_strip_kernel<T, 2>(a, am, m, tm_b, tm_c, aq, ascale, M, N, K, ldc, st);
  return launch_rows_strip_kernel<T, 3>(a, am, m, tm_b, tm_c, aq, ascale, M, N, K, ldc, st);
}

// ---------------------------------------------------------------------------
// The one-call layer's QKV product (dvl_fused_layer_q) on a persistent s8
// wgmma GEMM that stores by TMA: qkv[M, N] = bf16(deq(A[M, K] @ Wt[N, K]^T)
// + bias), gemm_s8_kernel's EQ_BIAS.
//
// gemm_s8_kernel gives each 128x128 output tile a block of its own: at K =
// 768 the block runs six K steps behind a cold ring, then stages its s32
// tile in the freed ring and writes rows with plain stores before it exits.
// Here one block an SM walks the tiles blockIdx.x, + gridDim.x, ... in
// bands of `band` N tiles (m by m, the band's N tiles fastest: the band's
// weight rows, the whole weight at the layer's widths, stay in L2, and the
// tiles in flight at once share their A rows):
//   * a producer thread streams every tile's K steps, tile after tile,
//     through a ring of 6 stages of 32 KB by TMA, so the next tile's K steps
//     arrive while this one's epilogue runs (a cold ring for each tile, and
//     its epilogue's row stores, are what the s8 GEMM loses at K = 768);
//   * two consumer warpgroups (64 rows each) run wgmma m64n128k32 s8, then
//     dequantize their accumulators in registers with gemm_s8_kernel's
//     epilogue arithmetic, operation for operation (the same __fmul_rn /
//     __fadd_rn order, the same rounding: the int32 sums are exact in any K
//     order, so every output is bit for bit that kernel's), and write the
//     bf16 tile into a staging buffer of their own -- not the ring, which
//     holds the next tile -- as two [64][64] boxes under the 128-byte
//     swizzle (a warp's 4-byte writes of a column group spread over every
//     bank), which thread 0 sends out by TMA stores; it waits for their reads
//     only before the staging's next use, a tile later.
// The TMA clips the ragged M edge.  Measured on the layer's four products
// (PERF.md, the layer's designs): this design wins on the QKV product; on the out, up and
// down products its exposed epilogue (the f32 y, the f32 hidden's
// quick_gelu, the residual reads) lost to gemm_s8_kernel's two blocks an SM,
// as did ping-pong consumers, two persistent blocks an SM and 128 x 256
// tiles (the down product takes gemm_s8_epi_kernel, below).
// ---------------------------------------------------------------------------

constexpr int TG_STAGES = 6;                                   // the ring's 32 KB stages
constexpr int TG_BOX = 64 * 128;                               // a [64 rows][128 B] staging box
constexpr int TG_OUT = 64 * SBN * 2;                           // a warpgroup's bf16 staging
constexpr int TG_SMEM = TG_STAGES * 2 * S_TILE + 2 * TG_OUT + 1024 + 2 * TG_STAGES * 8;
constexpr long long TG_BAND_BYTES = 16ll << 20;  // the weight rows a band keeps in L2
static_assert(TG_SMEM <= 227 * 1024, "the ring and the staging fit an SM");

// Tile `tile` of the persistent walk: bands of `band` N tiles (the last band
// may be narrower), each walked m by m, its N tiles fastest.
__host__ __device__ __forceinline__ void tg_tile(int tile, int mt, int nt, int band, int& m0,
                                                 int& n0) {
  const int b = tile / (mt * band), first = b * band;
  const int w = nt - first < band ? nt - first : band, r = tile - b * mt * band;
  m0 = (r / w) * SBM;
  n0 = (first + r % w) * SBN;
}

// The byte of bf16 element (r, col) of a warpgroup's staging: box col / 64,
// row r at r 128 B, its 16-byte chunk (col % 64) / 8 at chunk ^ (r % 8)
// (the TMA's 128-byte swizzle).
__device__ __forceinline__ int tg_stage_offset(int r, int col) {
  return (col >> 6) * TG_BOX + r * 128 + (((((col & 63) >> 3) ^ r) & 7) << 4) + (col & 7) * 2;
}

__global__ void __launch_bounds__(SGEMM_THREADS, 1)
gemm_s8_tma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ a_scale,
                   const float* __restrict__ w_scale, const float* __restrict__ bias, int M, int N,
                   int K, int band) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem);                       // [stage][128][128]
  int8_t* sB = reinterpret_cast<int8_t*>(smem + TG_STAGES * S_TILE);  // [stage][128][128]
  unsigned char* staging = smem + 2 * TG_STAGES * S_TILE;             // [2][TG_OUT]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * TG_OUT);
  uint64_t* empty = full + TG_STAGES;

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int mt = (M + SBM - 1) / SBM, nt = N / SBN, tiles = mt * nt;
  const int nk = (K + SBK - 1) / SBK;  // a ragged last K step arrives zero-filled
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (c == 2) {  // the producer warp: one thread keeps the ring full
    if (tid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tg_tile(tile, mt, nt, band, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % TG_STAGES;
        if (it >= TG_STAGES) mbar_wait(&empty[s], ((it / TG_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * S_TILE);
        tma_load_2d(sA + s * S_TILE, &tm_a, &full[s], kt * SBK, m0);
        tma_load_2d(sB + s * S_TILE, &tm_b, &full[s], kt * SBK, n0);
      }
    }
    return;
  }

  // consumer warpgroup c: rows 64 c .. 64 c + 63 of each tile, all columns
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int rl = warp * 16 + g;  // this thread's rows rl, rl + 8 of the warpgroup's 64
  unsigned char* stage = staging + c * TG_OUT;
  int acc[SBN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tg_tile(tile, mt, nt, band, m0, n0);
#pragma unroll
    for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % TG_STAGES;
      mbar_wait(&full[s], (it / TG_STAGES) & 1);
      const uint64_t da = desc_sw128(sA + s * S_TILE + c * 64 * SBK);
      const uint64_t db = desc_sw128(sB + s * S_TILE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      fence_regs(acc);
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&empty[prev]);

    // Epilogue: thread (warp, g, t) holds rows rl, rl + 8 and columns 8 j +
    // 2 t (+ 1), j = 0 .. 15: bf16(deq + bias) as gemm_s8_kernel's EQ_BIAS.
    const int row0 = m0 + 64 * c;
    const long long gm = (long long)row0 + rl;
    const float rs[2] = {gm < M ? a_scale[gm] : 0.f, gm + 8 < M ? a_scale[gm + 8] : 0.f};
    if (tid == 0) tma_store_wait<true>();  // the staging's last stores have read it
    named_barrier(1 + c, 128);
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 cs = *reinterpret_cast<const float2*>(w_scale + n0 + col);
      const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float o0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), rs[h]), cs.x), bb.x);
        const float o1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), rs[h]), cs.y), bb.y);
        *reinterpret_cast<uint32_t*>(stage + tg_stage_offset(rl + 8 * h, col)) = pack_bf16(o0, o1);
      }
    }
    fence_proxy_async();  // the staging, before the TMA reads it
    named_barrier(1 + c, 128);
    if (tid == 0) {
      if (row0 < M) {
        tma_store_2d(&tm_c, stage, n0, row0);
        tma_store_2d(&tm_c, stage + TG_BOX, n0 + 64, row0);
      }
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait<false>();
}

// A band of N tiles whose weight rows (128 K bytes a tile) fit TG_BAND_BYTES.
int tg_band(int nt, int K) {
  const long long b = TG_BAND_BYTES / ((long long)SBN * K);
  return b < 1 ? 1 : (b > nt ? nt : (int)b);
}

// qkv [M, N] bf16 from A [M, K] and Wt [N, K] int8 (K % 16 == 0, N % 128
// == 0), a_scale [M], w_scale and bias [N] f32: gemm_s8_kernel<EQ_BIAS>'s
// output on the persistent TMA-store GEMM.
cudaError_t launch_gemm_s8_tma(const int8_t* A, const float* a_scale, const int8_t* Wt,
                               const float* w_scale, const float* bias, bf16* C, int M, int N,
                               int K, cudaStream_t st) {
  if (M < 1 || N % SBN || K % 16 || K < 16) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b, tm_c;
  const uint64_t stride_k[1] = {(uint64_t)K}, stride_c[1] = {(uint64_t)N * 2};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t dims_c[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t box[2] = {SBK, SBM}, box_c[2] = {64, 64};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess)
    e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = make_tensor_map(&tm_c, C, 2, dims_c, stride_c, box_c);
  if (e != cudaSuccess) return e;
  static std::atomic<unsigned> sized{0};  // the devices the kernel's size is set on
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(sized.load(std::memory_order_relaxed) >> dev & 1u)) {
    e = cudaFuncSetAttribute(gemm_s8_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TG_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized.fetch_or(1u << dev, std::memory_order_relaxed);
  }
  if (g_sm_count == 0) {
    e = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int nt = N / SBN, tiles = ((M + SBM - 1) / SBM) * nt;
  gemm_s8_tma_kernel<<<tiles < g_sm_count ? tiles : g_sm_count, SGEMM_THREADS, TG_SMEM, st>>>(
      tm_a, tm_b, tm_c, a_scale, w_scale, bias, M, N, K, tg_band(nt, K));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The one-call layer's down product (dvl_fused_layer_q) with its epilogue on
// warpgroups of its own: out[M, ldc] = bf16((y + b2) + deq(hq @ W2t^T)), y
// f32, gemm_s8_kernel's EQ_RESID32_BIAS, on the persistent tile walk above.
// At K = 3,072 the s8 GEMM's blocks spend 24 K steps on a tile and then an
// epilogue that reads 512 B of f32 y a row; here:
//   * a producer thread streams the tiles' K steps through a 4-stage ring;
//   * two consumer warpgroups (64 rows each) run wgmma m64n128k32 s8 and
//     dump the int32 accumulators into a half-tile buffer each (the f32 TMA
//     box layout, 32 KB), then go on to the next tile's products;
//   * two epilogue warpgroups take each half from there (a thread 8 columns
//     of 8 rows: the row's y in 32-byte reads, the columns' scales and
//     biases once a tile), dequantize and apply the epilogue operation for
//     operation as gemm_s8_kernel (the same __fmul_rn / __fadd_rn order: the
//     int32 sums are exact in any K order, so every output is bit for bit
//     that kernel's), stage the bf16 rows as two [64][64] boxes under the
//     128-byte swizzle and send them out by TMA stores; the buffer is handed
//     back once the stores have read it.
// Measured on the layer's other products (PERF.md) the same design
// lost: the out product's epilogue is short, the up product's quick_gelu
// over a 128x128 tile outlasts its products on two warpgroups.  The output
// rows must be whole 16-byte units (layer_down_fits).
// ---------------------------------------------------------------------------

constexpr int TE_THREADS = 544;        // 2 consumer + 2 epilogue warpgroups, a producer warp
constexpr int TE_STAGES = 4;           // the ring's 32 KB stages
constexpr int TE_HALF = 64 * SBN * 4;  // a half tile of int32: 32 KB
constexpr int TE_SMEM = TE_STAGES * 2 * S_TILE + 2 * TE_HALF + 2 * TG_OUT + 1024 + 256;
static_assert(TE_SMEM <= 227 * 1024, "the ring, the halves and the staging fit an SM");

// The byte of int32 element (r, col) of a half-tile buffer: [64][32] boxes
// under the 128-byte swizzle (the f32 TMA box layout).
__device__ __forceinline__ int te_half_offset(int r, int col) {
  return (col >> 5) * TG_BOX + r * 128 + (((((col & 31) >> 2) ^ r) & 7) << 4) + (col & 3) * 4;
}

__global__ void __launch_bounds__(TE_THREADS, 1)
gemm_s8_epi_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ a_scale,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   const float* __restrict__ resid, int M, int N, int K, int ldc, int band) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem);                       // [stage][128][128]
  int8_t* sB = reinterpret_cast<int8_t*>(smem + TE_STAGES * S_TILE);  // [stage][128][128]
  unsigned char* halves = smem + 2 * TE_STAGES * S_TILE;              // [2][64][128] int32
  unsigned char* staging = halves + 2 * TE_HALF;                      // [2][64][128] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * TG_OUT);
  uint64_t* empty = full + TE_STAGES;
  uint64_t* dumped = empty + TE_STAGES;  // [2]: consumer h's half is in its buffer
  uint64_t* freed = dumped + 2;          // [2]: epilogue h's stores have read the staging

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int mt = (M + SBM - 1) / SBM, nt = N / SBN, tiles = mt * nt;
  const int nk = (K + SBK - 1) / SBK;  // a ragged last K step arrives zero-filled
  if (threadIdx.x == 0) {
    for (int s = 0; s < TE_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&dumped[h], 1);
      mbar_init(&freed[h], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 4) {  // the producer warp: one thread keeps the ring full
    if (tid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tg_tile(tile, mt, nt, band, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % TE_STAGES;
        if (it >= TE_STAGES) mbar_wait(&empty[s], ((it / TE_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * S_TILE);
        tma_load_2d(sA + s * S_TILE, &tm_a, &full[s], kt * SBK, m0);
        tma_load_2d(sB + s * S_TILE, &tm_b, &full[s], kt * SBK, n0);
      }
    }
    return;
  }

  if (wg < 2) {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    unsigned char* half = halves + wg * TE_HALF;
    int acc[SBN / 2];
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
#pragma unroll
      for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % TE_STAGES;
        mbar_wait(&full[s], (it / TE_STAGES) & 1);
        const uint64_t da = desc_sw128(sA + s * S_TILE + wg * 64 * SBK);
        const uint64_t db = desc_sw128(sB + s * S_TILE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        fence_regs(acc);
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);
      if (ti > 0) mbar_wait(&freed[wg], (ti - 1) & 1);  // the epilogue has read the last half
#pragma unroll
      for (int j = 0; j < SBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(half + te_half_offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      named_barrier(1 + wg, 128);
      if (tid == 0) mbar_arrive(&dumped[wg]);
    }
    return;
  }

  // epilogue warpgroup e: the half of consumer e; thread (cg, rr): columns
  // 8 cg .. 8 cg + 7 of rows rr, rr + 8, ..., rr + 56
  const int e = wg - 2, cg = tid & 15, rr = tid >> 4;
  const unsigned char* half = halves + e * TE_HALF;
  unsigned char* stage = staging + e * TG_OUT;
  int ti = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    int m0, n0;
    tg_tile(tile, mt, nt, band, m0, n0);
    const int n = n0 + 8 * cg, row0 = m0 + 64 * e;
    float cs[8], bb[8];
    *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(w_scale + n);
    *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(w_scale + n + 4);
    *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
    mbar_wait(&dumped[e], ti & 1);
#pragma unroll 2
    for (int k = 0; k < 8; ++k) {
      const int r = rr + 8 * k;
      const long long m = (long long)row0 + r;
      const float rs = m < M ? a_scale[m] : 0.f;
      int a[8];
      *reinterpret_cast<int4*>(a) = *reinterpret_cast<const int4*>(half + te_half_offset(r, 8 * cg));
      *reinterpret_cast<int4*>(a + 4) =
          *reinterpret_cast<const int4*>(half + te_half_offset(r, 8 * cg + 4));
      float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (m < M && n < ldc) {  // ldc % 8 == 0: the 8 columns are in or out together
        *reinterpret_cast<float4*>(y) = *reinterpret_cast<const float4*>(resid + m * ldc + n);
        *reinterpret_cast<float4*>(y + 4) =
            *reinterpret_cast<const float4*>(resid + m * ldc + n + 4);
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * i + h;
          const float d = __fmul_rn(__fmul_rn(__int2float_rn(a[c]), rs), cs[c]);
          o[h] = __fadd_rn(__fadd_rn(y[c], bb[c]), d);
        }
        pw[i] = pack_bf16(o[0], o[1]);
      }
      if (k == 0 && tid == 0) tma_store_wait<true>();  // the staging's last stores have read it
      if (k == 0) named_barrier(3 + e, 128);
      *reinterpret_cast<uint4*>(stage + tg_stage_offset(r, 8 * cg)) = packed;
    }
    named_barrier(3 + e, 128);  // every thread has read its half: hand it back
    if (tid == 0) mbar_arrive(&freed[e]);
    fence_proxy_async();  // the staging, before the TMA reads it
    named_barrier(3 + e, 128);
    if (tid == 0) {
      if (row0 < M) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (n0 + 64 * b < ldc) tma_store_2d(&tm_c, stage + b * TG_BOX, n0 + 64 * b, row0);
      }
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait<false>();
}

// Whether the one-call layer at model width D runs its down product on
// gemm_s8_epi_kernel: the bf16 output rows and the f32 y rows of D must be
// whole 16-byte units for the TMA stores and the epilogue's 8-column reads.
// Other widths take gemm_s8_kernel.  The one statement of the rule:
// ops/fused_block_q.py::layer_route asks it (dvl_layer_down_fits).
bool layer_down_fits(int D) { return D >= 8 && D % 8 == 0; }

// out [M, ldc] bf16 = bf16((y + bias) + deq(A @ Wt^T)) from A [M, K] and Wt
// [N, K] int8 (K % 16 == 0, N % 128 == 0, N - 128 < ldc <= N,
// layer_down_fits(ldc)), y [M, ldc] f32: gemm_s8_kernel<EQ_RESID32_BIAS>'s
// output on the epilogue-warpgroup GEMM.
cudaError_t launch_gemm_s8_epi(const int8_t* A, const float* a_scale, const int8_t* Wt,
                               const float* w_scale, const float* bias, const float* y, bf16* C,
                               int M, int N, int K, int ldc, cudaStream_t st) {
  if (M < 1 || N % SBN || K % 16 || K < 16 || ldc > N || ldc <= N - SBN || !layer_down_fits(ldc))
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b, tm_c;
  const uint64_t stride_k[1] = {(uint64_t)K}, stride_c[1] = {(uint64_t)ldc * 2};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t dims_c[2] = {(uint64_t)ldc, (uint64_t)M};
  const uint32_t box[2] = {SBK, SBM}, box_c[2] = {64, 64};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess)
    e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = make_tensor_map(&tm_c, C, 2, dims_c, stride_c, box_c);
  if (e != cudaSuccess) return e;
  static std::atomic<unsigned> sized{0};  // the devices the kernel's size is set on
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(sized.load(std::memory_order_relaxed) >> dev & 1u)) {
    e = cudaFuncSetAttribute(gemm_s8_epi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TE_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized.fetch_or(1u << dev, std::memory_order_relaxed);
  }
  if (g_sm_count == 0) {
    e = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int nt = N / SBN, tiles = ((M + SBM - 1) / SBM) * nt;
  gemm_s8_epi_kernel<<<tiles < g_sm_count ? tiles : g_sm_count, TE_THREADS, TE_SMEM, st>>>(
      tm_a, tm_b, tm_c, a_scale, w_scale, bias, y, M, N, K, ldc, tg_band(nt, K));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4's F-split down product (KB (a) 7) on the epilogue-warpgroup GEMM:
// out[M, ldc] = bf16((x + b2) + sum_c deq_c), deq_c = (acc_c * hs[m, c]) *
// s2, acc_c the exact int32 sum of the hidden's chunk c (chunk_steps K
// steps; each chunk quantized with its own row scales, hs [M, K / (128
// chunk_steps)]), the deq_c summed in f32 in chunk order from 0, x bf16:
// gemm_s8_kernel's EQ_RESID_BIAS_CHUNK, operation for operation.  That
// kernel keeps the f32 sum beside the int32 accumulators and so runs one
// block an SM at 168 registers, without the two blocks' overlap of one
// tile's epilogue with another's products.  Here gemm_s8_epi_kernel's walk
// and warps, with the sum on the epilogue warpgroups:
//   * the consumers run the K loop and, at each chunk's last K step, wait
//     for its products, hand the stage back, dump the chunk's int32 tile
//     into their half buffer (once the epilogue has read the last one) and
//     start the next chunk from zero: k hand-offs a tile, the barriers'
//     phases counted over hand-offs, not tiles;
//   * each epilogue thread folds each chunk into the f32 sums of its 8
//     columns of 8 rows: columns 4-7 in registers, columns 0-3 in shared
//     memory, in the 16-byte unit its bf16 row (r, 8 cg .. + 7) takes in
//     the output staging (tc_sum_offset), so the shared memory is
//     gemm_s8_epi_kernel's.  All 64 sums in registers beside the chunk's
//     codes outgrow the 96 registers ptxas grants 544 threads (they spilled
//     464 bytes a thread; 120 a thread do not launch: 5 of the 17 warps
//     share a quarter of the register file; this split still spills 268),
//     and all of them in shared memory leave room for a 3-stage ring only
//     (0.335 ms against this design's 0.306-0.326 at fb = 1,536 on the
//     same card, PERF.md).
//     After the last chunk the thread adds the residual and bias and writes
//     its bf16 row over its own sums' unit; the rows go out by TMA stores
//     as gemm_s8_epi_kernel's.
// Each chunk moves its int32 tile through shared memory twice (the dump,
// the fold's read) beside the products' operand reads: with the fold taken
// out the kernel takes 0.262 ms at fb = 1,536 and 0.289 at 768 against
// 0.307 and 0.422 (ViT-B/16 B=256 on an NVIDIA H100 80GB HBM3 at 700 W,
// fsplit_chunk_ablation.py), so the fold is what a chunk costs, and short
// chunks lose (fsplit_down_fits).  The output rows must be whole 16-byte
// units and each chunk whole K steps.
// ---------------------------------------------------------------------------

// The byte of f32 sum (r, col), col % 8 < 4, of an epilogue warpgroup's
// shared sums: the staging's 16-byte unit of (r, col & ~7), the unit whose
// bf16 row the same thread stages.
__device__ __forceinline__ int tc_sum_offset(int r, int col) {
  return tg_stage_offset(r, col & ~7) + (col & 3) * 4;
}

__global__ void __launch_bounds__(TE_THREADS, 1)
gemm_s8_epi_chunk_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ a_scale,
                         const float* __restrict__ w_scale, const float* __restrict__ bias,
                         const bf16* __restrict__ resid, int M, int N, int K, int ldc,
                         int chunk_steps, int band) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem);                       // [stage][128][128]
  int8_t* sB = reinterpret_cast<int8_t*>(smem + TE_STAGES * S_TILE);  // [stage][128][128]
  unsigned char* halves = smem + 2 * TE_STAGES * S_TILE;              // [2][64][128] int32
  unsigned char* sums = halves + 2 * TE_HALF;  // [2]: f32 columns 0-3 of each group, the staging
  uint64_t* full = reinterpret_cast<uint64_t*>(sums + 2 * TG_OUT);
  uint64_t* empty = full + TE_STAGES;
  uint64_t* dumped = empty + TE_STAGES;  // [2]: consumer h's chunk is in its buffer
  uint64_t* freed = dumped + 2;          // [2]: epilogue h has read that buffer

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int mt = (M + SBM - 1) / SBM, nt = N / SBN, tiles = mt * nt;
  const int nk = K / SBK, nchunks = nk / chunk_steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TE_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&dumped[h], 1);
      mbar_init(&freed[h], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 4) {  // the producer warp: one thread keeps the ring full
    if (tid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tg_tile(tile, mt, nt, band, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % TE_STAGES;
        if (it >= TE_STAGES) mbar_wait(&empty[s], ((it / TE_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * S_TILE);
        tma_load_2d(sA + s * S_TILE, &tm_a, &full[s], kt * SBK, m0);
        tma_load_2d(sB + s * S_TILE, &tm_b, &full[s], kt * SBK, n0);
      }
    }
    return;
  }

  if (wg < 2) {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    unsigned char* half = halves + wg * TE_HALF;
    int acc[SBN / 2];
#pragma unroll
    for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
    int it = 0, hand = 0;  // K steps and chunk hand-offs so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % TE_STAGES;
        mbar_wait(&full[s], (it / TE_STAGES) & 1);
        const uint64_t da = desc_sw128(sA + s * S_TILE + wg * 64 * SBK);
        const uint64_t db = desc_sw128(sB + s * S_TILE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SBK / 32; ++kk) wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        fence_regs(acc);
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if ((kt + 1) % chunk_steps) continue;
        // the chunk's last K step: its products done, the stage handed back,
        // the int32 tile dumped once the epilogue has read the last one
        wgmma_wait<0>();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(&empty[prev]);
        prev = -1;
        if (hand > 0) mbar_wait(&freed[wg], (hand - 1) & 1);
#pragma unroll
        for (int j = 0; j < SBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(half + te_half_offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        named_barrier(1 + wg, 128);
        if (tid == 0) mbar_arrive(&dumped[wg]);
        ++hand;
#pragma unroll
        for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
        fence_regs(acc);
      }
    }
    return;
  }

  // epilogue warpgroup e: the chunks of consumer e; thread (cg, rr): columns
  // 8 cg .. 8 cg + 7 of rows rr, rr + 8, ..., rr + 56
  const int e = wg - 2, cg = tid & 15, rr = tid >> 4;
  const unsigned char* half = halves + e * TE_HALF;
  unsigned char* stage = sums + e * TG_OUT;  // the sums of columns 0-3, then the bf16 rows
  int hand = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tg_tile(tile, mt, nt, band, m0, n0);
    const int n = n0 + 8 * cg, row0 = m0 + 64 * e;
    float cs[8];
    *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(w_scale + n);
    *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(w_scale + n + 4);
    float hi[8][4];  // the sums of columns 4-7, rows rr + 8 k: from 0, as the s8 GEMM's
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[k][i] = 0.f;
    if (tid == 0) tma_store_wait<true>();  // the last tile's stores have read the staging
    named_barrier(3 + e, 128);
    for (int c = 0; c < nchunks; ++c, ++hand) {
      mbar_wait(&dumped[e], hand & 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = rr + 8 * k;
        const long long m = (long long)row0 + r;
        const float rs = m < M ? a_scale[m * nchunks + c] : 0.f;
        int a[8];
        *reinterpret_cast<int4*>(a) = *reinterpret_cast<const int4*>(half + te_half_offset(r, 8 * cg));
        *reinterpret_cast<int4*>(a + 4) =
            *reinterpret_cast<const int4*>(half + te_half_offset(r, 8 * cg + 4));
        float4* lo = reinterpret_cast<float4*>(stage + tc_sum_offset(r, 8 * cg));
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (c > 0) *reinterpret_cast<float4*>(v) = *lo;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = __fadd_rn(v[i], __fmul_rn(__fmul_rn(__int2float_rn(a[i]), rs), cs[i]));
          hi[k][i] = __fadd_rn(hi[k][i],
                               __fmul_rn(__fmul_rn(__int2float_rn(a[4 + i]), rs), cs[4 + i]));
        }
        *lo = *reinterpret_cast<const float4*>(v);
      }
      named_barrier(3 + e, 128);  // every thread has read the chunk: hand the buffer back
      if (tid == 0) mbar_arrive(&freed[e]);
    }
    float bb[8];
    *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = rr + 8 * k;
      const long long m = (long long)row0 + r;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (m < M && n < ldc) {  // ldc % 8 == 0: the 8 columns are in or out together
        const uint4 raw = *reinterpret_cast<const uint4*>(resid + m * ldc + n);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f2 = __bfloat1622float2(p[i]);
          x[2 * i] = f2.x;
          x[2 * i + 1] = f2.y;
        }
      }
      uint4* lo = reinterpret_cast<uint4*>(stage + tc_sum_offset(r, 8 * cg));
      float v[8];
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 + i] = hi[k][i];
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[i] = pack_bf16(__fadd_rn(__fadd_rn(x[2 * i], bb[2 * i]), v[2 * i]),
                          __fadd_rn(__fadd_rn(x[2 * i + 1], bb[2 * i + 1]), v[2 * i + 1]));
      *lo = packed;  // the staging unit (r, 8 cg): this thread's own sums, read above
    }
    fence_proxy_async();  // the staging, before the TMA reads it
    named_barrier(3 + e, 128);
    if (tid == 0) {
      if (row0 < M) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (n0 + 64 * b < ldc) tma_store_2d(&tm_c, stage + b * TG_BOX, n0 + 64 * b, row0);
      }
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait<false>();
}

// Whether K4's F-split at model width D with hidden chunks of `chunk`
// padded columns runs its down product on gemm_s8_epi_chunk_kernel: the
// bf16 output and residual rows whole 16-byte units (layer_down_fits) and
// each chunk whole K steps, at least FSPLIT_MIN_STEPS of them.  Each chunk's
// hand-off costs the consumers a drained pipeline and a dump: at ViT-B/16
// B=256 the kernel won over gemm_s8_kernel's chunked mode at chunks of 1,536
// and 1,024 columns and lost at 768 (PERF.md).  Other shapes take
// gemm_s8_kernel's EQ_RESID_BIAS_CHUNK.  The one statement of the rule:
// ops/fused_block_q.py::fsplit_route asks it (dvl_fsplit_down_fits).
constexpr int FSPLIT_MIN_STEPS = 8;

bool fsplit_down_fits(int D, int chunk) {
  return layer_down_fits(D) && chunk % SBK == 0 && chunk >= FSPLIT_MIN_STEPS * SBK;
}

// out [M, ldc] bf16 = bf16((x + bias) + sum_c deq_c) from A [M, K] and Wt
// [N, K] int8 (N % 128 == 0, N - 128 < ldc <= N, K = nchunks chunk,
// fsplit_down_fits(ldc, chunk)), a_scale [M, nchunks], x [M, ldc] bf16:
// gemm_s8_kernel<EQ_RESID_BIAS_CHUNK>'s output on the epilogue-warpgroup
// GEMM.
cudaError_t launch_gemm_s8_epi_chunk(const int8_t* A, const float* a_scale, const int8_t* Wt,
                                     const float* w_scale, const float* bias, const bf16* x,
                                     bf16* C, int M, int N, int K, int chunk, int ldc,
                                     cudaStream_t st) {
  if (M < 1 || N % SBN || chunk < 1 || K % chunk || ldc > N || ldc <= N - SBN ||
      !fsplit_down_fits(ldc, chunk))
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b, tm_c;
  const uint64_t stride_k[1] = {(uint64_t)K}, stride_c[1] = {(uint64_t)ldc * 2};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t dims_c[2] = {(uint64_t)ldc, (uint64_t)M};
  const uint32_t box[2] = {SBK, SBM}, box_c[2] = {64, 64};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess)
    e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride_k, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = make_tensor_map(&tm_c, C, 2, dims_c, stride_c, box_c);
  if (e != cudaSuccess) return e;
  static std::atomic<unsigned> sized{0};  // the devices the kernel's size is set on
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(sized.load(std::memory_order_relaxed) >> dev & 1u)) {
    e = cudaFuncSetAttribute(gemm_s8_epi_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, TE_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized.fetch_or(1u << dev, std::memory_order_relaxed);
  }
  if (g_sm_count == 0) {
    e = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int nt = N / SBN, tiles = ((M + SBM - 1) / SBM) * nt;
  gemm_s8_epi_chunk_kernel<<<tiles < g_sm_count ? tiles : g_sm_count, TE_THREADS, TE_SMEM, st>>>(
      tm_a, tm_b, tm_c, a_scale, w_scale, bias, x, M, N, K, ldc, chunk / SBK, tg_band(nt, K));
  return cudaGetLastError();
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
int attention_block_q_impl(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                           const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                           const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                           void* attn, void* aq, void* ascale, int B, int S, int D, int heads,
                           int hdp, float scale, int causal, int variant, void* stream,
                           void* qq_ws = nullptr, int tma = 0) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, 64), DA = heads * hdp, NQKV = round_up(3 * DA, SBN);
  const int NO = round_up(D, SBN);
  if (variant != AQ_K3 && causal) return (int)cudaErrorInvalidValue;
  if (D < 1 || heads < 1 || D % heads || hdp < 64 || hdp % 64 || DA < D)
    return (int)cudaErrorInvalidValue;
  if (tma && variant != AQ_POSTDIV) return (int)cudaErrorInvalidValue;
  const bool recip = variant == AQ_VAR, mxu = variant == AQ_ATTR_MXU, vpu = variant == AQ_ATTR_VPU;
  cudaError_t e;
  if (mxu) {
    e = launch_cast_s8<true>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                             static_cast<float*>(xs), M, D, st, DK);
  } else if (tma) {  // xn not written
    e = launch_ln_quant(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                        static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), nullptr, M, D, DK, st);
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
    const int8_t* ixq = static_cast<const int8_t*>(xq);
    const float *fxs = static_cast<const float*>(xs), *fsqkv = static_cast<const float*>(sqkv),
                *fbqkv = static_cast<const float*>(bqkv);
    const int8_t* wqkv = static_cast<const int8_t*>(wqkv_t);
    e = tma ? launch_gemm_s8_tma(ixq, fxs, wqkv, fsqkv, fbqkv, static_cast<bf16*>(qkv), M, NQKV,
                                 DK, st)
            : launch_gemm_s8<EQ_BIAS>(ixq, fxs, wqkv, fsqkv, fbqkv, nullptr, qkv, M, NQKV, DK, st);
    if (e != cudaSuccess) return (int)e;
    const bf16* q3 = static_cast<const bf16*>(qkv);
    bf16* a = static_cast<bf16*>(attn);
    e = tma ? launch_attention_wgmma<true>(q3, a, B, S, heads, hdp, causal, st, NQKV, scale, 2)
            : launch_attention_wgmma(q3, a, B, S, heads, hdp, causal, st, NQKV, scale,
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
  else
    e = launch_gemm_s8<EQ_BIAS_RESID>(static_cast<const int8_t*>(aq),
                                      static_cast<const float*>(ascale),
                                      static_cast<const int8_t*>(wo_t),
                                      static_cast<const float*>(so), static_cast<const float*>(bo),
                                      x, out, M, NO, DA, st, nullptr, 0, D);
  return (int)e;
}

// ---------------------------------------------------------------------------
// The quantize passes of K4's F-split and KB (a) 2, 16 bytes a load.  One
// block of QR_THREADS threads a row, as quant_rows_kernel, each thread PV
// 16-byte units of the row (thread t the units t, t + 128, ...: a warp's
// loads coalesce), held in registers from one read: the row's amax, the
// scale q_scale_nan(amax) and the codes, written 4 (f32) or 8 (bf16) at a
// time.  The codes are quant_rows_kernel's: the IEEE quotient (q_code:
// qq_div's corrected reciprocal product where the row's scale is finite,
// __fdiv_rn where it is not; one branch a row), rounded half to even,
// clamped to +-127, a NaN quotient to 0.
//   * quant_rows_x4_kernel: the F-split's f32 hidden chunks past 1,024
//     columns (fb = 1,536 at ViT-B/16, SigLIP's 1,076 padded to 1,152),
//     which quant_rows_kernel's 32-slot tier held at 12 or 9 live values a
//     thread.  Bytes-bound: 5 bytes a value.
//   * qgelu_quant_rows_kernel: KB (a) 2's bf16 pre-activation u, quick_gelu
//     (common.cuh, the same expression) of each value after the load, the
//     codes of those f32 values; act_out (if not null) receives them as f32.
//     The element-by-element pass it replaces loaded 2 bytes at a time and
//     divided each value by __fdiv_rn.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_max_nan(float amax, float* red) {
  amax = warp_max_nan(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmax_nan(amax, red[w]);
  return amax;
}

template <int PV>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_x4_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int n) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
  const int n4 = n >> 2;
  uint4 v[PV];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PV; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    v[j] = i < n4 ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
    const float* f = reinterpret_cast<const float*>(&v[j]);
    amax = fmax_nan(amax, fmax_nan(fmax_nan(fabsf(f[0]), fabsf(f[1])),
                                   fmax_nan(fabsf(f[2]), fabsf(f[3]))));
  }
  const float s = q_scale_nan(block_max_nan(amax, red));
  const float rs = __frcp_rn(s);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * n);
  if (s < INFINITY) {
#pragma unroll
    for (int j = 0; j < PV; ++j)
      if (threadIdx.x + j * QR_THREADS < n4)
        qr[threadIdx.x + j * QR_THREADS] = q_chunk_as<float, true>(v[j], s, rs).x;
  } else {
#pragma unroll
    for (int j = 0; j < PV; ++j)
      if (threadIdx.x + j * QR_THREADS < n4)
        qr[threadIdx.x + j * QR_THREADS] = q_chunk_as<float, false>(v[j], s, rs).x;
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <int PV, bool FAST>
__device__ __forceinline__ void qgelu_codes(const float (&v)[PV][8], uint2* qr, float s, float rs,
                                            int n8) {
#pragma unroll
  for (int j = 0; j < PV; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    if (i >= n8) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c >> 2] |= q_code<FAST>(v[j][c], s, rs) << (8 * (c & 3));
    qr[i] = make_uint2(w[0], w[1]);
  }
}

template <int PV>
__global__ void __launch_bounds__(QR_THREADS)
qgelu_quant_rows_kernel(const bf16* __restrict__ u, int8_t* __restrict__ q,
                        float* __restrict__ scale, float* __restrict__ act_out, int n) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const uint4* ur = reinterpret_cast<const uint4*>(u + row * n);
  const int n8 = n >> 3;
  float v[PV][8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PV; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    const uint4 raw = i < n8 ? ur[i] : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(p[c]);
      v[j][2 * c] = quick_gelu(f.x);  // quick_gelu(0) = 0: a unit past the row adds nothing
      v[j][2 * c + 1] = quick_gelu(f.y);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) amax = fmax_nan(amax, fabsf(v[j][c]));
    if (act_out != nullptr && i < n8) {
      float4* a = reinterpret_cast<float4*>(act_out + row * n) + 2 * i;
      a[0] = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
      a[1] = make_float4(v[j][4], v[j][5], v[j][6], v[j][7]);
    }
  }
  const float s = q_scale_nan(block_max_nan(amax, red));
  const float rs = __frcp_rn(s);
  uint2* qr = reinterpret_cast<uint2*>(q + row * n);
  if (s < INFINITY)  // the branch a row, not a value
    qgelu_codes<PV, true>(v, qr, s, rs, n8);
  else
    qgelu_codes<PV, false>(v, qr, s, rs, n8);
  if (threadIdx.x == 0) scale[row] = s;
}

// The F-split's hidden chunks: k rows of n = F / k per row of h (rows = M k).
// Chunks past 1,024 columns (n % 4 == 0 there: chunks are multiples of 128)
// take quant_rows_x4_kernel; the others quant_rows_kernel's tiers, K4's.
cudaError_t launch_quant_chunks(const float* h, int8_t* q, float* scale, int rows, int n,
                                cudaStream_t st) {
  if (n <= 8 * QR_THREADS || n > 16 * QR_THREADS || n % 4)
    return launch_quant_rows(h, q, scale, rows, n, st);
  if (n <= 12 * QR_THREADS)
    quant_rows_x4_kernel<3><<<rows, QR_THREADS, 0, st>>>(h, q, scale, n);
  else
    quant_rows_x4_kernel<4><<<rows, QR_THREADS, 0, st>>>(h, q, scale, n);
  return cudaGetLastError();
}

// KB (a) 2's hidden: hq, hs from quick_gelu of u [rows, n] bf16 (n % 8 ==
// 0), g [rows, n] f32 the activations if not null.  Rows past 5,120 values
// (40 a thread) take quant_rows_kernel's QGELU passes.
cudaError_t launch_qgelu_quant(const bf16* u, int8_t* q, float* scale, float* g, int rows, int n,
                               cudaStream_t st) {
  const int units = n / 8;
  if (n % 8 || units > 5 * QR_THREADS)
    return launch_quant_rows_mode<false, true>(u, q, scale, g, rows, n, st);
  if (units <= QR_THREADS)
    qgelu_quant_rows_kernel<1><<<rows, QR_THREADS, 0, st>>>(u, q, scale, g, n);
  else if (units <= 2 * QR_THREADS)
    qgelu_quant_rows_kernel<2><<<rows, QR_THREADS, 0, st>>>(u, q, scale, g, n);
  else if (units <= 3 * QR_THREADS)
    qgelu_quant_rows_kernel<3><<<rows, QR_THREADS, 0, st>>>(u, q, scale, g, n);
  else if (units <= 4 * QR_THREADS)
    qgelu_quant_rows_kernel<4><<<rows, QR_THREADS, 0, st>>>(u, q, scale, g, n);
  else
    qgelu_quant_rows_kernel<5><<<rows, QR_THREADS, 0, st>>>(u, q, scale, g, n);
  return cudaGetLastError();
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
// (the quantize pass over the [M k, F / k] view of h, launch_quant_chunks;
// hs [M, k]), and the down product's K loop folding each chunk's int32 sum
// into an f32 sum with that chunk's row scales (EQ_RESID_BIAS_CHUNK).
// The F-split and MQ_BF16H open with one pass that normalises x and
// quantizes it (ln_quant_rows_kernel: K4's codes and scales bit for bit;
// xn is not written and may be null), four launches.  tma 1: the F-split's
// down product on gemm_s8_epi_chunk_kernel where fsplit_down_fits(D, F /
// k), MQ_BF16H's up product on gemm_s8_tma_kernel; tma 0 (the checks'
// route): both on gemm_s8_kernel.  The same outputs bit for bit.
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
                     void* stream, int k = 1, int fv = 0, int tma = 0) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, 64), NO = round_up(D, SBN);
  if (variant != MQ_K4 && act_kind != 0) return (int)cudaErrorInvalidValue;
  if (k < 1 || F % k || (F / k) % SBK) return (int)cudaErrorInvalidValue;
  if (k > 1 && variant != MQ_K4) return (int)cudaErrorInvalidValue;
  const bool recip = variant == MQ_VAR || variant == MQ_VAR_BF16_GELU;
  const bool mxu = variant == MQ_ATTR_MXU, vpu = variant == MQ_ATTR_VPU;
  const bool var_ln = recip && tma;  // KB (a) 3: LayerNorm and the reciprocal quantize in one
  const bool ln_quant = k > 1 || variant == MQ_BF16H;
  const int8_t* w1 = static_cast<const int8_t*>(w1_t);
  const float *fs1 = static_cast<const float*>(s1), *fb1 = static_cast<const float*>(b1);
  const float* fxs = static_cast<const float*>(xs);
  const int8_t* ixq = static_cast<const int8_t*>(xq);
  cudaError_t e;
  if (mxu) {
    e = launch_cast_s8<true>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                             static_cast<float*>(xs), M, D, st, DK);
  } else if (var_ln) {  // the reciprocal codes
    e = launch_ln_quant<true>(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                              static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                              static_cast<float*>(xs), nullptr, M, D, DK, st);
  } else if (ln_quant) {
    e = launch_ln_quant(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                        static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), nullptr, M, D, DK, st);
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
      e = tma ? launch_gemm_s8_tma(ixq, fxs, w1, fs1, fb1, static_cast<bf16*>(h), M, F, DK, st)
              : launch_gemm_s8<EQ_BIAS>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, F, DK, st);
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
    e = launch_qgelu_quant(static_cast<const bf16*>(h), static_cast<int8_t*>(hq),
                           static_cast<float*>(hs), static_cast<float*>(g), M, F, st);
  else if (recip)
    e = launch_quant_rows_mode<true, false>(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                                            static_cast<float*>(hs), nullptr, M, F, st);
  else if (k > 1)  // k rows of F / k per row of h
    e = launch_quant_chunks(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                            static_cast<float*>(hs), M * k, F / k, st);
  else
    e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                          static_cast<float*>(hs), M, F, st);
  if (e != cudaSuccess) return (int)e;
  const int8_t* ihq = static_cast<const int8_t*>(hq);
  const float *fhs = static_cast<const float*>(hs), *fs2 = static_cast<const float*>(s2),
              *fb2 = static_cast<const float*>(b2);
  const int8_t* w2 = static_cast<const int8_t*>(w2_t);
  if (vpu)
    e = launch_bcast_rows<EQ_RESID_BIAS>(ihq, fhs, F, fb2, x, out, M, D, st);
  else if (k > 1 && tma && fsplit_down_fits(D, F / k))
    e = launch_gemm_s8_epi_chunk(ihq, fhs, w2, fs2, fb2, static_cast<const bf16*>(x),
                                 static_cast<bf16*>(out), M, NO, F, F / k, D, st);
  else if (k > 1)
    e = launch_gemm_s8<EQ_RESID_BIAS_CHUNK>(ihq, fhs, w2, fs2, fb2, x, out, M, NO, F, st, nullptr,
                                            F / k / SBK, D);
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
                                stream, ws);
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

// tma 1: LayerNorm and the quantize pass of x in one (ln_quant_rows_kernel,
// xn not written), the QKV product on the persistent TMA-store GEMM, the
// core's divide-after instantiation (qq_div), five launches; tma 0 (the
// checks' route): K3's six launches with norm_after = 2.  The same outputs
// bit for bit.
int dvl_attention_block_q_postdiv(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv_t, const void* sqkv, const void* bqkv,
                                  const void* wo_t, const void* so, const void* bo, void* out,
                                  void* xn, void* xq, void* xs, void* qkv, void* attn, void* aq,
                                  void* ascale, int B, int S, int D, int heads, int hdp, int causal,
                                  float scale, int tma, void* stream) {
  return attention_block_q_impl(x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, bo, out, xn, xq, xs,
                                qkv, attn, aq, ascale, B, S, D, heads, hdp, scale, causal,
                                AQ_POSTDIV, stream, nullptr, tma);
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
// [M, k]; xn unwritten, tma 1 the down product on the epilogue-warpgroup
// GEMM where fsplit_down_fits); F is the padded hidden width, k chunks of fb
// rounded up to 128.
int dvl_mlp_block_q(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                    const void* s1, const void* b1, const void* w2_t, const void* s2,
                    const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                    void* hs, int tma, int M, int D, int F, int act_kind, int k, void* stream) {
  return mlp_block_q_impl(x, ln_s, ln_b, w1_t, s1, b1, w2_t, s2, b2, out, xn, xq, xs, h, hq, hs,
                          nullptr, M, D, F, act_kind, MQ_K4, stream, k, 0, tma);
}

// 1 where K4's F-split at model width D with padded hidden chunks of
// `chunk` columns runs its down product on the epilogue-warpgroup GEMM
// (fsplit_down_fits), else 0.
int dvl_fsplit_down_fits(int D, int chunk) { return fsplit_down_fits(D, chunk); }

// The one-call int8 layer of benchmarks/q_layer_fused.py (layer_kernel),
// nine launches: LayerNorm and the quantize pass of x in one
// (ln_quant_rows_kernel: K3's codes and scales, its bf16 rows never
// written) -> the s8 QKV product (EQ_BIAS) -> K3's core -> the attention
// rows' quantize pass -> the out product keeping y = x + (deq + bo) in f32
// (y32 [B*S, D]) beside its bf16 rounding yb (EQ_BIAS_RESID_Y) -> LayerNorm
// of yb and its quantize pass in one -> the up product with quick_gelu (h
// f32, EQ_BIAS_QGELU) -> the hidden's quantize pass -> the down product
// adding the f32 y: out = bf16((y + b2) + deq) (EQ_RESID32_BIAS).  tma 1:
// the QKV product on the persistent TMA-store GEMM gemm_s8_tma_kernel and,
// where layer_down_fits(D), the down product on gemm_s8_epi_kernel; tma 0
// (and the other products): gemm_s8_kernel.  The same outputs bit for bit.
// The attention half's weights and scratch are K3's (at hdp and scale: xq
// [B*S, DK], xs, qkv [B*S, NQKV] bf16, attn and aq [B*S, heads hdp],
// ascale), the MLP half's K4's (yq [B*S, DK], ys, h and hq [B*S, F], hs; F
// the padded hidden width), both on their padded layouts; DK = D rounded up
// to 64.
int dvl_fused_layer_q(const void* x, const void* ln1_s, const void* ln1_b, const void* wqkv_t,
                      const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                      const void* bo, const void* ln2_s, const void* ln2_b, const void* w1_t,
                      const void* s1, const void* b1, const void* w2_t, const void* s2,
                      const void* b2, void* out, void* xq, void* xs, void* qkv, void* attn,
                      void* aq, void* ascale, void* y32, void* yb, void* yq, void* ys, void* h,
                      void* hq, void* hs, int B, int S, int D, int F, int heads, int hdp,
                      float scale, int tma, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, 64), DA = heads * hdp, NQKV = round_up(3 * DA, SBN);
  const int NO = round_up(D, SBN);
  if (D < 1 || heads < 1 || D % heads || hdp < 64 || hdp % 64 || DA < D || F % SBK)
    return (int)cudaErrorInvalidValue;
  const int8_t *ixq = static_cast<const int8_t*>(xq), *iaq = static_cast<const int8_t*>(aq),
               *iyq = static_cast<const int8_t*>(yq), *ihq = static_cast<const int8_t*>(hq);
  const float *fxs = static_cast<const float*>(xs), *fas = static_cast<const float*>(ascale),
              *fys = static_cast<const float*>(ys), *fhs = static_cast<const float*>(hs);
  const int8_t *wqkv = static_cast<const int8_t*>(wqkv_t), *wo = static_cast<const int8_t*>(wo_t),
               *w1 = static_cast<const int8_t*>(w1_t), *w2 = static_cast<const int8_t*>(w2_t);
  const float *fsqkv = static_cast<const float*>(sqkv), *fbqkv = static_cast<const float*>(bqkv),
              *fso = static_cast<const float*>(so), *fbo = static_cast<const float*>(bo),
              *fs1 = static_cast<const float*>(s1), *fb1 = static_cast<const float*>(b1),
              *fs2 = static_cast<const float*>(s2), *fb2 = static_cast<const float*>(b2);
  cudaError_t e = launch_ln_quant(static_cast<const bf16*>(x), static_cast<const float*>(ln1_s),
                                  static_cast<const float*>(ln1_b), static_cast<int8_t*>(xq),
                                  static_cast<float*>(xs), nullptr, M, D, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = tma ? launch_gemm_s8_tma(ixq, fxs, wqkv, fsqkv, fbqkv, static_cast<bf16*>(qkv), M, NQKV, DK,
                               st)
          : launch_gemm_s8<EQ_BIAS>(ixq, fxs, wqkv, fsqkv, fbqkv, nullptr, qkv, M, NQKV, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, heads,
                             hdp, 0, st, NQKV, scale, 0);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(attn), static_cast<int8_t*>(aq),
                        static_cast<float*>(ascale), M, DA, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_BIAS_RESID_Y>(iaq, fas, wo, fso, fbo, x, y32, M, NO, DA, st, yb, 0, D);
  if (e != cudaSuccess) return (int)e;
  e = launch_ln_quant(static_cast<const bf16*>(yb), static_cast<const float*>(ln2_s),
                      static_cast<const float*>(ln2_b), static_cast<int8_t*>(yq),
                      static_cast<float*>(ys), nullptr, M, D, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_BIAS_QGELU>(iyq, fys, w1, fs1, fb1, nullptr, h, M, F, DK, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                        static_cast<float*>(hs), M, F, st);
  if (e != cudaSuccess) return (int)e;
  return (int)(tma && layer_down_fits(D)
                   ? launch_gemm_s8_epi(ihq, fhs, w2, fs2, fb2, static_cast<const float*>(y32),
                                        static_cast<bf16*>(out), M, NO, F, D, st)
                   : launch_gemm_s8<EQ_RESID32_BIAS>(ihq, fhs, w2, fs2, fb2, y32, out, M, NO, F, st,
                                                     nullptr, 0, D));
}

// 1 where the one-call layer at model width D runs its down product on the
// epilogue-warpgroup GEMM (layer_down_fits), else 0.
int dvl_layer_down_fits(int D) { return layer_down_fits(D); }

// KB (a) 2 / 3 and the attribution's MLP: K4's arguments, g (MQ_BF16H's
// f32 activation, or null) before M, and the variant (1 bf16h, 2 reciprocal
// quantizer, 3 reciprocal quantizer and bf16 quick_gelu, 4 q_attribution.py's
// "mxu", 5 its "vpu") in place of act_kind; F the padded hidden width, fv
// the model's; tma (bf16h: xn unwritten, 1 the up product on the persistent
// TMA-store GEMM; KB (a) 3: xn unwritten, 1 LayerNorm and the reciprocal
// quantize of x in one pass, then the up product, the hidden's pass and the
// down product, four launches).
int dvl_mlp_block_q_kb(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                       const void* s1, const void* b1, const void* w2_t, const void* s2,
                       const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                       void* hs, void* g, int M, int D, int F, int fv, int variant, int tma,
                       void* stream) {
  if (variant < MQ_BF16H || variant > MQ_ATTR_VPU) return (int)cudaErrorInvalidValue;
  return mlp_block_q_impl(x, ln_s, ln_b, w1_t, s1, b1, w2_t, s2, b2, out, xn, xq, xs, h, hq, hs,
                          g, M, D, F, 0, variant, stream, 1, fv, tma);
}

// A tensor-parallel slot's int8 attention up to its out-projection, on the
// group's padded layout (ops/fused_block.py::group_plan), four launches:
// LayerNorm and the quantize pass of x in one (ln_quant_rows_kernel: every
// slot of a row quantizes the same x, the same codes as K3's) -> the s8 QKV
// GEMM on the slot's columns -> the core on its g heads -> the row amax of
// its attention rows (amax [B*S] f32; the padded lanes are 0).  wqkv_t
// [NQKV, DK] int8 (the group's q, k, v output channels at hdp lanes a head,
// zero rows up to NQKV = 3 g hdp rounded up to 128), sqkv and bqkv [NQKV]
// f32.  Scratch: xq [B*S, DK] int8, xs [B*S] f32, qkv [B*S, NQKV] bf16; attn
// [B*S, g hdp] bf16.  scale: the true head dim's hd^-0.5.
int dvl_attention_block_q_heads(const void* x, const void* ln_s, const void* ln_b,
                                const void* wqkv_t, const void* sqkv, const void* bqkv, void* xq,
                                void* xs, void* qkv, void* attn, void* amax, int B, int S, int D,
                                int g, int hdp, int causal, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, DK = round_up(D, 64), DA = g * hdp, NQKV = round_up(3 * DA, SBN);
  if (g < 1 || hdp < 64 || hdp % 64) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  e = launch_ln_quant(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                      static_cast<float*>(xs), nullptr, M, D, DK, st);
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
// layout of its hidden columns, two launches: LayerNorm and the quantize
// pass of x in one (amax zeroed there) -> the s8 up GEMM with the activation
// (h [M, Fp] f32, zero past the slot's Fj columns), its epilogue folding
// each row's max |h| into amax [M] f32 (EQ_BIAS_QGELU_AMAX /
// EQ_BIAS_GELU_AMAX).  w1_t [Fp, DK] int8, s1 and b1 [Fp] f32 (zero past
// Fj).  Scratch: xq [M, DK] int8, xs [M] f32.
int dvl_mlp_block_q_cols(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                         const void* s1, const void* b1, void* xq, void* xs, void* h, void* amax,
                         int M, int D, int Fp, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int DK = round_up(D, 64);
  cudaError_t e;
  e = launch_ln_quant(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                      static_cast<float*>(xs), static_cast<float*>(amax), M, D, DK, st);
  if (e != cudaSuccess) return (int)e;
  const int8_t* ixq = static_cast<const int8_t*>(xq);
  const float *fxs = static_cast<const float*>(xs), *fs1 = static_cast<const float*>(s1),
              *fb1 = static_cast<const float*>(b1);
  const int8_t* w1 = static_cast<const int8_t*>(w1_t);
  e = act_kind == 0
          ? launch_gemm_s8<EQ_BIAS_QGELU_AMAX>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, Fp, DK, st,
                                               amax)
          : launch_gemm_s8<EQ_BIAS_GELU_AMAX>(ixq, fxs, w1, fs1, fb1, nullptr, h, M, Fp, DK, st,
                                              amax);
  return (int)e;
}

// The row-parallel product of one slot: a [M, K] (bf16 if a_f32 == 0, else
// f32; 16-byte aligned) quantized at the row scale max_j(amaxes[j]) / 127
// (clamped at 1e-8) into aq [M, K] int8 and ascale [M] f32, then out [M,
// ldc] int32 = aq @ wt^T, wt [N, K] int8 (the slot's input rows of the
// weight, transposed; N a multiple of 128, its rows past ldc zero).
// amaxes: a host array of 1 <= m <= TP_PARTS device pointers to [M] f32.
// K % 16 == 0.  strip 1 (where rows_strip_fits(K, ldc)): one launch of the
// row-strip kernel; 0: the warp-a-row quantize pass, then the s8 GEMM
// writing raw int32 (EQ_I32).  Both give the same codes, scales and
// partial.
int dvl_rows_q_partial(const void* a, int a_f32, const void* const* amaxes, int m,
                       const void* wt, void* aq, void* ascale, void* out, int M, int N, int K,
                       int ldc, int strip, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m < 1 || m > TP_PARTS || (strip && !rows_strip_fits(K, ldc)))
    return (int)cudaErrorInvalidValue;
  TpPtrs am{};
  for (int j = 0; j < m; ++j) am.p[j] = amaxes[j];
  int8_t* q = static_cast<int8_t*>(aq);
  float* qs = static_cast<float*>(ascale);
  const int8_t* w = static_cast<const int8_t*>(wt);
  if (strip)
    return (int)(a_f32 ? launch_rows_strip(static_cast<const float*>(a), am, m, w, q, qs,
                                           static_cast<int*>(out), M, N, K, ldc, st)
                       : launch_rows_strip(static_cast<const bf16*>(a), am, m, w, q, qs,
                                           static_cast<int*>(out), M, N, K, ldc, st));
  cudaError_t e =
      a_f32 ? launch_quant_given_amax(static_cast<const float*>(a), am, m, q, qs, M, K, st)
            : launch_quant_given_amax(static_cast<const bf16*>(a), am, m, q, qs, M, K, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm_s8<EQ_I32>(q, nullptr, w, nullptr, nullptr, nullptr, out, M, N, K, st,
                                     nullptr, 0, ldc);
}

// 1 where a slot's row-parallel product of K columns into int32 rows of ldc
// takes the row-strip kernel (rows_strip_fits), else 0.
int dvl_rows_strip_fits(int K, int ldc) { return rows_strip_fits(K, ldc); }

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
