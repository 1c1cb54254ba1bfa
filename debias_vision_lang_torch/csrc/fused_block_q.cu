// Hand-written Hopper (sm_90a) kernels for the two int8 fused transformer-
// block entry points of the ViT/text towers, with a plain C interface bound
// from Python through ctypes (debias_vision_lang_torch/ops/fused_block_q.py).
//
// Replaces the TPU Pallas kernels in debias_vision_lang_tpu/ops/fused_block_q.py:
//   dvl_attention_block_q  <- attention_block_q (_attn_q_kernel, and the
//                             bit-identical _attn_q_chains_kernel)
//   dvl_mlp_block_q        <- mlp_block_q, unsplit (_mlp_q_kernel with one F
//                             tile, and the chain variant _mlp_q_pipe_kernel)
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
//     (bf16 qkv), on coalesced rows, in the operation order above.  N % 128
//     == 0 and K % 128 == 0 (the wrappers raise otherwise); the TMA
//     zero-fills the ragged M edge;
//   * the attention block's core is the wgmma core of attention_wgmma.cuh
//     that K1 runs, on the same packed [B*S, 3D] qkv: each head's K and V
//     loaded once by TMA, whole f32 score rows in wgmma accumulators, P fed
//     to an RS-wgmma from registers (it scales by the reciprocal of the f32
//     row sum where the twin divides: at most one f32 ulp before the bf16
//     rounding); past 320 keys (the int8 joint Frozen-in-Time tower, S =
//     785) the two-pass long route of attention_long.cuh on the same qkv;
//   * a quantize pass, one block per row with the row in registers: amax,
//     scale and codes from a single read;
//   * the LayerNorm kernel of common.cuh.
// Quantizing inside the GEMMs (an epilogue taking the row amax, a producer
// quantizing on load) and fusing LN with the quantize pass are later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

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

template <typename T, int PER>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                  int n) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    v[j] = i < n ? to_f32(xr[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  int8_t* qr = q + row * n;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * QR_THREADS;
    if (i < n)
      qr[i] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -127.f), 127.f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename T>
cudaError_t launch_quant_rows(const T* x, int8_t* q, float* scale, int rows, int n,
                              cudaStream_t st) {
  if (n <= 8 * QR_THREADS)
    quant_rows_kernel<T, 8><<<rows, QR_THREADS, 0, st>>>(x, q, scale, n);
  else
    quant_rows_kernel<T, 32><<<rows, QR_THREADS, 0, st>>>(x, q, scale, n);
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
};                    // deq = (acc * row_scale) * channel_scale

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

template <int EPI>
__global__ void __launch_bounds__(SGEMM_THREADS, 2)
gemm_s8_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const bf16* __restrict__ resid,
               void* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem);                     // [stage][128][128]
  int8_t* sB = reinterpret_cast<int8_t*>(smem + SSTAGES * S_TILE);  // [stage][128][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SSTAGES * 2 * S_TILE);
  uint64_t* empty = full + SSTAGES;

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127;  // consumer warpgroup c
  const int n0 = blockIdx.x * SBN, m0 = blockIdx.y * SBM;
  const int nk = K / SBK;
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
#pragma unroll
  for (int i = 0; i < SBN / 2; ++i) acc[i] = 0;
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
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(stage + (warp * 16 + g + 8 * half) * SEPI_LD + j * 8 + 2 * t) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
  named_barrier(2 + c, 128);
  const int col = (tid & 15) * 8, n = n0 + col;
  float cs[8], bb[8];
  *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(w_scale + n);
  *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(w_scale + n + 4);
  *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
  *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
#pragma unroll 2
  for (int r = tid >> 4; r < 64; r += 8) {
    const long long m = (long long)m0 + c * 64 + r;
    if (m >= M) continue;
    const float rs = a_scale[m];
    int a[8];
    *reinterpret_cast<int4*>(a) = *reinterpret_cast<const int4*>(stage + r * SEPI_LD + col);
    *reinterpret_cast<int4*>(a + 4) = *reinterpret_cast<const int4*>(stage + r * SEPI_LD + col + 4);
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = __fmul_rn(__fmul_rn(__int2float_rn(a[i]), rs), cs[i]);
    if constexpr (EPI == EQ_BIAS_QGELU || EPI == EQ_BIAS_GELU) {
      float hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        hv[i] = EPI == EQ_BIAS_QGELU ? quick_gelu(__fadd_rn(d[i], bb[i]))
                                     : erf_gelu_rn(__fadd_rn(d[i], bb[i]));
      float* out = static_cast<float*>(C) + m * N + n;
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(hv);
      *reinterpret_cast<float4*>(out + 4) = *reinterpret_cast<const float4*>(hv + 4);
    } else {
      float rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if constexpr (EPI != EQ_BIAS) {
        const uint4 raw = *reinterpret_cast<const uint4*>(resid + m * N + n);
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
        else if constexpr (EPI == EQ_BIAS_RESID)
          o[i] = __fadd_rn(rr[i], __fadd_rn(d[i], bb[i]));
        else  // EQ_RESID_BIAS
          o[i] = __fadd_rn(__fadd_rn(rr[i], bb[i]), d[i]);
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) pw[i] = pack_bf16(o[2 * i], o[2 * i + 1]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + m * N + n) = packed;
    }
  }
}

template <int EPI>
cudaError_t launch_gemm_s8(const int8_t* A, const float* a_scale, const int8_t* Wt,
                           const float* w_scale, const float* bias, const bf16* resid, void* C,
                           int M, int N, int K, cudaStream_t st) {
  if (M < 1 || N % SBN || K % SBK || K < SBK) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;  // both K-major: boxes of 128 K x 128 rows
  const uint64_t stride[1] = {(uint64_t)K};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box[2] = {SBK, SBM};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return e;
  e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gemm_s8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SGEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(N / SBN, (M + SBM - 1) / SBM);
  gemm_s8_kernel<EPI><<<grid, SGEMM_THREADS, SGEMM_SMEM, st>>>(tm_a, tm_b, a_scale, w_scale, bias,
                                                               resid, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x + (deq(q(attn) @ wo_q) + bo), attn = MHA over
// bf16(deq(q(bf16(LN(x))) @ wqkv_q) + bqkv).  x, out [B, S, D] bf16; wqkv_t
// [3D, D], wo_t [D, D] int8 (the [in, out] weights transposed); sqkv [3D],
// so [D] channel scales, ln_s, ln_b, bo [D] and bqkv [3D] f32.  Scratch: xn,
// attn [B*S, D] bf16; xq, aq [B*S, D] int8; xs, ascale [B*S] f32; qkv
// [B*S, 3D] bf16.  D == heads * 64, D % 128 == 0 (the s8 GEMM's N and K),
// S >= 1 (the core's whole score rows up to 320 keys, its long route past).
int dvl_attention_block_q(const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
                          const void* sqkv, const void* bqkv, const void* wo_t, const void* so,
                          const void* bo, void* out, void* xn, void* xq, void* xs, void* qkv,
                          void* attn, void* aq, void* ascale, int B, int S, int D, int heads,
                          int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_BIAS>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                              static_cast<const int8_t*>(wqkv_t), static_cast<const float*>(sqkv),
                              static_cast<const float*>(bqkv), nullptr, qkv, M, 3 * D, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, D,
                             heads, causal, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(attn), static_cast<int8_t*>(aq),
                        static_cast<float*>(ascale), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_BIAS_RESID>(static_cast<const int8_t*>(aq),
                                    static_cast<const float*>(ascale),
                                    static_cast<const int8_t*>(wo_t), static_cast<const float*>(so),
                                    static_cast<const float*>(bo), static_cast<const bf16*>(x),
                                    out, M, D, D, st);
  return (int)e;
}

// out = (x + b2) + deq(q(h) @ w2_q), h = act(deq(q(bf16(LN(x))) @ w1_q) + b1)
// in f32.  x, out [M, D] bf16; w1_t [F, D], w2_t [D, F] int8 (transposed);
// s1, b1 [F], s2, b2, ln_s, ln_b [D] f32.  Scratch: xn [M, D] bf16, xq
// [M, D] int8, xs [M] f32, h [M, F] f32, hq [M, F] int8, hs [M] f32.
// act_kind 0 = quick_gelu, 1 = erf gelu (A&S).  D % 128 == 0, F % 128 == 0
// (the s8 wgmma GEMM's N and K), F <= 4096.
int dvl_mlp_block_q(const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
                    const void* s1, const void* b1, const void* w2_t, const void* s2,
                    const void* b2, void* out, void* xn, void* xq, void* xs, void* h, void* hq,
                    void* hs, int M, int D, int F, int act_kind, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  e = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(xn), static_cast<int8_t*>(xq),
                        static_cast<float*>(xs), M, D, st);
  if (e != cudaSuccess) return (int)e;
  if (act_kind == 0)
    e = launch_gemm_s8<EQ_BIAS_QGELU>(static_cast<const int8_t*>(xq),
                                     static_cast<const float*>(xs),
                                     static_cast<const int8_t*>(w1_t),
                                     static_cast<const float*>(s1),
                                     static_cast<const float*>(b1), nullptr, h, M, F, D, st);
  else
    e = launch_gemm_s8<EQ_BIAS_GELU>(static_cast<const int8_t*>(xq),
                                    static_cast<const float*>(xs),
                                    static_cast<const int8_t*>(w1_t),
                                    static_cast<const float*>(s1),
                                    static_cast<const float*>(b1), nullptr, h, M, F, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                        static_cast<float*>(hs), M, F, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_s8<EQ_RESID_BIAS>(static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
                                   static_cast<const int8_t*>(w2_t), static_cast<const float*>(s2),
                                   static_cast<const float*>(b2), static_cast<const bf16*>(x),
                                   out, M, D, F, st);
  return (int)e;
}

}  // extern "C"
