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
//   * the LN output and qkv rounded to bf16, the attention core is K1's
//     (common.cuh, bf16 in, f32 softmax normalised before PV, bf16 out), the
//     MLP hidden stays f32 until it is quantized, residual adds in f32 with
//     one final rounding.
//
// What bounds them on an H100: the four products (~2.8 GOP per image per
// layer at ViT-B/16) are tensor-core work at up to 1,979 TOP/s dense int8;
// LayerNorm, the four quantize passes and the f32 MLP hidden (B*S x F x 4
// bytes: 620 MB at B=256, written once by the up-projection and read once by
// its quantize pass) are bandwidth work.  The design (PERF.md has the
// measured split):
//   * one tiled int8 GEMM: 128x128 block tile, 64-byte K tile, 8 warps of
//     64x32, ldmatrix (b16 rows of byte pairs) + mma.sync m16n8k32 s8 with
//     s32 accumulators, a four-stage cp.async ring.  ldmatrix has no .trans
//     for 8-bit elements, so the weight is read from a transposed [out, in]
//     copy made once by the caller: K is contiguous per output channel, which
//     is the .col B operand as it lies.  The epilogue dequantizes and applies
//     bias, activation and residual on the accumulator registers;
//   * a quantize pass, one block per row with the row in registers: amax,
//     scale and codes from a single read;
//   * the LayerNorm kernel and the attention core of common.cuh, unchanged.
// wgmma, TMA and quantizing inside the GEMM prologue are later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "common.cuh"

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
// int8 GEMM: C[M, N] = epilogue(A[M, K] @ Wt[N, K]^T) with A, Wt int8
// row-major (Wt is the weight transposed to [out, in]), s32 accumulation,
// row scales [M] and channel scales [N] f32.  K % 16 == 0 and N % 8 == 0
// (checked by the wrapper); ragged M, N and K edges are zero-filled on load
// and masked on store.
// ---------------------------------------------------------------------------

enum EpilogueQ {
  EQ_BIAS = 0,        // bf16(deq + bias)                           (qkv)
  EQ_BIAS_RESID = 1,  // bf16(resid + (deq + bias))                 (out-proj)
  EQ_BIAS_QGELU = 2,  // f32 quick_gelu(deq + bias)                 (mlp up)
  EQ_BIAS_GELU = 3,   // f32 erf_gelu_rn(deq + bias), A&S 7.1.26    (mlp up)
  EQ_RESID_BIAS = 4,  // bf16((resid + bias) + deq)                 (mlp down)
};                    // deq = (acc * row_scale) * channel_scale

constexpr int QBM = 128, QBN = 128, QBK = 64, QSTAGES = 4;  // QBK in bytes
constexpr int QLD = QBK + 16;       // 80-byte rows: an ldmatrix's 8 rows hit distinct banks
constexpr int QTILE = QBM * QLD;    // bytes of one operand tile (QBM == QBN)
constexpr int QGEMM_THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int QGEMM_SMEM = QSTAGES * 2 * QTILE;  // 81,920 B: 2 blocks/SM

__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int EPI>
__global__ void __launch_bounds__(QGEMM_THREADS)
gemm_q_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
              const int8_t* __restrict__ Wt, const float* __restrict__ w_scale,
              const float* __restrict__ bias, const bf16* __restrict__ resid,
              void* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + QSTAGES * QTILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2;  // 0..1 -> 64 rows each
  const int warp_n = warp & 3;   // 0..3 -> 32 cols each
  const long long m0 = (long long)blockIdx.y * QBM;
  const int n0 = blockIdx.x * QBN;

  // one 16-byte chunk of A and one of Wt per (c) step: 128 rows x 4 chunks each
  auto load_tile = [&](int kt, int stage) {
    int8_t* as = As + stage * QTILE;
    int8_t* bs = Bs + stage * QTILE;
    const int k0 = kt * QBK;
#pragma unroll
    for (int c = tid; c < QBM * QBK / 16; c += QGEMM_THREADS) {
      const int r = c >> 2, cc = (c & 3) * 16;
      const bool kin = k0 + cc < K;
      const long long gm = m0 + r;
      const bool oka = kin && gm < M;
      cp_async16(as + r * QLD + cc, oka ? A + gm * K + k0 + cc : A, oka);
      const int gn = n0 + r;
      const bool okb = kin && gn < N;
      cp_async16(bs + r * QLD + cc, okb ? Wt + (long long)gn * K + k0 + cc : Wt, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // QSTAGES-deep cp.async ring, one commit group per K tile (empty groups at
  // the tail keep the count uniform, so wait_group<QSTAGES-2> = "tile kt in").
  const int nk = (K + QBK - 1) / QBK;
#pragma unroll
  for (int st = 0; st < QSTAGES - 1; ++st) {
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<QSTAGES - 2>();
    __syncthreads();  // tile kt visible to all; stage (kt-1) % QSTAGES free
    const int pre = kt + QSTAGES - 1;
    if (pre < nk) load_tile(pre, pre % QSTAGES);
    cp_async_commit();
    // A: lanes 0-15 rows 0-15 at byte 0, lanes 16-31 rows 0-15 at byte 16 ->
    // {a0, a1, a2, a3} of m16n8k32.  Wt: lanes 0-7 / 8-15 / 16-23 / 24-31 give
    // (n 0-7, k 0), (n 0-7, k 16), (n 8-15, k 0), (n 8-15, k 16) -> {b0, b1}
    // of two neighbouring n-tiles.
    const int8_t* as = As + (kt % QSTAGES) * QTILE + (warp_m * 64 + (lane & 15)) * QLD +
                       (lane >> 4) * 16;
    const int8_t* bs = Bs + (kt % QSTAGES) * QTILE +
                       (warp_n * 32 + (lane & 7) + ((lane >> 4) << 3)) * QLD +
                       ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < QBK; ks += 32) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], reinterpret_cast<const bf16*>(as + mt * 16 * QLD + ks));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(bfr[np], reinterpret_cast<const bf16*>(bs + np * 16 * QLD + ks));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16832_s8(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                       bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue on the accumulators: thread holds columns n, n+1 of rows g and
  // g + 8 of each 16x8 tile; one bf16 pair (or f32 pair) store each.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + warp_n * 32 + nt * 8 + 2 * t;
      if (n >= N) continue;
      const float2 cs = *reinterpret_cast<const float2*>(w_scale + n);
      const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (m >= M) continue;
        const float rs = a_scale[m];
        const float d0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), rs), cs.x);
        const float d1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), rs), cs.y);
        if constexpr (EPI == EQ_BIAS_QGELU || EPI == EQ_BIAS_GELU) {
          float2 hv;
          if constexpr (EPI == EQ_BIAS_QGELU) {
            hv = make_float2(quick_gelu(__fadd_rn(d0, bb.x)), quick_gelu(__fadd_rn(d1, bb.y)));
          } else {
            hv = make_float2(erf_gelu_rn(__fadd_rn(d0, bb.x)), erf_gelu_rn(__fadd_rn(d1, bb.y)));
          }
          *reinterpret_cast<float2*>(static_cast<float*>(C) + m * N + n) = hv;
        } else {
          float v0, v1;
          if constexpr (EPI == EQ_BIAS) {
            v0 = __fadd_rn(d0, bb.x);
            v1 = __fadd_rn(d1, bb.y);
          } else {
            const float2 rr =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + m * N + n));
            if constexpr (EPI == EQ_BIAS_RESID) {
              v0 = __fadd_rn(rr.x, __fadd_rn(d0, bb.x));
              v1 = __fadd_rn(rr.y, __fadd_rn(d1, bb.y));
            } else {  // EQ_RESID_BIAS
              v0 = __fadd_rn(__fadd_rn(rr.x, bb.x), d0);
              v1 = __fadd_rn(__fadd_rn(rr.y, bb.y), d1);
            }
          }
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(C) + m * N + n) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

template <int EPI>
cudaError_t launch_gemm_q(const int8_t* A, const float* a_scale, const int8_t* Wt,
                          const float* w_scale, const float* bias, const bf16* resid, void* C,
                          int M, int N, int K, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_q_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, QGEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  gemm_q_kernel<EPI><<<grid, QGEMM_THREADS, QGEMM_SMEM, st>>>(A, a_scale, Wt, w_scale, bias,
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
// [B*S, 3D] bf16.  D == heads * 64, S <= 320.
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
  e = launch_gemm_q<EQ_BIAS>(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                             static_cast<const int8_t*>(wqkv_t), static_cast<const float*>(sqkv),
                             static_cast<const float*>(bqkv), nullptr, qkv, M, 3 * D, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, D, heads,
                       causal, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const bf16*>(attn), static_cast<int8_t*>(aq),
                        static_cast<float*>(ascale), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_q<EQ_BIAS_RESID>(static_cast<const int8_t*>(aq),
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
// act_kind 0 = quick_gelu, 1 = erf gelu (A&S).  F <= 4096.
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
    e = launch_gemm_q<EQ_BIAS_QGELU>(static_cast<const int8_t*>(xq),
                                     static_cast<const float*>(xs),
                                     static_cast<const int8_t*>(w1_t),
                                     static_cast<const float*>(s1),
                                     static_cast<const float*>(b1), nullptr, h, M, F, D, st);
  else
    e = launch_gemm_q<EQ_BIAS_GELU>(static_cast<const int8_t*>(xq),
                                    static_cast<const float*>(xs),
                                    static_cast<const int8_t*>(w1_t),
                                    static_cast<const float*>(s1),
                                    static_cast<const float*>(b1), nullptr, h, M, F, D, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),
                        static_cast<float*>(hs), M, F, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_q<EQ_RESID_BIAS>(static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
                                   static_cast<const int8_t*>(w2_t), static_cast<const float*>(s2),
                                   static_cast<const float*>(b2), static_cast<const bf16*>(x),
                                   out, M, D, F, st);
  return (int)e;
}

}  // extern "C"
