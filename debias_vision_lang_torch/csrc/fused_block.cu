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
// rounds them; softmax normalised by the f32 row sum and rounded BEFORE the
// PV product (two passes over a whole score row, not an online softmax);
// residual adds in f32 with one final rounding.
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
//     parameter version) so both operands are K-major; N % 128 == 0 and
//     K % 64 == 0 (the wrapper raises otherwise); the ragged M edge is
//     zero-filled by the TMA and masked on store;
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

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                  const float* __restrict__ bias, const bf16* __restrict__ resid,
                  bf16* __restrict__ C, int M, int N, int K) {
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
  // with one rounding.
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
  float bb[8];
  *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + n);
  *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + n + 4);
#pragma unroll 4
  for (int r = tid >> 4; r < 64; r += 8) {
    const long long m = (long long)m0 + c * 64 + r;
    if (m >= M) continue;
    float v[8], rr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(stage + r * GEPI_LD + col);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(stage + r * GEPI_LD + col + 4);
    if (EPI == EPI_BIAS_RESID || EPI == EPI_RESID_BIAS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(resid + m * N + n);
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
    *reinterpret_cast<uint4*>(C + m * N + n) = packed;
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* Wt, const float* bias, const bf16* resid,
                        bf16* C, int M, int N, int K, cudaStream_t st) {
  if (M < 1 || N % GBN || K % GBK || K < GBK) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;  // both K-major: boxes of 64 K x 128 rows
  const uint64_t stride[1] = {(uint64_t)K * 2};
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box_a[2] = {GBK, GBM}, box_b[2] = {GBK, GBN};
  cudaError_t e = make_tensor_map(&tm_a, A, 2, dims_a, stride, box_a);
  if (e != cudaSuccess) return e;
  e = make_tensor_map(&tm_b, Wt, 2, dims_b, stride, box_b);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gemm_wgmma_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_wgmma_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(tm_a, tm_b, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x + (MHA(LN(x)) @ wo + bo); x, out [B, S, D] bf16; the weights
// K-major bf16, wqkv [3D, D] and wo [D, D] (the transposes of the
// parameters); ln_s, ln_b, bo [D] and bqkv [3D] f32.  Scratch (bf16):
// xn [B*S, D], qkv [B*S, 3D], attn [B*S, D].  D == heads * 64,
// D % 128 == 0, S >= 1 (past 320 keys the core takes its long route).
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
  e = launch_attention_wgmma(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, S, D,
                             heads, causal, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_BIAS_RESID>(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo),
                                  static_cast<const float*>(bo), static_cast<const bf16*>(x),
                                  static_cast<bf16*>(out), M, D, D, st);
  return (int)e;
}

// out = x + b2 + act(LN(x) @ w1 + b1) @ w2; x, out [M, D] bf16; the weights
// K-major bf16, w1 [F, D] and w2 [D, F] (the transposes of the
// parameters); ln_s, ln_b, b2 [D] and b1 [F] f32.  Scratch (bf16):
// xn [M, D], hidden [M, F].  D % 128 == 0, F % 128 == 0.  act_kind
// 0 = quick_gelu, 1 = erf gelu (A&S).
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