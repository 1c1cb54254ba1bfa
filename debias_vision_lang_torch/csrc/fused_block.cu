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
// wgmma, TMA and a fused LN prologue are later work.  The LayerNorm kernel,
// the attention core and the fragment helpers live in common.cuh, which the
// int8 blocks (fused_block_q.cu) share.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

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