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
// LayerNorm, the four quantize passes and the f32 MLP hidden (B*S x F x 4
// bytes: 620 MB at B=256, written once by the up-projection and read once by
// its quantize pass) are bandwidth work.  The design (PERF.md has the
// measured split):
//   * dvl_mlp_block_q's two products run one TMA-fed, warp-specialised s8
//     wgmma GEMM, the bf16 GEMM of csrc/fused_block.cu in 8-bit operands:
//     a 128x128 block tile, a K step of 128 int8 (128 B: the same 16 KB per
//     operand tile and the same 128-byte swizzle), a 3-stage ring filled by
//     one producer warp, two consumer warpgroups on wgmma m64n128k32 s8 with
//     s32 accumulators, two blocks per SM.  8-bit wgmma takes K-major
//     operands only, which both are: the activations [M, K] and the weight
//     copy transposed to [out, in] that the caller keeps.  The epilogue
//     stages the s32 tile in the freed ring and dequantizes, adds the bias
//     and applies the activation (f32 hidden) or the residual (bf16 out) on
//     coalesced rows, in the operation order above.  N % 128 == 0 and K %
//     128 == 0 (the wrapper raises otherwise); the TMA zero-fills the ragged
//     M edge;
//   * dvl_attention_block_q's two products still run the first design: a
//     tiled mma.sync GEMM (128x128 block tile, 64-byte K tile, 8 warps of
//     64x32, ldmatrix + mma.sync m16n8k32 s8, a four-stage cp.async ring;
//     ldmatrix has no .trans for 8-bit elements, so it too reads the
//     transposed weight copy), with the epilogue on the accumulator
//     registers; it goes when the attention block moves to the s8 GEMM and
//     the wgmma core;
//   * a quantize pass, one block per row with the row in registers: amax,
//     scale and codes from a single read;
//   * the LayerNorm kernel of common.cuh and the mma.sync attention core
//     below.
// Quantizing inside the GEMMs (the up GEMM's epilogue taking the row amax,
// the down GEMM's producer quantizing on load) is later work.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l % 16), column block (l / 16) of a 16x16 tile, so r = {a0..a3} of an
// m16n8k16 A operand (or, on byte pairs, of an m16n8k32 s8 one).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// ---------------------------------------------------------------------------
// The mma.sync attention core of the int8 attention block (K1's function;
// K1 and K5 run the wgmma core of attention_wgmma.cuh): packed qkv [B*S,
// 3D] (q | k | v, head h at columns h*64 .. h*64+63 of each third) -> attn
// [B*S, D], per (64 query rows, head, batch item); each warp owns 16 query
// rows.  Scores f32 * scale (+ the causal mask generated here), row max,
// exp, divide by the f32 row sum, round to bf16, then P @ V in f32 and one
// rounding -- exactly the TPU kernel's per-head loop.  Scores, probabilities and the output live in
// registers as mma.sync m16n8k16 fragments: the accumulator layout of two
// neighbouring 8-key score tiles is the A-operand layout of one 16-key PV
// step, so the probabilities feed PV without touching shared memory, which
// holds only K [keys][64] and V^T [64][keys] (~58 KB at S = 197).
// ---------------------------------------------------------------------------

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
// mma.sync int8 GEMM (the attention block's products; the MLP's run the s8
// wgmma GEMM below): C[M, N] = epilogue(A[M, K] @ Wt[N, K]^T) with A, Wt int8
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

// ---------------------------------------------------------------------------
// s8 wgmma GEMM (the MLP's up and down products): C[M, N] = epilogue(A[M, K]
// @ Wt[N, K]^T), A and Wt int8 row-major (both K-major), s32 accumulation,
// the epilogues of gemm_q_kernel.  The bf16 GEMM of fused_block.cu with a
// K step of 128 int8.
// ---------------------------------------------------------------------------

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
