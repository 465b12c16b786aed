// Unified Conv4Xbar block evaluator for Hopper (sm_90a), fp32, with the
// reference kernel's bf16 mode.
//
// Replaces kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas
// of the JAX package (its body is _unified_kernel): BOTH rails of the
// dual-rail delta factorization and BOTH GEMM stages of the Conv4Xbar
// emulator, for every (batch row, crossbar block) pair of one analog
// matmul.  Per block j and row m:
//   stage 0+1, per position (d, w, g) and window tap kk:
//     delta = celu(u[m,nb,d,g,kk] * w0v + g0k[kk,j,d,w,g]) - celu0k[kk,j,d,w,g]
//     t_kk  = delta @ w1k[kk]                       (C0=16 -> O1=8)
//     rails = celu(y0 + sum_kk t_kk*pos_kk), celu(y0 + sum_kk t_kk - sum_kk t_kk*pos_kk)
//   tail: row-window convs 8->4 (k=4), 4->32 (k=8), the (1,1,2) W-stage
//   2*32->32, then the FC head FLAT->32 (+ optional fc0 shift) ->16->O.
// Output (2, M*NB*NO, O), rows M-major with j = nb*NO + no innermost.
//
// What bounds it on an H100: at decode (M of a few rows) the read of the
// per-block precompute g0k/celu0k/y0 (72 KiB per block under CASE_A,
// about 2.5 GB for a full-width gemma3-1b mlp.up) -- the kernel is bound
// by bytes.  At prefill (M >= ~64) the 8,192 expm1 and ~0.25 MFLOP of
// fp32 arithmetic per (row, block) bound it by operations.
//
// What the design does about it: one thread block per (crossbar block,
// tile of bm rows), one thread per stage-1 position.  Each thread loads
// its position's precompute slice (2 x 2 x 16 floats + 8) into registers
// ONCE, with 16-byte loads, and reuses it for every row of the tile, so
// the precompute crosses device memory once per tile of rows: with a tile
// covering every row the kernel reads each byte of it once, the bound's
// own count.  All arithmetic is fp32 FMA on CUDA cores (TF32 would break
// parity with the fp32 plain version); the tail's per-row activations
// live in shared memory, the emulator weights (a few KB) are read through
// the read-only cache, where every block hits them.  This is the simple
// first version: stage 1 is scalar, the tail runs one row at a time.
//
// bf16 mode (template flag BF16, the reference's compute_dtype=bfloat16):
// every GEMM operand is rounded to bf16 (round to nearest even) and the
// products accumulate in fp32, at the reference dot's places -- the
// stage-1 delta @ w1k[kk], each tail stage, the W-stage and each FC
// layer.  An activation that feeds only a GEMM is rounded once where it
// is stored; weights are rounded where they are read.  Biases, CELU, the
// rail masks and the precompute stay fp32, so the bytes are those of the
// fp32 mode; the arithmetic stays scalar fp32 FMA (no tensor cores yet).
// A product of bf16 values is exact in fp32, so each FMA of the chain
// rounds once, like the plain version's bf16 dot that sums in the same
// order: the two agree bit for bit, where a different summation order
// would flip bf16 roundings downstream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The emulator weights, packed by the wrapper (kernels/emulator_block/
// emulator_block.py:_Weights).  Outside the anonymous namespace: the C
// entry point takes it, and a type with internal linkage in its signature
// would keep the entry point from being exported.
struct Weights {
  const float* w0v;  // (C0,)
  const float* w1k;  // (K1, C0, O1)
  const float* w2;   // (K2*O1, C2)
  const float* b2;
  const float* w3;   // (K3*C2, C3)
  const float* b3;
  const float* wst;  // (2*C3, CW)
  const float* bst;
  const float* f0;   // (FLAT, F1), rows in (d, h, w, c) order, bias folded
  const float* fb0;
  const float* f1;   // (F1, F2)
  const float* fb1;
  const float* f2;   // (F2, O)
  const float* fb2;
};

namespace {

constexpr int G = 32;       // row groups after the stage-1 window
constexpr int K1 = 2;       // stage-1 window (H = G * K1 = 64 wordlines)
constexpr int H = G * K1;
constexpr int C0 = 16;      // stage-0 channels
constexpr int O1 = 8;       // stage-1 channels
constexpr int K2 = 4, C2 = 4;    // tail stage 2: window 4, 8 -> 4
constexpr int K3 = 8, C3 = 32;   // tail stage 3: window 8, 4 -> 32
constexpr int CW = 32;           // W-stage: 2 x 32 -> 32
constexpr int F1 = 32, F2 = 16;  // FC head widths


__device__ __forceinline__ float celu(float x) { return x > 0.f ? x : expm1f(x); }

// a GEMM operand: itself in fp32 mode, rounded to bf16 in bf16 mode
template <bool BF16>
__device__ __forceinline__ float op(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <int D, int W, int O, bool BF16>
__global__ void __launch_bounds__(D * W * G)
unified_kernel(const float* __restrict__ u, const float* __restrict__ pos,
               const float* __restrict__ g0k, const float* __restrict__ celu0k,
               const float* __restrict__ y0, const float* __restrict__ shift,
               int shift_per_block, Weights wt, float* __restrict__ out,
               int M, int NB, int NO, int bm) {
  constexpr int P = D * W * G;                // stage-1 positions = threads
  constexpr int WO = W <= 2 ? 1 : W / 2;      // W-stage outputs
  constexpr int Q2 = P / K2;                  // stage-2 output rows
  constexpr int Q3 = Q2 / K3;                 // stage-3 output rows (= D*W)
  constexpr int Q4 = D * WO;                  // W-stage output rows
  constexpr int FLAT = Q4 * CW;
  static_assert(G % (K2 * K3) == 0, "tail windows must tile G");
  static_assert(W == 2 || W % 2 == 0, "W-stage pairs columns");

  __shared__ float s_w0v[C0];
  __shared__ float s_w1k[K1 * C0 * O1];
  __shared__ float h1[2][P * O1];
  __shared__ float h2[2][Q2 * C2];
  __shared__ float h3[2][Q3 * C3];
  __shared__ float h4[2][FLAT];
  __shared__ float h5[2][F1];
  __shared__ float h6[2][F2];

  const int tid = threadIdx.x;
  const long long j = blockIdx.x;             // crossbar block nb*NO + no
  const long long nblk = (long long)NB * NO;
  const long long nb = j / NO;
  const int m0 = blockIdx.y * bm;
  const int m1 = min(M, m0 + bm);

  for (int i = tid; i < C0; i += P) s_w0v[i] = wt.w0v[i];
  for (int i = tid; i < K1 * C0 * O1; i += P) s_w1k[i] = op<BF16>(wt.w1k[i]);

  // this thread's stage-1 position t = (d*W + w)*G + g: its precompute
  // slice goes to registers once and serves every row of the tile
  const int g = tid % G;
  const int d = tid / (W * G);
  float rg0[K1][C0], rc0[K1][C0], ry0[O1];
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
    const long long off = ((kk * nblk + j) * P + tid) * C0;
    const float4* a = reinterpret_cast<const float4*>(g0k + off);
    const float4* b = reinterpret_cast<const float4*>(celu0k + off);
#pragma unroll
    for (int q = 0; q < C0 / 4; ++q) {
      const float4 va = __ldg(a + q);
      const float4 vb = __ldg(b + q);
      rg0[kk][4 * q] = va.x; rg0[kk][4 * q + 1] = va.y;
      rg0[kk][4 * q + 2] = va.z; rg0[kk][4 * q + 3] = va.w;
      rc0[kk][4 * q] = vb.x; rc0[kk][4 * q + 1] = vb.y;
      rc0[kk][4 * q + 2] = vb.z; rc0[kk][4 * q + 3] = vb.w;
    }
  }
  {
    const float4* a = reinterpret_cast<const float4*>(y0 + (j * P + tid) * O1);
#pragma unroll
    for (int q = 0; q < O1 / 4; ++q) {
      const float4 v = __ldg(a + q);
      ry0[4 * q] = v.x; ry0[4 * q + 1] = v.y;
      ry0[4 * q + 2] = v.z; ry0[4 * q + 3] = v.w;
    }
  }
  __syncthreads();

  for (int m = m0; m < m1; ++m) {
    // ---- stage 0+1: both rails from one magnitude-drive CELU ----------
    const long long ub = ((m * (long long)NB + nb) * D + d) * H + g * K1;
    float tf[O1], tp[O1];
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) {
      const float uv = __ldg(u + ub + kk);
      const float pv = __ldg(pos + ub + kk);
      float t[O1];
#pragma unroll
      for (int o = 0; o < O1; ++o) t[o] = 0.f;
#pragma unroll
      for (int c = 0; c < C0; ++c) {
        // bf16 mode: rounded apart, as the plain version's multiply and
        // add are, so that the bf16 rounding of dl matches it
        const float v0 = BF16 ? __fadd_rn(__fmul_rn(uv, s_w0v[c]), rg0[kk][c])
                              : uv * s_w0v[c] + rg0[kk][c];
        const float dl = op<BF16>(celu(v0) - rc0[kk][c]);
#pragma unroll
        for (int o = 0; o < O1; ++o)
          t[o] = fmaf(dl, s_w1k[(kk * C0 + c) * O1 + o], t[o]);
      }
#pragma unroll
      for (int o = 0; o < O1; ++o) {
        tf[o] = kk == 0 ? t[o] : tf[o] + t[o];
        tp[o] = kk == 0 ? t[o] * pv : tp[o] + t[o] * pv;
      }
    }
#pragma unroll
    for (int o = 0; o < O1; ++o) {
      h1[0][tid * O1 + o] = op<BF16>(celu(ry0[o] + tp[o]));
      h1[1][tid * O1 + o] = op<BF16>(celu((ry0[o] + tf[o]) - tp[o]));
    }
    __syncthreads();

    // ---- tail stage 2: window K2 over g, 8 -> 4 channels ---------------
    for (int i = tid; i < 2 * Q2 * C2; i += P) {
      const int o = i % C2, q = (i / C2) % Q2, r = i / (C2 * Q2);
      const float* in = &h1[r][q * K2 * O1];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K2 * O1; ++k)
        acc = fmaf(in[k], op<BF16>(__ldg(wt.w2 + k * C2 + o)), acc);
      h2[r][q * C2 + o] = op<BF16>(celu(acc + __ldg(wt.b2 + o)));
    }
    __syncthreads();

    // ---- tail stage 3: window K3, 4 -> 32 channels ---------------------
    for (int i = tid; i < 2 * Q3 * C3; i += P) {
      const int o = i % C3, q = (i / C3) % Q3, r = i / (C3 * Q3);
      const float* in = &h2[r][q * K3 * C2];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K3 * C2; ++k)
        acc = fmaf(in[k], op<BF16>(__ldg(wt.w3 + k * C3 + o)), acc);
      h3[r][q * C3 + o] = op<BF16>(celu(acc + __ldg(wt.b3 + o)));
    }
    __syncthreads();

    // ---- W-stage: column pairs (2w, 2w+1), 2*32 -> 32 ------------------
    for (int i = tid; i < 2 * Q4 * CW; i += P) {
      const int o = i % CW, q = (i / CW) % Q4, r = i / (CW * Q4);
      const int dq = q / WO, wo = q % WO;
      const float* in = &h3[r][(dq * W + 2 * wo) * C3];
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < 2 * C3; ++k)
        acc = fmaf(in[k], op<BF16>(__ldg(wt.wst + k * CW + o)), acc);
      h4[r][q * CW + o] = op<BF16>(celu(acc + __ldg(wt.bst + o)));
    }
    __syncthreads();

    // ---- FC head: FLAT -> 32 (+ shift) -> 16 -> O ----------------------
    for (int i = tid; i < 2 * F1; i += P) {
      const int o = i % F1, r = i / F1;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < FLAT; ++k)
        acc = fmaf(h4[r][k], op<BF16>(__ldg(wt.f0 + k * F1 + o)), acc);
      acc = acc + __ldg(wt.fb0 + o);
      if (shift != nullptr)
        acc = acc + __ldg(shift + (shift_per_block ? j * F1 : 0) + o);
      h5[r][o] = op<BF16>(celu(acc));
    }
    __syncthreads();
    for (int i = tid; i < 2 * F2; i += P) {
      const int o = i % F2, r = i / F2;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < F1; ++k)
        acc = fmaf(h5[r][k], op<BF16>(__ldg(wt.f1 + k * F2 + o)), acc);
      h6[r][o] = op<BF16>(celu(acc + __ldg(wt.fb1 + o)));
    }
    __syncthreads();
    for (int i = tid; i < 2 * O; i += P) {
      const int o = i % O, r = i / O;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < F2; ++k)
        acc = fmaf(h6[r][k], op<BF16>(__ldg(wt.f2 + k * O + o)), acc);
      out[((r * (long long)M + m) * nblk + j) * O + o] = acc + __ldg(wt.fb2 + o);
    }
  }
}

template <int D, int W, int O, bool BF16>
int launch(const float* u, const float* pos, const float* g0k,
           const float* celu0k, const float* y0, const float* shift,
           int shift_per_block, const Weights& wt, float* out, int M, int NB,
           int NO, int bm, cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  unified_kernel<D, W, O, BF16><<<grid, D * W * G, 0, stream>>>(
      u, pos, g0k, celu0k, y0, shift, shift_per_block, wt, out, M, NB, NO, bm);
  return (int)cudaGetLastError();
}

template <int D, int W, int O>
int launch_mode(int bf16, const float* u, const float* pos, const float* g0k,
                const float* celu0k, const float* y0, const float* shift,
                int shift_per_block, const Weights& wt, float* out, int M,
                int NB, int NO, int bm, cudaStream_t s) {
  if (bf16)
    return launch<D, W, O, true>(u, pos, g0k, celu0k, y0, shift,
                                 shift_per_block, wt, out, M, NB, NO, bm, s);
  return launch<D, W, O, false>(u, pos, g0k, celu0k, y0, shift,
                                shift_per_block, wt, out, M, NB, NO, bm, s);
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).
// bf16 0: fp32 mode; 1: bf16 GEMM operands, fp32 accumulation.
// Returns the launch's cudaError_t (0 = launched); -1 for an unknown geom.
extern "C" int emulator_block_unified(
    int geom, int bf16, const float* u, const float* pos, const float* g0k,
    const float* celu0k, const float* y0, const float* shift,
    int shift_per_block, const Weights* wt, float* out, int M, int NB, int NO,
    int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_mode<4, 2, 1>(bf16, u, pos, g0k, celu0k, y0, shift,
                                shift_per_block, *wt, out, M, NB, NO, bm, s);
  if (geom == 1)
    return launch_mode<2, 8, 4>(bf16, u, pos, g0k, celu0k, y0, shift,
                                shift_per_block, *wt, out, M, NB, NO, bm, s);
  return -1;
}
