// Unified Conv4Xbar block evaluator for Hopper (sm_90a): the fp32 mode
// with the per-plan precompute folded in, and the reference kernel's bf16
// mode.
//
// Replaces kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas
// of the JAX package (its body is _unified_kernel): BOTH rails of the
// dual-rail delta factorization and BOTH GEMM stages of the Conv4Xbar
// emulator, for every (batch row, crossbar block) pair of one analog
// matmul.  Per block j and row m:
//   fold (once per block), per position (d, w, g) and window tap kk, from
//   the plan's normalized conductance gn = g_norm[j, d, g*K1 + kk, w]:
//     g0 = gn * w0g + b0,  celu0 = celu(g0),
//     y0 = sum_kk celu0[kk] @ w1k[kk] + b1       (C0=16 -> O1=8)
//   stage 0+1, per row:
//     delta = celu(u[m,nb,d,g,kk] * w0v + g0[kk]) - celu0[kk]
//     t_kk  = delta @ w1k[kk]
//     rails = celu(y0 + sum_kk t_kk*pos_kk), celu(y0 + sum_kk t_kk - sum_kk t_kk*pos_kk)
//   tail: row-window convs 8->4 (k=4), 4->32 (k=8), the (1,1,2) W-stage
//   2*32->32, then the FC head FLAT->32 (+ optional fc0 shift) ->16->O.
// Output (2, M*NB*NO, O), rows M-major with j = nb*NO + no innermost.
//
// fp32 mode (fused_kernel).  What bounds it on an H100: operations -- per
// (row, block) 8,192 exponentials (inside the stage-0 CELU) and about 0.25
// MFLOP of fp32 FMA, against a few bytes of drive per row; the fold reads 2 KiB
// of g_norm per block (70 MB for a full-width gemma3-1b mlp.up) where a
// precompute in device memory would be 72 KiB per block (2.5 GB).
//
// What the design does about it:
//   * the fold: one thread per stage-1 position computes its g0, celu0
//     (2 x 16 each) and y0 (8) into registers once per thread block and
//     reuses them for every row of the tile; nothing per plan is written;
//   * warp-local tail: G = 32, so warp (d, w) is one column of stage-1
//     positions, lane = g.  Stage 2 (window 4 over g) is a 4-lane
//     reduce-scatter with shuffles that leaves lane g with channel g % 4
//     of output row g / 4 -- exactly stage 3's input element g -- and
//     stage 3 (window 8 = the whole column) is a 32 x 32 product per
//     warp, lane = output channel, inputs read back as broadcasts from a
//     per-warp stash; no barrier up to here;
//   * R = D*W/2 rows per pass: stage 3 runs on all R rows at once (one
//     weight load per R x 2 rails), then ONE __syncthreads hands the
//     stage-3 columns (double-buffered) to the W-stage and FC head, where
//     each warp takes one (row, rail) -- 2R = D*W of them -- and runs the
//     W-stage, fc0 (four partial chains), fc1 and fc2 with only
//     __syncwarp between them.  One barrier per R rows (six per row
//     before);
//   * every weight lives in shared memory (63 KB a block under CASE_A,
//     two blocks per SM; 167 KB under CASE_B), each read either as a
//     broadcast or by consecutive lanes;
//   * every CELU of this kernel takes exp(x) - 1 from the hardware exp2
//     (celu_ex2) in place of the expm1f routine, which cost more than
//     the stage-1 products; all arithmetic is fp32 FMA on CUDA cores
//     (TF32 products, even as 3xTF32, err ten times more than FMA in
//     this port's other kernels; PERF.md).
// The sums run in another order than the plain version's matmuls and the
// CELU is exp(x) - 1, which move results by a few fp32 roundings.
//
// bf16 mode (unified_kernel<..., true>, the reference's
// compute_dtype=bfloat16; the first design of this kernel): it reads the
// per-plan precompute g0k/celu0k/y0 that the wrapper builds, one thread
// block per (crossbar block, tile of bm rows), one thread per stage-1
// position, the tail one row at a time through shared memory.  Every GEMM
// operand is rounded to bf16 (round to nearest even) and the products
// accumulate in fp32, at the reference dot's places -- the stage-1 delta
// @ w1k[kk], each tail stage, the W-stage and each FC layer.  An
// activation that feeds only a GEMM is rounded once where it is stored;
// weights are rounded where they are read.  Biases, CELU, the rail masks
// and the precompute stay fp32; the arithmetic is scalar fp32 FMA.  A
// product of bf16 values is exact in fp32, so each FMA of the chain
// rounds once, like the plain version's bf16 dot that sums in the same
// order: the two agree bit for bit, where a different summation order
// would flip bf16 roundings downstream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The emulator weights, packed by the wrapper (kernels/emulator_block/
// emulator_block.py:_Weights).  Outside the anonymous namespace: the C
// entry points take it, and a type with internal linkage in their
// signature would keep them from being exported.
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
  const float* w0g;  // (C0,)  stage 0's conductance weight (fp32 mode's fold)
  const float* b0;   // (C0,)
  const float* b1;   // (O1,)  stage 1's bias
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
constexpr unsigned FULL = 0xffffffffu;


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


// ---------------------------------------------------------------------------
// fp32 mode: the fold, the warp-local tail, R rows per barrier
// ---------------------------------------------------------------------------
constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// CELU through the hardware exp2 (__expf: one multiply and MUFU.EX2) where
// expm1f is a software routine of about twenty instructions, 8,192 of
// them per (row, block) in stage 0 alone.  exp(x) - 1 loses expm1's
// relative accuracy near 0 but keeps an absolute error of a few 1e-7, and
// the fold's celu0 uses the same function, so an idle wordline's delta
// stays exactly 0; the outputs stay within 0.2 of the card gate's
// allowance (atol 1e-5 + rtol 1e-4 |plain|) at every case chip_smoke.py
// checks (PERF.md).
__device__ __forceinline__ float celu_ex2(float x) {
  return x > 0.f ? x : __expf(x) - 1.f;
}

// The fp32 kernel's shapes and its shared-memory layout, in floats; every
// array starts on a 16-byte boundary so that float4 reads stay aligned.
template <int D, int W, int O>
struct Fused {
  static constexpr int P = D * W * G;           // threads: stage-1 positions
  static constexpr int NWARP = D * W;           // warp (d, w), lane g
  static constexpr int R = NWARP / 2;           // rows per pass: 2R (row, rail)
  static constexpr int WO = W <= 2 ? 1 : W / 2; // W-stage outputs
  static constexpr int Q4 = D * WO;             // W-stage output rows
  static constexpr int FLAT = Q4 * CW;
  static constexpr int W2S = K2 * 9;            // padded (c, o) row of w2: 36
  static constexpr int W1K = 0;                 // (K1, C0, O1)
  static constexpr int W0V = W1K + K1 * C0 * O1;
  static constexpr int W2 = W0V + C0;           // (K2, 36): w2[kk2*8 + c][o]
  static constexpr int B2 = W2 + K2 * W2S;
  static constexpr int W3 = B2 + 4;             // (K3*C2, C3)
  static constexpr int B3 = W3 + K3 * C2 * C3;
  static constexpr int WST = B3 + C3;           // (2*C3, CW)
  static constexpr int BST = WST + 2 * C3 * CW;
  static constexpr int F0 = BST + CW;           // (FLAT, F1)
  static constexpr int FB0 = F0 + FLAT * F1;
  static constexpr int F1W = FB0 + F1;          // (F1, F2)
  static constexpr int FB1 = F1W + F1 * F2;
  static constexpr int F2W = FB1 + F2;          // (F2, O)
  static constexpr int FB2 = F2W + up4(F2 * O);
  static constexpr int H2 = FB2 + 4;            // (NWARP, 2R, 32) stage-2 out
  static constexpr int H3 = H2 + NWARP * 2 * R * 32;  // (2, 2R, NWARP, 32)
  static constexpr int H4 = H3 + 2 * 2 * R * NWARP * 32;  // (NWARP, FLAT)
  static constexpr int H5 = H4 + NWARP * FLAT;  // (NWARP, F1)
  static constexpr int H6 = H5 + NWARP * F1;    // (NWARP, F2)
  static constexpr int FLOATS = H6 + NWARP * F2;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(NWARP % 2 == 0 && W % 2 == 0, "two rails per row, W pairs");
  static_assert(G == 32 && K2 * K3 == G && K2 * O1 == 32 && K3 * C2 == 32,
                "one warp is one stage-1 column; stage 3 takes it whole");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int W, int O>
__global__ void __launch_bounds__(D * W * G, D * W * G <= 256 ? 2 : 1)
fused_kernel(const float* __restrict__ u, const float* __restrict__ pos,
             const float* __restrict__ gn, const float* __restrict__ shift,
             int shift_per_block, Weights wt, float* __restrict__ out,
             int M, int NB, int NO, int bm) {
  using L = Fused<D, W, O>;
  constexpr int P = L::P, NWARP = L::NWARP, R = L::R, WO = L::WO;
  constexpr int Q4 = L::Q4, FLAT = L::FLAT;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const long long j = blockIdx.x;             // crossbar block nb*NO + no
  const long long nblk = (long long)NB * NO;
  const long long nb = j / NO;
  const int m0 = blockIdx.y * bm;
  const int m1 = min(M, m0 + bm);

  // ---- the weights to shared memory; the stage-2 stash zeroed ----------
  auto copy = [&](int at, const float* src, int n) {
    for (int i = tid; i < n; i += P) s[at + i] = __ldg(src + i);
  };
  copy(L::W1K, wt.w1k, K1 * C0 * O1);
  copy(L::W0V, wt.w0v, C0);
  for (int i = tid; i < K2 * O1 * C2; i += P)
    s[L::W2 + (i / (O1 * C2)) * L::W2S + i % (O1 * C2)] = __ldg(wt.w2 + i);
  copy(L::B2, wt.b2, C2);
  copy(L::W3, wt.w3, K3 * C2 * C3);
  copy(L::B3, wt.b3, C3);
  copy(L::WST, wt.wst, 2 * C3 * CW);
  copy(L::BST, wt.bst, CW);
  copy(L::F0, wt.f0, FLAT * F1);
  copy(L::FB0, wt.fb0, F1);
  copy(L::F1W, wt.f1, F1 * F2);
  copy(L::FB1, wt.fb1, F2);
  copy(L::F2W, wt.f2, F2 * O);
  copy(L::FB2, wt.fb2, O);
  for (int i = tid; i < NWARP * 2 * R * 32; i += P) s[L::H2 + i] = 0.f;

  // ---- the fold: this position's g0, celu0 and y0, once per block -------
  // position (d, w, g) = (warp / W, warp % W, lane); g_norm is (NB*NO, D,
  // H, W) and tap kk of row group g is wordline g*K1 + kk
  const int d = wi / W, w = wi % W, g = lane;
  float g0[K1][C0], c0[K1][C0], y0[O1];
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
    const float gv = __ldg(gn + ((j * D + d) * H + g * K1 + kk) * W + w);
#pragma unroll
    for (int c = 0; c < C0; ++c) {
      // rounded apart, as the plain version's multiply and add are
      g0[kk][c] = __fadd_rn(__fmul_rn(gv, __ldg(wt.w0g + c)), __ldg(wt.b0 + c));
      c0[kk][c] = celu_ex2(g0[kk][c]);
    }
  }
#pragma unroll
  for (int o = 0; o < O1; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int kk = 0; kk < K1; ++kk)
#pragma unroll
      for (int c = 0; c < C0; ++c)
        acc = fmaf(c0[kk][c], __ldg(wt.w1k + (kk * C0 + c) * O1 + o), acc);
    y0[o] = acc + __ldg(wt.b1 + o);
  }
  __syncthreads();

  float w0v[C0];
#pragma unroll
  for (int c = 0; c < C0; ++c) w0v[c] = s[L::W0V + c];
  float* h2w = s + L::H2 + wi * (2 * R * 32);   // this warp's stage-2 stash
  int buf = 0;
  for (int mg = m0; mg < m1; mg += R, buf ^= 1) {
    const int nr = min(R, m1 - mg);
    for (int r = 0; r < nr; ++r) {
      // ---- stage 0+1: both rails from one magnitude-drive CELU --------
      const long long ub = (((long long)(mg + r) * NB + nb) * D + d) * H + g * K1;
      const float2 uv = __ldg(reinterpret_cast<const float2*>(u + ub));
      const float2 pv = __ldg(reinterpret_cast<const float2*>(pos + ub));
      float tf[O1], tp[O1];
#pragma unroll
      for (int kk = 0; kk < K1; ++kk) {
        const float uk = kk == 0 ? uv.x : uv.y;
        const float pk = kk == 0 ? pv.x : pv.y;
        float t[O1];
#pragma unroll
        for (int o = 0; o < O1; ++o) t[o] = 0.f;
#pragma unroll
        for (int c = 0; c < C0; ++c) {
          const float dl = celu_ex2(uk * w0v[c] + g0[kk][c]) - c0[kk][c];
          const float4 wa = ld4(s + L::W1K + (kk * C0 + c) * O1);
          const float4 wb = ld4(s + L::W1K + (kk * C0 + c) * O1 + 4);
          t[0] = fmaf(dl, wa.x, t[0]); t[1] = fmaf(dl, wa.y, t[1]);
          t[2] = fmaf(dl, wa.z, t[2]); t[3] = fmaf(dl, wa.w, t[3]);
          t[4] = fmaf(dl, wb.x, t[4]); t[5] = fmaf(dl, wb.y, t[5]);
          t[6] = fmaf(dl, wb.z, t[6]); t[7] = fmaf(dl, wb.w, t[7]);
        }
#pragma unroll
        for (int o = 0; o < O1; ++o) {
          tf[o] = kk == 0 ? t[o] : tf[o] + t[o];
          tp[o] = kk == 0 ? t[o] * pk : tp[o] + t[o] * pk;
        }
      }
      float a[2][O1];
#pragma unroll
      for (int o = 0; o < O1; ++o) {
        a[0][o] = celu_ex2(y0[o] + tp[o]);
        a[1][o] = celu_ex2((y0[o] + tf[o]) - tp[o]);
      }
      // ---- stage 2: window K2 over g, 8 -> 4 channels -----------------
      // lane g's share of output row g/4: its 8 channels against rows
      // (g%4)*8 + c of w2
      float p[2][C2];
#pragma unroll
      for (int q = 0; q < C2; ++q) p[0][q] = p[1][q] = 0.f;
#pragma unroll
      for (int c = 0; c < O1; ++c) {
        const float4 wv = ld4(s + L::W2 + (g & 3) * L::W2S + c * C2);
#pragma unroll
        for (int rl = 0; rl < 2; ++rl) {
          p[rl][0] = fmaf(a[rl][c], wv.x, p[rl][0]);
          p[rl][1] = fmaf(a[rl][c], wv.y, p[rl][1]);
          p[rl][2] = fmaf(a[rl][c], wv.z, p[rl][2]);
          p[rl][3] = fmaf(a[rl][c], wv.w, p[rl][3]);
        }
      }
      // reduce-scatter over the 4 lanes of the window: lane g keeps
      // channel g % 4 (bit 1 of the lane picks the channel pair, bit 0
      // the channel), which is stage 3's input element g
      const bool hi = lane & 2, odd = lane & 1;
#pragma unroll
      for (int rl = 0; rl < 2; ++rl) {
        float k0 = hi ? p[rl][2] : p[rl][0];
        float k1 = hi ? p[rl][3] : p[rl][1];
        k0 += __shfl_xor_sync(FULL, hi ? p[rl][0] : p[rl][2], 2);
        k1 += __shfl_xor_sync(FULL, hi ? p[rl][1] : p[rl][3], 2);
        float k = odd ? k1 : k0;
        k += __shfl_xor_sync(FULL, odd ? k0 : k1, 1);
        h2w[(2 * r + rl) * 32 + lane] = celu_ex2(k + s[L::B2 + (lane & 3)]);
      }
    }
    __syncwarp();

    // ---- stage 3: the column's 32 inputs -> 32 channels, R rows at once
    // (rows past nr run on stale inputs; the head never reads them)
    float acc[2 * R];
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) acc[i] = 0.f;
#pragma unroll
    for (int kq = 0; kq < K3 * C2 / 4; ++kq) {
      const float w0 = s[L::W3 + (4 * kq) * C3 + lane];
      const float w1 = s[L::W3 + (4 * kq + 1) * C3 + lane];
      const float w2 = s[L::W3 + (4 * kq + 2) * C3 + lane];
      const float w3 = s[L::W3 + (4 * kq + 3) * C3 + lane];
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) {
        const float4 x = ld4(h2w + i * 32 + 4 * kq);
        acc[i] = fmaf(x.x, w0, acc[i]);
        acc[i] = fmaf(x.y, w1, acc[i]);
        acc[i] = fmaf(x.z, w2, acc[i]);
        acc[i] = fmaf(x.w, w3, acc[i]);
      }
    }
    float* h3 = s + L::H3 + buf * (2 * R * NWARP * 32);   // (2R, NWARP, 32)
    const float b3 = s[L::B3 + lane];
#pragma unroll
    for (int i = 0; i < 2 * R; ++i)
      h3[(i * NWARP + wi) * 32 + lane] = celu_ex2(acc[i] + b3);
    __syncthreads();

    // ---- W-stage and FC head: warp wi takes (row wi/2, rail wi%2) ------
    const int r = wi >> 1, rail = wi & 1;
    if (mg + r < m1) {
      const float* in = h3 + wi * NWARP * 32;   // the row-rail's columns
      float a4[Q4];
#pragma unroll
      for (int q = 0; q < Q4; ++q) a4[q] = 0.f;
      // column pairs (2wo, 2wo+1) of tile dq: 64 contiguous inputs
#pragma unroll 4
      for (int kq = 0; kq < 2 * C3 / 4; ++kq) {
        const float w0 = s[L::WST + (4 * kq) * CW + lane];
        const float w1 = s[L::WST + (4 * kq + 1) * CW + lane];
        const float w2 = s[L::WST + (4 * kq + 2) * CW + lane];
        const float w3 = s[L::WST + (4 * kq + 3) * CW + lane];
#pragma unroll
        for (int q = 0; q < Q4; ++q) {
          const float4 x = ld4(in + ((q / WO) * W + 2 * (q % WO)) * C3 + 4 * kq);
          a4[q] = fmaf(x.x, w0, a4[q]);
          a4[q] = fmaf(x.y, w1, a4[q]);
          a4[q] = fmaf(x.z, w2, a4[q]);
          a4[q] = fmaf(x.w, w3, a4[q]);
        }
      }
      float* h4 = s + L::H4 + wi * FLAT;
      const float bst = s[L::BST + lane];
#pragma unroll
      for (int q = 0; q < Q4; ++q) h4[q * CW + lane] = celu_ex2(a4[q] + bst);
      __syncwarp();
      // fc0: lane = output; four partial chains over the FLAT inputs
      float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int kq = 0; kq < FLAT / 4; ++kq) {
        const float4 x = ld4(h4 + 4 * kq);
        f[0] = fmaf(x.x, s[L::F0 + (4 * kq) * F1 + lane], f[0]);
        f[1] = fmaf(x.y, s[L::F0 + (4 * kq + 1) * F1 + lane], f[1]);
        f[2] = fmaf(x.z, s[L::F0 + (4 * kq + 2) * F1 + lane], f[2]);
        f[3] = fmaf(x.w, s[L::F0 + (4 * kq + 3) * F1 + lane], f[3]);
      }
      float h = ((f[0] + f[1]) + (f[2] + f[3])) + s[L::FB0 + lane];
      if (shift != nullptr)
        h = h + __ldg(shift + (shift_per_block ? j * F1 : 0) + lane);
      float* h5 = s + L::H5 + wi * F1;
      h5[lane] = celu_ex2(h);
      __syncwarp();
      // fc1: lanes o and o + 16 compute output o
      const int o1 = lane & (F2 - 1);
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int kq = 0; kq < F1 / 4; ++kq) {
        const float4 x = ld4(h5 + 4 * kq);
        e0 = fmaf(x.x, s[L::F1W + (4 * kq) * F2 + o1], e0);
        e1 = fmaf(x.y, s[L::F1W + (4 * kq + 1) * F2 + o1], e1);
        e0 = fmaf(x.z, s[L::F1W + (4 * kq + 2) * F2 + o1], e0);
        e1 = fmaf(x.w, s[L::F1W + (4 * kq + 3) * F2 + o1], e1);
      }
      float* h6 = s + L::H6 + wi * F2;
      const float v6 = celu_ex2((e0 + e1) + s[L::FB1 + o1]);
      if (lane < F2) h6[lane] = v6;
      __syncwarp();
      if (lane < O) {
        float y = 0.f;
#pragma unroll
        for (int k = 0; k < F2; ++k) y = fmaf(h6[k], s[L::F2W + k * O + lane], y);
        out[((rail * (long long)M + mg + r) * nblk + j) * O + lane] =
            y + s[L::FB2 + lane];
      }
    }
  }
}

template <int D, int W, int O>
int launch_f32(const float* u, const float* pos, const float* gn,
               const float* shift, int shift_per_block, const Weights& wt,
               float* out, int M, int NB, int NO, int bm, cudaStream_t stream) {
  constexpr int bytes = Fused<D, W, O>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_kernel<D, W, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  fused_kernel<D, W, O><<<grid, Fused<D, W, O>::P, bytes, stream>>>(
      u, pos, gn, shift, shift_per_block, wt, out, M, NB, NO, bm);
  return (int)cudaGetLastError();
}

template <int D, int W, int O>
int launch_bf16(const float* u, const float* pos, const float* g0k,
                const float* celu0k, const float* y0, const float* shift,
                int shift_per_block, const Weights& wt, float* out, int M,
                int NB, int NO, int bm, cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  unified_kernel<D, W, O, true><<<grid, D * W * G, 0, stream>>>(
      u, pos, g0k, celu0k, y0, shift, shift_per_block, wt, out, M, NB, NO, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).
// Each returns the launch's cudaError_t (0 = launched); -1 for an unknown
// geom.

// fp32 mode: g_norm (NB*NO, D, H, W), the plan's normalized conductances.
extern "C" int emulator_block_unified_f32(
    int geom, const float* u, const float* pos, const float* g_norm,
    const float* shift, int shift_per_block, const Weights* wt, float* out,
    int M, int NB, int NO, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_f32<4, 2, 1>(u, pos, g_norm, shift, shift_per_block, *wt,
                               out, M, NB, NO, bm, s);
  if (geom == 1)
    return launch_f32<2, 8, 4>(u, pos, g_norm, shift, shift_per_block, *wt,
                               out, M, NB, NO, bm, s);
  return -1;
}

// bf16 mode: the per-plan precompute g0k, celu0k, y0.
extern "C" int emulator_block_unified_bf16(
    int geom, const float* u, const float* pos, const float* g0k,
    const float* celu0k, const float* y0, const float* shift,
    int shift_per_block, const Weights* wt, float* out, int M, int NB, int NO,
    int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_bf16<4, 2, 1>(u, pos, g0k, celu0k, y0, shift,
                                shift_per_block, *wt, out, M, NB, NO, bm, s);
  if (geom == 1)
    return launch_bf16<2, 8, 4>(u, pos, g0k, celu0k, y0, shift,
                                shift_per_block, *wt, out, M, NB, NO, bm, s);
  return -1;
}

// Dynamic shared memory of one fp32 thread block, in bytes; -1 for an
// unknown geom.
extern "C" int emulator_block_unified_f32_smem(int geom) {
  if (geom == 0) return Fused<4, 2, 1>::BYTES;
  if (geom == 1) return Fused<2, 8, 4>::BYTES;
  return -1;
}
