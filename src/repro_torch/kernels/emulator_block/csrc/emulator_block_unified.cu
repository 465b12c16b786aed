// Unified Conv4Xbar block evaluator for Hopper (sm_90a): one kernel,
// fused_kernel<..., BF16>, for the fp32 mode and the reference kernel's
// bf16 mode, both folding the per-plan precompute in.
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
// What bounds it on an H100: operations -- per (row, block) 8,192
// exponentials (inside the stage-0 CELU) and about 0.25 MFLOP of fp32 FMA,
// against a few bytes of drive per row; the fold reads 2 KiB of g_norm per
// block (70 MB for a full-width gemma3-1b mlp.up) where a precompute in
// device memory would be 72 KiB per block (2.5 GB).
//
// What the design does about it:
//   * the fold: one thread per stage-1 position computes its g0, celu0
//     (2 x 16 each) and y0 (8) into registers once per thread block and
//     reuses them for every row of the tile; nothing per plan is written;
//   * warp-local tail: G = 32, so warp (d, w) is one column of stage-1
//     positions, lane = g.  Stage 2 (window 4 over g) leaves lane g with
//     channel g % 4 of output row g / 4 -- exactly stage 3's input element
//     g -- and stage 3 (window 8 = the whole column) is a 32 x 32 product
//     per warp, lane = output channel, inputs read back as broadcasts from
//     a per-warp stash; no barrier up to here;
//   * R = D*W/2 rows per pass: stage 3 runs on all R rows at once (one
//     weight load per R x 2 rails), then ONE __syncthreads hands the
//     stage-3 columns (double-buffered) to the W-stage and FC head, where
//     each warp takes one (row, rail) -- 2R = D*W of them -- and runs the
//     W-stage, fc0, fc1 and fc2 with only __syncwarp between them;
//   * every weight lives in shared memory (63 KB a block in fp32 under
//     CASE_A, two blocks per SM; 167 KB under CASE_B), each read either as
//     a broadcast or by consecutive lanes; all arithmetic is fp32 FMA on
//     the CUDA cores (TF32 products, even as 3xTF32, err ten times more
//     than FMA in this port's other kernels; PERF.md).
//
// fp32 mode: every CELU takes exp(x) - 1 from the hardware exp2
// (celu_ex2) in place of the expm1f routine, which cost more than the
// stage-1 products; stage 2 is a 4-lane reduce-scatter with shuffles, fc0
// runs four partial chains and fc1 two.  The sums run in another order
// than the plain version's matmuls and the CELU is exp(x) - 1, which move
// results by a few fp32 roundings.
//
// bf16 mode (the reference's compute_dtype=bfloat16): every GEMM operand
// is rounded to bf16 (round to nearest even) and the products accumulate
// in fp32, at the reference dot's places -- the stage-1 delta @ w1k[kk],
// each tail stage, the W-stage and each FC layer.  A weight is rounded
// once, where it is copied to shared memory; an activation that feeds a
// GEMM is rounded where it is stored.  Biases, the fold, the rail masks,
// the fc0 shift and the output stay fp32.  A product of bf16 values is
// exact in fp32, so each FMA of a chain rounds once, like the plain
// version's bf16_dot, which sums each contraction in order from index 0;
// every contraction here is one chain in that order, so the two agree bit
// for bit, where another order would flip bf16 roundings downstream.
// Hence, in this mode only: every CELU is expm1f (torch's expm1 on the
// card gives the same bits), g0, stage 0 and the rail sums round each
// multiply and add apart as the plain version's tensor ops do, y0 is one
// fp32 chain of rounded multiplies and adds (the plain version's
// f32_dot), stage 2 reads the window's 32 inputs back from a per-warp
// stash so that lane g sums output (g/4, g%4) as one chain, and fc0 and
// fc1 are one chain each.
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
  const float* w0g;  // (C0,)  stage 0's conductance weight (the fold)
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


// CELU as the plain version takes it: expm1f (the bf16 mode's, whose bits
// torch's expm1 on the card shares)
__device__ __forceinline__ float celu(float x) { return x > 0.f ? x : expm1f(x); }

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

// every CELU of a mode: exp2 in fp32, expm1f in bf16
template <bool BF16>
__device__ __forceinline__ float celu_of(float x) {
  if constexpr (BF16) return celu(x);
  else return celu_ex2(x);
}

// a GEMM operand: itself in fp32 mode, rounded to bf16 in bf16 mode
template <bool BF16>
__device__ __forceinline__ float op(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// The kernel's shapes and its shared-memory layout, in floats; every array
// starts on a 16-byte boundary so that float4 reads stay aligned.  w2 is
// (K2, 36) in fp32 mode -- w2[kk2*8 + c][o] at kk2*36 + c*4 + o -- and
// (C2, 36) in bf16 mode -- w2[k][o] at o*36 + k.  The bf16 mode adds the
// stage-2 input stash S2: per warp and rail, the column's 8 windows of 32
// inputs, each padded to 36 floats (two windows a quarter-warp read, on
// other banks).
template <int D, int W, int O, bool BF16>
struct Fused {
  static constexpr int P = D * W * G;           // threads: stage-1 positions
  static constexpr int NWARP = D * W;           // warp (d, w), lane g
  static constexpr int R = NWARP / 2;           // rows per pass: 2R (row, rail)
  static constexpr int WO = W <= 2 ? 1 : W / 2; // W-stage outputs
  static constexpr int Q4 = D * WO;             // W-stage output rows
  static constexpr int FLAT = Q4 * CW;
  static constexpr int W2S = K2 * 9;            // a padded row of 32 floats: 36
  static constexpr int W1K = 0;                 // (K1, C0, O1)
  static constexpr int W0V = W1K + K1 * C0 * O1;
  static constexpr int W2 = W0V + C0;           // (4, 36), see above
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
  static constexpr int S2R = (G / K2) * W2S;    // one rail's stash: 8 x 36
  static constexpr int S2 = H6 + NWARP * F2;    // bf16: (NWARP, 2, 8, 36)
  static constexpr int FLOATS = S2 + (BF16 ? NWARP * 2 * S2R : 0);
  static constexpr int BYTES = FLOATS * 4;
  static_assert(NWARP % 2 == 0 && W % 2 == 0, "two rails per row, W pairs");
  static_assert(G == 32 && K2 * K3 == G && K2 * O1 == 32 && K3 * C2 == 32,
                "one warp is one stage-1 column; stage 3 takes it whole");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int W, int O, bool BF16>
__global__ void __launch_bounds__(D * W * G, D * W * G <= 256 ? 2 : 1)
fused_kernel(const float* __restrict__ u, const float* __restrict__ pos,
             const float* __restrict__ gn, const float* __restrict__ shift,
             int shift_per_block, Weights wt, float* __restrict__ out,
             int M, int NB, int NO, int bm) {
  using L = Fused<D, W, O, BF16>;
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

  // ---- the weights to shared memory (a GEMM's rounded to bf16 once, in
  // bf16 mode); the stage-2 stash zeroed ----------------------------------
  auto copy = [&](int at, const float* src, int n) {
    for (int i = tid; i < n; i += P) s[at + i] = __ldg(src + i);
  };
  auto copy_op = [&](int at, const float* src, int n) {
    for (int i = tid; i < n; i += P) s[at + i] = op<BF16>(__ldg(src + i));
  };
  copy_op(L::W1K, wt.w1k, K1 * C0 * O1);
  copy(L::W0V, wt.w0v, C0);
  for (int i = tid; i < K2 * O1 * C2; i += P) {
    if constexpr (BF16)
      s[L::W2 + (i % C2) * L::W2S + i / C2] = op<true>(__ldg(wt.w2 + i));
    else
      s[L::W2 + (i / (O1 * C2)) * L::W2S + i % (O1 * C2)] = __ldg(wt.w2 + i);
  }
  copy(L::B2, wt.b2, C2);
  copy_op(L::W3, wt.w3, K3 * C2 * C3);
  copy(L::B3, wt.b3, C3);
  copy_op(L::WST, wt.wst, 2 * C3 * CW);
  copy(L::BST, wt.bst, CW);
  copy_op(L::F0, wt.f0, FLAT * F1);
  copy(L::FB0, wt.fb0, F1);
  copy_op(L::F1W, wt.f1, F1 * F2);
  copy(L::FB1, wt.fb1, F2);
  copy_op(L::F2W, wt.f2, F2 * O);
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
      c0[kk][c] = celu_of<BF16>(g0[kk][c]);
    }
  }
  // y0 from the fp32 w1k: in bf16 mode one chain, each multiply and add
  // rounded apart in the plain version's order k = kk*C0 + c
#pragma unroll
  for (int o = 0; o < O1; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int kk = 0; kk < K1; ++kk)
#pragma unroll
      for (int c = 0; c < C0; ++c) {
        const float wv = __ldg(wt.w1k + (kk * C0 + c) * O1 + o);
        if constexpr (BF16)
          acc = __fadd_rn(acc, __fmul_rn(c0[kk][c], wv));
        else
          acc = fmaf(c0[kk][c], wv, acc);
      }
    if constexpr (BF16)
      y0[o] = __fadd_rn(acc, __ldg(wt.b1 + o));
    else
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
          float dl;
          if constexpr (BF16)   // rounded apart, as in the plain version
            dl = op<true>(celu(__fadd_rn(__fmul_rn(uk, w0v[c]), g0[kk][c]))
                          - c0[kk][c]);
          else
            dl = celu_ex2(uk * w0v[c] + g0[kk][c]) - c0[kk][c];
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
          if constexpr (BF16)
            tp[o] = kk == 0 ? __fmul_rn(t[o], pk)
                            : __fadd_rn(tp[o], __fmul_rn(t[o], pk));
          else
            tp[o] = kk == 0 ? t[o] * pk : tp[o] + t[o] * pk;
        }
      }
      float a[2][O1];
#pragma unroll
      for (int o = 0; o < O1; ++o) {
        a[0][o] = op<BF16>(celu_of<BF16>(y0[o] + tp[o]));
        a[1][o] = op<BF16>(celu_of<BF16>((y0[o] + tf[o]) - tp[o]));
      }
      // ---- stage 2: window K2 over g, 8 -> 4 channels -----------------
      if constexpr (BF16) {
        // the window's 32 inputs k = (g % 4)*8 + c through the stash; lane
        // g sums output (g/4, g%4) over them as one chain, in order
        float* s2w = s + L::S2 + wi * (2 * L::S2R) + (lane >> 2) * L::W2S;
        __syncwarp();             // the previous row's reads are done
#pragma unroll
        for (int rl = 0; rl < 2; ++rl) {
          float4* dst = reinterpret_cast<float4*>(s2w + rl * L::S2R + (lane & 3) * O1);
          dst[0] = make_float4(a[rl][0], a[rl][1], a[rl][2], a[rl][3]);
          dst[1] = make_float4(a[rl][4], a[rl][5], a[rl][6], a[rl][7]);
        }
        __syncwarp();
        const float* w2c = s + L::W2 + (lane & 3) * L::W2S;
        float k0 = 0.f, k1 = 0.f;
#pragma unroll
        for (int kq = 0; kq < K2 * O1 / 4; ++kq) {
          const float4 wv = ld4(w2c + 4 * kq);
          const float4 x0 = ld4(s2w + 4 * kq);
          const float4 x1 = ld4(s2w + L::S2R + 4 * kq);
          k0 = fmaf(x0.x, wv.x, k0); k1 = fmaf(x1.x, wv.x, k1);
          k0 = fmaf(x0.y, wv.y, k0); k1 = fmaf(x1.y, wv.y, k1);
          k0 = fmaf(x0.z, wv.z, k0); k1 = fmaf(x1.z, wv.z, k1);
          k0 = fmaf(x0.w, wv.w, k0); k1 = fmaf(x1.w, wv.w, k1);
        }
        const float b2 = s[L::B2 + (lane & 3)];
        h2w[(2 * r) * 32 + lane] = op<true>(celu(k0 + b2));
        h2w[(2 * r + 1) * 32 + lane] = op<true>(celu(k1 + b2));
      } else {
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
      h3[(i * NWARP + wi) * 32 + lane] = op<BF16>(celu_of<BF16>(acc[i] + b3));
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
      for (int q = 0; q < Q4; ++q)
        h4[q * CW + lane] = op<BF16>(celu_of<BF16>(a4[q] + bst));
      __syncwarp();
      // fc0: lane = output; one chain over the FLAT inputs in bf16 mode,
      // four partial chains in fp32
      float h;
      if constexpr (BF16) {
        float f = 0.f;
#pragma unroll 8
        for (int kq = 0; kq < FLAT / 4; ++kq) {
          const float4 x = ld4(h4 + 4 * kq);
          f = fmaf(x.x, s[L::F0 + (4 * kq) * F1 + lane], f);
          f = fmaf(x.y, s[L::F0 + (4 * kq + 1) * F1 + lane], f);
          f = fmaf(x.z, s[L::F0 + (4 * kq + 2) * F1 + lane], f);
          f = fmaf(x.w, s[L::F0 + (4 * kq + 3) * F1 + lane], f);
        }
        h = f + s[L::FB0 + lane];
      } else {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int kq = 0; kq < FLAT / 4; ++kq) {
          const float4 x = ld4(h4 + 4 * kq);
          f[0] = fmaf(x.x, s[L::F0 + (4 * kq) * F1 + lane], f[0]);
          f[1] = fmaf(x.y, s[L::F0 + (4 * kq + 1) * F1 + lane], f[1]);
          f[2] = fmaf(x.z, s[L::F0 + (4 * kq + 2) * F1 + lane], f[2]);
          f[3] = fmaf(x.w, s[L::F0 + (4 * kq + 3) * F1 + lane], f[3]);
        }
        h = ((f[0] + f[1]) + (f[2] + f[3])) + s[L::FB0 + lane];
      }
      if (shift != nullptr)
        h = h + __ldg(shift + (shift_per_block ? j * F1 : 0) + lane);
      float* h5 = s + L::H5 + wi * F1;
      h5[lane] = op<BF16>(celu_of<BF16>(h));
      __syncwarp();
      // fc1: lanes o and o + 16 compute output o (one chain in bf16 mode,
      // two in fp32)
      const int o1 = lane & (F2 - 1);
      float e;
      if constexpr (BF16) {
        e = 0.f;
#pragma unroll
        for (int kq = 0; kq < F1 / 4; ++kq) {
          const float4 x = ld4(h5 + 4 * kq);
          e = fmaf(x.x, s[L::F1W + (4 * kq) * F2 + o1], e);
          e = fmaf(x.y, s[L::F1W + (4 * kq + 1) * F2 + o1], e);
          e = fmaf(x.z, s[L::F1W + (4 * kq + 2) * F2 + o1], e);
          e = fmaf(x.w, s[L::F1W + (4 * kq + 3) * F2 + o1], e);
        }
      } else {
        float e0 = 0.f, e1 = 0.f;
#pragma unroll
        for (int kq = 0; kq < F1 / 4; ++kq) {
          const float4 x = ld4(h5 + 4 * kq);
          e0 = fmaf(x.x, s[L::F1W + (4 * kq) * F2 + o1], e0);
          e1 = fmaf(x.y, s[L::F1W + (4 * kq + 1) * F2 + o1], e1);
          e0 = fmaf(x.z, s[L::F1W + (4 * kq + 2) * F2 + o1], e0);
          e1 = fmaf(x.w, s[L::F1W + (4 * kq + 3) * F2 + o1], e1);
        }
        e = e0 + e1;
      }
      float* h6 = s + L::H6 + wi * F2;
      const float v6 = op<BF16>(celu_of<BF16>(e + s[L::FB1 + o1]));
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

template <int D, int W, int O, bool BF16>
int launch(const float* u, const float* pos, const float* gn,
           const float* shift, int shift_per_block, const Weights& wt,
           float* out, int M, int NB, int NO, int bm, cudaStream_t stream) {
  constexpr int bytes = Fused<D, W, O, BF16>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_kernel<D, W, O, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  fused_kernel<D, W, O, BF16><<<grid, Fused<D, W, O, BF16>::P, bytes, stream>>>(
      u, pos, gn, shift, shift_per_block, wt, out, M, NB, NO, bm);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(int geom, const float* u, const float* pos, const float* gn,
             const float* shift, int shift_per_block, const Weights* wt,
             float* out, int M, int NB, int NO, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch<4, 2, 1, BF16>(u, pos, gn, shift, shift_per_block, *wt, out,
                                 M, NB, NO, bm, s);
  if (geom == 1)
    return launch<2, 8, 4, BF16>(u, pos, gn, shift, shift_per_block, *wt, out,
                                 M, NB, NO, bm, s);
  return -1;
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).  Both
// modes take g_norm (NB*NO, D, H, W), the plan's normalized conductances.
// Each returns the launch's cudaError_t (0 = launched); -1 for an unknown
// geom.
extern "C" int emulator_block_unified_f32(
    int geom, const float* u, const float* pos, const float* g_norm,
    const float* shift, int shift_per_block, const Weights* wt, float* out,
    int M, int NB, int NO, int bm, void* stream) {
  return dispatch<false>(geom, u, pos, g_norm, shift, shift_per_block, wt, out,
                         M, NB, NO, bm, stream);
}

extern "C" int emulator_block_unified_bf16(
    int geom, const float* u, const float* pos, const float* g_norm,
    const float* shift, int shift_per_block, const Weights* wt, float* out,
    int M, int NB, int NO, int bm, void* stream) {
  return dispatch<true>(geom, u, pos, g_norm, shift, shift_per_block, wt, out,
                        M, NB, NO, bm, stream);
}

// Dynamic shared memory of one thread block, in bytes, of the fp32 (bf16
// = 0) or the bf16 mode; -1 for an unknown geom.
extern "C" int emulator_block_unified_smem(int geom, int bf16) {
  if (geom == 0) return bf16 ? Fused<4, 2, 1, true>::BYTES : Fused<4, 2, 1, false>::BYTES;
  if (geom == 1) return bf16 ? Fused<2, 8, 4, true>::BYTES : Fused<2, 8, 4, false>::BYTES;
  return -1;
}
