// Unified Conv4Xbar block evaluator for Hopper (sm_90a): one kernel,
// fused_kernel<..., BF16>, for the fp32 mode and the reference kernel's
// bf16 mode, both folding the per-plan precompute in.
//
// Replaces kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas
// of the JAX package (its body is _unified_kernel): BOTH rails of the
// dual-rail delta factorization and BOTH GEMM stages of the Conv4Xbar
// emulator, for every (batch row, crossbar block) pair of one analog
// matmul.  Per block j and row m:
//   fold (once per block and row tile), per position (d, w, g) and window
//   tap kk, from the plan's normalized conductance
//   gn = g_norm[j, d, g*K1 + kk, w]:
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
//   * persistent thread blocks: the work items are the (crossbar block,
//     row tile) pairs, j innermost; the launch keeps no more thread blocks
//     than the card holds resident (the wrapper asks the runtime's
//     occupancy, emulator_block_unified_resident), so the weights go to
//     shared memory once per thread block, not once per item.  Thread
//     block b takes item b, then draws each next item from a counter in
//     device memory (the ticket) while its current item runs: the two
//     thread blocks an SM holds progress at rates up to 15% apart, and a
//     fixed share of the items each left one SM slot idle for the last 15%
//     of a call (PERF.md); drawn, all finish within a few items, and the
//     thread blocks work on neighbouring items, which share their drive
//     rows.  The last thread block out sets the ticket back to zero.  Where
//     the items are no more than the resident thread blocks, each takes
//     one;
//   * the fold: one thread per stage-1 position computes its g0, celu0
//     (2 x 16 each) and y0 (8) into registers once per item, from the
//     weights in shared memory, and reuses them for every row of the tile;
//     the next item's two g_norm values go to L1 while this item's rows run
//     (held in registers, they spilled); nothing per plan is written;
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
//     CASE_A, two blocks per SM; 167 KB under CASE_B), copied in 16-byte
//     pieces where the source is aligned, each read either as a broadcast
//     or by consecutive lanes; all arithmetic is fp32 FMA on
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
// (C2, 36) in bf16 mode -- w2[k][o] at o*36 + k.  The fold's weights
// follow the head's: w0g, b0, b1 and, in bf16 mode, w1k again unrounded
// (W1F; in fp32 mode W1K is already the fp32 w1k).  The bf16 mode adds the
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
  static constexpr int W0G = FB2 + 4;           // (C0,) the fold's
  static constexpr int B0 = W0G + C0;           // (C0,)
  static constexpr int B1 = B0 + C0;            // (O1,)
  static constexpr int W1F = BF16 ? B1 + O1 : W1K;  // (K1, C0, O1) fp32
  static constexpr int H2 = B1 + O1 + (BF16 ? K1 * C0 * O1 : 0);  // (NWARP, 2R, 32) stage-2 out
  static constexpr int H3 = H2 + NWARP * 2 * R * 32;  // (2, 2R, NWARP, 32)
  static constexpr int H4 = H3 + 2 * 2 * R * NWARP * 32;  // (NWARP, FLAT)
  static constexpr int H5 = H4 + NWARP * FLAT;  // (NWARP, F1)
  static constexpr int H6 = H5 + NWARP * F1;    // (NWARP, F2)
  static constexpr int S2R = (G / K2) * W2S;    // one rail's stash: 8 x 36
  static constexpr int S2 = H6 + NWARP * F2;    // bf16: (NWARP, 2, 8, 36)
  static constexpr int NXT = S2 + (BF16 ? NWARP * 2 * S2R : 0);  // 2 ints
  static constexpr int FLOATS = NXT + 4;
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
             int M, int NB, int NO, int bm, int* __restrict__ ticket) {
  using L = Fused<D, W, O, BF16>;
  constexpr int P = L::P, NWARP = L::NWARP, R = L::R, WO = L::WO;
  constexpr int Q4 = L::Q4, FLAT = L::FLAT;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);

  // item i is crossbar block j = i % (NB*NO) (nb*NO + no) of row tile
  // i / (NB*NO), rows [m0, m0 + bm); thread block b takes item b first, then
  // ticket[0]'s next count past the grid, drawn while its item runs
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int nblk = NB * NO;
  const int items = nblk * ((M + bm - 1) / bm);
  int* nxt = reinterpret_cast<int*>(s + L::NXT);   // by item parity

  // ---- the weights to shared memory, once (a GEMM's rounded to bf16 in
  // bf16 mode; 16-byte pieces where the source allows); the stage-2 stash
  // zeroed -------------------------------------------------------------------
  auto copy = [&](int at, const float* src, int n, bool rnd) {
    if (reinterpret_cast<size_t>(src) % 16 == 0 && n % 4 == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      for (int i = tid; i < n / 4; i += P) {
        float4 v = __ldg(s4 + i);
        if (rnd) {
          v.x = op<BF16>(v.x); v.y = op<BF16>(v.y);
          v.z = op<BF16>(v.z); v.w = op<BF16>(v.w);
        }
        smem4[at / 4 + i] = v;
      }
    } else {
      for (int i = tid; i < n; i += P) {
        const float v = __ldg(src + i);
        s[at + i] = rnd ? op<BF16>(v) : v;
      }
    }
  };
  copy(L::W1K, wt.w1k, K1 * C0 * O1, true);
  if constexpr (BF16) copy(L::W1F, wt.w1k, K1 * C0 * O1, false);
  copy(L::W0V, wt.w0v, C0, false);
  for (int i = tid; i < K2 * O1 * C2; i += P) {
    if constexpr (BF16)
      s[L::W2 + (i % C2) * L::W2S + i / C2] = op<true>(__ldg(wt.w2 + i));
    else
      s[L::W2 + (i / (O1 * C2)) * L::W2S + i % (O1 * C2)] = __ldg(wt.w2 + i);
  }
  copy(L::B2, wt.b2, C2, false);
  copy(L::W3, wt.w3, K3 * C2 * C3, true);
  copy(L::B3, wt.b3, C3, false);
  copy(L::WST, wt.wst, 2 * C3 * CW, true);
  copy(L::BST, wt.bst, CW, false);
  copy(L::F0, wt.f0, FLAT * F1, true);
  copy(L::FB0, wt.fb0, F1, false);
  copy(L::F1W, wt.f1, F1 * F2, true);
  copy(L::FB1, wt.fb1, F2, false);
  copy(L::F2W, wt.f2, F2 * O, true);
  copy(L::FB2, wt.fb2, O, false);
  copy(L::W0G, wt.w0g, C0, false);
  copy(L::B0, wt.b0, C0, false);
  copy(L::B1, wt.b1, O1, false);
  for (int i = tid; i < NWARP * 2 * R * 32; i += P) s[L::H2 + i] = 0.f;

  // position (d, w, g) = (warp / W, warp % W, lane); g_norm is (NB*NO, D,
  // H, W) and tap kk of row group g is wordline g*K1 + kk: this position's
  // two values in block j are at j*GB + go and j*GB + go + W
  const int d = wi / W, w = wi % W, g = lane;
  constexpr int GB = D * H * W;
  const float* gp = gn + (d * H + g * K1) * W + w;
  __syncthreads();

  float w0v[C0];
#pragma unroll
  for (int c = 0; c < C0; ++c) w0v[c] = s[L::W0V + c];
  float* h2w = s + L::H2 + wi * (2 * R * 32);   // this warp's stage-2 stash
  int buf = 0;   // the h3 double buffer toggles on across items
  for (int item = blockIdx.x, done = 0; item < items; ++done) {
    // the item after this one: read after this item's first barrier (its
    // g_norm to L1) and after its last (to go on); written to the other
    // parity's slot, which a late warp of the item before may still read
    if (tid == 0) nxt[done & 1] = (int)gridDim.x + atomicAdd(ticket, 1);
    const int j = item % nblk, m0 = item / nblk * bm;

    // ---- the fold: this position's g0, celu0 and y0, once per item --------
    const float* gj = gp + (long long)j * GB;
    float g0[K1][C0], c0[K1][C0], y0[O1];
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) {
      const float gv = __ldg(gj + kk * W);
#pragma unroll
      for (int c4 = 0; c4 < C0 / 4; ++c4) {
        const float4 wg = ld4(s + L::W0G + 4 * c4);
        const float4 bb = ld4(s + L::B0 + 4 * c4);
        const float wgs[4] = {wg.x, wg.y, wg.z, wg.w};
        const float bbs[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          const int c = 4 * c4 + ci;
          // rounded apart, as the plain version's multiply and add are
          g0[kk][c] = __fadd_rn(__fmul_rn(gv, wgs[ci]), bbs[ci]);
          c0[kk][c] = celu_of<BF16>(g0[kk][c]);
        }
      }
    }
    // y0 from the fp32 w1k: output o's chain runs over k = kk*C0 + c in
    // order (in bf16 mode each multiply and add rounded apart, as the plain
    // version's), the O1 chains side by side
    {
      float acc[O1];
#pragma unroll
      for (int o = 0; o < O1; ++o) acc[o] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K1; ++kk)
#pragma unroll
        for (int c = 0; c < C0; ++c) {
          const float4 wa = ld4(s + L::W1F + (kk * C0 + c) * O1);
          const float4 wb = ld4(s + L::W1F + (kk * C0 + c) * O1 + 4);
          const float wv[O1] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int o = 0; o < O1; ++o) {
            if constexpr (BF16)
              acc[o] = __fadd_rn(acc[o], __fmul_rn(c0[kk][c], wv[o]));
            else
              acc[o] = fmaf(c0[kk][c], wv[o], acc[o]);
          }
        }
#pragma unroll
      for (int o = 0; o < O1; ++o) {
        if constexpr (BF16)
          y0[o] = __fadd_rn(acc[o], s[L::B1 + o]);
        else
          y0[o] = acc[o] + s[L::B1 + o];
      }
    }

    const int nb = j / NO;
    const int m1 = min(M, m0 + bm);

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
      if (mg == m0 && nxt[done & 1] < items) {
        // the next item's g_norm values to L1 while this item's rows run
        const float* gx = gp + (long long)(nxt[done & 1] % nblk) * GB;
        asm volatile("prefetch.global.L1 [%0];" :: "l"(gx));
        asm volatile("prefetch.global.L1 [%0];" :: "l"(gx + W));
      }

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
          h = h + __ldg(shift + (shift_per_block ? (long long)j * F1 : 0) + lane);
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
    item = nxt[done & 1];
  }
  // the last thread block out leaves the ticket at zero for the next launch
  // on this stream; every other one has drawn its last count before it
  // counts itself out
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ticket + 1, 1) == (int)gridDim.x - 1) {
      ticket[0] = 0;
      ticket[1] = 0;
    }
  }
}

// One launch of `ctas` thread blocks (<= the items) that draw the items
// from `ticket` (two ints, zero before the launch and after it).
template <int D, int W, int O, bool BF16>
int launch(const float* u, const float* pos, const float* gn,
           const float* shift, int shift_per_block, const Weights& wt,
           float* out, int M, int NB, int NO, int bm, int ctas, int* ticket,
           cudaStream_t stream) {
  constexpr int bytes = Fused<D, W, O, BF16>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_kernel<D, W, O, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  fused_kernel<D, W, O, BF16><<<(unsigned)ctas, Fused<D, W, O, BF16>::P, bytes,
                                stream>>>(
      u, pos, gn, shift, shift_per_block, wt, out, M, NB, NO, bm, ticket);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(int geom, const float* u, const float* pos, const float* gn,
             const float* shift, int shift_per_block, const Weights* wt,
             float* out, int M, int NB, int NO, int bm, int ctas, int* ticket,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch<4, 2, 1, BF16>(u, pos, gn, shift, shift_per_block, *wt, out,
                                 M, NB, NO, bm, ctas, ticket, s);
  if (geom == 1)
    return launch<2, 8, 4, BF16>(u, pos, gn, shift, shift_per_block, *wt, out,
                                 M, NB, NO, bm, ctas, ticket, s);
  return -1;
}

// Thread blocks of the kernel one SM keeps resident, as the runtime reckons
// them from its registers, threads and dynamic shared memory; minus the
// cudaError_t if it cannot say.
template <int D, int W, int O, bool BF16>
int resident() {
  constexpr int bytes = Fused<D, W, O, BF16>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<D, W, O, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fused_kernel<D, W, O, BF16>, Fused<D, W, O, BF16>::P, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).  Both
// modes take g_norm (NB*NO, D, H, W), the plan's normalized conductances,
// `ctas` thread blocks (1 to the NB*NO*ceil(M/bm) items, which must be
// under 2^31) and `ticket`, two device ints that are zero, which the launch
// draws the items from and leaves at zero; two launches that may run at
// once need tickets of their own.  Each returns the launch's cudaError_t
// (0 = launched); -1 for an unknown geom.
extern "C" int emulator_block_unified_f32(
    int geom, const float* u, const float* pos, const float* g_norm,
    const float* shift, int shift_per_block, const Weights* wt, float* out,
    int M, int NB, int NO, int bm, int ctas, int* ticket, void* stream) {
  return dispatch<false>(geom, u, pos, g_norm, shift, shift_per_block, wt, out,
                         M, NB, NO, bm, ctas, ticket, stream);
}

extern "C" int emulator_block_unified_bf16(
    int geom, const float* u, const float* pos, const float* g_norm,
    const float* shift, int shift_per_block, const Weights* wt, float* out,
    int M, int NB, int NO, int bm, int ctas, int* ticket, void* stream) {
  return dispatch<true>(geom, u, pos, g_norm, shift, shift_per_block, wt, out,
                        M, NB, NO, bm, ctas, ticket, stream);
}

// Thread blocks of the fp32 (bf16 = 0) or the bf16 mode one SM of the
// current device keeps resident; minus the cudaError_t if the runtime
// cannot say, -1 for an unknown geom.
extern "C" int emulator_block_unified_resident(int geom, int bf16) {
  if (geom == 0) return bf16 ? resident<4, 2, 1, true>() : resident<4, 2, 1, false>();
  if (geom == 1) return bf16 ? resident<2, 8, 4, true>() : resident<2, 8, 4, false>();
  return -1;
}

// Dynamic shared memory of one thread block, in bytes, of the fp32 (bf16
// = 0) or the bf16 mode; -1 for an unknown geom.
extern "C" int emulator_block_unified_smem(int geom, int bf16) {
  if (geom == 0) return bf16 ? Fused<4, 2, 1, true>::BYTES : Fused<4, 2, 1, false>::BYTES;
  if (geom == 1) return bf16 ? Fused<2, 8, 4, true>::BYTES : Fused<2, 8, 4, false>::BYTES;
  return -1;
}
