// Paper-faithful per-block Conv4Xbar evaluators for Hopper (sm_90a), fp32.
//
// Two kernels over one network, one shared-memory layout and one tail:
//   block_warp_kernel (B2) replaces kernels/emulator_block/emulator_block.py:
//     emulator_block_pallas of the JAX package (body _kernel, stages
//     _stage_apply): x (N, 2, D, H, W) normalized (V, G) features and a
//     per-block periph (N, P) -> (N, O).
//   grid_warp_kernel (B3) replaces emulator_block_grid_pallas (body
//     _grid_kernel): the same network per (row m, crossbar block j) with
//     the (V, G) stack built on chip from the row's drive v01 (M, NB, D, H)
//     and the block's shared conductances g_norm (NB*NO, D, H, W), periph
//     (1, 0, ...) -> (M, NB*NO, O).
//
// The network (core/conv4xbar.py:build_stages; H = 64):
//   stage 0   2 -> 16, 1x1x1              CELU
//   stage 1  16 ->  8, window 2 over H    CELU   (G = 32 row groups)
//   stage 2   8 ->  4, window 4           CELU
//   stage 3   4 -> 32, window 8           CELU   (H collapses to 1)
//   W-stage  32 -> 32 over column pairs (2w, 2w+1), stride 1 if W <= 2 else 2
//   flatten (NCDHW), periph concat, FC head FLAT+P -> 32 -> 16 -> O.
// CELU is max(0,x) + min(0, expm1(x)).  Geometries: CASE_A (D, W, O) =
// (4, 2, 1), FLAT 128; CASE_B (2, 8, 4), FLAT 256.
//
// What bounds both on an H100: about 230 kFLOP and 10.9k CELUs per block
// evaluation under CASE_A (twice that under CASE_B) against 4 KiB of
// features read (B2), or 2 KiB of drive per row and 2 KiB of shared
// conductances per block (B3): both kernels are bound by operations, and
// their time follows the instructions issued per evaluation.
//
// The design, the pattern of the fast path's fp32 kernel
// (emulator_block_unified.cu, fused_kernel) on the full network:
//   * one thread per stage-1 position, warp = column (d, w), lane = g;
//   * stage 0+1 takes S1ROWS evaluations a pass, so each float4 of the
//     stage-1 weights read from shared memory serves that many;
//   * warp-local tail (stage2, stage3, head below, shared by both
//     kernels): stage 2 (window 4 over g) is a 4-lane reduce-scatter with
//     shuffles that leaves lane g with stage 3's input element g in a
//     per-warp stash; stage 3 (window 8 = the whole column) is a 32 x 32
//     product per warp over R = D*W evaluations at once, lane = output
//     channel; then ONE __syncthreads per R evaluations hands the stage-3
//     columns (double-buffered) to the head, where each warp takes one
//     evaluation and runs the W-stage, fc0 (four partial chains), fc1 and
//     fc2 with only __syncwarp between them;
//   * every CELU is exp(x) - 1 from the hardware exp2 (celu_ex2), where
//     expm1f is a software routine of about twenty instructions; all
//     arithmetic stays fp32 FMA on CUDA cores: TF32 would break fp32
//     parity;
//   * the weights sit in shared memory in the order pack_grid_weights /
//     pack_block_weights (kernels/emulator_block/emulator_block.py) pack
//     them, every array on a 16-byte boundary, copied as float4: 63 KB a
//     thread block under CASE_A (256 threads, two blocks per SM), 167 KB
//     under CASE_B (512 threads, one block per SM).
// B3 alone: each thread computes its stage-0 conductance terms g0 = g*w0g
//   + b0 (2 x 16) into registers once per thread block and reuses them for
//   every row of its tile (the fold); the slow path's periph is the
//   constant (1, 0, ...), so fc0's periph row is folded into fc0's bias on
//   the host and fc0 reads no periph row.
// B2 alone: every evaluation brings its own conductances, so stage 0 is
//   celu(v*w0v + (g*w0g + b0)), two FMAs, per evaluation; fc0 also reads
//   the evaluation's P periph features (a run-time P: 0, 2 and 15 in use)
//   against P extra rows kept after the activations; each thread block
//   takes one tile of bn evaluations (the wrapper spreads N evenly over
//   the thread blocks the card keeps resident), and each thread loads its
//   four features of the next stage-0+1 pass into registers while it
//   computes this one, so the 4 KiB an evaluation reads from HBM arrive
//   under the arithmetic (loads at use and a cp.async ring in shared
//   memory ran slower; tools/b2_variants.py builds both as patches of this
//   file); a short last pass repeats the tile's last evaluation and never
//   reads past it.
// The sums run in another order than the plain version's convolutions and
// the CELU is exp(x) - 1, which move results by a few fp32 roundings.
#include <cuda_runtime.h>

namespace {

constexpr int G = 32;       // row groups after the stage-1 window
constexpr int K1 = 2;       // stage-1 window (H = G * K1 = 64 wordlines)
constexpr int H = G * K1;
constexpr int C0 = 16;      // stage-0 channels
constexpr int O1 = 8;       // stage-1 channels
constexpr int K2 = 4, C2 = 4;    // stage 2: window 4, 8 -> 4
constexpr int K3 = 8, C3 = 32;   // stage 3: window 8, 4 -> 32
constexpr int CW = 32;           // W-stage: 2 x 32 -> 32
constexpr int F1 = 32, F2 = 16;  // FC head widths
constexpr unsigned FULL = 0xffffffffu;
// evaluations (B2) or rows (B3) a stage-0+1 pass takes: each float4 of
// w1k read from shared memory serves this many
constexpr int S1ROWS = 2;

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// CELU through the hardware exp2 (__expf: one multiply and MUFU.EX2) in
// place of the expm1f routine: exp(x) - 1 loses expm1's relative accuracy
// near 0 but keeps an absolute error of a few 1e-7, within the card gate
// (atol 1e-5 + rtol 1e-4 |plain|; a CPU test emulates it).
__device__ __forceinline__ float celu_ex2(float x) {
  return x > 0.f ? x : __expf(x) - 1.f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// component i of v (i a constant once the loop around it is unrolled)
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The shapes of one geometry and the shared-memory layout both kernels
// use, in floats.  The weights come first, in the order the packers lay
// them out and the kernels copy them; every array starts on a 16-byte
// boundary so that float4 reads stay aligned.  B2 adds fc0's periph rows
// after the activations (FP, a multiple of 4 rows).
template <int D, int W, int O>
struct Grid {
  static constexpr int NT = D * W * G;          // threads: stage-1 positions
  static constexpr int NWARP = D * W;           // warp (d, w), lane g
  static constexpr int R = NWARP;               // rows a pass: one a warp in the head
  static constexpr int WO = W <= 2 ? 1 : W / 2; // W-stage outputs
  static constexpr int Q4 = D * WO;             // W-stage output rows
  static constexpr int FLAT = Q4 * CW;
  static constexpr int W2S = K2 * 9;            // padded (c, o) row of w2: 36
  static constexpr int W1K = 0;                 // (K1, C0, O1)
  static constexpr int W0V = W1K + K1 * C0 * O1;
  static constexpr int W0G = W0V + C0;
  static constexpr int B0 = W0G + C0;
  static constexpr int B1 = B0 + C0;
  static constexpr int W2 = B1 + O1;            // (K2, 36): w2[kk2*8 + c][o]
  static constexpr int B2 = W2 + K2 * W2S;
  static constexpr int W3 = B2 + 4;             // (K3*C2, C3)
  static constexpr int B3 = W3 + K3 * C2 * C3;
  static constexpr int WST = B3 + C3;           // (2*C3, CW)
  static constexpr int BST = WST + 2 * C3 * CW;
  static constexpr int F0 = BST + CW;           // (FLAT, F1), rows (d, w, c)
  static constexpr int FB0 = F0 + FLAT * F1;    // fc0's bias (B3: + its periph row)
  static constexpr int F1W = FB0 + F1;          // (F1, F2)
  static constexpr int FB1 = F1W + F1 * F2;
  static constexpr int F2W = FB1 + F2;          // (F2, O)
  static constexpr int FB2 = F2W + up4(F2 * O);
  static constexpr int NW = FB2 + 4;            // packed weights
  static constexpr int H2 = NW;                 // (NWARP, R, 32) stage-2 stash
  static constexpr int H3 = H2 + NWARP * R * 32;      // (2, R, NWARP, 32)
  static constexpr int H4 = H3 + 2 * R * NWARP * 32;  // (NWARP, FLAT)
  static constexpr int H5 = H4 + NWARP * FLAT;  // (NWARP, F1)
  static constexpr int H6 = H5 + NWARP * F1;    // (NWARP, F2)
  static constexpr int FLOATS = H6 + NWARP * F2;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr int FP = FLOATS;             // B2: (up4(P), F1) periph rows
  __host__ __device__ static constexpr int block_bytes(int p) {
    return (FLOATS + up4(p) * F1) * 4;
  }
  static_assert(W0V % 4 == 0 && B1 % 4 == 0 && W2 % 4 == 0 && W3 % 4 == 0 &&
                F0 % 4 == 0 && F1W % 4 == 0 && F2W % 4 == 0 && NW % 4 == 0 &&
                FP % 4 == 0, "16-byte boundaries");
  static_assert(W % 2 == 0, "the W-stage pairs columns");
  static_assert(R % S1ROWS == 0, "stage-1 passes tile the rows of a pass");
  static_assert(G == 32 && K2 * K3 == G && K2 * O1 == 32 && K3 * C2 == 32,
                "one warp is one stage-1 column; stage 3 takes it whole");
};


// Stage 1's bias and CELU, then stage 2 (window K2 over g, 8 -> 4
// channels) of S1ROWS rows: t holds each row's stage-1 sums at this lane's
// position (d, w, g = lane); lane g leaves stage 3's input element g of
// row r + q in row r + q of its warp's stash h2w.
template <int D, int W, int O>
__device__ __forceinline__ void stage2(const float* s, float (&t)[S1ROWS][O1],
                                       float* h2w, int r, int lane) {
  using L = Grid<D, W, O>;
  const int g = lane;
  float p[S1ROWS][C2];
#pragma unroll
  for (int q = 0; q < S1ROWS; ++q) {
#pragma unroll
    for (int o = 0; o < O1; ++o) t[q][o] = celu_ex2(t[q][o] + s[L::B1 + o]);
#pragma unroll
    for (int o = 0; o < C2; ++o) p[q][o] = 0.f;
  }
  // lane g's share of output row g/4: its 8 channels against rows
  // (g%4)*8 + c of w2
#pragma unroll
  for (int c = 0; c < O1; ++c) {
    const float4 wv = ld4(s + L::W2 + (g & 3) * L::W2S + c * C2);
#pragma unroll
    for (int q = 0; q < S1ROWS; ++q) {
      p[q][0] = fmaf(t[q][c], wv.x, p[q][0]);
      p[q][1] = fmaf(t[q][c], wv.y, p[q][1]);
      p[q][2] = fmaf(t[q][c], wv.z, p[q][2]);
      p[q][3] = fmaf(t[q][c], wv.w, p[q][3]);
    }
  }
  // reduce-scatter over the 4 lanes of the window: lane g keeps
  // channel g % 4 (bit 1 of the lane picks the channel pair, bit 0
  // the channel), which is stage 3's input element g
  const bool hi = lane & 2, odd = lane & 1;
  const float b2 = s[L::B2 + (lane & 3)];
#pragma unroll
  for (int q = 0; q < S1ROWS; ++q) {
    float k0 = hi ? p[q][2] : p[q][0];
    float k1 = hi ? p[q][3] : p[q][1];
    k0 += __shfl_xor_sync(FULL, hi ? p[q][0] : p[q][2], 2);
    k1 += __shfl_xor_sync(FULL, hi ? p[q][1] : p[q][3], 2);
    float k = odd ? k1 : k0;
    k += __shfl_xor_sync(FULL, odd ? k0 : k1, 1);
    h2w[(r + q) * 32 + lane] = celu_ex2(k + b2);
  }
}

// Stage 3 of a pass: each of the warp's R stash rows (its column's 32
// inputs) -> 32 channels, lane = channel, into h3 (R, NWARP, 32).  Rows
// past the pass's count run on stale inputs; the head never reads them.
template <int D, int W, int O>
__device__ __forceinline__ void stage3(const float* s, const float* h2w,
                                       float* h3, int wi, int lane) {
  using L = Grid<D, W, O>;
  constexpr int R = L::R, NWARP = L::NWARP;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int kq = 0; kq < K3 * C2 / 4; ++kq) {
    const float w0 = s[L::W3 + (4 * kq) * C3 + lane];
    const float w1 = s[L::W3 + (4 * kq + 1) * C3 + lane];
    const float w2 = s[L::W3 + (4 * kq + 2) * C3 + lane];
    const float w3 = s[L::W3 + (4 * kq + 3) * C3 + lane];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 x = ld4(h2w + i * 32 + 4 * kq);
      acc[i] = fmaf(x.x, w0, acc[i]);
      acc[i] = fmaf(x.y, w1, acc[i]);
      acc[i] = fmaf(x.z, w2, acc[i]);
      acc[i] = fmaf(x.w, w3, acc[i]);
    }
  }
  const float b3 = s[L::B3 + lane];
#pragma unroll
  for (int i = 0; i < R; ++i)
    h3[(i * NWARP + wi) * 32 + lane] = celu_ex2(acc[i] + b3);
}

// The W-stage and FC head of one row on warp wi, with only __syncwarp:
// `in` holds the row's stage-3 columns (NWARP, 32); the O outputs go to
// y.  PERIPH (B2): fc0 also takes the row's P periph features -- lane k
// holds feature k in pv, features past 32 are read from `per` -- against
// the rows at FP (zero past P), feature i continuing chain i % 4.
template <int D, int W, int O, bool PERIPH>
__device__ __forceinline__ void head(float* s, const float* in, int wi,
                                     int lane, const float* __restrict__ per,
                                     int P, float pv, float* __restrict__ y) {
  using L = Grid<D, W, O>;
  constexpr int WO = L::WO, Q4 = L::Q4, FLAT = L::FLAT;
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
  if constexpr (PERIPH) {
    for (int k0 = 0; k0 < P; k0 += 32) {
      const float pk = k0 == 0 ? pv : (k0 + lane < P ? __ldg(per + k0 + lane) : 0.f);
      const int nk = min(32, up4(P - k0));
      for (int k = 0; k < nk; k += 4) {
        const float* row = s + L::FP + (k0 + k) * F1 + lane;
        f[0] = fmaf(__shfl_sync(FULL, pk, k), row[0], f[0]);
        f[1] = fmaf(__shfl_sync(FULL, pk, k + 1), row[F1], f[1]);
        f[2] = fmaf(__shfl_sync(FULL, pk, k + 2), row[2 * F1], f[2]);
        f[3] = fmaf(__shfl_sync(FULL, pk, k + 3), row[3 * F1], f[3]);
      }
    }
  }
  float* h5 = s + L::H5 + wi * F1;
  h5[lane] = celu_ex2(((f[0] + f[1]) + (f[2] + f[3])) + s[L::FB0 + lane]);
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
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < F2; ++k) acc = fmaf(h6[k], s[L::F2W + k * O + lane], acc);
    y[lane] = acc + s[L::FB2 + lane];
  }
}

// B3: thread block (j, i) evaluates crossbar block j for rows [i*bm,
// min(M, (i+1)*bm)).
template <int D, int W, int O>
__global__ void __launch_bounds__(D * W * G, D * W * G <= 256 ? 2 : 1)
grid_warp_kernel(const float* __restrict__ v01, const float* __restrict__ gn,
                 const float* __restrict__ wpack, float* __restrict__ out,
                 int M, int NB, int NO, int bm) {
  using L = Grid<D, W, O>;
  constexpr int NT = L::NT, NWARP = L::NWARP, R = L::R;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);

  // 32-bit bookkeeping where it fits (NB*NO < 2^31, the wrapper checks):
  // the registers go to the fold's g0
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int j = blockIdx.x;                   // crossbar block nb*NO + no
  const int nb = j / NO;
  const int m0 = blockIdx.y * bm;
  const int m1 = min(M, m0 + bm);

  // ---- the weights to shared memory; the stage-2 stash zeroed ----------
  const float4* w4 = reinterpret_cast<const float4*>(wpack);
  for (int i = tid; i < L::NW / 4; i += NT) smem4[i] = __ldg(w4 + i);
  for (int i = tid; i < NWARP * R * 32; i += NT) s[L::H2 + i] = 0.f;

  // ---- the fold: this position's stage-0 conductance terms, once ---------
  // position (d, w, g) = (warp / W, warp % W, lane); g_norm is (NB*NO, D,
  // H, W) and tap kk of row group g is wordline g*K1 + kk
  const int d = wi / W, w = wi % W, g = lane;
  float g0[K1][C0];
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
    const float gv = __ldg(gn + (((long long)j * D + d) * H + g * K1 + kk) * W + w);
#pragma unroll
    for (int c = 0; c < C0; ++c)     // rounded apart: no FMA across the add
      g0[kk][c] = __fadd_rn(__fmul_rn(gv, __ldg(wpack + L::W0G + c)),
                            __ldg(wpack + L::B0 + c));
  }
  __syncthreads();

  // this position's drive: v01[m, nb, d, g*K1 + kk]
  const float* vp = v01 + ((long long)nb * D + d) * H + g * K1;
  const int vstride = NB * D * H;
  float* h2w = s + L::H2 + wi * (R * 32);       // this warp's stage-2 stash
  int buf = 0;
  for (int mg = m0; mg < m1; mg += R, buf ^= 1) {
    const int nr = min(R, m1 - mg);
    for (int r = 0; r < nr; r += S1ROWS) {
      // ---- stage 0+1 on S1ROWS rows (a row past nr repeats the last) ---
      float2 v[S1ROWS];
#pragma unroll
      for (int q = 0; q < S1ROWS; ++q)
        v[q] = __ldg(reinterpret_cast<const float2*>(
            vp + (long long)min(mg + r + q, m1 - 1) * vstride));
      float t[S1ROWS][O1];
#pragma unroll
      for (int q = 0; q < S1ROWS; ++q)
#pragma unroll
        for (int o = 0; o < O1; ++o) t[q][o] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K1; ++kk) {
#pragma unroll
        for (int c = 0; c < C0; ++c) {
          const float4 wa = ld4(s + L::W1K + (kk * C0 + c) * O1);
          const float4 wb = ld4(s + L::W1K + (kk * C0 + c) * O1 + 4);
#pragma unroll
          for (int q = 0; q < S1ROWS; ++q) {
            const float h0 = celu_ex2(
                fmaf(kk == 0 ? v[q].x : v[q].y, s[L::W0V + c], g0[kk][c]));
            t[q][0] = fmaf(h0, wa.x, t[q][0]); t[q][1] = fmaf(h0, wa.y, t[q][1]);
            t[q][2] = fmaf(h0, wa.z, t[q][2]); t[q][3] = fmaf(h0, wa.w, t[q][3]);
            t[q][4] = fmaf(h0, wb.x, t[q][4]); t[q][5] = fmaf(h0, wb.y, t[q][5]);
            t[q][6] = fmaf(h0, wb.z, t[q][6]); t[q][7] = fmaf(h0, wb.w, t[q][7]);
          }
        }
        // no load of the next tap's weights is hoisted above this point:
        // ptxas otherwise runs past the 128-register cap and spills
        asm volatile("" ::: "memory");
      }
      stage2<D, W, O>(s, t, h2w, r, lane);
    }
    __syncwarp();
    float* h3 = s + L::H3 + buf * (R * NWARP * 32);   // (R, NWARP, 32)
    stage3<D, W, O>(s, h2w, h3, wi, lane);
    __syncthreads();
    // ---- W-stage and FC head: warp wi takes row mg + wi -----------------
    if (wi < nr)
      head<D, W, O, false>(s, h3 + wi * NWARP * 32, wi, lane, nullptr, 0, 0.f,
                           out + ((long long)(mg + wi) * NB * NO + j) * O);
  }
}

// B2's features at one stage-1 position of S1ROWS blocks: x[e, 0, d, g*K1
// + kk, w] in v[q], x[e, 1, ...] in c[q], tap kk = .x / .y.
struct Feat {
  float2 v[S1ROWS], c[S1ROWS];
};

// The features of blocks e + q (past `last`: block `last`) at the
// position xp points to in block 0.
template <int D, int W>
__device__ __forceinline__ void fetch(Feat& f, const float* __restrict__ xp,
                                      int e, int last) {
  constexpr int DHW = D * H * W;
#pragma unroll
  for (int q = 0; q < S1ROWS; ++q) {
    const float* p = xp + (long long)min(e + q, last) * (2 * DHW);
    f.v[q] = make_float2(__ldg(p), __ldg(p + W));
    f.c[q] = make_float2(__ldg(p + DHW), __ldg(p + DHW + W));
  }
}

// B2: thread block b evaluates blocks [b*bn, min(N, (b+1)*bn)) in passes of
// R; P periph features a block; wpack is pack_block_weights' vector (NW
// floats, then P rows of fc0), 16-byte aligned.
template <int D, int W, int O>
__global__ void __launch_bounds__(D * W * G, D * W * G <= 256 ? 2 : 1)
block_warp_kernel(const float* __restrict__ x, const float* __restrict__ periph,
                  const float* __restrict__ wpack, int P, float* __restrict__ out,
                  int N, int bn) {
  using L = Grid<D, W, O>;
  constexpr int NT = L::NT, NWARP = L::NWARP, R = L::R;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int n0 = blockIdx.x * bn, n1 = min(N, n0 + bn);

  // ---- the weights and fc0's periph rows (zero rows up to a multiple of
  // 4) to shared memory; the stage-2 stash zeroed ------------------------
  const float4* w4 = reinterpret_cast<const float4*>(wpack);
  for (int i = tid; i < L::NW / 4; i += NT) smem4[i] = __ldg(w4 + i);
  for (int i = tid; i < up4(P) * F1 / 4; i += NT)
    smem4[L::FP / 4 + i] = i < P * F1 / 4 ? __ldg(w4 + L::NW / 4 + i)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < NWARP * R * 32; i += NT) s[L::H2 + i] = 0.f;

  // this position (d, w, g) = (warp / W, warp % W, lane) in block 0:
  // x[0, 0, d, g*K1, w], kept as a 32-bit offset (a 64-bit pointer held
  // across the pass made ptxas spill); the first pass's features fetched
  const int d = wi / W, w = wi % W, g = lane;
  const int xo = (d * H + g * K1) * W + w;
  float* h2w = s + L::H2 + wi * (R * 32);       // this warp's stage-2 stash
  Feat nxt;                                     // the next pass's features
  fetch<D, W>(nxt, x + xo, n0, n1 - 1);
  __syncthreads();

  int buf = 0;
  for (int mg = n0; mg < n1; mg += R, buf ^= 1) {
    const int nr = min(R, n1 - mg);
    // the head's periph features, fetched while stage 0+1 runs: lane k
    // of warp wi holds feature k of block mg + wi
    const float* per = periph + (long long)(mg + wi) * P;
    const float pv = wi < nr && lane < P ? __ldg(per + lane) : 0.f;
    for (int r = 0; r < nr; r += S1ROWS) {
      // ---- this stage-0+1 pass's features; the tile's next pass's
      // fetched (later in this pass of R, else the next one's first) -----
      const int ne = r + S1ROWS < nr ? mg + r + S1ROWS : mg + R;
      const Feat f = nxt;
      if (ne < n1) fetch<D, W>(nxt, x + xo, ne, n1 - 1);
      // ---- stage 0+1 on S1ROWS blocks (past nr: the tile's last) --------
      float t1[S1ROWS][O1];
#pragma unroll
      for (int q = 0; q < S1ROWS; ++q)
#pragma unroll
        for (int o = 0; o < O1; ++o) t1[q][o] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K1; ++kk) {
#pragma unroll
        for (int c4 = 0; c4 < C0 / 4; ++c4) {
          const float4 wv4 = ld4(s + L::W0V + 4 * c4);
          const float4 wg4 = ld4(s + L::W0G + 4 * c4);
          const float4 b04 = ld4(s + L::B0 + 4 * c4);
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const int c = 4 * c4 + ci;
            const float wv = at(wv4, ci), wg = at(wg4, ci), b0 = at(b04, ci);
            const float4 wa = ld4(s + L::W1K + (kk * C0 + c) * O1);
            const float4 wb = ld4(s + L::W1K + (kk * C0 + c) * O1 + 4);
#pragma unroll
            for (int q = 0; q < S1ROWS; ++q) {
              const float vv = kk == 0 ? f.v[q].x : f.v[q].y;
              const float cv = kk == 0 ? f.c[q].x : f.c[q].y;
              const float h0 = celu_ex2(fmaf(vv, wv, fmaf(cv, wg, b0)));
              t1[q][0] = fmaf(h0, wa.x, t1[q][0]); t1[q][1] = fmaf(h0, wa.y, t1[q][1]);
              t1[q][2] = fmaf(h0, wa.z, t1[q][2]); t1[q][3] = fmaf(h0, wa.w, t1[q][3]);
              t1[q][4] = fmaf(h0, wb.x, t1[q][4]); t1[q][5] = fmaf(h0, wb.y, t1[q][5]);
              t1[q][6] = fmaf(h0, wb.z, t1[q][6]); t1[q][7] = fmaf(h0, wb.w, t1[q][7]);
            }
          }
        }
        // as in B3: no load of the next tap's weights hoisted above here
        asm volatile("" ::: "memory");
      }
      stage2<D, W, O>(s, t1, h2w, r, lane);
    }
    __syncwarp();
    float* h3 = s + L::H3 + buf * (R * NWARP * 32);   // (R, NWARP, 32)
    stage3<D, W, O>(s, h2w, h3, wi, lane);
    __syncthreads();
    // ---- W-stage and FC head: warp wi takes block mg + wi -------------
    if (wi < nr)
      head<D, W, O, true>(s, h3 + wi * NWARP * 32, wi, lane, per, P, pv,
                          out + (long long)(mg + wi) * O);
  }
}

template <int D, int W, int O>
int launch_block(const float* x, const float* periph, const float* wpack, int P,
                 float* out, int N, int bn, cudaStream_t stream) {
  const int bytes = Grid<D, W, O>::block_bytes(P);
  const cudaError_t e = cudaFuncSetAttribute(
      block_warp_kernel<D, W, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned nblocks = (unsigned)((N + bn - 1) / bn);
  block_warp_kernel<D, W, O><<<nblocks, Grid<D, W, O>::NT, bytes, stream>>>(
      x, periph, wpack, P, out, N, bn);
  return (int)cudaGetLastError();
}

// Thread blocks of B2 one SM keeps resident at this periph width, as the
// runtime reckons them from the kernel's registers, threads and dynamic
// shared memory; minus the cudaError_t if it cannot say.
template <int D, int W, int O>
int resident_blocks(int P) {
  const int bytes = Grid<D, W, O>::block_bytes(P);
  cudaError_t e = cudaFuncSetAttribute(
      block_warp_kernel<D, W, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, block_warp_kernel<D, W, O>, Grid<D, W, O>::NT, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

template <int D, int W, int O>
int launch_grid(const float* v01, const float* gnorm, const float* wpack,
                float* out, int M, int NB, int NO, int bm, cudaStream_t stream) {
  using L = Grid<D, W, O>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      grid_warp_kernel<D, W, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  grid_warp_kernel<D, W, O><<<grid, L::NT, L::BYTES, stream>>>(
      v01, gnorm, wpack, out, M, NB, NO, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).
// Each returns the launch's cudaError_t (0 = launched); -1 for an unknown geom.

// B2: wpack is pack_block_weights' vector (emulator_block_grid_weights
// floats, then n_periph rows of 32), 16-byte aligned; thread block b
// evaluates blocks [b*bn, min(N, (b+1)*bn)).
extern "C" int emulator_block_f32(int geom, const float* x, const float* periph,
                                  const float* wpack, int n_periph, float* out,
                                  int N, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_block<4, 2, 1>(x, periph, wpack, n_periph, out, N, bn, s);
  if (geom == 1)
    return launch_block<2, 8, 4>(x, periph, wpack, n_periph, out, N, bn, s);
  return -1;
}

// Dynamic shared memory one B2 thread block of the geometry takes, in
// bytes (reported by chip_smoke.py beside ptxas's static counts).
extern "C" int emulator_block_smem_bytes(int geom, int n_periph) {
  if (geom == 0) return Grid<4, 2, 1>::block_bytes(n_periph);
  if (geom == 1) return Grid<2, 8, 4>::block_bytes(n_periph);
  return -1;
}

// Thread blocks of B2 one SM of the current device keeps resident for the
// geometry and periph width (the wrapper's tile rule spreads N over them);
// minus the cudaError_t on failure, -1 for an unknown geom.
extern "C" int emulator_block_resident(int geom, int n_periph) {
  if (geom == 0) return resident_blocks<4, 2, 1>(n_periph);
  if (geom == 1) return resident_blocks<2, 8, 4>(n_periph);
  return -1;
}

// B3: wpack is pack_grid_weights' vector (emulator_block_grid_weights
// floats, 16-byte aligned), v01 8-byte aligned.
extern "C" int emulator_block_grid_f32(int geom, const float* v01,
                                       const float* gnorm, const float* wpack,
                                       float* out, int M, int NB, int NO,
                                       int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_grid<4, 2, 1>(v01, gnorm, wpack, out, M, NB, NO, bm, s);
  if (geom == 1)
    return launch_grid<2, 8, 4>(v01, gnorm, wpack, out, M, NB, NO, bm, s);
  return -1;
}

// The packed weights both kernels copy, in floats (B2's vector adds its
// periph rows after them), and one B3 thread block's dynamic shared
// memory, in bytes; -1 for an unknown geom.
extern "C" int emulator_block_grid_weights(int geom) {
  if (geom == 0) return Grid<4, 2, 1>::NW;
  if (geom == 1) return Grid<2, 8, 4>::NW;
  return -1;
}

extern "C" int emulator_block_grid_smem_bytes(int geom) {
  if (geom == 0) return Grid<4, 2, 1>::BYTES;
  if (geom == 1) return Grid<2, 8, 4>::BYTES;
  return -1;
}
