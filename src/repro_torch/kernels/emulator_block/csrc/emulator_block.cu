// Paper-faithful per-block Conv4Xbar evaluators for Hopper (sm_90a), fp32.
//
// Two kernels over one network, written once (stage01 + tail below):
//   block_kernel (B2) replaces kernels/emulator_block/emulator_block.py:
//     emulator_block_pallas of the JAX package (body _kernel, stages
//     _stage_apply): x (N, 2, D, H, W) normalized (V, G) features and a
//     per-block periph (N, P) -> (N, O).
//   grid_kernel (B3) replaces emulator_block_grid_pallas (body _grid_kernel):
//     the same network per (row m, crossbar block j) with the (V, G) stack
//     built on chip from the row's drive v01 (M, NB, D, H) and the block's
//     shared conductances g_norm (NB*NO, D, H, W), periph (1, 0, ...) of
//     length P -> (M, NB*NO, O).
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
// What bounds it on an H100: about 230 kFLOP and 10.9k expm1 per block
// evaluation under CASE_A (twice that under CASE_B) against 4 KiB of
// features read (B2), or 2 KiB of drive per row and 2 KiB of shared
// conductances per block (B3): both kernels are bound by operations.
//
// What the design does about it: one thread per stage-1 position
// (d, w, g) -- D*W*32 threads -- computes its two stage-0 rows and their
// stage-1 contraction in registers, so the 16-channel stage-0 activations
// never leave registers; the tail's activations and every weight (fc0's
// FLAT+P rows included) sit in dynamic shared memory, loaded once per
// thread block and reused by every evaluation it makes.  B2 walks a tile
// of crossbar blocks per thread block; B3 takes one crossbar block per
// thread block (gridDim.x: 34,560 blocks do not fit in y) and a tile of up
// to 128 rows (gridDim.y), holding the block's stage-0 conductance term in
// registers across the rows.  All arithmetic is scalar fp32 FMA on CUDA
// cores: TF32 would break fp32 parity.  This is the simple first version:
// the tail runs one evaluation at a time.
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

__device__ __forceinline__ float celu(float x) { return x > 0.f ? x : expm1f(x); }

// Shapes of one geometry and the float offsets of the packed weights
// (kernels/emulator_block/emulator_block.py:pack_net_weights): a fixed
// part, then fc0's FLAT + P rows -- the first FLAT in channels-last
// (d, w, c) order, the last P the periph rows.
template <int D, int W, int O>
struct Net {
  static constexpr int NT = D * W * G;            // threads = stage-1 positions
  static constexpr int WO = W <= 2 ? 1 : W / 2;   // W-stage outputs
  static constexpr int Q2 = NT / K2;              // stage-2 output rows
  static constexpr int Q3 = Q2 / K3;              // stage-3 output rows (= D*W)
  static constexpr int Q4 = D * WO;               // W-stage output rows
  static constexpr int FLAT = Q4 * CW;
  static constexpr int W0V = 0, W0G = W0V + C0, BI0 = W0G + C0;
  static constexpr int W1 = BI0 + C0;              // (K1, C0, O1)
  static constexpr int BI1 = W1 + K1 * C0 * O1;
  static constexpr int W2 = BI1 + O1;              // (K2*O1, C2)
  static constexpr int BI2 = W2 + K2 * O1 * C2;
  static constexpr int W3 = BI2 + C2;              // (K3*C2, C3)
  static constexpr int BI3 = W3 + K3 * C2 * C3;
  static constexpr int WS = BI3 + C3;              // (2*C3, CW)
  static constexpr int BS = WS + 2 * C3 * CW;
  static constexpr int FB0 = BS + CW;
  static constexpr int FW1 = FB0 + F1;            // (F1, F2)
  static constexpr int FB1 = FW1 + F1 * F2;
  static constexpr int FW2 = FB1 + F2;            // (F2, O)
  static constexpr int FB2 = FW2 + F2 * O;
  static constexpr int FW0 = FB2 + O;             // (FLAT + P, F1)
  // activations after the weights: h1, h2, h3, h5, h6, then h4 (FLAT + P,
  // the periph appended to the flatten)
  static constexpr int ACT = NT * O1 + Q2 * C2 + Q3 * C3 + F1 + F2;
  __host__ __device__ static constexpr int n_weights(int p) {
    return FW0 + (FLAT + p) * F1;
  }
  __host__ __device__ static constexpr int smem_floats(int p) {
    return n_weights(p) + ACT + FLAT + p;
  }
  static_assert(G % (K2 * K3) == 0, "tail windows must tile G");
  static_assert(W == 2 || W % 2 == 0, "the W-stage pairs columns");
};

struct Act {
  float *h1, *h2, *h3, *h4, *h5, *h6;
};

template <int D, int W, int O>
__device__ Act load(float* s, const float* __restrict__ wpack, int P) {
  using N = Net<D, W, O>;
  const int n = N::n_weights(P);
  for (int i = threadIdx.x; i < n; i += N::NT) s[i] = __ldg(wpack + i);
  Act a;
  a.h1 = s + n;
  a.h2 = a.h1 + N::NT * O1;
  a.h3 = a.h2 + N::Q2 * C2;
  a.h5 = a.h3 + N::Q3 * C3;
  a.h6 = a.h5 + F1;
  a.h4 = a.h6 + F2;
  return a;
}

// Stage 0+1 at this thread's position (d, w, g): the drives v[kk] and the
// stage-0 conductance terms gt[kk][c] = w0g[c] * g of rows 2g + kk -> the
// eight stage-1 activations, into h1[tid].
template <int D, int W, int O>
__device__ __forceinline__ void stage01(const float* s, const Act& a,
                                        const float v[K1], const float gt[K1][C0]) {
  using N = Net<D, W, O>;
  float t[O1];
#pragma unroll
  for (int o = 0; o < O1; ++o) t[o] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
#pragma unroll
    for (int c = 0; c < C0; ++c) {
      const float h0 = celu(fmaf(s[N::W0V + c], v[kk], gt[kk][c]) + s[N::BI0 + c]);
#pragma unroll
      for (int o = 0; o < O1; ++o)
        t[o] = fmaf(h0, s[N::W1 + (kk * C0 + c) * O1 + o], t[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < O1; ++o)
    a.h1[threadIdx.x * O1 + o] = celu(t[o] + s[N::BI1 + o]);
}

// Stages 2, 3, the W-stage and the FC head on h1 (filled by stage01) and
// the periph already in h4[FLAT:FLAT+P]; writes the O outputs to y.
template <int D, int W, int O>
__device__ void tail(const float* s, const Act& a, int P, float* __restrict__ y) {
  using N = Net<D, W, O>;
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < N::Q2 * C2; i += N::NT) {      // window K2 over g
    const int o = i % C2, q = i / C2;
    const float* in = a.h1 + q * K2 * O1;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K2 * O1; ++k) acc = fmaf(in[k], s[N::W2 + k * C2 + o], acc);
    a.h2[i] = celu(acc + s[N::BI2 + o]);
  }
  __syncthreads();
  for (int i = tid; i < N::Q3 * C3; i += N::NT) {      // window K3
    const int o = i % C3, q = i / C3;
    const float* in = a.h2 + q * K3 * C2;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K3 * C2; ++k) acc = fmaf(in[k], s[N::W3 + k * C3 + o], acc);
    a.h3[i] = celu(acc + s[N::BI3 + o]);
  }
  __syncthreads();
  for (int i = tid; i < N::Q4 * CW; i += N::NT) {      // column pairs
    const int o = i % CW, q = i / CW;
    const int dq = q / N::WO, wo = q % N::WO;
    const float* in = a.h3 + (dq * W + 2 * wo) * C3;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < 2 * C3; ++k) acc = fmaf(in[k], s[N::WS + k * CW + o], acc);
    a.h4[i] = celu(acc + s[N::BS + o]);
  }
  __syncthreads();
  const int nf0 = N::FLAT + P;
  for (int o = tid; o < F1; o += N::NT) {
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < nf0; ++k) acc = fmaf(a.h4[k], s[N::FW0 + k * F1 + o], acc);
    a.h5[o] = celu(acc + s[N::FB0 + o]);
  }
  __syncthreads();
  for (int o = tid; o < F2; o += N::NT) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < F1; ++k) acc = fmaf(a.h5[k], s[N::FW1 + k * F2 + o], acc);
    a.h6[o] = celu(acc + s[N::FB1 + o]);
  }
  __syncthreads();
  for (int o = tid; o < O; o += N::NT) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < F2; ++k) acc = fmaf(a.h6[k], s[N::FW2 + k * O + o], acc);
    y[o] = acc + s[N::FB2 + o];
  }
  // the next evaluation overwrites h1 and h4's periph: wait for readers
  __syncthreads();
}

// B2: thread block b evaluates blocks [b*bn, min(N, (b+1)*bn)).
template <int D, int W, int O>
__global__ void __launch_bounds__(D * W * G)
block_kernel(const float* __restrict__ x, const float* __restrict__ periph,
             const float* __restrict__ wpack, int P, float* __restrict__ out,
             int N, int bn) {
  using Nt = Net<D, W, O>;
  extern __shared__ float smem[];
  const Act a = load<D, W, O>(smem, wpack, P);
  const int tid = threadIdx.x;
  const int g = tid % G, w = (tid / G) % W, d = tid / (W * G);
  float gt[K1][C0];
  float v[K1];
  const int n0 = blockIdx.x * bn;
  const int n1 = min(N, n0 + bn);
  __syncthreads();
  for (int n = n0; n < n1; ++n) {
    // x[n, ch, d, 2g + kk, w]
    const float* xv = x + (((long long)n * 2 * D + d) * H + g * K1) * W + w;
    const float* xg = xv + (long long)D * H * W;
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) {
      v[kk] = __ldg(xv + kk * W);
      const float gv = __ldg(xg + kk * W);
#pragma unroll
      for (int c = 0; c < C0; ++c) gt[kk][c] = smem[Nt::W0G + c] * gv;
    }
    stage01<D, W, O>(smem, a, v, gt);
    for (int i = tid; i < P; i += Nt::NT)
      a.h4[Nt::FLAT + i] = __ldg(periph + (long long)n * P + i);
    tail<D, W, O>(smem, a, P, out + (long long)n * O);
  }
}

// B3: thread block (j, i) evaluates block j for rows [i*bm, min(M, (i+1)*bm)).
template <int D, int W, int O>
__global__ void __launch_bounds__(D * W * G)
grid_kernel(const float* __restrict__ v01, const float* __restrict__ gnorm,
            const float* __restrict__ wpack, int P, float* __restrict__ out,
            int M, int NB, int NO, int bm) {
  using Nt = Net<D, W, O>;
  extern __shared__ float smem[];
  const Act a = load<D, W, O>(smem, wpack, P);
  const int tid = threadIdx.x;
  const int g = tid % G, w = (tid / G) % W, d = tid / (W * G);
  const long long j = blockIdx.x;             // crossbar block nb*NO + no
  const long long nblk = (long long)NB * NO;
  const long long nb = j / NO;
  const int m0 = blockIdx.y * bm;
  const int m1 = min(M, m0 + bm);
  for (int i = tid; i < P; i += Nt::NT) a.h4[Nt::FLAT + i] = i == 0 ? 1.f : 0.f;
  __syncthreads();
  // the block's conductance term, shared by every row of the tile
  float gt[K1][C0];
  const float* gp = gnorm + ((j * D + d) * H + g * K1) * W + w;
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
    const float gv = __ldg(gp + kk * W);
#pragma unroll
    for (int c = 0; c < C0; ++c) gt[kk][c] = smem[Nt::W0G + c] * gv;
  }
  float v[K1];
  for (int m = m0; m < m1; ++m) {
    const float* vp = v01 + ((m * (long long)NB + nb) * D + d) * H + g * K1;
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) v[kk] = __ldg(vp + kk);
    stage01<D, W, O>(smem, a, v, gt);
    tail<D, W, O>(smem, a, P, out + ((long long)m * nblk + j) * O);
  }
}

template <int D, int W, int O>
int launch_block(const float* x, const float* periph, const float* wpack, int P,
                 float* out, int N, int bn, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Net<D, W, O>::smem_floats(P);
  cudaError_t e = cudaFuncSetAttribute(block_kernel<D, W, O>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned nblocks = (unsigned)((N + bn - 1) / bn);
  block_kernel<D, W, O><<<nblocks, D * W * G, bytes, stream>>>(x, periph, wpack, P,
                                                                out, N, bn);
  return (int)cudaGetLastError();
}

template <int D, int W, int O>
int launch_grid(const float* v01, const float* gnorm, const float* wpack, int P,
                float* out, int M, int NB, int NO, int bm, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Net<D, W, O>::smem_floats(P);
  cudaError_t e = cudaFuncSetAttribute(grid_kernel<D, W, O>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((long long)NB * NO), (unsigned)((M + bm - 1) / bm));
  grid_kernel<D, W, O><<<grid, D * W * G, bytes, stream>>>(v01, gnorm, wpack, P, out,
                                                           M, NB, NO, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// geom 0: CASE_A (D=4, W=2, O=1); geom 1: CASE_B (D=2, W=8, O=4).
// Each returns the launch's cudaError_t (0 = launched); -1 for an unknown geom.
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

extern "C" int emulator_block_grid_f32(int geom, const float* v01,
                                       const float* gnorm, const float* wpack,
                                       int n_periph, float* out, int M, int NB,
                                       int NO, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom == 0)
    return launch_grid<4, 2, 1>(v01, gnorm, wpack, n_periph, out, M, NB, NO, bm, s);
  if (geom == 1)
    return launch_grid<2, 8, 4>(v01, gnorm, wpack, n_periph, out, M, NB, NO, bm, s);
  return -1;
}

// Dynamic shared memory one thread block of the geometry takes, in bytes
// (reported by chip_smoke.py beside ptxas's static counts).
extern "C" int emulator_block_smem_bytes(int geom, int n_periph) {
  if (geom == 0) return (int)(sizeof(float) * Net<4, 2, 1>::smem_floats(n_periph));
  if (geom == 1) return (int)(sizeof(float) * Net<2, 8, 4>::smem_floats(n_periph));
  return -1;
}
