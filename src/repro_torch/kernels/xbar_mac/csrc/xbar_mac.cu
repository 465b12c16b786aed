// Nonlinear crossbar MAC for Hopper (sm_90a).
//
// Replaces kernels/xbar_mac/xbar_mac.py:xbar_mac_pallas of the JAX package
// (its body is _kernel): the analytic 1T1R cell drive, a product with the
// conductances and the integrator's saturation,
//   out = v_sat * tanh(gain * (relu(v - v_th) * (1 + beta*v)) @ g / v_sat)
// v (B, K) and g (K, N) in fp32 or bf16 (one type for both), widened to
// fp32 as they are read; fp32 accumulation; out (B, N) in v's type.
//
// What bounds it on an H100: it is a GEMM with an element-wise prologue on
// v and epilogue on the output.  At a decode batch (B of a few rows) the
// read of g (K*N elements) bounds it by bytes; from B of a few hundred
// rows on, its 2*B*K*N operations bound it (fp32 FMA outside the tensor
// cores, 67 TFLOP/s: TF32 would not hold the fp32 plain version).
//
// What the design does about it: one block of 256 threads per 64 x 64
// output tile walks K in tiles of 32 through shared memory.  The prologue
// runs once per element of v as the v tile is staged (not once per
// product), g is widened as its tile is staged, and each thread keeps a
// 4 x 4 sub-tile of fp32 accumulators in registers; the epilogue runs on
// those registers before the one store.  Ragged edges are masked: a drive
// element past B or K and a conductance past K or N are staged as 0,
// which adds nothing to a sum -- exact, like the reference's zero
// padding.  The prologue and epilogue round each operation (no FMA
// contraction), as the plain version does.  No tensor cores, no cp.async
// pipelining and no split over K yet: simple and right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;   // output tile and K step
constexpr int TM = 4, TN = 4;              // accumulators per thread
constexpr int THREADS = (BM / TM) * (BN / TN);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xbar_mac_kernel(const T* __restrict__ v, const T* __restrict__ g,
                T* __restrict__ out, int B, int K, int N, float v_th,
                float beta, float gain, float v_sat) {
  __shared__ float vs[BK][BM + 1];   // drive, transposed; +1 breaks bank conflicts
  __shared__ float gs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // v tile (BM x BK): neighbouring threads on neighbouring k
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = e / BK, k = e % BK;
      float d = 0.f;
      if (m0 + m < B && k0 + k < K) {
        const float x = to_f(v[(m0 + m) * K + k0 + k]);
        d = __fmul_rn(fmaxf(__fsub_rn(x, v_th), 0.f),
                      __fadd_rn(1.f, __fmul_rn(beta, x)));
      }
      vs[k][m] = d;
    }
    // g tile (BK x BN): neighbouring threads on neighbouring n
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int k = e / BN, n = e % BN;
      gs[k][n] = (k0 + k < K && n0 + n < N)
                     ? to_f(g[(long long)(k0 + k) * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = vs[k][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = gs[k][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * (BM / TM);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + j * (BN / TN);
      if (n >= N) continue;
      const float y = __fmul_rn(v_sat, tanhf(__fdiv_rn(__fmul_rn(gain, acc[i][j]), v_sat)));
      out[m * N + n] = from_f<T>(y);
    }
  }
}

template <typename T>
int launch(const void* v, const void* g, void* out, int B, int K, int N,
           float v_th, float beta, float gain, float v_sat, cudaStream_t s) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
  xbar_mac_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(out),
      B, K, N, v_th, beta, gain, v_sat);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16 (v, g and out alike).  Returns the launch's
// cudaError_t (0 = launched); -1 for an unknown dtype.
extern "C" int xbar_mac(int dtype, const void* v, const void* g, void* out,
                        int B, int K, int N, float v_th, float beta,
                        float gain, float v_sat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(v, g, out, B, K, N, v_th, beta, gain, v_sat, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(v, g, out, B, K, N, v_th, beta, gain, v_sat, s);
  return -1;
}
