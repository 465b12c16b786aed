// Diagonal gated linear recurrence for Hopper (sm_90a).
//
// Replaces kernels/linear_scan/linear_scan.py:linear_scan_pallas of the JAX
// package (its body is _kernel), the primitive behind Mamba-1's selective
// scan and RG-LRU:
//   h_t = a_t * h_{t-1} + b_t      (element-wise over D, h_{-1} = 0)
// a, b (B, S, D) in fp32 or bf16 (one type for both); the carry stays fp32
// over the whole sequence, as the reference's VMEM carry does; h (B, S, D)
// in a's type.  An optional first row b0 (B, D) stands in for b[:, 0]: the
// entry point folds an initial state h0 into it, so b is never copied.
//
// What bounds it on an H100: bytes.  It does 2 operations per element and
// must read a and b once and write h once; nothing is reused.
//
// What the design does about it: one thread per (batch, d) lane, with
// neighbouring threads on neighbouring d, so every load and store of a
// warp is one contiguous run of memory.  Each thread walks the sequence
// in order with its carry in a register, and issues the loads of the next
// U steps before it computes them, so that U loads of a and of b are in
// flight per thread while the dependent chain runs.  Each step rounds the
// product and the sum apart (no FMA contraction), as the plain version's
// separate multiply and add do.  Small D with few lanes (B*D of a few
// thousand) leaves the card underfilled: splitting S into chunks with a
// second pass over the chunk carries is the known remedy, later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;                 // sequence steps loaded ahead

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ b0, T* __restrict__ h, int B, int S, int D) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= (long long)B * D) return;
  const long long bi = lane / D, d = lane % D;
  const long long base = bi * S * (long long)D + d;
  float carry = 0.f;
  for (int s0 = 0; s0 < S; s0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      av[u] = 0.f;
      bv[u] = 0.f;
      if (s < S) {
        const long long off = base + (long long)s * D;
        av[u] = to_f(a[off]);
        bv[u] = (s == 0 && b0 != nullptr) ? to_f(b0[lane]) : to_f(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < S) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        h[base + (long long)s * D] = from_f<T>(carry);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* b0, void* h, int B,
           int S, int D, cudaStream_t s) {
  const long long lanes = (long long)B * D;
  const unsigned grid = (unsigned)((lanes + THREADS - 1) / THREADS);
  scan_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(b0), static_cast<T*>(h), B, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16 (a, b, b0 and h alike); b0 may be null.  Returns
// the launch's cudaError_t (0 = launched); -1 for an unknown dtype.
extern "C" int linear_scan(int dtype, const void* a, const void* b,
                           const void* b0, void* h, int B, int S, int D,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, b0, h, B, S, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, b0, h, B, S, D, s);
  return -1;
}
