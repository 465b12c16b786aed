// Online-softmax (flash) attention for Hopper (sm_90a), causal and/or
// sliding window.
//
// Replaces kernels/flash_attention/flash_attention.py:flash_attention_pallas
// of the JAX package (its body is _kernel).  q, k, v (BH, S, D) in fp32 or
// bf16 (one type for all three); out (BH, S, D) in v's type.  Numerics
// follow the reference kernel: q is widened to fp32 and scaled before the
// q.k^T product; masked scores take the finite NEG_INF = -1e30 (never
// -inf: exp(-inf - (-inf)) would be NaN on a row's first, fully masked
// tile); the running max m, sum l and accumulator stay fp32; in bf16 the
// probabilities p are rounded to bf16 before the p.v product, whose sums
// stay fp32; the result is acc / max(l, 1e-20).
//
// What bounds it on an H100: operations.  Each unmasked (q, k) pair costs
// 2*D for its score and 2*D for its share of p.v, against one read of q,
// k, v and one write of the output, so from S of a few hundred on the
// arithmetic dominates (fp32 FMA here, 67 TFLOP/s; the bf16 inputs' bound
// is the tensor cores' 989 TFLOP/s, which this kernel does not use yet).
//
// What the design does about it: one block of 256 threads per (b*h, tile
// of 64 query rows).  The scaled q tile stays in shared memory; K (stored
// transposed; both pitches padded against bank conflicts) and V tiles of 64
// rows stream through shared memory.  Each thread owns 4 query rows x 4
// key columns of the score tile and the same 4 rows x D/16 columns of the
// output accumulator, in registers, so the online-softmax state of a row
// lives in the 16 threads that share it (reduced with warp shuffles).
// KV tiles wholly outside the causal / window band are skipped.  That is
// exact: in the reference such a tile either comes after a row's live
// keys (p = exp(-1e30 - m) = 0, alpha = 1) or before them, where its
// p = 1 garbage is erased by the next live tile's alpha =
// exp(-1e30 - m) = 0.  Keys past S (ragged S) are masked like the band
// and their V rows are 0.  Shared memory is up to 214,528 B at D = 256,
// past the 48 KB default after the opt-in.  Scalar fp32 FMA, no
// tensor cores, no pipelining of the tile loads: simple and right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64;      // query rows and keys per tile
constexpr int THREADS = 256;         // 16 x 16
constexpr int TR = BQ / 16;          // query rows per thread
constexpr int TC = BK / 16;          // score columns per thread
constexpr int KP = BK + 1;           // pitch of the transposed K tile
constexpr int PP = BK + 1;           // pitch of the probability tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// p as the p.v product takes it: rounded to v's type
template <typename T> __device__ __forceinline__ float p_operand(float p) {
  return to_f(from_f<T>(p));
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)D * KP + (size_t)BK * D
                          + (size_t)BQ * PP);
}

// max and sum over the 16 lanes that share a query row (all lanes get the
// same value: each butterfly step adds the same two numbers either way)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int D,
             float scale, int causal, int window) {
  constexpr int DC = DMAX / 16;      // output columns per thread
  extern __shared__ float smem[];
  const int qp_ = D + 1;             // pitch of the q tile
  float* qs = smem;                  // (BQ, qp_) scaled q
  float* kt = qs + BQ * qp_;         // (D, KP) K tile, transposed
  float* vs = kt + D * KP;           // (BK, D) V tile
  float* ps = vs + BK * D;           // (BQ, PP) probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long head = (long long)blockIdx.x * S * D;
  const int q0 = blockIdx.y * BQ;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * qp_ + c] = q0 + r < S ? __fmul_rn(to_f(q[head + (long long)(q0 + r) * D + c]), scale)
                       : 0.f;
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // the KV tiles that hold a live key for some row of this tile
  const int q_last = min(S, q0 + BQ) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_lo / BK; t <= k_hi / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();                 // the last tile's kt / vs / ps are read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < S;
      const long long off = head + (long long)(k0 + r) * D + c;
      kt[c * KP + r] = in ? to_f(k[off]) : 0.f;
      vs[e] = in ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TC; ++b) s[a][b] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[TR], kb[TC];
#pragma unroll
      for (int a = 0; a < TR; ++a) qa[a] = qs[(ty + 16 * a) * qp_ + d];
#pragma unroll
      for (int b = 0; b < TC; ++b) kb[b] = kt[d * KP + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < TC; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int qp = q0 + ty + 16 * a;
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < TC; ++b) {
        const int kp = k0 + tx + 16 * b;
        const bool live = kp < S && (!causal || kp <= qp) &&
                          (window == 0 || qp - kp < window);
        if (!live) s[a][b] = NEG_INF;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < TC; ++b) {
        const float p = expf(s[a][b] - m_new);
        rs += p;
        ps[(ty + 16 * a) * PP + tx + 16 * b] = p_operand<T>(p);
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + row_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pa[TR];
#pragma unroll
      for (int a = 0; a < TR; ++a) pa[a] = ps[(ty + 16 * a) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dc = tx + 16 * c;
        if (dc < D) {
          const float vv = vs[j * D + dc];
#pragma unroll
          for (int a = 0; a < TR; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= S) continue;
    const float den = fmaxf(l[a], 1e-20f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < D) out[head + (long long)qp * D + dc] = from_f<T>(__fdiv_rn(acc[a][c], den));
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int D, float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BH, (unsigned)((S + BQ - 1) / BQ));
  flash_kernel<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, D, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int D, float scale, int causal, int window, cudaStream_t s) {
  if (D <= 64) return launch<T, 64>(q, k, v, out, BH, S, D, scale, causal, window, s);
  if (D <= 128) return launch<T, 128>(q, k, v, out, BH, S, D, scale, causal, window, s);
  if (D <= 256) return launch<T, 256>(q, k, v, out, BH, S, D, scale, causal, window, s);
  return -1;
}

}  // namespace

// Dynamic shared memory one block takes at head dim D.
extern "C" int flash_attention_smem_bytes(int D) { return (int)smem_bytes(D); }

// dtype 0: fp32, 1: bf16 (q, k, v and out alike); 1 <= D <= 256.  Returns
// the launch's cudaError_t (0 = launched); -1 for an unknown dtype or D.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int BH, int S, int D,
                               float scale, int causal, int window,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, BH, S, D, scale, causal, window, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, BH, S, D, scale, causal, window, s);
  return -1;
}
