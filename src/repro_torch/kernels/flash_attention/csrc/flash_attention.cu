// Online-softmax (flash) attention for Hopper (sm_90a), causal and/or
// sliding window, on the tensor cores.
//
// Replaces kernels/flash_attention/flash_attention.py:flash_attention_pallas
// of the JAX package (its body is _kernel).  q, k, v (BH, S, D) in fp32 or
// bf16 (one type for all three); out (BH, S, D) in v's type.  Numerics
// follow the reference kernel: masked scores take the finite NEG_INF =
// -1e30 (never -inf: exp(-inf - (-inf)) would be NaN on a row's first,
// fully masked tile); the running max m, sum l and accumulator stay fp32;
// in bf16 the probabilities p are rounded to bf16 before the p.v product,
// whose sums stay fp32; the result is acc / max(l, 1e-20).  Two changes of
// rounding only: the score is (q.k) * scale where the reference takes
// (q*scale).k (a product of two bf16 values is exact in fp32, so nothing
// is rounded to bf16 that the reference keeps in fp32), and
// exp(s - m) is taken as exp2(s*log2e - m*log2e), with scale*log2e folded
// into one fp32 factor.
//
// What bounds it on an H100: operations.  Each unmasked (q, k) pair costs
// 2*D for its score and 2*D for its share of p.v, against one read of q,
// k, v and one write of the output; from S of a few hundred on the
// arithmetic dominates: 989 TFLOP/s for bf16 inputs on the tensor cores,
// and for fp32 inputs 67 TFLOP/s outside them, or 495/3 = 165 TFLOP/s as
// the three TF32 products that keep fp32's accuracy (3xTF32, below).
//
// What the design does about it: one block of 4 warps per (b*h, tile of
// 64 query rows); each warp owns 16 query rows, its scores and its
// 16 x D fp32 output accumulator in registers (m16n8 C fragments: the
// online-softmax state of a row lives in the 4 lanes that share it,
// reduced with two shuffles).  Both products run on the tensor cores with
// fp32 accumulation: in bf16 as mma.sync.m16n8k16 (q and k through
// ldmatrix, the next head-dim step's fragments loaded while this one
// multiplies; v through ldmatrix.trans; p converted in registers from the
// score accumulators, whose C layout is the A layout of the next product);
// in fp32 as 3xTF32 on mma.sync.m16n8k8 (every operand split into tf32
// hi + lo, three products, each pass run over 4 accumulators in turn so
// that no product waits on the one before it), where the keys of each
// 8-key step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides
// of p.v so that the score fragment again serves as the A fragment without
// shuffles.  K/V tiles of 32 keys stream through shared memory with
// cp.async, double buffered: the next tile loads while this one is
// multiplied.  Row pitches are padded by 16 B so that ldmatrix and the
// fragment loads hit 32 distinct banks.  Shared memory at D = 256:
// 101,376 B in bf16 (two blocks per SM, with all of L1 given to shared
// memory), 199,680 B in fp32 (one).  At D = 64, 128 or 256 the products
// run without bounds checks, so the compiler can schedule across them.
// The grid is one dimension, query tiles in descending order, so that
// under a causal mask the heaviest tiles launch first.  KV tiles wholly
// outside the causal / window band are skipped.  That is exact: in the
// reference such a tile either comes after a row's live keys (p =
// exp(-1e30 - m) = 0, alpha = 1) or before them, where its p = 1 garbage
// is erased by the next live tile's alpha = exp(-1e30 - m) = 0.  Keys past
// S (ragged S) are masked like the band and their K/V rows are 0; head-dim
// columns past D are 0 in q, k and v.  Rows of D * sizeof(T) bytes that
// are not a multiple of 16, or misaligned tensors, are staged element by
// element instead of by cp.async.  Not used yet: wgmma and TMA (one
// warpgroup issuing 64-row products from shared memory, a producer warp
// keeping tile loads in flight), which would lift the mma.sync instruction rate
// and free the registers that hold fragments; and a split of the
// heaviest causal query tiles' KV range across blocks, which would even
// out the causal grid's last wave.
#include <stdint.h>

#include "../../common/csrc/sm90_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;             // each owns 16 query rows
constexpr int BQ = 16 * WARPS, BK = 32;   // query rows and keys per tile
constexpr int THREADS = 32 * WARPS;
constexpr int KT = BK / 8;           // 8-key column tiles of a score tile

template <typename T> struct Pad;    // row padding (elements): 16 bytes
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };
template <typename T, int DP>
__host__ __device__ constexpr int pitch() { return DP + Pad<T>::v; }

template <typename T, int DP> constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)pitch<T, DP>() * (BQ + 4 * BK);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows row0 .. row0+R-1 of a (S, D) matrix into an (R, DP) tile; rows past
// S and columns past D are 0.  vec: D * sizeof(T) % 16 == 0 and 16-byte
// aligned data, so each 16-byte chunk is wholly in or wholly out.  Trip
// counts are compile-time constants, so the copies unroll into straight code.
template <typename T, int DP, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int S,
                                          int D, bool vec) {
  constexpr int P = pitch<T, DP>();
  if (vec) {
    constexpr int EPC = 16 / sizeof(T), CPR = DP / EPC, CHUNKS = R * CPR;
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int c = threadIdx.x + it * THREADS;
      if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
      const int r = c / CPR, col = (c % CPR) * EPC, row = row0 + r;
      const bool in = row < S && col < D;
      sm90::cp_async16(dst + r * P + col, in ? src + (long long)row * D + col : src,
                       in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * DP; e += THREADS) {
      const int r = e / DP, col = e % DP, row = row0 + r;
      dst[r * P + col] = row < S && col < D ? src[(long long)row * D + col] : zero<T>();
    }
  }
}

// s (16 x BK scores of this warp) = q_w . k^T over the head dim; FULL:
// D == DP, known at compile time
template <int DP, bool FULL>
__device__ __forceinline__ void qk(float (&s)[KT][4], const __nv_bfloat16* qw,
                                   const __nv_bfloat16* kb, int D, int lane) {
  constexpr int P = pitch<__nv_bfloat16, DP>();
  if (FULL) D = DP;                  // every bound below becomes a constant
  const __nv_bfloat16* qa = qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
  const __nv_bfloat16* ka = kb + ((lane >> 4) * 8 + (lane & 7)) * P + ((lane >> 3) & 1) * 8;
  const int steps = (D + 15) / 16;
  // fragments of step d+1 load while step d multiplies
  uint32_t a[2][4], b[2][KT / 2][4];
  auto load = [&](int d, int buf) {
    sm90::ldmatrix_x4(a[buf], qa + d * 16);
#pragma unroll
    for (int jp = 0; jp < KT / 2; ++jp)
      sm90::ldmatrix_x4(b[buf][jp], ka + jp * 16 * P + d * 16);
  };
  load(0, 0);
#pragma unroll
  for (int d = 0; d < DP / 16; ++d) {
    if (d >= steps) break;
    if (d + 1 < steps) load(d + 1, (d + 1) & 1);
#pragma unroll
    for (int jp = 0; jp < KT / 2; ++jp) {
      sm90::mma_bf16(s[2 * jp], a[d & 1], b[d & 1][jp][0], b[d & 1][jp][1]);
      sm90::mma_bf16(s[2 * jp + 1], a[d & 1], b[d & 1][jp][2], b[d & 1][jp][3]);
    }
  }
}

template <int DP, bool FULL>
__device__ __forceinline__ void qk(float (&s)[KT][4], const float* qw,
                                   const float* kb, int D, int lane) {
  constexpr int P = pitch<float, DP>();
  if (FULL) D = DP;                  // every bound below becomes a constant
  const int g = lane >> 2, t = lane & 3;
  const float* qa = qw + g * P + t;
  const float* ka = kb + g * P + t;
  const int steps = (D + 7) / 8;
#pragma unroll 2
  for (int d = 0; d < steps; ++d) {
    uint32_t ah[4], al[4], bh[KT][2], bl[KT][2];
    sm90::split_tf32(qa[d * 8], ah[0], al[0]);
    sm90::split_tf32(qa[8 * P + d * 8], ah[1], al[1]);
    sm90::split_tf32(qa[d * 8 + 4], ah[2], al[2]);
    sm90::split_tf32(qa[8 * P + d * 8 + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      sm90::split_tf32(ka[j * 8 * P + d * 8], bh[j][0], bl[j][0]);
      sm90::split_tf32(ka[j * 8 * P + d * 8 + 4], bh[j][1], bl[j][1]);
    }
    // the three passes in turn over the KT accumulators, so that no
    // product waits on the one before it
#pragma unroll
    for (int j = 0; j < KT; ++j) sm90::mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < KT; ++j) sm90::mma_tf32(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < KT; ++j) sm90::mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
  }
}

// acc (16 x DP of this warp) += p . v; p in the score fragments
template <int DP, bool FULL>
__device__ __forceinline__ void pv(float (&acc)[DP / 8][4], const float (&p)[KT][4],
                                   const __nv_bfloat16* vb, int D, int lane) {
  constexpr int P = pitch<__nv_bfloat16, DP>();
  if (FULL) D = DP;                  // every bound below becomes a constant
  const __nv_bfloat16* va = vb + (((lane >> 3) & 1) * 8 + (lane & 7)) * P + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[4];
    a[0] = sm90::pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    a[1] = sm90::pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    a[2] = sm90::pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    a[3] = sm90::pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      if (np * 16 < D) {
        uint32_t b[4];
        sm90::ldmatrix_x4_trans(b, va + ks * 16 * P + np * 16);
        sm90::mma_bf16(acc[2 * np], a, b[0], b[1]);
        sm90::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DP, bool FULL>
__device__ __forceinline__ void pv(float (&acc)[DP / 8][4], const float (&p)[KT][4],
                                   const float* vb, int D, int lane) {
  constexpr int P = pitch<float, DP>();
  if (FULL) D = DP;                  // every bound below becomes a constant
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    // k index t <-> key 2t, t+4 <-> key 2t+1 (the C fragment's columns)
    uint32_t ah[4], al[4];
    sm90::split_tf32(p[j][0], ah[0], al[0]);
    sm90::split_tf32(p[j][2], ah[1], al[1]);
    sm90::split_tf32(p[j][1], ah[2], al[2]);
    sm90::split_tf32(p[j][3], ah[3], al[3]);
    const float* va = vb + (j * 8 + 2 * t) * P + g;
    // 4 output tiles at a time, the three passes in turn over them
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += 4) {
      if (n0 * 8 < D) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          sm90::split_tf32(va[(n0 + n) * 8], bh[n][0], bl[n][0]);
          sm90::split_tf32(va[P + (n0 + n) * 8], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) sm90::mma_tf32(acc[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) sm90::mma_tf32(acc[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) sm90::mma_tf32(acc[n0 + n], ah, bh[n][0], bh[n][1]);
      }
    }
  }
}

// max / sum over the 4 lanes that share a row (every lane gets the result)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int BH, int S, int D,
             float scale_log2, int causal, int window, int vec) {
  constexpr int P = pitch<T, DP>();
  constexpr int NT = DP / 8;         // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // (BQ, P)
  T* ks = qs + BQ * P;                      // 2 x (BK, P)
  T* vs = ks + 2 * BK * P;                  // 2 x (BK, P)

  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BQ;   // heaviest first
  const long long head = (long long)bh * S * D;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this lane's two rows

  // the KV tiles that hold a live key for some row of this tile
  const int q_last = min(S, q0 + BQ) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = k_hi / BK;

  load_tile<T, DP, BQ>(qs, qh, q0, S, D, vec);
  load_tile<T, DP, BK>(ks, kh, t_lo * BK, S, D, vec);
  load_tile<T, DP, BK>(vs, vh, t_lo * BK, S, D, vec);
  sm90::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int tt = t_lo; tt <= t_hi; ++tt) {
    const int buf = (tt - t_lo) & 1;
    if (tt < t_hi) {                 // the next tile, into the other buffer
      load_tile<T, DP, BK>(ks + (buf ^ 1) * BK * P, kh, (tt + 1) * BK, S, D, vec);
      load_tile<T, DP, BK>(vs + (buf ^ 1) * BK * P, vh, (tt + 1) * BK, S, D, vec);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();

    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // D == DP (the model shapes) takes code without bounds checks, which
    // the compiler can schedule across
    if (D == DP) qk<DP, true>(s, qs + warp * 16 * P, ks + buf * BK * P, D, lane);
    else qk<DP, false>(s, qs + warp * 16 * P, ks + buf * BK * P, D, lane);

    const int k0 = tt * BK;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? r0 : r1;
        const bool live = kp < S && (!causal || kp <= qp) &&
                          (window == 0 || qp - kp < window);
        s[j][e] = live ? s[j][e] * scale_log2 : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]); else mx1 = fmaxf(mx1, s[j][e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - (e < 2 ? mn0 : mn1));
        s[j][e] = p;
        if (e < 2) rs0 += p; else rs1 += p;
      }
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    l0 = l0 * a0 + quad_sum(rs0);
    l1 = l1 * a1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0; acc[n][1] *= a0;
      acc[n][2] *= a1; acc[n][3] *= a1;
    }
    if (D == DP) pv<DP, true>(acc, s, vs + buf * BK * P, D, lane);
    else pv<DP, false>(acc, s, vs + buf * BK * P, D, lane);
    __syncthreads();                 // this tile's buffers are free again
  }

  const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? r0 : r1;
      if (row < S && col < D)
        out[head + (long long)row * D + col] =
            from_f<T>(__fdiv_rn(acc[n][e], e < 2 ? den0 : den1));
    }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int D, float scale, int causal, int window, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, DP>();
  static unsigned configured = 0;
  cudaError_t err = sm90::configure_smem(flash_kernel<T, DP>, (int)smem, configured);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
                         | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = aligned && (D * sizeof(T)) % 16 == 0;
  const unsigned grid = (unsigned)(BH * ((S + BQ - 1) / BQ));
  flash_kernel<T, DP><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, S, D, scale * LOG2E,
      causal, window, vec);
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

template <typename T> size_t smem_d(int D) {
  return D <= 64 ? smem_bytes<T, 64>() : D <= 128 ? smem_bytes<T, 128>()
                                                  : smem_bytes<T, 256>();
}

}  // namespace

// Dynamic shared memory one block takes at head dim D (dtype as below).
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  return (int)(dtype == 0 ? smem_d<float>(D) : smem_d<__nv_bfloat16>(D));
}

// dtype 0: fp32, 1: bf16 (q, k, v and out alike); 1 <= D <= 256;
// BH * ceil(S / 64) < 2^31.  Returns the launch's cudaError_t (0 =
// launched); -1 for an unknown dtype or D.
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
