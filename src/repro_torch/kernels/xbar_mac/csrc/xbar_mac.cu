// Nonlinear crossbar MAC for Hopper (sm_90a), on the tensor cores.
//
// Replaces kernels/xbar_mac/xbar_mac.py:xbar_mac_pallas of the JAX package
// (its body is _kernel): the analytic 1T1R cell drive, a product with the
// conductances and the integrator's saturation,
//   out = v_sat * tanh(gain * (relu(v - v_th) * (1 + beta*v)) @ g / v_sat)
// v (B, K) and g (K, N) in fp32 or bf16 (one type for both); the drive is
// computed in fp32 from v widened to fp32; fp32 accumulation; out (B, N)
// in v's type.  In bf16 the drive is rounded to bf16 before the product
// (the plain version does the same in bf16 mode), so that both operands
// go to the bf16 tensor cores, where each product is exact in fp32.  In
// fp32 the product runs as 3xTF32 (each operand split into tf32 hi + lo,
// three products; see common/csrc/sm90_mma.cuh), which keeps fp32's
// accuracy.
//
// What bounds it on an H100: it is a GEMM with an element-wise prologue on
// v and epilogue on the output.  At a decode batch (B of a few rows) the
// read of g (K*N elements) bounds it by bytes; from B of a few hundred
// rows on, its 2*B*K*N operations bound it (989 TFLOP/s for bf16 inputs;
// for fp32 ones 67 TFLOP/s outside the tensor cores, 495/3 = 165 TFLOP/s
// as 3xTF32).
//
// What the design does about it: a block computes one BM x BN output tile
// over one range of K, in steps of 32, with mma.sync (m16n8k16 bf16, or
// m16n8k8 tf32 three times, each pass run over 4 accumulators in turn). v
// and g tiles stream through a cp.async ring in shared memory (4 stages in
// bf16, 3 in fp32).  When a stage has landed the block applies the
// prologue to its v tile in place, once per element (fp32, each operation
// rounded apart as in the plain version, then rounded to bf16 in bf16
// mode), and the warps multiply it (bf16: ldmatrix for the drive,
// ldmatrix.trans for g; fp32: fragments read straight from padded rows,
// conflict-free).  One barrier per K step: the prologue of step k+1 runs
// in the same interval as the products of step k, issued after them, so
// that it executes while they do.  In bf16 the prologue takes a pair of
// values a word and packs the pair back in one conversion; tiles that lie
// wholly inside v and g (every tile but the edges' at the model shapes)
// load and apply it without bounds checks.  Three tile shapes, picked from
// B and N: 128 x 128 (8 warps, 32 x 64 each in bf16, 64 x 32 in fp32)
// where those tiles give each SM a block, 64 x 64 (4 warps) below that,
// and 16 x 128 (4 warps) for a decode batch of at most 16 rows.  At most
// 128 registers a thread keep two blocks on each SM, so that one block's
// barrier waits overlap the other's products.  Where the tiles alone give
// fewer than 132 blocks (decode, and mlp.down's narrow N), K is split so
// that about two blocks run on each SM: each block writes its fp32 partial
// tile to a workspace, and the last block of a tile to arrive (one atomic
// counter per tile, which that block sets back to 0 for the next call)
// sums the partials in split order, which keeps the result deterministic,
// and applies the epilogue; still one launch per call.  The epilogue v_sat
// * tanh(gain * acc / v_sat) runs on the fp32 sums before the one store,
// tanh from the hardware exp2 (an absolute error of a few fp32 ulps of 1).
// Ragged edges are masked: a drive element past B or the split's K range
// and a conductance past K or N are 0, which adds nothing to a sum --
// exact, like the reference's zero padding.  Rows whose bytes are not a
// multiple of 16, or misaligned tensors, are staged element by element
// instead of by cp.async.  Not used yet: wgmma and TMA (a warpgroup
// issuing 64-row products straight from shared memory, a producer warp
// keeping loads in flight, TMA multicast sharing one g tile across a
// cluster), which would lift the mma.sync instruction rate and halve the
// L2 traffic per product.
#include <stdint.h>

#include "../../common/csrc/sm90_mma.cuh"

namespace {

constexpr int BK = 32, SMS = 132, MAX_SPLITS = 16;
// stages of the cp.async ring: two 256-thread blocks of either type fit an SM
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 4 : 3; }

template <typename T> struct Pad;    // v-tile row padding (elements): 16 bytes
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> struct alignas(2 * sizeof(T)) T2 { T x, y; };

template <typename T, int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // mma tiles per warp
  static constexpr int AP = BK + Pad<T>::v;            // v-tile pitch
  static constexpr int BP = BN + 8;                    // g-tile pitch
  static constexpr int STAGE = BM * AP + BK * BP;      // elements per stage
  static constexpr int STAGES = stages<T>();
  static constexpr size_t SMEM = sizeof(T) * (size_t)STAGES * STAGE;
};

// rows [r0, r0+R) x cols [c0, c0+C) of a row-major (rows, ld) matrix into a
// tile of pitch P; entries past (r_end, c_end) are 0.  vec: every 16-byte
// chunk is wholly in or wholly out, and 16-byte aligned.  Trip counts are
// compile-time constants, so each thread's copies unroll into straight code.
template <typename T, int R, int C, int P, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int r0, int r_end, int c0, int c_end,
                                          bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T), CPR = C / EPC, CHUNKS = R * CPR;
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool in = r0 + r < r_end && c0 + c < c_end;
      sm90::cp_async16(dst + r * P + c,
                       in ? src + (r0 + r) * ld + c0 + c : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < R * C; i += THREADS) {
      const int r = i / C, c = i % C;
      dst[r * P + c] = r0 + r < r_end && c0 + c < c_end
                           ? src[(r0 + r) * ld + c0 + c] : from_f<T>(0.f);
    }
  }
}

// the same for a tile wholly inside the matrix, whose rows' bytes are a
// multiple of 16 and 16-byte aligned: no bounds checks
template <typename T, int R, int C, int P, int THREADS>
__device__ __forceinline__ void load_tile_whole(T* dst, const T* src, long long ld) {
  constexpr int EPC = 16 / sizeof(T), CPR = C / EPC, CHUNKS = R * CPR;
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
    const int r = i / CPR, c = (i % CPR) * EPC;
    sm90::cp_async16(dst + r * P + c, src + r * ld + c, 16);
  }
}

// one BK step of this warp's products: bf16 mma.sync
template <int MT, int NT, int AP, int BP, bool FULL>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int lane,
                                         int live_mt) {
  if (FULL) live_mt = MT;            // every bound below becomes a constant
  const __nv_bfloat16* aa = as + ((lane & 7) + ((lane >> 3) & 1) * 8) * AP + (lane >> 4) * 8;
  const __nv_bfloat16* ba = bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * BP + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (mt < live_mt) sm90::ldmatrix_x4(a[mt], aa + mt * 16 * AP + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      sm90::ldmatrix_x4_trans(b, ba + kk * 16 * BP + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < live_mt) {
          sm90::mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          sm90::mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
    }
  }
}

// one BK step of this warp's products: 3xTF32 mma.sync
template <int MT, int NT, int AP, int BP, bool FULL>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const float* as,
                                         const float* bs, int lane, int live_mt) {
  if (FULL) live_mt = MT;            // every bound below becomes a constant
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = bs + (kk * 8 + t) * BP + nt * 8 + g;
      sm90::split_tf32(b[0], bh[nt][0], bl[nt][0]);
      sm90::split_tf32(b[4 * BP], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= live_mt) continue;
      const float* a = as + (mt * 16 + g) * AP + kk * 8 + t;
      uint32_t ah[4], al[4];
      sm90::split_tf32(a[0], ah[0], al[0]);
      sm90::split_tf32(a[8 * AP], ah[1], al[1]);
      sm90::split_tf32(a[4], ah[2], al[2]);
      sm90::split_tf32(a[8 * AP + 4], ah[3], al[3]);
      // the three passes in turn over the NT accumulators, so that no
      // product waits on the one before it
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sm90::mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sm90::mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sm90::mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
    }
  }
}

__device__ __forceinline__ float drive(float x, float v_th, float beta) {
  return __fmul_rn(fmaxf(__fsub_rn(x, v_th), 0.f), __fadd_rn(1.f, __fmul_rn(beta, x)));
}

// the cell prologue on one landed (BM, BK) v tile, in place; entries past
// (r_end, c_end) become 0.  vec: as load_tile's, one 16-byte chunk at a time.
// INSIDE: the tile lies wholly inside v (no entry to zero, no checks).
template <typename T, int BM, int AP, int THREADS, bool INSIDE>
__device__ __forceinline__ void prologue(T* as, int r_end, int c_end, float v_th,
                                         float beta, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T), CPR = BK / EPC, CHUNKS = BM * CPR;
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
      const int r = i / CPR, c = (i % CPR) * EPC;
      T* p = as + r * AP + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (INSIDE || (r < r_end && c < c_end)) {
        u = *reinterpret_cast<const uint4*>(p);
        if constexpr (sizeof(T) == 2) {   // a pair a word, packed in one conversion
          uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float lo = __uint_as_float(w[j] << 16);
            const float hi = __uint_as_float(w[j] & 0xffff0000u);
            const __nv_bfloat162 d = __floats2bfloat162_rn(drive(lo, v_th, beta),
                                                           drive(hi, v_th, beta));
            w[j] = *reinterpret_cast<const uint32_t*>(&d);
          }
        } else {
          float* e = reinterpret_cast<float*>(&u);
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = drive(e[j], v_th, beta);
        }
      }
      *reinterpret_cast<uint4*>(p) = u;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      as[r * AP + c] = from_f<T>(r < r_end && c < c_end
                                     ? drive(to_f(as[r * AP + c]), v_th, beta) : 0.f);
    }
  }
}

// v_sat * tanh(gain * acc / v_sat), with tanh(x) = sign(x) (1 - 2 / (exp(2|x|)
// + 1)) on the hardware exp2 and a fast division: an absolute error of a few
// fp32 ulps of 1, where tanhf's branches and polynomial cost an eighth of
// the kernel's time at mlp.up M = 2048
__device__ __forceinline__ float saturate(float acc, float gain, float v_sat) {
  const float x = __fdiv_rn(__fmul_rn(gain, acc), v_sat);
  const float t = 1.f - __fdividef(2.f, exp2f(2.f * 1.4426950408889634f * fabsf(x)) + 1.f);
  return __fmul_rn(v_sat, copysignf(t, x));
}

// at most 128 registers a thread, so that two 256-thread blocks (four of
// 128) share an SM and one block's barrier waits overlap another's products
template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(Tile<T, BM, BN, WM, WN>::THREADS,
                                  512 / Tile<T, BM, BN, WM, WN>::THREADS)
xbar_mac_kernel(const T* __restrict__ v, const T* __restrict__ g,
                T* __restrict__ out, int B, int K, int N, int chunk,
                float v_th, float beta, float gain, float v_sat, int vec,
                int* __restrict__ counters, float* __restrict__ partial) {
  using L = Tile<T, BM, BN, WM, WN>;
  constexpr int THREADS = L::THREADS, MT = L::MT, NT = L::NT;
  constexpr int AP = L::AP, BP = L::BP, STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int kb = split * chunk, ke = min(K, kb + chunk);
  const int nk = (ke - kb + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  // this warp's m16 tiles that hold a row < B (uniform across the warp)
  const int live_mt = min(MT, max(0, (B - m0 - wm * L::WTM + 15) / 16));

  // the tile lies inside v and g and K's range is whole steps: the loads
  // need no bounds checks
  const bool inside = vec && m0 + BM <= B && n0 + BN <= N && (ke - kb) % BK == 0;
  auto load_stage = [&](int kt) {
    T* as = smem + (kt % STAGES) * L::STAGE;
    T* bs = as + BM * AP;
    const int k0 = kb + kt * BK;
    if (inside) {
      load_tile_whole<T, BM, BK, AP, THREADS>(as, v + (long long)m0 * K + k0, K);
      load_tile_whole<T, BK, BN, BP, THREADS>(bs, g + (long long)k0 * N + n0, N);
    } else {
      load_tile<T, BM, BK, AP, THREADS>(as, v, K, m0, B, k0, ke, vec);
      load_tile<T, BK, BN, BP, THREADS>(bs, g + (long long)k0 * N, N, 0, ke - k0,
                                        n0, N, vec);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the prologue of step kt+1 and the products of step kt share one
  // barrier interval, so that warps overlap them
  auto prologue_stage = [&](int kt) {
    if (inside)
      prologue<T, BM, AP, THREADS, true>(smem + (kt % STAGES) * L::STAGE, B - m0,
                                         ke - kb - kt * BK, v_th, beta, true);
    else
      prologue<T, BM, AP, THREADS, false>(smem + (kt % STAGES) * L::STAGE, B - m0,
                                          ke - kb - kt * BK, v_th, beta, vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (nk > 0) prologue_stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 3>();
    // step kt+1 landed and step kt's prologue is done; step kt-1's stage is free
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    sm90::cp_async_commit();
    const T* as = smem + (kt % STAGES) * L::STAGE;
    // warps whose rows all lie below B (all but the last row tile's) take
    // code without bounds checks, which the compiler can schedule across
    if (live_mt == MT)
      mma_step<MT, NT, AP, BP, true>(acc, as + wm * L::WTM * AP,
                                     as + BM * AP + wn * L::WTN, lane, live_mt);
    else
      mma_step<MT, NT, AP, BP, false>(acc, as + wm * L::WTM * AP,
                                      as + BM * AP + wn * L::WTN, lane, live_mt);
    // after the products are issued, so that it runs while they execute
    if (kt + 1 < nk) prologue_stage(kt + 1);
  }

  const int gq = lane >> 2, tq = lane & 3;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g+8: two neighbouring columns each
          const int m = m0 + wm * L::WTM + i * 16 + gq + h * 8;
          const int n = n0 + wn * L::WTN + j * 8 + 2 * tq;
          if (m >= B || n >= N) continue;
          T* o = out + (long long)m * N + n;
          const T y0 = from_f<T>(saturate(acc[i][j][2 * h], gain, v_sat));
          if (n + 1 < N) {
            const T y1 = from_f<T>(saturate(acc[i][j][2 * h + 1], gain, v_sat));
            if (N % 2 == 0) {          // the pair is aligned: one store
              T2<T> pair{y0, y1};
              *reinterpret_cast<T2<T>*>(o) = pair;
            } else {
              o[0] = y0;
              o[1] = y1;
            }
          } else {
            o[0] = y0;
          }
        }
    return;
  }

  // split K: this block's partial tile, then the last block of the tile
  // sums the partials in split order and stores the output
  float* mine = partial + (long long)split * B * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * L::WTM + i * 16 + gq + (e >> 1) * 8;
        const int n = n0 + wn * L::WTN + j * 8 + 2 * tq + (e & 1);
        if (m < B && n < N) mine[(long long)m * N + n] = acc[i][j][e];
      }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // four columns a thread at a time, every split's loads in flight at once
  const long long stride = (long long)B * N;
  for (int i = threadIdx.x; i < BM * BN / 4; i += THREADS) {
    const int m = m0 + i / (BN / 4), n = n0 + i % (BN / 4) * 4;
    if (m >= B || n >= N) continue;
    const float* p = partial + (long long)m * N + n;
    if (N % 4 == 0) {                // n + 3 < N, and 16-byte aligned
      const float4* q = reinterpret_cast<const float4*>(p);
      float4 sum = __ldcg(q);
      for (int s0 = 1; s0 < splits; s0 += 4) {   // four loads in flight
        float4 x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + j < splits) x[j] = __ldcg(q + (s0 + j) * stride / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + j < splits) {
            sum.x += x[j].x; sum.y += x[j].y; sum.z += x[j].z; sum.w += x[j].w;
          }
      }
      T* o = out + (long long)m * N + n;
      o[0] = from_f<T>(saturate(sum.x, gain, v_sat));
      o[1] = from_f<T>(saturate(sum.y, gain, v_sat));
      o[2] = from_f<T>(saturate(sum.z, gain, v_sat));
      o[3] = from_f<T>(saturate(sum.w, gain, v_sat));
    } else {
      for (int j = 0; j < 4 && n + j < N; ++j) {
        float sum = __ldcg(p + j);
        for (int s = 1; s < splits; ++s) sum += __ldcg(p + s * stride + j);
        out[(long long)m * N + n + j] = from_f<T>(saturate(sum, gain, v_sat));
      }
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// The launch plan of one call: tile shape, grid and split of K.
struct Plan {
  int cfg;           // 0: 128 x 128, 1: 64 x 64, 2: 16 x 128
  int bm, bn, tiles_m, tiles_n, splits, chunk;
};

Plan plan(int B, int K, int N) {
  Plan p;
  auto set = [&](int cfg, int bm, int bn) {
    p.cfg = cfg; p.bm = bm; p.bn = bn;
    p.tiles_m = (B + bm - 1) / bm;
    p.tiles_n = (N + bn - 1) / bn;
  };
  if (B <= 16) set(2, 16, 128);
  else {             // the wider tile where it still gives each SM a block
    set(0, 128, 128);
    if (p.tiles_m * p.tiles_n < SMS) set(1, 64, 64);
  }
  const int tiles = p.tiles_m * p.tiles_n;
  const int nk = max(1, (K + BK - 1) / BK);
  int splits = 1;
  if (tiles < SMS)   // about two blocks per SM, at least 4 K steps each
    splits = max(1, min(min((2 * SMS + tiles - 1) / tiles, nk / 4), MAX_SPLITS));
  const int steps = (nk + splits - 1) / splits;
  p.chunk = steps * BK;
  p.splits = (nk + steps - 1) / steps;
  return p;
}

template <typename T, int BM, int BN, int WM, int WN>
int launch_cfg(const Plan& p, const void* v, const void* g, void* out, int B,
               int K, int N, float v_th, float beta, float gain, float v_sat,
               void* partial, void* counters, cudaStream_t s) {
  using L = Tile<T, BM, BN, WM, WN>;
  auto kernel = xbar_mac_kernel<T, BM, BN, WM, WN>;
  static unsigned configured = 0;
  cudaError_t err = sm90::configure_smem(kernel, (int)L::SMEM, configured);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const int vec = aligned && (K * sizeof(T)) % 16 == 0 && (N * sizeof(T)) % 16 == 0;
  const dim3 grid((unsigned)p.tiles_n, (unsigned)p.tiles_m, (unsigned)p.splits);
  kernel<<<grid, L::THREADS, L::SMEM, s>>>(
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(out),
      B, K, N, p.chunk, v_th, beta, gain, v_sat, vec, static_cast<int*>(counters),
      static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* v, const void* g, void* out, int B, int K, int N,
           float v_th, float beta, float gain, float v_sat, void* partial,
           void* counters, cudaStream_t s) {
  const Plan p = plan(B, K, N);
  if (p.splits > 1 && (partial == nullptr || counters == nullptr)) return -1;
  // the 128 x 128 tile's warps: 32 x 64 each in bf16, 64 x 32 in fp32
  // (whose 3xTF32 fragments favour fewer A rows per warp)
  constexpr int WM = sizeof(T) == 2 ? 4 : 2;
  if (p.cfg == 0)
    return launch_cfg<T, 128, 128, WM, 8 / WM>(p, v, g, out, B, K, N, v_th, beta,
                                               gain, v_sat, partial, counters, s);
  if (p.cfg == 1)
    return launch_cfg<T, 64, 64, 2, 2>(p, v, g, out, B, K, N, v_th, beta, gain,
                                       v_sat, partial, counters, s);
  return launch_cfg<T, 16, 128, 1, 4>(p, v, g, out, B, K, N, v_th, beta, gain,
                                      v_sat, partial, counters, s);
}

}  // namespace

// The launch plan at this shape: {tile rows, tile cols, tiles along B,
// tiles along N, splits of K, K per split}.
extern "C" void xbar_mac_plan(int B, int K, int N, int* out6) {
  const Plan p = plan(B, K, N);
  const int vals[6] = {p.bm, p.bn, p.tiles_m, p.tiles_n, p.splits, p.chunk};
  for (int i = 0; i < 6; ++i) out6[i] = vals[i];
}

// dtype 0: fp32, 1: bf16 (v, g and out alike).  Where K is split
// (xbar_mac_plan): partial, splits * B * N floats, and counters, one int
// per output tile, all 0 (the kernel leaves them 0 again); both may be
// null otherwise.  Returns the launch's cudaError_t (0 = launched); -1 for an
// unknown dtype or a missing workspace.
extern "C" int xbar_mac(int dtype, const void* v, const void* g, void* out,
                        int B, int K, int N, float v_th, float beta,
                        float gain, float v_sat, void* partial, void* counters,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(v, g, out, B, K, N, v_th, beta, gain, v_sat, partial,
                         counters, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(v, g, out, B, K, N, v_th, beta, gain, v_sat,
                                 partial, counters, s);
  return -1;
}
