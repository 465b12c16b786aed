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
// must read a and b once and write h once; nothing is reused.  At the
// memory's latency under load (~0.7 us) the card needs megabytes of loads
// in flight to reach its rate, far more than a thread's registers hold.
//
// What the design does about it: a thread block owns a column of C
// consecutive d of one batch row and walks all of S.  A ring of K stages
// in shared memory, each a tile of R rows x C lanes of a and one of b,
// keeps the loads in flight: the producer warp fills a stage as soon as
// the consumers release it (its empty mbarrier), and the consumers step
// the rows of a full one (its full mbarrier).
//  - Where every row is 16-byte aligned (D * size a multiple of 16,
//    aligned pointers), one producer thread fills a stage with one tensor
//    copy (cp.async.bulk.tensor, the Tensor Memory Accelerator) per
//    array: a box of R x C from a (B, S, D) tensor map, zeros past S and
//    D, completing on the full barrier with its byte count.  One bulk
//    copy a row instead held a 2,048-step walk to ~0.16 ms whatever its
//    width (an H100 80GB HBM3 at 700 W; the copies ~60 cycles apart).
//  - Elsewhere (an odd pitch such as D = 1001, or a pointer off 16
//    bytes) the producer warp's 32 lanes copy each row of a and of b as
//    the 16-byte chunks that hold it (cp.async through the load path,
//    arriving on the full barrier as they land), and the consumers read
//    past each row's skew within its first chunk.
//  - The consumer warp's threads share the column: each owns V = C / 32
//    consecutive lanes (one where C <= 32), so a narrow column keeps all
//    32 busy (at 16 bytes a thread, RG-LRU's 32-lane bf16 columns left
//    28 idle and the walk's instructions bound it).  Per row a thread
//    reads its V values of a and of b from the stage as one load each,
//    steps V independent fp32 carries, and stores V values of h (one
//    store of V x size bytes where aligned).
//  - b0, when given, is read once before the walk and takes b's place
//    in the first step, which is peeled off the steady loop.
// Each lane's carry steps through S in order, the product and the sum
// rounded apart (no FMA contraction), as the plain version's separate
// multiply and add do: the kernel is bit for bit equal to it and
// deterministic.  C, R and K are the caller's (linear_scan.py:launch_plan
// sizes them from the shape and the card).
#include <cuda.h>            // CUtensorMap and its enums; no -lcuda: see encoder()
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CONSUMERS = 32;          // warp 0: at most C / V of it step lanes
constexpr int THREADS = 2 * CONSUMERS; // warp 1: the producer
constexpr int RING_OFFSET = 128;       // the mbarriers first, the ring after
constexpr int TILE_ALIGN = 128;        // a tensor copy's shared destination

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}
// 16 bytes from global to shared memory through the load path, completing
// with this thread's other cp.async on an mbarrier (cp_async_arrive)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src) : "memory");
}
// one arrival on bar once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem(bar)) : "memory");
}
// the 16-byte chunks that hold n values of T from p: their bytes, and
// where the values start within them
template <typename T>
__device__ __forceinline__ unsigned chunks(const T* p, int n) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15);
  return (unsigned)(((reinterpret_cast<uintptr_t>(p + n) + 15) & ~uintptr_t(15)) - lo);
}
template <typename T> __device__ __forceinline__ int skew(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}
// the box at (d0, s0, bi) of a (B, S, D) tensor map into shared memory;
// elements outside the tensor arrive as zeros and count in the bytes
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map,
                                         int d0, int s0, int bi, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(s0), "r"(bi),
      "r"(smem(bar)) : "memory");
}

// V consecutive values of T (V * size = 2, 4, 8 or 16 bytes) moved as one
// load or store and unpacked to floats; a bf16 is the high half of its
// float, so widening it is a shift.
template <int BYTES> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

template <typename T, int V> struct Lanes {
  using W = typename Word<V * (int)sizeof(T)>::type;
  static constexpr int N = V * (int)sizeof(T) >= 4 ? V * (int)sizeof(T) / 4 : 1;
  static __device__ __forceinline__ void words(W w, uint32_t* u) {
    if constexpr (sizeof(W) == 16) {
      u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
    } else if constexpr (sizeof(W) == 8) {
      u[0] = w.x; u[1] = w.y;
    } else {
      u[0] = w;
    }
  }
  static __device__ __forceinline__ void load(const T* p, float* f) {
    uint32_t u[N];
    words(*reinterpret_cast<const W*>(p), u);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if constexpr (sizeof(T) == 4)
        f[v] = __uint_as_float(u[v]);
      else
        f[v] = __uint_as_float(v % 2 ? u[v / 2] & 0xffff0000u : u[v / 2] << 16);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    uint32_t u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 4) {
        u[i] = __float_as_uint(f[i]);
      } else if constexpr (V == 1) {
        const __nv_bfloat16 x = __float2bfloat16_rn(f[0]);
        u[i] = *reinterpret_cast<const unsigned short*>(&x);
      } else {
        const __nv_bfloat162 x = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&x);
      }
    }
    W w;
    if constexpr (sizeof(W) == 16) {
      w = make_uint4(u[0], u[1], u[2], u[3]);
    } else if constexpr (sizeof(W) == 8) {
      w = make_uint2(u[0], u[1]);
    } else {
      w = static_cast<W>(u[0]);
    }
    *reinterpret_cast<W*>(p) = w;
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One step of a thread's V lanes: h_t = a_t * h_{t-1} + b_t, the product
// and the sum rounded apart, h stored in T (all V at once where aligned,
// else the thread's first `mine` one by one).
template <typename T, int V, bool BULK>
__device__ __forceinline__ void step(float (&carry)[V], const float (&av)[V],
                                     const float (&bv)[V], T* out, int mine) {
#pragma unroll
  for (int v = 0; v < V; ++v)
    carry[v] = __fadd_rn(__fmul_rn(av[v], carry[v]), bv[v]);
  if (BULK) {
    Lanes<T, V>::store(out, carry);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < mine) out[v] = narrow<T>(carry[v]);
  }
}

// A tile row's values: C, and where rows are not 16-byte aligned room for
// the 16-byte chunks that hold them (16 bytes more).  A tile: R rows,
// padded to TILE_ALIGN bytes.
template <typename T> __host__ __device__ __forceinline__ int row_pitch(int C, bool bulk) {
  return bulk ? C : C + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ __forceinline__ int tile_elems(int pitch, int R) {
  const int bytes = R * pitch * (int)sizeof(T);
  return (bytes + TILE_ALIGN - 1) / TILE_ALIGN * TILE_ALIGN / (int)sizeof(T);
}

// A row of a thread's V lanes from a stage: s is the tile row, g the row in
// global memory (its 16-byte skew places the values off the bulk path).
template <typename T, int V, bool BULK>
__device__ __forceinline__ void load_row(const T* s, const T* g, int c0,
                                         int mine, float (&f)[V]) {
  if (BULK) {
    Lanes<T, V>::load(s + c0, f);
  } else {
    const T* p = s + skew(g) + c0;
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = v < mine ? widen(p[v]) : 0.f;
  }
}

// Thread block (bi, j) scans lanes d0 = j*C .. d0+cw-1 of batch row bi,
// V lanes a consumer thread (C = V * min(32, C)).  Shared memory: K full
// and K empty mbarriers, then K stages of [a | b] tiles.  BULK: every row
// is 16-byte aligned, and ma / mb map a / b; else each row arrives as the
// 16-byte chunks that hold it (reading past a row never leaves a chunk
// that holds some of its values, so never reaches another page).
template <typename T, int V, bool BULK>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const __grid_constant__ CUtensorMap ma,
            const __grid_constant__ CUtensorMap mb, const T* __restrict__ a,
            const T* __restrict__ b, const T* __restrict__ b0,
            T* __restrict__ h, int S, int D, int C, int R, int K) {
  extern __shared__ __align__(128) unsigned char shm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(shm);
  uint64_t* empty = full + K;
  T* ring = reinterpret_cast<T*>(shm + RING_OFFSET);
  const int pitch = row_pitch<T>(C, BULK);
  const int tile = tile_elems<T>(pitch, R);

  const int tiles = (D - 1) / C + 1;          // S, D >= 1
  const int bi = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * C;
  const int cw = min(C, D - d0);              // lanes of this column
  const int steppers = (cw + V - 1) / V;      // consumer threads with lanes
  const int stages = (S - 1) / R + 1;
  const long long col = (long long)bi * S * D + d0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < K; ++k) {
      bar_init(&full[k], BULK ? 1 : CONSUMERS);
      bar_init(&empty[k], steppers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                     // ---- the producer
    const int lane = tid - CONSUMERS;
    if (BULK && lane != 0) return;
    for (int i = 0; i < stages; ++i) {
      const int k = i % K;
      if (i >= K) bar_wait(&empty[k], ((i / K) - 1) & 1);
      T* sa = ring + (size_t)k * 2 * tile;
      T* sb = sa + tile;
      if (BULK) {
        bar_expect(&full[k], 2u * R * C * sizeof(T));
        box_copy(sa, &ma, d0, i * R, bi, &full[k]);
        box_copy(sb, &mb, d0, i * R, bi, &full[k]);
      } else {
        // the warp's lanes share the stage's (array, row, chunk) copies
        const int rows = min(R, S - i * R);
        const T* ga = a + col + (long long)i * R * D;
        const T* gb = b + col + (long long)i * R * D;
        const int per = C * (int)sizeof(T) / 16 + 1;   // chunks a row spans
        for (int e = lane; e < 2 * rows * per; e += CONSUMERS) {
          const int q = e % per, r = e / per % rows, x = e / (per * rows);
          const T* p = (x ? gb : ga) + (long long)r * D;
          if (q * 16 < (int)chunks(p, cw))
            cp_async16(reinterpret_cast<char*>((x ? sb : sa) + r * pitch) + q * 16,
                       reinterpret_cast<const char*>(p - skew(p)) + q * 16);
        }
        cp_async_arrive(&full[k]);
      }
    }
    return;
  }

  if (tid >= steppers) return;                // ---- the consumers
  const int c0 = tid * V;                     // this thread's first lane
  const int mine = min(V, cw - c0);           // < V only off the bulk path
  // b's first row: b0's where given, read once before the walk
  float first[V];
  const T* b0p = b0 != nullptr ? b0 + (long long)bi * D + d0 + c0 : nullptr;
  if (b0p != nullptr && BULK) {
    Lanes<T, V>::load(b0p, first);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      first[v] = b0p != nullptr && v < mine ? widen(b0p[v]) : 0.f;
  }
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f;
  T* hp = h + col + c0;
  for (int i = 0; i < stages; ++i) {
    const int k = i % K;
    bar_wait(&full[k], (i / K) & 1);
    const int rows = min(R, S - i * R);
    const T* sa = ring + (size_t)k * 2 * tile;
    const T* sb = sa + tile;
    const T* ga = a + col + (long long)i * R * D;
    const T* gb = b + col + (long long)i * R * D;
    int r = 0;
    if (i == 0) {                             // the sequence's first step
      float av[V], bv[V];
      load_row<T, V, BULK>(sa, ga, c0, mine, av);
      load_row<T, V, BULK>(sb, gb, c0, mine, bv);
      if (b0p != nullptr) {
#pragma unroll
        for (int v = 0; v < V; ++v) bv[v] = first[v];
      }
      step<T, V, BULK>(carry, av, bv, hp, mine);
      r = 1;
    }
#pragma unroll 4
    for (; r < rows; ++r) {
      float av[V], bv[V];
      load_row<T, V, BULK>(sa + r * pitch, ga + (long long)r * D, c0, mine, av);
      load_row<T, V, BULK>(sb + r * pitch, gb + (long long)r * D, c0, mine, bv);
      step<T, V, BULK>(carry, av, bv, hp + ((long long)i * R + r) * D, mine);
    }
    bar_arrive(&empty[k]);
  }
}

template <typename T> size_t ring_bytes(int C, int R, int K, bool bulk) {
  return RING_OFFSET + (size_t)K * 2 * tile_elems<T>(row_pitch<T>(C, bulk), R) * sizeof(T);
}

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// only the runtime, not the driver)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, S, D) tensor at p as boxes of R rows x C lanes of one batch row.
// A map is address arithmetic only, so this host thread's last two stay
// valid for the same address, shape and box (a caller's buffers recur).
template <typename T>
bool tensor_map(CUtensorMap* map, const void* p, int B, int S, int D, int C,
                int R) {
  struct Entry { const void* p; int B, S, D, C, R; CUtensorMap map; };
  static thread_local Entry last[2] = {};
  static thread_local int next = 0;
  for (const Entry& e : last)
    if (e.p == p && e.B == B && e.S == S && e.D == D && e.C == C && e.R == R) {
      *map = e.map;
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)S * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)R, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  last[next] = Entry{p, B, S, D, C, R, *map};
  next ^= 1;
  return true;
}

template <typename T>
int launch(const void* a, const void* b, const void* b0, void* h, int B,
           int S, int D, int C, int R, int K, cudaStream_t s) {
  constexpr int VMAX = 16 / sizeof(T);
  if (C < VMAX || C > CONSUMERS * VMAX || C % VMAX ||
      (C > CONSUMERS && C % CONSUMERS) || R < 1 || R > 256 || K < 2 ||
      2 * K * 8 > RING_OFFSET)
    return -2;
  const int V = C > CONSUMERS ? C / CONSUMERS : 1;
  const long long grid = (long long)B * ((D - 1) / C + 1);
  if (grid >= (1ll << 31)) return -2;
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)h |
                        (uintptr_t)b0;
  const bool bulk = (D * sizeof(T)) % 16 == 0 && any % 16 == 0;
  const size_t bytes = ring_bytes<T>(C, R, K, bulk);
  CUtensorMap ma{}, mb{};
  if (bulk && !(tensor_map<T>(&ma, a, B, S, D, C, R) &&
                tensor_map<T>(&mb, b, B, S, D, C, R)))
    return -3;
  auto run = [&](auto kernel) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, THREADS, bytes, s>>>(
        ma, mb, static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const T*>(b0), static_cast<T*>(h), S, D, C, R, K);
    return (int)cudaGetLastError();
  };
  auto with_v = [&](auto v) {
    constexpr int W = decltype(v)::value;
    return bulk ? run(scan_kernel<T, W, true>) : run(scan_kernel<T, W, false>);
  };
  if (V == 1) return with_v(std::integral_constant<int, 1>{});
  if (V == 2) return with_v(std::integral_constant<int, 2>{});
  if (V == 4) return with_v(std::integral_constant<int, 4>{});
  if constexpr (VMAX == 8)
    if (V == 8) return with_v(std::integral_constant<int, 8>{});
  return -2;
}

}  // namespace

// dtype 0: fp32, 1: bf16 (a, b, b0 and h alike); b0 may be null.  C (a
// multiple of 16 B / size, at most 32 x that, and above 32 a multiple of 32
// giving V = C / 32 = 2, 4 or 8 lanes a thread), 1 <= R <= 256 and
// 2 <= K <= 8: the launch plan.  Returns the launch's cudaError_t (0 = launched); -1 for
// an unknown dtype, -2 for a plan the kernel does not take, -3 where the
// driver gives no tensor map.
extern "C" int linear_scan(int dtype, const void* a, const void* b,
                           const void* b0, void* h, int B, int S, int D,
                           int C, int R, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, b0, h, B, S, D, C, R, K, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, b0, h, B, S, D, C, R, K, s);
  return -1;
}

// Thread blocks of the kernel an SM keeps resident with `bytes` of dynamic
// shared memory (the runtime's occupancy; the bulk instance of dtype).
extern "C" int linear_scan_resident(int dtype, int bytes) {
  int n = -1;
  cudaError_t e;
  if (dtype == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, scan_kernel<float, 4, true>, THREADS, bytes);
  else if (dtype == 1)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, scan_kernel<__nv_bfloat16, 8, true>, THREADS, bytes);
  else
    return -1;
  return e == cudaSuccess ? n : -1;
}
