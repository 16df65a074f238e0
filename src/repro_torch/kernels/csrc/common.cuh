// Pieces shared by the port's Hopper kernels (included by every csrc/*.cu).
//
//   F32 / BF16 / I32 / F64   raw storage bits, the order-preserving unsigned
//                            key (the total order: -0.0 just below +0.0) and
//                            the value IEEE comparisons run on
//   canon                    the key with -0.0 folded onto +0.0: its order is
//                            the order of IEEE `<` (for data without NaN)
//   sortable_u32             JAX's to_sortable_u32, bf16 through f32
//   Vec                      one 16-byte vector of a flat array, element loads
//                            at the ragged end
//   block_add                per-block counters into device memory, one
//                            atomic per counter and block
//   sort_rows                bitonic sort of every row of a (rows, stride)
//                            key buffer, `len` keys a row (a power of two of
//                            at least SORT_TILE): 8192-key tiles in registers,
//                            warp shuffles and shared memory, wider steps in
//                            device memory
// All offsets into the data are 64-bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SORT_THREADS = 512;
constexpr int KPT = 16;                          // keys each sort thread holds
constexpr int SORT_TILE = SORT_THREADS * KPT;    // keys one block sorts: 8192
constexpr int WARP_SPAN = 32 * KPT;              // keys one warp holds
constexpr int STEP_THREADS = 256;
constexpr int kBadArgument = -1;                 // C entry points: argument refused

// ---------------------------------------------------------------------------
// dtypes: raw storage bits, order-preserving unsigned key, comparison value
// ---------------------------------------------------------------------------

struct F32 {
  using Raw = uint32_t;
  using Key = uint32_t;
  using Val = float;
  static constexpr bool IS_FLOAT = true;
  static constexpr int BITS = 32;
  static constexpr Raw LO = 0xFF800000u;  // -inf
  static constexpr Raw HI = 0x7F800000u;  // +inf
  __device__ static Val val(Raw r) { return __uint_as_float(r); }
  __device__ static Key key(Raw r) { return r ^ ((r >> 31) ? 0xFFFFFFFFu : 0x80000000u); }
  __device__ static Raw raw(Key k) { return k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu); }
};

struct BF16 {
  using Raw = uint16_t;
  using Key = uint16_t;
  using Val = float;
  static constexpr bool IS_FLOAT = true;
  static constexpr int BITS = 16;
  static constexpr Raw LO = 0xFF80u;
  static constexpr Raw HI = 0x7F80u;
  __device__ static Val val(Raw r) { return __uint_as_float(uint32_t(r) << 16); }
  __device__ static Key key(Raw r) { return Key(r ^ ((r >> 15) ? 0xFFFFu : 0x8000u)); }
  __device__ static Raw raw(Key k) { return Raw(k ^ ((k >> 15) ? 0x8000u : 0xFFFFu)); }
};

struct I32 {
  using Raw = uint32_t;
  using Key = uint32_t;
  using Val = int32_t;
  static constexpr bool IS_FLOAT = false;
  static constexpr int BITS = 32;
  static constexpr Raw LO = 0x80000000u;  // INT32_MIN
  static constexpr Raw HI = 0x7FFFFFFFu;  // INT32_MAX
  __device__ static Val val(Raw r) { return int32_t(r); }
  __device__ static Key key(Raw r) { return r ^ 0x80000000u; }
  __device__ static Raw raw(Key k) { return k ^ 0x80000000u; }
};

struct F64 {
  using Raw = unsigned long long;
  using Key = unsigned long long;
  using Val = double;
  static constexpr bool IS_FLOAT = true;
  static constexpr int BITS = 64;
  static constexpr Raw LO = 0xFFF0000000000000ull;
  static constexpr Raw HI = 0x7FF0000000000000ull;
  __device__ static Val val(Raw r) { return __longlong_as_double((long long)r); }
  __device__ static Key key(Raw r) { return r ^ ((r >> 63) ? ~0ull : (1ull << 63)); }
  __device__ static Raw raw(Key k) { return k ^ ((k >> 63) ? (1ull << 63) : ~0ull); }
};


// -0.0's key onto +0.0's; the identity for integers.
template <class Tr>
__device__ __forceinline__ typename Tr::Key canon(typename Tr::Key k) {
  using Key = typename Tr::Key;
  constexpr Key top = Key(Key(1) << (Tr::BITS - 1));
  return (Tr::IS_FLOAT && k == Key(top - 1)) ? top : k;
}

// uint32 input: the sortable domain itself.
struct U32 {
  using Raw = uint32_t;
};

// JAX's to_sortable_u32 (ops.py): the f32 and int32 keys, bf16 through f32,
// uint32 as it is.
template <class Tr>
__device__ __forceinline__ uint32_t sortable_u32(typename Tr::Raw r);
template <>
__device__ __forceinline__ uint32_t sortable_u32<F32>(uint32_t r) { return F32::key(r); }
template <>
__device__ __forceinline__ uint32_t sortable_u32<BF16>(uint16_t r) {
  return F32::key(uint32_t(r) << 16);
}
template <>
__device__ __forceinline__ uint32_t sortable_u32<I32>(uint32_t r) { return I32::key(r); }
template <>
__device__ __forceinline__ uint32_t sortable_u32<U32>(uint32_t r) { return r; }

// Adds every thread's NC counters into out[0 .. NC): warp shuffles, one
// shared-memory slot per warp, one device-memory atomic per counter and block.
template <int NC, int THREADS>
__device__ __forceinline__ void block_add(int (&c)[NC], int* __restrict__ out) {
  __shared__ int part[THREADS / 32][NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c[i] += __shfl_down_sync(0xFFFFFFFFu, c[i], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) part[threadIdx.x >> 5][i] = c[i];
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += part[w][threadIdx.x];
    if (s) atomicAdd(&out[threadIdx.x], s);
  }
}

// One 16-byte vector of the flat array: a single load when it lies wholly
// inside the allocation, element loads at the ragged end.
template <class Raw>
struct Vec {
  static constexpr int N = 16 / sizeof(Raw);
  Raw r[N];
  __device__ __forceinline__ void load(const Raw* __restrict__ x, int64_t v,
                                       int64_t n_total) {
    const int64_t g = v * N;
    if (g + N <= n_total) {
      union { uint4 u; Raw e[N]; } w;
      w.u = __ldg(reinterpret_cast<const uint4*>(x) + v);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = w.e[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = (g + i < n_total) ? x[g + i] : Raw(0);
    }
  }
};

// ---------------------------------------------------------------------------
// bitonic sort of every row of a (rows, L) key buffer, L a power of two
// ---------------------------------------------------------------------------

template <class Key>
__device__ __forceinline__ void cmp_swap(Key* s, int64_t i, int64_t j, bool asc) {
  const Key a = s[i], b = s[i + j];
  if ((a > b) == asc) { s[i] = b; s[i + j] = a; }
}

__device__ __forceinline__ uint16_t shfl_xor(uint16_t v, int m) {
  return uint16_t(__shfl_xor_sync(0xFFFFFFFFu, unsigned(v), m));
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(0xFFFFFFFFu, v, m);
}
__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v, int m) {
  return __shfl_xor_sync(0xFFFFFFFFu, v, m);
}

// Shared-memory slot of tile position i: one pad word per 32 keeps both the
// row-wise copies and the per-thread runs of KPT keys free of bank conflicts.
__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

// Steps j = j_top, j_top/2, ..., 1 of bitonic stage k over one tile.  Thread
// t holds tile positions t*KPT .. t*KPT+KPT-1 in registers: steps j < KPT
// stay in registers, steps j < WARP_SPAN exchange between lanes of a warp,
// wider steps go through shared memory.
template <class Key>
__device__ __forceinline__ void tile_stage(Key (&r)[KPT], Key* s, int64_t tile_off,
                                           int64_t k, int j_top) {
  const int me = threadIdx.x * KPT;
  int j = j_top;
  if (j >= WARP_SPAN) {
#pragma unroll
    for (int q = 0; q < KPT; ++q) s[pad_idx(me + q)] = r[q];
    __syncthreads();
    for (; j >= WARP_SPAN; j >>= 1) {
      for (int t = threadIdx.x; t < SORT_TILE / 2; t += SORT_THREADS) {
        const int i = (t / j) * 2 * j + (t % j);
        const Key a = s[pad_idx(i)], b = s[pad_idx(i + j)];
        if ((a > b) == (((tile_off + i) & k) == 0)) {
          s[pad_idx(i)] = b;
          s[pad_idx(i + j)] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < KPT; ++q) r[q] = s[pad_idx(me + q)];
    __syncthreads();
  }
  for (; j >= KPT; j >>= 1) {
    const int m = j / KPT;                       // partner lane = lane ^ m
    const bool lower = (threadIdx.x & m) == 0;
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const Key o = shfl_xor(r[q], m);
      const bool asc = ((tile_off + me + q) & k) == 0;
      const Key mn = r[q] < o ? r[q] : o, mx = r[q] < o ? o : r[q];
      r[q] = (lower == asc) ? mn : mx;
    }
  }
#pragma unroll
  for (int jj = KPT / 2; jj > 0; jj >>= 1) {
    if (jj > j) continue;
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      if (q & jj) continue;
      const bool asc = ((tile_off + me + q) & k) == 0;
      const Key a = r[q], b = r[q + jj];
      if ((a > b) == asc) { r[q] = b; r[q + jj] = a; }
    }
  }
}

// k_merge == 0: sort every tile (stages k = 2 .. SORT_TILE, each tile in the
// direction its position in the row asks for).  k_merge > 0: finish stage
// k_merge for the steps j < SORT_TILE.  Each row holds `len` keys to sort
// (a power of two, at least SORT_TILE) at a stride of `stride` keys.
template <class Key>
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_tile(Key* __restrict__ buf, int64_t stride, int64_t len, int64_t k_merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s = reinterpret_cast<Key*>(smem);
  const int64_t tiles_per_row = len / SORT_TILE;
  const int64_t tile_off = (blockIdx.x % tiles_per_row) * SORT_TILE;
  const int64_t t0 = (blockIdx.x / tiles_per_row) * stride + tile_off;
#pragma unroll
  for (int c = 0; c < KPT; ++c) {
    const int i = c * SORT_THREADS + threadIdx.x;
    s[pad_idx(i)] = buf[t0 + i];
  }
  __syncthreads();
  Key r[KPT];
#pragma unroll
  for (int q = 0; q < KPT; ++q) r[q] = s[pad_idx(threadIdx.x * KPT + q)];
  __syncthreads();
  if (k_merge == 0) {
    for (int k = 2; k <= SORT_TILE; k <<= 1) tile_stage(r, s, tile_off, k, k >> 1);
  } else {
    tile_stage(r, s, tile_off, k_merge, SORT_TILE >> 1);
  }
#pragma unroll
  for (int q = 0; q < KPT; ++q) s[pad_idx(threadIdx.x * KPT + q)] = r[q];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < KPT; ++c) {
    const int i = c * SORT_THREADS + threadIdx.x;
    buf[t0 + i] = s[pad_idx(i)];
  }
}

template <class Key>
__global__ void __launch_bounds__(STEP_THREADS)
bitonic_step(Key* __restrict__ buf, int64_t rows, int64_t stride, int64_t len,
             int64_t k, int64_t j) {
  const int64_t half = len / 2;
  const int64_t pairs = rows * half;
  for (int64_t t = int64_t(blockIdx.x) * STEP_THREADS + threadIdx.x; t < pairs;
       t += int64_t(gridDim.x) * STEP_THREADS) {
    const int64_t r = t / half, u = t % half;
    const int64_t i = (u / j) * 2 * j + (u % j);
    cmp_swap(buf + r * stride, i, j, (i & k) == 0);
  }
}

inline int grid_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  if (b > 65535LL * 64) b = 65535LL * 64;
  return int(b < 1 ? 1 : b);
}

// Sorts the first `len` keys of every row of a (rows, stride) buffer
// ascending, on stream st.  Returns a cudaError_t value.
template <class Key>
int sort_rows(Key* buf, int64_t rows, int64_t stride, int64_t len, cudaStream_t st) {
  const unsigned tiles = unsigned(rows * len / SORT_TILE);
  const size_t smem = size_t(SORT_TILE + SORT_TILE / 32) * sizeof(Key);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bitonic_tile<Key>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem))) != cudaSuccess)
    return int(e);
  bitonic_tile<Key><<<tiles, SORT_THREADS, smem, st>>>(buf, stride, len, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  for (int64_t k = 2 * int64_t(SORT_TILE); k <= len; k <<= 1) {
    for (int64_t j = k >> 1; j >= SORT_TILE; j >>= 1) {
      bitonic_step<Key><<<grid_for(rows * len / 2, STEP_THREADS), STEP_THREADS, 0, st>>>(
          buf, rows, stride, len, k, j);
      if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    }
    bitonic_tile<Key><<<tiles, SORT_THREADS, smem, st>>>(buf, stride, len, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

}  // namespace
