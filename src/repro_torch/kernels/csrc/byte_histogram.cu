// 256-bin byte histogram for Hopper (sm_90a), the radix-select primitive.
//
// Replaces the TPU kernel src/repro/kernels/fused_select.py::byte_histogram
// (_byte_histogram_kernel): over the elements u of a flat array in JAX's
// sortable-uint32 domain with (u & mask) == prefix, the int32 histogram of
// the byte (u >> shift) & 0xFF.  The kernel forms u from the data itself
// (to_sortable_u32 of f32, bf16 through f32, int32; uint32 data as it is), so
// the 4-pass radix select reads x four times and never writes a u copy.
//
// What bounds it: reading the data once (1.2 ms for 4.03 GB at 3.35 TB/s).
// The TPU kernel one-hot-compares each byte against a 256-lane iota.  Here
// each warp of a block keeps its own 256-bin histogram in shared memory (so
// that a few hot bins, as the top byte of real data has, contend within one
// warp only), the block sums its warps' bins and adds each non-zero bin to
// the output with one atomic.  The caller zeroes the output.
//
// bh_radix_step walks one pass's histogram on the device, as
// ops.radix_select_kth does: byte = the first bin whose running count
// reaches k (bin 0 when none does), k -= the count below that bin,
// prefix |= byte << shift, mask |= 0xFF << shift.  The four passes need no
// host sync.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int BINS = 256;

template <class Tr>
__global__ void __launch_bounds__(THREADS)
byte_hist_kernel(const typename Tr::Raw* __restrict__ x, int64_t n,
                 const uint32_t* __restrict__ params, int shift, int* __restrict__ hist) {
  using V = Vec<typename Tr::Raw>;
  __shared__ int s_hist[WARPS][BINS];
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&s_hist[0][0])[i] = 0;
  const uint32_t prefix = params[0], mask = params[1];
  int* mine = s_hist[threadIdx.x >> 5];
  __syncthreads();

  const int64_t nvec = (n + V::N - 1) / V::N;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  for (int64_t v0 = int64_t(blockIdx.x) * THREADS + threadIdx.x; v0 < nvec;
       v0 += stride * UNROLL) {
    V vec[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) vec[u].load(x, v, n);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = v0 + u * stride;
      if (v >= nvec) continue;
      const int m = (v + 1) * V::N <= n ? V::N : int(n - v * V::N);
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        if (e >= m) break;
        const uint32_t k = sortable_u32<Tr>(vec[u].r[e]);
        if ((k & mask) == prefix) atomicAdd(&mine[(k >> shift) & 0xFFu], 1);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_hist[w][b];
    if (s) atomicAdd(&hist[b], s);
  }
}

template <class Tr>
int hist_impl(const void* x, int64_t n, const uint32_t* params, int shift, int* hist,
              int blocks, cudaStream_t st) {
  byte_hist_kernel<Tr><<<blocks, THREADS, 0, st>>>(
      static_cast<const typename Tr::Raw*>(x), n, params, shift, hist);
  return int(cudaGetLastError());
}

__global__ void radix_step_kernel(const int* __restrict__ hist, int* __restrict__ k,
                                  uint32_t* __restrict__ params, int shift) {
  const int kk = *k;
  int run = 0, byte = 0, below = 0;
  for (int b = 0; b < BINS; ++b) {
    const int prev = run;
    run += hist[b];
    if (run >= kk) {
      byte = b;
      below = prev;
      break;
    }
  }
  *k = kk - below;
  params[0] |= uint32_t(byte) << shift;
  params[1] |= 0xFFu << shift;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32 (keys formed by to_sortable_u32),
// 4 uint32 (already keys).  params: (prefix, mask) as uint32 on the device;
// shift in {0, 8, 16, 24}; hist: 256 int32, zeroed by the caller.  Returns a
// cudaError_t value, -1 for an argument refused.
extern "C" int bh_histogram(int dtype, const void* x, long long n, const void* params,
                            int shift, int* hist, int blocks, void* stream) {
  if (n < 1 || blocks < 1 || shift < 0 || shift > 24 || shift % 8) return kBadArgument;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pr = static_cast<const uint32_t*>(params);
  switch (dtype) {
    case 0: return hist_impl<F32>(x, n, pr, shift, hist, blocks, st);
    case 1: return hist_impl<BF16>(x, n, pr, shift, hist, blocks, st);
    case 2: return hist_impl<I32>(x, n, pr, shift, hist, blocks, st);
    case 4: return hist_impl<U32>(x, n, pr, shift, hist, blocks, st);
    default: return kBadArgument;
  }
}

// One pass's walk: hist (256 int32), k (int32) and params (prefix, mask), all
// on the device; k and params are updated in place.
extern "C" int bh_radix_step(const int* hist, int* k, void* params, int shift, void* stream) {
  if (shift < 0 || shift > 24 || shift % 8) return kBadArgument;
  radix_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, k, static_cast<uint32_t*>(params), shift);
  return int(cudaGetLastError());
}
