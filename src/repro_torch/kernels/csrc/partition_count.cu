// 3-way partition counts for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/partition_count.py::partition_count
// (_count3_kernel): the int32 (lt, eq, gt) counts of a flat array against one
// pivot, the paper's firstPass.  Two domains:
//   values    IEEE <, == on the data's own type (f32, bf16, int32, f64), so
//             -0.0 == +0.0 counts as eq;
//   sortable  JAX's to_sortable_u32 key of each element (f32, bf16 through
//             f32, int32; uint32 data as it is) against a uint32 pivot,
//             compared unsigned: the counting pass of the 32-step bitwise
//             radix search, which forms the key from x itself and so needs no
//             transformed copy of the data.
//
// What bounds it: reading the data once (4.03 GB at the main path's 120 x 2^23
// f32 is 1.2 ms at 3.35 TB/s); 2-3 operations an element.  The TPU kernel
// walks its grid in order and carries the counts in SMEM; here a parallel
// grid of blocks strides over 16-byte vectors, each thread counts in
// registers, and each block adds its three counts to the output with one
// atomic each (block_add).  The caller zeroes the output.
//
// bs_step advances the bitwise search on the device, so the 32 passes need
// no host sync: state = (lo, hi, mid) as uint32, and after the count of
// `mid` it sets hi = mid when count(u <= mid) >= k, else lo = mid + 1, then
// mid = lo + (hi - lo) / 2 (JAX's uint32 arithmetic, wrap included).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <class Tr>
struct ByValue {
  using Raw = typename Tr::Raw;
  using T = typename Tr::Val;
  __device__ static T of(Raw r) { return Tr::val(r); }
  __device__ static T pivot(const void* p) { return Tr::val(*static_cast<const Raw*>(p)); }
};

template <class Tr>
struct BySortable {
  using Raw = typename Tr::Raw;
  using T = uint32_t;
  __device__ static T of(Raw r) { return sortable_u32<Tr>(r); }
  __device__ static T pivot(const void* p) { return *static_cast<const uint32_t*>(p); }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
count3_kernel(const typename Op::Raw* __restrict__ x, int64_t n,
              const void* __restrict__ pivot, int* __restrict__ counts) {
  using V = Vec<typename Op::Raw>;
  const typename Op::T p = Op::pivot(pivot);
  const int64_t nvec = (n + V::N - 1) / V::N;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  int lt = 0, eq = 0, nv = 0;
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
        const typename Op::T t = Op::of(vec[u].r[e]);
        lt += t < p;
        eq += t == p;
      }
      nv += m;
    }
  }
  int c[3] = {lt, eq, nv - lt - eq};
  block_add<3, THREADS>(c, counts);
}

template <class Op>
int count_impl(const void* x, int64_t n, const void* pivot, int* counts, int blocks,
               cudaStream_t st) {
  count3_kernel<Op><<<blocks, THREADS, 0, st>>>(
      static_cast<const typename Op::Raw*>(x), n, pivot, counts);
  return int(cudaGetLastError());
}

__global__ void bisect_step_kernel(const int* __restrict__ counts, const int* __restrict__ k,
                                   uint32_t* __restrict__ state) {
  const int le = counts[0] + counts[1];
  uint32_t lo = state[0], hi = state[1];
  const uint32_t mid = state[2];
  if (le >= *k) hi = mid;
  else lo = mid + 1u;
  state[0] = lo;
  state[1] = hi;
  state[2] = lo + (hi - lo) / 2u;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float64, 4 uint32.  sortable: 0
// compares values (pivot of x's type), 1 compares to_sortable_u32 keys with
// a uint32 pivot (uint32 data always does).  counts: 3 int32, zeroed by the
// caller.  Returns a cudaError_t value, -1 for an argument refused.
extern "C" int pc_count(int dtype, int sortable, const void* x, long long n,
                        const void* pivot, int* counts, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return kBadArgument;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 4) return count_impl<BySortable<U32>>(x, n, pivot, counts, blocks, st);
  switch (dtype * 2 + (sortable ? 1 : 0)) {
    case 0: return count_impl<ByValue<F32>>(x, n, pivot, counts, blocks, st);
    case 1: return count_impl<BySortable<F32>>(x, n, pivot, counts, blocks, st);
    case 2: return count_impl<ByValue<BF16>>(x, n, pivot, counts, blocks, st);
    case 3: return count_impl<BySortable<BF16>>(x, n, pivot, counts, blocks, st);
    case 4: return count_impl<ByValue<I32>>(x, n, pivot, counts, blocks, st);
    case 5: return count_impl<BySortable<I32>>(x, n, pivot, counts, blocks, st);
    case 6: return count_impl<ByValue<F64>>(x, n, pivot, counts, blocks, st);
    default: return kBadArgument;
  }
}

// One step of the bitwise search: counts of the last pass, k (int32), state
// (lo, hi, mid) as uint32, all on the device.
extern "C" int pc_bisect_step(const int* counts, const int* k, void* state, void* stream) {
  bisect_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, k, static_cast<uint32_t*>(state));
  return int(cudaGetLastError());
}
