// Fused count + candidate-band extraction for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fused_select.py::fused_select
// (_fused_kernel) and ::fused_select_multi (_fused_multi_kernel).  For every
// shard p of a (P, n_i) batch and every pivot q it computes
//   counts[p][q] = (#x < pivot, #x == pivot, n_i - lt - eq)          int32
//   below[p][q]  = the cap largest values < pivot, descending, low-sentinel pad
//   above[p][q]  = the cap smallest values > pivot, ascending, high-sentinel pad
// with the bands ordered by the total order of lax.top_k (+0.0 above -0.0).
//
// What bounds it: reading the shards.  At the main path's shape (120 x 2^23
// f32, 4.03 GB) one read takes 1.2 ms at 3.35 TB/s; the bands written are
// Q * 2 * P * cap values (97 MB per pivot at cap = 100,666).  The TPU kernel
// keeps a running top_k of the bands in VMEM; a cap of ~10^5 values does not
// fit in 227 KB of shared memory, so this design replaces the running merge
// with a threshold, and sorts each band's keys where they were compacted:
//   pass 1  (hist_kernel)      one read: per shard one 2048-bin shared-memory
//                              histogram of the top 11 bits of the canonical
//                              key (-0.0 folded onto +0.0, so bins order as
//                              IEEE `<` does), one atomic an element for any
//                              number of pivots; an element's side of a pivot
//                              is decided by its bin unless it shares the
//                              pivot's bin, and only those are compared, into
//                              exact in-bin lt/eq counts in each thread's own
//                              shared-memory slots;
//   scan    (threshold_kernel) per (shard, pivot, side) the bin at which the
//                              count from the pivot outward reaches cap, and
//                              the counts;
//   pass 2  (compact_kernel)   one read: every element on a pivot's side (by
//                              IEEE `<`/`>`) at or beyond that bin is
//                              appended to its band's row of a packed scratch
//                              buffer (rows sized exactly by the scan)
//                              through block-aggregated cursors;
//   trim    (trim_kernel)      common.cuh: a histogram of the next key bits
//                              of the threshold bin finds how much of it each
//                              overfull band keeps, and moves the kept keys
//                              to the front of the band's row;
//   sort    (run_sort)         common.cuh: each run of 128 KB of kept keys
//                              sorted in shared memory, in place; a band of
//                              one run straight into the output;
//   merge   (merge_pass)       common.cuh: runs merged two by two by merge
//                              path, ping-ponging between the scratch rows
//                              and a second buffer; a band's last pass writes
//                              its first cap keys as values, sentinel padded.
// Rows and output hold the total-order key (the below side ~key, so that
// every row ascends from the pivot outward); bins and the trim use the
// canonical key.  Two full reads of the data.  On heavy ties the threshold
// bin can hold the whole shard: slower, still exact.  All offsets into the
// data and the scratch are 64-bit.  Each pass over the data launches one
// wave: as many blocks as the card holds at once.
#include "common.cuh"

namespace {

constexpr int BIN_BITS = 11;
constexpr int NB = 1 << BIN_BITS;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

// The bin of a raw value: the top BIN_BITS bits of its canonical key, so that
// bins order as IEEE `<` does and +-0.0 share one.
template <class Tr>
__device__ __forceinline__ int cbin(typename Tr::Raw r) {
  return int(canon<Tr>(Tr::key(r)) >> (Tr::BITS - BIN_BITS));
}

// ---------------------------------------------------------------------------
// pass 1: one canonical-key histogram per shard, exact counts in pivot bins
// ---------------------------------------------------------------------------

// An element's side of pivot q follows from its bin unless the two share a
// bin.  A byte per bin marks the pivots it holds; only an element in such a
// bin is compared, into lt and eq counts of its own thread in shared memory
// (no atomics: a thread's counts are its own slots).  NaN lies on no side of
// any pivot and is not counted.
template <class Tr, int MAXQ>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const typename Tr::Raw* __restrict__ x, int64_t n_i, int64_t n_total,
            const typename Tr::Raw* __restrict__ pivots, int Q, int64_t chunk,
            int* __restrict__ g_hist, int* __restrict__ g_pin) {
  using Raw = typename Tr::Raw;
  using Val = typename Tr::Val;
  using V = Vec<Raw>;
  __shared__ int s_hist[NB];
  __shared__ int s_in[2 * MAXQ][THREADS];        // each thread's in-bin lt, eq per pivot
  __shared__ Val s_pv[MAXQ];
  __shared__ unsigned char s_pmask[NB];          // bit q: pivot q's bin
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < NB; i += THREADS) {
    s_hist[i] = 0;
    s_pmask[i] = 0;
  }
#pragma unroll
  for (int q = 0; q < 2 * MAXQ; ++q) s_in[q][threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < Q; ++q) {
      s_pv[q] = Tr::val(pivots[q]);
      s_pmask[cbin<Tr>(pivots[q])] |= 1u << q;
    }
  }
  __syncthreads();

  const int64_t row = int64_t(p) * n_i;
  const int64_t lo = row + int64_t(blockIdx.x) * chunk;
  const int64_t hi = (row + n_i < lo + chunk) ? row + n_i : lo + chunk;
  if (lo < hi) {
    const int64_t v0 = lo / V::N, v1 = (hi + V::N - 1) / V::N;
    for (int64_t base = v0 + threadIdx.x; base < v1; base += int64_t(THREADS) * UNROLL) {
      V vec[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = base + int64_t(u) * THREADS;
        if (v < v1) vec[u].load(x, v, n_total);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = base + int64_t(u) * THREADS;
        if (v >= v1) continue;
        const int64_t g0 = v * V::N;
        const bool whole = g0 >= lo && g0 + V::N <= hi;
#pragma unroll
        for (int e = 0; e < V::N; ++e) {
          if (!whole && (g0 + e < lo || g0 + e >= hi)) continue;
          const Raw r = vec[u].r[e];
          const Val val = Tr::val(r);
          if (is_nan<Tr>(val)) continue;
          const int b = cbin<Tr>(r);
          atomicAdd(&s_hist[b], 1);
          for (unsigned m = s_pmask[b]; m; m &= m - 1) {
            const int q = __ffs(m) - 1;
            const Val pq = s_pv[q];
            s_in[2 * q][threadIdx.x] += val < pq;
            s_in[2 * q + 1][threadIdx.x] += val == pq;
          }
        }
      }
    }
  }
  __syncthreads();

  // warp w sums rows w, w + 8, ... of the per-thread counts
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < 2 * Q; i += THREADS / 32) {
    int c = 0;
    for (int t = lane; t < THREADS; t += 32) c += s_in[i][t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if (lane == 0 && c) atomicAdd(&g_pin[int64_t(p) * 2 * Q + i], c);
  }
  int* h = g_hist + int64_t(p) * NB;
  for (int i = threadIdx.x; i < NB; i += THREADS) {
    const int c = s_hist[i];
    if (c) atomicAdd(&h[i], c);
  }
}

// ---------------------------------------------------------------------------
// threshold scan: one warp per (shard, pivot, side)
// ---------------------------------------------------------------------------

// Row r = (p * Q + q) * 2 + side.  Counted outward from the pivot, position 0
// is the pivot's own bin (its elements on this side), position j the bin j
// steps away.  A NaN pivot has no element on either side.
template <class Tr>
__global__ void __launch_bounds__(32)
threshold_kernel(const int* __restrict__ g_hist, const int* __restrict__ g_pin,
                 const typename Tr::Raw* __restrict__ pivots, int Q, int64_t n_i, int cap,
                 int* __restrict__ thr, int* __restrict__ cand, int* __restrict__ thrcnt,
                 int* __restrict__ counts) {
  constexpr int PER_LANE = NB / 32;
  const int64_t r = blockIdx.x;
  const int side = int(r & 1);
  const int64_t pq = r >> 1;
  const int64_t p = pq / Q;
  const int lane = threadIdx.x;
  const typename Tr::Raw piv = pivots[pq % Q];
  const bool none = is_nan<Tr>(Tr::val(piv));
  const int pb = cbin<Tr>(piv);
  const int* h = g_hist + p * NB;
  const int* pin = g_pin + pq * 2;                // in-bin lt, eq
  const int len = side == 0 ? pb + 1 : NB - pb;
  auto bin_at = [side, pb](int j) { return side == 0 ? pb - j : pb + j; };
  auto count_at = [&](int j) {
    if (none) return 0;
    if (j) return h[bin_at(j)];
    return side == 0 ? pin[0] : h[pb] - pin[0] - pin[1];
  };

  int sum = 0;
  for (int j = lane * PER_LANE; j < (lane + 1) * PER_LANE && j < len; ++j) sum += count_at(j);
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  const unsigned hit = __ballot_sync(0xFFFFFFFFu, incl >= cap);
  int J = len - 1, c = total;
  if (hit) {
    const int owner = __ffs(hit) - 1;
    int jj = 0, cc = 0;
    if (lane == owner) {
      int run = incl - sum;
      for (int j = lane * PER_LANE; j < (lane + 1) * PER_LANE && j < len; ++j) {
        run += count_at(j);
        if (run >= cap) { jj = j; cc = run; break; }
      }
    }
    J = __shfl_sync(0xFFFFFFFFu, jj, owner);
    c = __shfl_sync(0xFFFFFFFFu, cc, owner);
  }
  if (lane == 0) {
    thr[r] = bin_at(J);
    cand[r] = c;
    thrcnt[r] = count_at(J);
    if (side == 0) {
      const int e = none ? 0 : pin[1];
      counts[pq * 3 + 0] = total;
      counts[pq * 3 + 1] = e;
      counts[pq * 3 + 2] = int(n_i - total - e);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: append each band's candidates to its scratch row
// ---------------------------------------------------------------------------

template <class Tr, int MAXQ>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const typename Tr::Raw* __restrict__ x, int64_t n_i, int64_t n_total,
               const typename Tr::Raw* __restrict__ pivots, int Q, int64_t chunk,
               const int* __restrict__ thr, const int64_t* __restrict__ off,
               int* __restrict__ cursor, typename Tr::Key* __restrict__ buf) {
  using Raw = typename Tr::Raw;
  using Key = typename Tr::Key;
  using V = Vec<Raw>;
  __shared__ int s_cnt[2 * MAXQ], s_pos[2 * MAXQ];
  __shared__ int64_t s_base[2 * MAXQ];
  const int p = blockIdx.y;
  typename Tr::Val pv[MAXQ];
  int tb[MAXQ], ta[MAXQ];
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) {
    const int qq = q < Q ? q : 0;
    pv[q] = Tr::val(pivots[qq]);
    tb[q] = thr[(p * Q + qq) * 2 + 0];
    ta[q] = thr[(p * Q + qq) * 2 + 1];
  }
  if (threadIdx.x < 2 * MAXQ) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const int64_t row = int64_t(p) * n_i;
  const int64_t lo = row + int64_t(blockIdx.x) * chunk;
  const int64_t hi = (row + n_i < lo + chunk) ? row + n_i : lo + chunk;
  const int64_t v0 = lo < hi ? lo / V::N : 0;
  const int64_t v1 = lo < hi ? (hi + V::N - 1) / V::N : 0;

  constexpr int64_t STEP = int64_t(THREADS) * UNROLL;
  // bands per element: bit 2q below pivot q, bit 2q+1 above it; fields of
  // a power-of-two width never straddle two words
  constexpr int MASK_BITS = 2 * MAXQ;
  constexpr int MASK_WORDS = (UNROLL * V::N * MASK_BITS + 31) / 32;
  V vec[UNROLL], next[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t v = v0 + threadIdx.x + int64_t(u) * THREADS;
    if (v < v1) next[u].load(x, v, n_total);
  }
  // every thread runs the same number of rounds: the loop holds barriers
  for (int64_t round = v0; round < v1; round += STEP) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) vec[u] = next[u];
    // the next round's loads fly while this round counts and writes
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = round + STEP + threadIdx.x + int64_t(u) * THREADS;
      if (v < v1) next[u].load(x, v, n_total);
    }
    // phase A: count this round's matches per band in shared memory and
    // keep each element's bands as a 2*MAXQ-bit mask
    unsigned mask[MASK_WORDS];
#pragma unroll
    for (int w = 0; w < MASK_WORDS; ++w) mask[w] = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = round + threadIdx.x + int64_t(u) * THREADS;
      if (v >= v1) continue;
      const int64_t g0 = v * V::N;
      const bool whole = g0 >= lo && g0 + V::N <= hi;
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        if (!whole && (g0 + e < lo || g0 + e >= hi)) continue;
        const Raw r = vec[u].r[e];
        const typename Tr::Val val = Tr::val(r);
        const int bin = cbin<Tr>(r);
        unsigned m = 0;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          if (q >= Q) break;
          if (val < pv[q]) { if (bin >= tb[q]) m |= 1u << (2 * q); }
          else if (val > pv[q]) { if (bin <= ta[q]) m |= 2u << (2 * q); }
        }
        if (m) {
          for (unsigned b = m; b; b &= b - 1) atomicAdd(&s_cnt[__ffs(b) - 1], 1);
          const int idx = (u * V::N + e) * MASK_BITS;
          mask[idx / 32] |= m << (idx % 32);
        }
      }
    }
    __syncthreads();
    // phase B: one device-memory atomic per band reserves the round's slots
    if (threadIdx.x < 2 * Q) {
      const int c = s_cnt[threadIdx.x];
      const int r = p * 2 * Q + threadIdx.x;
      s_base[threadIdx.x] = c ? off[r] + atomicAdd(&cursor[r], c) : 0;
      s_cnt[threadIdx.x] = 0;
      s_pos[threadIdx.x] = 0;
    }
    __syncthreads();
    // phase C: write the keys of the matched elements (the below side
    // stores ~key so that every row sorts ascending from the pivot out)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const int idx = (u * V::N + e) * MASK_BITS;
        unsigned m = (mask[idx / 32] >> (idx % 32)) & ((1u << (2 * MAXQ)) - 1u);
        if (!m) continue;
        const Key k = Tr::key(vec[u].r[e]);
        for (; m; m &= m - 1) {
          const int c = __ffs(m) - 1;
          buf[s_base[c] + atomicAdd(&s_pos[c], 1)] = (c & 1) ? k : Key(~k);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Blocks per shard for a pass over the data: as many as the card holds at
// once (one wave, by the kernel's occupancy, asked once per kernel), spread
// over the P shards, none with fewer than 16,384 elements.  A second,
// partial wave would about double the pass.
template <auto kernel>
int wave_blocks(int64_t P, int64_t n_i) {
  static int per_card = 0;
  if (!per_card) {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    per_card = per_sm * sms;
  }
  int64_t b = per_card / P;
  const int64_t most = (n_i + 16383) / 16384;
  if (b > most) b = most;
  if (b > 65535) b = 65535;
  return int(b < 1 ? 1 : b);
}

template <class Tr, int MAXQ>
int count_impl(const void* x, int64_t P, int64_t n_i, const void* pivots, int Q, int cap,
               int* hist, int* pin, int* thr, int* cand, int* thrcnt, int* counts,
               cudaStream_t st) {
  using Raw = typename Tr::Raw;
  const int bps = wave_blocks<hist_kernel<Tr, MAXQ>>(P, n_i);
  const int64_t chunk = (n_i + bps - 1) / bps;
  hist_kernel<Tr, MAXQ><<<dim3(bps, unsigned(P)), THREADS, 0, st>>>(
      static_cast<const Raw*>(x), n_i, P * n_i, static_cast<const Raw*>(pivots), Q, chunk,
      hist, pin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  threshold_kernel<Tr><<<unsigned(P * Q * 2), 32, 0, st>>>(
      hist, pin, static_cast<const Raw*>(pivots), Q, n_i, cap, thr, cand, thrcnt, counts);
  return int(cudaGetLastError());
}

template <class Tr, int MAXQ>
int compact_impl(const void* x, int64_t P, int64_t n_i, const void* pivots, int Q,
                 const int* thr, const int64_t* off, int* cursor, void* buf, cudaStream_t st) {
  using Raw = typename Tr::Raw;
  const int bps = wave_blocks<compact_kernel<Tr, MAXQ>>(P, n_i);
  const int64_t chunk = (n_i + bps - 1) / bps;
  compact_kernel<Tr, MAXQ><<<dim3(bps, unsigned(P)), THREADS, 0, st>>>(
      static_cast<const Raw*>(x), n_i, P * n_i, static_cast<const Raw*>(pivots), Q, chunk,
      thr, off, cursor, static_cast<typename Tr::Key*>(buf));
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float64.  maxq: 1 (fused_select)
// or 8 (fused_select_multi, Q <= 8 pivots per call).  Returns a cudaError_t
// value, 0 on success, -1 for an argument the kernels do not take.
#define FS_DISPATCH(FN, ...)                                                  \
  switch (dtype * 16 + maxq) {                                                \
    case 0 * 16 + 1: return FN<F32, 1>(__VA_ARGS__);                          \
    case 1 * 16 + 1: return FN<BF16, 1>(__VA_ARGS__);                         \
    case 2 * 16 + 1: return FN<I32, 1>(__VA_ARGS__);                          \
    case 3 * 16 + 1: return FN<F64, 1>(__VA_ARGS__);                          \
    case 0 * 16 + 8: return FN<F32, 8>(__VA_ARGS__);                          \
    case 1 * 16 + 8: return FN<BF16, 8>(__VA_ARGS__);                         \
    case 2 * 16 + 8: return FN<I32, 8>(__VA_ARGS__);                          \
    case 3 * 16 + 8: return FN<F64, 8>(__VA_ARGS__);                          \
    default: return kBadArgument;                                             \
  }

// Pass 1 and the scan.  hist: (P, fs_num_bins()) int32 and pin: (P, Q, 2)
// int32 (in-bin lt, eq), both zeroed by the caller; thr, cand, thrcnt:
// (P, Q, 2) int32; counts: (P, Q, 3) int32.
extern "C" int fs_count(int dtype, int maxq, const void* x, long long P, long long n_i,
                        const void* pivots, int Q, int cap, int* hist, int* pin, int* thr,
                        int* cand, int* thrcnt, int* counts, void* stream) {
  if (Q < 1 || Q > maxq || P < 1 || P > 65535 || n_i < 1 || cap < 1) return kBadArgument;
  FS_DISPATCH(count_impl, x, P, n_i, pivots, Q, cap, hist, pin, thr, cand, thrcnt, counts,
              static_cast<cudaStream_t>(stream))
}

// Pass 2.  off: (P*Q*2,) int64 start of each row in buf (rows of cand keys);
// cursor: same shape, int32, zeroed by the caller.
extern "C" int fs_compact(int dtype, int maxq, const void* x, long long P, long long n_i,
                          const void* pivots, int Q, const int* thr, const long long* off,
                          int* cursor, void* buf, void* stream) {
  if (Q < 1 || Q > maxq || P < 1 || P > 65535 || n_i < 1) return kBadArgument;
  FS_DISPATCH(compact_impl, x, P, n_i, pivots, Q, thr,
              reinterpret_cast<const int64_t*>(off), cursor, buf,
              static_cast<cudaStream_t>(stream))
}

// The trim and the band sort: fs_trim, fs_run_sort, fs_merge, fs_expand,
// fs_run_tile, fs_merge_chunk.
BAND_SORT_ENTRY_POINTS(fs, BIN_BITS)

// Histogram bins per shard.
extern "C" int fs_num_bins() { return NB; }
