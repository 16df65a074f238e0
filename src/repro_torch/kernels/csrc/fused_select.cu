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
// with a threshold:
//   pass 1  (hist_kernel)      one read: eq counts, and per (shard, pivot,
//                              side) a 2048-bin shared-memory histogram of
//                              the top 11 bits of the order-preserving key;
//   scan    (threshold_kernel) per (shard, pivot, side) the bin at which the
//                              count from the pivot side reaches cap; lt and
//                              gt are the two histograms' sums;
//   pass 2  (compact_kernel)   one read: every element at or beyond that bin
//                              is appended to its band's row of a scratch
//                              buffer through a block-aggregated cursor;
//   trim    (trim_kernel)      a histogram of the next key bits of the
//                              threshold bin cuts each band to about cap;
//   sort    (bitonic_*)        each row sorted by key: tiles of 8192 keys
//                              in registers, warp shuffles and shared memory,
//                              the wide steps in device memory;
//   emit    (emit_kernel)      the first cap keys of each row back to values,
//                              sentinel padded.
// Two full reads of the data.  On heavy ties the threshold bin can hold the
// whole shard: slower, still exact.  All offsets into the data are 64-bit.
#include "common.cuh"

namespace {

constexpr int BIN_BITS = 11;
constexpr int NB = 1 << BIN_BITS;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <class Tr>
__device__ __forceinline__ int bin_of(typename Tr::Key k) {
  return int(k >> (Tr::BITS - BIN_BITS));
}

// ---------------------------------------------------------------------------
// pass 1: eq counts + per-side key histograms
// ---------------------------------------------------------------------------

template <class Tr, int MAXQ>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const typename Tr::Raw* __restrict__ x, int64_t n_i, int64_t n_total,
            const typename Tr::Raw* __restrict__ pivots, int Q, int64_t chunk,
            int* __restrict__ g_hist, int* __restrict__ g_eq) {
  using Raw = typename Tr::Raw;
  using V = Vec<Raw>;
  extern __shared__ int s_hist[];  // [Q][2][NB]
  __shared__ int s_eq[MAXQ];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < Q * 2 * NB; i += THREADS) s_hist[i] = 0;
  if (threadIdx.x < MAXQ) s_eq[threadIdx.x] = 0;
  typename Tr::Val pv[MAXQ];
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) pv[q] = Tr::val(pivots[q < Q ? q : 0]);
  __syncthreads();

  const int64_t row = int64_t(p) * n_i;
  const int64_t lo = row + int64_t(blockIdx.x) * chunk;
  const int64_t hi = (row + n_i < lo + chunk) ? row + n_i : lo + chunk;
  int eq[MAXQ];
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) eq[q] = 0;

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
          const typename Tr::Val val = Tr::val(r);
          const int bin = bin_of<Tr>(Tr::key(r));
#pragma unroll
          for (int q = 0; q < MAXQ; ++q) {
            if (q >= Q) break;
            if (val < pv[q]) atomicAdd(&s_hist[(2 * q) * NB + bin], 1);
            else if (val > pv[q]) atomicAdd(&s_hist[(2 * q + 1) * NB + bin], 1);
            else if (val == pv[q]) ++eq[q];
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < MAXQ; ++q) {
    int c = eq[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if ((threadIdx.x & 31) == 0 && c && q < Q) atomicAdd(&s_eq[q], c);
  }
  __syncthreads();
  int* h = g_hist + int64_t(p) * Q * 2 * NB;
  for (int i = threadIdx.x; i < Q * 2 * NB; i += THREADS) {
    const int c = s_hist[i];
    if (c) atomicAdd(&h[i], c);
  }
  if (threadIdx.x < Q && s_eq[threadIdx.x]) atomicAdd(&g_eq[p * Q + threadIdx.x], s_eq[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// threshold scan: one warp per (shard, pivot, side)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
threshold_kernel(const int* __restrict__ g_hist, const int* __restrict__ g_eq,
                 int Q, int64_t n_i, int cap, int* __restrict__ thr,
                 int* __restrict__ cand, int* __restrict__ counts,
                 int* __restrict__ max_cand) {
  constexpr int PER_LANE = NB / 32;
  const int seg = blockIdx.x;     // ((p * Q) + q) * 2 + side
  const int side = seg & 1;       // 0: below the pivot, 1: above
  const int lane = threadIdx.x;
  const int* h = g_hist + int64_t(seg) * NB;
  // j counts bins outward from the pivot: descending keys below, ascending above
  auto bin_at = [side](int j) { return side == 0 ? NB - 1 - j : j; };

  int sum = 0;
  for (int j = lane * PER_LANE; j < (lane + 1) * PER_LANE; ++j) sum += h[bin_at(j)];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  const unsigned hit = __ballot_sync(0xFFFFFFFFu, incl >= cap);
  int J = NB - 1, c = total;
  if (hit) {
    const int owner = __ffs(hit) - 1;
    int jj = 0, cc = 0;
    if (lane == owner) {
      int run = incl - sum;
      for (int j = lane * PER_LANE; j < (lane + 1) * PER_LANE; ++j) {
        run += h[bin_at(j)];
        if (run >= cap) { jj = j; cc = run; break; }
      }
    }
    J = __shfl_sync(0xFFFFFFFFu, jj, owner);
    c = __shfl_sync(0xFFFFFFFFu, cc, owner);
  }
  if (lane == 0) {
    thr[seg] = bin_at(J);
    cand[seg] = c;
    atomicMax(max_cand, c);
    if (side == 0) {
      const int pq = seg >> 1;
      const int eq = g_eq[pq];
      counts[pq * 3 + 0] = total;
      counts[pq * 3 + 1] = eq;
      counts[pq * 3 + 2] = int(n_i - total - eq);
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
               const int* __restrict__ thr, int* __restrict__ cursor,
               typename Tr::Key* __restrict__ buf, int64_t L) {
  using Raw = typename Tr::Raw;
  using Key = typename Tr::Key;
  using V = Vec<Raw>;
  __shared__ int s_cnt[2 * MAXQ], s_pos[2 * MAXQ], s_base[2 * MAXQ];
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
  Key* out = buf + int64_t(p) * 2 * Q * L;

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
        const int bin = bin_of<Tr>(Tr::key(r));
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
      s_base[threadIdx.x] = c ? atomicAdd(&cursor[p * 2 * Q + threadIdx.x], c) : 0;
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
          const int pos = s_base[c] + atomicAdd(&s_pos[c], 1);
          out[int64_t(c) * L + pos] = (c & 1) ? k : Key(~k);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// trim: a second histogram level cuts each overfull band down to about cap
// ---------------------------------------------------------------------------

// A row holds cand sort keys (~key below the pivot, key above it: ascending
// means outward from the pivot).  Keys in bins before the threshold bin are
// all kept; of the threshold bin only the sub-bins up to the one where the
// count reaches cap are kept.  The row is compacted in place, the freed tail
// is refilled with all-ones keys, and cand becomes the kept count.
template <class Tr>
__global__ void __launch_bounds__(THREADS)
trim_kernel(typename Tr::Key* __restrict__ buf, int64_t L, const int* __restrict__ hist,
            const int* __restrict__ thr, int* __restrict__ cand, int cap,
            int* __restrict__ max_kept) {
  using Key = typename Tr::Key;
  constexpr int SUB_BITS = Tr::BITS - BIN_BITS < BIN_BITS ? Tr::BITS - BIN_BITS : BIN_BITS;
  constexpr int SUB = 1 << SUB_BITS;
  constexpr int SUB_SHIFT = Tr::BITS - BIN_BITS - SUB_BITS;
  __shared__ int s_hist[SUB];
  __shared__ int s_sub, s_pos;
  const int seg = blockIdx.x;
  const int c = cand[seg];
  if (c <= cap) {                       // nothing beyond cap to drop
    if (threadIdx.x == 0) atomicMax(max_kept, c);
    return;
  }
  const int t = thr[seg];
  const int b1 = (seg & 1) ? t : NB - 1 - t;          // threshold bin, sort-key space
  const int need = cap - (c - hist[int64_t(seg) * NB + t]);   // >= 1
  Key* row = buf + int64_t(seg) * L;
  for (int i = threadIdx.x; i < SUB; i += THREADS) s_hist[i] = 0;
  if (threadIdx.x == 0) s_pos = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += THREADS) {
    const Key k = row[i];
    if (int(k >> (Tr::BITS - BIN_BITS)) == b1)
      atomicAdd(&s_hist[int(k >> SUB_SHIFT) & (SUB - 1)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0, b2 = SUB - 1;
    for (int i = 0; i < SUB; ++i) {
      run += s_hist[i];
      if (run >= need) { b2 = i; break; }
    }
    s_sub = b2;
  }
  __syncthreads();
  const int b2 = s_sub;
  // each round reads its keys before any kept key is written: writes land
  // below the kept count so far, never on a key still to be read
  for (int base = 0; base < c; base += THREADS) {
    const int i = base + threadIdx.x;
    Key k = 0;
    bool keep = false;
    if (i < c) {
      k = row[i];
      const int hb = int(k >> (Tr::BITS - BIN_BITS));
      keep = hb < b1 || (hb == b1 && (int(k >> SUB_SHIFT) & (SUB - 1)) <= b2);
    }
    __syncthreads();
    if (keep) row[atomicAdd(&s_pos, 1)] = k;
    __syncthreads();
  }
  const int kept = s_pos;
  for (int i = kept + threadIdx.x; i < c; i += THREADS) row[i] = Key(~Key(0));
  if (threadIdx.x == 0) {
    cand[seg] = kept;
    atomicMax(max_kept, kept);
  }
}

// ---------------------------------------------------------------------------
// emit: first cap keys of each row back to values, sentinel padded
// ---------------------------------------------------------------------------

template <class Tr>
__global__ void emit_kernel(const typename Tr::Key* __restrict__ buf, int64_t L,
                            const int* __restrict__ cand, int64_t segs, int64_t cap,
                            typename Tr::Raw* __restrict__ below,
                            typename Tr::Raw* __restrict__ above) {
  using Key = typename Tr::Key;
  const int64_t total = segs * cap;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += int64_t(gridDim.x) * blockDim.x) {
    const int64_t seg = t / cap, i = t % cap;
    const int side = int(seg & 1);
    typename Tr::Raw v;
    if (i < cand[seg]) {
      Key k = buf[seg * L + i];
      if (side == 0) k = Key(~k);
      v = Tr::raw(k);
    } else {
      v = side == 0 ? typename Tr::Raw(Tr::LO) : typename Tr::Raw(Tr::HI);
    }
    (side == 0 ? below : above)[(seg >> 1) * cap + i] = v;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------


template <class Tr, int MAXQ>
int count_impl(const void* x, int64_t P, int64_t n_i, const void* pivots, int Q,
               int cap, int bps, int* hist, int* eq, int* thr, int* cand,
               int* counts, int* max_cand, cudaStream_t st) {
  using Raw = typename Tr::Raw;
  const int64_t chunk = (n_i + bps - 1) / bps;
  const size_t smem = size_t(Q) * 2 * NB * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(hist_kernel<Tr, MAXQ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  hist_kernel<Tr, MAXQ><<<dim3(bps, unsigned(P)), THREADS, smem, st>>>(
      static_cast<const Raw*>(x), n_i, P * n_i, static_cast<const Raw*>(pivots), Q,
      chunk, hist, eq);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  threshold_kernel<<<unsigned(P * Q * 2), 32, 0, st>>>(hist, eq, Q, n_i, cap, thr, cand,
                                                       counts, max_cand);
  return int(cudaGetLastError());
}

template <class Tr, int MAXQ>
int compact_impl(const void* x, int64_t P, int64_t n_i, const void* pivots, int Q,
                 int cap, int bps, const int* hist, const int* thr, int* cand,
                 int* cursor, void* buf_v, int64_t L, int trim, int* max_kept,
                 cudaStream_t st) {
  using Raw = typename Tr::Raw;
  using Key = typename Tr::Key;
  Key* buf = static_cast<Key*>(buf_v);
  const int64_t chunk = (n_i + bps - 1) / bps;
  compact_kernel<Tr, MAXQ><<<dim3(bps, unsigned(P)), THREADS, 0, st>>>(
      static_cast<const Raw*>(x), n_i, P * n_i, static_cast<const Raw*>(pivots), Q,
      chunk, thr, cursor, buf, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !trim) return int(e);
  trim_kernel<Tr><<<unsigned(P * Q * 2), THREADS, 0, st>>>(buf, L, hist, thr, cand, cap,
                                                           max_kept);
  return int(cudaGetLastError());
}

template <class Tr, int MAXQ>
int sort_emit_impl(int64_t rows, const int* cand, void* buf_v, int64_t L, int64_t len,
                   int64_t cap, void* below, void* above, cudaStream_t st) {
  using Raw = typename Tr::Raw;
  using Key = typename Tr::Key;
  Key* buf = static_cast<Key*>(buf_v);
  const int e = sort_rows<Key>(buf, rows, L, len, st);
  if (e) return e;

  emit_kernel<Tr><<<grid_for(rows * cap, 256), 256, 0, st>>>(
      buf, L, cand, rows, cap, static_cast<Raw*>(below), static_cast<Raw*>(above));
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

extern "C" int fs_count(int dtype, int maxq, const void* x, long long P, long long n_i,
                        const void* pivots, int Q, int cap, int bps, int* hist, int* eq,
                        int* thr, int* cand, int* counts, int* max_cand, void* stream) {
  if (Q < 1 || Q > maxq || P < 1 || P > 65535 || n_i < 1 || cap < 1 || bps < 1 ||
      bps > 65535)
    return kBadArgument;
  FS_DISPATCH(count_impl, x, P, n_i, pivots, Q, cap, bps, hist, eq, thr, cand, counts,
              max_cand, static_cast<cudaStream_t>(stream))
}

// trim != 0 also runs trim_kernel, which leaves the widest kept band in
// max_kept.
extern "C" int fs_compact(int dtype, int maxq, const void* x, long long P, long long n_i,
                          const void* pivots, int Q, int cap, int bps, const int* hist,
                          const int* thr, int* cand, int* cursor, void* buf, long long L,
                          int trim, int* max_kept, void* stream) {
  if (Q < 1 || Q > maxq || P < 1 || P > 65535 || n_i < 1 || cap < 1 || bps < 1 ||
      bps > 65535 || L < SORT_TILE || (L & (L - 1)))
    return kBadArgument;
  FS_DISPATCH(compact_impl, x, P, n_i, pivots, Q, cap, bps, hist, thr, cand, cursor, buf,
              L, trim, max_kept, static_cast<cudaStream_t>(stream))
}

// Sorts the first `len` keys of every row (len a power of two, SORT_TILE <=
// len <= L) and emits the bands.
extern "C" int fs_sort_emit(int dtype, int maxq, long long rows, const int* cand, void* buf,
                            long long L, long long len, long long cap, void* below,
                            void* above, void* stream) {
  if (rows < 1 || cap < 1 || len < SORT_TILE || len > L || (len & (len - 1)))
    return kBadArgument;
  FS_DISPATCH(sort_emit_impl, rows, cand, buf, L, len, cap, below, above,
              static_cast<cudaStream_t>(stream))
}

// Layout the caller allocates for: histogram bins per (shard, pivot, side),
// and the least width of a scratch row (rows are a power of two this wide
// or wider).
extern "C" int fs_num_bins() { return NB; }
extern "C" int fs_sort_tile() { return SORT_TILE; }
