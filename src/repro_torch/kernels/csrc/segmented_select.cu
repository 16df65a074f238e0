// Segmented count + candidate-band extraction for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segmented_select.py::
// segmented_select (_segmented_kernel).  For every shard p of a (P, n_i)
// batch of values with int32 group keys, and every (group g, level q) of a
// (G, Q) pivot grid, restricted to the elements with key == g (keys outside
// [0, G) belong to no group):
//   counts[p][g][q] = (#x < pivot, #x == pivot, #x > pivot)           int32
//   below[p][g][q]  = the cap largest values < pivot, descending, low-sentinel pad
//   above[p][g][q]  = the cap smallest values > pivot, ascending, high-sentinel pad
// with the bands ordered by the total order of lax.top_k (+0.0 above -0.0).
//
// What bounds it: at the grouped path's shape (120 x 2^23 f32 values and
// int32 keys, G x Q = 32 x 2, cap = 100,666) reading values and keys (8.05 GB,
// 2.4 ms at 3.35 TB/s) and writing the bands (P*G*Q*2*cap values, 6.2 GB).
// The TPU kernel re-scores every tile against all G*Q pivots, so its work
// grows with G.  Here each element looks up its own group and meets only
// that group's Q pivots.  The bands do not fit on chip, so, as in
// fused_select.cu, a threshold replaces the running merge, and each band's
// keys are sorted where they were compacted:
//   pass 1  (hist_kernel)      one read per group slice: per (shard, group)
//                              a 1024-bin shared-memory histogram of the top
//                              10 bits of the canonical key (-0.0 folded onto
//                              +0.0, so bins order as IEEE `<` does), and per
//                              (shard, group, level) exact lt/eq/gt counts of
//                              the elements in the pivot's own bin.  One
//                              histogram serves all Q pivots of a group: an
//                              element's side of a pivot is decided by its
//                              bin unless it shares the pivot's bin.  The
//                              groups whose histograms do not fit in shared
//                              memory at once take further slices (reads);
//   scan    (threshold_kernel) per (shard, group, level, side) the bin at
//                              which the count from the pivot outward reaches
//                              cap, and the counts;
//   pass 2  (compact_kernel)   one read: every element at or beyond its
//                              band's threshold bin is appended to the band's
//                              row of a packed scratch buffer (rows sized
//                              exactly by the scan) through block-aggregated
//                              cursors;
//   trim    (trim_kernel)      common.cuh: a histogram of the next key bits
//                              of the threshold bin finds how much of it each
//                              overfull band keeps, and moves the kept keys
//                              to the front of the band's row;
//   sort    (run_sort)         common.cuh: each run of 32,768 kept keys
//                              (128 KB) sorted in shared memory, in place; a
//                              band of one run, at the power of two at or
//                              above its length, straight into the output;
//   merge   (merge_pass)       common.cuh: runs merged two by two by merge
//                              path, ping-ponging between the scratch rows
//                              and a second buffer; a band's last pass writes
//                              its first cap keys as values, sentinel padded.
// A band of k kept keys is read and written about 2 + log2(k / 32,768) times
// after the compaction.  Heavy ties or one group holding the data make bands
// wider: slower, still exact.  A NaN value is on no side of any pivot and
// joins no band, and a NaN pivot has zero counts and sentinel bands, as the
// plain version's IEEE comparisons give: one compare an element in each
// pass.  All offsets into the data and the scratch are 64-bit.
#include "common.cuh"

namespace {

constexpr int SB_BITS = 10;
constexpr int NBS = 1 << SB_BITS;              // bins per (shard, group)
constexpr int HIST_THREADS = 512;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int SMEM_LIMIT = 227 * 1024;         // dynamic shared memory a block can have
constexpr int MAX_PIVOTS = 4096;               // G * Q one launch takes

template <class Tr>
__device__ __forceinline__ int sbin(typename Tr::Key ck) {
  return int(ck >> (Tr::BITS - SB_BITS));
}

template <class Tr>
__device__ __forceinline__ int pivot_bin(typename Tr::Raw r) {
  return sbin<Tr>(canon<Tr>(Tr::key(r)));
}

// Side of the pivot an element lies on, from its canonical bin where that
// differs from the pivot's: 0 below, 1 above, -1 equal.
template <class Tr>
__device__ __forceinline__ int side_of(typename Tr::Raw r, int b, typename Tr::Raw piv, int pb) {
  if (b < pb) return 0;
  if (b > pb) return 1;
  const typename Tr::Val v = Tr::val(r), pv = Tr::val(piv);
  return v < pv ? 0 : (v > pv ? 1 : -1);
}

// The int32 keys of the E elements of one value vector.
template <int E>
struct KeyVec {
  int k[E];
  __device__ __forceinline__ void load(const int* __restrict__ keys, int64_t v, int64_t n_total) {
    const int64_t g = v * E;
    if (g + E <= n_total) {
      if constexpr (E % 4 == 0) {
#pragma unroll
        for (int j = 0; j < E / 4; ++j) {
          const int4 w = __ldg(reinterpret_cast<const int4*>(keys + g) + j);
          k[4 * j] = w.x;
          k[4 * j + 1] = w.y;
          k[4 * j + 2] = w.z;
          k[4 * j + 3] = w.w;
        }
      } else {
        const int2 w = __ldg(reinterpret_cast<const int2*>(keys + g));
        k[0] = w.x;
        k[1] = w.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) k[i] = (g + i < n_total) ? keys[g + i] : -1;
    }
  }
};

template <class Tr>
constexpr int hist_smem(int gs, int Q) {
  return gs * (NBS + 3 * Q + Q) * 4 + gs * Q * 8;
}

// Groups one hist_kernel block histograms at once.
template <class Tr>
int groups_per_slice(int G, int Q) {
  const int per = hist_smem<Tr>(1, Q);
  const int gs = SMEM_LIMIT / per;
  return gs < G ? gs : G;
}

// ---------------------------------------------------------------------------
// pass 1: per-group key histograms, exact counts in each pivot's bin
// ---------------------------------------------------------------------------

template <class Tr>
__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(const typename Tr::Raw* __restrict__ x, const int* __restrict__ keys,
            int64_t n_i, int64_t n_total, const typename Tr::Raw* __restrict__ pivots,
            int G, int Q, int Gs, int64_t chunk, int* __restrict__ g_hist,
            int* __restrict__ g_pin) {
  using Raw = typename Tr::Raw;
  using V = Vec<Raw>;
  using K = KeyVec<V::N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.y;
  const int g0 = blockIdx.z * Gs;
  const int gs = (G - g0 < Gs) ? G - g0 : Gs;
  Raw* s_piv = reinterpret_cast<Raw*>(smem);                       // [gs][Q]
  int* s_hist = reinterpret_cast<int*>(smem + size_t(Gs) * Q * 8);  // [gs][NBS]
  int* s_pin = s_hist + Gs * NBS;                                  // [gs][Q][3]
  int* s_pbin = s_pin + Gs * Q * 3;                                // [gs][Q]
  for (int i = threadIdx.x; i < gs * NBS; i += HIST_THREADS) s_hist[i] = 0;
  for (int i = threadIdx.x; i < gs * Q * 3; i += HIST_THREADS) s_pin[i] = 0;
  for (int i = threadIdx.x; i < gs * Q; i += HIST_THREADS) {
    const Raw r = pivots[int64_t(g0) * Q + i];
    s_piv[i] = r;
    s_pbin[i] = is_nan<Tr>(Tr::val(r)) ? -1 : pivot_bin<Tr>(r);
  }
  __syncthreads();

  const int64_t row = int64_t(p) * n_i;
  const int64_t lo = row + int64_t(blockIdx.x) * chunk;
  const int64_t hi = (row + n_i < lo + chunk) ? row + n_i : lo + chunk;
  if (lo < hi) {
    const int64_t v0 = lo / V::N, v1 = (hi + V::N - 1) / V::N;
    for (int64_t base = v0 + threadIdx.x; base < v1; base += int64_t(HIST_THREADS) * UNROLL) {
      V vec[UNROLL];
      K kv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = base + int64_t(u) * HIST_THREADS;
        if (v < v1) {
          vec[u].load(x, v, n_total);
          kv[u].load(keys, v, n_total);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t v = base + int64_t(u) * HIST_THREADS;
        if (v >= v1) continue;
        const int64_t e0 = v * V::N;
        const bool whole = e0 >= lo && e0 + V::N <= hi;
#pragma unroll
        for (int e = 0; e < V::N; ++e) {
          if (!whole && (e0 + e < lo || e0 + e >= hi)) continue;
          const unsigned g = unsigned(kv[u].k[e]) - unsigned(g0);
          if (g >= unsigned(gs)) continue;
          const Raw r = vec[u].r[e];
          if (is_nan<Tr>(Tr::val(r))) continue;
          const int b = sbin<Tr>(canon<Tr>(Tr::key(r)));
          atomicAdd(&s_hist[int(g) * NBS + b], 1);
          for (int q = 0; q < Q; ++q) {
            const int i = int(g) * Q + q;
            if (s_pbin[i] != b) continue;
            const int s = side_of<Tr>(r, b, s_piv[i], b);
            atomicAdd(&s_pin[i * 3 + (s == 0 ? 0 : (s < 0 ? 1 : 2))], 1);
          }
        }
      }
    }
  }
  __syncthreads();
  int* h = g_hist + (int64_t(p) * G + g0) * NBS;
  for (int i = threadIdx.x; i < gs * NBS; i += HIST_THREADS) {
    const int c = s_hist[i];
    if (c) atomicAdd(&h[i], c);
  }
  int* pin = g_pin + (int64_t(p) * G + g0) * Q * 3;
  for (int i = threadIdx.x; i < gs * Q * 3; i += HIST_THREADS) {
    const int c = s_pin[i];
    if (c) atomicAdd(&pin[i], c);
  }
}

// ---------------------------------------------------------------------------
// threshold scan: one warp per (shard, group, level, side)
// ---------------------------------------------------------------------------

// Row r = ((p * G + g) * Q + q) * 2 + side.  Counted outward from the pivot,
// position 0 is the pivot's own bin (its elements on this side), position j
// the bin j steps away.  A NaN pivot has no element on any side.
template <class Tr>
__global__ void __launch_bounds__(32)
threshold_kernel(const int* __restrict__ g_hist, const int* __restrict__ g_pin,
                 const typename Tr::Raw* __restrict__ pivots, int G, int Q, int cap,
                 int* __restrict__ thr, int* __restrict__ cand, int* __restrict__ thrcnt,
                 int* __restrict__ counts) {
  constexpr int PER_LANE = NBS / 32;
  const int64_t r = blockIdx.x;
  const int side = int(r & 1);
  const int64_t pgq = r >> 1;
  const int q = int(pgq % Q);
  const int64_t pg = pgq / Q;
  const int g = int(pg % G);
  const int lane = threadIdx.x;
  const typename Tr::Raw piv = pivots[g * Q + q];
  const bool none = is_nan<Tr>(Tr::val(piv));
  const int pb = pivot_bin<Tr>(piv);
  const int* h = g_hist + pg * NBS;
  const int* pin = g_pin + pgq * 3;
  const int len = side == 0 ? pb + 1 : NBS - pb;
  auto bin_at = [side, pb](int j) { return side == 0 ? pb - j : pb + j; };
  auto count_at = [&](int j) {
    if (none) return 0;
    return j == 0 ? pin[side == 0 ? 0 : 2] : h[bin_at(j)];
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
      counts[pgq * 3 + 0] = total;
      counts[pgq * 3 + 1] = none ? 0 : pin[1];
    } else {
      counts[pgq * 3 + 2] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: append each band's candidates to its packed scratch row
// ---------------------------------------------------------------------------

template <class Tr>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const typename Tr::Raw* __restrict__ x, const int* __restrict__ keys,
               int64_t n_i, int64_t n_total, const typename Tr::Raw* __restrict__ pivots,
               int G, int Q, int64_t chunk, const int* __restrict__ thr,
               const int64_t* __restrict__ off, int* __restrict__ cursor,
               typename Tr::Key* __restrict__ buf) {
  using Raw = typename Tr::Raw;
  using Key = typename Tr::Key;
  using V = Vec<Raw>;
  using K = KeyVec<V::N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int GQ = G * Q;
  const int p = blockIdx.y;
  int64_t* s_base = reinterpret_cast<int64_t*>(smem);          // [GQ][2]
  Raw* s_piv = reinterpret_cast<Raw*>(s_base + 2 * GQ);         // [GQ]
  int* s_pbin = reinterpret_cast<int*>(smem + size_t(GQ) * 24);  // [GQ]
  int* s_thr = s_pbin + GQ;                                     // [GQ][2]
  int* s_cnt = s_thr + 2 * GQ;                                  // [GQ][2]
  int* s_pos = s_cnt + 2 * GQ;                                  // [GQ][2]
  for (int i = threadIdx.x; i < GQ; i += THREADS) {
    s_piv[i] = pivots[i];
    s_pbin[i] = pivot_bin<Tr>(pivots[i]);
  }
  // a NaN pivot's thresholds lie beyond every bin: its bands stay empty
  for (int i = threadIdx.x; i < 2 * GQ; i += THREADS) {
    const bool none = is_nan<Tr>(Tr::val(pivots[i >> 1]));
    s_thr[i] = none ? ((i & 1) ? -1 : NBS) : thr[int64_t(p) * 2 * GQ + i];
    s_cnt[i] = 0;
  }
  __syncthreads();

  const int64_t row = int64_t(p) * n_i;
  const int64_t lo = row + int64_t(blockIdx.x) * chunk;
  const int64_t hi = (row + n_i < lo + chunk) ? row + n_i : lo + chunk;
  const int64_t v0 = lo < hi ? lo / V::N : 0;
  const int64_t v1 = lo < hi ? (hi + V::N - 1) / V::N : 0;
  constexpr int64_t STEP = int64_t(THREADS) * UNROLL;

  // the band an element joins for level q: 2*(g*Q+q) + side, or -1
  auto band = [&](Raw r, int g, int b, int q) {
    const int i = g * Q + q;
    const int s = side_of<Tr>(r, b, s_piv[i], s_pbin[i]);
    if (s == 0) return b >= s_thr[2 * i] ? 2 * i : -1;
    if (s == 1) return b <= s_thr[2 * i + 1] ? 2 * i + 1 : -1;
    return -1;
  };

  // every thread runs the same number of rounds: the loop holds barriers
  for (int64_t round = v0; round < v1; round += STEP) {
    V vec[UNROLL];
    K kv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = round + threadIdx.x + int64_t(u) * THREADS;
      if (v < v1) {
        vec[u].load(x, v, n_total);
        kv[u].load(keys, v, n_total);
      }
    }
    // phase A: count this round's members of every band
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = round + threadIdx.x + int64_t(u) * THREADS;
      if (v >= v1) continue;
      const int64_t e0 = v * V::N;
      const bool whole = e0 >= lo && e0 + V::N <= hi;
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        if (!whole && (e0 + e < lo || e0 + e >= hi)) continue;
        const int g = kv[u].k[e];
        if (unsigned(g) >= unsigned(G)) continue;
        const Raw r = vec[u].r[e];
        if (is_nan<Tr>(Tr::val(r))) continue;
        const int b = sbin<Tr>(canon<Tr>(Tr::key(r)));
        for (int q = 0; q < Q; ++q) {
          const int c = band(r, g, b, q);
          if (c >= 0) atomicAdd(&s_cnt[c], 1);
        }
      }
    }
    __syncthreads();
    // phase B: one device-memory atomic per band reserves the round's slots
    for (int i = threadIdx.x; i < 2 * GQ; i += THREADS) {
      const int c = s_cnt[i];
      if (c) s_base[i] = off[int64_t(p) * 2 * GQ + i] + atomicAdd(&cursor[int64_t(p) * 2 * GQ + i], c);
      s_cnt[i] = 0;
      s_pos[i] = 0;
    }
    __syncthreads();
    // phase C: write the keys (the below side stores ~key, so that every
    // row sorts ascending from the pivot outward)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t v = round + threadIdx.x + int64_t(u) * THREADS;
      if (v >= v1) continue;
      const int64_t e0 = v * V::N;
      const bool whole = e0 >= lo && e0 + V::N <= hi;
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        if (!whole && (e0 + e < lo || e0 + e >= hi)) continue;
        const int g = kv[u].k[e];
        if (unsigned(g) >= unsigned(G)) continue;
        const Raw r = vec[u].r[e];
        if (is_nan<Tr>(Tr::val(r))) continue;
        const Key k = Tr::key(r);
        const int b = sbin<Tr>(canon<Tr>(k));
        for (int q = 0; q < Q; ++q) {
          const int c = band(r, g, b, q);
          if (c < 0) continue;
          buf[s_base[c] + atomicAdd(&s_pos[c], 1)] = (c & 1) ? k : Key(~k);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class Tr>
int hist_impl(const void* x, const int* keys, int64_t P, int64_t n_i, const void* pivots,
              int G, int Q, int bps, int* hist, int* pin, cudaStream_t st) {
  using Raw = typename Tr::Raw;
  const int Gs = groups_per_slice<Tr>(G, Q);
  if (Gs < 1) return kBadArgument;
  const int slices = (G + Gs - 1) / Gs;
  const int64_t chunk = (n_i + bps - 1) / bps;
  const int smem = hist_smem<Tr>(Gs, Q);
  cudaError_t e = cudaFuncSetAttribute(hist_kernel<Tr>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  hist_kernel<Tr><<<dim3(bps, unsigned(P), unsigned(slices)), HIST_THREADS, smem, st>>>(
      static_cast<const Raw*>(x), keys, n_i, P * n_i, static_cast<const Raw*>(pivots), G, Q,
      Gs, chunk, hist, pin);
  return int(cudaGetLastError());
}

template <class Tr>
int threshold_impl(const int* hist, const int* pin, const void* pivots, int64_t P, int G,
                   int Q, int cap, int* thr, int* cand, int* thrcnt, int* counts,
                   cudaStream_t st) {
  threshold_kernel<Tr><<<unsigned(P * G * Q * 2), 32, 0, st>>>(
      hist, pin, static_cast<const typename Tr::Raw*>(pivots), G, Q, cap, thr, cand, thrcnt,
      counts);
  return int(cudaGetLastError());
}

template <class Tr>
int compact_impl(const void* x, const int* keys, int64_t P, int64_t n_i, const void* pivots,
                 int G, int Q, int bps, const int* thr, const int64_t* off, int* cursor,
                 void* buf, cudaStream_t st) {
  using Raw = typename Tr::Raw;
  const int64_t chunk = (n_i + bps - 1) / bps;
  const int smem = G * Q * (24 + 4 + 3 * 8);
  cudaError_t e = cudaFuncSetAttribute(compact_kernel<Tr>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  compact_kernel<Tr><<<dim3(bps, unsigned(P)), THREADS, smem, st>>>(
      static_cast<const Raw*>(x), keys, n_i, P * n_i, static_cast<const Raw*>(pivots), G, Q,
      chunk, thr, off, cursor, static_cast<typename Tr::Key*>(buf));
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float64 (DTYPE_DISPATCH, common.cuh).
// Every function returns a cudaError_t value, 0 on success, -1 for an
// argument the kernels do not take.
static bool shape_ok(long long P, long long n_i, int G, int Q, int bps) {
  return P >= 1 && P <= 65535 && n_i >= 1 && G >= 1 && Q >= 1 &&
         (long long)G * Q <= MAX_PIVOTS && bps >= 1 && bps <= 65535;
}

// Groups whose histograms one pass-1 read covers (its reads are
// ceil(G / this)).
extern "C" int ss_groups_per_slice(int dtype, int G, int Q) {
  if (G < 1 || Q < 1) return kBadArgument;
  DTYPE_DISPATCH(groups_per_slice, G, Q)
}

// Pass 1.  hist: (P, G, ss_num_bins()) int32, pin: (P, G, Q, 3) int32, both
// zeroed by the caller; pivots: (G, Q) of x's type.
extern "C" int ss_hist(int dtype, const void* x, const int* keys, long long P, long long n_i,
                       const void* pivots, int G, int Q, int bps, int* hist, int* pin,
                       void* stream) {
  if (!shape_ok(P, n_i, G, Q, bps)) return kBadArgument;
  DTYPE_DISPATCH(hist_impl, x, keys, P, n_i, pivots, G, Q, bps, hist, pin,
                 static_cast<cudaStream_t>(stream))
}

// The scan.  thr, cand, thrcnt: (P, G, Q, 2) int32; counts: (P, G, Q, 3).
extern "C" int ss_threshold(int dtype, const int* hist, const int* pin, const void* pivots,
                            long long P, int G, int Q, int cap, int* thr, int* cand,
                            int* thrcnt, int* counts, void* stream) {
  if (!shape_ok(P, 1, G, Q, 1) || cap < 1) return kBadArgument;
  DTYPE_DISPATCH(threshold_impl, hist, pin, pivots, P, G, Q, cap, thr, cand, thrcnt, counts,
                 static_cast<cudaStream_t>(stream))
}

// Pass 2.  off: (P*G*Q*2,) int64 start of each row in buf (rows of cand keys);
// cursor: same shape, int32, zeroed by the caller.
extern "C" int ss_compact(int dtype, const void* x, const int* keys, long long P, long long n_i,
                          const void* pivots, int G, int Q, int bps, const int* thr,
                          const long long* off, int* cursor, void* buf, void* stream) {
  if (!shape_ok(P, n_i, G, Q, bps)) return kBadArgument;
  DTYPE_DISPATCH(compact_impl, x, keys, P, n_i, pivots, G, Q, bps, thr,
                 reinterpret_cast<const int64_t*>(off), cursor, buf,
                 static_cast<cudaStream_t>(stream))
}

// The trim and the band sort: ss_trim, ss_run_sort, ss_merge, ss_expand,
// ss_run_tile, ss_merge_chunk.
BAND_SORT_ENTRY_POINTS(ss, SB_BITS)

extern "C" int ss_num_bins() { return NBS; }
extern "C" int ss_max_pivots() { return MAX_PIVOTS; }
