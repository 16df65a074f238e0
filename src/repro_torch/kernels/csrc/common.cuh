// Pieces shared by the port's Hopper kernels (included by every csrc/*.cu).
//
//   F32 / BF16 / I32 / F64   raw storage bits, the order-preserving unsigned
//                            key (the total order: -0.0 just below +0.0) and
//                            the value IEEE comparisons run on
//   canon                    the key with -0.0 folded onto +0.0: its order is
//                            the order of IEEE `<` (for data without NaN)
//   is_nan                   a value that the band kernels skip
//   sortable_u32             JAX's to_sortable_u32, bf16 through f32
//   Vec                      one 16-byte vector of a flat array, element loads
//                            at the ragged end
//   block_add                per-block counters into device memory, one
//                            atomic per counter and block
//   warp_steps               bitonic steps over KPT keys a lane holds in
//                            registers, exchanging by warp shuffles
//   run_sort, merge_pass     rows of any length: runs of run_tile<Key>() keys
//                            (128 KB) sorted in shared memory, then merged
//                            pairwise by merge path, the last pass handing
//                            each row to the caller's output policy;
//                            expand_blocks writes their block tables
//   trim_kernel              the band kernels' trim: each overfull row of
//                            candidates cut to about cap kept keys, in place
//   BandRows, band_run_sort, the band kernels' sort of their packed rows,
//   band_merge               written out as values; BAND_SORT_ENTRY_POINTS
//                            declares the trim's and the sort's C interface
//                            under a library's prefix
// All offsets into the data are 64-bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KPT = 16;                          // keys each sort thread holds
constexpr int WARP_SPAN = 32 * KPT;              // keys one warp holds
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

// A NaN value lies on no side of any pivot: the band kernels skip it.
template <class Tr>
__device__ __forceinline__ bool is_nan(typename Tr::Val v) {
  return Tr::IS_FLOAT && !(v == v);
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
// bitonic steps over keys held in registers
// ---------------------------------------------------------------------------

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

// Steps j, j/2, ..., 1 (j < WARP_SPAN) of bitonic stage k over the KPT keys
// a lane holds, r[q] at position p0 + q: steps j >= KPT exchange with lane
// lane ^ (j / KPT), smaller steps stay in registers.
template <class Key>
__device__ __forceinline__ void warp_steps(Key (&r)[KPT], int64_t p0, int lane, int64_t k,
                                           int j) {
  for (; j >= KPT; j >>= 1) {
    const int m = j / KPT;                       // partner lane = lane ^ m
    const bool lower = (lane & m) == 0;
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const Key o = shfl_xor(r[q], m);
      const bool asc = ((p0 + q) & k) == 0;
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
      const bool asc = ((p0 + q) & k) == 0;
      const Key a = r[q], b = r[q + jj];
      if ((a > b) == asc) { r[q] = b; r[q + jj] = a; }
    }
  }
}

// ---------------------------------------------------------------------------
// rows sorted as runs in shared memory, then merged pairwise by merge path
// ---------------------------------------------------------------------------
//
// A row of n keys is cut into runs of run_tile<Key>() keys.  run_sort sorts
// each run in one block; merge_pass merges runs two by two (pass p merges
// runs of run_tile << p keys), each block producing MERGE_CHUNK keys of the
// merged row.  A row of one run, and the last pass of a wider row, hand the
// sorted keys to the caller's Rows policy instead of the buffer:
//   int len(r)                  keys of row r
//   int out_len()               keys the caller takes from each row
//   void put(r, i, key, valid)  row r's i-th output; valid is i < len(r)
// Both kernels take a table of (row, run or chunk) per block, which
// expand_blocks writes from per-row block counts that the host derives from
// the row lengths.

#ifndef RUN_BYTES
#define RUN_BYTES (1 << 17)                      // keys of one run, in bytes
#endif
constexpr int RUN_THREADS = 512;
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_KPT = 8;
constexpr int MERGE_CHUNK = MERGE_THREADS * MERGE_KPT;   // keys one merge block writes
constexpr int TRIM_THREADS = 256;

// The (row, index) table of the sort's launches: segment s (row s % rows of
// one launch) owns entries first[s] .. first[s + 1] - 1, first being an
// exclusive prefix of the per-row block counts over all launches.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
expand_blocks(const int* __restrict__ first, int64_t segments, int rows,
              int* __restrict__ blk_row, int* __restrict__ blk_idx) {
  for (int64_t s = blockIdx.x; s < segments; s += gridDim.x) {
    const int lo = first[s], hi = first[s + 1];
    for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
      blk_row[i] = int(s % rows);
      blk_idx[i] = i - lo;
    }
  }
}

// Keys one run_sort block sorts: 32,768 of 32 bits, with the pad slots
// 132 KB of shared memory.
template <class Key>
__host__ __device__ constexpr int run_tile() { return RUN_BYTES / int(sizeof(Key)); }

template <class Key>
__host__ __device__ constexpr int run_smem() {
  return (run_tile<Key>() + run_tile<Key>() / 32) * int(sizeof(Key));
}

// Stages k0 .. k1 of the bitonic network over s[0, n), one warp per
// WARP_SPAN keys in registers: all steps of stages k <= WARP_SPAN, or the
// steps j < WARP_SPAN of one wider stage (k0 == k1).
template <class Key>
__device__ __forceinline__ void warp_stages(Key* s, int n, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  for (int seg = (threadIdx.x >> 5) * WARP_SPAN; seg < n; seg += (blockDim.x >> 5) * WARP_SPAN) {
    const int p0 = seg + lane * KPT;
    Key r[KPT];
#pragma unroll
    for (int q = 0; q < KPT; ++q) r[q] = s[pad_idx(p0 + q)];
    for (int k = k0; k <= k1; k <<= 1)
      warp_steps(r, p0, lane, k, (k >> 1) < WARP_SPAN / 2 ? (k >> 1) : WARP_SPAN / 2);
#pragma unroll
    for (int q = 0; q < KPT; ++q) s[pad_idx(p0 + q)] = r[q];
  }
  __syncthreads();
}

// Sorts s[0, n) ascending (pad_idx slots; n a power of two, WARP_SPAN <= n).
template <class Key>
__device__ void block_sort(Key* s, int n) {
  warp_stages(s, n, 2, WARP_SPAN);
  for (int k = 2 * WARP_SPAN; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= WARP_SPAN; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const Key a = s[pad_idx(i)], b = s[pad_idx(i + j)];
        if ((a > b) == ((i & k) == 0)) {
          s[pad_idx(i)] = b;
          s[pad_idx(i + j)] = a;
        }
      }
      __syncthreads();
    }
    warp_stages(s, n, k, k);
  }
}

// Block b sorts run blk_run[b] of row blk_row[b], in place in buf (row r
// starts at off[r]), at the power of two at or above its length (at least
// one warp's span), padded with the largest key.  A row of one run goes to
// rows.put instead, out_len() keys of it.
template <class Key, class Rows>
__global__ void __launch_bounds__(RUN_THREADS)
run_sort(Rows rows, Key* __restrict__ buf, const int64_t* __restrict__ off,
         const int* __restrict__ blk_row, const int* __restrict__ blk_run) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s = reinterpret_cast<Key*>(smem);
  constexpr int T = run_tile<Key>();
  const int64_t r = blk_row[blockIdx.x];
  const int len = rows.len(r);
  const int lo = blk_run[blockIdx.x] * T;
  const int n = len - lo < T ? len - lo : T;
  int width = WARP_SPAN;
  while (width < n) width <<= 1;
  Key* row = buf + off[r] + lo;
  for (int t = threadIdx.x; t < width; t += RUN_THREADS) s[pad_idx(t)] = t < n ? row[t] : Key(~Key(0));
  __syncthreads();
  block_sort(s, width);
  if (len <= T) {
    const int out = rows.out_len();
    for (int t = threadIdx.x; t < out; t += RUN_THREADS)
      rows.put(r, t, t < n ? s[pad_idx(t)] : Key(0), t < n);
  } else {
    for (int t = threadIdx.x; t < n; t += RUN_THREADS) row[t] = s[pad_idx(t)];
  }
}

// Merge path: how many of the first d keys of merge(a, b) come from a, equal
// keys taking a first.
template <class Key>
__device__ __forceinline__ int merge_split(const Key* a, int la, const Key* b, int lb, int d) {
  int lo = d > lb ? d - lb : 0, hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass p: block b writes keys [c * MERGE_CHUNK, (c + 1) * MERGE_CHUNK) of
// row blk_row[b], c = blk_chunk[b], merged from two sorted runs of
// run_tile << p keys of src (a last run with no partner is copied).  Rows of
// more than 2^(p+1) runs go to dst, the others to rows.put (out_len() keys
// each, so their last pass merges only what the caller takes).
template <class Key, class Rows>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_pass(Rows rows, const Key* __restrict__ src, const int64_t* __restrict__ src_off,
           Key* __restrict__ dst, const int64_t* __restrict__ dst_off, int pass,
           const int* __restrict__ blk_row, const int* __restrict__ blk_chunk) {
  __shared__ Key s_in[MERGE_CHUNK];
  __shared__ Key s_out[MERGE_CHUNK];
  __shared__ int s_split[2];
  constexpr int T = run_tile<Key>();
  const int64_t r = blk_row[blockIdx.x];
  const int len = rows.len(r);
  const bool last = (len + T - 1) / T <= (2 << pass);
  const int end = last ? rows.out_len() : len;
  const int o0 = blk_chunk[blockIdx.x] * MERGE_CHUNK;
  const int o1 = end - o0 < MERGE_CHUNK ? end : o0 + MERGE_CHUNK;
  const int m1 = o1 < len ? o1 : len;            // merged keys end here
  const int n = m1 - o0;
  if (n > 0) {
    const int64_t W = int64_t(T) << pass;
    const int64_t s0 = (o0 / (2 * W)) * 2 * W;   // the pair's first key
    const int la = int(len - s0 < W ? len - s0 : W);
    const int lb = int(len - s0 - W <= 0 ? 0 : (len - s0 - W < W ? len - s0 - W : W));
    const Key* a = src + src_off[r] + s0;
    const Key* b = a + W;
    if (threadIdx.x < 2)
      s_split[threadIdx.x] = merge_split(a, la, b, lb, int((threadIdx.x ? m1 : o0) - s0));
    __syncthreads();
    const int i0 = s_split[0], i1 = s_split[1];
    const int j0 = int(o0 - s0) - i0, j1 = int(m1 - s0) - i1;
    const int na = i1 - i0, nb = j1 - j0;
    for (int t = threadIdx.x; t < na; t += MERGE_THREADS) s_in[t] = a[i0 + t];
    for (int t = threadIdx.x; t < nb; t += MERGE_THREADS) s_in[na + t] = b[j0 + t];
    __syncthreads();
    const int d = threadIdx.x * MERGE_KPT;
    if (d < n) {
      const Key* sa = s_in;
      const Key* sb = s_in + na;
      int ia = merge_split(sa, na, sb, nb, d), ib = d - ia;
#pragma unroll
      for (int q = 0; q < MERGE_KPT; ++q) {
        if (d + q >= n) break;
        const bool take_a = ia < na && (ib >= nb || sa[ia] <= sb[ib]);
        s_out[d + q] = take_a ? sa[ia++] : sb[ib++];
      }
    }
    __syncthreads();
  }
  if (last) {
    for (int t = threadIdx.x; t < o1 - o0; t += MERGE_THREADS)
      rows.put(r, o0 + t, t < n ? s_out[t] : Key(0), t < n);
  } else {
    Key* out = dst + dst_off[r] + o0;
    for (int t = threadIdx.x; t < n; t += MERGE_THREADS) out[t] = s_out[t];
  }
}

// ---------------------------------------------------------------------------
// the trim: how much of its threshold bin each overfull band keeps
// ---------------------------------------------------------------------------

// The band kernels bin each band's candidates by the top BIN_BITS bits of
// the canonical key, counted outward from the pivot: thr[r] is row r's
// threshold bin, thrcnt[r] its count on the row's side.
template <class Tr, int BIN_BITS>
struct Trim {
  using Key = typename Tr::Key;
  static constexpr int NB = 1 << BIN_BITS;
  static constexpr int SUB_BITS = Tr::BITS - BIN_BITS < 11 ? Tr::BITS - BIN_BITS : 11;
  static constexpr int SUB = 1 << SUB_BITS;
  static constexpr int SUB_SHIFT = Tr::BITS - BIN_BITS - SUB_BITS;
  // a stored key as a canonical key that ascends from the pivot outward
  __device__ static Key outward(Key s, int side) {
    const Key ck = canon<Tr>(side == 0 ? Key(~s) : s);
    return side == 0 ? Key(~ck) : ck;
  }
  __device__ static int bin(Key o) { return int(o >> (Tr::BITS - BIN_BITS)); }
  __device__ static int sub(Key o) { return int(o >> SUB_SHIFT) & (SUB - 1); }
};

// kept[r]: the keys row r keeps.  A row of more than cap candidates keeps
// those in bins nearer the pivot and, of its threshold bin, the sub-bins up
// to the first at which the count reaches cap; its kept keys are then moved
// to the front of its row, in place.  The kept keys are the row's smallest,
// since the outward key ascends with the stored key.
template <class Tr, int BIN_BITS>
__global__ void __launch_bounds__(TRIM_THREADS)
trim_kernel(typename Tr::Key* __restrict__ buf, const int64_t* __restrict__ off,
            const int* __restrict__ cand, const int* __restrict__ thr,
            const int* __restrict__ thrcnt, int cap, int* __restrict__ kept) {
  using T = Trim<Tr, BIN_BITS>;
  using Key = typename Tr::Key;
  constexpr int PER = 8;                          // keys a thread holds per round
  __shared__ int s_hist[T::SUB];
  __shared__ int s_b2, s_cur;
  const int64_t r = blockIdx.x;
  const int c = cand[r];
  if (c <= cap) {
    if (threadIdx.x == 0) kept[r] = c;
    return;
  }
  const int side = int(r & 1);
  const int b1 = side == 0 ? T::NB - 1 - thr[r] : thr[r];
  const int before = c - thrcnt[r];                 // keys in bins nearer the pivot
  const int need = cap - before;                    // >= 1
  for (int i = threadIdx.x; i < T::SUB; i += TRIM_THREADS) s_hist[i] = 0;
  __syncthreads();
  Key* row = buf + off[r];
  for (int i = threadIdx.x; i < c; i += TRIM_THREADS) {
    const Key o = T::outward(row[i], side);
    if (T::bin(o) == b1) atomicAdd(&s_hist[T::sub(o)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0, b2 = T::SUB - 1;
    for (int i = 0; i < T::SUB; ++i) {
      run += s_hist[i];
      if (run >= need) { b2 = i; break; }
    }
    kept[r] = before + run;
    s_b2 = before + run < c ? b2 : -1;
    s_cur = 0;
  }
  __syncthreads();
  const int b2 = s_b2;
  if (b2 < 0) return;
  // every key of a round is read before any is written, and the writes end
  // at or before the round's last key
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < c; base += TRIM_THREADS * PER) {
    Key v[PER];
    bool keep[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = base + q * TRIM_THREADS + threadIdx.x;
      keep[q] = false;
      if (i < c) {
        v[q] = row[i];
        const Key o = T::outward(v[q], side);
        const int hb = T::bin(o);
        keep[q] = hb < b1 || (hb == b1 && T::sub(o) <= b2);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, keep[q]);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_cur, __popc(m));
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
      if (keep[q]) row[at + __popc(m & ((1u << lane) - 1))] = v[q];
    }
    __syncthreads();
  }
}

template <int BIN_BITS>
struct BandTrim {
  template <class Tr>
  static int launch(void* buf, const int64_t* off, const int* cand, const int* thr,
                    const int* thrcnt, int64_t rows, int cap, int* kept, cudaStream_t st) {
    trim_kernel<Tr, BIN_BITS><<<unsigned(rows), TRIM_THREADS, 0, st>>>(
        static_cast<typename Tr::Key*>(buf), off, cand, thr, thrcnt, cap, kept);
    return int(cudaGetLastError());
  }
};

// ---------------------------------------------------------------------------
// the band sort: output policy and launches shared by the band kernels
// ---------------------------------------------------------------------------

// The sort's output policy for band rows: row r = 2 * band + side keeps
// kept[r] keys; its first cap go back to values (the below side stores
// ~key) into below or above, band-major, the rest are the side's sentinel.
template <class Tr>
struct BandRows {
  using Key = typename Tr::Key;
  using Raw = typename Tr::Raw;
  const int* kept;
  int cap;
  Raw* below;
  Raw* above;
  __device__ int len(int64_t r) const { return kept[r]; }
  __device__ int out_len() const { return cap; }
  __device__ void put(int64_t r, int i, Key k, bool valid) const {
    const int side = int(r & 1);
    const Raw v = valid ? Tr::raw(side == 0 ? Key(~k) : k)
                        : (side == 0 ? Raw(Tr::LO) : Raw(Tr::HI));
    (side == 0 ? below : above)[(r >> 1) * int64_t(cap) + i] = v;
  }
};

template <class Tr>
int band_run_sort(void* buf, const int64_t* off, const int* kept, int cap, void* below,
                  void* above, const int* blk_row, const int* blk_run, int64_t blocks,
                  cudaStream_t st) {
  using Key = typename Tr::Key;
  using Raw = typename Tr::Raw;
  constexpr int smem = run_smem<Key>();
  cudaError_t e = cudaFuncSetAttribute(run_sort<Key, BandRows<Tr>>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const BandRows<Tr> rows{kept, cap, static_cast<Raw*>(below), static_cast<Raw*>(above)};
  run_sort<Key, BandRows<Tr>><<<unsigned(blocks), RUN_THREADS, smem, st>>>(
      rows, static_cast<Key*>(buf), off, blk_row, blk_run);
  return int(cudaGetLastError());
}

template <class Tr>
int band_merge(const void* src, const int64_t* src_off, void* dst, const int64_t* dst_off,
               const int* kept, int cap, void* below, void* above, int pass,
               const int* blk_row, const int* blk_chunk, int64_t blocks, cudaStream_t st) {
  using Key = typename Tr::Key;
  using Raw = typename Tr::Raw;
  const BandRows<Tr> rows{kept, cap, static_cast<Raw*>(below), static_cast<Raw*>(above)};
  merge_pass<Key, BandRows<Tr>><<<unsigned(blocks), MERGE_THREADS, 0, st>>>(
      rows, static_cast<const Key*>(src), src_off, static_cast<Key*>(dst), dst_off, pass,
      blk_row, blk_chunk);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float64.
#define DTYPE_DISPATCH(FN, ...)                                               \
  switch (dtype) {                                                            \
    case 0: return FN<F32>(__VA_ARGS__);                                      \
    case 1: return FN<BF16>(__VA_ARGS__);                                     \
    case 2: return FN<I32>(__VA_ARGS__);                                      \
    case 3: return FN<F64>(__VA_ARGS__);                                      \
    default: return kBadArgument;                                             \
  }

// The trim's and the band sort's C entry points of one library, each name
// under its prefix, for its bins of BIN_BITS bits (kernels/band_sort.py
// declares and drives them).  Each returns a cudaError_t value, 0 on
// success, -1 for an argument the kernels refuse.
//   _trim         kept: (rows,) int32; moves each trimmed row's kept keys to
//                 the front of its row
//   _run_sort     one block per (blk_row, blk_run) pair, `blocks` of them: the
//                 runs sorted in place in buf (row r from off[r]), rows of one
//                 run straight to below/above (bands of cap values)
//   _merge        merge pass `pass` from src (rows at src_off) to dst (rows at
//                 dst_off) or, for the rows it finishes, to below/above; one
//                 block per (blk_row, blk_chunk) pair
//   _expand       the block tables: blk_row, blk_idx (first[segments],) int32
//                 from first (segments + 1,) int32, `rows` segments a launch
//   _run_tile     keys of one run for dtype; _merge_chunk: keys of one merge
//                 block's output
#define BAND_SORT_ENTRY_POINTS(PREFIX, BIN_BITS)                              \
  extern "C" int PREFIX##_trim(int dtype, void* buf, const long long* off,     \
                               const int* cand, const int* thr,                \
                               const int* thrcnt, long long rows, int cap,     \
                               int* kept, void* stream) {                      \
    if (rows < 1 || rows > 0x7FFFFFFFLL || cap < 1) return kBadArgument;       \
    DTYPE_DISPATCH(BandTrim<BIN_BITS>::launch, buf,                            \
                   reinterpret_cast<const int64_t*>(off), cand, thr, thrcnt,   \
                   rows, cap, kept,                                            \
                   static_cast<cudaStream_t>(stream))                          \
  }                                                                            \
  extern "C" int PREFIX##_run_sort(int dtype, void* buf, const long long* off,  \
                                   const int* kept, int cap, void* below,       \
                                   void* above, const int* blk_row,             \
                                   const int* blk_run, long long blocks,        \
                                   void* stream) {                              \
    if (blocks < 1 || blocks > 0x7FFFFFFFLL || cap < 1) return kBadArgument;   \
    DTYPE_DISPATCH(band_run_sort, buf, reinterpret_cast<const int64_t*>(off),   \
                   kept, cap, below, above, blk_row, blk_run, blocks,           \
                   static_cast<cudaStream_t>(stream))                          \
  }                                                                            \
  extern "C" int PREFIX##_merge(int dtype, const void* src,                    \
                                const long long* src_off, void* dst,           \
                                const long long* dst_off, const int* kept,     \
                                int cap, void* below, void* above, int pass,   \
                                const int* blk_row, const int* blk_chunk,      \
                                long long blocks, void* stream) {              \
    if (blocks < 1 || blocks > 0x7FFFFFFFLL || cap < 1 || pass < 0 || pass > 30) \
      return kBadArgument;                                                     \
    DTYPE_DISPATCH(band_merge, src, reinterpret_cast<const int64_t*>(src_off),  \
                   dst, reinterpret_cast<const int64_t*>(dst_off), kept, cap,   \
                   below, above, pass, blk_row, blk_chunk, blocks,              \
                   static_cast<cudaStream_t>(stream))                          \
  }                                                                            \
  extern "C" int PREFIX##_expand(const int* first, long long segments, int rows, \
                                 int* blk_row, int* blk_idx, void* stream) {    \
    if (segments < 1 || rows < 1) return kBadArgument;                         \
    const int grid = int(segments < 65535 ? segments : 65535);                 \
    expand_blocks<128><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(    \
        first, segments, rows, blk_row, blk_idx);                              \
    return int(cudaGetLastError());                                            \
  }                                                                            \
  extern "C" int PREFIX##_run_tile(int dtype) {                                \
    switch (dtype) {                                                           \
      case 0: case 2: return run_tile<uint32_t>();                             \
      case 1: return run_tile<uint16_t>();                                     \
      case 3: return run_tile<unsigned long long>();                           \
      default: return kBadArgument;                                            \
    }                                                                          \
  }                                                                            \
  extern "C" int PREFIX##_merge_chunk() { return MERGE_CHUNK; }
