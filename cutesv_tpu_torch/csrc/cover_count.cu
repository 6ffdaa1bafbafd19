// Cover count for genotype read support, hand-written for Hopper (sm_90a).
//
// Replaces cutesv_tpu/ops/pallas_sweep.py::_cover_kernel (the one Pallas
// kernel of the JAX package). For every SV window w it counts the reads r
// with  start[r] <= s[w]  and  end[r] >= e[w]  over coordinates the host
// has already doubled (ops/sweep.py::scale_and_pad), in int32.
//
// The pruning. Let L be the largest end - start over the reads, in int64.
// A read that covers w has  start >= end - L >= e[w] - L, so its start lies
// in [e[w] - L, s[w]], and only those reads need a compare; a window whose
// range holds no read start counts 0. The reads are counting-sorted by
// the bin of their start, the windows by the bin of theirs, and each group
// of WINDOWS_PER_GROUP windows in bin order is compared with the reads of
// the bins that its windows' ranges span. This is exact for any input:
// reads and windows in any order, e < s, end < start, duplicates, all
// reads at one start, the int32 extremes and scale_and_pad's INT32_MIN/MAX
// sentinels.
//
// Long reads. One ultra-long read would widen every range. Each read has
// a length class (the bit length of end - start, 0 when that is <= 0);
// the fewest top classes that hold at most n_reads >> LONG_SHIFT reads go
// to a dense arm, which every group compares with all its windows, and L
// is taken over the other reads. So the dense arm costs at most
// n_sv * n_reads / 1024 compares, and L is under twice the length of the
// longest read outside that share.
//
// One cooperative launch (cudaLaunchCooperativeKernel: every block is
// resident, so grid-wide barriers separate the phases instead of launches;
// the host enqueues one operation and never syncs). Phases:
//   0. zero the header and both histograms;
//   1. stats: least and greatest read start, length classes;
//   2. hist: the long-read cut, L (a 64-bit atomicMax), the read-bin and
//      window-bin histograms (warp-aggregated atomicAdd, whose return
//      gives each read and window its rank within its bin);
//   3. scan: one exclusive scan over both histograms (bin offsets);
//   4. scatter: short reads as int2 (start, end) into bin order (offset
//      plus rank: no atomics), long reads into their own list, windows as
//      int2 (s, e) into bin order with their original index;
//   5. ranges: each group of windows gets its reads, the binned ones from
//      the bin of its least e - L to the bin of its greatest s, then the
//      long list, cut into TILE-read work items; a scan numbers the items;
//   6. count: the GROUPS thread groups of every block walk the items, one
//      window per thread in registers, the item's reads in shared memory,
//      the next item's tile loaded with cp.async while this one is compared
//      (double-buffered); one atomicAdd per window and item, at the
//      window's original index. So a group of windows over many reads (all
//      reads at one start, e < s, the dense arm) is spread over the card,
//      and a shape of a few hundred windows fills as many groups as it has
//      items.
// Order within a bin does not matter: a count is a sum of 0/1. Scratch
// that one block writes and another reads is read with ld.global.cg (from
// L2) after a barrier: the SMs' L1 caches are not coherent.
//
// What bounds it. Not the compares any more: at genome scale (32,768
// windows x 1.5 M reads of 1-40 kb over 1e9 doubled bp) the groups compare
// about 1e8 pairs (3 integer operations each: ~10 us at the int32 issue
// rate), and the phases move ~60 MB (the reads read three times, their
// binned copy written and read once: ~18 us at 3.35 TB/s, most of it in
// L2). At the main path's shapes (hundreds to thousands of windows,
// 25-130 k reads) it is the latency of the phases and their barriers.
// Tensor cores do not apply: there is no product, only integer compares
// and adds.
//
// The caller passes a scratch buffer of cutesv_cover_scratch_bytes() bytes
// and an `out` it has zeroed (the counts are added into it); the entry
// point allocates nothing and returns the first CUDA error, if any. The
// first PHASE_STAMPS * 8 bytes of the scratch hold the device clock
// (%globaltimer, ns) after phase 0 and at the end of phases 1-6.

#include <climits>
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;             // per block, every phase
constexpr int WINDOWS_PER_GROUP = 64;    // phase 6: one window per thread
constexpr int GROUPS = THREADS / WINDOWS_PER_GROUP;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 512;                // reads per shared tile (4 KB)
constexpr int MIN_BINS = 1024;           // bins: a power of two in
constexpr int MAX_BINS = 32768;          //   [MIN_BINS, MAX_BINS], about
constexpr int READS_PER_BIN = 8;         //   READS_PER_BIN reads each
constexpr int LONG_SHIFT = 10;           // dense arm: <= n_reads >> 10
constexpr int LEN_CLASSES = 33;          // bit lengths 0..32
constexpr int MAX_GRID = 4096;           // blocks (the scans' partial sums)
constexpr int SMALL_SCAN = 4096;         // scanned by one block up to this
constexpr int PHASE_STAMPS = 7;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long LEN_BIAS = 1LL << 32;  // L is kept as L + 2^32 > 0
constexpr size_t ALIGN = 256;

struct Header {
  unsigned long long stamp[PHASE_STAMPS];  // first: read by the wrapper
  unsigned long long len_max;  // greatest short end - start, + LEN_BIAS;
                               // 0 while there is none
  unsigned int lo_inv;         // max of ~key(start): ~lo_inv is the least
  unsigned int hi_key;         // max of key(start)
  int n_long;                  // reads in the dense arm
  int len_class[LEN_CLASSES];  // reads per length class
};

// Byte offsets into the scratch buffer.
struct Layout {
  int nb;              // bins
  long long x_groups;  // groups of windows
  size_t hist, rank, rbin, rlong, wbin, wperm, r0, nbin, items, partial,
      bytes;
};

size_t aligned(size_t x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }

Layout layout(int n_sv, int n_reads) {
  Layout l;
  const long long want = (static_cast<long long>(n_reads) + READS_PER_BIN - 1)
                         / READS_PER_BIN;
  l.nb = MIN_BINS;
  while (l.nb < MAX_BINS && l.nb < want) l.nb *= 2;
  l.x_groups = (static_cast<long long>(n_sv) + WINDOWS_PER_GROUP - 1) /
               WINDOWS_PER_GROUP;
  size_t at = aligned(sizeof(Header));
  // read bins [0, nb), window bins [nb, 2 nb), the total at [2 nb]
  l.hist = at;
  at += (2 * static_cast<size_t>(l.nb) + 1) * sizeof(int);
  l.rank = at = aligned(at);  // each read's, then window's, rank in its bin
  at += (static_cast<size_t>(n_reads) + n_sv) * sizeof(int);
  l.rbin = at = aligned(at);
  at += static_cast<size_t>(n_reads) * sizeof(int2);
  l.rlong = at = aligned(at);
  at += (static_cast<size_t>(n_reads >> LONG_SHIFT) + 1) * sizeof(int2);
  l.wbin = at = aligned(at);
  at += static_cast<size_t>(n_sv) * sizeof(int2);
  l.wperm = at = aligned(at);
  at += static_cast<size_t>(n_sv) * sizeof(int);
  l.r0 = at = aligned(at);  // per group of windows: its first binned read,
  at += static_cast<size_t>(l.x_groups) * sizeof(int);
  l.nbin = at = aligned(at);  // its binned reads,
  at += static_cast<size_t>(l.x_groups) * sizeof(int);
  l.items = at = aligned(at);  // its first item (the total at the end)
  at += static_cast<size_t>(l.x_groups + 1) * sizeof(long long);
  l.partial = at = aligned(at);  // the scans' per-block sums
  at += static_cast<size_t>(MAX_GRID) * sizeof(long long);
  l.bytes = aligned(at);
  return l;
}

struct Args {
  const int32_t *sv_s, *sv_e, *st, *en;
  int n_sv, n_reads, nb;
  long long x_groups;
  Header* h;
  int *hist, *rank;
  int2 *rbin, *rlong, *wbin;
  int *wperm, *r0, *nbin;
  long long *items, *partial;
  int32_t* out;
};

// int32 -> uint32 in the same order
__device__ __forceinline__ unsigned key_of(int x) {
  return static_cast<unsigned>(x) ^ 0x80000000u;
}

__device__ __forceinline__ long long of_key(unsigned k) {
  return static_cast<int>(k ^ 0x80000000u);
}

__device__ __forceinline__ int len_class(long long len) {
  return len <= 0 ? 0 : 64 - __clzll(len);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What phases 2, 4 and 5 derive from the header written by phase 1.
struct Plan {
  long long lo, hi;  // least and greatest read start
  int shift;         // bin(x) = (x - lo) >> shift, < nb on [lo, hi]
  int cut;           // a read of a length class above `cut` is long
};

// Every thread's copy of the plan, made once per block: the header's
// fields are loaded at once (one L2 round trip), then thread 0 walks the
// length classes in shared memory.
__device__ Plan block_plan(const Args& a) {
  __shared__ Plan plan;
  __shared__ int cls[LEN_CLASSES];
  __shared__ unsigned lo_inv, hi_key;
  if (threadIdx.x < LEN_CLASSES) {
    cls[threadIdx.x] = __ldcg(&a.h->len_class[threadIdx.x]);
  } else if (threadIdx.x == LEN_CLASSES) {
    lo_inv = __ldcg(&a.h->lo_inv);
    hi_key = __ldcg(&a.h->hi_key);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Plan p;
    p.lo = of_key(~lo_inv);
    p.hi = of_key(hi_key);
    p.shift = 0;
    while (((p.hi - p.lo) >> p.shift) >= a.nb) ++p.shift;
    // the least cut whose classes above it hold <= n_reads >> LONG_SHIFT
    const int limit = a.n_reads >> LONG_SHIFT;
    int above = 0;
    p.cut = LEN_CLASSES - 1;
    while (p.cut > 0 && above + cls[p.cut] <= limit) {
      above += cls[p.cut];
      --p.cut;
    }
    plan = p;
  }
  __syncthreads();
  const Plan p = plan;
  __syncthreads();
  return p;
}

__device__ __forceinline__ int bin_of(long long x, const Plan& p, int nb) {
  const long long b = (x - p.lo) >> p.shift;
  return static_cast<int>(b < 0 ? 0 : (b >= nb ? nb - 1 : b));
}

// Grid-stride over [0, n) in whole warps, so that every lane of a warp
// runs each iteration (the warp intrinsics below need all 32).
#define FOR_WARP_STRIDE(i, n)                                               \
  for (long long base_ = static_cast<long long>(blockIdx.x) * THREADS +    \
                         (threadIdx.x & ~31u),                              \
                 i = base_ + (threadIdx.x & 31);                            \
       base_ < (n); base_ += static_cast<long long>(gridDim.x) * THREADS,  \
                 i = base_ + (threadIdx.x & 31))

// Sum over the block, returned to every thread.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sum[WARPS];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
  __syncthreads();
  return s;
}

// Inclusive scan over the block; `total` gets the block's sum.
template <typename T>
__device__ T block_scan(T v, T* total) {
  __shared__ T warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  T before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + v;
}

// Exclusive scan of a[0, n) in place over the whole grid, the total at
// a[n]. Block b scans the b-th run of the array after a barrier that
// publishes every run's sum.
template <typename T>
__device__ void grid_scan(cg::grid_group& grid, T* a, long long n,
                          long long* partial) {
  const long long chunk = (n + gridDim.x - 1) / gridDim.x;
  const long long b0 = min(n, blockIdx.x * chunk), b1 = min(n, b0 + chunk);
  T s = 0;
  for (long long j = b0 + threadIdx.x; j < b1; j += THREADS) {
    s += __ldcg(&a[j]);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
  grid.sync();
  T run = 0;
  for (long long k = threadIdx.x; k < blockIdx.x; k += THREADS) {
    run += static_cast<T>(__ldcg(&partial[k]));
  }
  run = block_sum(run);
  for (long long base = b0; base < b1; base += THREADS) {
    const long long j = base + threadIdx.x;
    const T v = j < b1 ? __ldcg(&a[j]) : 0;
    T total;
    const T incl = block_scan(v, &total);
    if (j < b1) a[j] = run + incl - v;
    run += total;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) a[n] = run;
}

// Exclusive scan of a[0, n) in place by block 0 alone, each thread over a
// contiguous run, the total at a[n] (the other blocks go on to the next
// barrier).
template <typename T>
__device__ void block0_scan(T* a, long long n) {
  if (blockIdx.x != 0) return;
  const long long per = (n + THREADS - 1) / THREADS;
  const long long j0 = min(n, threadIdx.x * per), j1 = min(n, j0 + per);
  T s = 0;
#pragma unroll 16
  for (long long j = j0; j < j1; ++j) s += __ldcg(&a[j]);
  T total;
  T run = block_scan(s, &total) - s;
#pragma unroll 16
  for (long long j = j0; j < j1; ++j) {
    const T v = __ldcg(&a[j]);
    a[j] = run;
    run += v;
  }
  if (threadIdx.x == 0) a[n] = total;
}

// Exclusive scan of a[0, n) in place, the total at a[n]: by block 0 when
// the array is small (no inner barrier), else over the grid.
template <typename T>
__device__ void scan(cg::grid_group& grid, T* a, long long n,
                     long long* partial) {
  if (n <= SMALL_SCAN) {
    block0_scan(a, n);
  } else {
    grid_scan(grid, a, n, partial);
  }
}

__device__ __forceinline__ void stamp(const Args& a, int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) a.h->stamp[k] = clock_ns();
}

__device__ void phase_zero(const Args& a) {
  const long long n = 2LL * a.nb + 1;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
    a.hist[i] = 0;
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < LEN_CLASSES) a.h->len_class[threadIdx.x] = 0;
    if (threadIdx.x == 0) {
      a.h->len_max = 0;
      a.h->lo_inv = a.h->hi_key = 0;
      a.h->n_long = 0;
      for (int k = 1; k < PHASE_STAMPS; ++k) a.h->stamp[k] = 0;
    }
  }
}

__device__ void phase_stats(const Args& a) {
  __shared__ int cls[LEN_CLASSES];
  __shared__ unsigned lo_inv, hi_key;
  if (threadIdx.x < LEN_CLASSES) cls[threadIdx.x] = 0;
  if (threadIdx.x == 0) lo_inv = hi_key = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned my_lo_inv = 0, my_hi = 0;
  FOR_WARP_STRIDE(i, a.n_reads) {
    int c = -1;
    if (i < a.n_reads) {
      const int s = a.st[i];
      const unsigned k = key_of(s);
      my_lo_inv = max(my_lo_inv, ~k);
      my_hi = max(my_hi, k);
      c = len_class(static_cast<long long>(a.en[i]) - s);
    }
    const unsigned peers = __match_any_sync(FULL, c);
    if (c >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cls[c], __popc(peers));
  }
  my_lo_inv = __reduce_max_sync(FULL, my_lo_inv);
  my_hi = __reduce_max_sync(FULL, my_hi);
  if (lane == 0) {
    atomicMax(&lo_inv, my_lo_inv);
    atomicMax(&hi_key, my_hi);
  }
  __syncthreads();
  if (threadIdx.x < LEN_CLASSES && cls[threadIdx.x] != 0) {
    atomicAdd(&a.h->len_class[threadIdx.x], cls[threadIdx.x]);
  }
  if (threadIdx.x == 0) {
    atomicMax(&a.h->lo_inv, lo_inv);
    atomicMax(&a.h->hi_key, hi_key);
  }
}

// Index i < n_reads is read i, else window i - n_reads; rank[i] is its
// place within its bin, or -1 for a long read.
__device__ void phase_hist(const Args& a) {
  __shared__ unsigned long long warp_len[WARPS];
  const Plan p = block_plan(a);
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(a.n_reads) + a.n_sv;
  unsigned long long my_len = 0;
  FOR_WARP_STRIDE(i, n) {
    int slot = -1;  // read bin b: hist[b]; window bin b: hist[nb + b]
    if (i < a.n_reads) {
      const int s = a.st[i];
      const long long len = static_cast<long long>(a.en[i]) - s;
      if (len_class(len) <= p.cut) {
        slot = bin_of(s, p, a.nb);
        const unsigned long long biased = len + LEN_BIAS;
        my_len = biased > my_len ? biased : my_len;
      }
    } else if (i < n) {
      slot = a.nb + bin_of(a.sv_s[i - a.n_reads], p, a.nb);
    }
    const unsigned peers = __match_any_sync(FULL, slot);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (slot >= 0 && lane == leader) {
      at = atomicAdd(&a.hist[slot], __popc(peers));
    }
    at = __shfl_sync(FULL, at, leader) + __popc(peers & lanes_below());
    if (i < n) a.rank[i] = slot >= 0 ? at : -1;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(FULL, my_len, o);
    my_len = v > my_len ? v : my_len;
  }
  if (lane == 0) warp_len[threadIdx.x >> 5] = my_len;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0;
    for (int w = 0; w < WARPS; ++w) m = warp_len[w] > m ? warp_len[w] : m;
    if (m != 0) atomicMax(&a.h->len_max, m);
  }
}

// Index i < n_reads is read i, else window i - n_reads: a short read or a
// window goes to its bin's offset plus its rank, a long read (rank -1) to
// the long list. The offsets run over both histograms, so a window's place
// is its offset less the short reads.
__device__ void phase_scatter(const Args& a) {
  const Plan p = block_plan(a);
  const int lane = threadIdx.x & 31;
  const int n_short = __ldcg(&a.hist[a.nb]);
  const long long n = static_cast<long long>(a.n_reads) + a.n_sv;
  FOR_WARP_STRIDE(i, n) {
    bool is_long = false;
    int2 v = make_int2(0, 0);
    if (i < a.n_reads) {
      v = make_int2(a.st[i], a.en[i]);
      const int r = __ldcg(&a.rank[i]);
      if (r >= 0) {
        a.rbin[__ldcg(&a.hist[bin_of(v.x, p, a.nb)]) + r] = v;
      } else {
        is_long = true;
      }
    } else if (i < n) {
      const long long w = i - a.n_reads;
      v = make_int2(a.sv_s[w], a.sv_e[w]);
      const int at = __ldcg(&a.hist[a.nb + bin_of(v.x, p, a.nb)]) - n_short +
                     __ldcg(&a.rank[i]);
      a.wbin[at] = v;
      a.wperm[at] = static_cast<int>(w);
    }
    const unsigned longs = __ballot_sync(FULL, is_long);
    if (longs != 0) {
      const int first = __ffs(longs) - 1;
      int l = 0;
      if (lane == first) l = atomicAdd(&a.h->n_long, __popc(longs));
      l = __shfl_sync(FULL, l, first) + __popc(longs & lanes_below());
      if (is_long) a.rlong[l] = v;
    }
  }
}

// One warp per group of windows (two windows a lane): the binned reads
// from the bin of the least e - L to the bin of the greatest s over its
// windows whose own range [e - L, s] meets [lo, hi], then the long list;
// its item count is ceil(reads / TILE).
__device__ void phase_ranges(const Args& a) {
  const Plan p = block_plan(a);
  const int lane = threadIdx.x & 31;
  const unsigned long long len_max = __ldcg(&a.h->len_max);
  const long long L = static_cast<long long>(len_max) - LEN_BIAS;
  const int n_long = __ldcg(&a.h->n_long);
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long x = static_cast<long long>(blockIdx.x) * WARPS +
                     (threadIdx.x >> 5);
       x < a.x_groups; x += warps) {
    long long lo_r = LLONG_MAX, hi_r = LLONG_MIN;
    for (int k = 0; k < WINDOWS_PER_GROUP; k += 32) {
      const long long i = x * WINDOWS_PER_GROUP + k + lane;
      if (i < a.n_sv && len_max != 0) {
        const int2 w = __ldcg(&a.wbin[i]);
        const long long lo = max(static_cast<long long>(w.y) - L, p.lo);
        const long long hi = min(static_cast<long long>(w.x), p.hi);
        if (lo <= hi) {
          lo_r = min(lo_r, lo);
          hi_r = max(hi_r, hi);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo_r = min(lo_r, __shfl_xor_sync(FULL, lo_r, o));
      hi_r = max(hi_r, __shfl_xor_sync(FULL, hi_r, o));
    }
    if (lane == 0) {
      int first = 0, count = 0;
      if (lo_r <= hi_r) {
        first = __ldcg(&a.hist[bin_of(lo_r, p, a.nb)]);
        count = __ldcg(&a.hist[bin_of(hi_r, p, a.nb) + 1]) - first;
      }
      a.r0[x] = first;
      a.nbin[x] = count;
      a.items[x] = (static_cast<long long>(count) + n_long + TILE - 1) / TILE;
    }
  }
}

// Work item `it` of phase 6: its group of windows and its reads, as
// indices into the group's list (its binned reads, then the long list).
struct Item {
  long long x;    // group of windows
  int r0, n_bin;  // the group's binned reads
  int v0, m;      // this item's first index and count in the list
};

__device__ Item item_of(const Args& a, long long it, int n_long) {
  long long lo = 0, hi = a.x_groups - 1;  // the last group starting <= it
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (__ldcg(&a.items[mid]) <= it) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  Item t;
  t.x = lo;
  t.r0 = __ldcg(&a.r0[lo]);
  t.n_bin = __ldcg(&a.nbin[lo]);
  t.v0 = static_cast<int>((it - __ldcg(&a.items[lo])) * TILE);
  t.m = min(TILE, t.n_bin + n_long - t.v0);
  return t;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A barrier over the WINDOWS_PER_GROUP threads of thread group g.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(WINDOWS_PER_GROUP));
}

// rbin and rlong go through L1 (cp.async.ca): no SM reads them before
// this phase, so no L1 holds a line of them from before phase 4.
__device__ void load_tile(int2* dst, const Item& t, int gt, const Args& a) {
  for (int j = gt; j < t.m; j += WINDOWS_PER_GROUP) {
    const int v = t.v0 + j;
    cp_async8(&dst[j], v < t.n_bin ? a.rbin + t.r0 + v
                                   : a.rlong + (v - t.n_bin));
  }
}

__device__ __forceinline__ int2 window_of(const Args& a, const Item& t,
                                          int gt) {
  const long long i = t.x * WINDOWS_PER_GROUP + gt;
  return i < a.n_sv ? __ldcg(&a.wbin[i]) : make_int2(0, 0);
}

// Thread group g of the block takes items g, g + GROUPS * gridDim.x, ...
// of the block's turn; no barrier follows, so a group runs out alone.
__device__ void phase_count(const Args& a) {
  __shared__ __align__(16) int2 tile[GROUPS][2][TILE];
  const int g = threadIdx.x / WINDOWS_PER_GROUP;
  const int gt = threadIdx.x % WINDOWS_PER_GROUP;
  const long long n_items = __ldcg(&a.items[a.x_groups]);
  const int n_long = __ldcg(&a.h->n_long);
  const long long stride = static_cast<long long>(gridDim.x) * GROUPS;
  long long it = static_cast<long long>(blockIdx.x) * GROUPS + g;
  if (it < n_items) {
    Item cur = item_of(a, it, n_long);
    load_tile(tile[g][0], cur, gt, a);
    cp_async_commit();
    int2 w = window_of(a, cur, gt);
    for (int k = 0; it < n_items; ++k) {
      const long long next = it + stride;
      Item nxt = cur;
      int2 w_nxt = w;
      if (next < n_items) {  // into the buffer freed at k - 1
        nxt = item_of(a, next, n_long);
        load_tile(tile[g][(k + 1) & 1], nxt, gt, a);
        w_nxt = window_of(a, nxt, gt);
      }
      cp_async_commit();    // (an empty group after the last item)
      cp_async_wait_one();  // this item's tile has landed (this thread's)
      group_sync(g);        // ... and every thread's of the group
      const int2* rd = tile[g][k & 1];
      int cnt = 0;
#pragma unroll 8
      for (int j = 0; j < cur.m; ++j) {
        const int2 r = rd[j];  // same address for the warp: a broadcast
        cnt += (r.x <= w.x) & (r.y >= w.y);
      }
      const long long i = cur.x * WINDOWS_PER_GROUP + gt;
      if (i < a.n_sv && cnt != 0) {
        atomicAdd(&a.out[__ldcg(&a.wperm[i])], cnt);
      }
      group_sync(g);  // the tile is consumed before item k + 2 reuses it
      it = next;
      cur = nxt;
      w = w_nxt;
    }
  }
  if (gt == 0) atomicMax(&a.h->stamp[PHASE_STAMPS - 1], clock_ns());
}

__global__ void __launch_bounds__(THREADS) cover_count_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: every block
  phase_zero(a);
  stamp(a, 0);
  grid.sync();
  phase_stats(a);
  grid.sync();
  stamp(a, 1);
  phase_hist(a);
  grid.sync();
  stamp(a, 2);
  scan<int>(grid, a.hist, 2LL * a.nb, a.partial);
  grid.sync();
  stamp(a, 3);
  phase_scatter(a);
  grid.sync();
  stamp(a, 4);
  phase_ranges(a);
  grid.sync();
  scan<long long>(grid, a.items, a.x_groups, a.partial);
  grid.sync();
  stamp(a, 5);
  phase_count(a);
}

}  // namespace

// Bytes of scratch that cutesv_cover_count needs for these sizes.
extern "C" size_t cutesv_cover_scratch_bytes(int n_sv, int n_reads) {
  if (n_sv < 0 || n_reads < 0) return 0;
  return layout(n_sv, n_reads).bytes;
}

// out[w] += #{r : st[r] <= sv_s[w] && en[r] >= sv_e[w]} over all reads, on
// the current device, enqueued on `stream` as one cooperative launch.
extern "C" int cutesv_cover_count(const void* sv_s, const void* sv_e,
                                  int n_sv, const void* st, const void* en,
                                  int n_reads, void* scratch,
                                  size_t scratch_bytes, void* out,
                                  void* stream) {
  if (n_sv <= 0 || n_reads <= 0) return static_cast<int>(cudaSuccess);
  const Layout l = layout(n_sv, n_reads);
  if (scratch == nullptr || scratch_bytes < l.bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the blocks that can be resident at once on this device, asked once
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cover_count_kernel, THREADS, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm < MAX_GRID ? sms * per_sm : MAX_GRID;
  }
  // every resident block, or one per THREADS reads and windows if that is
  // fewer (a small call keeps its barriers cheap)
  const long long want =
      (static_cast<long long>(n_reads) + n_sv + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(want < resident[dev] ? want
                                                         : resident[dev]);
  char* base = static_cast<char*>(scratch);
  Args a;
  a.sv_s = static_cast<const int32_t*>(sv_s);
  a.sv_e = static_cast<const int32_t*>(sv_e);
  a.st = static_cast<const int32_t*>(st);
  a.en = static_cast<const int32_t*>(en);
  a.n_sv = n_sv;
  a.n_reads = n_reads;
  a.nb = l.nb;
  a.x_groups = l.x_groups;
  a.h = reinterpret_cast<Header*>(base);
  a.hist = reinterpret_cast<int*>(base + l.hist);
  a.rank = reinterpret_cast<int*>(base + l.rank);
  a.rbin = reinterpret_cast<int2*>(base + l.rbin);
  a.rlong = reinterpret_cast<int2*>(base + l.rlong);
  a.wbin = reinterpret_cast<int2*>(base + l.wbin);
  a.wperm = reinterpret_cast<int*>(base + l.wperm);
  a.r0 = reinterpret_cast<int*>(base + l.r0);
  a.nbin = reinterpret_cast<int*>(base + l.nbin);
  a.items = reinterpret_cast<long long*>(base + l.items);
  a.partial = reinterpret_cast<long long*>(base + l.partial);
  a.out = static_cast<int32_t*>(out);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cover_count_kernel), dim3(grid),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
