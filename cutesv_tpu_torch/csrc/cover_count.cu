// Cover count for genotype read support, hand-written for Hopper (sm_90a).
//
// Replaces cutesv_tpu/ops/pallas_sweep.py::_cover_kernel (the one Pallas
// kernel of the JAX package). For every SV window w it counts the reads r
// with  start[r] <= s[w]  and  end[r] >= e[w]  over coordinates the host
// has already doubled (ops/sweep.py::scale_and_pad), in int32.
//
// What bounds it: the int32 issue rate. Each (window, read) pair costs
// 3-4 integer operations (two compares, the add, and their AND unless it
// folds into the second compare's predicate), so S windows x R reads is
// 3*S*R to 4*S*R operations against 12*S + 8*R bytes in and out: at
// genome scale (32,768 x 1,500,000) that is ~1.5e11-2e11 operations and
// ~12 MB.
// Reads are re-read by every block from L2; device memory is not the
// limit.
//
// Design. The TPU kernel held one 131k-read block resident in VMEM and
// walked SV tiles over a sequential grid; that shape is not copied.
//   * grid.x walks windows: each thread holds WPT windows in registers
//     (THREADS*WPT windows per block), so one shared-memory read of a
//     read's (start, end) feeds WPT compare pairs;
//   * grid.y splits the reads, so that even a few thousand windows fill
//     every SM (the launcher reads the device's SM count and aims for
//     BLOCKS_PER_SM blocks on each); each block streams its read range
//     through shared memory in TILE-read tiles with coalesced loads,
//     accumulates int32 counts in registers, and adds them into `out`
//     with one atomicAdd per window (integer adds, so the result does
//     not depend on order);
//   * one launch covers all reads (the TPU's 131,072-read chunking only
//     served one compiled shape). `out` must be zeroed by the caller.
// The launch is asynchronous on the given stream, allocates nothing, and
// returns cudaGetLastError().
//
// A sort-plus-search formulation with fewer than S*R operations is a
// later redesign; this kernel is the plain dominance count done right.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WPT = 8;                       // windows per thread
constexpr int WINDOWS_PER_BLOCK = THREADS * WPT;
constexpr int TILE = 2048;                   // reads per shared tile (16 KB)

__global__ void __launch_bounds__(THREADS)
cover_count_kernel(const int32_t* __restrict__ sv_s,
                   const int32_t* __restrict__ sv_e, int n_sv,
                   const int32_t* __restrict__ st,
                   const int32_t* __restrict__ en, int n_reads,
                   int reads_per_split, int32_t* __restrict__ out) {
  __shared__ int2 tile[TILE];

  const int w0 = blockIdx.x * WINDOWS_PER_BLOCK + threadIdx.x;
  int ws[WPT], we[WPT], cnt[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = w0 + k * THREADS;
    // out-of-range windows get the never-covered sentinel and are not
    // written back
    ws[k] = w < n_sv ? sv_s[w] : INT_MIN;
    we[k] = w < n_sv ? sv_e[w] : INT_MAX;
    cnt[k] = 0;
  }

  const int r_begin = blockIdx.y * reads_per_split;
  const int r_end = min(n_reads, r_begin + reads_per_split);
  for (int r0 = r_begin; r0 < r_end; r0 += TILE) {
    const int m = min(TILE, r_end - r0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < m; j += THREADS) {
      tile[j] = make_int2(st[r0 + j], en[r0 + j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const int2 rd = tile[j];  // same address for the warp: a broadcast
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        cnt[k] += (rd.x <= ws[k]) & (rd.y >= we[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = w0 + k * THREADS;
    if (w < n_sv && cnt[k] != 0) atomicAdd(&out[w], cnt[k]);
  }
}

constexpr int BLOCKS_PER_SM = 4;             // blocks to aim for, per SM
constexpr long long MAX_GRID_Y = 65535;

// Reads of one block: split the reads so that about BLOCKS_PER_SM blocks
// per SM run, in whole tiles, within grid.y's limit.
long long reads_per_split(long long x_blocks, long long n_reads, int sms) {
  const long long tiles = (n_reads + TILE - 1) / TILE;
  long long splits = BLOCKS_PER_SM * static_cast<long long>(sms) / x_blocks;
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  long long per = (n_reads + splits - 1) / splits;
  per = (per + TILE - 1) / TILE * TILE;
  while ((n_reads + per - 1) / per > MAX_GRID_Y) per *= 2;
  return per;
}

}  // namespace

// out[w] += #{r : st[r] <= sv_s[w] && en[r] >= sv_e[w]} over all reads,
// on the current device.
extern "C" int cutesv_cover_count(const void* sv_s, const void* sv_e,
                                  int n_sv, const void* st, const void* en,
                                  int n_reads, void* out, void* stream) {
  if (n_sv <= 0 || n_reads <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long x_blocks =
      (n_sv + WINDOWS_PER_BLOCK - 1) / WINDOWS_PER_BLOCK;
  const long long per = reads_per_split(x_blocks, n_reads, sms);
  const dim3 grid(static_cast<unsigned>(x_blocks),
                  static_cast<unsigned>((n_reads + per - 1) / per));
  cover_count_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv_s), static_cast<const int32_t*>(sv_e),
      n_sv, static_cast<const int32_t*>(st), static_cast<const int32_t*>(en),
      n_reads, static_cast<int>(per), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
