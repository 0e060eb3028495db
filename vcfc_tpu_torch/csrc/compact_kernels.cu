// Hopper stable row compaction of the .vcfz device routes (S1).
//
// Replaces vcfc_tpu/ops/vcfz_device.py::sort_compact (:356), which is not a
// Pallas kernel but an XLA sort: a stable lax.sort_key_val of each row
// keyed by the cell index where the mask is set and INT32_MAX elsewhere.
// What that sort computes is a stable partition, and that is what this
// computes, with no sort: for B rows of n int32 values and a byte mask,
// the row's masked values first, in order, then its unmasked values, in
// order, and the row's masked count.  With c the inclusive cumsum of the
// mask, a masked cell i goes to c - 1 and an unmasked one to count + i - c
// (sort_compact_plain in vcfc_tpu_torch/ops/vcfz_device.py, the spec).
//
// One entry point launches three kernels on the given stream:
//   1. compact_count: a block a (row, chunk of CHUNK cells) counts the
//      chunk's masked cells (a count a thread, then a warp sum by shuffles
//      and a block sum in shared memory).
//   2. compact_scan: a warp a row takes the exclusive scan of its chunks'
//      counts, 32 chunks a step (shuffles), and writes the row's count.
//   3. compact_write: a block a (row, chunk) walks its chunk a tile of 256
//      cells at a time: a ballot and a popcount give each cell's rank among
//      its warp's masked cells, the warps' counts in shared memory give the
//      tile's, so each thread knows the masked cells before its cell in the
//      row and writes its value to its place.
// Values move as raw 32 bits: packed words with bit 31 set stay negative.
//
// Its bound is bytes: each cell's value read (4 bytes) and its mask byte
// read once, the value written (4 bytes), and 4 bytes a row for the count:
// (9, 4).  The cohort's first v1 decode dispatch, 118 rows x 565,248 cells,
// is 600 MB, 0.179 ms at the H100's 3.35 TB/s.  This design reads the mask
// twice (passes 1 and 3) and the writes of a tile scatter to two runs of
// addresses, so it sits above that bound; it is one pass over the bytes and
// no O(n log n) sort.
//
// Plain C interface (loaded with ctypes): the entry point allocates
// nothing (the caller passes the chunks' counts and bases as scratch) and
// returns the first cudaGetLastError() that is not cudaSuccess.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // threads a block in passes 1 and 3
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 4096;  // cells a block of passes 1 and 3 owns
constexpr unsigned FULL = 0xFFFFFFFFu;

// Pass 1: the masked cells of each (row, chunk).
__global__ void __launch_bounds__(THREADS)
compact_count(const uint8_t* __restrict__ mask, int32_t* __restrict__ chunk_count, long long n,
              long long n_chunks) {
  __shared__ int warp_sum[WARPS];
  const long long g = blockIdx.x;  // row * n_chunks + chunk
  const long long row = g / n_chunks;
  const long long c0 = (g - row * n_chunks) * CHUNK;
  const long long c1 = min(c0 + CHUNK, n);
  const uint8_t* m = mask + row * n;
  int sum = 0;
  for (long long i = c0 + threadIdx.x; i < c1; i += THREADS) sum += m[i] != 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(FULL, sum, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sum[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_sum[w];
    chunk_count[g] = total;
  }
}

// Pass 2: each chunk's base (the row's masked cells before it), and the
// row's count.
__global__ void __launch_bounds__(THREADS)
compact_scan(const int32_t* __restrict__ chunk_count, int32_t* __restrict__ chunk_base,
             int32_t* __restrict__ counts, long long B, long long n_chunks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= B) return;  // the whole warp
  const int32_t* c = chunk_count + row * n_chunks;
  int32_t* base = chunk_base + row * n_chunks;
  int carry = 0;
  for (long long k0 = 0; k0 < n_chunks; k0 += 32) {  // the same steps on every lane
    const long long k = k0 + lane;
    const int v = k < n_chunks ? c[k] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (k < n_chunks) base[k] = carry + incl - v;
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) counts[row] = carry;
}

// Pass 3: every value of the chunk to its place in the row.
__global__ void __launch_bounds__(THREADS)
compact_write(const int32_t* __restrict__ values, const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ chunk_base, const int32_t* __restrict__ counts,
              int32_t* __restrict__ out, long long n, long long n_chunks) {
  __shared__ int warp_count[WARPS];
  const long long g = blockIdx.x;
  const long long row = g / n_chunks;
  const long long c0 = (g - row * n_chunks) * CHUNK;
  const long long c1 = min(c0 + CHUNK, n);
  const int32_t* v = values + row * n;
  const uint8_t* m = mask + row * n;
  int32_t* o = out + row * n;
  const long long count = counts[row];
  long long before_tile = chunk_base[g];  // masked cells of the row before the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (long long t0 = c0; t0 < c1; t0 += THREADS) {  // the same steps on every thread
    const long long i = t0 + threadIdx.x;
    const bool in = i < c1;
    const bool set = in && m[i] != 0;
    const unsigned ballot = __ballot_sync(FULL, set);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before_warp = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int x = warp_count[w];
      before_warp += w < warp ? x : 0;
      tile += x;
    }
    // the row's masked cells before cell i
    const long long c = before_tile + before_warp + __popc(ballot & below);
    if (in) o[set ? c : count + i - c] = v[i];
    before_tile += tile;
    __syncthreads();  // every warp has read warp_count
  }
}

}  // namespace

extern "C" {

// values: (B, n) int32; mask: (B, n) bytes, nonzero where set; out: (B, n)
// int32; counts: (B) int32; chunk_count and chunk_base: (B * ceil(n /
// 4096)) int32 of scratch each.
int vcfc_cuda_sort_compact(const void* values, const void* mask, void* out, void* counts,
                           void* chunk_count, void* chunk_base, long long B, long long n,
                           void* stream) {
  if (B < 1 || n < 1) return int(cudaErrorInvalidValue);
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long blocks = B * n_chunks;
  const long long scan_blocks = (B + WARPS - 1) / WARPS;
  if (blocks > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* cc = static_cast<int32_t*>(chunk_count);
  auto* cb = static_cast<int32_t*>(chunk_base);
  auto* cnt = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  compact_count<<<unsigned(blocks), THREADS, 0, s>>>(m, cc, n, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  compact_scan<<<unsigned(scan_blocks), THREADS, 0, s>>>(cc, cb, cnt, B, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  compact_write<<<unsigned(blocks), THREADS, 0, s>>>(static_cast<const int32_t*>(values), m, cb,
                                                     cnt, static_cast<int32_t*>(out), n, n_chunks);
  return int(cudaGetLastError());
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
