// Tile building blocks of the ablation probes (probe_kernels.cu): cell
// loads and stores, the flag-byte tables, the encode scan of one tile
// (encode_tile), the decode fill of one tile (decode_tile) and the tile
// encode kernel, templated on the number of cells a thread owns (probe C4;
// at 16 cells it is the design K1 had before its warp-per-row kernel).
// The kernels K1-K4 (rle_kernels.cu) take only the constants and the
// launch checks at the end.
//
// One CTA walks one row in tiles of blockDim x V cells; each thread owns V
// consecutive cells.  A row scan is a per-thread serial scan, a
// warp-shuffle scan and a shared-memory combine of the warp totals, with a
// carry from tile to tile (left to right for the encode, right to left for
// the decode).  Every kernel that calls encode_tile or decode_tile gets
// K1's or K2's run boundaries at every tile and thread edge.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 16;  // C2/C3/C5/C6/C7 cells per thread per tile: one uint4 of bytes
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CODE_ESCAPE = 4;

// Reads V bytes at p (4-, 8- or 16-byte aligned for V = 4, 8, 16) as
// little-endian 32-bit words.
template <int V>
__device__ __forceinline__ void load_vector(const uint8_t* p, uint32_t words[(V + 3) / 4]) {
  if constexpr (V == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    words[0] = q.x, words[1] = q.y, words[2] = q.z, words[3] = q.w;
  } else if constexpr (V == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    words[0] = q.x, words[1] = q.y;
  } else {
    words[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vector(uint8_t* p, const uint32_t words[(V + 3) / 4]) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = words[0];
  }
}

// Loads the V cells at row[p, p + V); cells at or past w read as 0.  With
// vec_ok, whole groups of V >= 4 cells load as one vector.
template <int V>
__device__ __forceinline__ void load_cells(const uint8_t* row, int p, int w, bool vec_ok,
                                           uint8_t v[V]) {
  if (V >= 4 && vec_ok && p + V <= w) {
    uint32_t words[(V + 3) / 4];
    load_vector<V>(row + p, words);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p + k < w ? row[p + k] : 0;
  }
}

// Stores the V cells to row[p, p + V), dropping those at or past w.
template <int V>
__device__ __forceinline__ void store_cells(uint8_t* row, int p, int w, bool vec_ok,
                                            const uint8_t v[V]) {
  if (V >= 4 && vec_ok && p + V <= w) {
    uint32_t words[(V + 3) / 4] = {};
#pragma unroll
    for (int k = 0; k < V; ++k) words[k >> 2] |= uint32_t(v[k]) << (8 * (k & 3));
    store_vector<V>(row + p, words);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (p + k < w) row[p + k] = v[k];
  }
}

// Flag-byte base per genotype code (utils.hpp:44-56 of the reference).
__device__ __forceinline__ int flag_base(int c) {
  return c == 0 ? 0x00 : c == 1 ? 0xA0 : c == 2 ? 0xC0 : c == 3 ? 0x80 : 0xE0;
}

__device__ __forceinline__ int flag_code(int f) {
  if ((f & 0x80) == 0) return 0;
  const int masked = f & 0xE0;
  return masked == 0xE0 ? CODE_ESCAPE : masked == 0xA0 ? 1 : masked == 0xC0 ? 2 : 3;
}

__device__ __forceinline__ int flag_run_len(int f) {
  if (f == 0) return 0;
  if ((f & 0x80) == 0) return f & 0x7F;
  return (f & 0xE0) == 0xE0 ? 1 : f & 0x1F;
}

__device__ __forceinline__ bool starts_run(int c, int prev) {
  return c != prev || c == CODE_ESCAPE || prev == CODE_ESCAPE;
}

__device__ __forceinline__ int block_sum(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
  if (lane == 0) s_warp[warp] = x;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < int(blockDim.x >> 5); ++i) total += s_warp[i];
  return total;
}

// The scan half of one encode tile: returns the latest run start left of
// the thread's first cell p0, and moves carry (the latest run start left
// of the tile) past this tile.  A run starts where the code changes or
// either neighbour is an escape.  c holds the thread's V codes at
// [p0, p0 + V) and prev the code at p0 - 1 (-1 at the row start, so cell 0
// always starts a run).  Every thread of the block calls it; active is
// p0 < w.
template <int V>
__device__ __forceinline__ int scan_tile(const uint8_t c[V], int prev, int p0, int w,
                                         bool active, int& carry, int* s_scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int latest = -1;
  if (active) {
    int pc = prev;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (p0 + k < w && starts_run(c[k], pc)) latest = p0 + k;
      pc = c[k];
    }
  }
  // exclusive prefix max of the threads' latest run starts
  int incl = latest;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = max(incl, y);
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? s_scan[lane] : -1;
#pragma unroll
    for (int off = 1; off < MAX_WARPS; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x = max(x, y);
    }
    if (lane < nwarps) s_scan[lane] = x;
  }
  __syncthreads();
  int run_start = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) run_start = -1;
  if (warp > 0) run_start = max(run_start, s_scan[warp - 1]);
  run_start = max(run_start, carry);
  carry = max(carry, s_scan[nwarps - 1]);
  __syncthreads();  // s_scan is rewritten by the next tile
  return run_start;
}

// One tile of the encode scan (C3, C4, C6).  flags[i] = base(c) | (rem + 1) at
// each segment's last cell i < n and 0 elsewhere, where d = i - run_start,
// rem = d % 127 for code 0 and d % 31 otherwise, and a segment starts
// where rem == 0.  count gathers the segment starts below n.  A cell is a
// segment's last when it is n - 1 or when cell i + 1 (< n) starts a
// segment; that needs only the next code: cell i + 1 starts a segment iff
// it starts a run or rem(i) == cap - 1.
//
// c, prev, p0, w, active, carry as for scan_tile; next is the code at
// p0 + V (-1 past the row).  count carries to the next tile.
template <int V>
__device__ __forceinline__ void encode_tile(const uint8_t c[V], int prev, int next, int p0,
                                            int w, int n, bool active, int& carry, int& count,
                                            int* s_scan, uint8_t f[V]) {
  int run_start = scan_tile<V>(c, prev, p0, w, active, carry, s_scan);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = 0;
  if (!active) return;
  int pc = prev;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = p0 + k;
    const int ck = c[k];
    if (i < w) {
      if (starts_run(ck, pc)) run_start = i;
      const int d = i - run_start;
      const int rem = ck == 0 ? d % 127 : d % 31;
      const int cap = ck == 0 ? 127 : 31;
      if (i < n && rem == 0) ++count;
      const int nc = k + 1 < V ? c[k + 1] : next;
      const bool next_boundary =
          i + 1 < n && i + 1 < w && (starts_run(nc, ck) || rem == cap - 1);
      if (next_boundary || i == n - 1) f[k] = uint8_t(flag_base(ck) | (rem + 1));
    }
    pc = ck;
  }
}

// One tile of the decode fill (C3, C5, C7).  Each cell takes the next present
// flag at or after it (0xFF past the row's last flag, like rle_decode's
// sentinel, so such cells decode as an escape) and its code from that
// flag's bits; sum gathers the run length of every flag below n.  The
// tiles go right to left; inside a tile, an exclusive suffix min over
// (thread << 8 | first flag) keys gives each thread the nearest flag to
// its right, and carry holds the nearest flag right of the tile.
__device__ __forceinline__ void decode_tile(const uint8_t f[VEC], int p0, int n,
                                            bool active, int& carry, int& sum,
                                            int* s_scan, uint8_t c[VEC]) {
  constexpr int NONE = INT_MAX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int key = NONE;
  if (active) {
#pragma unroll
    for (int k = VEC - 1; k >= 0; --k) {
      if (f[k]) key = int(threadIdx.x) << 8 | f[k];
      if (p0 + k < n) sum += flag_run_len(f[k]);
    }
  }
  int incl = key;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl = min(incl, y);
  }
  if (lane == 0) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? s_scan[lane] : NONE;
#pragma unroll
    for (int off = 1; off < MAX_WARPS; off <<= 1) {
      const int y = __shfl_down_sync(FULL, x, off);
      if (lane + off < 32) x = min(x, y);
    }
    if (lane < nwarps) s_scan[lane] = x;
  }
  __syncthreads();
  int right = __shfl_down_sync(FULL, incl, 1);
  if (lane == 31) right = NONE;
  if (warp + 1 < nwarps) right = min(right, s_scan[warp + 1]);
  int cur = right != NONE ? right & 0xFF : carry;
  if (s_scan[0] != NONE) carry = s_scan[0] & 0xFF;
  __syncthreads();  // s_scan is rewritten by the next tile

#pragma unroll
  for (int k = VEC - 1; k >= 0; --k) {
    if (active && f[k]) cur = f[k];
    c[k] = uint8_t(flag_code(cur));
  }
}

// The tile encode at V cells a thread: (rows, w) uint8 codes -> flags,
// nseg, K1's outputs; the blocked-encode probe C4 runs every V.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
rle_encode_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ flags,
                  int32_t* __restrict__ nseg, int w, int n, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = codes + int64_t(blockIdx.x) * w;
  uint8_t* out = flags + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * V;
  int carry = -1, count = 0;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * V;
    const bool active = p0 < w;
    uint8_t c[V], f[V];
    int prev = -1, next = -1;
    if (active) {
      load_cells<V>(in, p0, w, vec_ok, c);
      prev = p0 > 0 ? in[p0 - 1] : -1;  // -1: cell 0 always starts a run
      next = p0 + V < w ? in[p0 + V] : -1;
    }
    encode_tile<V>(c, prev, next, p0, w, n, active, carry, count, s_scan, f);
    if (active) store_cells<V>(out, p0, w, vec_ok, f);
  }
  const int total = block_sum(count, s_sum);
  if (threadIdx.x == 0) nseg[blockIdx.x] = total;
}

// One thread per V cells of a row, in whole warps, at most MAX_THREADS:
// narrow rows leave no thread without a cell.
template <int V = VEC>
int block_threads(int w) {
  const int needed = (w + V - 1) / V;
  const int warps = (needed + 31) / 32;
  return warps * 32 < MAX_THREADS ? warps * 32 : MAX_THREADS;
}

// Vector accesses need whole groups of V cells per row and 16-byte
// aligned planes (V = 16 for K1-K4).
template <int V = VEC>
bool vec_aligned(int w, const void* a, const void* b, const void* c = nullptr) {
  return w % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

bool bad_shape(long long rows, int width) {
  return rows <= 0 || rows > INT_MAX || width <= 0;
}

}  // namespace
