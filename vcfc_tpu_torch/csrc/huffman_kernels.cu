// Hopper order-0 canonical Huffman decode of the .vcfz device route.
//
// Replaces vcfc_tpu/ops/huffman_device.py::decode_bits, an XLA function
// whose heart is three lax.scans (XLA fuses each into one loop; PyTorch
// eager has none, and the plain form in vcfc_tpu_torch/ops/huffman_device.py
// launches a handful of ops a scan step).  It computes exactly what
// decode_bits_plain computes: for B streams of W big-endian 32-bit words
// cut into s1 segments of s2 bits, the (B, s1*s2) int32 plane holding
// ordinal + 1 at each bit that starts a codeword, chained from bit 0, and
// 0 elsewhere.
//
// The design is the card's own, not the scans carried over.  The state of
// the JAX package's recurrence is one-hot: it only ever says where the
// next symbol starts.  So a segment's 15x15 boolean transfer matrix is a
// map from the 15 offsets at which a symbol may start past the segment's
// first bit to the offset of the first start past its end, and folding
// the recurrence over a segment is walking the codewords: pos += len(pos).
//   1. huffman_segment_maps: a warp a (stream, segment).  The warp computes
//      the code lengths of the segment's bits, CHUNK at a time, into shared
//      memory (each bit's 15-bit window from two words, 14 compares with the
//      book's canonical limits); lanes 0-14 then walk from entry offsets
//      0-14 and write the segment's map, 15 bytes.
//   2. huffman_chain: a warp a stream; lane 0 chains the maps from offset
//      0, CHAIN_SEGS segments at a time from shared memory, and writes each
//      segment's entry offset.
//   3. huffman_emit: a warp a (stream, segment).  The warp computes each
//      bit's length and ordinal + 1 into shared memory; lane 0 walks from
//      the segment's entry offset and marks the start bits in a shared
//      bitmask; the warp then writes the chunk's plane, ordinal + 1 at the
//      marked bits and 0 elsewhere, 32 consecutive int32 a store.
//
// Its bound is bytes: the words read once (4 bytes a word) and the plane
// written once (128 bytes a word), 275 MB for a cohort dispatch of 118
// streams x 276 segments of 2,048 bits, 0.083 ms at the H100's 3.35 TB/s.
// This simple design does not reach it: the walks are serial chains of
// shared-memory loads, one a codeword, hidden only by the warps in flight,
// lane 0 walks alone in pass 3, and the lengths are computed twice (passes
// 1 and 3) rather than kept in device memory.
//
// Plain C interface (loaded with ctypes): the entry point launches the
// three kernels on the given stream, allocates nothing (the caller passes
// the segment maps' and entry offsets' scratch), and returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 15;          // window bits, state bits, entry offsets
constexpr int WARPS = 8;         // warps a CTA
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 512;       // bits a warp holds in shared memory at once
constexpr int CHAIN_SEGS = 256;  // segment maps a chain warp holds at once

struct Tables {
  int limits[WIN];      // limits[l-1]: exclusive window bound of lengths <= l
  int idx_adjust[WIN];  // first ordinal of length l minus its first code
};

// The 15-bit window starting at bit p of a row of nwords words, zeros past
// the row's last word.
__device__ __forceinline__ int window15(const uint32_t* row, long long nwords, long long p) {
  const long long w = p >> 5;
  const uint64_t hi = __ldg(row + w);
  const uint64_t lo = w + 1 < nwords ? __ldg(row + w + 1) : 0u;
  return int((((hi << 32) | lo) << (p & 31)) >> (64 - WIN));
}

// 1 + the number of canonical limits the window reaches (1..15).
__device__ __forceinline__ int code_len(int win, const Tables& t) {
  int len = 1;
#pragma unroll
  for (int l = 0; l < WIN - 1; ++l) len += win >= t.limits[l];
  return len;
}

// Pass 1: each (stream, segment)'s map, entry offset k -> the offset past
// the segment's end of the first start a walk from k reaches.
__global__ void __launch_bounds__(THREADS)
huffman_segment_maps(const uint32_t* __restrict__ words, uint8_t* __restrict__ seg_map,
                     long long n_segs, long long s1, long long s2, long long nwords,
                     Tables t) {
  __shared__ uint8_t lens[WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (g >= n_segs) return;
  const long long b = g / s1;
  const uint32_t* row = words + b * nwords;
  const long long seg0 = (g - b * s1) * s2, seg1 = seg0 + s2;
  long long pos = seg0 + lane;  // lanes 0-14 walk; a start may lie past seg1
  for (long long c0 = seg0; c0 < seg1; c0 += CHUNK) {
    const int n = int(min(static_cast<long long>(CHUNK), seg1 - c0));
    for (int i = lane; i < n; i += 32) lens[warp][i] = uint8_t(code_len(window15(row, nwords, c0 + i), t));
    __syncwarp();
    if (lane < WIN) {
      const long long end = c0 + n;
      while (pos < end) pos += lens[warp][pos - c0];
    }
    __syncwarp();
  }
  if (lane < WIN) seg_map[g * WIN + lane] = uint8_t(pos - seg1);
}

// Pass 2: each segment's entry offset, chaining the maps from offset 0.
__global__ void __launch_bounds__(THREADS)
huffman_chain(const uint8_t* __restrict__ seg_map, uint8_t* __restrict__ seg_in, long long B,
              long long s1) {
  __shared__ uint8_t maps[WARPS][CHAIN_SEGS * WIN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (b >= B) return;
  const uint8_t* m = seg_map + b * s1 * WIN;
  int off = 0;
  for (long long c0 = 0; c0 < s1; c0 += CHAIN_SEGS) {
    const int n = int(min(static_cast<long long>(CHAIN_SEGS), s1 - c0));
    for (int i = lane; i < n * WIN; i += 32) maps[warp][i] = m[c0 * WIN + i];
    __syncwarp();
    if (lane == 0) {
      for (int s = 0; s < n; ++s) {
        seg_in[b * s1 + c0 + s] = uint8_t(off);
        off = maps[warp][s * WIN + off];
      }
    }
    __syncwarp();
  }
}

// Pass 3: the plane, ordinal + 1 at each start bit reached from the
// segment's entry offset, 0 elsewhere.
__global__ void __launch_bounds__(THREADS)
huffman_emit(const uint32_t* __restrict__ words, const uint8_t* __restrict__ seg_in,
             int32_t* __restrict__ out, long long n_segs, long long s1, long long s2,
             long long nwords, Tables t) {
  __shared__ uint8_t lens[WARPS][CHUNK];
  __shared__ int32_t vals[WARPS][CHUNK];
  __shared__ uint32_t starts[WARPS][CHUNK / 32];
  __shared__ int adjust[WIN];
  if (threadIdx.x < WIN) {
    int a = 0;  // constant indices: the tables stay in the parameter bank
#pragma unroll
    for (int l = 0; l < WIN; ++l)
      if (threadIdx.x == l) a = t.idx_adjust[l];
    adjust[threadIdx.x] = a;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (g >= n_segs) return;
  const long long b = g / s1;
  const uint32_t* row = words + b * nwords;
  int32_t* plane = out + b * nwords * 32;
  const long long seg0 = (g - b * s1) * s2, seg1 = seg0 + s2;
  long long pos = seg0 + seg_in[g];
  for (long long c0 = seg0; c0 < seg1; c0 += CHUNK) {
    const int n = int(min(static_cast<long long>(CHUNK), seg1 - c0));
    for (int i = lane; i < n; i += 32) {
      const int win = window15(row, nwords, c0 + i);
      const int len = code_len(win, t);
      lens[warp][i] = uint8_t(len);
      vals[warp][i] = (win >> (WIN - len)) + adjust[len - 1] + 1;
    }
    for (int i = lane; i < CHUNK / 32; i += 32) starts[warp][i] = 0;
    __syncwarp();
    if (lane == 0) {
      const long long end = c0 + n;
      while (pos < end) {
        const int r = int(pos - c0);
        starts[warp][r >> 5] |= 1u << (r & 31);
        pos += lens[warp][r];
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32)
      plane[c0 + i] = (starts[warp][i >> 5] >> (i & 31)) & 1u ? vals[warp][i] : 0;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// words: (B, nwords) big-endian words as int32; out: (B, nwords * 32)
// int32; seg_map: (B * s1 * 15) bytes and seg_in: (B * s1) bytes of
// scratch; limits, idx_adjust: 15 int32 each, host memory.  nwords * 32
// must equal s1 * s2.
int vcfc_cuda_huffman_decode_bits(const void* words, void* out, void* seg_map, void* seg_in,
                                  long long B, long long nwords, long long s1, long long s2,
                                  const int* limits, const int* idx_adjust, void* stream) {
  if (B < 1 || nwords < 1 || s1 < 1 || s2 < 1 || nwords * 32 != s1 * s2)
    return int(cudaErrorInvalidValue);
  Tables t;
  for (int l = 0; l < WIN; ++l) {
    t.limits[l] = limits[l];
    t.idx_adjust[l] = idx_adjust[l];
  }
  const auto* w = static_cast<const uint32_t*>(words);
  auto* map = static_cast<uint8_t*>(seg_map);
  auto* in = static_cast<uint8_t*>(seg_in);
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_segs = B * s1;
  const long long seg_blocks = (n_segs + WARPS - 1) / WARPS;
  const long long chain_blocks = (B + WARPS - 1) / WARPS;
  if (seg_blocks > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  huffman_segment_maps<<<unsigned(seg_blocks), THREADS, 0, s>>>(w, map, n_segs, s1, s2, nwords, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  huffman_chain<<<unsigned(chain_blocks), THREADS, 0, s>>>(map, in, B, s1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  huffman_emit<<<unsigned(seg_blocks), THREADS, 0, s>>>(w, in, static_cast<int32_t*>(out), n_segs,
                                                        s1, s2, nwords, t);
  return int(cudaGetLastError());
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
