// Hopper RLE kernels of the .vcfc codec: K1 encode, K2 decode, and their
// text-fused forms K3 (classify + encode) and K4 (decode + render).
//
// K1 (rle_encode_kernel) replaces vcfc_tpu/ops/pallas_rle.py::_encode_kernel
// (_encode_body); K2 (rle_decode_kernel) replaces ::_decode_kernel
// (_decode_body); K3 (text_encode_kernel) replaces ::_text_encode_kernel
// (_classify_words, then _encode_body); K4 (text_decode_kernel) replaces
// ::_text_decode_kernel (_decode_body, then _render_words).  They compute
// exactly what vcfc_tpu/ops/rle.py's rle_encode / rle_decode /
// text_rle_encode / text_rle_decode compute; the plain PyTorch versions in
// vcfc_tpu_torch/ops/rle.py are the spec they are tested against.
//
// What bounds them: per genotype cell K1 and K2 read one byte and write one
// byte, K3 reads a 4-byte "a|b\t" word and writes one flag byte, K4 reads
// one flag byte and writes a code byte and a word, and each does a few
// dozen integer operations per cell, so all four are bound by
// device-memory bandwidth.  The design therefore touches every cell once:
// one CTA per row walks the row in tiles of blockDim x VEC cells, each
// thread owns VEC consecutive cells (16-byte loads and stores where the
// row is 16-byte aligned), and the row scan is a per-thread serial scan, a
// warp-shuffle scan and a shared-memory combine of the warp totals, with a
// carry from tile to tile (left to right for K1/K3, right to left for
// K2/K4).  K1 and K3 share that scan (encode_tile), K2 and K4 theirs
// (decode_tile).  No intermediate plane goes to device memory: K3
// classifies its words into codes in registers, K4 renders its words from
// the codes in registers.
//
// Plain C interface (loaded with ctypes): every entry point launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 16;  // cells per thread per tile: one uint4 of bytes
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CODE_ESCAPE = 4;

// Loads the VEC cells at row[p, p + VEC); cells at or past w read as 0.
__device__ __forceinline__ void load_cells(const uint8_t* row, int p, int w,
                                           bool vec_ok, uint8_t v[VEC]) {
  if (vec_ok && p + VEC <= w) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + p);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p + k < w ? row[p + k] : 0;
  }
}

// Stores the VEC cells to row[p, p + VEC), dropping those at or past w.
__device__ __forceinline__ void store_cells(uint8_t* row, int p, int w,
                                            bool vec_ok, const uint8_t v[VEC]) {
  if (vec_ok && p + VEC <= w) {
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < VEC; ++k) words[k >> 2] |= uint32_t(v[k]) << (8 * (k & 3));
    *reinterpret_cast<uint4*>(row + p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (p + k < w) row[p + k] = v[k];
  }
}

// The 4-byte-word forms: four 16-byte loads or stores where aligned.
__device__ __forceinline__ void load_words(const uint32_t* row, int p, int w,
                                           bool vec_ok, uint32_t v[VEC]) {
  if (vec_ok && p + VEC <= w) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(row + p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p + k < w ? row[p + k] : 0;
  }
}

__device__ __forceinline__ void store_words(uint32_t* row, int p, int w,
                                            bool vec_ok, const uint32_t v[VEC]) {
  if (vec_ok && p + VEC <= w) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<uint4*>(row + p)[q] =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
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

// A little-endian word b0 | b1 << 8 | b2 << 16 | sep << 24 is 2a + b when
// b0 = a and b2 = b are '0' or '1' and b1 is '|', and an escape otherwise
// (the reference's four-GT match, compress.cpp:126-170).
__device__ __forceinline__ int classify_word(uint32_t t) {
  const int b0 = t & 0xFF, b1 = (t >> 8) & 0xFF, b2 = (t >> 16) & 0xFF;
  const bool valid = ((b0 - 48) & ~1) == 0 && b1 == 124 && ((b2 - 48) & ~1) == 0;
  return valid ? (b0 - 48) * 2 + (b2 - 48) : CODE_ESCAPE;
}

// A code's word: "?|?" for an escape, separator '\n' on the row's last
// sample and '\t' elsewhere.
__device__ __forceinline__ uint32_t render_word(int code, bool last) {
  const uint32_t b0 = code == CODE_ESCAPE ? 63 : 48 + (code >> 1);
  const uint32_t b2 = code == CODE_ESCAPE ? 63 : 48 + (code & 1);
  return b0 | (124u << 8) | (b2 << 16) | ((last ? 10u : 9u) << 24);
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

// One tile of the encode scan (K1, K3).  flags[i] = base(c) | (rem + 1) at
// each segment's last cell i < n and 0 elsewhere, where a run starts where
// the code changes or either neighbour is an escape, d = i - run_start,
// rem = d % 127 for code 0 and d % 31 otherwise, and a segment starts
// where rem == 0.  count gathers the segment starts below n.  A cell is a
// segment's last when it is n - 1 or when cell i + 1 (< n) starts a
// segment; that needs only the next code: cell i + 1 starts a segment iff
// it starts a run or rem(i) == cap - 1.
//
// c holds the thread's VEC codes at [p0, p0 + VEC), prev the code at
// p0 - 1 (-1 at the row start) and next the code at p0 + VEC (-1 past the
// row).  carry (the latest run start left of the tile) and count carry to
// the next tile.  Every thread of the block calls it; active is p0 < w.
__device__ __forceinline__ void encode_tile(const uint8_t c[VEC], int prev, int next,
                                            int p0, int w, int n, bool active,
                                            int& carry, int& count, int* s_scan,
                                            uint8_t f[VEC]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int latest = -1;
  if (active) {
    int pc = prev;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
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

#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = 0;
  if (!active) return;
  int pc = prev;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int i = p0 + k;
    const int ck = c[k];
    if (i < w) {
      if (starts_run(ck, pc)) run_start = i;
      const int d = i - run_start;
      const int rem = ck == 0 ? d % 127 : d % 31;
      const int cap = ck == 0 ? 127 : 31;
      if (i < n && rem == 0) ++count;
      const int nc = k + 1 < VEC ? c[k + 1] : next;
      const bool next_boundary =
          i + 1 < n && i + 1 < w && (starts_run(nc, ck) || rem == cap - 1);
      if (next_boundary || i == n - 1) f[k] = uint8_t(flag_base(ck) | (rem + 1));
    }
    pc = ck;
  }
}

// One tile of the decode fill (K2, K4).  Each cell takes the next present
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

// K1: (rows, w) uint8 codes -> flags, nseg.
__global__ void __launch_bounds__(MAX_THREADS)
rle_encode_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ flags,
                  int32_t* __restrict__ nseg, int w, int n, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = codes + int64_t(blockIdx.x) * w;
  uint8_t* out = flags + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  int carry = -1, count = 0;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t c[VEC], f[VEC];
    int prev = -1, next = -1;
    if (active) {
      load_cells(in, p0, w, vec_ok, c);
      prev = p0 > 0 ? in[p0 - 1] : -1;  // -1: cell 0 always starts a run
      next = p0 + VEC < w ? in[p0 + VEC] : -1;
    }
    encode_tile(c, prev, next, p0, w, n, active, carry, count, s_scan, f);
    if (active) store_cells(out, p0, w, vec_ok, f);
  }
  const int total = block_sum(count, s_sum);
  if (threadIdx.x == 0) nseg[blockIdx.x] = total;
}

// K3: (rows, w) int32 words -> flags, nseg, seps_ok.  Each word, and the
// neighbour words of K1's look-behind and look-ahead, is classified in
// registers.  seps_ok is 1 iff every separator byte before sample n - 1 is
// a tab (so 1 for n <= 1), by a block sum of the bad separators.
__global__ void __launch_bounds__(MAX_THREADS)
text_encode_kernel(const uint32_t* __restrict__ text, uint8_t* __restrict__ flags,
                   int32_t* __restrict__ nseg, int32_t* __restrict__ seps_ok,
                   int w, int n, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  __shared__ int s_bad[MAX_WARPS];
  const uint32_t* in = text + int64_t(blockIdx.x) * w;
  uint8_t* out = flags + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  int carry = -1, count = 0, bad = 0;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t c[VEC], f[VEC];
    int prev = -1, next = -1;
    if (active) {
      uint32_t t[VEC];
      load_words(in, p0, w, vec_ok, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        c[k] = uint8_t(classify_word(t[k]));
        if (p0 + k < w && p0 + k < n - 1 && (t[k] >> 24) != 9) ++bad;
      }
      prev = p0 > 0 ? classify_word(in[p0 - 1]) : -1;
      next = p0 + VEC < w ? classify_word(in[p0 + VEC]) : -1;
    }
    encode_tile(c, prev, next, p0, w, n, active, carry, count, s_scan, f);
    if (active) store_cells(out, p0, w, vec_ok, f);
  }
  const int total = block_sum(count, s_sum);
  const int total_bad = block_sum(bad, s_bad);
  if (threadIdx.x == 0) {
    nseg[blockIdx.x] = total;
    seps_ok[blockIdx.x] = total_bad == 0;
  }
}

// K2: (rows, w) uint8 flags -> codes, decoded.
__global__ void __launch_bounds__(MAX_THREADS)
rle_decode_kernel(const uint8_t* __restrict__ flags, uint8_t* __restrict__ codes,
                  int32_t* __restrict__ decoded, int w, int n, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = flags + int64_t(blockIdx.x) * w;
  uint8_t* out = codes + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  int carry = 0xFF, sum = 0;
  for (int t0 = (w - 1) / tile * tile; t0 >= 0; t0 -= tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t f[VEC], c[VEC];
    if (active) load_cells(in, p0, w, vec_ok, f);
    decode_tile(f, p0, n, active, carry, sum, s_scan, c);
    if (active) store_cells(out, p0, w, vec_ok, c);
  }
  const int total = block_sum(sum, s_sum);
  if (threadIdx.x == 0) decoded[blockIdx.x] = total;
}

// K4: (rows, w) uint8 flags -> words, codes, decoded.  The words are
// rendered from the codes in registers; the '\n' goes at n - 1 whatever
// that cell holds.
__global__ void __launch_bounds__(MAX_THREADS)
text_decode_kernel(const uint8_t* __restrict__ flags, uint32_t* __restrict__ text,
                   uint8_t* __restrict__ codes, int32_t* __restrict__ decoded,
                   int w, int n, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = flags + int64_t(blockIdx.x) * w;
  uint8_t* out = codes + int64_t(blockIdx.x) * w;
  uint32_t* words = text + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  int carry = 0xFF, sum = 0;
  for (int t0 = (w - 1) / tile * tile; t0 >= 0; t0 -= tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t f[VEC], c[VEC];
    if (active) load_cells(in, p0, w, vec_ok, f);
    decode_tile(f, p0, n, active, carry, sum, s_scan, c);
    if (active) {
      store_cells(out, p0, w, vec_ok, c);
      uint32_t t[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = render_word(c[k], p0 + k == n - 1);
      store_words(words, p0, w, vec_ok, t);
    }
  }
  const int total = block_sum(sum, s_sum);
  if (threadIdx.x == 0) decoded[blockIdx.x] = total;
}

// One thread per VEC cells of a row, in whole warps, at most MAX_THREADS:
// narrow rows leave no thread without a cell.
int block_threads(int w) {
  const int needed = (w + VEC - 1) / VEC;
  const int warps = (needed + 31) / 32;
  return warps * 32 < MAX_THREADS ? warps * 32 : MAX_THREADS;
}

// 16-byte accesses need whole uint4s per thread and 16-byte aligned rows.
bool vec_aligned(int w, const void* a, const void* b, const void* c = nullptr) {
  return w % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

bool bad_shape(long long rows, int width) {
  return rows <= 0 || rows > INT_MAX || width <= 0;
}

}  // namespace

extern "C" {

// codes, flags: (rows, width) uint8, row-major; nseg: (rows,) int32.
int vcfc_cuda_rle_encode(const void* codes, void* flags, void* nseg, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(flags);
  rle_encode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), width, n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, row-major; decoded: (rows,) int32.
int vcfc_cuda_rle_decode(const void* flags, void* codes, void* decoded, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* out = static_cast<uint8_t*>(codes);
  rle_decode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(decoded), width, n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// text: (rows, width) int32 words, flags: (rows, width) uint8, row-major;
// nseg, seps_ok: (rows,) int32.
int vcfc_cuda_text_encode(const void* text, void* flags, void* nseg, void* seps_ok,
                          long long rows, int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint32_t*>(text);
  auto* out = static_cast<uint8_t*>(flags);
  text_encode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), static_cast<int32_t*>(seps_ok), width,
      n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, text: (rows, width) int32 words,
// row-major; decoded: (rows,) int32.
int vcfc_cuda_text_decode(const void* flags, void* text, void* codes, void* decoded,
                          long long rows, int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* words = static_cast<uint32_t*>(text);
  auto* out = static_cast<uint8_t*>(codes);
  text_decode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, words, out, static_cast<int32_t*>(decoded), width, n_samples,
      vec_aligned(width, in, words, out));
  return int(cudaGetLastError());
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
