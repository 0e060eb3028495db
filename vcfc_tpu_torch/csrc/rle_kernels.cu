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
// dozen integer operations per cell, which at the card's INT32 rate take
// longer than the bytes take at its memory rate.  The design therefore
// touches every cell once: one CTA per row walks the row in tiles of
// blockDim x VEC cells, each thread owns VEC consecutive cells (16-byte
// loads and stores where the row is 16-byte aligned), and the row scan is
// a per-thread serial scan, a warp-shuffle scan and a shared-memory
// combine of the warp totals, with a carry from tile to tile (left to
// right for K1/K3, right to left for K2/K4).  K1 and K3 share that scan
// (encode_tile in rle_tile.cuh), K2 and K4 theirs (decode_tile).  No
// intermediate plane goes to device memory: K3 classifies its words into
// codes in registers, K4 renders its words from the codes in registers.
//
// Plain C interface (loaded with ctypes): every entry point launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include "rle_tile.cuh"

namespace {

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
    encode_tile<VEC>(c, prev, next, p0, w, n, active, carry, count, s_scan, f);
    if (active) store_cells<VEC>(out, p0, w, vec_ok, f);
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
    if (active) load_cells<VEC>(in, p0, w, vec_ok, f);
    decode_tile(f, p0, n, active, carry, sum, s_scan, c);
    if (active) store_cells<VEC>(out, p0, w, vec_ok, c);
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
    if (active) load_cells<VEC>(in, p0, w, vec_ok, f);
    decode_tile(f, p0, n, active, carry, sum, s_scan, c);
    if (active) {
      store_cells<VEC>(out, p0, w, vec_ok, c);
      uint32_t t[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = render_word(c[k], p0 + k == n - 1);
      store_words(words, p0, w, vec_ok, t);
    }
  }
  const int total = block_sum(sum, s_sum);
  if (threadIdx.x == 0) decoded[blockIdx.x] = total;
}

}  // namespace

extern "C" {

// codes, flags: (rows, width) uint8, row-major; nseg: (rows,) int32.
int vcfc_cuda_rle_encode(const void* codes, void* flags, void* nseg, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(flags);
  rle_encode_kernel<VEC><<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
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
