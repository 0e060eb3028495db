// Ablation probes of the Hopper RLE kernels K1-K4 (rle_kernels.cu).  C4 at
// 16 cells and C5 are the tile design that K1 and K2 had before they
// became warp-per-row kernels, C6 and C7 that of K3 and K4; C1-C3 each
// keep part of that design's work and cut the rest, so that timing them
// beside C4 and C5 splits where its time went, and timing K1-K4 beside
// C4-C7 measures the rewrite.
// "K1's" and "K2's" below name the function, which both designs compute.
//
// C1 scan_only_kernel<V> replaces scripts/kernel_ceiling.py::enc_scan_only
// and scripts/swar_probe.py's scan-only kern (scan_only_with): K1's run
// scan alone.  Each cell's latest run start (prefix max of "starts a run ?
// i : -1" over the whole row, padding included) is written & 0x7F, and the
// per-row output is cell 0's run start, which is always 0.
// C2 scan_replaced_kernel replaces kernel_ceiling.py::enc_noscan: K1's
// loads, remainders, next-boundary look-ahead, flag bytes, segment count
// and stores, with the scan replaced by run_start = starts a run ? i :
// i & ~127.
// C3 roundtrip_kernel replaces kernel_ceiling.py::rt_kernel: K1 then K2 on
// one row in one CTA, the row's flags in shared memory instead of device
// memory; it writes only the decoded codes and the decoded count.
// C4 rle_encode_kernel<V> (rle_tile.cuh) replaces swar_probe.py's
// full-encode kern (full_encode_with over scan_blocked /
// scan_blocked_strided): the tile design of K1 at V = 1, 2, 4, 8 or 16
// cells a thread.  The TPU probe's "block 2/4" is 2 or 4 cells per lane.
// Its outputs are K1's at every V; at V = 16 it is the tile design K1 had
// before K1 became the warp-per-row kernel of rle_kernels.cu.
// C5 tile_decode_kernel: the tile design K2 had before the same change,
// kept as it was (one CTA per row, decode_tile's suffix min over thread
// keys, two barriers a tile), so that K2 can be timed against it; it
// replaces what K2 replaces, vcfc_tpu/ops/pallas_rle.py::_decode_kernel,
// and its outputs are K2's.
// C6 tile_text_encode_kernel and C7 tile_text_decode_kernel: the tile
// designs K3 and K4 had before they became warp-per-row kernels, kept as
// they were (one CTA per row; C6 classifies each word, and each thread its
// two neighbour words again, with byte extracts and branches, then
// encode_tile; C7 runs decode_tile, then renders each cell with selects),
// so that K3 and K4 can be timed against them.  They replace what K3 and
// K4 replace, vcfc_tpu/ops/pallas_rle.py::_text_encode_kernel and
// ::_text_decode_kernel, and their outputs are K3's and K4's.
//
// What bounds them: like K1 and K2, a byte in and a byte out per cell (C6
// and C7: K3's and K4's bytes) and a few dozen integer operations per
// cell; the probes differ from K1-K4 only in the operations, which is what
// they measure.  Every probe walks a row in tiles with encode_tile's /
// decode_tile's carries, so every run boundary, at tile and thread edges
// too, is K1's, and every fill K2's.  The plain PyTorch versions in
// vcfc_tpu_torch/ops/probe.py and ops/rle.py are the spec.
//
// Plain C interface (loaded with ctypes): every entry point launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include "rle_tile.cuh"

namespace {

// C1: (rows, w) uint8 codes -> latest run start & 0x7F (uint8), and cell
// 0's run start (int32) per row.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
scan_only_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ starts,
                 int32_t* __restrict__ first, int w, bool vec_ok) {
  __shared__ int s_scan[MAX_WARPS];
  const uint8_t* in = codes + int64_t(blockIdx.x) * w;
  uint8_t* out = starts + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * V;
  int carry = -1;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * V;
    const bool active = p0 < w;
    uint8_t c[V], m[V];
    int prev = -1;
    if (active) {
      load_cells<V>(in, p0, w, vec_ok, c);
      prev = p0 > 0 ? in[p0 - 1] : -1;
    }
    int run_start = scan_tile<V>(c, prev, p0, w, active, carry, s_scan);
    if (!active) continue;
    int pc = prev;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (starts_run(c[k], pc)) run_start = p0 + k;
      m[k] = uint8_t(run_start & 0x7F);
      if (k == 0 && p0 == 0) first[blockIdx.x] = run_start;
      pc = c[k];
    }
    store_cells<V>(out, p0, w, vec_ok, m);
  }
}

__device__ __forceinline__ int cap_rem(int c, int d) { return c == 0 ? d % 127 : d % 31; }

// C2: (rows, w) uint8 codes -> flags, nseg, with every cell's run start
// taken as itself where it starts a run and i & ~127 elsewhere.  The
// segment-start test of cell i + 1 needs that cell's own remainder, so
// each thread computes it for its VEC cells and the next thread's first.
__global__ void __launch_bounds__(MAX_THREADS)
scan_replaced_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ flags,
                     int32_t* __restrict__ nseg, int w, int n, bool vec_ok) {
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = codes + int64_t(blockIdx.x) * w;
  uint8_t* out = flags + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  int count = 0;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    if (p0 >= w) continue;
    uint8_t c[VEC], f[VEC];
    load_cells<VEC>(in, p0, w, vec_ok, c);
    const int prev = p0 > 0 ? in[p0 - 1] : -1;
    const int next = p0 + VEC < w ? in[p0 + VEC] : -1;
    int rem[VEC];
    bool boundary[VEC + 1];
    int pc = prev;
#pragma unroll
    for (int k = 0; k <= VEC; ++k) {
      const int i = p0 + k;
      const int ck = k < VEC ? c[k] : next;
      const int r = cap_rem(ck, starts_run(ck, pc) ? 0 : i & 127);
      if (k < VEC) rem[k] = r;
      boundary[k] = i < w && i < n && r == 0;
      pc = ck;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = p0 + k;
      if (boundary[k]) ++count;
      const bool last = boundary[k + 1] || i == n - 1;
      f[k] = i < w && last ? uint8_t(flag_base(c[k]) | (rem[k] + 1)) : 0;
    }
    store_cells<VEC>(out, p0, w, vec_ok, f);
  }
  const int total = block_sum(count, s_sum);
  if (threadIdx.x == 0) nseg[blockIdx.x] = total;
}

// C3: (rows, w) uint8 codes -> decoded codes, decoded count.  K1's tiles
// go left to right and leave the row's flags in dynamic shared memory (w
// bytes); K2's tiles then go right to left over them.  The whole row's
// flags must exist before the first decode tile, since the encode scan
// runs left to right and the decode fill right to left.
__global__ void __launch_bounds__(MAX_THREADS)
roundtrip_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ out,
                 int32_t* __restrict__ decoded, int w, int n, bool vec_ok) {
  extern __shared__ __align__(16) uint8_t s_flags[];
  __shared__ int s_scan[MAX_WARPS];
  __shared__ int s_sum[MAX_WARPS];
  const uint8_t* in = codes + int64_t(blockIdx.x) * w;
  uint8_t* res = out + int64_t(blockIdx.x) * w;
  const int tile = blockDim.x * VEC;
  const bool smem_vec = w % VEC == 0;
  int carry = -1, count = 0;
  for (int t0 = 0; t0 < w; t0 += tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t c[VEC], f[VEC];
    int prev = -1, next = -1;
    if (active) {
      load_cells<VEC>(in, p0, w, vec_ok, c);
      prev = p0 > 0 ? in[p0 - 1] : -1;
      next = p0 + VEC < w ? in[p0 + VEC] : -1;
    }
    encode_tile<VEC>(c, prev, next, p0, w, n, active, carry, count, s_scan, f);
    if (active) store_cells<VEC>(s_flags, p0, w, smem_vec, f);
  }
  __syncthreads();  // every tile's flags are in shared memory
  int fill = 0xFF, sum = 0;
  for (int t0 = (w - 1) / tile * tile; t0 >= 0; t0 -= tile) {
    const int p0 = t0 + threadIdx.x * VEC;
    const bool active = p0 < w;
    uint8_t f[VEC], c[VEC];
    if (active) load_cells<VEC>(s_flags, p0, w, smem_vec, f);
    decode_tile(f, p0, n, active, fill, sum, s_scan, c);
    if (active) store_cells<VEC>(res, p0, w, vec_ok, c);
  }
  const int total = block_sum(sum, s_sum);
  if (threadIdx.x == 0) decoded[blockIdx.x] = total;
}

// C5: (rows, w) uint8 flags -> codes, decoded, in tiles.
__global__ void __launch_bounds__(MAX_THREADS)
tile_decode_kernel(const uint8_t* __restrict__ flags, uint8_t* __restrict__ codes,
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

// C6: (rows, w) int32 words -> flags, nseg, seps_ok (K3's outputs).  Each
// word, and the neighbour words of the look-behind and look-ahead, is
// classified in registers.  seps_ok is 1 iff every separator byte before
// sample n - 1 is a tab (so 1 for n <= 1), by a block sum of the bad
// separators.
__global__ void __launch_bounds__(MAX_THREADS)
tile_text_encode_kernel(const uint32_t* __restrict__ text, uint8_t* __restrict__ flags,
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

// C7: (rows, w) uint8 flags -> words, codes, decoded (K4's outputs).  The
// words are rendered from the codes in registers; the '\n' goes at n - 1
// whatever that cell holds.
__global__ void __launch_bounds__(MAX_THREADS)
tile_text_decode_kernel(const uint8_t* __restrict__ flags, uint32_t* __restrict__ text,
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

// The widest row roundtrip_kernel takes: the block's opt-in shared memory
// less its static shared memory; -1 if the device cannot be queried.
int roundtrip_max_width() {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, roundtrip_kernel) != cudaSuccess)
    return -1;
  return optin - int(attr.sharedSizeBytes);
}

template <int V>
void launch_scan_only(const uint8_t* in, uint8_t* out, int32_t* first, long long rows,
                      int width, cudaStream_t stream) {
  scan_only_kernel<V><<<unsigned(rows), block_threads<V>(width), 0, stream>>>(
      in, out, first, width, vec_aligned<V>(width, in, out));
}

template <int V>
void launch_blocked_encode(const uint8_t* in, uint8_t* out, int32_t* nseg, long long rows,
                           int width, int n, cudaStream_t stream) {
  rle_encode_kernel<V><<<unsigned(rows), block_threads<V>(width), 0, stream>>>(
      in, out, nseg, width, n, vec_aligned<V>(width, in, out));
}

}  // namespace

extern "C" {

// codes, starts: (rows, width) uint8, row-major; first: (rows,) int32;
// cells: 1, 2, 4, 8 or 16.  n_samples is unused, as in the TPU probe.
int vcfc_cuda_probe_scan_only(const void* codes, void* starts, void* first, long long rows,
                              int width, int n_samples, int cells, void* stream) {
  (void)n_samples;
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(starts);
  auto* row_out = static_cast<int32_t*>(first);
  const auto s = cudaStream_t(stream);
  switch (cells) {
    case 1: launch_scan_only<1>(in, out, row_out, rows, width, s); break;
    case 2: launch_scan_only<2>(in, out, row_out, rows, width, s); break;
    case 4: launch_scan_only<4>(in, out, row_out, rows, width, s); break;
    case 8: launch_scan_only<8>(in, out, row_out, rows, width, s); break;
    case 16: launch_scan_only<16>(in, out, row_out, rows, width, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// codes, flags: (rows, width) uint8, row-major; nseg: (rows,) int32.
int vcfc_cuda_probe_scan_replaced(const void* codes, void* flags, void* nseg, long long rows,
                                  int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(flags);
  scan_replaced_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), width, n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

int vcfc_cuda_probe_roundtrip_max_width() { return roundtrip_max_width(); }

// codes, out: (rows, width) uint8, row-major; decoded: (rows,) int32.  A
// width past vcfc_cuda_probe_roundtrip_max_width() is refused.
int vcfc_cuda_probe_roundtrip(const void* codes, void* out, void* decoded, long long rows,
                              int width, int n_samples, void* stream) {
  if (bad_shape(rows, width) || width > roundtrip_max_width())
    return int(cudaErrorInvalidValue);
  if (width > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, width);
    if (err != cudaSuccess) return int(err);
  }
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* res = static_cast<uint8_t*>(out);
  roundtrip_kernel<<<unsigned(rows), block_threads(width), size_t(width),
                     cudaStream_t(stream)>>>(in, res, static_cast<int32_t*>(decoded), width,
                                             n_samples, vec_aligned(width, in, res));
  return int(cudaGetLastError());
}

// codes, flags: (rows, width) uint8, row-major; nseg: (rows,) int32;
// cells: 1, 2, 4, 8 or 16.
int vcfc_cuda_probe_blocked_encode(const void* codes, void* flags, void* nseg, long long rows,
                                   int width, int n_samples, int cells, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(flags);
  auto* counts = static_cast<int32_t*>(nseg);
  const auto s = cudaStream_t(stream);
  switch (cells) {
    case 1: launch_blocked_encode<1>(in, out, counts, rows, width, n_samples, s); break;
    case 2: launch_blocked_encode<2>(in, out, counts, rows, width, n_samples, s); break;
    case 4: launch_blocked_encode<4>(in, out, counts, rows, width, n_samples, s); break;
    case 8: launch_blocked_encode<8>(in, out, counts, rows, width, n_samples, s); break;
    case 16: launch_blocked_encode<16>(in, out, counts, rows, width, n_samples, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, row-major; decoded: (rows,) int32.
int vcfc_cuda_probe_tile_decode(const void* flags, void* codes, void* decoded, long long rows,
                                int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* out = static_cast<uint8_t*>(codes);
  tile_decode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(decoded), width, n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// text: (rows, width) int32 words, flags: (rows, width) uint8, row-major;
// nseg, seps_ok: (rows,) int32.
int vcfc_cuda_probe_tile_text_encode(const void* text, void* flags, void* nseg, void* seps_ok,
                                     long long rows, int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint32_t*>(text);
  auto* out = static_cast<uint8_t*>(flags);
  tile_text_encode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), static_cast<int32_t*>(seps_ok), width,
      n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, text: (rows, width) int32 words,
// row-major; decoded: (rows,) int32.
int vcfc_cuda_probe_tile_text_decode(const void* flags, void* text, void* codes, void* decoded,
                                     long long rows, int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* words = static_cast<uint32_t*>(text);
  auto* out = static_cast<uint8_t*>(codes);
  tile_text_decode_kernel<<<unsigned(rows), block_threads(width), 0, cudaStream_t(stream)>>>(
      in, words, out, static_cast<int32_t*>(decoded), width, n_samples,
      vec_aligned(width, in, words, out));
  return int(cudaGetLastError());
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
