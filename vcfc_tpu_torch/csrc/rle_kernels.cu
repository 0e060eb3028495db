// Hopper RLE kernels of the .vcfc codec: K1 encode, K2 decode, and their
// text-fused forms K3 (classify + encode) and K4 (decode + render).
//
// K1 (rle_encode_rows_kernel) replaces
// vcfc_tpu/ops/pallas_rle.py::_encode_kernel (_encode_body); K2
// (rle_decode_rows_kernel) replaces ::_decode_kernel (_decode_body); K3
// (text_encode_kernel) replaces ::_text_encode_kernel (_classify_words,
// then _encode_body); K4 (text_decode_kernel) replaces
// ::_text_decode_kernel (_decode_body, then _render_words).  They compute
// exactly what vcfc_tpu/ops/rle.py's rle_encode / rle_decode /
// text_rle_encode / text_rle_decode compute; the plain PyTorch versions in
// vcfc_tpu_torch/ops/rle.py are the spec they are tested against.
//
// What bounds K1 and K2: bytes.  Per genotype cell each reads one byte and
// writes one byte, plus 4 bytes a row: 10,493,952 bytes for one engine
// batch of 2,048 x 2,560, 0.00313 ms at the H100's 3.35 TB/s.  The function
// needs no more than a handful of integer operations a cell, and every
// integer operation the kernels spend runs on the SM's 64 INT32 lanes, so
// the design spends as few as it can:
//   - geometry: one warp walks a row in rounds of 32 lanes x 16 cells, a
//     lane owning one uint4 of 16 cells a round and loading the next
//     round's while it works; the row scan is warp shuffles, with a carry
//     from round to round and no barrier.  A CTA holds four rows.  (Two or
//     four warps a row, or a __launch_bounds__ minimum of 8 or 16 blocks,
//     measured no faster on an H100: PERF.md's geometry sweep.)
//   - K1 finds run starts once, four cells a word, as bit 7 of each byte:
//     a byte unlike the byte before it (the word against itself shifted
//     one byte by a funnel shift), an escape, or an escape before it (the
//     escape bits shifted one byte); a 17-bit mask holds them for the 16
//     cells and the next one.  The only remainder is one d % cap at the
//     lane's first cell: the segment starts are the run starts plus at
//     most one cap wrap (cap >= 31 > 16), and each cell's remainder is its
//     distance to the latest of them, filled forward byte-wise with shifts
//     and masks.  Flag bases come from one __byte_perm a word.  A group
//     without a flag stores zeros and computes nothing more;
//   - K2 takes a presence mask per word, each flag's code from one
//     __byte_perm over its top three bits, a byte-wise fill from the right
//     for the cells between flags, and run lengths summed in 16-bit
//     halves; a group without a flag stores its carried-in code.
// K3 and K4 walk tiles instead: one CTA per row walks the row in tiles of
// blockDim x VEC cells, each thread owns VEC consecutive cells, and the
// row scan is a per-thread serial scan, a warp-shuffle scan and a
// shared-memory combine of the warp totals, with a carry from tile to tile
// (encode_tile and decode_tile in rle_tile.cuh).  No intermediate plane
// goes to device memory: K3 classifies its words into codes in registers,
// K4 renders its words from the codes in registers.
//
// Plain C interface (loaded with ctypes): every entry point launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include "rle_tile.cuh"

namespace {

// K1's and K2's geometry: one warp a row, CTA_WARPS rows a CTA.
constexpr int CTA_WARPS = 4;
constexpr int CTA_THREADS = CTA_WARPS * 32;
constexpr int GROUP = 16;           // a lane's cells a round: one uint4
constexpr int ROUND = 32 * GROUP;   // a row's cells a round
constexpr int NONE = -1;

// Bits k < t of a 32-bit mask (t may be negative or past 32).
__device__ __forceinline__ uint32_t below(int t) {
  return t <= 0 ? 0u : t >= 32 ? FULL : (1u << t) - 1;
}

constexpr uint32_t MSBS = 0x80808080u, LOW7 = 0x7F7F7F7Fu;

// Bit 7 of each byte where that byte of t is not 0, and 0 elsewhere (the
// low 7 bits are added within the byte, so no carry crosses bytes).
__device__ __forceinline__ uint32_t nonzero(uint32_t t) {
  return (((t & LOW7) + LOW7) | t) & MSBS;
}

// Bit 7 of each byte of s (s holds no other bits), as bits 0-3.
__device__ __forceinline__ uint32_t byte_msbs(uint32_t s) {
  return (s * 0x00204081u) >> 28;
}

// Each byte of s (s holds only bits 7 of bytes) spread to 0x00 or 0xFF.
__device__ __forceinline__ uint32_t msbs_to_bytes(uint32_t s) { return (s >> 7) * 0xFFu; }

// Bits 0-3 of b, each spread over its byte (0x00 or 0xFF).
__device__ __forceinline__ uint32_t bits_to_bytes(uint32_t b) {
  return (((b & 0xFu) * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// Bytes 0-3 of m (each < 8) as the four selector nibbles of __byte_perm:
// m | m >> 4 holds bytes 0 and 1 in its byte 0, bytes 2 and 3 in its byte 2.
__device__ __forceinline__ uint32_t nibbles(uint32_t m) {
  const uint32_t t = m | (m >> 4);
  return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

__device__ __forceinline__ uint32_t splat(uint32_t byte) { return byte * 0x01010101u; }

// The group of 16 cells at row[p, p + 16) as four little-endian words;
// cells at or past w read as 0.
__device__ __forceinline__ void load_group(const uint8_t* row, int p, int w, bool vec_ok,
                                           uint32_t x[4]) {
  if (vec_ok && p + GROUP <= w) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    x[0] = x[1] = x[2] = x[3] = 0;
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (p + k < w) x[k >> 2] |= uint32_t(row[p + k]) << (8 * (k & 3));
  }
}

__device__ __forceinline__ void store_group(uint8_t* row, int p, int w, bool vec_ok,
                                            const uint32_t y[4]) {
  if (vec_ok && p + GROUP <= w) {
    *reinterpret_cast<uint4*>(row + p) = make_uint4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (p + k < w) row[p + k] = uint8_t(y[k >> 2] >> (8 * (k & 3)));
  }
}

// The sum of x over the warp's lanes, in every lane.
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// K1: (rows, w) uint8 codes -> flags, nseg.  flags[i] = base(c) | (rem + 1)
// at each segment's last cell i < n and 0 elsewhere, where d = i -
// run_start, rem = d % 127 for code 0 and d % 31 otherwise, a segment
// starts where rem == 0, and a run starts where the code changes or either
// neighbour is an escape (4; other bytes >= 5 are no escape but take
// base 0xE0 and cap 31).  nseg counts the segment starts below n.
__global__ void __launch_bounds__(CTA_THREADS)
rle_encode_rows_kernel(const uint8_t* __restrict__ codes, uint8_t* __restrict__ flags,
                       int32_t* __restrict__ nseg, long long rows, int w, int n, bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * CTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint8_t* in = codes + row * w;
  uint8_t* out = flags + row * w;
  const int end = min(n, w);  // segment starts count below end
  int carry = NONE, count = 0;  // carry: the latest run start left of the round
  int round_prev = NONE;         // the code left of the round
  const int lane_cell = lane * GROUP;
  uint32_t x[4] = {0, 0, 0, 0}, xn[4];
  if (lane_cell < w) load_group(in, lane_cell, w, vec_ok, x);
  for (int base = 0; base < w; base += ROUND) {
    const int p0 = base + lane_cell;
    const bool active = p0 < w;
    // the next round's group, loaded while this one is worked on
    xn[0] = xn[1] = xn[2] = xn[3] = 0;
    if (p0 + ROUND < w) load_group(in, p0 + ROUND, w, vec_ok, xn);
    // the codes at p0 - 1 and p0 + 16 (NONE off the row); the round's
    // edges come from the previous and the next round's groups
    const int up = __shfl_up_sync(FULL, int(x[3] >> 24), 1);
    const int down = __shfl_down_sync(FULL, int(x[0] & 0xFF), 1);
    const int next_round = __shfl_sync(FULL, int(xn[0] & 0xFF), 0);
    int prev = NONE, next = NONE;
    if (active && p0 > 0) prev = lane > 0 ? up : round_prev;
    if (p0 + GROUP < w) next = lane < 31 ? down : next_round;

    // S: the cells k = 0..16 at p0 + k that start a run.  Per word, bit 7
    // of a byte marks a code unlike the one before it (the word against
    // itself shifted one byte, the code before it shifted in), an escape,
    // or an escape before it (the escape bits shifted one byte).
    uint32_t S = 0;
    uint32_t word_before = prev == NONE ? 0u : uint32_t(prev) << 24;
    uint32_t esc_before = prev == CODE_ESCAPE ? 0x80000000u : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t esc = nonzero(x[j] ^ splat(CODE_ESCAPE)) ^ MSBS;
      const uint32_t s = nonzero(x[j] ^ __funnelshift_l(word_before, x[j], 8)) | esc |
                         __funnelshift_l(esc_before, esc, 8);
      S |= byte_msbs(s) << (4 * j);
      word_before = x[j];
      esc_before = esc;
    }
    if (prev == NONE) S |= 1u;  // cell 0 of the row
    const int last_code = x[3] >> 24;
    if (next != NONE && (next != last_code || next == CODE_ESCAPE || last_code == CODE_ESCAPE))
      S |= 1u << GROUP;
    S &= below(w - p0);

    // the latest run start left of the group: shuffles, then the rounds
    // before
    const uint32_t own = S & 0xFFFFu;
    int incl = own ? p0 + 31 - __clz(own) : NONE;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, y);
    }
    int left = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) left = NONE;
    const int run_start = max(carry, left);
    carry = max(carry, __shfl_sync(FULL, incl, 31));

    // B: the cells that start a segment, the run starts and at most one
    // cap wrap before the group's first run start
    const int c0 = x[0] & 0xFF;
    const int cap0 = c0 == 0 ? 127 : 31;
    const int d0 = (S & 1u) ? 0 : p0 - run_start;
    const int rem0 = c0 == 0 ? d0 % 127 : d0 % 31;
    uint32_t B = S;
    const int wrap = rem0 == 0 ? 0 : cap0 - rem0;
    if (wrap <= GROUP && (S & below(wrap)) == 0) B |= 1u << wrap;
    B &= below(w - p0);
    count += __popc(B & below(min(end - p0, GROUP)));

    // L: the cells that end a segment, before a segment start or at n - 1
    uint32_t L = (B >> 1) & below(end - p0 - 1);
    if (n > p0 && n - p0 <= GROUP && n <= w) L |= 1u << (n - 1 - p0);
    uint32_t f[4] = {0, 0, 0, 0};
    if (L) {
      // rem at cell k: k minus the latest segment start at or before k,
      // or rem0 + k where none is.  F holds that start + 1 per byte, filled
      // forward from the bytes that start a segment (seen: 0xFF) within the
      // word, then from the word before (F_in where seen_in)
      uint32_t F_in = 0, seen_in = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t k1 = 0x04030201u + splat(4 * j);  // k + 1 per byte
        uint32_t seen = bits_to_bytes(B >> (4 * j));
        uint32_t F = k1 & seen;
        F |= ~seen & (F << 8);
        seen |= seen << 8;
        F |= ~seen & (F << 16);
        seen |= seen << 16;
        F |= ~seen & F_in;
        seen |= seen_in;
        F_in = __byte_perm(F, 0, 0x3333);
        seen_in = uint32_t(int32_t(seen) >> 31);
        const uint32_t rem = (seen & (k1 - F)) | (~seen & (splat(rem0) + k1 - splat(1)));
        // flag bases: 0x00, 0xA0, 0xC0, 0x80 by code & 3, 0xE0 for codes >= 4
        const uint32_t low = __byte_perm(0x80C0A000u, 0, nibbles(x[j] & splat(3)));
        const uint32_t high = msbs_to_bytes(nonzero(x[j] & splat(0xFC)));
        const uint32_t flag_base = (low & ~high) | (high & splat(0xE0));
        f[j] = (flag_base | (rem + splat(1))) & bits_to_bytes(L >> (4 * j));
      }
    }
    if (active) store_group(out, p0, w, vec_ok, f);
    round_prev = __shfl_sync(FULL, int(x[3] >> 24), 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = xn[j];
  }
  const int total = warp_sum(count);
  if (lane == 0) nseg[row] = total;
}

// K2: (rows, w) uint8 flags -> codes, decoded.  Each cell takes the code of
// the next present flag at or after it (an escape past the row's last
// flag, like rle_decode's 0xFF sentinel); decoded sums the run lengths of
// the flags below n.  The rounds go right to left.
__global__ void __launch_bounds__(CTA_THREADS)
rle_decode_rows_kernel(const uint8_t* __restrict__ flags, uint8_t* __restrict__ codes,
                       int32_t* __restrict__ decoded, long long rows, int w, int n,
                       bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * CTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint8_t* in = flags + row * w;
  uint8_t* out = codes + row * w;
  const int end = min(n, w);
  int carry = CODE_ESCAPE, sum = 0;  // carry: the code of the next flag right of the round
  const int lane_cell = lane * GROUP;
  const int last_base = (w - 1) / ROUND * ROUND;
  uint32_t x[4] = {0, 0, 0, 0}, xn[4];
  if (last_base + lane_cell < w) load_group(in, last_base + lane_cell, w, vec_ok, x);
  for (int base = last_base; base >= 0; base -= ROUND) {
    const int p0 = base + lane_cell;
    const bool active = p0 < w;
    // the next round's group (to the left), loaded while this one is worked on
    xn[0] = xn[1] = xn[2] = xn[3] = 0;
    if (base > 0) load_group(in, p0 - ROUND, w, vec_ok, xn);
    uint32_t P = 0;  // the cells that hold a flag
#pragma unroll
    for (int j = 0; j < 4; ++j) P |= byte_msbs(nonzero(x[j])) << (4 * j);

    // the code of the lane's first flag; codes from a flag's top 3 bits:
    // 0-3 (bit 7 clear) -> 0, 0x80 -> 3, 0xA0 -> 1, 0xC0 -> 2, 0xE0 -> 4
    constexpr uint32_t CODE_OF_TOP3 = 0x04020103u;
    int first = NONE;
    if (P) {
      const int k = __ffs(P) - 1;
      const uint32_t word = k < 8 ? (k < 4 ? x[0] : x[1]) : (k < 12 ? x[2] : x[3]);
      first = __byte_perm(0, CODE_OF_TOP3, (word >> (8 * (k & 3) + 5)) & 7) & 0xFF;
    }
    // the code of the first flag right of the group: shuffles, then the
    // rounds after
    int incl = first;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(FULL, incl, off);
      if (lane + off < 32 && incl == NONE) incl = y;
    }
    int right = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) right = NONE;
    const int round_first = __shfl_sync(FULL, incl, 0);
    const int in_code = right != NONE ? right : carry;
    if (round_first != NONE) carry = round_first;

    uint32_t c[4];
    if (P == 0) {
      c[0] = c[1] = c[2] = c[3] = splat(in_code);
    } else {
      // each word filled from its own flags right to left, then from the
      // word to its right
      uint32_t fill = in_code;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        uint32_t known = msbs_to_bytes(nonzero(x[j]));
        uint32_t v = __byte_perm(0, CODE_OF_TOP3, nibbles((x[j] >> 5) & 0x07070707u)) & known;
        v |= ~known & (v >> 8);
        known |= known >> 8;
        v |= ~known & (v >> 16);
        known |= known >> 16;
        c[j] = v | (~known & splat(fill));
        fill = c[j] & 0xFF;
      }
      // run lengths of the flags below n: f & 0x7F for bit 7 clear, 1 for
      // an escape flag (>= 0xE0), f & 0x1F otherwise; summed in two 16-bit
      // halves (at most 4 x 2 x 127 each)
      const int below_n = end - p0;
      if (below_n > 0) {
        uint32_t halves = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t hi = msbs_to_bytes(x[j] & MSBS);
          const uint32_t esc = msbs_to_bytes(x[j] & (x[j] << 1) & (x[j] << 2) & MSBS);
          uint32_t len = x[j] & (LOW7 ^ (hi & splat(0x60)));
          len = (len & ~esc) | (esc & splat(1));
          if (below_n < GROUP) len &= bits_to_bytes(below(below_n) >> (4 * j));
          halves += (len & 0x00FF00FFu) + ((len >> 8) & 0x00FF00FFu);
        }
        sum += int((halves & 0xFFFFu) + (halves >> 16));
      }
    }
    if (active) store_group(out, p0, w, vec_ok, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = xn[j];
  }
  const int total = warp_sum(sum);
  if (lane == 0) decoded[row] = total;
}

unsigned row_blocks(long long rows) {
  return unsigned((rows + CTA_WARPS - 1) / CTA_WARPS);
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
  rle_encode_rows_kernel<<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), rows, width, n_samples, vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, row-major; decoded: (rows,) int32.
int vcfc_cuda_rle_decode(const void* flags, void* codes, void* decoded, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* out = static_cast<uint8_t*>(codes);
  rle_decode_rows_kernel<<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(decoded), rows, width, n_samples,
      vec_aligned(width, in, out));
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

// K1's (kernel 0) or K2's (kernel 1) registers a thread, local memory
// bytes a thread and resident blocks per SM, as built; the return value is
// a cudaError.
int vcfc_cuda_rle_kernel_info(int kernel, int* regs, int* local_bytes, int* blocks_per_sm) {
  const auto fn = kernel == 0 ? rle_encode_rows_kernel : rle_decode_rows_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, CTA_THREADS, 0));
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
