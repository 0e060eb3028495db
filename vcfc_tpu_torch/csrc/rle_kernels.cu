// Hopper RLE kernels of the .vcfc codec: K1 encode, K2 decode, and their
// text-fused forms K3 (classify + encode) and K4 (decode + render).
//
// K1 (encode_rows_kernel<Codes>) replaces
// vcfc_tpu/ops/pallas_rle.py::_encode_kernel (_encode_body); K2
// (decode_rows_kernel<Codes>) replaces ::_decode_kernel (_decode_body); K3
// (encode_rows_kernel<Text>) replaces ::_text_encode_kernel
// (_classify_words, then _encode_body, then the separator check); K4
// (decode_rows_kernel<Text>) replaces ::_text_decode_kernel (_decode_body,
// then _render_words).  They compute exactly what vcfc_tpu/ops/rle.py's
// rle_encode / rle_decode / text_rle_encode / text_rle_decode compute; the
// plain PyTorch versions in vcfc_tpu_torch/ops/rle.py are the spec they are
// tested against.
//
// What bounds them: bytes.  Per genotype cell K1 and K2 read one byte and
// write one byte, plus 4 bytes a row: 10,493,952 bytes for one engine
// batch of 2,048 x 2,560, 0.00313 ms at the H100's 3.35 TB/s; K3 reads a
// 4-byte word and writes a byte, K4 reads a byte and writes a word and a
// byte.  The function needs no more than a handful of integer operations a
// cell, and every integer operation the kernels spend runs on the SM's 64
// INT32 lanes, so the design spends as few as it can:
//   - geometry: one warp walks a row in rounds of 32 lanes x 16 cells, a
//     lane owning one group of 16 cells a round (one uint4 of bytes, or
//     four of text words) and loading the next round's while it works; the
//     row scan is warp shuffles, with a carry from round to round and no
//     barrier.  A CTA holds four rows.  (Other rows a CTA or a
//     __launch_bounds__ minimum measured no faster on an H100: PERF.md's
//     geometry sweep.)
//   - the encode finds run starts once, four cells a word, as bit 7 of
//     each byte: a byte unlike the byte before it (the word against itself
//     shifted one byte by a funnel shift), an escape, or an escape before
//     it (the escape bits shifted one byte); a 17-bit mask holds them for
//     the 16 cells and the next one.  The only remainder is one d % cap at
//     the lane's first cell: the segment starts are the run starts plus at
//     most one cap wrap (cap >= 31 > 16), and each cell's remainder is its
//     distance to the latest of them, filled forward byte-wise with shifts
//     and masks.  Flag bases come from one __byte_perm a word.  A group
//     without a flag stores zeros and computes nothing more;
//   - the decode takes a presence mask per word, each flag's code from one
//     __byte_perm over its top three bits, a byte-wise fill from the right
//     for the cells between flags, and run lengths summed in 16-bit
//     halves; a group without a flag stores its carried-in code.
// K1/K3 are one kernel and K2/K4 another, templated on the plane beside
// the flags (Codes or Text below).  K3 classifies its 16 words into four
// code words as it takes them from the load, four words at a time in
// byte-wise arithmetic (fewer instructions and registers than one word at
// a time: a few percent faster on an H100).  K4 renders 16 words a lane
// from the round's code words, passed through shared memory so that the
// warp's word stores are contiguous.  No intermediate plane goes to device
// memory.
//
// Plain C interface (loaded with ctypes): every entry point launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include "rle_tile.cuh"

namespace {

// The geometry: one warp a row, CTA_WARPS rows a CTA.
constexpr int CTA_WARPS = 4;
constexpr int CTA_THREADS = CTA_WARPS * 32;
constexpr int GROUP = 16;           // a lane's cells a round
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

// The group of 16 cells at row[p, p + 16) as N little-endian words (4 for
// byte cells, 16 for word cells); cells at or past w read as 0.
template <class Cell, int N>
__device__ __forceinline__ void load_group(const Cell* row, int p, int w, bool vec_ok,
                                           uint32_t (&x)[N]) {
  static_assert(N * 4 == GROUP * int(sizeof(Cell)), "a group is 16 cells");
  if (vec_ok && p + GROUP <= w) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(row + p)[q];
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = 0;
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (p + k < w)
        x[k * sizeof(Cell) / 4] |= uint32_t(row[p + k]) << (8 * (k * sizeof(Cell) % 4));
  }
}

template <class Cell, int N>
__device__ __forceinline__ void store_group(Cell* row, int p, int w, bool vec_ok,
                                            const uint32_t (&y)[N]) {
  static_assert(N * 4 == GROUP * int(sizeof(Cell)), "a group is 16 cells");
  if (vec_ok && p + GROUP <= w) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<uint4*>(row + p)[q] =
          make_uint4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (p + k < w)
        row[p + k] = Cell(y[k * sizeof(Cell) / 4] >> (8 * (k * sizeof(Cell) % 4)));
  }
}

// The sum of x over the warp's lanes, in every lane.
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// "0|0\t" as a little-endian word.
constexpr uint32_t TAB_WORD = 0x09307C30u;

// A text word's code: with x = t ^ "0|0\t", the word is 2a + b when its
// bytes 0 and 2 are '0' + a and '0' + b with a, b in {0, 1} and its byte 1
// is '|' (x clear in bits 1-7 of bytes 0 and 2 and in all of byte 1), and
// an escape otherwise: the reference's four-GT match (compress.cpp:126-170),
// _classify_words' predicate.
__device__ __forceinline__ uint32_t classify(uint32_t t) {
  const uint32_t x = t ^ TAB_WORD;
  return (x & 0x00FEFFFEu) ? uint32_t(CODE_ESCAPE) : ((x & 1u) << 1) | ((x >> 16) & 1u);
}

// The plane beside the flags, one cell a sample: K1's input and K2's
// output, one code byte a cell.
struct Codes {
  using Cell = uint8_t;
  static constexpr int WORDS = 4;  // words of a group
  static constexpr bool SEPARATORS = false;

  // a group's four code words; no separators
  __device__ static void codes(const uint32_t (&raw)[WORDS], uint32_t (&x)[4], uint32_t& bad) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = raw[j];
    bad = 0;
  }
  __device__ static int first_code(const uint32_t (&raw)[WORDS]) { return raw[0] & 0xFF; }
  // K2 writes no words
  __device__ static void render(Cell*, int, int, int, bool, const uint32_t (&)[4]) {}
};

// K3's input and K4's output besides the codes: one little-endian
// "a|b<sep>" word a cell.
struct Text {
  using Cell = uint32_t;
  static constexpr int WORDS = 16;
  static constexpr bool SEPARATORS = true;

  // A group's 16 words classified into four code words, classify() four
  // words at a time: __byte_perm gathers bytes 0, 1, 2 and 3 of words
  // 4j..4j+3 into one word each, XORed with "0|0\t"; a byte's code is
  // (bit 0 of byte 0) << 1 | bit 0 of byte 2, or 4 where any other bit of
  // the three is set.  bad gets bit k where word k's separator is not a
  // tab.
  __device__ static void codes(const uint32_t (&raw)[WORDS], uint32_t (&x)[4], uint32_t& bad) {
    bad = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* t = raw + 4 * j;
      const uint32_t even01 = __byte_perm(t[0], t[1], 0x6240);
      const uint32_t even23 = __byte_perm(t[2], t[3], 0x6240);
      const uint32_t odd01 = __byte_perm(t[0], t[1], 0x7351);
      const uint32_t odd23 = __byte_perm(t[2], t[3], 0x7351);
      const uint32_t a = __byte_perm(even01, even23, 0x5410) ^ splat(0x30);
      const uint32_t b = __byte_perm(even01, even23, 0x7632) ^ splat(0x30);
      const uint32_t pipe = __byte_perm(odd01, odd23, 0x5410) ^ splat(0x7C);
      const uint32_t sep = __byte_perm(odd01, odd23, 0x7632) ^ splat(0x09);
      const uint32_t esc = msbs_to_bytes(nonzero(((a | b) & splat(0xFE)) | pipe));
      x[j] = ((((a & splat(1)) << 1) | (b & splat(1))) & ~esc) | (esc & splat(CODE_ESCAPE));
      bad |= byte_msbs(nonzero(sep)) << (4 * j);
    }
  }
  __device__ static int first_code(const uint32_t (&raw)[WORDS]) { return classify(raw[0]); }

  // The words of a round's codes, c holding the lane's group of 16 (code
  // word c[j] holds cells 4j..4j+3).  Stored one uint4 a lane at a stride
  // of 64 bytes, a warp's store would write every 32-byte sector in two
  // halves; so the codes go through shared memory, and in store q lane l
  // renders and stores the 4 words of cells 128q + 4l..+3 of the round
  // (512 contiguous bytes a warp).  Bytes 0 and 2 of a word are '0' +
  // (c >> 1) and '0' + (c & 1), four cells at a time, '?' for an escape
  // (4 >> 1 & 1 = 4 & 1 = 0, plus 15), interleaved with '|' and '\t' by
  // __byte_perm; then '\n' at cell n - 1.  Every lane of the warp calls
  // it, active or not.
  __device__ static void render(Cell* row, int base, int w, int n, bool vec_ok,
                                const uint32_t (&c)[4]) {
    __shared__ uint4 s_codes[CTA_WARPS][32];
    const int lane = threadIdx.x & 31;
    uint4* s = s_codes[threadIdx.x >> 5];
    s[lane] = make_uint4(c[0], c[1], c[2], c[3]);
    __syncwarp();
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = reinterpret_cast<const uint32_t*>(s)[32 * q + lane];
    __syncwarp();  // the next round rewrites s
    constexpr uint32_t PIPE_TAB = 0x097Cu;  // bytes 4, 5 of the selectors below
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = base + 128 * q + 4 * lane;
      const uint32_t esc = ((v[q] >> 2) & 0x01010101u) * 0x0Fu;
      const uint32_t b0 = splat(0x30) + ((v[q] >> 1) & 0x01010101u) + esc;
      const uint32_t b2 = splat(0x30) + (v[q] & 0x01010101u) + esc;
      const uint32_t lo = __byte_perm(b0, b2, 0x5140), hi = __byte_perm(b0, b2, 0x7362);
      uint32_t t[4] = {__byte_perm(lo, PIPE_TAB, 0x5140), __byte_perm(lo, PIPE_TAB, 0x5342),
                       __byte_perm(hi, PIPE_TAB, 0x5140), __byte_perm(hi, PIPE_TAB, 0x5342)};
      const int last = n - 1 - p;
      if (unsigned(last) < 4u) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == last) t[k] ^= (0x09u ^ 0x0Au) << 24;
      }
      if (vec_ok && p + 4 <= w) {
        *reinterpret_cast<uint4*>(row + p) = make_uint4(t[0], t[1], t[2], t[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (p + k < w) row[p + k] = t[k];
      }
    }
  }
};

// K1 (In = Codes): (rows, w) uint8 codes -> flags, nseg.  flags[i] =
// base(c) | (rem + 1) at each segment's last cell i < n and 0 elsewhere,
// where d = i - run_start, rem = d % 127 for code 0 and d % 31 otherwise,
// a segment starts where rem == 0, and a run starts where the code changes
// or either neighbour is an escape (4; other bytes >= 5 are no escape but
// take base 0xE0 and cap 31).  nseg counts the segment starts below n.
// K3 (In = Text): (rows, w) int32 words -> the same flags and nseg of the
// words' codes, and seps_ok: 1 iff every separator byte before sample
// n - 1 is a tab (so 1 for n <= 1).
template <class In>
__global__ void __launch_bounds__(CTA_THREADS)
encode_rows_kernel(const typename In::Cell* __restrict__ cells, uint8_t* __restrict__ flags,
                   int32_t* __restrict__ nseg, int32_t* __restrict__ seps_ok, long long rows,
                   int w, int n, bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * CTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const typename In::Cell* in = cells + row * w;
  uint8_t* out = flags + row * w;
  const int end = min(n, w);  // segment starts count below end
  const int checked = min(n - 1, w);  // separators are checked below this
  int carry = NONE, count = 0;  // carry: the latest run start left of the round
  int round_prev = NONE;         // the code left of the round
  uint32_t bad_seps = 0;
  const int lane_cell = lane * GROUP;
  uint32_t raw[In::WORDS], raw_next[In::WORDS];
#pragma unroll
  for (int j = 0; j < In::WORDS; ++j) raw[j] = 0;
  if (lane_cell < w) load_group(in, lane_cell, w, vec_ok, raw);
  for (int base = 0; base < w; base += ROUND) {
    const int p0 = base + lane_cell;
    const bool active = p0 < w;
    // the next round's group, loaded while this one is worked on
#pragma unroll
    for (int j = 0; j < In::WORDS; ++j) raw_next[j] = 0;
    if (p0 + ROUND < w) load_group(in, p0 + ROUND, w, vec_ok, raw_next);
    uint32_t x[4], bad;
    In::codes(raw, x, bad);
    bad_seps |= bad & below(checked - p0);
    // the codes at p0 - 1 and p0 + 16 (NONE off the row); the round's
    // edges come from the previous and the next round's groups
    const int up = __shfl_up_sync(FULL, int(x[3] >> 24), 1);
    const int down = __shfl_down_sync(FULL, int(x[0] & 0xFF), 1);
    const int next_round = __shfl_sync(FULL, In::first_code(raw_next), 0);
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
    for (int j = 0; j < In::WORDS; ++j) raw[j] = raw_next[j];
  }
  const int total = warp_sum(count);
  if constexpr (In::SEPARATORS) {
    const bool any_bad = __any_sync(FULL, bad_seps != 0);
    if (lane == 0) seps_ok[row] = !any_bad;
  }
  if (lane == 0) nseg[row] = total;
}

// K2 (Out = Codes): (rows, w) uint8 flags -> codes, decoded.  Each cell
// takes the code of the next present flag at or after it (an escape past
// the row's last flag, like rle_decode's 0xFF sentinel); decoded sums the
// run lengths of the flags below n.  The rounds go right to left.
// K4 (Out = Text): the same codes and decoded, and each code's word:
// "?|?" for an escape, separator '\n' at sample n - 1, whatever that cell
// holds, and '\t' elsewhere.
template <class Out>
__global__ void __launch_bounds__(CTA_THREADS)
decode_rows_kernel(const uint8_t* __restrict__ flags, uint8_t* __restrict__ codes,
                   typename Out::Cell* __restrict__ text, int32_t* __restrict__ decoded,
                   long long rows, int w, int n, bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * CTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint8_t* in = flags + row * w;
  uint8_t* out = codes + row * w;
  typename Out::Cell* words = text + row * w;
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
    Out::render(words, base, w, n, vec_ok, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = xn[j];
  }
  const int total = warp_sum(sum);
  if (lane == 0) decoded[row] = total;
}

unsigned row_blocks(long long rows) {
  return unsigned((rows + CTA_WARPS - 1) / CTA_WARPS);
}

}  // namespace

extern "C" {

// codes, flags: (rows, width) uint8, row-major; nseg: (rows,) int32.
int vcfc_cuda_rle_encode(const void* codes, void* flags, void* nseg, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* out = static_cast<uint8_t*>(flags);
  encode_rows_kernel<Codes><<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), nullptr, rows, width, n_samples,
      vec_aligned(width, in, out));
  return int(cudaGetLastError());
}

// flags, codes: (rows, width) uint8, row-major; decoded: (rows,) int32.
int vcfc_cuda_rle_decode(const void* flags, void* codes, void* decoded, long long rows,
                         int width, int n_samples, void* stream) {
  if (bad_shape(rows, width)) return int(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(flags);
  auto* out = static_cast<uint8_t*>(codes);
  decode_rows_kernel<Codes><<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, nullptr, static_cast<int32_t*>(decoded), rows, width, n_samples,
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
  encode_rows_kernel<Text><<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, static_cast<int32_t*>(nseg), static_cast<int32_t*>(seps_ok), rows, width,
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
  decode_rows_kernel<Text><<<row_blocks(rows), CTA_THREADS, 0, cudaStream_t(stream)>>>(
      in, out, words, static_cast<int32_t*>(decoded), rows, width, n_samples,
      vec_aligned(width, in, words, out));
  return int(cudaGetLastError());
}

// The registers a thread, local memory bytes a thread and resident blocks
// per SM, as built, of K1 (kernel 0), K2 (1), K3 (2) or K4 (3); the return
// value is a cudaError.
int vcfc_cuda_rle_kernel_info(int kernel, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(encode_rows_kernel<Codes>),
      reinterpret_cast<const void*>(decode_rows_kernel<Codes>),
      reinterpret_cast<const void*>(encode_rows_kernel<Text>),
      reinterpret_cast<const void*>(decode_rows_kernel<Text>),
  };
  if (kernel < 0 || kernel >= 4) return int(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernels[kernel]);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernels[kernel],
                                                           CTA_THREADS, 0));
}

const char* vcfc_cuda_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
