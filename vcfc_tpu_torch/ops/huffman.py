"""Canonical, length-limited Huffman coding over codec symbols.

The port's copy of ``vcfc_tpu/ops/huffman.py``, so that ``vcfc_tpu_torch``
imports nothing of ``vcfc_tpu``.  ``ops.histogram`` uses the context count
and the initial context; ``format.vcfz`` the rest.

The .vcfz extended container entropy-codes the per-line symbol stream
(flag bytes plus dictionary-coded escape strings) with one *global*
codebook.  Histograms come from the device (ops.histogram /
parallel.shard psum-merge); the tiny tree construction is host work.

Canonical form: codebook is fully determined by the per-symbol code
lengths, so the container stores just one byte per present symbol.
Lengths are limited to MAX_CODE_LEN so decode can use a flat
2^MAX_CODE_LEN lookup table (the native decoder) — lengths beyond the
cap are squashed with the standard count-scaling heuristic.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

MAX_CODE_LEN = 15


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths for a frequency vector (0 for absent symbols),
    limited to MAX_CODE_LEN."""
    freqs = np.asarray(freqs, np.int64)
    present = np.flatnonzero(freqs > 0)
    n = len(present)
    lengths = np.zeros(len(freqs), np.uint8)
    if n == 0:
        return lengths
    if n > (1 << MAX_CODE_LEN):  # a depth-15 tree has at most 2^15 leaves
        raise ValueError(
            f"{n} distinct symbols cannot fit {MAX_CODE_LEN}-bit-limited codes"
        )
    if n == 1:
        lengths[present[0]] = 1
        return lengths

    f = freqs[present].astype(np.float64)
    # 64 rounds, not 32: halving provably reaches all-ones (where the
    # tree depth is ~log2(n) <= 15) only after ~log2(max count) rounds,
    # and symbol counts can exceed 2^32 on multi-GB streams.  Mirrored
    # bit-for-bit in vcfcq.cpp::huffman_lengths (byte contract).
    for _ in range(64):  # squash until the tree fits the cap
        heap: list[tuple[float, int]] = [(float(w), i) for i, w in enumerate(f)]
        heapq.heapify(heap)
        parent = {}
        next_id = n
        while len(heap) > 1:
            w1, a = heapq.heappop(heap)
            w2, b = heapq.heappop(heap)
            parent[a] = next_id
            parent[b] = next_id
            heapq.heappush(heap, (w1 + w2, next_id))
            next_id += 1
        depth = np.zeros(n, np.int32)
        for i in range(n):
            d, node = 0, i
            while node in parent:
                node = parent[node]
                d += 1
            depth[i] = d
        if depth.max() <= MAX_CODE_LEN:
            lengths[present] = depth.astype(np.uint8)
            return lengths
        # flatten the distribution and retry (standard length-limit trick)
        f = np.maximum(f / 2, 1.0)
    raise RuntimeError("failed to limit Huffman code lengths")


@dataclass
class Codebook:
    """Canonical codebook: codes assigned in (length, symbol) order."""

    lengths: np.ndarray  # (n_symbols,) uint8, 0 = absent
    codes: np.ndarray  # (n_symbols,) uint32

    @classmethod
    def from_lengths(cls, lengths: np.ndarray) -> "Codebook":
        lengths = np.asarray(lengths, np.uint8)
        if (lengths > MAX_CODE_LEN).any():
            raise ValueError("code length exceeds MAX_CODE_LEN")
        # Kraft check: length tables come from untrusted containers; an
        # over-subscribed table would silently overlap decode-table rows
        present = lengths[lengths > 0].astype(np.int64)
        if present.size and int(
            (np.int64(1) << (MAX_CODE_LEN - present)).sum()
        ) > (1 << MAX_CODE_LEN):
            raise ValueError("corrupt codebook: Kraft inequality violated")
        codes = np.zeros(len(lengths), np.uint32)
        code = 0
        for bit_len in range(1, MAX_CODE_LEN + 1):
            for sym in np.flatnonzero(lengths == bit_len):
                codes[sym] = code
                code += 1
            code <<= 1
        return cls(lengths, codes)

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray) -> "Codebook":
        return cls.from_lengths(code_lengths(freqs))

    def decode_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat 2^MAX_CODE_LEN decode table: (symbol, length) per prefix."""
        size = 1 << MAX_CODE_LEN
        sym_t = np.zeros(size, np.int32)
        len_t = np.zeros(size, np.uint8)
        for sym in np.flatnonzero(self.lengths):
            ln = int(self.lengths[sym])
            prefix = int(self.codes[sym]) << (MAX_CODE_LEN - ln)
            count = 1 << (MAX_CODE_LEN - ln)
            sym_t[prefix : prefix + count] = sym
            len_t[prefix : prefix + count] = ln
        return sym_t, len_t


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> tuple[bytes, int]:
    """Vectorized MSB-first packing of per-symbol (code, length) pairs —
    the single packing routine behind pack_symbols and pack_symbols_ctx.
    Expands every symbol to its bits: bit k of an n-bit code is
    (code >> (n-1-k)) & 1."""
    codes = codes.astype(np.uint64)
    total = int(lengths.sum())
    ends = np.cumsum(lengths)
    starts = ends - lengths
    bit_sym = np.repeat(np.arange(len(codes)), lengths)
    bit_k = np.arange(total) - np.repeat(starts, lengths)
    shift = (lengths[bit_sym] - 1 - bit_k).astype(np.uint64)
    bits = ((codes[bit_sym] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes(), total


def pack_symbols(symbols: np.ndarray, book: Codebook) -> tuple[bytes, int]:
    """MSB-first bit packing. Returns (payload, total_bits)."""
    lengths = book.lengths[symbols].astype(np.int64)
    if (lengths == 0).any():
        raise ValueError("symbol with no codeword in the codebook")
    return _pack_bits(book.codes[symbols], lengths)


# --------------------------------------------------------------------------
# Context-classed coding (.vcfz v2): each symbol is coded with the codebook
# selected by the CLASS of the previous symbol.  Four classes capture ~96%
# of the order-1 entropy gain on the flag-byte stream at 4x the codebook
# metadata (measured: 2.09 MB order-0 vs 1.72 MB with 4 classes on the
# 50 MB cohort).  Class 1 is the fixed initial context of every block so
# blocks decode independently.

N_CTX = 4
CTX_INIT = 1
# v4 adds a 5th class for vertical-match run symbols (format/vcfz.py)
N_CTX_V4 = 5


def symbol_classes(n_symbols: int, match_base: int | None = None) -> np.ndarray:
    """Class of each alphabet symbol when it is the *previous* symbol:
    0 = full 0|0 run (0x7F), 1 = shorter 0|0 run, 2 = het run,
    3 = escape-dictionary symbol (>= 256; raw 0xE0.. bytes never appear
    as symbols), and — v4 only — 4 = vertical-match run (symbols >=
    ``match_base``)."""
    cls = np.empty(n_symbols, np.uint8)
    syms = np.arange(n_symbols)
    cls[syms < 0x80] = 1
    if n_symbols > 0x7F:
        cls[0x7F] = 0
    cls[(syms >= 0x80) & (syms < 0x100)] = 2
    cls[syms >= 0x100] = 3
    if match_base is not None:
        cls[syms >= match_base] = 4
    return cls


def ctx_of_stream(symbols: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Per-symbol coding context: class of the previous symbol, CTX_INIT
    for the first."""
    ctx = np.empty(len(symbols), np.uint8)
    if len(symbols):
        ctx[0] = CTX_INIT
        ctx[1:] = classes[symbols[:-1]]
    return ctx


def context_codebooks(
    symbol_blocks: list[np.ndarray],
    n_alphabet: int,
    classes: np.ndarray | None = None,
    n_ctx: int = N_CTX,
) -> list[Codebook]:
    """One codebook per context class.  Frequencies are accumulated with
    the exact per-block context assignment (every block restarts at
    CTX_INIT), so every (context, symbol) pair the packer will emit is
    guaranteed a codeword."""
    if classes is None:
        classes = symbol_classes(n_alphabet)
    freqs = np.zeros((n_ctx, n_alphabet), np.int64)
    for block in symbol_blocks:
        block = np.asarray(block, np.int64)
        ctx = ctx_of_stream(block, classes)
        np.add.at(freqs, (ctx.astype(np.int64), block), 1)
    return [Codebook.from_frequencies(freqs[c]) for c in range(n_ctx)]


def pack_symbols_ctx(
    symbols: np.ndarray, books: list[Codebook], classes: np.ndarray | None = None
) -> tuple[bytes, int]:
    """Context-switching MSB-first packing (native bit writer when
    available; the numpy path below is the oracle fallback)."""
    symbols = np.asarray(symbols, np.int64)
    n_alphabet = len(books[0].lengths)
    if classes is None:
        classes = symbol_classes(n_alphabet)
    ctx = ctx_of_stream(symbols, classes).astype(np.int64)
    all_lengths = np.stack([b.lengths for b in books])  # (N_CTX, alphabet)
    all_codes = np.stack([b.codes for b in books])
    lengths = all_lengths[ctx, symbols].astype(np.int64)
    if (lengths == 0).any():
        raise ValueError("symbol with no codeword in its context codebook")

    from ..host import native

    if native.available():
        payload = native.huffman_encode_ctx(
            symbols, all_codes, all_lengths, classes, CTX_INIT
        )
        return payload, int(lengths.sum())

    return _pack_bits(all_codes[ctx, symbols], lengths)


def unpack_symbols_ctx(
    payload: bytes, n_symbols: int, books: list[Codebook],
    classes: np.ndarray | None = None,
) -> np.ndarray:
    """Context-switching canonical decode (numpy oracle; the native
    decoder is the fast path)."""
    tables = [b.decode_table() for b in books]
    if classes is None:
        classes = symbol_classes(len(books[0].lengths))
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    window = MAX_CODE_LEN
    padded = np.concatenate([bits, np.zeros(window, np.uint8)])
    weights = (1 << np.arange(window - 1, -1, -1)).astype(np.int64)
    out = np.empty(n_symbols, np.int32)
    pos = 0
    ctx = CTX_INIT
    for i in range(n_symbols):
        sym_t, len_t = tables[ctx]
        prefix = int(padded[pos : pos + window] @ weights)
        ln = int(len_t[prefix])
        if ln == 0:  # uncovered prefix: same error as the native decoder
            raise ValueError("invalid Huffman stream")
        sym = sym_t[prefix]
        out[i] = sym
        pos += ln
        ctx = int(classes[sym])
    return out


def unpack_symbols(payload: bytes, n_symbols: int, book: Codebook) -> np.ndarray:
    """Pure-Python/numpy canonical decode (oracle; the native decoder is
    the fast path)."""
    sym_t, len_t = book.decode_table()
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    out = np.empty(n_symbols, np.int32)
    pos = 0
    window = MAX_CODE_LEN
    # build a padded bit array so the final window read never overruns
    padded = np.concatenate([bits, np.zeros(window, np.uint8)])
    weights = (1 << np.arange(window - 1, -1, -1)).astype(np.int64)
    for i in range(n_symbols):
        prefix = int(padded[pos : pos + window] @ weights)
        ln = int(len_t[prefix])
        if ln == 0:  # uncovered prefix: same error as the native decoder
            raise ValueError("invalid Huffman stream")
        out[i] = sym_t[prefix]
        pos += ln
    return out
