"""Cases of the order-0 Huffman decode (``ops.huffman_device.decode_bits``),
as seeded numpy words.

The Hopper kernel (``csrc/huffman_kernels.cu``) walks the codewords of each
(stream, segment) from 15 entry offsets in chunks of 512 bits, chains the
segments' maps 256 at a time, and walks again from each segment's true
entry offset.  These cases put codes of every length 1-15, codes that
straddle words, segments shorter than a codeword (s2 < 15), segments that
no chunk divides, chains past 256 segments, one-segment streams, rows of
zero length and arbitrary words (bit 31 set; windows past the book's last
limit) under its passes.

``decode_cases`` returns (name, words (B, W) int32, book, s1, s2) with
W * 32 == s1 * s2.
"""

from __future__ import annotations

import numpy as np

from ..ops.huffman import Codebook, pack_symbols
from ..ops.huffman_device import _split_grid, stream_words


def _random_words(rng, B, W):
    return rng.integers(-(1 << 31), 1 << 31, (B, W), dtype=np.int64).astype(np.int32)


def _skewed_book(rng):
    A = int(rng.integers(5, 400))
    freqs = rng.integers(0, 1000, A)
    freqs[int(rng.integers(0, A))] += 100000  # skew: short codes appear
    return Codebook.from_frequencies(freqs)


def _streams(rng, book, sizes):
    """Payloads of random symbol streams under book, sizes symbols each."""
    present = np.flatnonzero(book.lengths)
    p = 2.0 ** -book.lengths[present].astype(np.float64)  # every length appears
    p /= p.sum()
    return [pack_symbols(rng.choice(present, size=n, p=p).astype(np.int64), book)[0]
            if n else b"" for n in sizes]


def _grid_case(name, payloads, book, grid=None):
    s1, s2 = grid or _split_grid(max(len(p) for p in payloads) * 8)
    return (name, stream_words(payloads, s1, s2), book, s1, s2)


def decode_cases(seed: int = 9) -> list[tuple[str, np.ndarray, Codebook, int, int]]:
    rng = np.random.default_rng(seed)
    full = np.zeros(16, np.uint8)
    full[:14] = np.arange(1, 15)
    full[14:] = 15  # lengths 1..14 once and 15 twice: a complete code
    full_book = Codebook.from_lengths(full)
    uniform = np.zeros(130, np.uint8)
    uniform[1:129] = 7  # 7-bit codes straddle every word boundary
    uniform_book = Codebook.from_lengths(uniform)
    one = Codebook.from_frequencies(np.array([0, 9]))  # a one-symbol alphabet
    cases = [
        _grid_case("lengths 1-15, B=5", _streams(rng, full_book, [3000, 1, 200, 4000, 17]),
                   full_book),
        _grid_case("lengths 1-15, B=1", _streams(rng, full_book, [5000]), full_book),
        _grid_case("7-bit codes straddling words", _streams(rng, uniform_book, [997, 4096]),
                   uniform_book),
        _grid_case("one-symbol alphabet", [pack_symbols(np.ones(100, np.int64), one)[0]], one),
        _grid_case("rows of zero length", _streams(rng, full_book, [0, 700, 0, 0, 1500, 0]),
                   full_book),
    ]
    for i in range(3):
        book = _skewed_book(rng)
        sizes = [int(n) for n in rng.integers(1, 5000, 7)]
        cases.append(_grid_case(f"skewed book {i}, B=7", _streams(rng, book, sizes), book))
    payloads = _streams(rng, full_book, [1200, 800, 1500])
    for s1, s2 in ((1, 4096), (2, 2048), (3, 1024 + 256 + 64), (16, 256), (128, 32), (256, 16),
                   (512, 8), (4096, 1)):
        cases.append(_grid_case(f"s1={s1} s2={s2}", payloads, full_book, (s1, s2)))
    cases.append(("arbitrary words, lengths 1-15", _random_words(rng, 4, 96), full_book, 4, 768))
    cases.append(("arbitrary words, skewed book", _random_words(rng, 3, 64), _skewed_book(rng),
                  1, 2048))
    cases.append(("arbitrary words, one-symbol alphabet", _random_words(rng, 2, 64), one, 8, 256))
    long = _streams(rng, full_book, [90_000, 30_000])  # chains past 256 segments
    cases.append(_grid_case("chain of 300 segments", long, full_book, (300, 2048)))
    return cases
