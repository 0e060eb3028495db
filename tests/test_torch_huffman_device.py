"""The port's order-0 Huffman device decode (vcfc_tpu_torch.ops.huffman_device)
on the CPU, against vcfc_tpu.ops.huffman_device on JAX's CPU backend.

``device_decode_tables``, ``_windows15`` (words with bit 31 set),
``_lens_and_syms``, ``decode_bits`` (the plane, element by element, on the
cases of ``eval.huffman_cases``) and ``_split_grid`` are held to the JAX
package's; ``device_unpack_symbols`` to the JAX package's and to the host
``unpack_symbols``, its 'invalid Huffman stream' gates included, on the
dense branch and under ``VCFZ_COMPACT=device`` (the compaction branch,
also against the dense one).  A numpy
model of the Hopper kernel's three passes (segment maps from 15 entry
offsets, the chain, the emitting walk; ``csrc/huffman_kernels.cu``) is
held to ``decode_bits_plain`` on the same cases, so that its arithmetic is
checked where no card is.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcfc_tpu.ops import huffman as jhuff
from vcfc_tpu.ops import huffman_device as jh
from vcfc_tpu_torch.eval.huffman_cases import decode_cases
from vcfc_tpu_torch.ops import huffman_device as th
from vcfc_tpu_torch.ops.huffman import Codebook, pack_symbols, unpack_symbols

CASES = decode_cases()
CASE_IDS = [name for name, *_ in CASES]


def _jax_book(book):
    return jhuff.Codebook.from_lengths(book.lengths)


def _books():
    rng = np.random.default_rng(3)
    books = []
    for _ in range(3):
        freqs = rng.integers(0, 1000, int(rng.integers(5, 400)))
        freqs[0] += 100000
        books.append(Codebook.from_frequencies(freqs))
    books.append(Codebook.from_frequencies(np.array([0, 9])))
    books.extend(book for name, _w, book, *_ in CASES if name == "lengths 1-15, B=1")
    return books


@pytest.mark.parametrize("book", _books(), ids=lambda b: f"{int((b.lengths > 0).sum())}syms")
def test_device_decode_tables(book):
    got = th.device_decode_tables(book)
    want = jh.device_decode_tables(_jax_book(book))
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_windows15_on_words_with_bit_31_set(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(-(1 << 31), 1 << 31, (3, 17), dtype=np.int64).astype(np.int32)
    words[0, :] |= np.int32(-(1 << 31))  # bit 31 of every word of row 0
    words[1, -1] = -1  # an all-ones last word: windows run into the zero pad
    got = th._windows15(torch.from_numpy(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jh._windows15(jnp.asarray(words))))


@pytest.mark.parametrize("book", _books(), ids=lambda b: f"{int((b.lengths > 0).sum())}syms")
def test_lens_and_syms(book):
    window = np.arange(1 << 15, dtype=np.int32)[None, :]  # every window
    limits, adjust, _ = th.device_decode_tables(book)
    got = th._lens_and_syms(torch.from_numpy(window), torch.from_numpy(limits),
                            torch.from_numpy(adjust))
    jl, ja, _ = jh.device_decode_tables(_jax_book(book))
    want = jh._lens_and_syms(jnp.asarray(window), jl, ja)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_decode_bits_matches_jax(case):
    _name, words, book, s1, s2 = CASES[case]
    limits, adjust, _ = th.device_decode_tables(book)
    got = th.decode_bits(torch.from_numpy(words), limits, adjust, s1=s1, s2=s2)
    assert got.dtype == torch.int32 and got.shape == (words.shape[0], s1 * s2)
    jl, ja, _ = jh.device_decode_tables(_jax_book(book))
    want = np.asarray(jh.decode_bits(jnp.asarray(words), jl, ja, s1=s1, s2=s2))
    np.testing.assert_array_equal(got.numpy(), want)


# The kernel's geometry (csrc/huffman_kernels.cu)
CHUNK, CHAIN_SEGS, WIN = 512, 256, 15


def _kernel_model(words, limits, adjust, s1, s2):
    """The three passes of csrc/huffman_kernels.cu in numpy, chunk by chunk
    as a warp holds them: pass 1 walks each (stream, segment) from entry
    offsets 0-14 and keeps the offset past the end it reaches, pass 2
    chains the maps from offset 0 (CHAIN_SEGS segments at a time), pass 3
    walks from each segment's entry offset and writes ordinal + 1 at the
    start bits."""
    B, W = words.shape
    win = th._windows15(torch.from_numpy(words)).numpy().astype(np.int64)
    lens = 1 + (win[..., None] >= limits[None, None, : WIN - 1]).sum(-1)
    vals = (win >> (WIN - lens)) + adjust[lens - 1] + 1
    seg0 = (np.arange(s1) * s2)[None, :, None]  # every (stream, segment) at once
    rows = np.arange(B)[:, None, None]
    pos = seg0 + np.arange(WIN)  # pass 1: (B, s1, 15) walkers
    for c0 in range(0, s2, CHUNK):
        end = seg0 + min(c0 + CHUNK, s2)
        while (step := pos < end).any():
            pos = np.where(step, pos + lens[rows, np.minimum(pos, W * 32 - 1)], pos)
    seg_map = pos - (seg0 + s2)
    seg_in = np.zeros((B, s1), np.int64)  # pass 2
    for b in range(B):
        off = 0
        for c0 in range(0, s1, CHAIN_SEGS):
            maps = seg_map[b, c0 : c0 + CHAIN_SEGS]
            for s in range(len(maps)):
                seg_in[b, c0 + s] = off
                off = maps[s, off]
    out = np.zeros((B, W * 32), np.int32)  # pass 3: (B, s1) walkers
    pos, seg0, rows = seg0[..., 0] + seg_in, seg0[..., 0], rows[..., 0]
    for c0 in range(0, s2, CHUNK):
        end = seg0 + min(c0 + CHUNK, s2)
        while (step := pos < end).any():
            b, p = np.broadcast_to(rows, pos.shape)[step], pos[step]
            out[b, p] = vals[b, p]
            pos[step] += lens[b, p]
    return out


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_kernel_model_matches_plain(case):
    _name, words, book, s1, s2 = CASES[case]
    limits, adjust, _ = th.device_decode_tables(book)
    want = th.decode_bits_plain(torch.from_numpy(words), limits, adjust, s1=s1, s2=s2)
    np.testing.assert_array_equal(_kernel_model(words, limits, adjust, s1, s2), want.numpy())


@pytest.mark.parametrize("nbits", [0, 1, 8, 4095, 4096, 4097, 65_536, 516_840, 8_388_608,
                                   8_388_609, 16_777_216, 50_000_000, 200_000_000])
def test_split_grid(nbits):
    assert th._split_grid(nbits) == jh._split_grid(nbits)


def test_decode_bits_checks_the_grid():
    words = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not tile"):
        th.decode_bits(words, np.zeros(15, np.int32), np.zeros(15, np.int32), s1=3, s2=32)
    with pytest.raises(TypeError, match="int32"):
        th.decode_bits(words.long(), np.zeros(15, np.int32), np.zeros(15, np.int32), s1=4, s2=32)


def test_decode_bits_does_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    takes CUDA tensors only: it raises instead of running the plain form."""
    words = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        th.decode_bits(words, np.zeros(15, np.int32), np.zeros(15, np.int32), s1=4, s2=32)


# --- device_unpack_symbols ----------------------------------------------------------


def _streams(seed, n=7):
    rng = np.random.default_rng(seed)
    A = int(rng.integers(5, 400))
    freqs = rng.integers(0, 1000, A)
    freqs[int(rng.integers(0, A))] += 100000
    book = Codebook.from_frequencies(freqs)
    present = np.flatnonzero(book.lengths)
    streams = [rng.choice(present, size=int(rng.integers(1, 5000))) for _ in range(n)]
    return book, streams, [pack_symbols(s.astype(np.int64), book)[0] for s in streams]


def _assert_both(payloads, n_syms, book):
    got = th.device_unpack_symbols(payloads, n_syms, book, device="cpu")
    want = jh.device_unpack_symbols(payloads, n_syms, _jax_book(book))
    assert len(got) == len(want) == len(payloads)
    for g, w, p, n in zip(got, want, payloads, n_syms):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, unpack_symbols(p, n, book))
    return got


@pytest.mark.parametrize("seed", range(3))
def test_unpack_random_streams(seed):
    book, streams, payloads = _streams(seed)
    for g, s in zip(_assert_both(payloads, [len(s) for s in streams], book), streams):
        np.testing.assert_array_equal(g, s)


def test_unpack_single_symbol_alphabet():
    book = Codebook.from_frequencies(np.array([0, 9]))
    payload, _ = pack_symbols(np.ones(100, np.int64), book)
    (got,) = _assert_both([payload], [100], book)
    np.testing.assert_array_equal(got, np.ones(100))


def test_unpack_word_boundary_straddles():
    lengths = np.zeros(130, np.uint8)
    lengths[1:129] = 7
    book = Codebook.from_lengths(lengths)
    stream = (np.arange(997) % 128 + 1).astype(np.int64)
    payload, _ = pack_symbols(stream, book)
    (got,) = _assert_both([payload], [len(stream)], book)
    np.testing.assert_array_equal(got, stream)


def test_unpack_empty_payloads_and_no_payloads():
    book, streams, payloads = _streams(4, n=3)
    _assert_both([b"", payloads[0], b""], [0, len(streams[0]), 0], book)
    assert th.device_unpack_symbols([], [], book, device="cpu") == []


def test_unpack_truncated_stream_raises():
    book = Codebook.from_frequencies(np.arange(1, 40))
    stream = np.arange(30, dtype=np.int64) % 39
    payload, _ = pack_symbols(stream, book)
    for unpack, bk in ((th.device_unpack_symbols, book), (jh.device_unpack_symbols, _jax_book(book))):
        kwargs = {"device": "cpu"} if unpack is th.device_unpack_symbols else {}
        with pytest.raises(ValueError, match="invalid Huffman"):
            unpack([payload[: len(payload) // 4]], [30], bk, **kwargs)


def test_unpack_ordinal_outside_the_book_raises():
    """Under a one-symbol book ("0"), all-ones bytes give windows past the
    book's last limit: their ordinals fall outside the book and both ports
    raise."""
    book = Codebook.from_frequencies(np.array([0, 9]))
    with pytest.raises(ValueError, match="invalid Huffman"):
        th.device_unpack_symbols([b"\xff" * 64], [10], book, device="cpu")
    with pytest.raises(ValueError, match="invalid Huffman"):
        jh.device_unpack_symbols([b"\xff" * 64], [10], _jax_book(book))


@pytest.mark.parametrize("max_bits", [4096, 3 * 8192])
def test_unpack_in_several_dispatches(monkeypatch, max_bits):
    """_MAX_DISPATCH_BITS cut small: the streams go in groups of one and of
    a few, each group its own decode_bits call."""
    book, streams, payloads = _streams(5)
    calls = []
    real = th.decode_bits

    def spy(words, *args, **kwargs):
        calls.append(words.shape[0])
        return real(words, *args, **kwargs)

    monkeypatch.setattr(th, "decode_bits", spy)
    monkeypatch.setattr(th, "_MAX_DISPATCH_BITS", max_bits)
    monkeypatch.setattr(jh, "_MAX_DISPATCH_BITS", max_bits)
    for g, s in zip(_assert_both(payloads, [len(s) for s in streams], book), streams):
        np.testing.assert_array_equal(g, s)
    assert len(calls) > 1 and sum(calls) == len(payloads)


def test_unpack_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    book, streams, payloads = _streams(6, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.device_unpack_symbols(payloads, [len(s) for s in streams], book)


# --- device_unpack_symbols under VCFZ_COMPACT=device ------------------------------


@pytest.fixture
def compact(monkeypatch):
    """VCFZ_COMPACT=device, which both packages read."""
    monkeypatch.setenv("VCFZ_COMPACT", "device")


def _assert_compacted(payloads, n_syms, book, monkeypatch):
    """The compaction branch against the JAX package's and against the
    port's dense branch (VCFZ_COMPACT=host)."""
    got = _assert_both(payloads, n_syms, book)
    monkeypatch.setenv("VCFZ_COMPACT", "host")
    dense = th.device_unpack_symbols(payloads, n_syms, book, device="cpu")
    monkeypatch.setenv("VCFZ_COMPACT", "device")
    for g, d in zip(got, dense):
        np.testing.assert_array_equal(g, d)
    return got


@pytest.mark.parametrize("seed", range(3))
def test_unpack_compacted_random_streams(seed, compact, monkeypatch):
    book, streams, payloads = _streams(seed)
    calls = []
    real = th._compact_rows
    monkeypatch.setattr(th, "_compact_rows", lambda *a: calls.append(1) or real(*a))
    got = _assert_compacted(payloads, [len(s) for s in streams], book, monkeypatch)
    for g, s in zip(got, streams):
        np.testing.assert_array_equal(g, s)
    assert calls  # the compaction branch ran


def test_unpack_compacted_empty_payloads_and_straddles(compact, monkeypatch):
    book, streams, payloads = _streams(4, n=3)
    _assert_compacted([b"", payloads[0], b""], [0, len(streams[0]), 0], book, monkeypatch)
    lengths = np.zeros(130, np.uint8)
    lengths[1:129] = 7
    book = Codebook.from_lengths(lengths)
    stream = (np.arange(997) % 128 + 1).astype(np.int64)
    (got,) = _assert_compacted([pack_symbols(stream, book)[0]], [len(stream)], book, monkeypatch)
    np.testing.assert_array_equal(got, stream)


def test_unpack_compacted_truncated_stream_raises(compact):
    """Each row is masked to its stream's bits before the compaction, so a
    truncated payload still fails the count gate (the JAX package's
    test_truncated_stream_gate_under_device_compact); the whole stream
    decodes."""
    book = Codebook.from_frequencies(np.arange(1, 40))
    stream = np.arange(3000, dtype=np.int64) % 39
    payload, _ = pack_symbols(stream, book)
    for unpack, bk, kwargs in ((th.device_unpack_symbols, book, {"device": "cpu"}),
                               (jh.device_unpack_symbols, _jax_book(book), {})):
        with pytest.raises(ValueError, match="invalid Huffman"):
            unpack([payload[: len(payload) // 2]], [len(stream)], bk, **kwargs)
        np.testing.assert_array_equal(unpack([payload], [len(stream)], bk, **kwargs)[0], stream)


def test_unpack_compacted_ordinal_outside_the_book_raises(compact):
    book = Codebook.from_frequencies(np.array([0, 9]))
    with pytest.raises(ValueError, match="invalid Huffman"):
        th.device_unpack_symbols([b"\xff" * 64], [10], book, device="cpu")
    with pytest.raises(ValueError, match="invalid Huffman"):
        jh.device_unpack_symbols([b"\xff" * 64], [10], _jax_book(book))


@pytest.mark.parametrize("max_bits", [4096, 3 * 8192])
def test_unpack_compacted_in_several_dispatches(monkeypatch, compact, max_bits):
    """_MAX_DISPATCH_BITS cut small in both packages: several dispatches,
    each compacted, through buffers the dispatches reuse."""
    book, streams, payloads = _streams(5)
    calls = []
    real = th._compact_rows

    def spy(plane, nbits):
        calls.append(plane.shape[0])
        return real(plane, nbits)

    monkeypatch.setattr(th, "_compact_rows", spy)
    monkeypatch.setattr(th, "_MAX_DISPATCH_BITS", max_bits)
    monkeypatch.setattr(jh, "_MAX_DISPATCH_BITS", max_bits)
    for g, s in zip(_assert_both(payloads, [len(s) for s in streams], book), streams):
        np.testing.assert_array_equal(g, s)
    assert len(calls) > 1 and sum(calls) == len(payloads)


def test_stream_words_into_a_buffer():
    _book, _streams_, payloads = _streams(7, n=4)
    s1, s2 = th._split_grid(max(len(p) for p in payloads) * 8)
    want = th.stream_words(payloads, s1, s2)
    for row, p in zip(want, payloads):  # big-endian words, zero-padded
        padded = p + bytes(s1 * s2 // 8 - len(p))
        np.testing.assert_array_equal(row, np.frombuffer(padded, ">u4").astype(np.int64)
                                      .astype(np.uint32).view(np.int32))
    buf = np.full(want.shape, -1, np.int32)
    assert th.stream_words(payloads, s1, s2, out=buf) is buf
    np.testing.assert_array_equal(buf, want)
    with pytest.raises(ValueError, match="C-contiguous int32"):
        th.stream_words(payloads, s1, s2, out=np.zeros(want.shape, np.int64))
