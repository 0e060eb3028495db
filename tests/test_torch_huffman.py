"""The port's canonical Huffman coder (vcfc_tpu_torch.ops.huffman) and its
native bindings against vcfc_tpu's, on seeded numpy inputs.

Codebooks must be equal length for length and code for code, payloads
byte for byte, decodes element for element: the port's copy is the JAX
package's, so every comparison is exact.
"""

import numpy as np
import pytest

from vcfc_tpu.host import native as jax_native
from vcfc_tpu.ops import huffman as jh
from vcfc_tpu_torch.host import native
from vcfc_tpu_torch.ops import huffman as th

SEEDS = list(range(8))


def _freqs(seed, n=300, used=60):
    rng = np.random.default_rng(seed)
    freqs = np.zeros(n, np.int64)
    freqs[rng.choice(n, size=min(used, n), replace=False)] = rng.integers(1, 10_000, min(used, n))
    return freqs


def _stream(seed, alphabet=300, size=4000):
    """A skewed symbol stream over flag bytes and escape symbols."""
    rng = np.random.default_rng(seed)
    p = np.full(alphabet, 1.0)
    p[0x7F] = 400.0
    p[1:0x7F] = 8.0
    p[0x80:0x100] = 3.0
    p /= p.sum()
    return rng.choice(alphabet, size=size, p=p).astype(np.int64)


def _blocks(seed, n_blocks=5, alphabet=300):
    return [_stream(seed * 10 + b, alphabet, 500 + 97 * b) for b in range(n_blocks)]


def test_constants_match():
    assert (th.MAX_CODE_LEN, th.N_CTX, th.N_CTX_V4, th.CTX_INIT) == (
        jh.MAX_CODE_LEN, jh.N_CTX, jh.N_CTX_V4, jh.CTX_INIT)


EDGE_FREQS = {
    "empty": np.zeros(10, np.int64),
    "one symbol": np.array([0, 7, 0]),
    "two symbols": np.array([5, 3]),
    "skewed past the cap": np.array([2**i for i in range(40)], dtype=np.float64),
    "uniform 256": np.ones(256, np.int64),
    "counts past 2^32": np.array([1, 1 << 40, 3, 1 << 35, 0, 9], np.int64),
}


@pytest.mark.parametrize("name", list(EDGE_FREQS))
def test_code_lengths_on_edges(name):
    np.testing.assert_array_equal(th.code_lengths(EDGE_FREQS[name]),
                                  jh.code_lengths(EDGE_FREQS[name]))


@pytest.mark.parametrize("seed", SEEDS)
def test_codebooks_and_decode_tables(seed):
    freqs = _freqs(seed)
    tb, jb = th.Codebook.from_frequencies(freqs), jh.Codebook.from_frequencies(freqs)
    np.testing.assert_array_equal(tb.lengths, jb.lengths)
    np.testing.assert_array_equal(tb.codes, jb.codes)
    for got, want in zip(tb.decode_table(), jb.decode_table()):
        np.testing.assert_array_equal(got, want)


def test_kraft_violation_raises_in_both():
    for mod in (th, jh):
        with pytest.raises(ValueError, match="Kraft"):
            mod.Codebook.from_lengths(np.full(300, 8, np.uint8))
        with pytest.raises(ValueError, match="MAX_CODE_LEN"):
            mod.Codebook.from_lengths(np.array([16, 1], np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_and_unpack_order0(seed):
    symbols = _stream(seed)
    freqs = np.bincount(symbols, minlength=300)
    tb, jb = th.Codebook.from_frequencies(freqs), jh.Codebook.from_frequencies(freqs)
    got, want = th.pack_symbols(symbols, tb), jh.pack_symbols(symbols, jb)
    assert got == want
    np.testing.assert_array_equal(th.unpack_symbols(got[0], len(symbols), tb),
                                  jh.unpack_symbols(want[0], len(symbols), jb))
    np.testing.assert_array_equal(th.unpack_symbols(got[0], len(symbols), tb), symbols)


def test_pack_without_a_codeword_raises_in_both():
    lengths = np.zeros(300, np.uint8)
    lengths[:2] = 1
    for mod in (th, jh):
        with pytest.raises(ValueError, match="no codeword"):
            mod.pack_symbols(np.array([0, 1, 5]), mod.Codebook.from_lengths(lengths))


@pytest.mark.parametrize("match_base", [None, 300, 257])
@pytest.mark.parametrize("n", [1, 0x7F, 0x80, 0x100, 400])
def test_symbol_classes(n, match_base):
    np.testing.assert_array_equal(th.symbol_classes(n, match_base),
                                  jh.symbol_classes(n, match_base))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_ctx_of_stream(seed):
    symbols = _stream(seed)
    classes = jh.symbol_classes(300)
    np.testing.assert_array_equal(th.ctx_of_stream(symbols, classes),
                                  jh.ctx_of_stream(symbols, classes))
    np.testing.assert_array_equal(th.ctx_of_stream(symbols[:0], classes),
                                  jh.ctx_of_stream(symbols[:0], classes))


def _books(mod, seed, n_ctx, match_base=None):
    alphabet = 300 if match_base is None else match_base + 41
    blocks = [b % alphabet for b in _blocks(seed, alphabet=alphabet)]
    if match_base is not None:  # a vertical-match band above the escapes
        for b in blocks:
            b[::7] = match_base + (b[::7] % 41)
    classes = mod.symbol_classes(alphabet, match_base=match_base)
    return blocks, classes, mod.context_codebooks(blocks, alphabet, classes, n_ctx)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n_ctx,match_base", [(4, None), (5, 300)])
def test_context_codebooks(seed, n_ctx, match_base):
    _blk, _cls, got = _books(th, seed, n_ctx, match_base)
    _blk, _cls, want = _books(jh, seed, n_ctx, match_base)
    assert len(got) == len(want) == n_ctx
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.codes, w.codes)


@pytest.mark.parametrize("no_native", ["", "1"])
@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n_ctx,match_base", [(4, None), (5, 300)])
def test_pack_and_unpack_by_context(seed, n_ctx, match_base, no_native, monkeypatch):
    """Native bit writer and numpy fallback (VCFC_NO_NATIVE=1) alike."""
    monkeypatch.setenv("VCFC_NO_NATIVE", no_native)
    blocks, classes, tbooks = _books(th, seed, n_ctx, match_base)
    _blk, _cls, jbooks = _books(jh, seed, n_ctx, match_base)
    for block in blocks:
        got = th.pack_symbols_ctx(block, tbooks, classes)
        assert got == jh.pack_symbols_ctx(block, jbooks, classes)
        back = th.unpack_symbols_ctx(got[0], len(block), tbooks, classes)
        np.testing.assert_array_equal(back, jh.unpack_symbols_ctx(got[0], len(block), jbooks,
                                                                  classes))
        np.testing.assert_array_equal(back, block)


def test_invalid_stream_raises_in_both():
    book_t = th.Codebook.from_lengths(np.array([1, 2, 0, 0], np.uint8))
    book_j = jh.Codebook.from_lengths(np.array([1, 2, 0, 0], np.uint8))
    for mod, book in ((th, book_t), (jh, book_j)):
        with pytest.raises(ValueError, match="invalid Huffman stream"):
            mod.unpack_symbols(b"\xff\xff", 4, book)
        with pytest.raises(ValueError, match="invalid Huffman stream"):
            mod.unpack_symbols_ctx(b"\xff\xff", 4, [book] * 4, np.zeros(4, np.uint8))


# --- the five native bindings the .vcfz codec calls ---------------------------


@pytest.fixture
def natives():
    if not (native.available() and jax_native.available()):
        pytest.skip("native library unavailable")
    return native, jax_native


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_native_huffman_decode(natives, seed):
    symbols = _stream(seed)
    book = jh.Codebook.from_frequencies(np.bincount(symbols, minlength=300))
    payload, _bits = jh.pack_symbols(symbols, book)
    sym_t, len_t = book.decode_table()
    got = native.huffman_decode(payload, len(symbols), sym_t, len_t)
    np.testing.assert_array_equal(got, jax_native.huffman_decode(payload, len(symbols), sym_t,
                                                                 len_t))
    np.testing.assert_array_equal(got, symbols)
    uncovered = np.zeros_like(len_t)  # no prefix decodes: both bindings refuse
    for binding in (native, jax_native):
        with pytest.raises(ValueError, match="invalid Huffman stream"):
            binding.huffman_decode(payload, len(symbols), sym_t, uncovered)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_native_context_coders(natives, seed):
    blocks, classes, books = _books(jh, seed, 4)
    codes = np.stack([b.codes for b in books])
    lengths = np.stack([b.lengths for b in books])
    tables = [b.decode_table() for b in books]
    sym_ts, len_ts = np.stack([t[0] for t in tables]), np.stack([t[1] for t in tables])
    for block in blocks:
        payload = native.huffman_encode_ctx(block, codes, lengths, classes, th.CTX_INIT)
        assert payload == jax_native.huffman_encode_ctx(block, codes, lengths, classes,
                                                        jh.CTX_INIT)
        got = native.huffman_decode_ctx(payload, len(block), sym_ts, len_ts, classes,
                                        th.CTX_INIT)
        np.testing.assert_array_equal(got, jax_native.huffman_decode_ctx(
            payload, len(block), sym_ts, len_ts, classes, jh.CTX_INIT))
        np.testing.assert_array_equal(got, block)
    missing = lengths.copy()
    missing[:, blocks[0][0]] = 0
    with pytest.raises(ValueError, match="without a codeword"):
        native.huffman_encode_ctx(blocks[0], codes, missing, classes, th.CTX_INIT)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_native_merge_ctx(natives, seed):
    """The v7 context automaton over per-context sub-streams."""
    block = _stream(seed, size=3000)
    classes = jh.symbol_classes(300)
    ctx = jh.ctx_of_stream(block, classes)
    subs = [block[ctx == c].astype(np.int32) for c in range(4)]
    flat = np.concatenate(subs)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in subs])]).astype(np.int64)
    got = native.vcfz_merge_ctx(flat, offsets, classes, th.CTX_INIT, len(block))
    np.testing.assert_array_equal(
        got, jax_native.vcfz_merge_ctx(flat, offsets, classes, jh.CTX_INIT, len(block)))
    np.testing.assert_array_equal(got, block)
    short = offsets.copy()
    short[1:] -= 1
    short[1:] = np.maximum(short[1:], 0)
    with pytest.raises(ValueError, match="underrun"):
        native.vcfz_merge_ctx(flat, short, classes, th.CTX_INIT, len(block))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_native_compact_flags(natives, seed):
    rng = np.random.default_rng(seed)
    flags = np.where(rng.random((37, 129)) < 0.2, rng.integers(1, 256, (37, 129)), 0)
    flags = flags.astype(np.uint8)
    flags[5] = 0  # a line without flags
    nflags = np.count_nonzero(flags, axis=1).astype(np.int32)
    got = native.compact_flags(flags, nflags)
    np.testing.assert_array_equal(got, jax_native.compact_flags(flags, nflags))
    np.testing.assert_array_equal(got, flags[flags != 0])
