"""The port's `.vcfz` device encode (vcfc_tpu_torch.ops.vcfz_device and
format.vcfz_device) on the CPU, against vcfc_tpu.

The ops (``sympos_v3``, ``ctx_plane``, ``pack_cells`` and its segmented
word sum) are held element by element to the JAX package's on its CPU
backend: the words (int32, bit 31 included), the emit mask, ``total_bits``
and ``bad``.  The route (``device="cpu"``) is held byte for byte to the JAX
package's host writer for v1, v2, v3, v5 and v8; v4, v6 and v7 raise
NotImplementedError.  The device decode (``vcfz_to_vcfc_device``) is held
to the JAX package's and to the host reconstruction for v1, v5 and v8;
v2/v3 return None, v4/v6/v7 raise NotImplementedError.  Under
``VCFZ_COMPACT=device`` (on-device compaction: ``sort_compact``,
``pack_cells_compact``, ``compact_payloads_device``, ``esc_plane_device``)
both routes give the same bytes, and every compact pack's width comes from
its own counts; ``device_compaction`` reads the env per device type.  The
shapes stay small: XLA's CPU compile of ``pack_cells`` is slow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fuzz import make_vcf
from vcfc_tpu.format import compress_bytes, decompress_bytes
from vcfc_tpu.format import vcfz as jz
from vcfc_tpu.format import vcfz_device as jdz
from vcfc_tpu.ops import huffman as jh
from vcfc_tpu.ops import vcfz_device as jd
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.format import vcfz as tz
from vcfc_tpu_torch.format import vcfz_device as tzd
from vcfc_tpu_torch.host.fast import parse_vcfc_native
from vcfc_tpu_torch.ops import vcfz_device as td

CPU = "cpu"
DEVICE_VERSIONS = [1, 2, 3, 5, 8]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _assert_same(got, want):
    """Element by element; values, not dtypes of width (bool stays bool)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


# --- the ops ----------------------------------------------------------------------


def _flags(seed, L=48, W=200):
    """Positional flag planes with escape flags (0xE1) and every flag band."""
    rng = np.random.default_rng(seed)
    flags = np.where(rng.random((L, W)) < 0.3, rng.integers(1, 256, (L, W)), 0)
    flags[rng.random((L, W)) < 0.05] = 0xE1
    esc = rng.integers(0, 1000, (L, W)).astype(np.int32)
    return flags.astype(np.uint8), esc


@pytest.mark.parametrize("seed", range(4))
def test_sympos_v3(seed):
    flags, esc = _flags(seed)
    got = td.sympos_v3(_t(flags), _t(esc))
    assert got.dtype == torch.int32
    _assert_same(got, jd.sympos_v3(jnp.asarray(flags), jnp.asarray(esc)))


@pytest.mark.parametrize("v4", [False, True])
def test_cell_class(v4):
    sym = np.arange(0, 700, dtype=np.int32)[None, :]
    got = td._cell_class(_t(sym), 400, v4=v4)
    _assert_same(got, jd._cell_class(jnp.asarray(sym), 400, v4=v4))


def _grid(seed, n_blocks=4, B=3000, alphabet=300, density=0.2, m_base=None):
    rng = np.random.default_rng(seed)
    grid = np.where(rng.random((n_blocks, B)) < density,
                    rng.integers(1, alphabet, (n_blocks, B)), 0).astype(np.int32)
    if m_base is not None:  # a vertical-match band
        band = rng.random((n_blocks, B)) < 0.05
        grid[band & (grid != 0)] = m_base + 3
    grid[-1] = 0  # an empty block
    return grid


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("v4", [False, True])
def test_ctx_plane(seed, v4):
    grid = _grid(seed, alphabet=290, m_base=280 if v4 else None)
    valid = grid != 0
    got = td.ctx_plane(_t(grid), _t(valid), 280, jh.CTX_INIT, v4=v4)
    assert got.dtype == torch.int32
    _assert_same(got, jd.ctx_plane(jnp.asarray(grid), jnp.asarray(valid), 280, jh.CTX_INIT,
                                   v4=v4))


def test_pack_entries():
    books = jh.context_codebooks([np.arange(1, 300)] * 3, 300)
    np.testing.assert_array_equal(td.pack_entries(books), jd.pack_entries(books))


def _books(grid, n_ctx):
    streams = [row[row != 0].astype(np.int64) for row in grid]
    alphabet = int(grid.max()) + 1
    if n_ctx == 1:
        return [jh.Codebook.from_frequencies(np.bincount(np.concatenate(streams),
                                                         minlength=alphabet))]
    return jh.context_codebooks(streams, alphabet, jh.symbol_classes(alphabet), n_ctx)


def _pack_both(grid, valid, books, n_ctx, ctx_init=jh.CTX_INIT, m_base=10**9, v4=False):
    entries = jd.pack_entries(books)
    got = td.pack_cells(_t(grid), _t(valid), _t(entries), m_base, ctx_init, n_ctx=n_ctx, v4=v4)
    want = jd.pack_cells(jnp.asarray(grid), jnp.asarray(valid), jnp.asarray(entries), m_base,
                         ctx_init, n_ctx=n_ctx, v4=v4)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert got[0].dtype == got[2].dtype == torch.int32 and got[1].dtype == torch.bool
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_ctx", [1, 4])
def test_pack_cells(seed, n_ctx):
    """Random sparse grids: every element of the four outputs, and payloads
    equal to the host packers' (pack_symbols / pack_symbols_ctx)."""
    grid = _grid(seed)
    books = _books(grid, n_ctx)
    word_val, emit, total_bits, bad = _pack_both(grid, grid != 0, books, n_ctx)
    assert not bad.any()
    assert (word_val[emit] < 0).any()  # words with bit 31 set, as JAX's negative int32
    payloads = td.compact_payloads(word_val.numpy(), emit.numpy(), total_bits.numpy())
    assert payloads == jd.compact_payloads(word_val.numpy(), emit.numpy(), total_bits.numpy())
    classes = jh.symbol_classes(len(books[0].lengths))
    for row, payload, bits in zip(grid, payloads, total_bits.tolist()):
        stream = row[row != 0].astype(np.int64)
        want = (jh.pack_symbols(stream, books[0]) if n_ctx == 1
                else jh.pack_symbols_ctx(stream, books, classes))
        assert (payload, bits) == want


def _fixed_book(length, n=300):
    lengths = np.zeros(n, np.uint8)
    lengths[1 : 1 + (1 << length) - 1] = length
    return jh.Codebook.from_lengths(lengths)


def test_pack_cells_final_cell_straddle():
    """5 symbols of 7 bits, the last valid cell crossing a word boundary:
    its spill lands in the trailing pad cell."""
    book = _fixed_book(7)
    syms = np.array([[1, 2, 3, 4, 5]], np.int32)
    word_val, emit, total_bits, bad = _pack_both(syms, np.ones((1, 5), bool), [book], 1, 0)
    assert int(total_bits[0]) == 35 and not bad.any()
    assert td.compact_payloads(word_val, emit, total_bits)[0] == jh.pack_symbols(
        syms[0].astype(np.int64), book)[0]


def test_pack_cells_stream_ending_on_a_word_boundary():
    """Row 0: 4 symbols of 8 bits end exactly on the first word's end, so
    the trailing segment emits nothing, and the one word has bit 31 set;
    row 1: 5 symbols, 40 bits, two words."""
    book = _fixed_book(8)
    syms = np.array([[200, 2, 3, 4, 0, 0], [7, 0, 9, 200, 5, 1]], np.int32)
    valid = syms != 0
    word_val, emit, total_bits, bad = _pack_both(syms, valid, [book], 1, 0)
    assert total_bits.tolist() == [32, 40]
    assert emit.sum(dim=1).tolist() == [1, 2]
    assert int(word_val[0][emit[0]][0]) < 0
    for r in range(2):
        stream = syms[r][valid[r]].astype(np.int64)
        assert td.compact_payloads(word_val, emit, total_bits)[r] == jh.pack_symbols(
            stream, book)[0]


def test_pack_cells_without_a_codeword_is_bad():
    book = _fixed_book(3)  # codes for symbols 1-7 only
    syms = np.array([[1, 2, 3], [1, 9, 2]], np.int32)
    _word_val, _emit, _bits, bad = _pack_both(syms, syms != 0, [book], 1, 0)
    assert bad.tolist() == [False, True]


@pytest.mark.parametrize("seed", range(4))
def test_segmented_word_sum(seed):
    """The cumsum form against the JAX package's Hillis-Steele loop, on
    int32 contributions with bit 31 set and segments of every length."""
    rng = np.random.default_rng(seed)
    contrib = rng.integers(-(1 << 31), 1 << 31, (3, 777), dtype=np.int64).astype(np.int32)
    seg = rng.random((3, 777)) < [[0.02], [0.5], [1.0]]
    seg[:, 0] = True
    got = td._wrap32(td._segmented_sum(_t(contrib).long() & 0xFFFFFFFF, _t(seg)))
    _assert_same(got, jd._segmented_sum_scan(jnp.asarray(contrib), jnp.asarray(seg)))


# --- the route ----------------------------------------------------------------------


def _fuzz_vcfc(seed=501, samples=70, variants=90, sv_every=8):
    return compress_bytes(make_vcf(seed, samples, variants, sv_every=sv_every))


@pytest.fixture(scope="module")
def cohort_vcfc():
    return compress_bytes(generate_realistic_vcf(96, 500, seed=9))


@pytest.mark.parametrize("version", DEVICE_VERSIONS)
def test_route_bytes_equal_the_jax_host_writer(version):
    vcfc = _fuzz_vcfc()
    before = tzd.ENCODES[version]
    got = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
    assert got == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tzd.ENCODES[version] == before + 1


@pytest.mark.parametrize("version", DEVICE_VERSIONS)
def test_route_across_batches(version, cohort_vcfc, monkeypatch):
    """Batches of 4 blocks of 16 lines with a short last one (the JAX
    package's test_multi_batch_paths), then batches of one block."""
    want = jz.vcfz_from_vcfc(cohort_vcfc, block_lines=16, version=version)
    monkeypatch.setattr(tzd, "_MAX_CELLS", 16 * 128 * 4)
    assert tzd.vcfz_from_vcfc_device(cohort_vcfc, 16, version, device=CPU) == want
    monkeypatch.setattr(tzd, "_MAX_CELLS", 1)
    assert tzd.vcfz_from_vcfc_device(cohort_vcfc, 16, version, device=CPU) == want


@pytest.mark.parametrize("version", DEVICE_VERSIONS)
def test_route_on_the_cohort_with_default_blocks(version, cohort_vcfc, monkeypatch):
    monkeypatch.setenv("VCFZ_PACK", "device")
    got = tz.vcfz_from_vcfc(cohort_vcfc, version=version, device=CPU)
    assert got == jz.vcfz_from_vcfc(cohort_vcfc, version=version)


def test_escape_first_occurrence_order():
    """Escapes whose first appearance (z|2 before a|2) differs from their
    sorted order: the escape-id plane keeps stream order."""
    rows = [["z|2", "0|0", "a|2", "0|0"], ["0|0", "a|2", "0|0", "z|2"],
            ["c|2", "0|0", "0|0", "b|2"]]
    lines = [b"##f=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC\tD\n"]
    for i, r in enumerate(rows):
        lines.append(b"1\t%d\t.\tA\tT\t9\tPASS\t.\tGT\t" % (100 + i) + "\t".join(r).encode()
                     + b"\n")
    vcfc = compress_bytes(b"".join(lines))
    for version in DEVICE_VERSIONS:
        got = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
        assert got == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tz.VcfzReader.parse(got).escapes == [b"z|2", b"a|2", b"c|2", b"b|2"]


def test_escape_dense_corpus():
    vcfc = _fuzz_vcfc(504, 30, 60, sv_every=3)
    for version in DEVICE_VERSIONS:
        got = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
        assert got == jz.vcfz_from_vcfc(vcfc, version=version)


def test_non_greedy_input_transcodes_exactly():
    """v1-v3 take their symbols from the flags, so a non-canonical stream
    transcodes byte-exactly on the route too."""
    from vcfc_tpu.format.headers import encode_length_header

    header = (b"##m=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
              + b"".join(b"\tS%d" % i for i in range(10)) + b"\n")
    req = b"1\t100\t.\tA\tT\t.\t.\t.\tGT\t"
    body = bytes([0x05, 0x05])
    vcfc = (header + encode_length_header(4 + len(req) + len(body) + 1)
            + encode_length_header(len(req)) + req + body + b"\n")
    for version in DEVICE_VERSIONS:
        assert tz.vcfz_from_vcfc(vcfc, version=version, route="device",
                                 device=CPU) == jz.vcfz_from_vcfc(vcfc, version=version)


@pytest.mark.parametrize("version", [4, 6, 7])
def test_vertical_versions_raise_on_the_route(version, monkeypatch):
    vcfc = _fuzz_vcfc(502, 20, 30)
    with pytest.raises(NotImplementedError, match="ROADMAP A.2"):
        tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
    monkeypatch.setenv("VCFZ_PACK", "device")
    with pytest.raises(NotImplementedError, match="vertical transform"):
        tz.vcfz_from_vcfc(vcfc, version=version, device=CPU)
    monkeypatch.delenv("VCFZ_PACK")
    assert tz.vcfz_from_vcfc(vcfc, version=version) == jz.vcfz_from_vcfc(vcfc, version=version)


def test_device_decode_raises(monkeypatch):
    """The device decode decodes v5 and refuses v4, v6 and v7 (the
    vertical-match resolve), through route= and through VCFZ_PACK."""
    vcfc = _fuzz_vcfc(502, 20, 30)
    z = jz.vcfz_from_vcfc(vcfc, version=5)
    vcf = decompress_bytes(vcfc)
    assert tz.decompress_vcfz(z, route="device", device=CPU) == vcf
    monkeypatch.setenv("VCFZ_PACK", "device")
    assert tz.decompress_vcfz(z, device=CPU) == vcf
    for version in (4, 6, 7):
        z = jz.vcfz_from_vcfc(vcfc, version=version)
        with pytest.raises(NotImplementedError, match="ROADMAP A.2.3"):
            tz.decompress_vcfz(z, device=CPU)
        with pytest.raises(NotImplementedError, match="vertical-match resolve"):
            tz.decompress_vcfz(z, route="device", device=CPU)


# --- the device decode --------------------------------------------------------------

# name -> (the .vcfc, block_lines): the corpora of tests/data, the fuzz
# corpus and the escape-dense corpus
DECODE_CORPORA = {
    "small": (lambda d: compress_bytes((d / "small.vcf").read_bytes()), 32),
    "sv": (lambda d: compress_bytes((d / "sv.vcf").read_bytes()), 4),
    "fuzz": (lambda d: _fuzz_vcfc(), None),
    "escape-dense": (lambda d: _fuzz_vcfc(504, 30, 60, sv_every=3), 16),
}
DECODE_VERSIONS = [1, 5, 8]


@pytest.mark.parametrize("version", DECODE_VERSIONS)
@pytest.mark.parametrize("name", list(DECODE_CORPORA))
def test_device_decode_equals_jax_and_host(name, version, data_dir):
    """vcfz_to_vcfc_device on the CPU: the JAX package's device decode's
    bytes and the host reconstruction's; the counter moves by one."""
    make, block_lines = DECODE_CORPORA[name]
    vcfc = make(data_dir)
    z = jz.vcfz_from_vcfc(vcfc, block_lines, version)
    before = tzd.DECODES[version]
    got = tzd.vcfz_to_vcfc_device(z, device=CPU)
    assert tzd.DECODES[version] == before + 1
    assert got == vcfc == tz.VcfzReader.parse(z).to_vcfc()
    assert got == jdz.vcfz_to_vcfc_device(z)


def test_device_decode_of_the_route_s_own_containers(cohort_vcfc):
    """Encode on the route, decode on the route: the .vcfc comes back."""
    for version in DECODE_VERSIONS:
        z = tz.vcfz_from_vcfc(cohort_vcfc, version=version, route="device", device=CPU)
        assert tzd.vcfz_to_vcfc_device(z, device=CPU) == cohort_vcfc


@pytest.mark.parametrize("version", [2, 3])
def test_context_coded_versions_take_the_host_decode(version):
    """v2 and v3 are context-coded: None, as in the JAX package, the counter
    unmoved, and decompress_vcfz(route="device") decodes on the host."""
    vcfc = _fuzz_vcfc(505, 40, 60)
    z = jz.vcfz_from_vcfc(vcfc, version=version)
    before = dict(tzd.DECODES)
    assert tzd.vcfz_to_vcfc_device(z, device=CPU) is None
    assert jdz.vcfz_to_vcfc_device(z) is None
    assert tz.decompress_vcfz(z, route="device", device=CPU) == decompress_bytes(vcfc)
    assert tzd.DECODES == before


@pytest.mark.parametrize("version", [4, 6, 7])
def test_vertical_versions_refuse_the_device_decode(version):
    z = jz.vcfz_from_vcfc(_fuzz_vcfc(506, 30, 40), version=version)
    before = dict(tzd.DECODES)
    with pytest.raises(NotImplementedError, match="ROADMAP A.2.3"):
        tzd.vcfz_to_vcfc_device(z, device=CPU)
    assert tzd.DECODES == before


def test_corrupt_payload_raises():
    """An all-ones payload chains into windows past the book's last
    canonical limit: ordinals out of range raise, as in the JAX package."""
    vcfc = compress_bytes(make_vcf(42, 40, 120))
    z = bytearray(jz.vcfz_from_vcfc(vcfc, version=5))
    r = jz.VcfzReader.parse(bytes(z))
    assert int(r.books[0].lengths.max()) < 15
    blk = r.blocks[0]
    start = r.payload_base + blk["payload_off"]
    z[start : start + blk["payload_len"]] = b"\xff" * blk["payload_len"]
    with pytest.raises(ValueError, match="invalid Huffman"):
        jdz.vcfz_to_vcfc_device(bytes(z))
    with pytest.raises(ValueError, match="invalid Huffman"):
        tzd.vcfz_to_vcfc_device(bytes(z), device=CPU)


def test_structural_inputs_take_the_host_writer_and_leave_the_counter():
    """No data lines, or no samples: the JAX package's None cases."""
    no_lines = compress_bytes(b"##f=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\n")
    no_samples = compress_bytes(
        b"##f=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n"
        b"1\t100\t.\tA\tT\t9\tPASS\t.\tGT\n")
    before = dict(tzd.ENCODES)
    for vcfc in (no_lines, no_samples):
        assert tzd.vcfz_from_vcfc_device(vcfc, 256, 3, device=CPU) is None
        assert tz.vcfz_from_vcfc(vcfc, route="device", device=CPU) == jz.vcfz_from_vcfc(vcfc)
    assert tzd.ENCODES == before


def test_route_without_the_native_library_raises(monkeypatch):
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native host library"):
        tz.vcfz_from_vcfc(_fuzz_vcfc(502, 20, 30), route="device", device=CPU)


def test_route_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.vcfz_from_vcfc(_fuzz_vcfc(502, 20, 30), route="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.decompress_vcfz(jz.vcfz_from_vcfc(_fuzz_vcfc(502, 20, 30)))


# --- VCFZ_COMPACT=device: on-device compaction on both routes ---------------------


@pytest.fixture
def compact(monkeypatch):
    """VCFZ_COMPACT=device, which both packages read."""
    monkeypatch.setenv("VCFZ_COMPACT", "device")


@pytest.fixture
def compact_calls(monkeypatch):
    """Records each pack_cells_compact call's (width, counts) and counts
    sort_compact's calls, in the port's ops."""
    calls = {"pack_cells_compact": [], "sort_compact": 0}
    pack, sort = td.pack_cells_compact, td.sort_compact

    def spy_pack(sym_c, counts, *args, **kwargs):
        calls["pack_cells_compact"].append((sym_c.shape[1], counts.clone()))
        return pack(sym_c, counts, *args, **kwargs)

    def spy_sort(values, mask):
        calls["sort_compact"] += 1
        return sort(values, mask)

    monkeypatch.setattr(td, "pack_cells_compact", spy_pack)
    monkeypatch.setattr(td, "sort_compact", spy_sort)
    return calls


def _widths_come_from_the_counts(calls, n_cells):
    """Every pack_cells_compact call got the width _bucket gives its own
    counts, which is no less than the largest of them (no row is cut)."""
    assert calls["pack_cells_compact"]
    for width, counts in calls["pack_cells_compact"]:
        top = int(counts.max()) if counts.numel() else 0
        assert width == td._bucket(top, n_cells) >= top


@pytest.mark.parametrize("version", DEVICE_VERSIONS)
def test_route_under_device_compaction(version, compact, compact_calls):
    """The JAX package's TestDeviceCompact::test_encode_byte_identical: the
    host writer's bytes; the route compacts on the device."""
    vcfc = _fuzz_vcfc()
    before = tzd.ENCODES[version]
    got = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
    assert got == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tzd.ENCODES[version] == before + 1
    blocks = -(-90 // 256)
    packs = blocks * (4 if version == 8 else 1)
    assert len(compact_calls["pack_cells_compact"]) == packs
    # one sort a pack, and one a payload compaction (v3+: the required columns too)
    assert compact_calls["sort_compact"] == 2 * packs + (version >= 3)
    _widths_come_from_the_counts(compact_calls, 128 * 256)


@pytest.mark.parametrize("version", DEVICE_VERSIONS)
def test_route_under_device_compaction_partial_block_and_batches(version, compact,
                                                                 compact_calls, monkeypatch):
    """A trailing partial block (203 lines in blocks of 16) in batches of 4
    blocks, then of one: the bucketed slices and the per-batch escape
    scatter at their edges (the JAX package's
    test_partial_block_and_multi_batch); the decode restores the .vcfc."""
    vcfc = _fuzz_vcfc(503, 50, 203)
    want = jz.vcfz_from_vcfc(vcfc, block_lines=16, version=version)
    for cells in (16 * 128 * 4, 1):
        monkeypatch.setattr(tzd, "_MAX_CELLS", cells)
        assert tzd.vcfz_from_vcfc_device(vcfc, 16, version, device=CPU) == want
    _widths_come_from_the_counts(compact_calls, 16 * 128)
    if version in DECODE_VERSIONS:
        assert tzd.vcfz_to_vcfc_device(want, device=CPU) == vcfc


def test_escape_dense_v8_under_device_compaction(compact):
    """Escape-dense input: the escape plane scattered on the device keeps
    each id on its cell (the JAX package's test_escape_order_preserved)."""
    vcfc = _fuzz_vcfc(504, 30, 60, sv_every=3)
    for version in DEVICE_VERSIONS:
        got = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
        assert got == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tzd.vcfz_to_vcfc_device(got, device=CPU) == vcfc
    assert int(parse_vcfc_native(vcfc).esc_count.sum()) > 100


def test_escape_plane_scattered_on_the_device(compact, monkeypatch):
    """Under compaction every batch's escape plane comes from
    esc_plane_device, which gets every escape cell once."""
    vcfc = _fuzz_vcfc(504, 30, 60, sv_every=3)
    calls = []
    real = td.esc_plane_device
    monkeypatch.setattr(td, "esc_plane_device", lambda *a: calls.append(len(a[0])) or real(*a))
    monkeypatch.setattr(tzd, "_MAX_CELLS", 1)
    assert tzd.vcfz_from_vcfc_device(vcfc, 4, 3, device=CPU) == jz.vcfz_from_vcfc(vcfc, 4, 3)
    assert len(calls) == 15 and sum(calls) == int(parse_vcfc_native(vcfc).esc_count.sum())


@pytest.mark.parametrize("version", DECODE_VERSIONS)
@pytest.mark.parametrize("name", list(DECODE_CORPORA))
def test_device_decode_under_device_compaction(name, version, data_dir, compact,
                                               compact_calls):
    """The decode under VCFZ_COMPACT=device: the input .vcfc, and the JAX
    package's device decode's bytes under the same setting."""
    make, block_lines = DECODE_CORPORA[name]
    vcfc = make(data_dir)
    z = jz.vcfz_from_vcfc(vcfc, block_lines, version)
    got = tzd.vcfz_to_vcfc_device(z, device=CPU)
    assert got == vcfc == jdz.vcfz_to_vcfc_device(z)
    assert compact_calls["sort_compact"] > 0


def test_device_decode_under_device_compaction_of_the_cohort(cohort_vcfc, compact):
    for version in DECODE_VERSIONS:
        z = tz.vcfz_from_vcfc(cohort_vcfc, version=version, route="device", device=CPU)
        assert z == jz.vcfz_from_vcfc(cohort_vcfc, version=version)
        assert tzd.vcfz_to_vcfc_device(z, device=CPU) == cohort_vcfc


def test_corrupt_payload_raises_under_device_compaction(compact):
    vcfc = compress_bytes(make_vcf(42, 40, 120))
    z = bytearray(jz.vcfz_from_vcfc(vcfc, version=5))
    r = jz.VcfzReader.parse(bytes(z))
    blk = r.blocks[0]
    start = r.payload_base + blk["payload_off"]
    z[start : start + blk["payload_len"]] = b"\xff" * blk["payload_len"]
    with pytest.raises(ValueError, match="invalid Huffman"):
        tzd.vcfz_to_vcfc_device(bytes(z), device=CPU)


def test_host_setting_keeps_the_dense_branch(monkeypatch, compact_calls):
    """VCFZ_COMPACT=host on both routes: no compaction on the device, the
    same bytes."""
    monkeypatch.setenv("VCFZ_COMPACT", "host")
    vcfc = _fuzz_vcfc()
    for version in DECODE_VERSIONS:
        z = tz.vcfz_from_vcfc(vcfc, version=version, route="device", device=CPU)
        assert z == jz.vcfz_from_vcfc(vcfc, version=version)
        assert tzd.vcfz_to_vcfc_device(z, device=CPU) == vcfc
    assert compact_calls == {"pack_cells_compact": [], "sort_compact": 0}


@pytest.mark.parametrize("env,cpu,cuda", [(None, False, True), ("device", True, True),
                                          ("host", False, False), ("other", False, True)])
def test_device_compaction_reads_the_env_per_device_type(monkeypatch, env, cpu, cuda):
    """VCFZ_COMPACT=device|host forces the branch (as the JAX package's
    device_compaction() does); unset or another value, the CPU takes the
    host branch and a CUDA device the device branch."""
    if env is None:
        monkeypatch.delenv("VCFZ_COMPACT", raising=False)
    else:
        monkeypatch.setenv("VCFZ_COMPACT", env)
    assert td.device_compaction("cpu") is cpu
    assert td.device_compaction(torch.device("cpu")) is cpu
    assert td.device_compaction("cuda") is cuda
    assert td.device_compaction(torch.device("cuda", 0)) is cuda
    if env in ("device", "host"):
        assert jd.device_compaction() is cpu
