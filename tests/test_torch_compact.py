"""The port's on-device compaction ops (vcfc_tpu_torch.ops.vcfz_device) on the
CPU, against vcfc_tpu.ops.vcfz_device on JAX's CPU backend.

``sort_compact`` (the plain form, the spec of the Hopper kernel S1) is held
to the JAX package's stable sort element by element on the whole row, tail
included, and on the counts; ``_bucket``, ``pack_cells_compact``,
``compact_payloads_device`` and ``esc_plane_device`` to the JAX package's.
A numpy model of S1's three passes (``csrc/compact_kernels.cu``: chunk
counts, a warp's scan of a row's chunks, the ranked writes of 256-cell
tiles) is held to the plain form, so that its indexing is checked where no
card is.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcfc_tpu.ops import huffman as jh
from vcfc_tpu.ops import vcfz_device as jd
from vcfc_tpu_torch.ops import cuda_compact
from vcfc_tpu_torch.ops import vcfz_device as td

DENSITIES = [0.0, 0.18, 0.5, 1.0]
# (rows, cells): one chunk of the kernel, a width no chunk divides, more
# chunks than a warp scans in one step, and a single cell
SHAPES = [(7, 4096), (7, 9000), (3, 140_000), (6, 1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _grid(seed, shape, density):
    """int32 values over the whole range (bit 31 set in half of them) and a
    mask at the density, with an empty row, a fully masked row and a row
    masked on its last cell only."""
    rng = np.random.default_rng(seed)
    B, n = shape
    values = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)
    mask = rng.random(shape) < density
    mask[0] = False
    mask[1 % B] = True
    if B > 2:
        mask[2] = False
        mask[2, -1] = True
    return values, mask


def _jax_sort_compact(values, mask):
    got_v, got_c = jd.sort_compact(jnp.asarray(values), jnp.asarray(mask))
    return np.asarray(got_v), np.asarray(got_c)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("density", DENSITIES)
def test_sort_compact_matches_jax(shape, density):
    values, mask = _grid(int(density * 100) + shape[1], shape, density)
    got_v, got_c = td.sort_compact(_t(values), _t(mask))
    want_v, want_c = _jax_sort_compact(values, mask)
    assert got_v.dtype == torch.int32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert got_c.tolist() == mask.sum(axis=1).tolist()


def test_sort_compact_takes_a_uint8_mask_and_an_empty_width():
    values, mask = _grid(5, (4, 300), 0.3)
    want = td.sort_compact(_t(values), _t(mask))
    got = td.sort_compact(_t(values), _t(mask.astype(np.uint8)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    v, c = td.sort_compact(torch.zeros((3, 0), dtype=torch.int32),
                           torch.zeros((3, 0), dtype=torch.bool))
    assert v.shape == (3, 0) and c.tolist() == [0, 0, 0]


def test_sort_compact_checks_its_shapes():
    with pytest.raises(ValueError, match="2-D"):
        td.sort_compact(torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="2-D"):
        td.sort_compact(torch.zeros((2, 5), dtype=torch.int32),
                        torch.zeros((2, 4), dtype=torch.bool))


def test_sort_compact_does_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    takes CUDA tensors only: it raises instead of running the plain form."""
    values = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        td.sort_compact(values, torch.zeros((2, 8), dtype=torch.bool, device="meta"))
    with pytest.raises(TypeError, match="int32"):
        cuda_compact.cuda_sort_compact(values.long(), torch.zeros((2, 8), dtype=torch.bool))


@pytest.mark.parametrize("k,n", [(0, 10), (0, 100_000), (1, 4096), (4096, 100_000),
                                 (4097, 100_000), (9000, 9001), (99_999, 100_000),
                                 (565_248, 565_248)])
def test_bucket_matches_jax(k, n):
    assert td._bucket(k, n) == jd._bucket(k, n)
    assert td._SLICE_BUCKET == jd._SLICE_BUCKET


# --- a numpy model of S1 (csrc/compact_kernels.cu) ------------------------------------

THREADS, WARP = 256, 32


def _kernel_model(values, mask):
    """S1's three passes in numpy, as its blocks and warps take them: pass 1
    counts each (row, chunk)'s masked cells, pass 2 scans a row's chunk
    counts 32 at a time (a warp's step) and writes the row's count, pass 3
    walks each chunk a tile of 256 cells at a time and writes each value to
    its place from the tile's warp counts and each lane's rank in its
    warp's ballot."""
    B, n = values.shape
    chunk = cuda_compact.CHUNK
    n_chunks = -(-n // chunk)
    m = mask != 0
    chunk_count = np.zeros((B, n_chunks), np.int64)
    for k in range(n_chunks):
        chunk_count[:, k] = m[:, k * chunk : (k + 1) * chunk].sum(axis=1)
    base = np.zeros_like(chunk_count)
    counts = np.zeros(B, np.int64)
    for b in range(B):
        carry = 0
        for k0 in range(0, n_chunks, WARP):
            v = chunk_count[b, k0 : k0 + WARP]
            incl = np.cumsum(v)
            base[b, k0 : k0 + WARP] = carry + incl - v
            carry += int(incl[-1])
        counts[b] = carry
    out = np.full_like(values, 0x5A5A5A5A)  # cells the model misses stay marked
    lane = np.arange(WARP)
    for b in range(B):
        for k in range(n_chunks):
            c0, c1 = k * chunk, min((k + 1) * chunk, n)
            before_tile = base[b, k]
            for t0 in range(c0, c1, THREADS):
                i = t0 + np.arange(THREADS)
                inside = i < c1
                tile = np.zeros(THREADS, bool)
                tile[inside] = m[b, i[inside]]
                warps = tile.reshape(-1, WARP)
                ballots = (warps.astype(np.int64) << lane).sum(axis=1)
                warp_count = warps.sum(axis=1)
                before_warp = np.cumsum(warp_count) - warp_count
                below = (1 << lane) - 1
                rank = np.array([bin(int(ballots[w]) & int(below[j])).count("1")
                                 for w in range(len(ballots)) for j in lane])
                c = before_tile + np.repeat(before_warp, WARP) + rank
                dst = np.where(tile, c, counts[b] + i - c)
                out[b, dst[inside]] = values[b, i[inside]]
                before_tile += int(warp_count.sum())
    return out, counts.astype(np.int32)


@pytest.mark.parametrize("shape", [(5, 4096), (5, 9000), (2, 140_000), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("density", DENSITIES)
def test_kernel_model_matches_plain(shape, density):
    values, mask = _grid(int(density * 10) + shape[0], shape, density)
    want_v, want_c = td.sort_compact_plain(_t(values), _t(mask))
    got_v, got_c = _kernel_model(values, mask)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())


# --- pack_cells_compact, compact_payloads_device, esc_plane_device -------------------


def _symbol_grid(seed=11, n_blocks=5, B=4096, alphabet=300):
    rng = np.random.default_rng(seed)
    grid = np.where(rng.random((n_blocks, B)) < 0.18,
                    rng.integers(1, alphabet, (n_blocks, B)), 0).astype(np.int32)
    grid[3] = 0  # an empty row: counts 0, an empty payload
    return grid


def _books(grid, n_ctx, alphabet=300):
    streams = [row[row != 0].astype(np.int64) for row in grid]
    if n_ctx == 1:
        return [jh.Codebook.from_frequencies(np.bincount(np.concatenate(streams),
                                                         minlength=alphabet))]
    return jh.context_codebooks(streams, alphabet, jh.symbol_classes(alphabet), n_ctx)


@pytest.mark.parametrize("n_ctx", [1, 4])
def test_pack_cells_compact_matches_jax(n_ctx):
    """The JAX package's TestPackCellsCompact on both ports: a width three
    cells past the largest count, every element of the four outputs equal,
    and the payloads the dense packer's."""
    grid = _symbol_grid()
    books = _books(grid, n_ctx)
    entries = jd.pack_entries(books)
    dense = td.pack_cells(_t(grid), _t(grid != 0), _t(entries), 10**9, jh.CTX_INIT,
                          n_ctx=n_ctx, v4=False)
    want_payloads = td.compact_payloads(*(x.numpy() for x in dense[:3]))

    sc, cnt = td.sort_compact(_t(grid), _t(grid != 0))
    kb = int(cnt.max()) + 3  # deliberately untidy width
    got = td.pack_cells_compact(sc[:, :kb], cnt, _t(entries), 10**9, jh.CTX_INIT,
                                n_ctx=n_ctx, v4=False)
    jsc, jcnt = jd.sort_compact(jnp.asarray(grid), jnp.asarray(grid != 0))
    want = jd.pack_cells_compact(jsc[:, :kb], jcnt, jnp.asarray(entries), 10**9, jh.CTX_INIT,
                                 n_ctx=n_ctx, v4=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    assert got[0].dtype == got[2].dtype == torch.int32 and got[1].dtype == torch.bool
    assert not got[3].any()
    np.testing.assert_array_equal(got[2].numpy(), dense[2].numpy())
    assert td.compact_payloads(*(x.numpy() for x in got[:3])) == want_payloads


def test_pack_cells_compact_flags_a_width_under_the_count():
    """A width under a row's count would cut its stream short: that row is
    bad, the others are not."""
    grid = _symbol_grid(seed=12)
    books = _books(grid, 1)
    sc, cnt = td.sort_compact(_t(grid), _t(grid != 0))
    short = int(cnt[0]) - 1
    _wv, _emit, _bits, bad = td.pack_cells_compact(
        sc[:, :short], cnt, _t(jd.pack_entries(books)), 10**9, 0, n_ctx=1, v4=False)
    assert bad.tolist() == (cnt > short).tolist() and bad[0] and not bad[3]


@pytest.mark.parametrize("n_ctx", [1, 4])
def test_compact_payloads_device_matches_jax_and_the_host_compaction(n_ctx):
    grid = _symbol_grid(seed=13)
    books = _books(grid, n_ctx)
    entries = jd.pack_entries(books)
    wv, emit, bits, _bad = td.pack_cells(_t(grid), _t(grid != 0), _t(entries), 10**9,
                                         jh.CTX_INIT, n_ctx=n_ctx, v4=False)
    got = td.compact_payloads_device(wv, emit, bits)
    assert got == td.compact_payloads(wv.numpy(), emit.numpy(), bits.numpy())
    assert got == jd.compact_payloads_device(jnp.asarray(wv.numpy()), jnp.asarray(emit.numpy()),
                                             jnp.asarray(bits.numpy()))
    assert got[3] == b""
    stage = td.HostStage("cpu")  # one buffer across calls, as a route reuses it
    assert td.compact_payloads_device(wv, emit, bits, stage) == got
    assert td.compact_payloads_device(wv[:2], emit[:2], bits[:2], stage) == got[:2]


@pytest.mark.parametrize("where", ["none", "last line", "spread"])
def test_esc_plane_device_matches_jax(where):
    lpb, s_pad = 48, 256
    rng = np.random.default_rng(17)
    if where == "none":
        lines = samples = ids = np.zeros(0, np.int32)
    elif where == "last line":
        samples = np.sort(rng.choice(250, 9, replace=False)).astype(np.int32)
        lines = np.full(9, lpb - 1, np.int32)
        ids = rng.integers(0, 900, 9).astype(np.int32)
    else:
        cells = np.sort(rng.choice(lpb * 250, 200, replace=False))
        lines, samples = (cells // 250).astype(np.int32), (cells % 250).astype(np.int32)
        ids = rng.integers(0, 5000, 200).astype(np.int32)
    got = td.esc_plane_device(lines, samples, ids, lpb, s_pad, "cpu")
    want = jd.esc_plane_device(lines, samples, ids, lpb, s_pad)
    assert got.dtype == torch.int32 and got.shape == (lpb, s_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_stage_reuses_and_grows_its_buffer():
    stage = td.HostStage("cpu")
    assert not stage.pinned
    a = stage.take((4, 8), torch.int32)
    ptr = stage.buf.data_ptr()
    b = stage.take((2, 3), torch.int32)
    assert b.shape == (2, 3) and stage.buf.data_ptr() == ptr
    stage.take((100, 100), torch.int32)
    assert stage.buf.numel() == 40_000 and a.shape == (4, 8)
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    np.testing.assert_array_equal(stage.fetch(x), x.numpy())
