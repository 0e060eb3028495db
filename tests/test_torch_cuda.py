"""The CUDA kernels of vcfc_tpu_torch against their plain PyTorch versions.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every output is integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from vcfc_tpu_torch import engine
from vcfc_tpu_torch.eval.edge_cases import encode_edge_cases, flag_edge_cases, text_edge_cases
from vcfc_tpu_torch.eval.huffman_cases import decode_cases
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.ops import _build, cuda_compact, cuda_huffman, cuda_rle, probe
from vcfc_tpu_torch.ops import huffman_device as hd
from vcfc_tpu_torch.ops import vcfz_device as vd
from vcfc_tpu_torch.ops.rle import (
    rle_decode_plain,
    rle_encode_plain,
    text_rle_decode_plain,
    text_rle_encode_plain,
    unpack_packed_flags,
)

pytestmark = pytest.mark.cuda

P = [0.81, 0.072, 0.072, 0.0264, 0.0196]
EDGE = encode_edge_cases()
FLAG_EDGE = flag_edge_cases()
TEXT_EDGE = text_edge_cases()
HUFFMAN = decode_cases()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _misaligned(x):
    """A contiguous copy of x whose data starts one element past where a
    new tensor's would, so no row start is 16-byte aligned."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize(
    "L,W,S,p",
    [
        (256, 2560, 2504, P),
        (8, 50048, 50000, P),
        (64, 128, 1, P),
        (64, 128, 127, P),
        (64, 16384, 16300, [1.0, 0, 0, 0, 0]),  # runs past every tile
        (64, 4096, 4000, [0.1, 0.05, 0.05, 0.05, 0.75]),  # escape-dense
        (64, 1000, 990, P),  # a width the 16-byte loads do not divide
    ],
)
def test_kernels_match_plain(cuda_device, L, W, S, p):
    rng = np.random.default_rng(W + S)
    codes = rng.choice(5, size=(L, W), p=p).astype(np.uint8)
    codes[:5, :S] = np.arange(5, dtype=np.uint8)[:5, None]
    x = torch.from_numpy(codes).to(cuda_device)
    flags, nseg = cuda_rle.cuda_rle_encode(x, S)
    _assert_equal((flags, nseg), rle_encode_plain(x, S))
    _assert_equal(cuda_rle.cuda_rle_decode(flags, S), rle_decode_plain(flags, S))


@pytest.mark.parametrize("W,S", [(384, 300), (2560, 2504), (1000, 990)])
def test_decode_of_malformed_planes_matches_plain(cuda_device, W, S):
    rng = np.random.default_rng(W)
    flags = rng.integers(0, 256, (64, W), dtype=np.uint8)
    flags[rng.random((64, W)) < 0.97] = 0  # gaps past 127 cells
    flags[:4] = 0
    x = torch.from_numpy(flags).to(cuda_device)
    _assert_equal(cuda_rle.cuda_rle_decode(x, S), rle_decode_plain(x, S))
    _assert_equal(cuda_rle.cuda_probe_tile_decode(x, S), rle_decode_plain(x, S))


@pytest.mark.parametrize("case", range(len(EDGE)), ids=[name for name, _, _ in EDGE])
def test_edge_cases_match_plain(cuda_device, case):
    """K1, then K2 and C5 on its flags, on the runs, wraps and escapes of
    eval.edge_cases."""
    _name, codes, S = EDGE[case]
    x = torch.from_numpy(codes).to(cuda_device)
    flags, nseg = cuda_rle.cuda_rle_encode(x, S)
    _assert_equal((flags, nseg), rle_encode_plain(x, S))
    _assert_equal(cuda_rle.cuda_probe_blocked_encode(x, S, 16), (flags, nseg))
    want = rle_decode_plain(flags, S)
    _assert_equal(cuda_rle.cuda_rle_decode(flags, S), want)
    _assert_equal(cuda_rle.cuda_probe_tile_decode(flags, S), want)


@pytest.mark.parametrize("case", range(len(FLAG_EDGE)), ids=[name for name, _, _ in FLAG_EDGE])
def test_flag_edge_cases_match_plain(cuda_device, case):
    _name, flags, S = FLAG_EDGE[case]
    x = torch.from_numpy(flags).to(cuda_device)
    want = rle_decode_plain(x, S)
    _assert_equal(cuda_rle.cuda_rle_decode(x, S), want)
    _assert_equal(cuda_rle.cuda_probe_tile_decode(x, S), want)


@pytest.mark.parametrize(
    "L,W,S",
    [(256, 2560, 2504), (8, 50048, 50000), (64, 128, 1), (64, 128, 127), (64, 1000, 990)],
)
def test_text_kernels_match_plain(cuda_device, L, W, S):
    """K3 on words of every kind (genotypes, escapes, bad separators, zero
    rows, arbitrary 32-bit words), then K4 on its flags and on a malformed
    plane."""
    rng = np.random.default_rng(W + S + 1)
    fields = np.frombuffer(b"0|0\t0|1\t1|0\t1|1\t2|0\t./.\t0|0x", np.uint32)
    words = fields[rng.choice(len(fields), size=(L, W), p=[0.7, 0.1, 0.08, 0.06, 0.03, 0.02, 0.01])]
    words[: L // 8] = rng.integers(0, 1 << 32, (L // 8, W), dtype=np.uint32)
    words[L // 8 : L // 4] = 0
    words[:, S:] = 0
    x = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    flags, nseg, seps_ok = cuda_rle.cuda_text_encode(x, S)
    _assert_equal((flags, nseg, seps_ok), text_rle_encode_plain(x, S))
    _assert_equal(cuda_rle.cuda_text_decode(flags, S), text_rle_decode_plain(flags, S))
    malformed = torch.from_numpy(rng.integers(0, 256, (L, W), dtype=np.uint8)).to(cuda_device)
    malformed[torch.rand(L, W, device=cuda_device) < 0.97] = 0
    _assert_equal(cuda_rle.cuda_text_decode(malformed, S), text_rle_decode_plain(malformed, S))
    _assert_equal(cuda_rle.cuda_probe_tile_text_encode(x, S), (flags, nseg, seps_ok))
    _assert_equal(cuda_rle.cuda_probe_tile_text_decode(malformed, S),
                  text_rle_decode_plain(malformed, S))


@pytest.mark.parametrize("layout", ["as cut", "width 1000", "misaligned start"])
@pytest.mark.parametrize("case", range(len(TEXT_EDGE)), ids=[name for name, _, _ in TEXT_EDGE])
def test_text_edge_cases_match_plain(cuda_device, case, layout):
    """K3 and C6 on the edge cases as words, then K4 and C7 on K3's flags:
    at the case's width (1,024), cut to 1,000 columns (no multiple of 16,
    so no row but the first starts on a 16-byte boundary) and starting
    one element past an aligned address."""
    _name, words, n = TEXT_EDGE[case]
    if layout == "width 1000":
        words = np.ascontiguousarray(words[:, :1000])
    x = torch.from_numpy(words).to(cuda_device)
    if layout == "misaligned start":
        x = _misaligned(x)
    want = text_rle_encode_plain(x, n)
    _assert_equal(cuda_rle.cuda_text_encode(x, n), want)
    _assert_equal(cuda_rle.cuda_probe_tile_text_encode(x, n), want)
    flags = _misaligned(want[0]) if layout == "misaligned start" else want[0]
    want = text_rle_decode_plain(flags, n)
    _assert_equal(cuda_rle.cuda_text_decode(flags, n), want)
    _assert_equal(cuda_rle.cuda_probe_tile_text_decode(flags, n), want)


@pytest.mark.parametrize("case", range(len(FLAG_EDGE)), ids=[name for name, _, _ in FLAG_EDGE])
def test_text_decode_of_flag_edge_cases_matches_plain(cuda_device, case):
    _name, flags, S = FLAG_EDGE[case]
    x = torch.from_numpy(flags).to(cuda_device)
    want = text_rle_decode_plain(x, S)
    _assert_equal(cuda_rle.cuda_text_decode(x, S), want)
    _assert_equal(cuda_rle.cuda_probe_tile_text_decode(x, S), want)
    _assert_equal(cuda_rle.cuda_text_decode(_misaligned(x), S), want)


@pytest.mark.parametrize("kernel", ["rle_encode", "rle_decode", "text_encode", "text_decode"])
def test_kernel_info_reports_every_kernel(cuda_device, kernel):
    info = cuda_rle.kernel_info(kernel)
    assert info["registers"] > 0 and info["local_bytes"] >= 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("parse", [None, "device"], ids=["parse-route", "text-route"])
def test_engine_on_cuda_matches_cpu(cuda_device, monkeypatch, parse):
    if parse:
        monkeypatch.setenv("VCFC_PARSE", parse)
    vcf = generate_realistic_vcf(300, 600, seed=9)
    kernels = ("text_encode", "text_decode") if parse else ("rle_encode", "rle_decode")
    before = dict(cuda_rle.LAUNCHES)
    vcfc = engine.compress(vcf, force_device=True, device=cuda_device)
    assert vcfc == engine.compress(vcf, force_device=True, device="cpu")
    assert engine.decompress(vcfc, force_device=True, device=cuda_device) == vcf
    assert all(cuda_rle.LAUNCHES[k] > before[k] for k in kernels)


def _batch_loop_inputs(S=300, L=1000):
    """Each batch loop of the engine as a function of (line_batch, device),
    on one corpus: 4 batches of 256 lines (the last short)."""
    from vcfc_tpu_torch.format.vcf import compress_bytes, parse_metadata_headers
    from vcfc_tpu_torch.host import fast, native
    from vcfc_tpu_torch.host.parse import parse_vcf_bytes

    vcf = generate_realistic_vcf(S, L, seed=12)
    parsed = parse_vcf_bytes(vcf)
    flagpos, _ = engine.encode_on_device(parsed.codes, S, 1024, "cpu")
    header = parse_metadata_headers(vcf)
    raw = np.frombuffer(vcf, np.uint8)
    _start, end, sample_start = native.index_lines(raw, header.data_offset)
    irregular = (end - sample_start) != 4 * S - 1
    body = raw[header.data_offset :]
    packed = fast.parse_vcfc_packed_native(compress_bytes(vcf))
    return {
        "encode_on_device": lambda lb, d: engine.encode_on_device(parsed.codes, S, lb, d),
        "decode_on_device": lambda lb, d: engine.decode_on_device(flagpos[:, :S], S, lb, d),
        "encode_text_on_device": lambda lb, d: engine.encode_text_on_device(
            body, sample_start, irregular, S, lb, d),
        "decode_text_on_device": lambda lb, d: engine.decode_text_on_device(flagpos, S, lb, d),
        "unpack_decode_on_device": lambda lb, d: engine.unpack_decode_on_device(
            packed.flags, packed.nflags, S, lb, d),
    }


@pytest.mark.parametrize("loop", ["encode_on_device", "decode_on_device", "encode_text_on_device",
                                  "decode_text_on_device", "unpack_decode_on_device"])
def test_pipelined_batch_loops_match_cpu(cuda_device, loop):
    """The CUDA pipeline (pinned buffers reused over 4 batches, a copy
    stream and a compute stream) against the CPU loop in one batch,
    element by element."""
    run = _batch_loop_inputs()[loop]
    want = run(1024, "cpu")
    for _ in range(2):  # the second call reuses the cached pinned blocks
        got = run(256, cuda_device)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["codes", "flags", "bytes"])
def test_histograms_on_cuda_match_cpu(cuda_device, kind):
    from vcfc_tpu_torch.ops import histogram

    rng = np.random.default_rng(13)
    codes = rng.choice(5, size=(512, 2560), p=P).astype(np.uint8)
    codes[:, 2504:] = 0
    codes[-7:] = 0  # zero-padded rows
    plane = {"codes": codes, "flags": rle_encode_plain(torch.from_numpy(codes), 2504)[0].numpy(),
             "bytes": rng.integers(0, 256, (512, 2560), dtype=np.uint8)}[kind]
    x, y = torch.from_numpy(plane), torch.from_numpy(plane).to(cuda_device)
    _assert_equal([histogram.code_histogram(y).cpu()], [histogram.code_histogram(x)])
    for n in (1, 1000, 2504, 2560, 5000):
        _assert_equal([histogram.masked_code_histogram(y, n).cpu(),
                       histogram.ctx_flag_histogram(y, n).cpu()],
                      [histogram.masked_code_histogram(x, n), histogram.ctx_flag_histogram(x, n)])


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_steps_on_cuda_match_cpu(cuda_device, shards):
    """Each sharded step over shards on the one card (a stream each)
    against the same step over CPU shards."""
    from vcfc_tpu_torch.parallel import dryrun, shard
    from vcfc_tpu_torch.parallel.mesh import make_data_mesh

    cuda = make_data_mesh(devices=(cuda_device,) * shards)
    cpu = make_data_mesh(devices=("cpu",) * shards)
    L, W, n = 768 * shards, 2560, 2504
    codes = np.random.default_rng(shards).choice(5, size=(L, W), p=P).astype(np.uint8)
    codes[:, n:] = 0
    flagpos = rle_encode_plain(torch.from_numpy(codes), n)[0].numpy()
    packed, nflags = dryrun.pack_flags(flagpos)
    text = dryrun.code_words(codes, n)
    for make, args in [
        (shard.make_sharded_encode_step, (codes, n)),
        (shard.make_sharded_codebook_step, (codes, n)),
        (shard.make_sharded_decode_step, (flagpos, n)),
        (lambda mesh: shard.make_sharded_unpack_decode_step(mesh, W), (packed, nflags, n)),
        (shard.make_sharded_text_step, (text, n)),
        (shard.make_sharded_roundtrip_step, (codes, n)),
    ]:
        _assert_equal(make(cuda)(*args), make(cpu)(*args))


def test_sharded_codec_and_dryrun_on_cuda(cuda_device):
    from vcfc_tpu_torch.format.vcf import compress_bytes
    from vcfc_tpu_torch.parallel.dryrun import dryrun_multichip

    vcf = generate_realistic_vcf(300, 5000, seed=14)
    vcfc = compress_bytes(vcf)
    before = dict(cuda_rle.LAUNCHES)
    for mesh in (None, (cuda_device,) * 2):
        assert engine.compress_sharded(vcf, mesh) == vcfc
        assert engine.decompress_sharded(vcfc, mesh) == vcf
    assert all(cuda_rle.LAUNCHES[k] > before[k] for k in ("rle_encode", "rle_decode"))
    dryrun_multichip(torch.cuda.device_count())
    dryrun_multichip(2, devices=(cuda_device,) * 2)


@pytest.mark.parametrize(
    "L,W,S,p",
    [
        (256, 2560, 2560, P),  # the ablation's shape
        (64, 384, 300, P),  # n < width
        (64, 1, 1, P),
        (64, 17, 17, P),
        (64, 192, 192, P),
        (64, 2504, 2504, P),  # a width no group of cells divides
        (4, 50000, 50000, P),
        (64, 4096, 4000, [0.0, 0, 0, 0, 1.0]),  # all escapes
        (64, 4096, 4000, [1.0, 0, 0, 0, 0]),  # all 0|0: runs past every tile
    ],
)
def test_probes_match_plain(cuda_device, L, W, S, p):
    """C1 and C4 at every cells a thread, C2, C3; C4's outputs are K1's,
    C5's K2's."""
    rng = np.random.default_rng(W + S + 2)
    codes = rng.choice(5, size=(L, W), p=p).astype(np.uint8)
    x = torch.from_numpy(codes).to(cuda_device)
    k1 = cuda_rle.cuda_rle_encode(x, S)
    for cells in cuda_rle.PROBE_CELLS:
        _assert_equal(cuda_rle.cuda_probe_scan_only(x, S, cells), probe.scan_only_plain(x, S))
        _assert_equal(cuda_rle.cuda_probe_blocked_encode(x, S, cells), k1)
    _assert_equal(k1, rle_encode_plain(x, S))
    _assert_equal(cuda_rle.cuda_probe_scan_replaced(x, S), probe.scan_replaced_plain(x, S))
    _assert_equal(cuda_rle.cuda_probe_roundtrip(x, S), probe.roundtrip_plain(x, S))
    _assert_equal(cuda_rle.cuda_probe_tile_decode(k1[0], S), cuda_rle.cuda_rle_decode(k1[0], S))


def test_roundtrip_probe_takes_wide_rows_and_refuses_wider(cuda_device):
    rng = np.random.default_rng(65536)
    x = torch.from_numpy(rng.choice(5, size=(8, 65536), p=P).astype(np.uint8)).to(cuda_device)
    _assert_equal(cuda_rle.cuda_probe_roundtrip(x, 65500), probe.roundtrip_plain(x, 65500))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rle.cuda_probe_roundtrip(torch.zeros((1, 1 << 18), dtype=torch.uint8,
                                                  device=cuda_device), 1 << 18)


def test_unpack_on_cuda_matches_cpu(cuda_device):
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 256, (256, 640), dtype=np.uint8)
    nflags = rng.integers(0, 641, 256).astype(np.int32)
    want = unpack_packed_flags(torch.from_numpy(packed), torch.from_numpy(nflags), 2560)
    got = unpack_packed_flags(torch.from_numpy(packed).to(cuda_device),
                              torch.from_numpy(nflags).to(cuda_device), 2560)
    assert torch.equal(got.cpu(), want)


def test_unpack_route_on_cuda_matches_cpu(cuda_device, monkeypatch):
    monkeypatch.setenv("VCFC_UNPACK", "device")
    vcf = generate_realistic_vcf(300, 600, seed=9)
    vcfc = engine.compress(vcf, force_device=True, device="cpu")
    before = cuda_rle.LAUNCHES["rle_decode"]
    assert engine.decompress(vcfc, force_device=True, device=cuda_device) == vcf
    assert cuda_rle.LAUNCHES["rle_decode"] > before


@pytest.mark.parametrize("n_ctx", [1, 4])
def test_vcfz_ops_on_cuda_match_cpu(cuda_device, n_ctx):
    """sympos_v3, ctx_plane and pack_cells on the card against their CPU
    form, element by element, on sparse grids of cohort blocks (words with
    bit 31 set among them) and on a block holding four symbols."""
    from vcfc_tpu_torch.ops import vcfz_device as vd
    from vcfc_tpu_torch.ops.huffman import CTX_INIT, Codebook, context_codebooks

    rng = np.random.default_rng(21 + n_ctx)
    flags = np.where(rng.random((512, 2560)) < 0.2, rng.integers(1, 256, (512, 2560)), 0)
    flags[rng.random((512, 2560)) < 0.01] = 0xE1
    esc = rng.integers(0, 40, (512, 2560)).astype(np.int32)
    sym = vd.sympos_v3(torch.from_numpy(flags.astype(np.uint8)), torch.from_numpy(esc))
    got = vd.sympos_v3(torch.from_numpy(flags.astype(np.uint8)).to(cuda_device),
                       torch.from_numpy(esc).to(cuda_device))
    assert torch.equal(got.cpu(), sym)
    cells = sym.reshape(2, 256 * 2560)  # two blocks of 256 lines
    streams = [row[row != 0].numpy().astype(np.int64) for row in cells]
    alphabet = 256 + 40
    if n_ctx == 1:
        books = [Codebook.from_frequencies(np.bincount(np.concatenate(streams),
                                                       minlength=alphabet))]
    else:
        books = context_codebooks(streams, alphabet)
    entries = torch.from_numpy(vd.pack_entries(books))
    valid = cells != 0
    ctx = vd.ctx_plane(cells, valid, alphabet, CTX_INIT, v4=False)
    assert torch.equal(vd.ctx_plane(cells.to(cuda_device), valid.to(cuda_device), alphabet,
                                    CTX_INIT, v4=False).cpu(), ctx)
    boundary = torch.zeros((1, 256 * 2560), dtype=torch.int32)
    boundary[0, :4] = torch.tensor([0x7F, 0x7F, 0x7F, 0x7F])  # whole words of 0|0 runs
    for grid in (cells, boundary):
        want = vd.pack_cells(grid, grid != 0, entries, alphabet, CTX_INIT, n_ctx=n_ctx, v4=False)
        out = vd.pack_cells(grid.to(cuda_device), (grid != 0).to(cuda_device),
                            entries.to(cuda_device), alphabet, CTX_INIT, n_ctx=n_ctx, v4=False)
        for g, w in zip(out, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        if grid is cells:
            assert (want[0][want[1]] < 0).any()  # words with bit 31 set


@pytest.mark.parametrize("version", [1, 2, 3, 5, 8])
def test_vcfz_device_route_on_cuda_matches_host_writer(cuda_device, monkeypatch, version):
    """The device route on the card, in one batch and in batches of 4
    blocks, byte-identical to the host writer; the route's counter moves
    once a container."""
    from vcfc_tpu_torch.format import vcfz, vcfz_device

    vcfc = engine.compress(generate_realistic_vcf(300, 1500, seed=14), force_device=True,
                           device="cpu")
    want = vcfz.vcfz_from_vcfc(vcfc, version=version)
    before = vcfz_device.ENCODES[version]
    assert vcfz.vcfz_from_vcfc(vcfc, version=version, route="device",
                               device=cuda_device) == want
    want16 = vcfz.vcfz_from_vcfc(vcfc, block_lines=16, version=version)
    monkeypatch.setattr(vcfz_device, "_MAX_CELLS", 16 * 384 * 4)
    assert vcfz_device.vcfz_from_vcfc_device(vcfc, 16, version, device=cuda_device) == want16
    assert vcfz_device.ENCODES[version] == before + 2


@pytest.mark.parametrize("case", range(len(HUFFMAN)), ids=[name for name, *_ in HUFFMAN])
def test_huffman_decode_bits_matches_plain(cuda_device, case):
    """The Hopper decode against decode_bits_plain, on the card and on the
    CPU, element by element; decode_bits on a CUDA tensor launches it."""
    _name, words, book, s1, s2 = HUFFMAN[case]
    limits, adjust, _ = hd.device_decode_tables(book)
    x = torch.from_numpy(words).to(cuda_device)
    before = cuda_huffman.LAUNCHES["huffman_decode_bits"]
    got = hd.decode_bits(x, limits, adjust, s1=s1, s2=s2)
    assert cuda_huffman.LAUNCHES["huffman_decode_bits"] == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, hd.decode_bits_plain(x, limits, adjust, s1=s1, s2=s2))
    assert torch.equal(got.cpu(), hd.decode_bits_plain(torch.from_numpy(words), limits, adjust,
                                                       s1=s1, s2=s2))


def test_huffman_unpack_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """device_unpack_symbols on the card, in one dispatch and in several,
    equal to the CPU's; a truncated stream raises on both."""
    from vcfc_tpu_torch.ops.huffman import Codebook, pack_symbols

    rng = np.random.default_rng(31)
    book = Codebook.from_frequencies(rng.integers(1, 1000, 300))
    streams = [rng.integers(0, 300, int(rng.integers(1, 20000))) for _ in range(9)]
    payloads = [pack_symbols(s, book)[0] for s in streams]
    n = [len(s) for s in streams]
    for max_bits in (hd._MAX_DISPATCH_BITS, 3 * 65536):
        monkeypatch.setattr(hd, "_MAX_DISPATCH_BITS", max_bits)
        got = hd.device_unpack_symbols(payloads, n, book, device=cuda_device)
        for g, s in zip(got, streams):
            np.testing.assert_array_equal(g, s)
    with pytest.raises(ValueError, match="invalid Huffman"):
        hd.device_unpack_symbols([payloads[0][:3]], [n[0]], book, device=cuda_device)


@pytest.mark.parametrize("version", [1, 5, 8])
def test_vcfz_device_decode_on_cuda(cuda_device, version):
    """decompress_vcfz(route="device") on the card restores the input; the
    route's counter and the kernel's launches move."""
    from vcfc_tpu_torch.format import vcfz, vcfz_device

    vcf = generate_realistic_vcf(300, 1500, seed=15)
    vcfc = engine.compress(vcf, force_device=True, device="cpu")
    z = vcfz.vcfz_from_vcfc(vcfc, block_lines=64, version=version)
    before = (vcfz_device.DECODES[version], cuda_huffman.LAUNCHES["huffman_decode_bits"])
    assert vcfz_device.vcfz_to_vcfc_device(z, device=cuda_device) == vcfc
    assert vcfz.decompress_vcfz(z, route="device", device=cuda_device) == vcf
    assert vcfz_device.DECODES[version] == before[0] + 2
    assert cuda_huffman.LAUNCHES["huffman_decode_bits"] > before[1]


@pytest.mark.parametrize("B,n", [(118, 565_248), (7, 4096), (5, 9000), (3, 140_000), (4, 1),
                                 (1, 4097), (300, 257)])
@pytest.mark.parametrize("density", [0.0, 0.18, 0.5, 1.0])
def test_sort_compact_matches_plain(cuda_device, B, n, density):
    """S1 against sort_compact_plain, on the card and on the CPU, element by
    element on the whole row and on the counts, with an empty row, a full
    row and a row masked on its last cell only; sort_compact on a CUDA
    tensor launches it, with a bool mask and with a uint8 one."""
    rng = np.random.default_rng(B * 7 + n)
    values = rng.integers(-(1 << 31), 1 << 31, (B, n), dtype=np.int64).astype(np.int32)
    mask = rng.random((B, n)) < density
    mask[0] = False
    mask[1 % B] = True
    mask[2 % B, -1] = True
    v, m = torch.from_numpy(values).to(cuda_device), torch.from_numpy(mask).to(cuda_device)
    before = cuda_compact.LAUNCHES["sort_compact"]
    got = vd.sort_compact(v, m)
    got8 = vd.sort_compact(v, m.to(torch.uint8))
    assert cuda_compact.LAUNCHES["sort_compact"] == before + 2
    want = vd.sort_compact_plain(v, m)
    want_cpu = vd.sort_compact_plain(torch.from_numpy(values), torch.from_numpy(mask))
    for g, g8, w, wc in zip(got, got8, want, want_cpu):
        assert g.dtype == torch.int32 and g.device.type == "cuda"
        assert torch.equal(g, w) and torch.equal(g8, w) and torch.equal(g.cpu(), wc)


def test_sort_compact_on_the_cohort_decode_plane(cuda_device, monkeypatch):
    """S1 on H1's planes of a realistic container's payloads, masked to
    each stream's bits, as the decode's compaction branch gives it."""
    from vcfc_tpu_torch.format import vcfz

    vcfc = engine.compress(generate_realistic_vcf(300, 1500, seed=16), force_device=True,
                           device="cpu")
    reader = vcfz.VcfzReader.parse(vcfz.vcfz_from_vcfc(vcfc, block_lines=64, version=1))
    base = reader.payload_base
    payloads = [bytes(reader.raw[base + b["payload_off"] : base + b["payload_off"]
                                 + b["payload_len"]]) for b in reader.blocks]
    s1, s2 = hd._split_grid(max(len(p) for p in payloads) * 8)
    limits, adjust, _ = hd.device_decode_tables(reader.books[0])
    words = torch.from_numpy(hd.stream_words(payloads, s1, s2)).to(cuda_device)
    plane = hd.decode_bits(words, limits, adjust, s1=s1, s2=s2)
    nbits = torch.tensor([len(p) * 8 for p in payloads], device=cuda_device)
    mask = (plane != 0) & (torch.arange(plane.shape[1], device=cuda_device)[None, :]
                           < nbits[:, None])
    got = vd.sort_compact(plane, mask)
    want = vd.sort_compact_plain(plane, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    n_syms = [int(b["n_symbols"]) for b in reader.blocks]
    assert (got[1].cpu().numpy() >= np.array(n_syms)).all()


def test_compaction_ops_on_cuda_match_cpu(cuda_device):
    """pack_cells_compact, compact_payloads_device and esc_plane_device on
    the card equal their CPU form."""
    from vcfc_tpu_torch.ops.huffman import CTX_INIT, context_codebooks

    rng = np.random.default_rng(23)
    grid = np.where(rng.random((6, 256 * 2560)) < 0.2,
                    rng.integers(1, 296, (6, 256 * 2560)), 0).astype(np.int32)
    books = context_codebooks([row[row != 0].astype(np.int64) for row in grid], 296)
    entries = torch.from_numpy(vd.pack_entries(books))
    cells = torch.from_numpy(grid)
    outs = []
    for dev in ("cpu", cuda_device):
        sc, cnt = vd.sort_compact(cells.to(dev), (cells != 0).to(dev))
        kb = vd._bucket(int(cnt.max()), cells.shape[1])
        packed = vd.pack_cells_compact(sc[:, :kb], cnt, entries.to(dev), 296, CTX_INIT,
                                       n_ctx=4, v4=False)
        outs.append((packed, vd.compact_payloads_device(*packed[:3], vd.HostStage(dev))))
    (cpu_packed, cpu_payloads), (gpu_packed, gpu_payloads) = outs
    for g, w in zip(gpu_packed, cpu_packed):
        assert torch.equal(g.cpu(), w)
    assert gpu_payloads == cpu_payloads
    lines = np.repeat(np.arange(0, 64, 3, dtype=np.int32), 2)
    samples = np.tile(np.array([5, 2503], np.int32), len(lines) // 2)
    ids = np.arange(len(lines), dtype=np.int32)
    assert torch.equal(vd.esc_plane_device(lines, samples, ids, 64, 2560, cuda_device).cpu(),
                       vd.esc_plane_device(lines, samples, ids, 64, 2560, "cpu"))


@pytest.mark.parametrize("setting", ["device", "host"])
@pytest.mark.parametrize("version", [1, 2, 3, 5, 8])
def test_vcfz_routes_on_cuda_under_both_settings(cuda_device, monkeypatch, setting, version):
    """Both routes on the card under VCFZ_COMPACT=device and =host: the host
    writer's bytes in one batch and in batches of 4 blocks, the decode
    restoring the input; S1 launches under device only."""
    from vcfc_tpu_torch.format import vcfz, vcfz_device

    monkeypatch.setenv("VCFZ_COMPACT", setting)
    vcf = generate_realistic_vcf(300, 1500, seed=14)
    vcfc = engine.compress(vcf, force_device=True, device="cpu")
    want = vcfz.vcfz_from_vcfc(vcfc, version=version)
    want16 = vcfz.vcfz_from_vcfc(vcfc, block_lines=16, version=version)
    before = cuda_compact.LAUNCHES["sort_compact"]
    assert vcfz.vcfz_from_vcfc(vcfc, version=version, route="device", device=cuda_device) == want
    monkeypatch.setattr(vcfz_device, "_MAX_CELLS", 16 * 384 * 4)
    assert vcfz_device.vcfz_from_vcfc_device(vcfc, 16, version, device=cuda_device) == want16
    encoded = cuda_compact.LAUNCHES["sort_compact"]
    assert (encoded > before) == (setting == "device")
    if version in vcfz_device.DECODE_VERSIONS:
        for z in (want, want16):
            assert vcfz.decompress_vcfz(z, route="device", device=cuda_device) == vcf
        assert (cuda_compact.LAUNCHES["sort_compact"] > encoded) == (setting == "device")
