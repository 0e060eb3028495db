"""chip_smoke.py's arithmetic and tables, checked without a card.

chip_smoke imports no JAX and no card at import time, so its bound, its
plain-op line and its "kernels" rows can be held to numbers worked out by
hand; its main() refuses to run without a CUDA device.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from vcfc_tpu_torch.ops import cuda_compact, cuda_huffman, cuda_rle

INT32_RATE = 64 * 132 * 1980e6  # 64 lanes per SM per clock x 132 SMs x 1,980 MHz


@pytest.mark.parametrize(
    "name,L,W,nbytes",
    [
        ("rle_encode", 2048, 2560, 10_493_952),  # a byte in and out per cell, 4 a row
        ("rle_decode", 2048, 2560, 10_493_952),
        ("probe_tile_decode", 2048, 2560, 10_493_952),
        ("probe_blocked_encode", 8192, 2560, 41_975_808),
        ("text_encode", 2048, 2560, 5 * 2048 * 2560 + 8 * 2048),
        ("text_decode", 2048, 2560, 6 * 2048 * 2560 + 4 * 2048),
        ("probe_tile_text_encode", 2048, 2560, 5 * 2048 * 2560 + 8 * 2048),
        ("probe_tile_text_decode", 2048, 2560, 6 * 2048 * 2560 + 4 * 2048),
        # a cohort decode dispatch: 129 streams of 16,256 words, each word
        # read and its 32 int32 plane entries written
        ("huffman_decode_bits", 129, 16256, 129 * 16256 * (4 + 32 * 4)),
        # the cohort's first v1 decode plane: each cell's int32 read and
        # written and its mask byte read, and each row's int32 count
        ("sort_compact", 118, 565_248, 118 * 565_248 * 9 + 118 * 4),
    ],
)
def test_bound_is_the_bytes_at_the_memory_rate(name, L, W, nbytes):
    assert chip_smoke.bound(name, L, W) == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_k1_bound_at_one_engine_batch():
    assert chip_smoke.bound("rle_encode", 2048, 2560) == pytest.approx(0.0031325, abs=5e-8)


@pytest.mark.parametrize("name,ops", [("rle_encode", 35), ("rle_decode", 25),
                                      ("probe_tile_decode", 25), ("probe_roundtrip", 60),
                                      ("probe_tile_text_encode", 59),
                                      ("probe_tile_text_decode", 37),
                                      ("huffman_decode_bits", 5669), ("sort_compact", 7)])
def test_plain_op_line(name, ops):
    got = chip_smoke.plain_ops_ms(name, 2048, 2560, INT32_RATE)
    assert got == pytest.approx(ops * 2048 * 2560 / INT32_RATE * 1e3, rel=1e-12)


def test_every_kernel_and_probe_has_terms_a_count_and_a_row():
    names = list(chip_smoke.CHECKED)
    assert names == [*chip_smoke.KERNELS, *chip_smoke.PROBES, *chip_smoke.TEXT_PROBES,
                     *chip_smoke.DECODE_KERNELS, *chip_smoke.COMPACT_KERNELS]
    assert "huffman_decode_bits" in names and "sort_compact" in names
    assert (set(names) == set(chip_smoke.BOUND_BYTES) == set(chip_smoke.PLAIN_OPS)
            == set(cuda_rle.LAUNCHES) | set(cuda_huffman.LAUNCHES) | set(cuda_compact.LAUNCHES))
    assert not set(cuda_rle.LAUNCHES) & set(cuda_huffman.LAUNCHES)
    assert not (set(cuda_rle.LAUNCHES) | set(cuda_huffman.LAUNCHES)) & set(cuda_compact.LAUNCHES)
    stats = {name: {"max_abs_err": 0, "mismatches": 0} for name in names}
    for name in names:
        row = chip_smoke._kernel_row(name, "src", "file:1", 3, stats, (2048, 2560), 0.01, 0.5)
        assert row["bound_by"] == "bytes"
        assert row["bound_ms"] == chip_smoke.bound(name, 2048, 2560)
        # every number on the line but bound_ms is measured: no plain-op line
        assert "plain_ops_ms" not in row
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(row)


def test_earlier_designs_are_probes_of_the_kernels_line():
    for kernel, (probe, cells) in chip_smoke.EARLIER_DESIGN.items():
        assert kernel in chip_smoke.KERNELS and probe in chip_smoke.CHECKED
        assert cells in (None, *cuda_rle.PROBE_CELLS)


def test_every_kernel_is_timed_beside_its_earlier_design():
    """K1-K4 each have a tile design; C6 and C7, which the ablation does
    not time, move K3's and K4's bytes, compute their plain versions and
    replace the same TPU kernels."""
    assert set(chip_smoke.EARLIER_DESIGN) == set(chip_smoke.KERNELS)
    assert set(chip_smoke.TEXT_PROBES) == {"probe_tile_text_encode", "probe_tile_text_decode"}
    assert not set(chip_smoke.TEXT_PROBES) & set(chip_smoke.PROBES)
    for kernel in ("text_encode", "text_decode"):
        probe = chip_smoke.EARLIER_DESIGN[kernel][0]
        assert probe in chip_smoke.TEXT_PROBES
        assert chip_smoke.BOUND_BYTES[probe] == chip_smoke.BOUND_BYTES[kernel]
        assert chip_smoke.PLAIN_OPS[probe] == chip_smoke.PLAIN_OPS[kernel]
        assert chip_smoke.TEXT_PROBES[probe][1:] == chip_smoke.KERNELS[kernel][1:]


def test_main_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_main_refuses_unknown_arguments(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert chip_smoke.main(["--compact"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and chip_smoke.COMPACT_AB_FLAG in out.err


def test_compact_ab_times_each_setting_in_turns_and_checks_each_run(monkeypatch):
    """The A/B runs the route under each VCFZ_COMPACT setting in its turns,
    with no clock around it but its own, checks every result and holds S1's
    launches to the device setting."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setitem(chip_smoke.COMPACT_LAUNCHES, "sort_compact", 0)
    seen = []

    def route(launch=True):
        setting = os.environ["VCFZ_COMPACT"]
        seen.append(setting)
        if setting == "device" and launch:
            chip_smoke.COMPACT_LAUNCHES["sort_compact"] += 1
        return b"out"

    ab = chip_smoke._ab(route, chip_smoke._check_equal(b"out", "v1 encode"))
    assert tuple(seen) == chip_smoke.COMPACT_TURNS
    assert {k: len(v) for k, v in ab["walls_s"].items()} == {"device": 2, "host": 2}
    assert ab["device_over_host"] > 0
    assert "ratio of the means" in chip_smoke._ab_text(ab)
    with pytest.raises(SystemExit, match="differs"):
        chip_smoke._ab(route, chip_smoke._check_equal(b"other", "v1 encode"))
    with pytest.raises(SystemExit, match="sort_compact launched 0 times"):
        chip_smoke._ab(lambda: route(launch=False), lambda _out: None)


def test_spread_prints_the_median_and_range():
    assert chip_smoke.spread([0.5, 0.1, 0.3]) == "median 0.300 s (0.100-0.500 s, 3 runs)"
    assert chip_smoke.spread([0.2, 0.4]) == "median 0.300 s (0.200-0.400 s, 2 runs)"


def test_cli_prefix_is_the_header_and_the_first_lines(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CLI_LINES", 2)
    vcf = b"##fileformat=VCFv4.2\n#CHROM\tPOS\n1\ta\n1\tb\n1\tc\n"
    assert chip_smoke.cli_prefix(vcf) == b"##fileformat=VCFv4.2\n#CHROM\tPOS\n1\ta\n1\tb\n"


def test_the_sharded_path_and_every_device_layer_are_counted():
    """The sharded path launches K1-K4, each held to its plain version;
    every route's device layer has its staging timed inside it."""
    assert set(chip_smoke.SHARDED_KERNELS) == set(chip_smoke.KERNELS)
    assert "VCFC_SHARDED" in chip_smoke.ROUTE_ENV
    for _env, _kernels, layers in chip_smoke.ROUTES.values():
        for call in filter(None, layers.values()):
            assert call["staging in it"] == chip_smoke.STAGING
            assert any(name.startswith("device layer") for name in call)


def test_vcfz_phase_runs_every_device_version_and_reads_the_routes_counter():
    """Phase 3c writes each version the device route encodes and reads the
    counter the route itself moves; it decodes on the device the versions
    the decode takes (v1, v5, v8) and reads that counter too; its path
    launches K1, K2 and the Huffman decode."""
    from vcfc_tpu_torch.format import vcfz_device
    from vcfc_tpu_torch.ops import vcfz_device as ops

    assert chip_smoke.VCFZ_VERSIONS == vcfz_device.DEVICE_VERSIONS == (1, 2, 3, 5, 8)
    assert chip_smoke.ENCODES is vcfz_device.ENCODES
    assert set(vcfz_device.ENCODES) == set(chip_smoke.VCFZ_VERSIONS)
    assert chip_smoke.VCFZ_DECODE_VERSIONS == vcfz_device.DECODE_VERSIONS == (1, 5, 8)
    assert chip_smoke.DECODES is vcfz_device.DECODES
    assert set(chip_smoke.VCFZ_DECODE_VERSIONS) <= set(chip_smoke.VCFZ_VERSIONS)
    assert chip_smoke.VCFZ_CLI_VERSION in chip_smoke.VCFZ_DECODE_VERSIONS
    assert chip_smoke.HUFFMAN_LAUNCHES is cuda_huffman.LAUNCHES
    assert chip_smoke.COMPACT_LAUNCHES is cuda_compact.LAUNCHES
    assert set(chip_smoke.VCFZ_KERNELS) == {"rle_encode", "rle_decode", "huffman_decode_bits",
                                            "sort_compact"}
    # both routes run profiled once under each setting of the compaction, the
    # card's default first; the opt-in A/B runs each setting twice, in turns
    assert chip_smoke.COMPACT_SETTINGS == ("device", "host")
    assert sorted(chip_smoke.COMPACT_TURNS) == ["device", "device", "host", "host"]
    assert chip_smoke.COMPACT_TURNS[0] == chip_smoke.COMPACT_TURNS[-1]
    assert "VCFZ_COMPACT" in chip_smoke.ROUTE_ENV
    assert set(chip_smoke.VCFZ_KERNELS) <= set(chip_smoke.CHECKED)
    assert all(callable(getattr(ops, name)) for name in chip_smoke.VCFZ_OPS)


def test_huffman_kernel_is_built_and_its_passes_are_named_in_the_source():
    """Phase 1 builds huffman_kernels.cu; the profile finds H1's three
    passes by the names its source gives them."""
    assert "huffman_kernels" in chip_smoke.SOURCES
    source = (chip_smoke.REPO / chip_smoke.HUFFMAN_SOURCE).read_text()
    assert all(f"{name}(" in source for name in chip_smoke.HUFFMAN_PASSES)
    by_name = {"(anonymous namespace)::huffman_emit(unsigned int const*)": 2.0,
               "huffman_chain": 0.5, "Memcpy DtoH": 9.0}
    assert chip_smoke._huffman_device_ms(by_name) == {
        "huffman_segment_maps": 0.0, "huffman_chain": 0.5, "huffman_emit": 2.0}


def test_decode_layers_wrap_what_decompress_vcfz_calls(data_dir):
    """The host-clock layers of phase 3c's decode are the functions the
    device route and the host route call, so each layer's clock runs."""
    from vcfc_tpu_torch import engine
    from vcfc_tpu_torch.format import vcfz

    vcfc = (data_dir / "sv.vcfc").read_bytes()
    z = vcfz.vcfz_from_vcfc(vcfc, block_lines=4, version=8)
    for route, layers, setting in ((None, chip_smoke.HOST_DECODE_LAYERS, None),
                                   ("device", chip_smoke.DEVICE_DECODE_LAYERS, "device"),
                                   ("device", chip_smoke.DEVICE_DECODE_LAYERS, "host")):
        with chip_smoke.route_env({} if setting is None else {"VCFZ_COMPACT": setting}):
            with chip_smoke.wrapping({"device": (engine, "_device")},
                                     lambda _n, _f: lambda _d: torch.device("cpu")):
                with chip_smoke.layer_clock(layers, chip_smoke.SYNCED_LAYERS) as seconds:
                    assert vcfz.decompress_vcfz(z, route=route) == (data_dir / "sv.vcf").read_bytes()
        # the host setting has no compaction step; every other layer ran
        skipped = {"compaction and counts"} if setting == "host" else set()
        assert all((s > 0) != (name in skipped) for name, s in seconds.items()), seconds
    assert set(chip_smoke.ENTROPY_STEPS) <= set(chip_smoke.DEVICE_DECODE_LAYERS)
    assert set(chip_smoke.SYNCED_LAYERS) <= set(chip_smoke.ENTROPY_STEPS)


def test_cohort_dispatch_is_the_first_group_device_unpack_symbols_decodes(monkeypatch):
    """The words of phase 2's and phase 5's cohort case are the first
    dispatch of a v1 container's payloads: decoded on the CPU and compacted
    as device_unpack_symbols does, they give each block's symbols."""
    from vcfc_tpu_torch import engine
    from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
    from vcfc_tpu_torch.format import vcfz
    from vcfc_tpu_torch.ops import huffman_device as hd

    vcfc = engine.compress(generate_realistic_vcf(40, 300, seed=3), force_device=True,
                           device="cpu")
    z = vcfz.vcfz_from_vcfc(vcfc, block_lines=32, version=1)
    monkeypatch.setattr(chip_smoke, "_MAX_DISPATCH_BITS", 4 * 4096)
    words, limits, adjust, s1, s2, blocks = chip_smoke.cohort_dispatch(z)
    reader = vcfz.VcfzReader.parse(z)
    assert blocks == len(reader.blocks) == 10
    assert words.shape == (4, s1 * s2 // 32) and words.dtype == np.int32
    plane = hd.decode_bits(torch.from_numpy(words), limits, adjust, s1=s1, s2=s2).numpy()
    _, _, sorted_syms = hd.device_decode_tables(reader.books[0])
    for b in range(4):
        blk = reader.blocks[b]
        row = plane[b, : blk["payload_len"] * 8]
        syms = sorted_syms[row[row != 0][: int(blk["n_symbols"])] - 1]
        np.testing.assert_array_equal(syms, reader._decode_block_symbols(b))


def test_vcfz_region_and_full_scan(data_dir):
    """The region starts at the prefix's middle line, and the full scan
    keeps the lines that overlap it, SV-aware, as query_vcfz does."""
    vcf = (data_dir / "sv.vcf").read_bytes()
    body = vcf[chip_smoke.parse_metadata_headers(vcf).data_offset :].split(b"\n")
    chrom, pos = body[len(body) // 2].split(b"\t", 2)[:2]
    assert chip_smoke.vcfz_region(vcf) == (
        f"{chrom.decode()}:{int(pos)}-{int(pos) + chip_smoke.VCFZ_REGION_SPAN}")
    assert chip_smoke.full_scan(vcf, "1:400-460") == (data_dir / "qb_sv_400_460.out").read_bytes()


def test_annotated_wraps_and_restores():
    from vcfc_tpu_torch.ops import vcfz_device as ops

    real = ops.sympos_v3
    labels = {"sympos_v3": "ops.vcfz_device.sympos_v3"}
    with chip_smoke.annotated(ops, labels):
        assert ops.sympos_v3 is not real
        out = ops.sympos_v3(torch.tensor([[0xE1, 3]], dtype=torch.uint8),
                            torch.tensor([[7, 0]], dtype=torch.int32))
    assert ops.sympos_v3 is real
    assert out.tolist() == [[263, 3]]


def test_compact_kernel_is_built_and_its_kernels_are_named_in_the_source():
    """Phase 1 builds compact_kernels.cu; the profile finds S1's three
    kernels by the names its source gives them."""
    assert "compact_kernels" in chip_smoke.SOURCES
    source = (chip_smoke.REPO / chip_smoke.COMPACT_SOURCE).read_text()
    assert all(f"{name}(" in source for name in chip_smoke.COMPACT_PASSES)
    by_name = {"(anonymous namespace)::compact_write(int const*, unsigned char const*)": 2.0,
               "compact_count": 0.5, "huffman_emit": 7.0, "Memcpy DtoH": 9.0}
    assert chip_smoke._compact_device_ms(by_name) == 2.5


def test_trace_copies_reads_the_memcpy_bytes():
    """The copies of a profiler trace by kind, with their bytes, and the
    D2H total; a trace without byte counts reads as not measured."""
    trace = {"traceEvents": [
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 1500,
         "args": {"bytes": 4096}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 500,
         "args": {"bytes": 1024}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "dur": 250,
         "args": {"bytes": 8}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "dur": 100,
         "args": {"bytes": 64}},
        {"cat": "kernel", "name": "compact_write", "dur": 9, "args": {}},
        {"ph": "M", "name": "process_name"}]}
    copies = chip_smoke.trace_copies(trace)
    assert copies == {
        "Memcpy DtoH (Device -> Pinned)": {"count": 2, "bytes": 5120, "ms": 2.0},
        "Memcpy DtoH (Device -> Pageable)": {"count": 1, "bytes": 8, "ms": 0.25},
        "Memcpy HtoD (Pinned -> Device)": {"count": 1, "bytes": 64, "ms": 0.1}}
    assert chip_smoke.d2h(copies) == (5128, 2.25)
    del trace["traceEvents"][2]["args"]["bytes"]
    assert chip_smoke.d2h(chip_smoke.trace_copies(trace)) == (None, 2.25)
    assert chip_smoke.d2h({}) == (0, 0)


def test_sort_compact_library_computes_the_plain_function():
    """The yardstick of S1's library_ms, the JAX package's stable sort and a
    gather, computes what sort_compact_plain computes."""
    from vcfc_tpu_torch.ops.vcfz_device import sort_compact_plain

    rng = np.random.default_rng(0)
    for name, values, mask in chip_smoke.compact_cases(rng)[:12]:
        v, m = torch.from_numpy(values), torch.from_numpy(mask)
        for got, want in zip(chip_smoke.sort_compact_library(v, m), sort_compact_plain(v, m)):
            assert torch.equal(got, want), name


def test_compact_cases_hold_the_edges():
    cases = chip_smoke.compact_cases(np.random.default_rng(1))
    assert len(cases) == 24
    for name, values, mask in cases:
        assert values.dtype == np.int32 and mask.dtype == bool and values.shape == mask.shape
        assert not mask[0].any() and mask[1 % len(mask)].all() and mask[2 % len(mask), -1]
    widths = {values.shape[1] for _name, values, _mask in cases}
    assert any(w % 4096 for w in widths) and max(widths) > 32 * 4096


def test_dispatch_bits_are_the_payloads_bits():
    from vcfc_tpu_torch import engine
    from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
    from vcfc_tpu_torch.format import vcfz

    vcfc = engine.compress(generate_realistic_vcf(40, 300, seed=3), force_device=True,
                           device="cpu")
    z = vcfz.vcfz_from_vcfc(vcfc, block_lines=32, version=1)
    reader = vcfz.VcfzReader.parse(z)
    assert chip_smoke.dispatch_bits(z, 4) == [b["payload_len"] * 8 for b in reader.blocks[:4]]


@pytest.mark.parametrize("version", [1, 5, 8])
def test_decode_d2h_model_counts_what_the_decode_brings_back(version, monkeypatch):
    """The model's bytes are those of the planes and slices the entropy
    decode brings back on the CPU, on both branches, give or take the
    spurious starts of each stream's last byte (under a bucket)."""
    from vcfc_tpu_torch import engine
    from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
    from vcfc_tpu_torch.format import vcfz
    from vcfc_tpu_torch.format import vcfz_device as route
    from vcfc_tpu_torch.ops import huffman_device as hd

    vcfc = engine.compress(generate_realistic_vcf(60, 400, seed=4), force_device=True,
                           device="cpu")
    z = vcfz.vcfz_from_vcfc(vcfc, block_lines=32, version=version)
    monkeypatch.setattr(hd, "_MAX_DISPATCH_BITS", 3 * 4096 * 4)
    monkeypatch.setattr(chip_smoke, "_MAX_DISPATCH_BITS", 3 * 4096 * 4)
    seen = []
    real = hd._download
    monkeypatch.setattr(hd, "_download", lambda plane, stage: seen.append(plane.nbytes + 4 * (
        stage is not None) * plane.shape[0]) or real(plane, stage))
    model = chip_smoke.decode_d2h_model(z)
    for setting, want in zip(("host", "device"), model):
        monkeypatch.setenv("VCFZ_COMPACT", setting)
        seen.clear()
        assert route.vcfz_to_vcfc_device(z, device="cpu") == vcfc
        assert len(seen) > 1 and sum(seen) == want
