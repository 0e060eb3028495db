"""The port's host `.vcfz` codec (vcfc_tpu_torch.format.vcfz) against
vcfc_tpu.format.vcfz: the writer's bytes for v1-v8, the reader, the
decompress and the region query, on the corpora of tests/test_vcfz.py and
a seeded cohort; and the port's compress-z / decompress-z / query-z verbs,
run under tmp_path.

Bytes must be equal, byte for byte.  The port's decompress runs on its
engine with device="cpu" (the plain PyTorch kernels).
"""

import functools

import numpy as np
import pytest
import torch

from test_fuzz import make_vcf
from vcfc_tpu import cli as jax_cli
from vcfc_tpu.eval.random_vcf import generate_correlated_vcf
from vcfc_tpu.format import compress_bytes, decompress_bytes
from vcfc_tpu.format import vcfz as jz
from vcfc_tpu.format.headers import encode_length_header
from vcfc_tpu.query.coordinate import parse_coordinate_string as jax_region
from vcfc_tpu_torch import cli, engine
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.format import vcfz as tz
from vcfc_tpu_torch.query.coordinate import parse_coordinate_string

CPU = "cpu"
VERSIONS = [1, 2, 3, 4, 5, 6, 7, 8]


def _escapes_vcf():
    """Escapes whose first appearance (z|2 before a|2) differs from their
    sorted order."""
    rows = [["z|2", "0|0", "a|2", "0|0"], ["0|0", "a|2", "0|0", "z|2"],
            ["c|2", "0|0", "0|0", "b|2"]]
    lines = [b"##f=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC\tD\n"]
    for i, r in enumerate(rows):
        lines.append(b"1\t%d\t.\tA\tT\t9\tPASS\t.\tGT\t" % (100 + i) + "\t".join(r).encode()
                     + b"\n")
    return b"".join(lines)


def _non_greedy_vcfc():
    """A valid but non-canonical .vcfc line: ten 0|0 as [0x05, 0x05]."""
    header = (b"##m=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
              + b"".join(b"\tS%d" % i for i in range(10)) + b"\n")
    req = b"1\t100\t.\tA\tT\t.\t.\t.\tGT\t"
    body = bytes([0x05, 0x05])
    return (header + encode_length_header(4 + len(req) + len(body) + 1)
            + encode_length_header(len(req)) + req + body + b"\n")


# name -> (the VCF, block_lines for the writer (None: the version's
# default), query regions)
CORPORA = {
    "small": (lambda d: (d / "small.vcf").read_bytes(), 32, ["1:10100-10150", "1", "2"]),
    "sv": (lambda d: (d / "sv.vcf").read_bytes(), 4, ["1:400-460", "1:1-100000", "1"]),
    "fuzz": (lambda d: make_vcf(501, 70, 90, sv_every=8), None, ["1:1000-9000", "1", "X"]),
    "cohort": (lambda d: generate_realistic_vcf(96, 700, seed=7), 64,
               ["1:16050075-16052000", "2", "X:16050075-16060000", "22:1-2"]),
    "correlated": (lambda d: generate_correlated_vcf(60, 150, mutation_rate=0.03, seed=11), 7,
                   ["1:1000-1400", "1"]),
    "escapes": (lambda d: _escapes_vcf(), None, ["1:100-101", "1"]),
}


@functools.lru_cache(maxsize=None)
def _corpus(name, data_dir):
    vcf = CORPORA[name][0](data_dir)
    return vcf, compress_bytes(vcf)


@functools.lru_cache(maxsize=None)
def _containers(name, version, data_dir):
    _vcf, vcfc = _corpus(name, data_dir)
    block_lines = CORPORA[name][1]
    return (tz.vcfz_from_vcfc(vcfc, block_lines, version),
            jz.vcfz_from_vcfc(vcfc, block_lines, version))


CASES = [(name, v) for name in CORPORA for v in VERSIONS]


@pytest.mark.parametrize("name,version", CASES)
def test_host_writer_bytes(name, version, data_dir):
    got, want = _containers(name, version, data_dir)
    assert got == want


@pytest.mark.parametrize("name,version", CASES)
def test_reader_and_decompress(name, version, data_dir):
    vcf, vcfc = _corpus(name, data_dir)
    z, _ = _containers(name, version, data_dir)
    got, want = tz.VcfzReader.parse(z), jz.VcfzReader.parse(z)
    for field in ("block_lines", "n_lines", "n_samples", "header_blob", "escapes", "version",
                  "payload_base", "blocks"):
        assert str(getattr(got, field)) == str(getattr(want, field)), field
    for field in ("req_lens", "nsym", "req_starts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for g, w in zip(got.books, want.books):
        np.testing.assert_array_equal(g.lengths, w.lengths)
    assert got.to_vcfc() == vcfc
    out = tz.decompress_vcfz(z, device=CPU)
    assert out == jz.decompress_vcfz(z) == vcf == decompress_bytes(vcfc)


@pytest.mark.parametrize("name,version", CASES)
def test_query(name, version, data_dir):
    z, _ = _containers(name, version, data_dir)
    for region in CORPORA[name][2]:
        got = b"".join(tz.query_vcfz(z, parse_coordinate_string(region)))
        assert got == b"".join(jz.query_vcfz(z, jax_region(region))), region


@pytest.mark.parametrize("version", VERSIONS)
def test_numpy_fallback_bytes_and_decode(version, data_dir, monkeypatch):
    """Without the native library (VCFC_NO_NATIVE=1) the oracle walker,
    the numpy packers and the numpy decoders give the same bytes."""
    vcf, vcfc = _corpus("fuzz", data_dir)
    want, _ = _containers("fuzz", version, data_dir)
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")
    z = tz.vcfz_from_vcfc(vcfc, version=version)
    assert z == want == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tz.VcfzReader.parse(z).to_vcfc() == vcfc


def test_single_block_decodes_alone(data_dir):
    vcf, vcfc = _corpus("correlated", data_dir)
    z = tz.vcfz_from_vcfc(vcfc, version=4, block_lines=7)
    got, want = tz.VcfzReader.parse(z), jz.VcfzReader.parse(z)
    for b in (0, 3, len(got.blocks) - 1):
        assert got.block_lines_vcfc(b) == want.block_lines_vcfc(b)
    q = parse_coordinate_string("1:1000-1400")
    assert got.select_blocks(q) == want.select_blocks(jax_region("1:1000-1400"))


@pytest.mark.parametrize("version", [1, 2, 3, 5, 8])
def test_non_greedy_input_transcodes_exactly(version):
    vcfc = _non_greedy_vcfc()
    z = tz.vcfz_from_vcfc(vcfc, version=version)
    assert z == jz.vcfz_from_vcfc(vcfc, version=version)
    assert tz.VcfzReader.parse(z).to_vcfc() == vcfc


@pytest.mark.parametrize("version", [4, 6, 7])
def test_non_greedy_input_refused_by_the_vertical_transform(version):
    for mod in (tz, jz):
        with pytest.raises(ValueError, match="non-greedy"):
            mod.vcfz_from_vcfc(_non_greedy_vcfc(), version=version)


def test_unsupported_version_raises():
    for mod in (tz, jz):
        with pytest.raises(ValueError, match="unsupported .vcfz version"):
            mod.vcfz_from_vcfc(_non_greedy_vcfc(), version=9)


def _patched(z, off, fmt, value):
    import struct

    b = bytearray(z)
    struct.pack_into(fmt, b, off, value)
    return bytes(b)


def test_corrupt_containers_raise_as_in_the_jax_package(data_dir):
    _vcf, vcfc = _corpus("correlated", data_dir)
    z = tz.vcfz_from_vcfc(vcfc, version=3)
    r = tz.VcfzReader.parse(z)
    off = len(tz.MAGIC) + 9 + 12 + 8 + len(r.header_blob) + 4
    for e in r.escapes:
        off += 2 + len(e)
    nsym_off = z.find(r.req_lens.astype(np.uint32).tobytes()) + 4 * r.n_lines
    zero_line = bytearray(z)
    zero_line[nsym_off : nsym_off + 4] = (0).to_bytes(4, "little")
    cases = [
        (b"XXXX" + z[4:], "not a .vcfz"),
        (_patched(z, 4, "<I", 9), "unsupported"),
        (_patched(z, off, "<I", 10_000), "alphabet"),
        (_patched(z, len(tz.MAGIC) + 5, "<I", 0), "block_lines|cover"),
        (z[: len(z) // 2], "truncated|cover|corrupt"),
        (bytes(zero_line), "zero-symbol|cover|corrupt|invalid"),
    ]
    for bad, match in cases:
        for mod in (tz, jz):
            with pytest.raises(ValueError, match=match):
                mod.VcfzReader.parse(bad).to_vcfc()


# --- the CLI verbs ---------------------------------------------------------------


@pytest.fixture
def cpu_cli(monkeypatch):
    monkeypatch.setattr(engine, "_device", lambda _device: torch.device(CPU))
    monkeypatch.delenv("VCFZ_PACK", raising=False)


@pytest.mark.parametrize("version", [None, "1", "4", "8"])
@pytest.mark.parametrize("source", ["vcf", "vcfc"])
def test_cli_round_trip(tmp_path, data_dir, cpu_cli, capsysbinary, version, source):
    """compress-z of a VCF (engine.compress first) or of a .vcfc, then
    decompress-z and query-z: the JAX package's bytes and lines."""
    vcf, vcfc = _corpus("sv", data_dir)
    src, z, out = tmp_path / f"in.{source}", tmp_path / "in.vcfz", tmp_path / "out.vcf"
    src.write_bytes(vcf if source == "vcf" else vcfc)
    argv = ["compress-z", str(src), str(z)] + ([version] if version else [])
    assert cli.main(argv) == 0
    assert z.read_bytes() == jz.vcfz_from_vcfc(vcfc, version=int(version or jz.VERSION))
    assert cli.main(["decompress-z", str(z), str(out)]) == 0
    assert out.read_bytes() == vcf
    capsysbinary.readouterr()
    assert cli.main(["query-z", str(z), "1:400-460"]) == 0
    assert capsysbinary.readouterr().out == (data_dir / "qb_sv_400_460.out").read_bytes()


@pytest.mark.parametrize("argv", [
    ["compress-z", "in.vcf"],
    ["compress-z", "in.vcf", "out.vcfz", "9"],
    ["compress-z", "in.vcf", "out.vcfz", "x"],
    ["decompress-z", "in.vcfz"],
    ["query-z", "in.vcfz"],
    ["query-z", "in.vcfz", "1:5"],
])
def test_cli_usage_messages_and_exit_codes(tmp_path, cpu_cli, capsys, monkeypatch, argv):
    """The port prints what vcfc_tpu.cli prints and exits as it does."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.vcf").write_bytes(b"##x\n#CHROM\n")
    (tmp_path / "in.vcfz").write_bytes(b"")
    results = []
    for main in (cli.main, jax_cli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
        results.append((rc, capsys.readouterr().out))
    assert results[0] == results[1]
    assert results[0][0] == 1


def test_cli_device_routes_not_ported_exit_2(tmp_path, data_dir, cpu_cli, capsys, monkeypatch):
    """VCFZ_PACK=device: compress-z encodes v1/v2/v3/v5/v8 on the device
    route (the JAX package's bytes) and decompress-z decodes v8 on it;
    v4/v6/v7 refuse both with exit code 2 and say why."""
    vcf, vcfc = _corpus("sv", data_dir)
    src, z = tmp_path / "in.vcf", tmp_path / "in.vcfz"
    src.write_bytes(vcf)
    monkeypatch.setenv("VCFZ_PACK", "device")
    assert cli.main(["compress-z", str(src), str(z), "8"]) == 0
    assert z.read_bytes() == jz.vcfz_from_vcfc(vcfc, version=8)
    assert cli.main(["decompress-z", str(z), str(tmp_path / "out.vcf")]) == 0
    assert (tmp_path / "out.vcf").read_bytes() == vcf
    assert cli.main(["compress-z", str(src), str(tmp_path / "v4.vcfz"), "4"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert not (tmp_path / "v4.vcfz").exists()
    (tmp_path / "v4.vcfz").write_bytes(jz.vcfz_from_vcfc(vcfc, version=4))
    assert cli.main(["decompress-z", str(tmp_path / "v4.vcfz"), str(tmp_path / "v4.vcf")]) == 2
    assert "not ported" in capsys.readouterr().err
    assert not (tmp_path / "v4.vcf").exists()


def test_cli_other_verbs_still_exit_2(cpu_cli, capsys):
    for verb in ("query", "gap-analysis", "create-manifest"):
        assert cli.main([verb, "x.vcfc", "1"]) == 2
        assert "not ported" in capsys.readouterr().err
