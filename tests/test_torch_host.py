"""The port's host layer (vcfc_tpu_torch.format / .host / .eval) against
the modules of vcfc_tpu it was copied from.

The same bytes go through both packages: the golden fixtures in
tests/data and random VCFs from test_fuzz.make_vcf.  Bytes must be equal,
arrays equal element by element.
"""

from dataclasses import fields, is_dataclass

import numpy as np
import pytest

from test_fuzz import make_vcf

from vcfc_tpu.eval import random_vcf as jax_random_vcf
from vcfc_tpu.format import headers as jax_headers
from vcfc_tpu.format import lines as jax_lines
from vcfc_tpu.format import vcf as jax_vcf
from vcfc_tpu.host import assemble as jax_assemble
from vcfc_tpu.host import fast as jax_fast
from vcfc_tpu.host import native as jax_native
from vcfc_tpu.host import parse as jax_parse
from vcfc_tpu_torch.eval import random_vcf
from vcfc_tpu_torch.format import constants, headers, lines, vcf
from vcfc_tpu_torch.host import assemble, fast, native, parse

RANDOM = [(401, 1, 30), (402, 127, 40), (403, 300, 50), (404, 1000, 20)]


def _inputs(name, data_dir):
    if name in ("small", "sv"):
        return (data_dir / f"{name}.vcf").read_bytes()
    seed, samples, variants = RANDOM[int(name)]
    return make_vcf(seed, samples, variants, sv_every=7)


INPUTS = ["small", "sv", "0", "1", "2", "3"]


def _outcome(fn, *args):
    """fn's result, or the name and message of the ValueError it raised."""
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


def _assert_same(got, want):
    """Dataclasses field by field, arrays element by element, the rest by ==."""
    if is_dataclass(want):
        assert [f.name for f in fields(got)] == [f.name for f in fields(want)]
        for f in fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", INPUTS)
def test_oracle_codec_matches(name, data_dir):
    data = _inputs(name, data_dir)
    want = jax_vcf.compress_bytes(data)
    assert vcf.compress_bytes(data) == want
    assert vcf.decompress_bytes(want) == jax_vcf.decompress_bytes(want) == data
    _assert_same(vcf.parse_metadata_headers(want), jax_vcf.parse_metadata_headers(want))


@pytest.mark.parametrize("native_env", [None, "1"], ids=["native", "numpy"])
@pytest.mark.parametrize("name", INPUTS)
def test_parse_and_encode_assembly_match(name, data_dir, monkeypatch, native_env):
    if native_env:
        monkeypatch.setenv("VCFC_NO_NATIVE", native_env)
    data = _inputs(name, data_dir)
    got, want = parse.parse_vcf_bytes(data), jax_parse.parse_vcf_bytes(data)
    _assert_same(got, want)
    flagpos, nseg = jax_native.rle_encode_host(want.codes, want.n_samples)
    assert assemble.assemble_vcfc(got, flagpos, nseg) == jax_vcf.compress_bytes(data)
    if not native_env:
        assert fast.assemble_vcfc_native(got, flagpos, nseg) == jax_fast.assemble_vcfc_native(
            want, flagpos, nseg
        )


@pytest.mark.parametrize("name", INPUTS)
def test_vcfc_parse_and_decode_assemblies_match(name, data_dir):
    data = _inputs(name, data_dir)
    vcfc = jax_vcf.compress_bytes(data)
    got, want = fast.parse_vcfc_native(vcfc), jax_fast.parse_vcfc_native(vcfc)
    _assert_same(got, want)
    _assert_same(assemble.parse_vcfc_bytes(vcfc), jax_assemble.parse_vcfc_bytes(vcfc))
    S = want.header.schema.sample_count
    codes = jax_native.expand_codes(want.flags, S)
    decoded = np.full(want.n_lines, S, np.int32)
    assert fast.assemble_vcf_native(got, codes, decoded) == data
    lut = np.frombuffer(b"0|0\t0|1\t1|0\t1|1\t?|?\t", np.uint8).reshape(5, 4)
    text = lut[codes].reshape(want.n_lines, -1).copy()
    text[:, 4 * S - 1] = ord("\n")
    assert fast.assemble_vcf_from_text(got, text, decoded) == jax_fast.assemble_vcf_from_text(
        want, text, decoded
    ) == data
    np_parsed = assemble.parse_vcfc_bytes(vcfc)
    np_codes = jax_native.expand_codes(np_parsed.flags, S)
    np_text = lut[np_codes].reshape(np_parsed.n_lines, -1)
    assert assemble.assemble_vcf(np_parsed, np_text, decoded) == data


@pytest.mark.parametrize("name", INPUTS)
def test_packed_vcfc_parse_matches(name, data_dir):
    """The VCFC_UNPACK=device route's host side: the packed parse, with
    and without a scan made beforehand, the positional parse reusing that
    scan, ``scan_vcfc_stream`` against the hand-made scan, and the native
    scan_packed entry point itself."""
    vcfc = jax_vcf.compress_bytes(_inputs(name, data_dir))
    _assert_same(fast.parse_vcfc_packed_native(vcfc), jax_fast.parse_vcfc_packed_native(vcfc))
    header = vcf.parse_metadata_headers(vcfc)
    raw = np.frombuffer(vcfc, np.uint8)
    scan = (header, *native.scan_vcfc(raw, header.data_offset, len(vcfc) // 10 + 16))
    for got, want in zip(fast.scan_vcfc_stream(vcfc)[1:], scan[1:]):
        np.testing.assert_array_equal(got, want)
    _assert_same(fast.parse_vcfc_packed_native(vcfc, scan=scan),
                 jax_fast.parse_vcfc_packed_native(vcfc))
    _assert_same(fast.parse_vcfc_native(vcfc, scan=scan), jax_fast.parse_vcfc_native(vcfc))
    S = header.schema.sample_count
    for M in (128, 1024):  # 128 is too narrow for some lines: their status is 1
        _assert_same(native.scan_packed(raw, *scan[1:], S, M),
                     jax_native.scan_packed(raw, *scan[1:], S, M))


@pytest.mark.parametrize("name", INPUTS)
def test_native_text_entry_points_match(name, data_dir):
    data = _inputs(name, data_dir)
    header = vcf.parse_metadata_headers(data)
    raw = np.frombuffer(data, np.uint8)
    got = native.index_lines(raw, header.data_offset)
    want = jax_native.index_lines(raw, header.data_offset)
    _assert_same(got, want)
    S = header.schema.sample_count
    line_start, line_end, sample_start = want
    body = raw[header.data_offset :]
    irregular = ((line_end - sample_start) != 4 * S - 1).astype(np.uint8)
    s_pad = max((S + 127) // 128 * 128, 128)
    _assert_same(native.gather_text(body, sample_start, irregular, S, s_pad),
                 jax_native.gather_text(body, sample_start, irregular, S, s_pad))
    _assert_same(native.classify(body, sample_start, line_end, S),
                 jax_native.classify(body, sample_start, line_end, S))


@pytest.mark.parametrize("S,L,seed", [(1, 50, 1), (300, 120, 2), (2504, 40, 5)])
def test_generate_realistic_vcf_bytes_match(S, L, seed):
    assert random_vcf.generate_realistic_vcf(S, L, seed) == jax_random_vcf.generate_realistic_vcf(
        S, L, seed
    )


@pytest.mark.parametrize("length", [0, 1, 127, 1 << 20, 0x3FFF_FFFF])
def test_line_headers_match(length):
    blob = headers.encode_length_header(length) + headers.encode_length_header(length // 2)
    assert blob == jax_headers.encode_length_header(length) + jax_headers.encode_length_header(
        length // 2
    )
    assert headers.decode_line_headers(blob) == jax_headers.decode_line_headers(blob)


def test_constants_match():
    from vcfc_tpu.format import constants as jax_constants

    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names and {n: getattr(constants, n) for n in names} == {
        n: getattr(jax_constants, n) for n in names
    }


@pytest.mark.parametrize(
    "line",
    [
        b"1\t100\tx\tA\tG\t50\tPASS\t.\tGT\t0|0\t0|1\t./.\t10|2",
        b"1\t100\tx\tA\tG\t50\tPASS\t.",
        b"1\t100\t\tx\tA\tG\t50\tPASS\t.\tGT\t1|1",
    ],
    ids=["samples", "no-format", "empty-term"],
)
def test_data_line_codec_matches(line):
    enc = lines.encode_data_line(line)
    assert enc == jax_lines.encode_data_line(line)
    assert lines.split_terms(line) == jax_lines.split_terms(line)
    S = max(len(lines.split_terms(line)) - 9, 0)
    # an 8-column line decodes to an error in both (the reference's check)
    assert _outcome(lines.decode_data_line, enc, 0, S) == _outcome(
        jax_lines.decode_data_line, enc, 0, S
    )


@pytest.mark.parametrize(
    "bad",
    [b"1\t2\t3", b"##m\n", b"#CHROM\tPOS\n1\t2\n", b""],
    ids=["short-line", "no-header", "header-before-meta", "empty"],
)
def test_validation_errors_match(bad):
    assert _outcome(vcf.compress_bytes, bad) == _outcome(jax_vcf.compress_bytes, bad)
    assert _outcome(vcf.parse_metadata_headers, bad) == _outcome(
        jax_vcf.parse_metadata_headers, bad
    )


def test_native_builds_into_the_checkout_and_honours_the_off_switch(monkeypatch):
    assert native.available()
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")
    assert not native.available()
