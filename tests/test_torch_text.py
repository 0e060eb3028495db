"""The VCFC_PARSE=device text route of the port against vcfc_tpu's.

Kernels: the same seeded numpy planes go through vcfc_tpu.ops.rle's XLA
twins text_rle_encode / text_rle_decode (on the CPU backend), through
vcfc_tpu.ops.pallas_rle's pallas_text_encode / pallas_text_decode in
interpret mode, and through the port's plain versions; every output is
integers, so every comparison is exact, element by element.  Malformed
flag planes go to the XLA twin only: pallas_text_decode fills from 128
cells ahead, text_rle_decode over the whole row (ROADMAP C).

Engine: compress / decompress under VCFC_PARSE=device on the plain
versions (device="cpu", force_device=True), byte-identical to
vcfc_tpu.engine under the same variable and to the format oracle, on the
cases of tests/test_device_parse.py.  The CUDA kernels K3/K4 are held to
the plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from _torch_word_models import TEXT_CASES, text_case
from test_fuzz import make_vcf

from vcfc_tpu import engine as jax_engine
from vcfc_tpu.format import compress_bytes, decompress_bytes
from vcfc_tpu.ops import rle as jax_rle
from vcfc_tpu.ops.pallas_rle import pallas_text_decode, pallas_text_encode
from vcfc_tpu_torch import engine
from vcfc_tpu_torch.ops import cuda_rle
from vcfc_tpu_torch.ops import rle as torch_rle

CPU = "cpu"
def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", TEXT_CASES)
def test_text_encode_matches_xla(name):
    words, S = text_case(name)
    _assert_equal(torch_rle.text_rle_encode_plain(_t(words), S), jax_rle.text_rle_encode(words, S))


@pytest.mark.parametrize("name", TEXT_CASES)
def test_text_encode_matches_pallas(name):
    words, S = text_case(name)
    _assert_equal(
        torch_rle.text_rle_encode_plain(_t(words), S),
        pallas_text_encode(words, S, interpret=True),
    )


@pytest.mark.parametrize("name", TEXT_CASES)
def test_text_decode_matches_xla_and_pallas(name):
    words, S = text_case(name)
    flags = np.asarray(jax_rle.text_rle_encode(words, S)[0])
    got = torch_rle.text_rle_decode_plain(_t(flags), S)
    _assert_equal(got, jax_rle.text_rle_decode(flags, S))
    _assert_equal(got, pallas_text_decode(flags, S, interpret=True))


def test_bad_separator_rows_are_flagged():
    words, S = text_case("bad-separators")
    seps_ok = torch_rle.text_rle_encode_plain(_t(words), S)[2].numpy()
    assert seps_ok[:64].tolist() == [0] * 64
    assert (seps_ok[64:] == 1).all()


def test_text_round_trip_is_a_fixed_point():
    """decode(encode(words)) renders the words, escapes as "?|?", and a
    second pass changes nothing."""
    words, S = text_case("pallas-300")
    f, _k, _r = torch_rle.text_rle_encode_plain(_t(words), S)
    t1, _c, d = torch_rle.text_rle_decode_plain(f, S)
    assert (d.numpy() == S).all()
    f2, _k, _r = torch_rle.text_rle_encode_plain(t1, S)
    t2, _c, _d = torch_rle.text_rle_decode_plain(f2, S)
    _assert_equal((f2, t2), (f, t1))
    rendered = t1.numpy()[:, :S].view(np.uint8).reshape(len(words), S, 4)
    source = words[:, :S].view(np.uint8).reshape(len(words), S, 4)
    valid = np.isin(source[:, :, 0], (48, 49)) & (source[:, :, 1] == 124)
    valid &= np.isin(source[:, :, 2], (48, 49))
    np.testing.assert_array_equal(rendered[valid], source[valid])
    assert (rendered[~valid][:, :3] == np.frombuffer(b"?|?", np.uint8)).all()


def _malformed(seed, W):
    """256 rows (a multiple of the Pallas text tile height) of random flag
    bytes with gaps past 127 cells, empty rows, zero tails and rows full of
    flags."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 256, (256, W), dtype=np.uint8)
    flags[rng.random((256, W)) < 0.97] = 0
    flags[:4] = 0
    flags[4:8, W // 2 :] = 0
    flags[8:12] = rng.integers(1, 256, (4, W), dtype=np.uint8)
    return flags


@pytest.mark.parametrize("seed,W,S", [(50, 384, 300), (51, 2560, 2504), (52, 128, 1)])
def test_text_decode_of_malformed_planes_matches_xla(seed, W, S):
    flags = _malformed(seed, W)
    _assert_equal(
        torch_rle.text_rle_decode_plain(_t(flags), S), jax_rle.text_rle_decode(flags, S)
    )


@pytest.mark.parametrize(
    "seed,W,S,first,count", [(50, 384, 300, [14, 66], 783), (51, 2560, 2504, [4, 720], 10156)]
)
def test_pallas_text_decode_differs_from_the_port_on_malformed_planes(seed, W, S, first, count):
    """Pins the difference logged in ROADMAP C: pallas_text_decode fills
    from 128 cells ahead only, so past a gap longer than 127 cells its
    words and codes differ from text_rle_decode's and the port's; decoded
    agrees."""
    flags = _malformed(seed, W)
    got = torch_rle.text_rle_decode_plain(_t(flags), S)
    pallas = [np.asarray(x) for x in pallas_text_decode(flags, S, interpret=True)]
    for k in (0, 1):  # words, codes
        diff = np.argwhere(got[k].numpy() != pallas[k])
        assert len(diff) == count and diff[0].tolist() == first
    np.testing.assert_array_equal(got[2].numpy(), pallas[2])


def test_cpu_tensors_take_the_plain_text_versions():
    words, S = text_case("pallas-300")
    before = dict(cuda_rle.LAUNCHES)
    want = torch_rle.text_rle_encode_plain(_t(words), S)
    _assert_equal(torch_rle.text_rle_encode(_t(words), S), want)
    _assert_equal(torch_rle.text_rle_decode(want[0], S), torch_rle.text_rle_decode_plain(want[0], S))
    assert cuda_rle.LAUNCHES == before


@pytest.mark.parametrize(
    "wrapper,plane,error",
    [
        (cuda_rle.cuda_text_encode, torch.zeros((4, 128), dtype=torch.uint8), TypeError),
        (cuda_rle.cuda_text_encode, torch.zeros((4, 128), dtype=torch.int32), ValueError),
        (cuda_rle.cuda_text_encode, torch.zeros((128, 4), dtype=torch.int32).t(), ValueError),
        (cuda_rle.cuda_text_encode, torch.zeros((0, 128), dtype=torch.int32), ValueError),
        (cuda_rle.cuda_text_decode, torch.zeros((4, 128), dtype=torch.int32), TypeError),
        (cuda_rle.cuda_text_decode, torch.zeros((4, 128), dtype=torch.uint8), ValueError),
    ],
    ids=["encode-dtype", "encode-cpu", "encode-non-contiguous", "encode-empty",
         "decode-dtype", "decode-cpu"],
)
def test_text_wrappers_reject_what_the_kernels_do_not_take(wrapper, plane, error):
    with pytest.raises(error):
        wrapper(plane, 100)


# ---------------------------------------------------------------------------
# The engine under VCFC_PARSE=device (tests/test_device_parse.py's cases)


@pytest.fixture
def device_parse(monkeypatch):
    monkeypatch.setenv("VCFC_PARSE", "device")


@pytest.fixture
def text_route_only(monkeypatch):
    """Fail if the engine takes the parse route's device layers."""
    def parse_route(*_args):
        raise AssertionError("the parse route was taken")

    monkeypatch.setattr(engine, "encode_on_device", parse_route)
    monkeypatch.setattr(engine, "decode_on_device", parse_route)


def _check_round_trip(vcf):
    vcfc = engine.compress(vcf, force_device=True, device=CPU)
    assert vcfc == jax_engine.compress(vcf, force_device=True) == compress_bytes(vcf)
    back = engine.decompress(vcfc, force_device=True, device=CPU)
    assert back == jax_engine.decompress(vcfc, force_device=True) == vcf
    assert decompress_bytes(vcfc) == vcf


def _mutate(vcf, edit):
    lines = vcf.split(b"\n")
    parts = lines[2].split(b"\t")  # the first data line
    lines[2] = b"\t".join(edit(parts))
    return b"\n".join(lines)


@pytest.mark.parametrize(
    "seed,samples,variants,sv_every",
    [(201, 127, 24, 5), (202, 300, 24, 5), (203, 2504, 24, 5), (211, 127, 24, 5),
     (212, 300, 24, 5), (213, 2504, 24, 5), (215, 384, 32, 7)],
)
def test_text_route_matches_jax_and_oracle(device_parse, text_route_only, seed, samples,
                                           variants, sv_every):
    _check_round_trip(make_vcf(seed, samples, variants, sv_every=sv_every))


@pytest.mark.parametrize("samples", [126, 127, 128, 129, 255, 256, 257])
def test_text_route_boundary_widths(device_parse, text_route_only, samples):
    _check_round_trip(make_vcf(300 + samples, samples, 16))


def test_text_route_irregular_lines(device_parse, text_route_only):
    """A wide escape ("10|2") breaks the 4-byte stride: the line takes the
    oracle path and the bytes still match."""
    def widen(parts):
        parts[9 + 3] = b"10|2"
        return parts

    _check_round_trip(_mutate(make_vcf(204, 64, 12), widen))


def test_text_route_bad_separator(device_parse, text_route_only):
    """Two 3-byte fields merged into one 7-byte field keep the line's
    length, so only the device's separator test can catch it."""
    def merge(parts):
        return parts[:9] + [parts[9] + b"x" + parts[10]] + parts[11:]

    vcf = _mutate(make_vcf(205, 8, 12), merge)
    vcfc = engine.compress(vcf, force_device=True, device=CPU)
    assert vcfc == jax_engine.compress(vcf, force_device=True) == compress_bytes(vcf)


def test_text_route_escape_lengths(device_parse, text_route_only):
    """Escapes longer than the "?|?" placeholder, on the first and on the
    last sample, splice over the device text plane."""
    def escapes(parts):
        parts[9] = b"10|2"
        parts[9 + 63] = b"2|10"
        return parts

    vcf = _mutate(make_vcf(214, 64, 12), escapes)
    vcfc = compress_bytes(vcf)
    assert engine.decompress(vcfc, force_device=True, device=CPU) == vcf
    assert jax_engine.decompress(vcfc, force_device=True) == vcf


def test_text_route_wide_cohort(device_parse, text_route_only):
    _check_round_trip(make_vcf(216, 8192, 6, sv_every=5))


@pytest.mark.parametrize("line_batch", [1, 700])
def test_text_route_line_batches(device_parse, text_route_only, line_batch):
    vcf = make_vcf(217, 200, 700)
    vcfc = engine.compress(vcf, line_batch=line_batch, force_device=True, device=CPU)
    assert vcfc == compress_bytes(vcf)
    assert engine.decompress(vcfc, line_batch=line_batch, force_device=True, device=CPU) == vcf


def test_text_route_small_input_takes_the_oracle(device_parse, monkeypatch):
    vcf = make_vcf(206, 4, 3)

    def device(*_args):
        raise AssertionError("a device layer ran below the size gate")

    for name in ("encode_text_on_device", "decode_text_on_device", "encode_on_device",
                 "decode_on_device"):
        monkeypatch.setattr(engine, name, device)
    vcfc = engine.compress(vcf, device=CPU)
    assert vcfc == compress_bytes(vcf)
    assert engine.decompress(vcfc, device=CPU) == vcf


def test_text_route_needs_the_native_runtime(device_parse, monkeypatch):
    """Without the native runtime the route is skipped, as in vcfc_tpu:
    the parse route runs on the numpy host path."""
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")

    def text_route(*_args):
        raise AssertionError("the text route ran without the native runtime")

    monkeypatch.setattr(engine, "encode_text_on_device", text_route)
    monkeypatch.setattr(engine, "decode_text_on_device", text_route)
    vcf = make_vcf(218, 130, 20, sv_every=5)
    vcfc = engine.compress(vcf, force_device=True, device=CPU)
    assert vcfc == compress_bytes(vcf)
    assert engine.decompress(vcfc, force_device=True, device=CPU) == vcf


def test_text_route_rejects_a_line_without_format(device_parse):
    vcf = make_vcf(219, 8, 4)
    lines = vcf.split(b"\n")
    lines[3] = b"\t".join(lines[3].split(b"\t")[:8])
    bad = b"\n".join(lines)
    with pytest.raises(ValueError, match="FORMAT") as got:
        engine.compress(bad, force_device=True, device=CPU)
    with pytest.raises(ValueError, match="FORMAT") as want:
        jax_engine.compress(bad, force_device=True)
    assert got.type.__name__ == want.type.__name__
