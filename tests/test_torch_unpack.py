"""The port's packed-unpack decompress route (VCFC_UNPACK=device) against
vcfc_tpu's.

``unpack_packed_flags`` / ``unpack_rle_decode`` (plain PyTorch on the CPU)
against ``vcfc_tpu.ops.rle``'s MXU formulation on the cases of
tests/test_engine.py and tests/test_wide_cohort.py; the route itself
against ``vcfc_tpu.engine.decompress`` under VCFC_UNPACK=device and
VCFC_FORCE_DEVICE=1, byte for byte.  The CUDA route is held to this one in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from test_fuzz import make_vcf

from vcfc_tpu import engine as jax_engine
from vcfc_tpu.format import compress_bytes
from vcfc_tpu.ops import rle as jax_rle
from vcfc_tpu_torch import engine
from vcfc_tpu_torch.format.vcf import parse_metadata_headers
from vcfc_tpu_torch.host import fast, native
from vcfc_tpu_torch.ops import rle as torch_rle

CPU = "cpu"


def _packed(flagpos: np.ndarray, nseg: np.ndarray):
    """Compact each row's nonzero flag bytes to its front, in order."""
    packed = np.zeros((flagpos.shape[0], max(int(nseg.max()), 1)), np.uint8)
    for i, row in enumerate(flagpos):
        nz = row[row > 0]
        packed[i, : len(nz)] = nz
    return packed, nseg.astype(np.int32)


def _case(name):
    """(packed (L, M) uint8, nflags (L,) int32, out_width)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "three-flags":  # test_engine.py::test_unpack_packed_flags
        packed = np.zeros((1, 8), np.uint8)
        packed[0, :3] = [127, 127, 46]
        return packed, np.array([3], np.int32), 384
    if name == "production-shape":  # test_engine.py, 2,504-sample cohort width
        L, S, S_pad = 512, 2504, 2560
        codes = np.zeros((L, S_pad), np.uint8)
        codes[:, :S] = rng.choice(5, size=(L, S), p=[0.8, 0.07, 0.07, 0.04, 0.02])
        codes[: L // 4, :S] = 0
        flagpos, nseg = map(np.asarray, jax_rle.rle_encode(codes, S))
        return *_packed(flagpos, nseg), S_pad
    if name == "wide-16384":  # test_wide_cohort.py::test_wide_unpack_kernel
        L, S = 32, 16384
        codes = rng.choice(5, size=(L, S), p=[0.9, 0.04, 0.03, 0.02, 0.01]).astype(np.uint8)
        flagpos, nseg = map(np.asarray, jax_rle.rle_encode(codes, S))
        return *_packed(flagpos, nseg), S
    if name == "ends-past-width":  # runs that overrun out_width are dropped
        packed = rng.integers(0, 128, (64, 40), dtype=np.uint8)
        return packed, np.full(64, 40, np.int32), 1000
    if name == "zero-run-lengths":  # 0x80, 0xA0, 0xC0 and 0 cover no sample
        packed = rng.integers(0, 256, (64, 96), dtype=np.uint8)
        packed[rng.random((64, 96)) < 0.2] = rng.choice([0x80, 0xA0, 0xC0, 0x00])
        return packed, rng.integers(0, 97, 64).astype(np.int32), 2560
    if name == "counts-zero-and-past-width":
        packed = rng.integers(1, 256, (32, 128), dtype=np.uint8)
        nflags = rng.integers(0, 200, 32).astype(np.int32)
        nflags[:8] = 0
        return packed, nflags, 384
    raise KeyError(name)


CASES = ["three-flags", "production-shape", "wide-16384", "ends-past-width",
         "zero-run-lengths", "counts-zero-and-past-width"]


@pytest.mark.parametrize("name", CASES)
def test_unpack_matches_jax(name):
    packed, nflags, width = _case(name)
    got = torch_rle.unpack_packed_flags(torch.from_numpy(packed), torch.from_numpy(nflags), width)
    want = np.asarray(jax_rle.unpack_packed_flags(packed, nflags, out_width=width))
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["production-shape", "zero-run-lengths"])
def test_unpack_rle_decode_matches_jax(name):
    packed, nflags, width = _case(name)
    S = width - 56
    got = torch_rle.unpack_rle_decode(torch.from_numpy(packed), torch.from_numpy(nflags), S, width)
    want = jax_rle.unpack_rle_decode(packed, nflags, S, out_width=width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unpack_inverts_compaction():
    width = 2560
    codes = np.random.default_rng(77).choice(5, size=(512, 2504), p=[0.8, 0.07, 0.07, 0.04, 0.02])
    padded = np.zeros((512, width), np.uint8)
    padded[:, :2504] = codes
    flagpos = torch_rle.rle_encode_plain(torch.from_numpy(padded), 2504)[0]
    packed, nflags = _packed(flagpos.numpy(), (flagpos > 0).sum(1).numpy())
    got = torch_rle.unpack_packed_flags(torch.from_numpy(packed), torch.from_numpy(nflags), width)
    assert torch.equal(got, flagpos)


# ---------------------------------------------------------------------------
# The engine under VCFC_UNPACK=device (tests/test_engine.py's seeds)


@pytest.fixture
def unpack_route(monkeypatch):
    monkeypatch.setenv("VCFC_UNPACK", "device")
    monkeypatch.setenv("VCFC_FORCE_DEVICE", "1")

    def parse_route(*_args):
        raise AssertionError("the parse route's device layer was taken")

    monkeypatch.setattr(engine, "decode_on_device", parse_route)


@pytest.mark.parametrize("seed,samples,variants", [(21, 150, 400), (22, 2504, 120), (23, 31, 900)])
def test_unpack_route_matches_jax(unpack_route, seed, samples, variants):
    vcf = make_vcf(seed, samples, variants, sv_every=9)
    vcfc = compress_bytes(vcf)
    got = engine.decompress(vcfc, device=CPU)
    assert got == jax_engine.decompress(vcfc) == vcf


@pytest.mark.parametrize("line_batch", [1, 700])
def test_unpack_route_line_batches(unpack_route, line_batch):
    vcf = make_vcf(24, 200, 700)
    assert engine.decompress(compress_bytes(vcf), line_batch=line_batch, device=CPU) == vcf


def test_unpack_route_escape_splices(unpack_route):
    """Escapes wider than 3 bytes, on the first and last sample."""
    lines = make_vcf(25, 64, 12).split(b"\n")
    parts = lines[2].split(b"\t")
    parts[9], parts[9 + 63] = b"10|2", b"2|10"
    lines[2] = b"\t".join(parts)
    vcf = b"\n".join(lines)
    vcfc = compress_bytes(vcf)
    assert engine.decompress(vcfc, device=CPU) == jax_engine.decompress(vcfc) == vcf


def test_unpack_route_gate_falls_through_with_its_scan(monkeypatch):
    """Below the size gate the route declines, and the parse route reuses
    the stream scan it already made."""
    monkeypatch.setenv("VCFC_UNPACK", "device")
    vcf = make_vcf(26, 40, 30)
    vcfc = compress_bytes(vcf)
    scans = []
    parse = fast.parse_vcfc_native

    def spy(raw, width=None, scan=None):
        scans.append(scan)
        return parse(raw, width, scan=scan)

    def device(*_args):
        raise AssertionError("the unpack route ran below the size gate")

    monkeypatch.setattr(fast, "parse_vcfc_native", spy)
    monkeypatch.setattr(engine, "unpack_decode_on_device", device)
    assert engine.decompress(vcfc, device=CPU) == vcf
    assert len(scans) == 1 and scans[0] is not None and len(scans[0][1]) == 30


def test_unpack_route_needs_the_native_runtime(monkeypatch):
    """Without the native runtime the route is skipped, as in vcfc_tpu."""
    monkeypatch.setenv("VCFC_UNPACK", "device")
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")

    def device(*_args):
        raise AssertionError("the unpack route ran without the native runtime")

    monkeypatch.setattr(engine, "unpack_decode_on_device", device)
    vcf = make_vcf(27, 130, 20, sv_every=5)
    assert engine.decompress(compress_bytes(vcf), force_device=True, device=CPU) == vcf


def test_unpack_route_rejects_a_malformed_line(unpack_route):
    vcf = make_vcf(28, 64, 16)
    vcfc = bytearray(compress_bytes(vcf))
    header = parse_metadata_headers(bytes(vcfc))
    raw = np.frombuffer(bytes(vcfc), np.uint8)
    line_off, _len, req_len = native.scan_vcfc(raw, header.data_offset, 64)
    vcfc[int(line_off[3]) + 8 + int(req_len[3])] = 0x7F  # a 127-sample run in a 64-sample line
    bad = bytes(vcfc)
    with pytest.raises(ValueError, match="malformed") as got:
        engine.decompress(bad, device=CPU)
    with pytest.raises(ValueError, match="malformed") as want:
        jax_engine.decompress(bad)
    assert got.type.__name__ == want.type.__name__
    assert str(got.value) == str(want.value)


def test_unpack_route_without_cuda_raises(small_vcfc, monkeypatch):
    monkeypatch.setenv("VCFC_UNPACK", "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.decompress(small_vcfc)
