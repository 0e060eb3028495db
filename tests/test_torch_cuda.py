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
from vcfc_tpu_torch.eval.edge_cases import encode_edge_cases, flag_edge_cases
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.ops import _build, cuda_rle, probe
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
