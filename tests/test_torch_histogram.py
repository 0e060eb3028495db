"""The port's histograms (vcfc_tpu_torch.ops.histogram) against vcfc_tpu's.

The same seeded numpy planes go through ``vcfc_tpu.ops.histogram`` on the
JAX CPU backend and through the port's PyTorch ops on CPU tensors; every
count must be equal, with the JAX version's shape and dtype.  The cases are
those of tests/test_parallel.py, widths up to 50,000, ``n`` below, at and
past the width, zero-padded rows, and arbitrary bytes.  The CUDA results
are held to these in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from vcfc_tpu.ops import histogram as jax_hist
from vcfc_tpu.ops.rle import rle_encode as jax_rle_encode
from vcfc_tpu_torch.ops import histogram
from vcfc_tpu_torch.ops.huffman import CTX_INIT, N_CTX

P = [0.7, 0.1, 0.1, 0.05, 0.05]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _assert_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _codes(L, W, S, seed, p=P, pad_rows=0):
    """Codes in the first S columns, zero after; the last pad_rows rows
    zero, as the engine pads a batch."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((L, W), np.uint8)
    codes[:, :S] = rng.choice(5, size=(L, S), p=p)
    if pad_rows:
        codes[L - pad_rows :] = 0
    return codes


# (L, width, samples, n) of the planes, n the histograms' sample count
CASES = [
    (4, 128, 128, 5),
    (64, 128, 100, 100),
    (16, 256, 200, 200),
    (32, 128, 100, 128),
    (32, 384, 300, 300),
    (8, 2560, 2504, 2504),
    (8, 2560, 2504, 1000),  # n < width and < the samples
    (4, 50048, 50000, 50000),
    (4, 50048, 50000, 49999),
    (3, 1, 1, 1),
    (8, 17, 17, 17),
    (16, 384, 300, 0),
    (16, 384, 300, 1000),  # n past the width
]


def test_the_cases_of_test_parallel():
    codes = np.zeros((4, 128), np.uint8)
    codes[0, :5] = [1, 2, 3, 4, 1]
    h = histogram.code_histogram(_t(codes))
    _assert_equal(h, jax_hist.code_histogram(codes))
    assert int(h.sum()) == 4 * 128
    assert h[1] == 2 and h[2] == 1 and h[3] == 1 and h[4] == 1
    hm = histogram.masked_code_histogram(_t(codes), 5)
    _assert_equal(hm, jax_hist.masked_code_histogram(codes, 5))
    assert int(hm.sum()) == 4 * 5


def test_ctx_flag_histogram_of_test_parallel():
    """TestCtxFlagHistogram's case and its scalar reference."""
    rng = np.random.default_rng(7)
    codes = rng.choice(5, size=(16, 256), p=P).astype(np.uint8)
    S = 200
    flagpos = np.asarray(jax_rle_encode(codes, np.int32(S))[0])
    got = histogram.ctx_flag_histogram(_t(flagpos), S)
    _assert_equal(got, jax_hist.ctx_flag_histogram(flagpos, np.int32(S)))
    want = np.zeros((N_CTX, 256), np.int64)
    for row in flagpos:
        ctx = CTX_INIT
        for f in map(int, row[:S]):
            if f:
                want[ctx, f] += 1
                ctx = 0 if f == 0x7F else 1 if f < 0x80 else 2 if f < 0xE0 else 3
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,W,S,n", CASES)
@pytest.mark.parametrize("pad_rows", [0, 1], ids=["full", "zero-padded-rows"])
def test_code_histograms_match_jax(L, W, S, n, pad_rows):
    codes = _codes(L, W, S, seed=W + n, pad_rows=pad_rows)
    _assert_equal(histogram.code_histogram(_t(codes)), jax_hist.code_histogram(codes))
    _assert_equal(histogram.masked_code_histogram(_t(codes), n),
                  jax_hist.masked_code_histogram(codes, np.int32(n)))


@pytest.mark.parametrize("L,W,S,n", CASES)
@pytest.mark.parametrize("pad_rows", [0, 1], ids=["full", "zero-padded-rows"])
def test_ctx_flag_histogram_matches_jax(L, W, S, n, pad_rows):
    codes = _codes(L, W, S, seed=W + n + 1, pad_rows=pad_rows)
    flagpos = np.asarray(jax_rle_encode(codes, np.int32(min(S, max(n, 1))))[0])
    _assert_equal(histogram.ctx_flag_histogram(_t(flagpos), n),
                  jax_hist.ctx_flag_histogram(flagpos, np.int32(n)))


def test_arbitrary_bytes_match_jax():
    """Bytes past code 4 count nowhere in the code histograms; every
    nonzero byte is a flag of the context histogram."""
    rng = np.random.default_rng(11)
    plane = rng.integers(0, 256, (32, 1000), dtype=np.uint8)
    plane[rng.random(plane.shape) < 0.5] = 0
    _assert_equal(histogram.code_histogram(_t(plane)), jax_hist.code_histogram(plane))
    for n in (1, 500, 1000):
        _assert_equal(histogram.masked_code_histogram(_t(plane), n),
                      jax_hist.masked_code_histogram(plane, np.int32(n)))
        _assert_equal(histogram.ctx_flag_histogram(_t(plane), n),
                      jax_hist.ctx_flag_histogram(plane, np.int32(n)))


def test_ctx_flag_histogram_counts_every_flag():
    codes = _codes(64, 2560, 2504, seed=3)
    flagpos = np.asarray(jax_rle_encode(codes, np.int32(2504))[0])
    got = histogram.ctx_flag_histogram(_t(flagpos), 2504)
    assert int(got.sum()) == int((flagpos > 0).sum())
    assert int(got[:, 0].sum()) == 0  # a zero byte is no flag
