"""chip_smoke.py's arithmetic and tables, checked without a card.

chip_smoke imports no JAX and no card at import time, so its bound, its
plain-op line and its "kernels" rows can be held to numbers worked out by
hand; its main() refuses to run without a CUDA device.
"""

import pytest
import torch

import chip_smoke
from vcfc_tpu_torch.ops import cuda_rle

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
    ],
)
def test_bound_is_the_bytes_at_the_memory_rate(name, L, W, nbytes):
    assert chip_smoke.bound(name, L, W) == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_k1_bound_at_one_engine_batch():
    assert chip_smoke.bound("rle_encode", 2048, 2560) == pytest.approx(0.0031325, abs=5e-8)


@pytest.mark.parametrize("name,ops", [("rle_encode", 35), ("rle_decode", 25),
                                      ("probe_tile_decode", 25), ("probe_roundtrip", 60)])
def test_plain_op_line(name, ops):
    got = chip_smoke.plain_ops_ms(name, 2048, 2560, INT32_RATE)
    assert got == pytest.approx(ops * 2048 * 2560 / INT32_RATE * 1e3, rel=1e-12)


def test_every_kernel_and_probe_has_terms_a_count_and_a_row():
    names = [*chip_smoke.KERNELS, *chip_smoke.PROBES]
    assert (set(names) == set(chip_smoke.BOUND_BYTES) == set(chip_smoke.PLAIN_OPS)
            == set(cuda_rle.LAUNCHES))
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
        assert kernel in chip_smoke.KERNELS and probe in chip_smoke.PROBES
        assert cells in (None, *cuda_rle.PROBE_CELLS)


def test_main_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
