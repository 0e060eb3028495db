"""The port's ablation probes (vcfc_tpu_torch.ops.probe) against the Pallas
probe kernels of scripts/kernel_ceiling.py (P1) and scripts/swar_probe.py
(P2).

The probe kernels are nested functions of each script's ``main``.  They
are taken from the script's source by ``ast`` and run, unchanged, through
``vcfc_tpu.ops.pallas_rle._grid_call`` in interpret mode, as
tests/test_pallas.py runs the Pallas kernels on the CPU; nothing is copied
from the scripts and no script is edited.  The same seeded numpy planes go
through the port's plain versions.  Every output is integers, so every
comparison is exact.  The CUDA probes are held to the plain versions in
tests/test_torch_cuda.py.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bench
import vcfc_tpu.ops.pallas_rle as P
from vcfc_tpu_torch.eval import bench_codes, geometry_sweep, kernel_ceiling
from vcfc_tpu_torch.ops import cuda_rle, probe
from vcfc_tpu_torch.ops.rle import rle_decode_plain, rle_encode_plain

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
SHAPES = [(256, 256), (256, 384), (256, 512)]


@functools.cache
def _probe_functions(script: str) -> dict:
    """The nested functions of ``main`` in scripts/<script>, defined in a
    namespace that holds what ``main`` imports."""
    tree = ast.parse((SCRIPTS / script).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = {"jax": jax, "jnp": jnp, "pltpu": pltpu, "P": P, "np": np}
    for node in main.body:
        if isinstance(node, ast.FunctionDef):
            exec(compile(ast.Module(body=[node], type_ignores=[]), str(SCRIPTS / script), "exec"), ns)
    return ns


def _pallas(kernel, codes: np.ndarray, n: int):
    """A probe kernel on one (L, S_pad) plane, as the scripts call it but
    in interpret mode: (plane (L, S_pad) uint8, per-row (L,) int32)."""
    S_pad = codes.shape[1]
    plane, row = P._grid_call(kernel, jnp.asarray(codes), n, [(S_pad, jnp.uint8), (1, jnp.int32)],
                              True)
    return np.asarray(plane), np.asarray(row).reshape(-1)


def _codes(L: int, S_pad: int, seed: int) -> np.ndarray:
    """bench._gt_codes's plane with one row of each code's longest run."""
    codes = bench._gt_codes(L, S_pad, seed)
    codes[:5] = np.arange(5, dtype=np.uint8)[:, None]
    return codes


def _port(fn, codes: np.ndarray, n: int):
    return tuple(t.numpy() for t in fn(torch.from_numpy(codes), n))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _swar_scans():
    f = _probe_functions("swar_probe.py")
    return {
        "swar2": lambda m, S_pad, BL: f["scan_blocked"](m, S_pad, BL, 2),
        "swar4": lambda m, S_pad, BL: f["scan_blocked"](m, S_pad, BL, 4),
        "swar2-strided": lambda m, S_pad, BL: f["scan_blocked_strided"](m, S_pad, BL, 2),
    }


@pytest.mark.parametrize("L,S_pad", SHAPES)
@pytest.mark.parametrize("pad", [0, 84], ids=["n=S_pad", "n<S_pad"])
@pytest.mark.parametrize(
    "kernel,port",
    [("enc_scan_only", probe.scan_only_plain), ("enc_noscan", probe.scan_replaced_plain),
     ("rt_kernel", probe.roundtrip_plain)],
    ids=["P1a-scan-only", "P1b-scan-replaced", "P1c-roundtrip"],
)
def test_p1_plain_versions_match_kernel_ceiling_probes(kernel, port, L, S_pad, pad):
    codes, n = _codes(L, S_pad, S_pad + pad), S_pad - pad
    _assert_equal(_port(port, codes, n),
                  _pallas(_probe_functions("kernel_ceiling.py")[kernel], codes, n))


@pytest.mark.parametrize("L,S_pad", SHAPES)
def test_p2b_scan_only_matches_swar_probe(L, S_pad):
    """swar_probe's scan-only kernel over the full-width scan is P1a."""
    f = _probe_functions("swar_probe.py")
    codes = _codes(L, S_pad, S_pad + 1)
    want = _pallas(f["scan_only_with"](f["scan_full"]), codes, S_pad)
    _assert_equal(_port(probe.scan_only_plain, codes, S_pad), want)


@pytest.mark.parametrize(
    "variant,L,S_pad",
    [(v, 256, w) for v in ("swar2", "swar2-strided") for w in (256, 384, 512)]
    + [("swar4", 256, 256), ("swar4", 256, 512)],
)
def test_p2a_blocked_encode_matches_swar_probe(variant, L, S_pad):
    """The blocked-scan encode gives K1's flags where its aggregate width
    S_pad / block is a power of two or at least 128 (see the test below)."""
    f = _probe_functions("swar_probe.py")
    codes = _codes(L, S_pad, S_pad + 2)
    for n in (S_pad, S_pad - 84):
        want = _pallas(f["full_encode_with"](_swar_scans()[variant]), codes, n)
        _assert_equal(_port(probe.probe_blocked_encode, codes, n), want)
        _assert_equal(_port(rle_encode_plain, codes, n), want)
    scan = _pallas(f["scan_only_with"](_swar_scans()[variant]), codes, S_pad)
    _assert_equal(_port(probe.scan_only_plain, codes, S_pad), scan)


@pytest.mark.parametrize(
    "S_pad,variant,first,count",
    [(384, "swar4", (0, 3), 10450), (192, "swar2", (0, 3), 5159), (192, "swar4", (0, 3), 5035)],
)
def test_swar_probe_blocked_scan_differs_from_k1_at_narrow_widths(S_pad, variant, first, count):
    """swar_probe.py:99 left-pads the aggregate scan by win = min(128, W)
    columns, W = S_pad / block, but its roll ladder shifts by up to
    2^ceil(log2 W) - 1 > W when W < 128 is not a power of two, so the end
    of each row wraps into its start.  On bench._gt_codes's plane (seed 0)
    the blocked encode's flags then differ from K1's; the port computes
    K1's flags at every width and does not follow the probe."""
    f = _probe_functions("swar_probe.py")
    codes = bench._gt_codes(256, S_pad)
    got = _pallas(f["full_encode_with"](_swar_scans()[variant]), codes, S_pad)
    want = _port(rle_encode_plain, codes, S_pad)
    differ = got[0] != want[0]
    assert int(differ.sum()) == count
    assert tuple(int(i) for i in np.argwhere(differ)[0]) == first
    assert (got[1] != want[1]).any()


@pytest.mark.parametrize("L,S,seed", [(256, 384, 0), (64, 2560, 3), (8, 1, 7)])
def test_gt_codes_copy_matches_bench(L, S, seed):
    np.testing.assert_array_equal(bench_codes.gt_codes(L, S, seed), bench._gt_codes(L, S, seed))


@pytest.mark.parametrize("cells", cuda_rle.PROBE_CELLS)
def test_cpu_tensors_take_the_plain_probes(cells):
    codes = torch.from_numpy(_codes(64, 300, 4))
    before = dict(cuda_rle.LAUNCHES)
    _assert_equal(probe.probe_scan_only(codes, 250, cells), probe.scan_only_plain(codes, 250))
    _assert_equal(probe.probe_blocked_encode(codes, 250, cells), rle_encode_plain(codes, 250))
    _assert_equal(probe.probe_scan_replaced(codes, 250), probe.scan_replaced_plain(codes, 250))
    _assert_equal(probe.probe_roundtrip(codes, 250), probe.roundtrip_plain(codes, 250))
    flags = rle_encode_plain(codes, 250)[0]
    _assert_equal(probe.probe_tile_decode(flags, 250), rle_decode_plain(flags, 250))
    assert cuda_rle.LAUNCHES == before


@pytest.mark.parametrize("fn", [probe.probe_scan_only, probe.probe_blocked_encode])
def test_probes_reject_cells_no_kernel_has(fn):
    with pytest.raises(ValueError, match="cells must be one of"):
        fn(torch.zeros((4, 128), dtype=torch.uint8), 100, 3)


@pytest.mark.parametrize(
    "wrapper",
    [cuda_rle.cuda_probe_scan_only, cuda_rle.cuda_probe_scan_replaced,
     cuda_rle.cuda_probe_roundtrip, cuda_rle.cuda_probe_blocked_encode,
     cuda_rle.cuda_probe_tile_decode],
)
@pytest.mark.parametrize(
    "plane,error",
    [(torch.zeros((4, 128), dtype=torch.int32), TypeError),
     (torch.zeros((128, 4), dtype=torch.uint8).t(), ValueError),
     (torch.zeros((4, 128), dtype=torch.uint8), ValueError)],  # a CPU tensor
    ids=["dtype", "non-contiguous", "cpu"],
)
def test_probe_wrappers_reject_what_the_kernels_do_not_take(wrapper, plane, error):
    with pytest.raises(error):
        wrapper(plane, 100)


def test_kernel_ceiling_runs_on_the_cpu(capsys):
    assert kernel_ceiling.main(["--device", "cpu", "--lines", "64", "--samples", "384"]) == 0
    out = capsys.readouterr().out
    assert "every variant equals its reference" in out and "not measured" in out
    result = kernel_ceiling.run("cpu", 64, 300, seed=2)
    assert result["times_ms"] is None and set(result["checks"].values()) == {0}
    assert {f"blocked encode {c} vs K1" for c in cuda_rle.PROBE_CELLS} <= set(result["checks"])
    assert {"tile decode", "tile decode vs K2"} <= set(result["checks"])


def test_kernel_ceiling_without_cuda_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ceiling.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_geometry_sweep_without_cuda_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert geometry_sweep.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
