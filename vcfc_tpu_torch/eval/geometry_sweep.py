"""The geometry sweep of K1-K4: rows a CTA x ``__launch_bounds__`` minimum
blocks.

    python -m vcfc_tpu_torch.eval.geometry_sweep        # needs a CUDA device

K1-K4 (``csrc/rle_kernels.cu``) walk each row with one warp, four rows a
CTA, under ``__launch_bounds__(CTA_THREADS)``: K1 and K3 are one kernel
template, K2 and K4 the other.  This writes a copy of the source and its
header into a temporary directory for each pair of rows a CTA x minimum
resident blocks a multiprocessor (which caps the registers a thread), with
``CTA_WARPS`` and the bounds patched, builds every copy with nvcc at once,
holds each build's K1-K4 to their plain versions, and times them on two
planes: a 2,048 x 2,560 batch of a generated cohort (the main path's shape
and data) and the ablation's 8,192 x 2,560 ``gt_codes`` plane.  K3 and K4
take each plane as text: its codes rendered as "a|b\t" words by K4's
plain version (escapes as "?|?", '\n' at the last sample), and the flags
K3 makes of them.  Each time is the mean of two medians (``eval.timing``),
one from a pass over the builds in order and one from a pass in reverse.
It prints each build's times, then its registers, local memory and
resident blocks per SM, then one JSON line.  The package's own build is never touched.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..host.parse import parse_vcf_bytes
from ..ops import _build
from ..ops.rle import (
    rle_decode_plain,
    rle_encode_plain,
    text_rle_decode_plain,
    text_rle_encode_plain,
)
from .bench_codes import gt_codes
from .random_vcf import generate_realistic_vcf
from .timing import median_ms, rotated

# (rows a CTA, minimum blocks): none, half and all of the SM's 64 warps
# asked for, as far as its 32 resident blocks allow
GRID = [(1, 1), (1, 32), (2, 1), (2, 16), (2, 32),
        (4, 1), (4, 8), (4, 16), (8, 1), (8, 4), (8, 8)]
COHORT_SAMPLES, WIDTH = 2504, 2560
# in the order of vcfc_cuda_rle_kernel_info's kernels
KERNELS = ("rle_encode", "rle_decode", "text_encode", "text_decode")
LABELS = {"rle_encode": "K1", "rle_decode": "K2", "text_encode": "K3", "text_decode": "K4"}
PLAIN = {"rle_encode": rle_encode_plain, "rle_decode": rle_decode_plain,
         "text_encode": text_rle_encode_plain, "text_decode": text_rle_decode_plain}
# each kernel's outputs in the order of its C entry point: the dtype of an
# (L, W) plane, or None for an (L,) int32 column
OUTPUTS = {"rle_encode": (torch.uint8, None), "rle_decode": (torch.uint8, None),
           "text_encode": (torch.uint8, None, None),
           "text_decode": (torch.int32, torch.uint8, None)}


def patched_source(rows: int, blocks: int) -> str:
    """rle_kernels.cu with CTA_WARPS = rows and the launch bounds of the
    encode and decode kernels (K1/K3, K2/K4) asking for ``blocks`` resident
    blocks."""
    src = (_build.CSRC / "rle_kernels.cu").read_text()
    edits = {"constexpr int CTA_WARPS = 4;": (1, f"constexpr int CTA_WARPS = {rows};"),
             "__launch_bounds__(CTA_THREADS)": (2, f"__launch_bounds__(CTA_THREADS, {blocks})")}
    for old, (count, new) in edits.items():
        if src.count(old) != count:
            raise RuntimeError(f"geometry_sweep: rle_kernels.cu holds {old!r} "
                               f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def _build_copy(geometry, tmp: Path) -> Path:
    rows, blocks = geometry
    d = tmp / f"rows{rows}-blocks{blocks}"
    d.mkdir()
    for header in _build.CSRC.glob("*.cuh"):
        (d / header.name).write_bytes(header.read_bytes())
    (d / "rle_kernels.cu").write_text(patched_source(rows, blocks))
    lib = d / "rle_kernels.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "rle_kernels.cu")], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the {geometry} copy:\n{done.stderr}")
    return lib


class Build:
    """K1-K4 of one patched build, loaded with ctypes."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        for kernel in KERNELS:
            fn = getattr(self.lib, f"vcfc_cuda_{kernel}")
            fn.argtypes = [*[ctypes.c_void_p] * (1 + len(OUTPUTS[kernel])), ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        self.lib.vcfc_cuda_rle_kernel_info.argtypes = [ctypes.c_int,
                                                       *[ctypes.POINTER(ctypes.c_int)] * 3]
        self.lib.vcfc_cuda_rle_kernel_info.restype = ctypes.c_int

    def launch(self, kernel: str, x: torch.Tensor, n: int):
        outs = [torch.empty(x.shape if dtype else x.shape[:1], dtype=dtype or torch.int32,
                            device=x.device) for dtype in OUTPUTS[kernel]]
        err = getattr(self.lib, f"vcfc_cuda_{kernel}")(
            x.data_ptr(), *(out.data_ptr() for out in outs), x.shape[0], x.shape[1], n,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"geometry_sweep: {kernel} launch failed: cudaError {err}")
        return tuple(outs)

    def info(self, kernel: str) -> dict:
        values = [ctypes.c_int() for _ in range(3)]
        err = self.lib.vcfc_cuda_rle_kernel_info(KERNELS.index(kernel),
                                                 *map(ctypes.byref, values))
        if err:
            raise RuntimeError(f"geometry_sweep: {kernel} attributes: cudaError {err}")
        return dict(zip(("registers", "local_bytes", "blocks_per_sm"), (v.value for v in values)))


def planes() -> dict:
    """{name: (codes (L, WIDTH) uint8 numpy, n_samples)}: the cohort batch
    and the ablation's plane."""
    vcf = generate_realistic_vcf(COHORT_SAMPLES, 2048, seed=5)
    codes = np.zeros((2048, WIDTH), np.uint8)
    codes[:, :COHORT_SAMPLES] = parse_vcf_bytes(vcf).codes
    return {"cohort batch 2048x2560": (codes, COHORT_SAMPLES),
            "gt_codes 8192x2560": (gt_codes(8192, WIDTH), WIDTH)}


def run() -> dict:
    """Build, check and time every geometry; returns {"device", "builds":
    [{"rows_per_cta", "min_blocks", kernel: info for each of KERNELS}],
    "ms": {plane: {"rows,blocks": {kernel: ms for each of KERNELS}}}}."""
    with tempfile.TemporaryDirectory(prefix="geometry_sweep-") as tmp:
        t = time.perf_counter()
        with ThreadPoolExecutor(len(GRID)) as pool:
            paths = list(pool.map(lambda g: _build_copy(g, Path(tmp)), GRID))
        print(f"geometry_sweep: built {len(GRID)} geometries in {time.perf_counter() - t:.1f} s")
        builds = {g: Build(p) for g, p in zip(GRID, paths)}
    attrs = [{"rows_per_cta": r, "min_blocks": b, **{k: builds[(r, b)].info(k) for k in KERNELS}}
             for r, b in GRID]

    ms = {}
    for plane, (codes_np, n) in planes().items():
        codes = torch.from_numpy(codes_np).cuda()
        flags = rle_encode_plain(codes, n)[0]
        inputs = {"rle_encode": codes, "rle_decode": flags,
                  "text_encode": text_rle_decode_plain(flags, n)[0], "text_decode": flags}
        for geometry in GRID:
            for name, x in inputs.items():
                got, want = builds[geometry].launch(name, x, n), PLAIN[name](x, n)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"geometry_sweep: {name} at {geometry} disagrees with "
                                       f"its plain version on {plane}")
        rotations = {name: rotated(x) for name, x in inputs.items()}
        passes = {g: {name: [] for name in inputs} for g in GRID}
        for order in (GRID, GRID[::-1]):
            for geometry in order:
                for name, xs in rotations.items():
                    launch = builds[geometry].launch
                    passes[geometry][name].append(
                        median_ms(lambda x, n_, k=name, f=launch: f(k, x, n_), xs, n))
        del rotations
        ms[plane] = {f"{r},{b}": {name: sum(v) / len(v) for name, v in passes[(r, b)].items()}
                     for r, b in GRID}
    return {"device": torch.cuda.get_device_name(0), "builds": attrs, "ms": ms}


def table(result: dict) -> list[str]:
    lines = [f"geometry sweep on {result['device']}, one warp a row: ms a launch"]
    head = "".join(f"{LABELS[k]:>10s}" for k in KERNELS)
    for plane, ms in result["ms"].items():
        lines.append(f"  {plane}: rows/CTA min blocks{head}")
        for build in result["builds"]:
            key = f"{build['rows_per_cta']},{build['min_blocks']}"
            lines.append(f"  {build['rows_per_cta']:8d} {build['min_blocks']:10d}"
                         + "".join(f"{ms[key][k]:10.5f}" for k in KERNELS))
    lines.append("  registers/local bytes/blocks per SM: rows/CTA min blocks"
                 + "".join(f"{LABELS[k]:>12s}" for k in KERNELS))
    for build in result["builds"]:
        attrs = "".join(f"{build[k]['registers']}/{build[k]['local_bytes']}/"
                        f"{build[k]['blocks_per_sm']}".rjust(12) for k in KERNELS)
        lines.append(f"  {build['rows_per_cta']:8d} {build['min_blocks']:10d}{attrs}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("geometry_sweep: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    result = run()
    print("\n".join(table(result)))
    print(json.dumps({"geometry_sweep": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
