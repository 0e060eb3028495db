"""The K1/K2 ablation: where the RLE kernels' device time goes.

    python -m vcfc_tpu_torch.eval.kernel_ceiling                  # CUDA, 8192 x 2560
    python -m vcfc_tpu_torch.eval.kernel_ceiling --device cpu --lines 256 --samples 384

The port of ``scripts/kernel_ceiling.py`` and ``scripts/swar_probe.py``.
On ``bench._gt_codes``'s plane (``eval.bench_codes.gt_codes``) it runs
K1 and K2 beside the probes (``ops.probe``) of their earlier tile design:

  blocked encode c   the tile encode at c = 1, 2, 4, 8, 16 cells a thread (C4)
  tile decode        the tile decode (C5)
  scan-only c        the tile encode's run scan alone, at c cells a thread (C1)
  scan-replaced      the tile encode with the scan replaced by idx & ~127 (C2)
  round trip         the tile encode then the tile decode in one kernel,
                     the flags in shared memory (C3)

Correctness comes first, and a mismatch fails the run: every variant is
held to its plain version, the blocked encode at every c to K1's bytes
and the tile decode to K2's.  Then, on a CUDA device only, each is timed
with CUDA events (the median of trials of launches queued behind a
device-side sleep, inputs rotated over more than the L2; K1 and C4 at 16
cells, and K2 and C5, in turns), and the run prints the derived numbers:
the tile design's scan (C4 16 - scan-replaced) and flag plane round trip
(C4 16 + C5 - round trip), the best cells a thread, and K1's and K2's
shares of C4 16 and C5.  A CPU run checks the control flow at a small
shape and times nothing.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import torch

from ..ops.cuda_rle import PROBE_CELLS
from ..ops.probe import (
    probe_blocked_encode,
    probe_roundtrip,
    probe_scan_only,
    probe_scan_replaced,
    probe_tile_decode,
    roundtrip_plain,
    scan_only_plain,
    scan_replaced_plain,
)
from ..ops.rle import rle_decode, rle_decode_plain, rle_encode, rle_encode_plain
from .bench_codes import gt_codes
from .timing import in_turns, median_ms, rotated

LINES, SAMPLES = 8192, 2560  # the TPU probes' shape


def _check(checks: dict, name: str, got, want) -> None:
    """Exact equality of every output; raises on the first mismatch."""
    mismatches = sum(int((g != w).sum()) for g, w in zip(got, want))
    checks[name] = mismatches
    if mismatches:
        raise RuntimeError(f"kernel_ceiling: {name} disagrees with its reference in "
                           f"{mismatches} elements")


def _variants():
    """(name, kernel, plain version) of every variant that takes codes."""
    rows = [("K1 encode", rle_encode, rle_encode_plain)]
    rows += [(f"scan-only {c}", functools.partial(probe_scan_only, cells=c), scan_only_plain)
             for c in PROBE_CELLS]
    rows.append(("scan-replaced", probe_scan_replaced, scan_replaced_plain))
    rows += [(f"blocked encode {c}", functools.partial(probe_blocked_encode, cells=c),
              rle_encode_plain) for c in PROBE_CELLS]
    rows.append(("round trip", probe_roundtrip, roundtrip_plain))
    return rows


# the plain versions, each timed once ("blocked encode"'s is K1's)
_PLAIN = {"K1 encode": rle_encode_plain, "scan-only": scan_only_plain,
          "scan-replaced": scan_replaced_plain, "round trip": roundtrip_plain}


def run(device="cuda", lines: int = LINES, samples: int = SAMPLES, seed: int = 0) -> dict:
    """Check every variant, then time them on a CUDA device.  Returns
    {"device", "shape", "checks": {name: mismatches}, "times_ms",
    "plain_ms", "derived"}; the last three are None on a CPU device."""
    device = torch.device(device)
    codes = torch.from_numpy(gt_codes(lines, samples, seed)).to(device)
    n = samples
    checks: dict = {}
    k1 = rle_encode(codes, n)
    _check(checks, "K1 encode", k1, rle_encode_plain(codes, n))
    for name, kernel, plain in _variants()[1:]:
        _check(checks, name, kernel(codes, n), plain(codes, n))
        if name.startswith("blocked encode"):
            _check(checks, f"{name} vs K1", kernel(codes, n), k1)
    k2 = rle_decode(k1[0], n)
    _check(checks, "K2 decode", k2, rle_decode_plain(k1[0], n))
    _check(checks, "tile decode", probe_tile_decode(k1[0], n), rle_decode_plain(k1[0], n))
    _check(checks, "tile decode vs K2", probe_tile_decode(k1[0], n), k2)
    back, decoded = probe_roundtrip(codes, n)
    if not (torch.equal(back, codes) and bool((decoded == n).all())):
        raise RuntimeError("kernel_ceiling: the round trip does not restore the codes")
    if device.type != "cuda":
        return {"device": str(device), "shape": [lines, samples], "checks": checks,
                "times_ms": None, "plain_ms": None, "derived": None}

    xs = rotated(codes)
    flag_xs = [rle_encode(x, n)[0] for x in xs]
    kernels = {name: kernel for name, kernel, _plain in _variants()}
    times = {}
    times["K1 encode"], times["blocked encode 16"] = in_turns(
        rle_encode, kernels["blocked encode 16"], xs, xs, n)
    times.update((name, median_ms(kernel, xs, n)) for name, kernel in kernels.items()
                 if name not in times)
    times["K2 decode"], times["tile decode"] = in_turns(
        rle_decode, probe_tile_decode, flag_xs, flag_xs, n)
    plain_times = {name: median_ms(plain, xs, n) for name, plain in _PLAIN.items()}
    plain_times["K2 decode"] = median_ms(rle_decode_plain, flag_xs, n)
    del xs, flag_xs
    best_scan = min(PROBE_CELLS, key=lambda c: times[f"scan-only {c}"])
    best_blocked = min(PROBE_CELLS, key=lambda c: times[f"blocked encode {c}"])
    c4_ms, c5_ms = times["blocked encode 16"], times["tile decode"]
    derived = {
        "scan_ms (C4 16 - scan-replaced)": c4_ms - times["scan-replaced"],
        "flag_plane_ms ((C4 16 + C5) - round trip)": c4_ms + c5_ms - times["round trip"],
        "best_scan_only_cells": best_scan,
        "best_blocked_encode_cells": best_blocked,
        "K1 / C4 16": times["K1 encode"] / c4_ms,
        "K2 / C5": times["K2 decode"] / c5_ms,
    }
    return {"device": torch.cuda.get_device_name(device), "shape": [lines, samples],
            "checks": checks, "times_ms": times, "plain_ms": plain_times, "derived": derived}


def table(result: dict) -> list[str]:
    """The result as printable lines: each variant's time and its share of
    the tile design's (C4 at 16 cells for an encode, C5 for a decode, their
    sum for the round trip), then the derived numbers."""
    L, S = result["shape"]
    if result["times_ms"] is None:
        return [f"{L}x{S} on {result['device']}: every variant equals its reference "
                f"({len(result['checks'])} checks); times not measured off a CUDA device"]
    times = result["times_ms"]
    c4, c5 = times["blocked encode 16"], times["tile decode"]
    lines = [f"{L}x{S} on {result['device']}: {len(result['checks'])} checks, 0 mismatches"]
    for name, ms in times.items():
        base, of = (c4 + c5, "C4 16 + C5") if name == "round trip" else (
            (c5, "C5") if name in ("K2 decode", "tile decode") else (c4, "C4 16"))
        lines.append(f"  {name:20s} {ms:9.5f} ms  {ms / base:7.1%} of {of}")
    lines += [f"  {name}: {value:.5f}" if isinstance(value, float) else f"  {name}: {value}"
              for name, value in result["derived"].items()]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--lines", type=int, default=LINES)
    ap.add_argument("--samples", type=int, default=SAMPLES)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("kernel_ceiling: PyTorch sees no CUDA device (pass --device cpu to check the "
              "plain versions)", file=sys.stderr)
        return 1
    result = run(args.device, args.lines, args.samples)
    print("\n".join(table(result)))
    print(json.dumps({"kernel_ceiling": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
