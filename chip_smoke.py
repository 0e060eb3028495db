#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the .vcfc codec (vcfc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and make with g++.  It
builds the CUDA kernels and the native host library from this checkout,
then runs, in order, failing (non-zero exit) at the first phase that fails:

  1. the card's name and power limit; nvcc builds of csrc/rle_kernels.cu
     (K1-K4) and csrc/probe_kernels.cu (the ablation probes C1-C5), both
     started together; make of native/libvcfc_host.so; the 1000 Genomes
     phase 3 sized cohort
  2. each kernel against its plain PyTorch version on the card, exact on
     every output element, at the engine's batch shapes, on edge cases and
     on the group and round edges of eval.edge_cases; C1 and C4 at every
     cells a thread, C4 against K1's outputs and C5 against K2's too
  3. the routes of the main path on the cohort: the parse route (K1/K2),
     the VCFC_PARSE=device text route (K3/K4) and the VCFC_UNPACK=device
     decompress route (packed flags unpacked on the card, then K2); each
     route's compress bytes equal to the native host executor's, its
     decompress restoring the input, and a CLI compress/decompress round
     trip of each route in a temporary directory
  4. each route's kernels' launch counts from its own phase 3 run above zero
  5. each kernel's time and its plain version's (CUDA events, median,
     inputs read from HBM) beside its bound (the bytes it must move at the
     card's memory rate) and its plain-op line (its plain version's
     elementwise steps at the card's INT32 rate), K1 and K2 in turns with
     their earlier tile designs C4 (16 cells) and C5 and beside a device
     copy of their input plane; and the end-to-end seconds of the routes
  6. where the time goes, per route: host-clock seconds per layer from
     phase 3's calls, and device busy time from torch.profiler events on
     the CUDA device only
  7. the K1/K2 ablation (vcfc_tpu_torch.eval.kernel_ceiling) at 8192 x
     2560, K1 and K2 again in turns with C4 and C5, its probes' launch
     counts from that run above zero, and its table
  8. one "kernels" JSON line (launches, mismatches, times, bounds), then a
     last line {"ok": true, "device": {...}}
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from vcfc_tpu_torch import engine
from vcfc_tpu_torch.eval import kernel_ceiling
from vcfc_tpu_torch.eval.bench_codes import gt_codes
from vcfc_tpu_torch.eval.edge_cases import encode_edge_cases, flag_edge_cases
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.eval.timing import LAUNCHES_PER_TRIAL, TRIALS, in_turns, median_ms, rotated
from vcfc_tpu_torch.format.vcf import parse_metadata_headers
from vcfc_tpu_torch.host import fast, native
from vcfc_tpu_torch.host.parse import parse_vcf_bytes
from vcfc_tpu_torch.ops._build import build
from vcfc_tpu_torch.ops.cuda_rle import (
    LAUNCHES,
    PROBE_CELLS,
    cuda_probe_blocked_encode,
    cuda_probe_roundtrip,
    cuda_probe_scan_only,
    cuda_probe_scan_replaced,
    cuda_probe_tile_decode,
    cuda_rle_decode,
    cuda_rle_encode,
    cuda_text_decode,
    cuda_text_encode,
    kernel_info,
)
from vcfc_tpu_torch.ops.probe import roundtrip_plain, scan_only_plain, scan_replaced_plain
from vcfc_tpu_torch.ops.rle import (
    rle_decode_plain,
    rle_encode_plain,
    text_rle_decode_plain,
    text_rle_encode_plain,
)

REPO = Path(__file__).resolve().parent
# The cohort: 1000 Genomes phase 3 has 2,504 samples.
SAMPLES = 2504
LINES = 65536
SEED = 5
CLI_LINES = 8192  # the CLI round trips run on this prefix of the cohort
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
TIMED_SHAPE = (2048, 2560)  # one engine batch of the cohort
SOURCE = "vcfc_tpu_torch/csrc/rle_kernels.cu"
PROBE_SOURCE = "vcfc_tpu_torch/csrc/probe_kernels.cu"
KERNELS = {  # name -> (kernel, plain version, the TPU kernel it replaces)
    "rle_encode": (cuda_rle_encode, rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:181"),
    "rle_decode": (cuda_rle_decode, rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:234"),
    "text_encode": (cuda_text_encode, text_rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:265"),
    "text_decode": (cuda_text_decode, text_rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:292"),
}
# The ablation probes: name -> (kernel, plain version, the TPU kernel it
# replaces, its row in kernel_ceiling's times, its plain version's row);
# C1 and C4 take cells= and report their best cells.
PROBES = {
    "probe_scan_only": (cuda_probe_scan_only, scan_only_plain,
                        "scripts/kernel_ceiling.py:69", "scan-only", "scan-only"),
    "probe_scan_replaced": (cuda_probe_scan_replaced, scan_replaced_plain,
                            "scripts/kernel_ceiling.py:91", "scan-replaced", "scan-replaced"),
    "probe_roundtrip": (cuda_probe_roundtrip, roundtrip_plain,
                        "scripts/kernel_ceiling.py:130", "round trip", "round trip"),
    "probe_blocked_encode": (cuda_probe_blocked_encode, rle_encode_plain,
                             "scripts/swar_probe.py:119", "blocked encode", "K1 encode"),
    "probe_tile_decode": (cuda_probe_tile_decode, rle_decode_plain,
                          "vcfc_tpu/ops/pallas_rle.py:234", "tile decode", "K2 decode"),
}
# K1 and K2 beside their earlier tile designs, timed in turns: kernel ->
# (probe, its cells= or None)
EARLIER_DESIGN = {"rle_encode": ("probe_blocked_encode", 16),
                  "rle_decode": ("probe_tile_decode", None)}
CELLS_PROBES = ("probe_scan_only", "probe_blocked_encode")
# The bound, the least time the card could take: the bytes each kernel must
# move per cell (each input read once, each output written once) and per
# row (the int32 per-row outputs) over the H100's published 3.35 TB/s.
# Every kernel is bound by bytes, so each row of the "kernels" line says
# bound_by "bytes".
HBM_BYTES_PER_S = 3.35e12
BOUND_BYTES = {  # name -> (bytes per cell, bytes per row)
    "rle_encode": (2, 4),
    "rle_decode": (2, 4),
    "text_encode": (5, 8),
    "text_decode": (6, 4),
    "probe_scan_only": (2, 4),
    "probe_scan_replaced": (2, 4),
    "probe_roundtrip": (2, 4),
    "probe_blocked_encode": (2, 4),
    "probe_tile_decode": (2, 4),
}
# Printed beside the bound by phases 5 and 7, not on the "kernels" line:
# the plain-op line, the integer operations per cell of a kernel's plain
# version (one per elementwise step over the plane) over the card's INT32
# rate, 64 INT32 lanes per SM per clock (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper, Hopper SM) x the card's SMs x its maximum SM
# clock from nvidia-smi.  It counts one way of writing the function, not
# the work the function needs (K1 and K2 do fewer), so it bounds nothing.
# The probes' counts come from K1's and K2's: C1 keeps K1's plain steps up
# to the scan (the int32 cast, the shifted copy, the five of new_run, the
# where, the cummax) and adds the & 0x7F and the cast, 11; C2 swaps the
# where + cummax of the scan for an & and a where, 35 like K1; C3's plain
# version is K1's then K2's, 35 + 25; C4's is K1's, C5's K2's.
INT32_OPS_PER_SM_PER_CLOCK = 64
CLOCK_QUERY = ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"]
PLAIN_OPS = {  # name -> the plain version's operations per cell
    "rle_encode": 35,
    "rle_decode": 25,
    "text_encode": 59,
    "text_decode": 37,
    "probe_scan_only": 11,
    "probe_scan_replaced": 35,
    "probe_roundtrip": 60,
    "probe_blocked_encode": 35,
    "probe_tile_decode": 25,
}
VALID_WORDS = [b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t"]
ESCAPE_WORDS = [b"2|0\t", b"./.\t", b"0/1\t", b"9|9\t", b"1|2\t"]
ROUTE_ENV = ("VCFC_PARSE", "VCFC_UNPACK")
# route -> its environment, its kernels, host-clock layers per engine call
# (None: the call is the parse route's, which the route does not change)
ROUTES = {
    "parse route": ({}, ("rle_encode", "rle_decode"), {
        "compress": {"parse": (engine, "parse_vcf_bytes"),
                     "device layer": (engine, "encode_on_device"),
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_on_device"),
                       "render": (fast, "assemble_vcf_native")}}),
    "text route": ({"VCFC_PARSE": "device"}, ("text_encode", "text_decode"), {
        "compress": {"index": (native, "index_lines"),
                     "gather": (native, "gather_text"),
                     "device layer": (engine, "encode_text_on_device"),
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_text_on_device"),
                       "render from text": (fast, "assemble_vcf_from_text")}}),
    "unpack route": ({"VCFC_UNPACK": "device"}, ("rle_decode",), {
        "compress": None,
        "decompress": {"packed parse": (fast, "parse_vcfc_packed_native"),
                       "device layer": (engine, "unpack_decode_on_device"),
                       "render": (fast, "assemble_vcf_native")}}),
}


def phase1_build():
    card = subprocess.run(CARD_QUERY, check=True, capture_output=True, text=True)
    print(card.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        paths = list(pool.map(build, ("rle_kernels", "probe_kernels")))
    print(f"phase 1: built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t:.1f} s")
    subprocess.run(["make", "-C", str(REPO / "native"), "libvcfc_host.so"],
                   check=True, stdout=sys.stderr)
    if not native.available():
        raise SystemExit("phase 1: the native host library does not load")
    print("phase 1: native host library built")
    t = time.perf_counter()
    vcf = generate_realistic_vcf(SAMPLES, LINES, SEED)
    print(f"phase 1: generated {len(vcf):,} bytes of VCF ({SAMPLES} x {LINES}) "
          f"in {time.perf_counter() - t:.1f} s")
    return vcf


def _cohort(rng, L, W, S, p=(0.81, 0.072, 0.072, 0.0264, 0.0196)):
    codes = np.zeros((L, W), np.uint8)
    codes[:, :S] = rng.choice(5, size=(L, S), p=p)
    codes[:5, :S] = np.arange(5, dtype=np.uint8)[:, None]  # each code's longest run
    return codes


def encode_cases(rng):
    """(name, codes, n_samples) for K1, from the engine's shapes to edges."""
    cases = [
        ("cohort batch 2048x2560", _cohort(rng, 2048, 2560, 2504), 2504),
        ("wide batch 2048x50048", _cohort(rng, 2048, 50048, 50000), 50000),
    ]
    for s in (1, 127, 128):
        cases.append((f"S={s} S_pad=128", _cohort(rng, 256, 128, s), s))
    runs = np.zeros((64, 16384), np.uint8)  # runs past a thread's and a tile's cells
    for row in runs:
        pos = 0
        while pos < row.size:
            n = int(rng.integers(1, 6000))
            row[pos : pos + n] = rng.integers(0, 5)
            pos += n
    cases.append(("long runs 64x16384", runs, 16300))
    cases.append(("escape-dense 256x4096",
                  _cohort(rng, 256, 4096, 4000, p=(0.1, 0.05, 0.05, 0.05, 0.75)), 4000))
    cases.append(("arbitrary bytes 256x1000", rng.integers(0, 256, (256, 1000), dtype=np.uint8), 990))
    for w, s in ((1, 1), (17, 17), (4097, 4097), (333, 400)):
        cases.append((f"width {w} S={s}", _cohort(rng, 64, w, min(s, w)), s))
    return cases


def malformed_flag_cases(rng):
    """(name, flags, n_samples) for K2 and K4: random planes with gaps past
    127 cells, empty rows, zero tails and rows full of flags."""
    cases = []
    for w, s in ((2560, 2504), (16384, 16300), (1000, 990), (128, 1)):
        m = rng.integers(0, 256, (256, w), dtype=np.uint8)
        m[rng.random((256, w)) < 0.97] = 0
        m[:8] = 0
        m[8:16, w // 2 :] = 0
        m[16:24] = rng.integers(1, 256, (8, w), dtype=np.uint8)
        cases.append((f"malformed {256}x{w}", m, s))
    return cases


def _words(rng, codes, S):
    """int32 text words of gather_text's layout for a code plane: codes 0-3
    as their genotype, others as a random escape genotype, tab separators,
    a 0 separator on sample S - 1 and zero words from column S on."""
    def as_int(fields):
        return np.array([int.from_bytes(f, "little") for f in fields], np.uint32)

    valid, escapes = as_int(VALID_WORDS), as_int(ESCAPE_WORDS)
    words = escapes[rng.integers(0, len(escapes), codes.shape)]
    ok = codes < 4
    words[ok] = valid[codes[ok]]
    if S <= codes.shape[1]:
        words[:, S - 1] &= 0x00FFFFFF
    words[:, S:] = 0
    return words.view(np.int32)


def cohort_text_batch(vcf: bytes) -> np.ndarray:
    """The cohort's first engine batch as the text route gathers it:
    TIMED_SHAPE int32 words from native.gather_text."""
    header = parse_metadata_headers(vcf)
    raw = np.frombuffer(vcf, np.uint8)
    _start, end, sample_start = native.index_lines(raw, header.data_offset)
    L, W = TIMED_SHAPE
    irregular = (end[:L] - sample_start[:L] != 4 * SAMPLES - 1).astype(np.uint8)
    text = native.gather_text(raw[header.data_offset :], sample_start[:L], irregular, SAMPLES, W)
    return text.view(np.int32)


def text_encode_cases(rng, vcf, cases):
    """(name, words, n_samples) for K3: the cohort's first batch as
    gather_text builds it, every K1 case as words, and separator, zero-row
    and arbitrary-word edges."""
    out = [("cohort batch 2048x2560 (gather_text)", cohort_text_batch(vcf), SAMPLES)]
    out += [(name, _words(rng, codes, n), n) for name, codes, n in cases]
    bad = _words(rng, _cohort(rng, 256, 384, 300), 300)
    cols = rng.integers(0, 299, 64)
    bad[np.arange(64), cols] = (bad[np.arange(64), cols] & 0x00FFFFFF) | (ord("x") << 24)
    bad[64:128, 299] |= ord("x") << 24  # sample n - 1's separator is not checked
    bad[128:192, 300:] = rng.integers(-(1 << 31), 1 << 31, (64, 84), dtype=np.int64)  # padding
    out.append(("bad separators 256x384", bad, 300))
    zero = _words(rng, _cohort(rng, 256, 2560, 2504), 2504)
    zero[::2] = 0  # the rows gather_text leaves zero for irregular lines and padding
    out.append(("zero rows 256x2560", zero, 2504))
    out.append(("random 32-bit words 256x1000",
                rng.integers(-(1 << 31), 1 << 31, (256, 1000), dtype=np.int64).astype(np.int32), 990))
    alphabet = np.frombuffer(b"01|\t2./\n", np.uint8)
    near = alphabet[rng.integers(0, len(alphabet), (256, 4 * 512))]
    out.append(("genotype-alphabet bytes 256x512", near.view(np.int32), 500))
    return out


def probe_cases():
    """(name, codes, n_samples) for C1-C4: the ablation's plane, n below
    the width, widths no group of cells divides, and rows all escapes and
    all 0|0."""
    cases = [("probe shape 8192x2560", gt_codes(8192, 2560), 2560),
             ("n < width 256x2560", gt_codes(256, 2560, 1), 2504)]
    for w in (1, 17, 192, 384, 2504, 50000):
        cases.append((f"width {w}", gt_codes(8 if w == 50000 else 256, w, w), w))
    rows = gt_codes(256, 2560, 2)
    rows[::3] = 4
    rows[1::3] = 0
    cases.append(("all-escape and all-zero rows 256x2560", rows, 2560))
    return cases


def _compare(got, want):
    torch.cuda.synchronize()
    mismatches = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    return mismatches, err


def phase2_kernels(rng, vcf):
    stats = {name: {"cases": 0, "mismatches": 0, "max_abs_err": 0}
             for name in [*KERNELS, *PROBES]}

    def check(name, case, x, n, cells=None, want=None):
        """The kernel against its plain version (or against want)."""
        kernel, plain = (KERNELS[name] if name in KERNELS else PROBES[name])[:2]
        if cells is not None:
            kernel = functools.partial(kernel, cells=cells)
            case = f"{case} cells={cells}"
        got = kernel(x, n)
        mism, err = _compare(got, plain(x, n) if want is None else want)
        st = stats[name]
        st["cases"] += 1
        st["mismatches"] += mism
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if mism:
            print(f"phase 2: {name} {case}: {mism} mismatching elements")
        return got

    cases = encode_cases(rng) + encode_edge_cases()
    flag_cases = malformed_flag_cases(rng) + flag_edge_cases()
    decode_inputs = [(case, check("rle_encode", case, torch.from_numpy(codes).cuda(), n)[0], n)
                     for case, codes, n in cases]
    text_inputs = [(case, check("text_encode", case, torch.from_numpy(words).cuda(), n)[0], n)
                   for case, words, n in text_encode_cases(rng, vcf, cases)]
    del cases
    for case, flags, n in flag_cases:
        decode_inputs.append((case, torch.from_numpy(flags).cuda(), n))
        text_inputs.append((case, torch.from_numpy(flags).cuda(), n))
    for case, flags, n in decode_inputs:
        k2 = check("rle_decode", case, flags, n)
        check("probe_tile_decode", case, flags, n)
        check("probe_tile_decode", f"{case} against K2", flags, n, want=k2)
    for case, flags, n in text_inputs:
        check("text_decode", case, flags, n)
    del decode_inputs, text_inputs
    for case, codes, n in probe_cases():
        x = torch.from_numpy(codes).cuda()
        k1 = cuda_rle_encode(x, n)
        for cells in PROBE_CELLS:
            check("probe_scan_only", case, x, n, cells)
            check("probe_blocked_encode", case, x, n, cells)
            check("probe_blocked_encode", f"{case} against K1", x, n, cells, want=k1)
        check("probe_scan_replaced", case, x, n)
        check("probe_roundtrip", case, x, n)
    check("probe_roundtrip", "width 65536", torch.from_numpy(gt_codes(16, 65536, 3)).cuda(), 65500)
    for name, st in stats.items():
        print(f"phase 2: {name}: {st['cases']} cases, {st['mismatches']} mismatching elements, "
              f"max abs error {st['max_abs_err']}")
    if any(st["mismatches"] for st in stats.values()):
        raise SystemExit("phase 2: a kernel disagrees with its plain version")
    return stats


def host_reference(vcf: bytes) -> bytes:
    """The native host executor's .vcfc bytes (no device involved)."""
    parsed = parse_vcf_bytes(vcf)
    flagpos, nseg = native.rle_encode_host(parsed.codes, parsed.n_samples)
    return fast.assemble_vcfc_native(parsed, flagpos, nseg)


@contextlib.contextmanager
def route_env(env):
    """The route variables (ROUTE_ENV) as env sets them, the others unset,
    inside; restored after."""
    saved = {var: os.environ.pop(var, None) for var in ROUTE_ENV}
    os.environ.update(env)
    try:
        yield
    finally:
        for var, value in saved.items():
            os.environ.pop(var, None)
            if value is not None:
                os.environ[var] = value


@contextlib.contextmanager
def batch_shapes(mod, attr):
    """Record the shape of the first argument of every call of mod.attr
    made inside."""
    shapes = []
    fn = getattr(mod, attr)

    def spy(*args, **kwargs):
        shapes.append(tuple(args[0].shape))
        return fn(*args, **kwargs)

    setattr(mod, attr, spy)
    try:
        yield shapes
    finally:
        setattr(mod, attr, fn)


@contextlib.contextmanager
def layer_clock(layers):
    """Time, on the host clock, each layer the engine calls while inside:
    yields {layer: seconds}, summed over the layer's calls."""
    seconds = dict.fromkeys(layers, 0.0)

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] += time.perf_counter() - t
        return run

    saved = {name: getattr(mod, attr) for name, (mod, attr) in layers.items()}
    for name, (mod, attr) in layers.items():
        setattr(mod, attr, timed(name, saved[name]))
    try:
        yield seconds
    finally:
        for name, (mod, attr) in layers.items():
            setattr(mod, attr, saved[name])


def _cli_round_trip(prefix: bytes, route_vars: dict):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    for var in ROUTE_ENV:
        env.pop(var, None)
    env.update(route_vars)
    with tempfile.TemporaryDirectory() as tmp:
        src, mid, out = (os.path.join(tmp, f) for f in ("in.vcf", "in.vcfc", "out.vcf"))
        with open(src, "wb") as f:
            f.write(prefix)
        for verb, a, b in (("compress", src, mid), ("decompress", mid, out)):
            r = subprocess.run([sys.executable, "-m", "vcfc_tpu_torch", verb, a, b],
                               cwd=tmp, env=env, capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"phase 3: CLI {verb} failed ({r.returncode}):\n{r.stderr}")
        with open(mid, "rb") as f:
            cli_vcfc = f.read()
        with open(out, "rb") as f:
            return cli_vcfc, f.read()


def phase3_main_path(vcf: bytes):
    """Each route once on the cohort, the counts set to 0 just before it
    and read just after; returns {route: its run}.  A route whose compress
    is the parse route's decompresses the parse route's bytes."""
    reference = host_reference(vcf)
    cut = vcf.index(b"\n", vcf.index(b"\n#CHROM") + 1) + 1  # end of the header
    for _ in range(CLI_LINES):
        cut = vcf.index(b"\n", cut) + 1
    prefix = vcf[:cut]
    prefix_reference = host_reference(prefix)
    runs = {}
    for route, (env, _kernels, layers) in ROUTES.items():
        with route_env(env):
            for name in LAUNCHES:
                LAUNCHES[name] = 0
            if layers["compress"] is None:
                vcfc, compress_s, compress_layers = runs["parse route"]["vcfc"], None, None
            else:
                with layer_clock(layers["compress"]) as compress_layers:
                    t = time.perf_counter()
                    vcfc = engine.compress(vcf)
                    compress_s = time.perf_counter() - t
            with layer_clock(layers["decompress"]) as decompress_layers, \
                    batch_shapes(engine, "unpack_rle_decode") as packed_batches:
                t = time.perf_counter()
                back = engine.decompress(vcfc)
                decompress_s = time.perf_counter() - t
            counts = dict(LAUNCHES)
        shown = "the parse route's" if compress_s is None else f"{compress_s:.3f} s ->"
        print(f"phase 3: {route}: compress {shown} {len(vcfc):,} bytes; "
              f"decompress {decompress_s:.3f} s; launches {counts}")
        if vcfc != reference:
            raise SystemExit(f"phase 3: {route}: compress bytes differ from the native "
                             "host executor's")
        if back != vcf:
            raise SystemExit(f"phase 3: {route}: decompress does not restore the input")
        print(f"phase 3: {route}: compress == native host executor bytes; "
              "decompress restores the input")
        if packed_batches:
            rows, m = packed_batches[0]
            s_pad = -(-SAMPLES // 128) * 128
            print(f"phase 3: {route}: packed width M = {m} against S_pad = {s_pad}; H2D per "
                  f"batch of {rows} lines {rows * (m + 4):,} bytes (flags + counts) against "
                  f"{rows * s_pad:,} for the positional plane ({len(packed_batches)} batches)")
        cli_vcfc, cli_back = _cli_round_trip(prefix, env)
        if cli_vcfc != prefix_reference or cli_back != prefix:
            raise SystemExit(f"phase 3: {route}: CLI round trip differs")
        print(f"phase 3: {route}: CLI compress/decompress round trip ok ({CLI_LINES} lines)")
        runs[route] = {"vcfc": vcfc, "compress_s": compress_s, "decompress_s": decompress_s,
                       "counts": counts, "layers": {"compress": compress_layers,
                                                    "decompress": decompress_layers}}
    return runs


def int32_ops_per_s() -> float:
    """The card's peak INT32 rate: lanes per SM per clock x SMs x max SM clock."""
    mhz = subprocess.run(CLOCK_QUERY, check=True, capture_output=True, text=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_PER_CLOCK * sms * float(mhz.split()[0]) * 1e6


def bound(name, L, W):
    """The bound in ms of one launch on an (L, W) plane: its bytes over the
    card's memory rate."""
    per_cell, per_row = BOUND_BYTES[name]
    return (per_cell * L * W + per_row * L) / HBM_BYTES_PER_S * 1e3


def plain_ops_ms(name, L, W, int_ops_per_s):
    """The plain-op line in ms of one launch on an (L, W) plane: its plain
    version's elementwise steps over the card's INT32 rate."""
    return PLAIN_OPS[name] * L * W / int_ops_per_s * 1e3


def _kernel_row(name, source, replaces, launches, stats, shape, ms, plain_ms):
    """One entry of the "kernels" line."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": stats[name]["max_abs_err"],
            "mismatches": stats[name]["mismatches"], "shape": list(shape), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound(name, *shape), "bound_by": "bytes",
            "library_ms": None}


def phase5_times(vcf, stats, launches, int_rate):
    L, W = TIMED_SHAPE
    codes = torch.from_numpy(parse_vcf_bytes(vcf).codes[:L]).cuda()
    codes = torch.nn.functional.pad(codes, (0, W - SAMPLES))
    text = torch.from_numpy(cohort_text_batch(vcf)).cuda()
    flags = rle_encode_plain(codes, SAMPLES)[0]
    inputs = {"rle_encode": codes, "rle_decode": flags, "text_encode": text, "text_decode": flags}
    print(f"phase 5: INT32 rate {int_rate:.6e} ops/s "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs), "
          f"HBM {HBM_BYTES_PER_S:.3e} B/s")
    for name in EARLIER_DESIGN:
        info = kernel_info(name)
        print(f"phase 5: {name} as built: {info['registers']} registers and "
              f"{info['local_bytes']} local bytes a thread, {info['blocks_per_sm']} resident "
              "blocks of 128 threads per SM")
    rows = []
    for name, (kernel, plain, replaces) in KERNELS.items():
        x = inputs[name]
        xs = rotated(x)
        warm_ms = median_ms(kernel, [x], SAMPLES)
        if name in EARLIER_DESIGN:
            probe, cells = EARLIER_DESIGN[name]
            earlier = PROBES[probe][0]
            if cells is not None:
                earlier = functools.partial(earlier, cells=cells)
            ms, earlier_ms = in_turns(kernel, earlier, xs, xs, SAMPLES)
        else:
            ms = median_ms(kernel, xs, SAMPLES)
        plain_ms = median_ms(plain, xs, SAMPLES)
        row = _kernel_row(name, SOURCE, replaces, launches[name], stats, (L, W), ms, plain_ms)
        ops_ms = plain_ops_ms(name, L, W, int_rate)
        print(f"phase 5: {name} {L}x{W}: kernel {ms:.5f} ms (one input, L2-warm: "
              f"{warm_ms:.5f} ms), plain {plain_ms:.5f} ms, bound {row['bound_ms']:.5f} ms by "
              f"bytes ({row['bound_ms'] / ms:.1%} of the kernel's time), plain-op line "
              f"{ops_ms:.5f} ms (median of {TRIALS} trials of "
              f"{LAUNCHES_PER_TRIAL} launches, cycling through {len(xs)} copies of the input)")
        if name in EARLIER_DESIGN:
            copy = torch.empty_like(x)
            copy_ms = median_ms(lambda src, _n: copy.copy_(src), xs, SAMPLES)
            shown = probe + ("" if cells is None else f" at {cells} cells")
            print(f"phase 5: {name} {L}x{W} in turns with its earlier design {shown}: "
                  f"{ms:.5f} ms against {earlier_ms:.5f} ms ({ms / earlier_ms:.1%}); bound "
                  f"{row['bound_ms']:.5f} ms, plain-op lines {ops_ms:.5f} and "
                  f"{plain_ops_ms(probe, L, W, int_rate):.5f} ms; a device copy of its input "
                  f"plane (Tensor.copy_, the same bytes in and out) {copy_ms:.5f} ms")
        del xs
        rows.append(row)
    return rows


def _device_busy(fn):
    """Run fn under torch.profiler; returns (wall ms, busy ms, ms by kind)
    from the events on the CUDA device only (kernels and memcpys): busy is
    the union of their intervals, host runtime and aten rows never count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("phase 6: the profiler recorded no CUDA-device events")
    kinds = {"h2d": 0.0, "d2h": 0.0, "kernel": 0.0, "other": 0.0}
    spans = []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        kind = ("h2d" if e.name.startswith("Memcpy HtoD") else
                "d2h" if e.name.startswith("Memcpy DtoH") else
                "other" if e.name.startswith("Memcpy") or e.name.startswith("Memset") else
                "kernel")
        kinds[kind] += (end - start) / 1e3
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    return wall_ms, busy_us / 1e3, kinds


def phase6_breakdown(vcf: bytes, runs):
    """The host-clock split of phase 3's engine calls, then one profiled
    compress and decompress per route."""
    for route, run in runs.items():
        for call, seconds in run["layers"].items():
            if seconds is None:  # the parse route's call
                continue
            if not all(seconds.values()):
                raise SystemExit(f"phase 6: {route} {call} did not go through every layer: "
                                 f"{seconds}")
            print(f"phase 6: {route} {call} host clock (phase 3's run, "
                  f"{run[call + '_s']:.3f} s): "
                  + ", ".join(f"{layer} {s:.3f} s" for layer, s in seconds.items()))
        calls = [("decompress", lambda: engine.decompress(run["vcfc"]))]
        if run["compress_s"] is not None:
            calls.insert(0, ("compress", lambda: engine.compress(vcf)))
        with route_env(ROUTES[route][0]):
            for call, fn in calls:
                wall, busy, kinds = _device_busy(fn)
                if busy > wall:
                    raise SystemExit(f"phase 6: {route} {call} device busy {busy} ms exceeds "
                                     f"its wall {wall} ms")
                print(f"phase 6: {route} {call} profiled wall {wall:.3f} ms, device busy "
                      f"{busy:.3f} ms, device idle share {1 - busy / wall:.4f}; "
                      + ", ".join(f"{kind} {ms:.3f} ms" for kind, ms in kinds.items()))


def phase7_ablation(stats, int_rate):
    """The K1/K2 ablation on its own, the counts set to 0 just before it
    and read just after; returns the probes' rows of the "kernels" line."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t = time.perf_counter()
    result = kernel_ceiling.run("cuda")
    counts = {name: LAUNCHES[name] for name in PROBES}
    print(f"phase 7: kernel_ceiling in {time.perf_counter() - t:.1f} s; probe launches {counts}")
    for line in kernel_ceiling.table(result):
        print(f"phase 7: {line}")
    print(json.dumps({"kernel_ceiling": result}))
    if not all(counts.values()):
        raise SystemExit(f"phase 7: a probe did not launch in the ablation: {counts}")
    times, plain = result["times_ms"], result["plain_ms"]
    L, W = result["shape"]
    for name, (k, earlier) in {"rle_encode": ("K1 encode", "blocked encode 16"),
                               "rle_decode": ("K2 decode", "tile decode")}.items():
        probe = EARLIER_DESIGN[name][0]
        print(f"phase 7: {name} {L}x{W} in turns with {earlier}: {times[k]:.5f} ms against "
              f"{times[earlier]:.5f} ms ({times[k] / times[earlier]:.1%}); bound "
              f"{bound(name, L, W):.5f} ms by bytes, plain-op lines "
              f"{plain_ops_ms(name, L, W, int_rate):.5f} and "
              f"{plain_ops_ms(probe, L, W, int_rate):.5f} ms")
    rows = []
    for name, (_kernel, _plain, replaces, label, plain_label) in PROBES.items():
        if name in CELLS_PROBES:
            by_cells = {c: times[f"{label} {c}"] for c in PROBE_CELLS}
            best = min(by_cells, key=by_cells.get)
            print(f"phase 7: {name} by cells a thread: "
                  + ", ".join(f"{c}: {ms:.5f} ms" for c, ms in by_cells.items())
                  + f"; the kernels line reports cells={best}")
            ms = by_cells[best]
        else:
            ms = times[label]
        rows.append(_kernel_row(name, PROBE_SOURCE, replaces, counts[name], stats,
                                result["shape"], ms, plain[plain_label]))
        if name in CELLS_PROBES:
            rows[-1]["cells"] = best
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    wall = time.perf_counter()
    vcf = phase1_build()
    rng = np.random.default_rng(SEED)
    stats = phase2_kernels(rng, vcf)
    runs = phase3_main_path(vcf)

    launches = {}  # a kernel on several routes reports its first route's count
    for route, (_env, kernels, _layers) in ROUTES.items():
        counts = runs[route]["counts"]
        if not all(counts[name] > 0 for name in kernels):
            raise SystemExit(f"phase 4: a kernel did not run on the {route}: {counts}")
        print(f"phase 4: {route}: " + ", ".join(f"{name} {counts[name]}" for name in kernels))
        for name in kernels:
            launches.setdefault(name, counts[name])
    print(f"phase 4: every kernel launched on its route: {launches}")

    int_rate = int32_ops_per_s()
    kernel_rows = phase5_times(vcf, stats, launches, int_rate)
    text_bytes = SAMPLES * LINES * 4  # "a|b\t" per genotype cell

    def rate(seconds):
        return None if seconds is None else text_bytes / seconds / 1e9

    print(json.dumps({"e2e": {
        "samples": SAMPLES, "lines": LINES, "vcf_bytes": len(vcf),
        "genotype_text_bytes": text_bytes, "routes": {
            route: {"vcfc_bytes": len(run["vcfc"]), "compress_s": run["compress_s"],
                    "decompress_s": run["decompress_s"],
                    "compress_genotype_GB_per_s": rate(run["compress_s"]),
                    "decompress_genotype_GB_per_s": rate(run["decompress_s"])}
            for route, run in runs.items()}}}))
    phase6_breakdown(vcf, runs)
    kernel_rows += phase7_ablation(stats, int_rate)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - wall:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
