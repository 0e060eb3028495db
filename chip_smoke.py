#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the .vcfc codec (vcfc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and make with g++.  It
builds the CUDA kernels and the native host library from this checkout,
then runs, in order, failing (non-zero exit) at the first phase that fails:

  1. the card's name and power limit; nvcc build of csrc/rle_kernels.cu
     (K1-K4); make of native/libvcfc_host.so; the 1000 Genomes phase 3
     sized cohort
  2. each kernel against its plain PyTorch version on the card, exact on
     every output element, at the engine's batch shapes and on edge cases
  3. both routes of the main path on the cohort: the parse route (K1/K2)
     and the VCFC_PARSE=device text route (K3/K4); each route's compress
     bytes equal to the native host executor's, its decompress restoring
     the input, and a CLI compress/decompress round trip of each route in a
     temporary directory
  4. each route's kernels' launch counts from its own phase 3 run above zero
  5. each kernel's time and its plain version's (CUDA events, median,
     inputs read from HBM) beside its bound, and the end-to-end seconds of
     both routes
  6. where the time goes, per route: host-clock seconds per layer from
     phase 3's calls, and device busy time from torch.profiler events on
     the CUDA device only
  7. one "kernels" JSON line (launches, mismatches, times, bounds), then a
     last line {"ok": true, "device": {...}}
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vcfc_tpu_torch import engine
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.format.vcf import parse_metadata_headers
from vcfc_tpu_torch.host import fast, native
from vcfc_tpu_torch.host.parse import parse_vcf_bytes
from vcfc_tpu_torch.ops._build import build
from vcfc_tpu_torch.ops.cuda_rle import (
    LAUNCHES,
    cuda_rle_decode,
    cuda_rle_encode,
    cuda_text_decode,
    cuda_text_encode,
)
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
TIMING_TRIALS = 15
LAUNCHES_PER_TRIAL = 20
SLEEP_CYCLES = 50_000_000  # ~25 ms: longer than enqueueing a trial's launches
# Timed launches cycle through copies of their input that together hold at
# least this many bytes, 4x the H100's 50 MB L2, so each launch reads its
# input from HBM and not from what the launch before left in L2.
ROTATE_BYTES = 200_000_000
SOURCE = "vcfc_tpu_torch/csrc/rle_kernels.cu"
KERNELS = {  # name -> (kernel, plain version, the TPU kernel it replaces)
    "rle_encode": (cuda_rle_encode, rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:181"),
    "rle_decode": (cuda_rle_decode, rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:234"),
    "text_encode": (cuda_text_encode, text_rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:265"),
    "text_decode": (cuda_text_decode, text_rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:292"),
}
# Bounds: bytes each kernel must move per cell (each input read once, each
# output written once) and per row (the int32 per-row outputs) over the
# H100's published 3.35 TB/s; and the integer operations per cell of its
# plain version (one per elementwise step over the plane) over the card's
# INT32 rate: 64 INT32 lanes per SM per clock (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper, Hopper SM) x the card's SMs x its maximum SM
# clock from nvidia-smi.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_SM_PER_CLOCK = 64
CLOCK_QUERY = ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"]
BOUND_TERMS = {  # name -> (bytes per cell, bytes per row, operations per cell)
    "rle_encode": (2, 4, 35),
    "rle_decode": (2, 4, 25),
    "text_encode": (5, 8, 59),
    "text_decode": (6, 4, 37),
}
VALID_WORDS = [b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t"]
ESCAPE_WORDS = [b"2|0\t", b"./.\t", b"0/1\t", b"9|9\t", b"1|2\t"]
ROUTES = {  # route -> VCFC_PARSE, its kernels, host-clock layers per engine call
    "parse route": (None, ("rle_encode", "rle_decode"), {
        "compress": {"parse": (engine, "parse_vcf_bytes"),
                     "device layer": (engine, "encode_on_device"),
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_on_device"),
                       "render": (fast, "assemble_vcf_native")}}),
    "text route": ("device", ("text_encode", "text_decode"), {
        "compress": {"index": (native, "index_lines"),
                     "gather": (native, "gather_text"),
                     "device layer": (engine, "encode_text_on_device"),
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_text_on_device"),
                       "render from text": (fast, "assemble_vcf_from_text")}}),
}


def phase1_build():
    card = subprocess.run(CARD_QUERY, check=True, capture_output=True, text=True)
    print(card.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    path = build("rle_kernels")
    print(f"phase 1: built {path.name} in {time.perf_counter() - t:.1f} s")
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


def _compare(kernel, plain, x, n):
    got, want = kernel(x, n), plain(x, n)
    torch.cuda.synchronize()
    mismatches = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    return mismatches, err, got


def phase2_kernels(rng, vcf):
    stats = {name: {"cases": 0, "mismatches": 0, "max_abs_err": 0} for name in KERNELS}

    def check(name, case, x, n):
        kernel, plain, _ = KERNELS[name]
        mism, err, got = _compare(kernel, plain, x, n)
        st = stats[name]
        st["cases"] += 1
        st["mismatches"] += mism
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if mism:
            print(f"phase 2: {name} {case}: {mism} mismatching elements")
        return got

    cases = encode_cases(rng)
    flag_cases = malformed_flag_cases(rng)
    decode_inputs = [(case, check("rle_encode", case, torch.from_numpy(codes).cuda(), n)[0], n)
                     for case, codes, n in cases]
    text_inputs = [(case, check("text_encode", case, torch.from_numpy(words).cuda(), n)[0], n)
                   for case, words, n in text_encode_cases(rng, vcf, cases)]
    del cases
    for case, flags, n in flag_cases:
        decode_inputs.append((case, torch.from_numpy(flags).cuda(), n))
        text_inputs.append((case, torch.from_numpy(flags).cuda(), n))
    for case, flags, n in decode_inputs:
        check("rle_decode", case, flags, n)
    for case, flags, n in text_inputs:
        check("text_decode", case, flags, n)
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
def parse_env(value):
    """VCFC_PARSE set to value (None: unset) inside, restored after."""
    saved = os.environ.pop("VCFC_PARSE", None)
    if value is not None:
        os.environ["VCFC_PARSE"] = value
    try:
        yield
    finally:
        os.environ.pop("VCFC_PARSE", None)
        if saved is not None:
            os.environ["VCFC_PARSE"] = saved


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


def _cli_round_trip(prefix: bytes, parse: str | None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    env.pop("VCFC_PARSE", None)
    if parse is not None:
        env["VCFC_PARSE"] = parse
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
    and read just after; returns {route: its run}."""
    reference = host_reference(vcf)
    cut = vcf.index(b"\n", vcf.index(b"\n#CHROM") + 1) + 1  # end of the header
    for _ in range(CLI_LINES):
        cut = vcf.index(b"\n", cut) + 1
    prefix = vcf[:cut]
    prefix_reference = host_reference(prefix)
    runs = {}
    for route, (parse, _kernels, layers) in ROUTES.items():
        with parse_env(parse):
            for name in LAUNCHES:
                LAUNCHES[name] = 0
            with layer_clock(layers["compress"]) as compress_layers:
                t = time.perf_counter()
                vcfc = engine.compress(vcf)
                compress_s = time.perf_counter() - t
            with layer_clock(layers["decompress"]) as decompress_layers:
                t = time.perf_counter()
                back = engine.decompress(vcfc)
                decompress_s = time.perf_counter() - t
            counts = dict(LAUNCHES)
        print(f"phase 3: {route}: compress {compress_s:.3f} s -> {len(vcfc):,} bytes; "
              f"decompress {decompress_s:.3f} s; launches {counts}")
        if vcfc != reference:
            raise SystemExit(f"phase 3: {route}: compress bytes differ from the native "
                             "host executor's")
        if back != vcf:
            raise SystemExit(f"phase 3: {route}: decompress does not restore the input")
        print(f"phase 3: {route}: compress == native host executor bytes; "
              "decompress restores the input")
        cli_vcfc, cli_back = _cli_round_trip(prefix, parse)
        if cli_vcfc != prefix_reference or cli_back != prefix:
            raise SystemExit(f"phase 3: {route}: CLI round trip differs")
        print(f"phase 3: {route}: CLI compress/decompress round trip ok ({CLI_LINES} lines)")
        runs[route] = {"vcfc": vcfc, "compress_s": compress_s, "decompress_s": decompress_s,
                       "counts": counts, "layers": {"compress": compress_layers,
                                                    "decompress": decompress_layers}}
    return runs


def _median_ms(fn, xs, n):
    """Median device time of one launch of fn.  Each trial queues
    LAUNCHES_PER_TRIAL launches behind a device-side sleep, so that the
    host's cost of enqueueing them stays out of the span the events time;
    the launches take the inputs xs in turn."""
    fn(xs[0], n)
    torch.cuda.synchronize()
    times = []
    launch = 0
    for _ in range(TIMING_TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(LAUNCHES_PER_TRIAL):
            fn(xs[launch % len(xs)], n)
            launch += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES_PER_TRIAL)
    return statistics.median(times)


def int32_ops_per_s() -> float:
    """The card's peak INT32 rate: lanes per SM per clock x SMs x max SM clock."""
    mhz = subprocess.run(CLOCK_QUERY, check=True, capture_output=True, text=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_PER_CLOCK * sms * float(mhz.split()[0]) * 1e6


def bound(name, L, W, int_ops_per_s):
    """(bound ms, what bounds it) for one launch on an (L, W) plane."""
    per_cell, per_row, ops = BOUND_TERMS[name]
    bytes_ms = (per_cell * L * W + per_row * L) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops * L * W / int_ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase5_times(vcf, stats, launches):
    L, W = TIMED_SHAPE
    codes = torch.from_numpy(parse_vcf_bytes(vcf).codes[:L]).cuda()
    codes = torch.nn.functional.pad(codes, (0, W - SAMPLES))
    text = torch.from_numpy(cohort_text_batch(vcf)).cuda()
    flags = rle_encode_plain(codes, SAMPLES)[0]
    inputs = {"rle_encode": codes, "rle_decode": flags, "text_encode": text, "text_decode": flags}
    int_rate = int32_ops_per_s()
    print(f"phase 5: INT32 rate {int_rate:.6e} ops/s "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs), "
          f"HBM {HBM_BYTES_PER_S:.3e} B/s")
    rows = []
    for name, (kernel, plain, replaces) in KERNELS.items():
        x = inputs[name]
        copies = -(-ROTATE_BYTES // x.nbytes)
        xs = [x.clone() for _ in range(copies)]
        warm_ms = _median_ms(kernel, [x], SAMPLES)
        ms = _median_ms(kernel, xs, SAMPLES)
        plain_ms = _median_ms(plain, xs, SAMPLES)
        del xs
        bound_ms, bound_by = bound(name, L, W, int_rate)
        print(f"phase 5: {name} {L}x{W}: kernel {ms:.5f} ms (one input, L2-warm: "
              f"{warm_ms:.5f} ms), plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms by "
              f"{bound_by} (median of {TIMING_TRIALS} trials of {LAUNCHES_PER_TRIAL} launches, "
              f"cycling through {copies} copies of the input)")
        rows.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": stats[name]["max_abs_err"],
                     "mismatches": stats[name]["mismatches"], "shape": [L, W], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
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
            if not all(seconds.values()):
                raise SystemExit(f"phase 6: {route} {call} did not go through every layer: "
                                 f"{seconds}")
            print(f"phase 6: {route} {call} host clock (phase 3's run, "
                  f"{run[call + '_s']:.3f} s): "
                  + ", ".join(f"{layer} {s:.3f} s" for layer, s in seconds.items()))
        with parse_env(ROUTES[route][0]):
            for call, fn in (("compress", lambda: engine.compress(vcf)),
                             ("decompress", lambda: engine.decompress(run["vcfc"]))):
                wall, busy, kinds = _device_busy(fn)
                if busy > wall:
                    raise SystemExit(f"phase 6: {route} {call} device busy {busy} ms exceeds "
                                     f"its wall {wall} ms")
                print(f"phase 6: {route} {call} profiled wall {wall:.3f} ms, device busy "
                      f"{busy:.3f} ms, device idle share {1 - busy / wall:.4f}; "
                      + ", ".join(f"{kind} {ms:.3f} ms" for kind, ms in kinds.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    wall = time.perf_counter()
    vcf = phase1_build()
    rng = np.random.default_rng(SEED)
    stats = phase2_kernels(rng, vcf)
    runs = phase3_main_path(vcf)

    launches = {}
    for route, (_parse, kernels, _layers) in ROUTES.items():
        counts = runs[route]["counts"]
        if not all(counts[name] > 0 for name in kernels):
            raise SystemExit(f"phase 4: a kernel did not run on the {route}: {counts}")
        launches.update((name, counts[name]) for name in kernels)
    print(f"phase 4: every kernel launched on its route: {launches}")

    kernel_rows = phase5_times(vcf, stats, launches)
    text_bytes = SAMPLES * LINES * 4  # "a|b\t" per genotype cell
    print(json.dumps({"e2e": {
        "samples": SAMPLES, "lines": LINES, "vcf_bytes": len(vcf),
        "genotype_text_bytes": text_bytes, "routes": {
            route: {"vcfc_bytes": len(run["vcfc"]), "compress_s": run["compress_s"],
                    "decompress_s": run["decompress_s"],
                    "compress_genotype_GB_per_s": text_bytes / run["compress_s"] / 1e9,
                    "decompress_genotype_GB_per_s": text_bytes / run["decompress_s"] / 1e9}
            for route, run in runs.items()}}}))
    phase6_breakdown(vcf, runs)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - wall:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
