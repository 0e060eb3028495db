#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the .vcfc codec (vcfc_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --compact-ab    # and the A/B of VCFZ_COMPACT in 3c

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and make with g++.  It
builds the CUDA kernels and the native host library from this checkout,
then runs, in order, failing (non-zero exit) at the first phase that fails:

  1. the card's name and power limit; nvcc builds of csrc/rle_kernels.cu
     (K1-K4), csrc/probe_kernels.cu (the ablation probes C1-C7),
     csrc/huffman_kernels.cu (the .vcfz Huffman decode, H1) and
     csrc/compact_kernels.cu (the .vcfz row compaction, S1), all started
     together; make of native/libvcfc_host.so; the 1000 Genomes phase 3
     sized cohort, its .vcfc by the native host executor and its v1 .vcfz
     by the host writer
  2. each kernel against its plain PyTorch version on the card, exact on
     every output element, at the engine's batch shapes, on edge cases and
     on the group and round edges of eval.edge_cases (as text words for K3,
     K4, C6 and C7, with bad separators on those edges); C1 and C4 at every
     cells a thread, C4 against K1's outputs and C5 against K2's too, C6
     and C7 on K3's and K4's cases; H1 on eval.huffman_cases and on one
     decode dispatch of the cohort's v1 block payloads; S1 on seeded grids
     (densities 0 to 1, widths no chunk divides) and on that dispatch's
     plane masked to each stream's bits, values and counts
  3. the routes of the main path on the cohort, each call REPEATS times
     (median and min-max printed): the parse route (K1/K2), the
     VCFC_PARSE=device text route (K3/K4) and the VCFC_UNPACK=device
     decompress route (packed flags unpacked on the card, then K2); each
     route's compress bytes equal to the native host executor's, its
     decompress restoring the input, in every run, and a CLI
     compress/decompress round trip of each route in a temporary directory
  3b. the sharded path: engine.compress_sharded / decompress_sharded on
     the cohort over make_data_mesh() (every card) and over two shards on
     cuda:0, bytes equal to the native host executor's and compress's and
     the input restored; dryrun_multichip over both meshes; a CLI
     VCFC_SHARDED=1 round trip; and the encode, codebook and roundtrip
     steps' histograms against the plain CPU histograms of a cohort batch
  3c. the .vcfz path: engine.compress (K1) once, then for each version
     the device route encodes (1, 2, 3, 5, 8) the container written once by
     the host writer and by vcfz_from_vcfc(route="device") under
     torch.profiler once under each VCFZ_COMPACT setting (device, the
     default on the card, then host), each byte-identical, the device
     counter moved by one and S1's launches moved under device only; each container decompressed by
     decompress_vcfz (K2) back to the input and one region through
     query_vcfz equal to a full scan of the input; the bytes, the walls,
     the device busy time, the copies (count, bytes and ms by kind, from
     the profile's trace), the top device operations and the device time
     of the ported ops printed per run; then each container
     decompress_vcfz(route="device") decodes (1, 5, 8) decoded so under
     each setting too, under torch.profiler (H1, S1 under device, then
     K2), back to the input, the decode counter moved by one, with the
     host clock of the entropy decode's steps; v2/v3 through the same call
     to the host decode, the counter unmoved; with --compact-ab, each
     device route again in turns under VCFZ_COMPACT=host, device, device,
     host with neither profiler nor clock around it, each checked, and
     the ratio of the settings' mean walls per version; then a CLI compress-z (VCFZ_PACK=device) / decompress-z
     / query-z round trip, and a v8 compress-z / decompress-z round trip
     both under VCFZ_PACK=device
  4. each path's kernels' launch counts from its own run (phase 3's
     routes, phase 3b's codec and dry run, phase 3c's .vcfz path) above zero
  5. each kernel's time and its plain version's (CUDA events, median,
     inputs read from HBM) beside its bound (the bytes it must move at the
     card's memory rate) and its plain-op line (its plain version's
     elementwise steps at the card's INT32 rate), K1-K4 in turns with
     their earlier tile designs C4 (16 cells), C5, C6 and C7 and beside a
     device copy of their input plane, with their registers, local memory
     and resident blocks; H1 on the cohort's v1 decode dispatch; and the
     end-to-end seconds of the routes; S1 on the cohort's masked v1 decode
     plane beside its plain version and the JAX package's formulation, a
     stable torch.sort and a gather (library_ms)
  6. where the time goes, per route: host-clock seconds per layer from
     phase 3's median run, and device busy time from torch.profiler events
     on the CUDA device only (with the batches overlapped, a device
     layer's host clock holds its staging and its waits on the card; the
     device busy time is the yardstick); then each call in turns with the
     engine's staging slots and with one slot, the control of the overlap
  7. the K1/K2 ablation (vcfc_tpu_torch.eval.kernel_ceiling) at 8192 x
     2560, K1 and K2 again in turns with C4 and C5, its probes' launch
     counts from that run above zero, and its table
  8. one "kernels" JSON line (launches summed over the paths and by path,
     mismatches, times, bounds), then a last line
     {"ok": true, "device": {...}}
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
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
from vcfc_tpu_torch.eval.huffman_cases import decode_cases
from vcfc_tpu_torch.eval.edge_cases import (
    ESCAPE_WORDS,
    VALID_WORDS,
    encode_edge_cases,
    flag_edge_cases,
    separator_edge_cases,
)
from vcfc_tpu_torch.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu_torch.eval.timing import LAUNCHES_PER_TRIAL, TRIALS, in_turns, median_ms, rotated
from vcfc_tpu_torch.format import vcfz
from vcfc_tpu_torch.format.vcf import parse_metadata_headers
from vcfc_tpu_torch.format import vcfz_device as vcfz_route
from vcfc_tpu_torch.format.vcfz_device import DECODE_VERSIONS, DECODES, DEVICE_VERSIONS, ENCODES
from vcfc_tpu_torch.host import fast, native
from vcfc_tpu_torch.host.parse import parse_vcf_bytes
from vcfc_tpu_torch.ops._build import build
from vcfc_tpu_torch.ops.cuda_compact import LAUNCHES as COMPACT_LAUNCHES, cuda_sort_compact
from vcfc_tpu_torch.ops.cuda_huffman import LAUNCHES as HUFFMAN_LAUNCHES, cuda_decode_bits
from vcfc_tpu_torch.ops.cuda_rle import (
    LAUNCHES,
    PROBE_CELLS,
    cuda_probe_blocked_encode,
    cuda_probe_roundtrip,
    cuda_probe_scan_only,
    cuda_probe_scan_replaced,
    cuda_probe_tile_decode,
    cuda_probe_tile_text_decode,
    cuda_probe_tile_text_encode,
    cuda_rle_decode,
    cuda_rle_encode,
    cuda_text_decode,
    cuda_text_encode,
    kernel_info,
)
from vcfc_tpu_torch.ops.histogram import ctx_flag_histogram, masked_code_histogram
from vcfc_tpu_torch.ops import huffman_device, vcfz_device
from vcfc_tpu_torch.ops.huffman_device import (
    _MAX_DISPATCH_BITS,
    _split_grid,
    decode_bits_plain,
    device_decode_tables,
    stream_words,
)
from vcfc_tpu_torch.ops.probe import roundtrip_plain, scan_only_plain, scan_replaced_plain
from vcfc_tpu_torch.ops.rle import (
    rle_decode_plain,
    rle_encode_plain,
    text_rle_decode_plain,
    text_rle_encode_plain,
)
from vcfc_tpu_torch.ops.vcfz_device import sort_compact_plain
from vcfc_tpu_torch.parallel.dryrun import dryrun_multichip
from vcfc_tpu_torch.parallel.mesh import make_data_mesh
from vcfc_tpu_torch.parallel.shard import (
    make_sharded_codebook_step,
    make_sharded_encode_step,
    make_sharded_roundtrip_step,
)
from vcfc_tpu_torch.query.coordinate import compute_end_position, parse_coordinate_string

REPO = Path(__file__).resolve().parent
# The cohort: 1000 Genomes phase 3 has 2,504 samples.
SAMPLES = 2504
LINES = 65536
SEED = 5
CLI_LINES = 8192  # the CLI round trips run on this prefix of the cohort
REPEATS = 5  # phase 3 runs each route's calls this many times
SHARDED_REPEATS = 3  # phase 3b runs the sharded codec this many times a mesh
CONTROL_TURNS = 3  # phase 6 runs each call this many times with and without overlap
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
TIMED_SHAPE = (2048, 2560)  # one engine batch of the cohort
SOURCE = "vcfc_tpu_torch/csrc/rle_kernels.cu"
PROBE_SOURCE = "vcfc_tpu_torch/csrc/probe_kernels.cu"
HUFFMAN_SOURCE = "vcfc_tpu_torch/csrc/huffman_kernels.cu"
COMPACT_SOURCE = "vcfc_tpu_torch/csrc/compact_kernels.cu"
SOURCES = ("rle_kernels", "probe_kernels", "huffman_kernels", "compact_kernels")  # phase 1
KERNELS = {  # name -> (kernel, plain version, the TPU kernel it replaces)
    "rle_encode": (cuda_rle_encode, rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:181"),
    "rle_decode": (cuda_rle_decode, rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:234"),
    "text_encode": (cuda_text_encode, text_rle_encode_plain, "vcfc_tpu/ops/pallas_rle.py:265"),
    "text_decode": (cuda_text_decode, text_rle_decode_plain, "vcfc_tpu/ops/pallas_rle.py:292"),
}
# The ablation's probes: name -> (kernel, plain version, the TPU kernel it
# replaces, its row in kernel_ceiling's times, its plain version's row); C1
# and C4 take cells= and report their best cells.
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
# C6 and C7, the tile designs of K3 and K4, outside the ablation: name ->
# (kernel, plain version, the TPU kernel it replaces); phase 5 times them
# beside K3 and K4 and gives them their rows of the "kernels" line.
TEXT_PROBES = {
    "probe_tile_text_encode": (cuda_probe_tile_text_encode, text_rle_encode_plain,
                               "vcfc_tpu/ops/pallas_rle.py:265"),
    "probe_tile_text_decode": (cuda_probe_tile_text_decode, text_rle_decode_plain,
                               "vcfc_tpu/ops/pallas_rle.py:292"),
}
# H1, the .vcfz device decode: name -> (kernel, plain version, the JAX
# function it replaces: XLA's three scans, not a Pallas kernel).  It takes
# (words, limits, idx_adjust, s1=, s2=) and times on a (streams, words) plane.
DECODE_KERNELS = {
    "huffman_decode_bits": (cuda_decode_bits, decode_bits_plain,
                            "vcfc_tpu/ops/huffman_device.py:120"),
}
# S1, the .vcfz row compaction: name -> (kernel, plain version, the JAX
# function it replaces: XLA's stable sort, not a Pallas kernel).  It takes
# (values, mask) and times on the cohort's masked v1 decode plane.
COMPACT_KERNELS = {
    "sort_compact": (cuda_sort_compact, sort_compact_plain,
                     "vcfc_tpu/ops/vcfz_device.py:356"),
}
# every kernel held to its plain version: name -> (kernel, plain version,
# the TPU kernel it replaces)
CHECKED = {**KERNELS, **{name: probe[:3] for name, probe in PROBES.items()}, **TEXT_PROBES,
           **DECODE_KERNELS, **COMPACT_KERNELS}
# K1-K4 beside their earlier tile designs, timed in turns: kernel ->
# (probe, its cells= or None)
EARLIER_DESIGN = {"rle_encode": ("probe_blocked_encode", 16),
                  "rle_decode": ("probe_tile_decode", None),
                  "text_encode": ("probe_tile_text_encode", None),
                  "text_decode": ("probe_tile_text_decode", None)}
CELLS_PROBES = ("probe_scan_only", "probe_blocked_encode")
# The bound, the least time the card could take: the bytes each kernel must
# move per cell (each input read once, each output written once) and per
# row (the int32 per-row outputs) over the H100's published 3.35 TB/s.
# Every kernel is bound by bytes, so each row of the "kernels" line says
# bound_by "bytes".  H1's cell is a word of a stream: the word read (4
# bytes) and its 32 int32 plane entries written (128 bytes).  S1's cell is
# a cell of a row: its int32 value read and written and its mask byte read
# (9 bytes), and a row's int32 count written (4 bytes).
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
    "probe_tile_text_encode": (5, 8),
    "probe_tile_text_decode": (6, 4),
    "huffman_decode_bits": (132, 0),
    "sort_compact": (9, 4),
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
# version is K1's then K2's, 35 + 25; C4's is K1's, C5's K2's, C6's K3's
# and C7's K4's.  H1's plain version per word: per bit the window's 3
# (shift, mask, cast), 104 in _lens_and_syms (14 x compare, cast, add; 15 x
# shift, add, eq, where; the two fills), pass A's 4 on each of 15 states
# and 1 on the length (61), pass C's 6 and the output's 3, 177 a bit, 5,664
# a word, and the word's own 5 (widen, mask, shifted copy, shift, or):
# 5,669.  Pass B's 77 a segment (under 2 a word at s2 = 2,048) are left out.
# S1's plain version per cell: the mask cast, the cumsum, c - 1, count + i,
# - c, the where and the scatter, 7 (the count's cast a row left out).
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
    "probe_tile_text_encode": 59,
    "probe_tile_text_decode": 37,
    "huffman_decode_bits": 5669,
    "sort_compact": 7,
}
ROUTE_ENV = ("VCFC_PARSE", "VCFC_UNPACK", "VCFC_SHARDED", "VCFZ_PACK", "VCFZ_COMPACT")
# route -> its environment, its kernels, host-clock layers per engine call
# (None: the call is the parse route's, which the route does not change).
# A device layer's clock runs from its first staged batch to its last
# fetched one: with the batches overlapped, it holds the host's staging
# (timed on its own too; the text route's holds the gathers), its copies
# out of the pinned buffers and its waits on the card.
STAGING = (engine, "_stage")  # fills a batch's staging buffers, inside a device layer
ROUTES = {
    "parse route": ({}, ("rle_encode", "rle_decode"), {
        "compress": {"parse": (engine, "parse_vcf_bytes"),
                     "device layer": (engine, "encode_on_device"),
                     "staging in it": STAGING,
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_on_device"),
                       "staging in it": STAGING,
                       "render": (fast, "assemble_vcf_native")}}),
    "text route": ({"VCFC_PARSE": "device"}, ("text_encode", "text_decode"), {
        "compress": {"index": (native, "index_lines"),
                     "device layer": (engine, "encode_text_on_device"),
                     "staging in it": STAGING,
                     "gather in the staging": (native, "gather_text"),
                     "assembly": (fast, "assemble_vcfc_native")},
        "decompress": {"parse": (fast, "parse_vcfc_native"),
                       "device layer": (engine, "decode_text_on_device"),
                       "staging in it": STAGING,
                       "render from text": (fast, "assemble_vcf_from_text")}}),
    "unpack route": ({"VCFC_UNPACK": "device"}, ("rle_decode",), {
        "compress": None,
        "decompress": {"packed parse": (fast, "parse_vcfc_packed_native"),
                       "device layer": (engine, "unpack_decode_on_device"),
                       "staging in it": STAGING,
                       "render": (fast, "assemble_vcf_native")}}),
}

# The sharded path (phase 3b): its meshes, and its kernels (K1 and K2 in
# the codec, K1-K4 in the dry run).
SHARDED_KERNELS = ("rle_encode", "rle_decode", "text_encode", "text_decode")

# The .vcfz path (phase 3c): the versions its device route encodes and
# decodes, the kernels the path launches (K1 in engine.compress, K2 in
# decompress_vcfz, H1 in the device decode; its three CUDA kernels, the
# passes, are attributed by name in the profile),
# the PyTorch ops of ops.vcfz_device whose device time the profile
# attributes (each call wrapped in a record_function of its name; ctx_plane
# also runs inside pack_cells where the pack has four contexts, v2 and v3,
# and is part of its time there), and the query-z region: the CHROM and
# POS of the middle line of the CLI prefix, to VCFZ_REGION_SPAN bases on.
VCFZ_VERSIONS = DEVICE_VERSIONS
VCFZ_DECODE_VERSIONS = DECODE_VERSIONS
VCFZ_KERNELS = ("rle_encode", "rle_decode", "huffman_decode_bits", "sort_compact")
HUFFMAN_PASSES = ("huffman_segment_maps", "huffman_chain", "huffman_emit")
COMPACT_PASSES = ("compact_count", "compact_scan", "compact_write")  # S1's kernels
# The on-device compaction: the device routes run profiled once under each
# VCFZ_COMPACT setting (the card's default first); with --compact-ab, its
# A/B runs them again in these turns, a version at a time, unprofiled.
COMPACT_SETTINGS = ("device", "host")
COMPACT_TURNS = ("host", "device", "device", "host")
COMPACT_AB_FLAG = "--compact-ab"
# host-clock layers of decompress_vcfz: the host route's (the native Huffman
# decode runs inside the line assembly) and the device route's, whose
# entropy decode is split into the steps of each dispatch
# (ops.huffman_device.device_unpack_symbols); the steps of SYNCED_LAYERS
# leave work queued on the card, so their clock stops only once the card is
# done (the steps run one after another, so this moves the waits, not the
# work).  The compaction runs under VCFZ_COMPACT=device only.
HOST_DECODE_LAYERS = {"line assembly": (vcfz.VcfzReader, "block_lines_vcfc"),
                      "engine.decompress": (engine, "decompress")}
DEVICE_DECODE_LAYERS = {"words build": (huffman_device, "stream_words"),
                        "H2D": (huffman_device, "_upload"),
                        "H1 and its wait": (huffman_device, "decode_bits"),
                        "compaction and counts": (huffman_device, "_compact_rows"),
                        "D2H": (huffman_device, "_download"),
                        "gate and map": (huffman_device, "_rows_to_symbols"),
                        "context merge": (vcfz_route, "_merge_ctx_streams"),
                        **HOST_DECODE_LAYERS}
SYNCED_LAYERS = ("H2D", "H1 and its wait", "compaction and counts")
ENTROPY_STEPS = ("words build", "H2D", "H1 and its wait", "compaction and counts", "D2H",
                 "gate and map")
VCFZ_CLI_VERSION = 8  # the version of the CLI's device decode round trip
VCFZ_OPS = ("sympos_v3", "ctx_plane", "pack_cells", "pack_cells_compact", "sort_compact",
            "esc_plane_device")
VCFZ_REGION_SPAN = 20_000
TOP_DEVICE_OPS = 5


def sharded_meshes():
    """name -> mesh: every visible card, and two shards on the first."""
    return {"make_data_mesh()": make_data_mesh(),
            "two shards on cuda:0": make_data_mesh(devices=("cuda:0",) * 2)}


def phase1_build():
    card = subprocess.run(CARD_QUERY, check=True, capture_output=True, text=True)
    print(card.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.get_num_threads()} intra-op threads, "
          f"{os.cpu_count()} CPUs")
    t = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, started together
        paths = list(pool.map(build, SOURCES))
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
    gather_text builds it, every K1 case as words, and separator (on group
    and round edges too), zero-row and arbitrary-word edges."""
    out = [("cohort batch 2048x2560 (gather_text)", cohort_text_batch(vcf), SAMPLES)]
    out += [(name, _words(rng, codes, n), n) for name, codes, n in cases]
    bad = _words(rng, _cohort(rng, 256, 384, 300), 300)
    cols = rng.integers(0, 299, 64)
    bad[np.arange(64), cols] = (bad[np.arange(64), cols] & 0x00FFFFFF) | (ord("x") << 24)
    bad[64:128, 299] |= ord("x") << 24  # sample n - 1's separator is not checked
    bad[128:192, 300:] = rng.integers(-(1 << 31), 1 << 31, (64, 84), dtype=np.int64)  # padding
    out.append(("bad separators 256x384", bad, 300))
    out += separator_edge_cases()
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


def cohort_dispatch(v1: bytes):
    """The first decode dispatch of a v1 container's block payloads, as
    device_unpack_symbols builds it: (words (B, W) int32, limits,
    idx_adjust, s1, s2, the blocks in the container)."""
    reader = vcfz.VcfzReader.parse(v1)
    base = reader.payload_base
    payloads = [bytes(reader.raw[base + b["payload_off"] : base + b["payload_off"]
                                 + b["payload_len"]]) for b in reader.blocks]
    s1, s2 = _split_grid(max(len(p) for p in payloads) * 8)
    group = max(_MAX_DISPATCH_BITS // (s1 * s2), 1)
    limits, adjust, _ = device_decode_tables(reader.books[0])
    return stream_words(payloads[:group], s1, s2), limits, adjust, s1, s2, len(payloads)


def dispatch_bits(v1: bytes, streams: int) -> list[int]:
    """The bit lengths of the first ``streams`` block payloads of a v1
    container: the lengths the decode's compaction masks each row of the
    plane to."""
    reader = vcfz.VcfzReader.parse(v1)
    return [int(b["payload_len"]) * 8 for b in reader.blocks[:streams]]


def masked_plane(dispatch, nbits):
    """H1's plane of the dispatch on the card and its mask, as the decode's
    compaction gives them to S1: the start bits within each stream's bits."""
    words, limits, adjust, s1, s2, _blocks = dispatch
    plane = cuda_decode_bits(torch.from_numpy(words).cuda(), limits, adjust, s1=s1, s2=s2)
    cells = torch.arange(plane.shape[1], device=plane.device)[None, :]
    return plane, (plane != 0) & (cells < torch.tensor(nbits, device=plane.device)[:, None])


def compact_cases(rng):
    """(name, values, mask) for S1: int32 values over the whole range, masks
    at densities 0 to 1 with an empty row, a full row and a row masked on
    its last cell, at widths of one chunk, none and many."""
    cases = []
    for B, n in ((7, 4096), (5, 9000), (3, 140_000), (4, 1), (300, 257), (25, 655_361)):
        for density in (0.0, 0.18, 0.5, 1.0):
            values = rng.integers(-(1 << 31), 1 << 31, (B, n), dtype=np.int64).astype(np.int32)
            mask = rng.random((B, n)) < density
            mask[0] = False
            mask[1 % B] = True
            mask[2 % B, -1] = True
            cases.append((f"{B}x{n} density {density}", values, mask))
    return cases


def sort_compact_library(values, mask):
    """The JAX package's formulation of sort_compact in PyTorch calls, the
    yardstick of S1's library_ms (the port never calls it): a stable sort
    of each row keyed by the cell index where the mask is set and INT32_MAX
    elsewhere, a gather of the values by the sort's order, and the counts."""
    cells = torch.arange(values.shape[1], dtype=torch.int32, device=values.device)
    key = torch.where(mask, cells[None, :], torch.iinfo(torch.int32).max)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(values, 1, order), mask.sum(dim=1, dtype=torch.int32)


def _compare(got, want):
    torch.cuda.synchronize()
    mismatches = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    return mismatches, err


def phase2_kernels(rng, vcf, dispatch, nbits):
    stats = {name: {"cases": 0, "mismatches": 0, "max_abs_err": 0}
             for name in CHECKED}

    def check(name, case, x, n, cells=None, want=None):
        """The kernel against its plain version (or against want)."""
        kernel, plain = CHECKED[name][:2]
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
    text_inputs = []
    for case, words, n in text_encode_cases(rng, vcf, cases):
        x = torch.from_numpy(words).cuda()
        text_inputs.append((case, check("text_encode", case, x, n)[0], n))
        check("probe_tile_text_encode", case, x, n)
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
        check("probe_tile_text_decode", case, flags, n)
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
    words, limits, adjust, s1, s2, _blocks = dispatch
    cases = [(name, w, *device_decode_tables(book)[:2], c1, c2)
             for name, w, book, c1, c2 in decode_cases()]
    cases.append((f"cohort v1 dispatch {words.shape[0]}x{words.shape[1]} words (s1={s1}, "
                  f"s2={s2})", words, limits, adjust, s1, s2))
    kernel, plain = CHECKED["huffman_decode_bits"][:2]
    for case, w, lim, adj, c1, c2 in cases:
        x = torch.from_numpy(w).cuda()
        mism, err = _compare([kernel(x, lim, adj, s1=c1, s2=c2)],
                             [plain(x, lim, adj, s1=c1, s2=c2)])
        st = stats["huffman_decode_bits"]
        st["cases"] += 1
        st["mismatches"] += mism
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if mism:
            print(f"phase 2: huffman_decode_bits {case}: {mism} mismatching elements")
        del x
    plane, mask = masked_plane(dispatch, nbits)
    cases = [(name, torch.from_numpy(v).cuda(), torch.from_numpy(m).cuda())
             for name, v, m in compact_cases(rng)]
    cases.append((f"cohort v1 dispatch plane {plane.shape[0]}x{plane.shape[1]}, masked to "
                  "each stream's bits", plane, mask))
    kernel, plain = CHECKED["sort_compact"][:2]
    for case, v, m in cases:
        mism, err = _compare(kernel(v, m), plain(v, m))
        st = stats["sort_compact"]
        st["cases"] += 1
        st["mismatches"] += mism
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if mism:
            print(f"phase 2: sort_compact {case}: {mism} mismatching elements")
    del cases, plane, mask, v, m
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
def wrapping(targets, wrap):
    """Inside, each function mod.attr of targets ({name: (mod, attr)}) is
    replaced by wrap(name, the function); restored after."""
    saved = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}
    for name, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(name, saved[name]))
    try:
        yield
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, saved[name])


@contextlib.contextmanager
def batch_shapes(mod, attr):
    """Record the shape of the first argument of every call of mod.attr
    made inside."""
    shapes = []

    def spy(_name, fn):
        def run(*args, **kwargs):
            shapes.append(tuple(args[0].shape))
            return fn(*args, **kwargs)
        return run

    with wrapping({attr: (mod, attr)}, spy):
        yield shapes


@contextlib.contextmanager
def layer_clock(layers, synced=()):
    """Time, on the host clock, each layer the engine calls while inside:
    yields {layer: seconds}, summed over the layer's calls.  The clock of a
    layer in ``synced`` stops once the card has done what the layer queued
    (where CUDA is in use)."""
    seconds = dict.fromkeys(layers, 0.0)

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if name in synced and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                seconds[name] += time.perf_counter() - t
        return run

    with wrapping(layers, timed):
        yield seconds


def _cli(tmp: str, argv: list, route_vars: dict, phase: str) -> bytes:
    """One process of the port's CLI in tmp, with the route variables
    (ROUTE_ENV) of route_vars only; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    for var in ROUTE_ENV:
        env.pop(var, None)
    env.update(route_vars)
    r = subprocess.run([sys.executable, "-m", "vcfc_tpu_torch", *argv], cwd=tmp, env=env,
                       capture_output=True)
    if r.returncode:
        raise SystemExit(f"{phase}: CLI {argv[0]} failed ({r.returncode}):\n"
                         f"{r.stderr.decode(errors='replace')}")
    return r.stdout


def _cli_round_trip(prefix: bytes, route_vars: dict, phase: str = "phase 3"):
    with tempfile.TemporaryDirectory() as tmp:
        src, mid, out = (os.path.join(tmp, f) for f in ("in.vcf", "in.vcfc", "out.vcf"))
        with open(src, "wb") as f:
            f.write(prefix)
        _cli(tmp, ["compress", src, mid], route_vars, phase)
        _cli(tmp, ["decompress", mid, out], route_vars, phase)
        with open(mid, "rb") as f:
            cli_vcfc = f.read()
        with open(out, "rb") as f:
            return cli_vcfc, f.read()


def cli_prefix(vcf: bytes) -> bytes:
    """The header and the first CLI_LINES lines of the cohort."""
    cut = vcf.index(b"\n", vcf.index(b"\n#CHROM") + 1) + 1  # end of the header
    for _ in range(CLI_LINES):
        cut = vcf.index(b"\n", cut) + 1
    return vcf[:cut]


def spread(seconds) -> str:
    """'median s (min-max s, n runs)' of a list of seconds."""
    return (f"median {statistics.median(seconds):.3f} s ({min(seconds):.3f}-"
            f"{max(seconds):.3f} s, {len(seconds)} runs)")


def _timed_runs(call, layers, check):
    """REPEATS calls of call(), each checked by check(result) and timed on
    the host clock with its layers; returns (the first result, [seconds],
    the layers of the median run)."""
    seconds, split, first = [], [], None
    for _ in range(REPEATS):
        with layer_clock(layers) as clock:
            t = time.perf_counter()
            out = call()
            seconds.append(time.perf_counter() - t)
        check(out)
        split.append(clock)
        first = out if first is None else first
        del out
    median_run = sorted(range(REPEATS), key=seconds.__getitem__)[REPEATS // 2]
    return first, seconds, split[median_run]


def phase3_main_path(vcf: bytes, reference: bytes, prefix: bytes):
    """Each route REPEATS times on the cohort, the counts set to 0 just
    before the route and read just after; returns {route: its runs}.  A
    route whose compress is the parse route's decompresses the parse
    route's bytes."""
    prefix_reference = host_reference(prefix)
    runs = {}
    for route, (env, _kernels, layers) in ROUTES.items():

        def check_vcfc(vcfc):
            if vcfc != reference:
                raise SystemExit(f"phase 3: {route}: compress bytes differ from the native "
                                 "host executor's")

        def check_back(back):
            if back != vcf:
                raise SystemExit(f"phase 3: {route}: decompress does not restore the input")

        with route_env(env):
            for name in LAUNCHES:
                LAUNCHES[name] = 0
            if layers["compress"] is None:
                vcfc, compress_s, compress_layers = runs["parse route"]["vcfc"], None, None
            else:
                vcfc, compress_s, compress_layers = _timed_runs(
                    lambda: engine.compress(vcf), layers["compress"], check_vcfc)
            with batch_shapes(engine, "unpack_rle_decode") as packed_batches:
                _back, decompress_s, decompress_layers = _timed_runs(
                    lambda: engine.decompress(vcfc), layers["decompress"], check_back)
            del _back
            counts = dict(LAUNCHES)
        shown = "the parse route's" if compress_s is None else f"{spread(compress_s)} ->"
        print(f"phase 3: {route}: compress {shown} {len(vcfc):,} bytes; "
              f"decompress {spread(decompress_s)}; launches over the runs {counts}")
        print(f"phase 3: {route}: compress == native host executor bytes; "
              f"decompress restores the input, in every run")
        if packed_batches:
            rows, m = packed_batches[0]
            s_pad = -(-SAMPLES // 128) * 128
            batches = len(packed_batches) // REPEATS
            print(f"phase 3: {route}: packed width M = {m} against S_pad = {s_pad}; H2D per "
                  f"batch of {rows} lines {rows * (m + 4):,} bytes (flags + counts) against "
                  f"{rows * s_pad:,} for the positional plane ({batches} batches a call)")
        cli_vcfc, cli_back = _cli_round_trip(prefix, env)
        if cli_vcfc != prefix_reference or cli_back != prefix:
            raise SystemExit(f"phase 3: {route}: CLI round trip differs")
        print(f"phase 3: {route}: CLI compress/decompress round trip ok ({CLI_LINES} lines)")
        runs[route] = {"vcfc": vcfc, "compress_s": compress_s, "decompress_s": decompress_s,
                       "counts": counts, "layers": {"compress": compress_layers,
                                                    "decompress": decompress_layers}}
    return runs


def _check_step_histograms(name, mesh, codes):
    """Each shard step's histograms on the mesh against the plain CPU
    histograms of the same batch, exact."""
    n = SAMPLES
    x = torch.from_numpy(codes)
    want_hist = masked_code_histogram(x, n)
    flags = rle_encode_plain(x, n)[0]
    want_ctx = ctx_flag_histogram(flags, n)
    _f, _k, hist, offsets = make_sharded_encode_step(mesh, codes.shape[1])(codes, n)
    _f2, nseg, ctx_hist = make_sharded_codebook_step(mesh)(codes, n)
    _c, n_ok, hist2 = make_sharded_roundtrip_step(mesh)(codes, n)
    bad = [what for what, ok in (
        ("encode step histogram", torch.equal(hist, want_hist)),
        ("codebook step context histogram", torch.equal(ctx_hist, want_ctx)),
        ("roundtrip step histogram", torch.equal(hist2, want_hist)),
        ("roundtrip n_ok", int(n_ok) == len(mesh)),
        ("context histogram total", int(ctx_hist.sum()) == int(nseg.sum())),
        ("monotone offsets", bool((offsets.diff() >= 0).all()))) if not ok]
    if bad:
        raise SystemExit(f"phase 3b: {name}: {', '.join(bad)} disagree")
    print(f"phase 3b: {name}: the encode, codebook and roundtrip steps' histograms equal the "
          f"plain CPU histograms of a {codes.shape[0]}x{codes.shape[1]} cohort batch; "
          f"n_ok {int(n_ok)}, offsets {offsets.tolist()}")


def phase3b_sharded(vcf: bytes, reference: bytes, prefix: bytes, parse_vcfc: bytes):
    """The sharded path on the cohort over each mesh of sharded_meshes(),
    then the dry run, the counts set to 0 just before and read just after;
    then a CLI VCFC_SHARDED=1 round trip and the steps' histograms.
    Returns (the counts, {mesh: {compress_s, decompress_s}})."""
    meshes = sharded_meshes()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    times = {}
    for name, mesh in meshes.items():
        compress_s, decompress_s = [], []
        for _ in range(SHARDED_REPEATS):
            t = time.perf_counter()
            vcfc = engine.compress_sharded(vcf, mesh)
            compress_s.append(time.perf_counter() - t)
            if vcfc != reference or vcfc != parse_vcfc:
                raise SystemExit(f"phase 3b: {name}: compress_sharded bytes differ from the "
                                 "native host executor's or compress's")
            t = time.perf_counter()
            back = engine.decompress_sharded(vcfc, mesh)
            decompress_s.append(time.perf_counter() - t)
            if back != vcf:
                raise SystemExit(f"phase 3b: {name}: decompress_sharded does not restore the "
                                 "input")
            del vcfc, back
        times[name] = {"shards": len(mesh), "compress_s": compress_s,
                       "decompress_s": decompress_s}
        print(f"phase 3b: {name} ({len(mesh)} shards on {', '.join(map(str, mesh))}): "
              f"compress_sharded {spread(compress_s)}, decompress_sharded "
              f"{spread(decompress_s)}; bytes == native host executor's and compress's, the "
              f"input restored, in every run")
    for name, mesh in meshes.items():
        dryrun_multichip(len(mesh), devices=mesh)
        print(f"phase 3b: dryrun_multichip({len(mesh)}) over {name}: ok")
    counts = dict(LAUNCHES)
    print(f"phase 3b: launches over the sharded path {counts}")
    cli_vcfc, cli_back = _cli_round_trip(prefix, {"VCFC_SHARDED": "1"}, "phase 3b")
    if cli_vcfc != host_reference(prefix) or cli_back != prefix:
        raise SystemExit("phase 3b: CLI VCFC_SHARDED=1 round trip differs")
    print(f"phase 3b: CLI VCFC_SHARDED=1 compress/decompress round trip ok ({CLI_LINES} lines)")
    codes = np.zeros((2048, 2560), np.uint8)
    codes[:, :SAMPLES] = parse_vcf_bytes(prefix).codes[:2048]
    codes[-5:] = 0  # zero-padded rows, as a short last chunk has
    for name, mesh in meshes.items():
        _check_step_histograms(name, mesh, codes)
    return counts, times


def vcfz_region(prefix: bytes) -> str:
    """The query-z region: from the middle line of the CLI prefix, its CHROM
    and POS to POS + VCFZ_REGION_SPAN."""
    lines = prefix[parse_metadata_headers(prefix).data_offset :].split(b"\n")
    chrom, pos = lines[len(lines) // 2].split(b"\t", 2)[:2]
    return f"{chrom.decode()}:{int(pos)}-{int(pos) + VCFZ_REGION_SPAN}"


def full_scan(vcf: bytes, region: str) -> bytes:
    """The lines of a VCF that overlap region, SV-aware (query_vcfz's
    semantics), by a scan of every line of the text."""
    query = parse_coordinate_string(region)
    header = parse_metadata_headers(vcf)
    out = []
    for line in vcf[header.data_offset :].split(b"\n")[:-1]:
        cols = line.split(b"\t", 8)
        pos = int(cols[1])
        end = compute_end_position(pos, cols[3], cols[4], cols[7])
        if query.compare_to_range(cols[0].decode(), pos, end) == 0:
            out.append(line + b"\n")
    return b"".join(out)


def annotated(mod, labels):
    """Inside, each call of mod.name of labels ({name: label}) runs in a
    torch.profiler record_function of its label, so that the profile
    attributes its device time to it."""
    def wrap(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(labels[name]):
                return fn(*args, **kwargs)
        return run

    return wrapping({name: (mod, name) for name in labels}, wrap)


def _cli_vcfz_round_trip(prefix: bytes, region: str):
    """compress-z under VCFZ_PACK=device (the device route; K1 first), then
    decompress-z and query-z with VCFZ_PACK unset (the host decode); then
    compress-z of VCFZ_CLI_VERSION and decompress-z, both under
    VCFZ_PACK=device (the device encode and decode), each a CLI process in
    a temporary directory.  Returns (the container, the decompressed VCF,
    query-z's output, the VCFZ_CLI_VERSION container, its decompressed
    VCF)."""
    device = {"VCFZ_PACK": "device"}
    with tempfile.TemporaryDirectory() as tmp:
        src, mid, out, mid2, out2 = (os.path.join(tmp, f) for f in (
            "in.vcf", "in.vcfz", "out.vcf", "in2.vcfz", "out2.vcf"))
        with open(src, "wb") as f:
            f.write(prefix)
        _cli(tmp, ["compress-z", src, mid], device, "phase 3c")
        _cli(tmp, ["decompress-z", mid, out], {}, "phase 3c")
        queried = _cli(tmp, ["query-z", mid, region], {}, "phase 3c")
        _cli(tmp, ["compress-z", src, mid2, str(VCFZ_CLI_VERSION)], device, "phase 3c")
        _cli(tmp, ["decompress-z", mid2, out2], device, "phase 3c")
        outputs = []
        for path in (mid, out, mid2, out2):
            with open(path, "rb") as f:
                outputs.append(f.read())
        container, back, container2, back2 = outputs
        return container, back, queried, container2, back2


def _huffman_device_ms(by_name) -> dict:
    """H1's device ms in a profile, by pass (its three kernels, by name)."""
    return {p: sum(ms for name, ms in by_name.items() if p in name) for p in HUFFMAN_PASSES}


def _seconds(layers) -> str:
    return ", ".join(f"{layer} {s:.3f} s" for layer, s in layers.items())


def _compact_device_ms(by_name) -> float:
    """S1's device ms in a profile (its three kernels, by name)."""
    return sum(ms for name, ms in by_name.items() if any(p in name for p in COMPACT_PASSES))


def _d2h_text(copies) -> str:
    nbytes, ms = d2h(copies)
    shown = "bytes not measured" if nbytes is None else f"{nbytes:,} bytes"
    return f"D2H {shown} in {ms:.3f} ms"


def _device_encode(vcfc: bytes, version: int, host: bytes, setting: str, labels) -> dict:
    """vcfz_from_vcfc(route="device") under VCFZ_COMPACT=setting and
    torch.profiler: the host writer's bytes, ENCODES[version] moved by one,
    S1 launched under device and not under host."""
    out, copies = [], {}
    encodes, compacts = ENCODES[version], COMPACT_LAUNCHES["sort_compact"]
    with route_env({"VCFZ_COMPACT": setting}), annotated(vcfz_device, labels):
        wall, busy, kinds, by_name, op_ms = _device_busy(
            lambda: out.append(vcfz.vcfz_from_vcfc(vcfc, version=version, route="device")),
            labels=tuple(labels.values()), copies=copies)
    what = f"phase 3c: v{version}: device route, VCFZ_COMPACT={setting}"
    if out[0] != host:
        raise SystemExit(f"{what}: the bytes differ from the host writer's")
    if ENCODES[version] != encodes + 1:
        raise SystemExit(f"{what}: the route's counter did not move: it fell back to the host "
                         "writer")
    compacts = COMPACT_LAUNCHES["sort_compact"] - compacts
    if (compacts > 0) != (setting == "device"):
        raise SystemExit(f"{what}: sort_compact launched {compacts} times")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_DEVICE_OPS]
    ops = {name: op_ms[label] for name, label in labels.items()}
    print(f"{what}: {wall / 1e3:.3f} s (profiled), bytes equal, counter +1, sort_compact "
          f"{compacts} launches; device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f} ("
          + ", ".join(f"{kind} {ms:.3f}" for kind, ms in kinds.items())
          + f" ms); {_d2h_text(copies)}; copies: {_copies(copies)}; ops "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in ops.items())
          + " ms; top device ops: " + "; ".join(f"{name[:80]} {ms:.3f} ms" for name, ms in top))
    return {"wall_s": wall / 1e3, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kinds_ms": kinds, "d2h_bytes": d2h(copies)[0], "d2h_ms": d2h(copies)[1],
            "copies": copies, "ops_device_ms": ops, "top_device_ops_ms": dict(top),
            "sort_compact_launches": compacts}


def _host_decode(host: bytes, version: int, vcf: bytes) -> dict:
    """decompress_vcfz(route="device") of a context-coded container (v2,
    v3): the host decode, the input restored, no device decode counted."""
    before = (HUFFMAN_LAUNCHES["huffman_decode_bits"], COMPACT_LAUNCHES["sort_compact"])
    decoded = dict(DECODES)
    t = time.perf_counter()
    back = vcfz.decompress_vcfz(host, route="device")
    wall_s = time.perf_counter() - t
    if back != vcf:
        raise SystemExit(f"phase 3c: v{version}: decompress_vcfz(route='device') does not "
                         "restore the input")
    if DECODES != decoded or (HUFFMAN_LAUNCHES["huffman_decode_bits"],
                              COMPACT_LAUNCHES["sort_compact"]) != before:
        raise SystemExit(f"phase 3c: v{version}: the device decode ran on a context-coded "
                         f"container: {DECODES}")
    print(f"phase 3c: v{version}: decompress_vcfz(route='device') {wall_s:.3f} s takes the "
          f"host decode (a context-coded container), restores the input; the decode "
          f"counter did not move {dict(DECODES)}")
    return {"device_decode": "host", "device_decode_route_s": wall_s}


def _device_decode(host: bytes, version: int, vcf: bytes, setting: str) -> dict:
    """decompress_vcfz(route="device") of one container under
    VCFZ_COMPACT=setting and torch.profiler: the input restored,
    DECODES[version] moved by one, H1 launched, S1 launched under device
    and not under host; the host clock of its layers and of the entropy
    decode's steps."""
    before = (HUFFMAN_LAUNCHES["huffman_decode_bits"], COMPACT_LAUNCHES["sort_compact"])
    decoded = DECODES[version]
    back, copies = [], {}
    with route_env({"VCFZ_COMPACT": setting}), \
            layer_clock(DEVICE_DECODE_LAYERS, SYNCED_LAYERS) as layers:
        wall, busy, kinds, by_name, _ = _device_busy(
            lambda: back.append(vcfz.decompress_vcfz(host, route="device")), copies=copies)
    what = f"phase 3c: v{version}: decompress_vcfz(route='device'), VCFZ_COMPACT={setting}"
    if back[0] != vcf:
        raise SystemExit(f"{what}: does not restore the input")
    if DECODES[version] != decoded + 1:
        raise SystemExit(f"{what}: the decode's counter reads {DECODES[version]}, not "
                         f"{decoded + 1}")
    launches = HUFFMAN_LAUNCHES["huffman_decode_bits"] - before[0]
    compacts = COMPACT_LAUNCHES["sort_compact"] - before[1]
    if not launches or (compacts > 0) != (setting == "device"):
        raise SystemExit(f"{what}: huffman_decode_bits launched {launches} times, sort_compact "
                         f"{compacts}")
    passes = _huffman_device_ms(by_name)
    kernel_ms, compact_ms = sum(passes.values()), _compact_device_ms(by_name)
    entropy_s = sum(layers[step] for step in ENTROPY_STEPS)
    print(f"{what}: {wall / 1e3:.3f} s (profiled, layers clocked), restores the input, counter "
          f"+1; host clock: "
          f"entropy decode {entropy_s:.3f} s ({_seconds({k: layers[k] for k in ENTROPY_STEPS})}), "
          + _seconds({k: v for k, v in layers.items() if k not in ENTROPY_STEPS})
          + f"; device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f} ("
          + ", ".join(f"{kind} {ms:.3f}" for kind, ms in kinds.items())
          + f" ms); {_d2h_text(copies)}; copies: {_copies(copies)}; huffman_decode_bits "
          f"{launches} launches, {kernel_ms:.3f} ms on the device ("
          + ", ".join(f"{p} {ms:.3f}" for p, ms in passes.items())
          + f" ms); sort_compact {compacts} launches, {compact_ms:.3f} ms on the device")
    return {"wall_s": wall / 1e3, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kinds_ms": kinds, "d2h_bytes": d2h(copies)[0], "d2h_ms": d2h(copies)[1],
            "copies": copies, "layers_s": layers, "entropy_decode_s": entropy_s,
            "huffman_decode_bits_ms": kernel_ms, "huffman_decode_bits_passes_ms": passes,
            "huffman_decode_bits_launches": launches, "sort_compact_ms": compact_ms,
            "sort_compact_launches": compacts}


def decode_d2h_model(z: bytes) -> tuple:
    """The entropy decode's D2H bytes for container z on each branch, from
    its streams' bit lengths and symbol counts, dispatch by dispatch as
    device_unpack_symbols cuts them: (dense: B x s1*s2 x 4 a dispatch,
    compacted: B x kb x 4 + 4 B a dispatch, kb bucketed from the largest
    symbol count; the true kb takes the largest count of start bits, which
    may pass it by the few spurious starts of a stream's last byte)."""
    reader = vcfz.VcfzReader.parse(z)
    blocks = reader.blocks
    if reader.version == 8:
        calls = [([int(b["ctx_plen"][c]) for b in blocks], [int(b["ctx_nsym"][c]) for b in blocks])
                 for c in range(len(reader.books))]
    else:
        calls = [([int(b["payload_len"]) for b in blocks], [int(b["n_symbols"]) for b in blocks])]
    if reader.version >= 3:
        ends = [min((i + 1) * reader.block_lines, reader.n_lines) for i in range(len(blocks))]
        calls.append(([int(b["req_payload_len"]) for b in blocks],
                      [int(reader.req_starts[hi - 1]) + int(reader.req_lens[hi - 1])
                       - int(reader.req_starts[i * reader.block_lines])
                       for i, hi in enumerate(ends)]))
    dense = compacted = 0
    for lens, n_syms in calls:
        s1, s2 = _split_grid(max(lens) * 8)
        group = max(_MAX_DISPATCH_BITS // (s1 * s2), 1)
        for g0 in range(0, len(lens), group):
            B = len(lens[g0 : g0 + group])
            dense += B * s1 * s2 * 4
            compacted += B * vcfz_device._bucket(max(n_syms[g0 : g0 + group]), s1 * s2) * 4 + 4 * B
    return dense, compacted


def _unprofiled_wall(run, check, setting: str) -> float:
    """The wall in s of run() under VCFZ_COMPACT=setting, with neither
    profiler nor layer clock around it, the card idle at its start and its
    end; check(result) raises where the result is wrong, and S1 must
    launch under device only."""
    compacts = COMPACT_LAUNCHES["sort_compact"]
    with route_env({"VCFZ_COMPACT": setting}):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    check(out)
    if (COMPACT_LAUNCHES["sort_compact"] > compacts) != (setting == "device"):
        raise SystemExit(f"phase 3c: A/B under VCFZ_COMPACT={setting}: sort_compact launched "
                         f"{COMPACT_LAUNCHES['sort_compact'] - compacts} times")
    return wall


def _ab(run, check) -> dict:
    """The A/B of one route: {setting: [walls in s]} over COMPACT_TURNS,
    each from _unprofiled_wall, and the ratio of the settings' mean walls
    (device over host)."""
    walls = {setting: [] for setting in COMPACT_SETTINGS}
    for setting in COMPACT_TURNS:
        walls[setting].append(_unprofiled_wall(run, check, setting))
    return {"walls_s": walls,
            "device_over_host": statistics.mean(walls["device"]) / statistics.mean(walls["host"])}


def _ab_text(ab) -> str:
    return (f"device {', '.join(f'{w:.3f}' for w in ab['walls_s']['device'])} s against host "
            f"{', '.join(f'{w:.3f}' for w in ab['walls_s']['host'])} s (ratio of the means "
            f"{ab['device_over_host']:.3f})")


def _check_equal(want: bytes, what: str):
    def check(got):
        if got != want:
            raise SystemExit(f"phase 3c: {what}: A/B run differs")
    return check


def phase3c_vcfz(vcf: bytes, reference: bytes, prefix: bytes, compact_ab: bool = False):
    """The .vcfz path on the cohort, the counts set to 0 just before and
    read just after (with compact_ab, the A/B's runs in it); then the CLI
    round trips.  Returns (the counts, {version: its numbers})."""
    card = subprocess.run(CARD_QUERY, check=True, capture_output=True, text=True).stdout.strip()
    region = vcfz_region(prefix)
    want_region = full_scan(vcf, region)
    region_lines = want_region.count(b"\n")
    labels = {name: f"ops.vcfz_device.{name}" for name in VCFZ_OPS}
    start = time.perf_counter()
    for counts in (LAUNCHES, HUFFMAN_LAUNCHES, COMPACT_LAUNCHES, ENCODES, DECODES):
        for name in counts:
            counts[name] = 0
    t = time.perf_counter()
    vcfc = engine.compress(vcf)
    compress_s = time.perf_counter() - t
    if vcfc != reference:
        raise SystemExit("phase 3c: engine.compress bytes differ from the native host executor's")
    print(f"phase 3c: {card}; engine.compress {compress_s:.3f} s -> {len(vcfc):,} bytes of "
          f".vcfc; query-z region {region} ({region_lines} lines in a full scan); the device "
          f"routes profiled under VCFZ_COMPACT={', '.join(COMPACT_SETTINGS)}"
          + (f", then unprofiled in turns under {', '.join(COMPACT_TURNS)}" if compact_ab else ""))
    runs_a_version = len(COMPACT_SETTINGS) + (len(COMPACT_TURNS) if compact_ab else 0)
    results = {}
    for version in VCFZ_VERSIONS:
        t = time.perf_counter()
        host = vcfz.vcfz_from_vcfc(vcfc, version=version)
        host_s = time.perf_counter() - t
        print(f"phase 3c: v{version}: {len(host):,} bytes; host writer {host_s:.3f} s")
        encode = {setting: _device_encode(vcfc, version, host, setting, labels)
                  for setting in COMPACT_SETTINGS}
        with layer_clock(HOST_DECODE_LAYERS) as decompress_layers:
            t = time.perf_counter()
            back = vcfz.decompress_vcfz(host)
            decompress_s = time.perf_counter() - t
        if back != vcf:
            raise SystemExit(f"phase 3c: v{version}: decompress_vcfz does not restore the input")
        del back
        t = time.perf_counter()
        got_region = b"".join(vcfz.query_vcfz(host, parse_coordinate_string(region)))
        query_s = time.perf_counter() - t
        if got_region != want_region:
            raise SystemExit(f"phase 3c: v{version}: query_vcfz {region} differs from the full "
                             "scan")
        print(f"phase 3c: v{version}: decompress_vcfz {decompress_s:.3f} s "
              f"({_seconds(decompress_layers)}) restores the input; query_vcfz {query_s:.3f} s "
              "equals the full scan")
        results[version] = {
            "vcfz_bytes": len(host), "host_writer_s": host_s, "device_encode": encode,
            "decompress_vcfz_s": decompress_s, "decompress_vcfz_layers_s": decompress_layers,
            "query_vcfz_s": query_s}
        if compact_ab:
            results[version]["encode_ab"] = _ab(
                lambda: vcfz.vcfz_from_vcfc(vcfc, version=version, route="device"),
                _check_equal(host, f"v{version} encode"))
            print(f"phase 3c: v{version}: A/B of VCFZ_COMPACT, the encode "
                  f"{_ab_text(results[version]['encode_ab'])} against the host writer's "
                  f"{host_s:.3f} s")
        if version in VCFZ_DECODE_VERSIONS:
            dense, compacted = decode_d2h_model(host)
            print(f"phase 3c: v{version}: the entropy decode's D2H by its streams' bits and "
                  f"symbols: dense {dense:,} bytes, compacted {compacted:,} bytes "
                  f"({compacted / dense:.4f}); engine.decompress after it brings back the same "
                  "on both")
            decode = {setting: _device_decode(host, version, vcf, setting)
                      for setting in COMPACT_SETTINGS}
            results[version].update(device_decode=decode, entropy_d2h_model_bytes={
                "host": dense, "device": compacted})
            if compact_ab:
                results[version]["decode_ab"] = _ab(
                    lambda: vcfz.decompress_vcfz(host, route="device"),
                    _check_equal(vcf, f"v{version} decode"))
                print(f"phase 3c: v{version}: A/B of VCFZ_COMPACT, the decode "
                      f"{_ab_text(results[version]['decode_ab'])} against the host route's "
                      f"{decompress_s:.3f} s")
        else:
            results[version].update(_host_decode(host, version, vcf))
        del host
    counts = {**LAUNCHES, **HUFFMAN_LAUNCHES, **COMPACT_LAUNCHES}
    if any(ENCODES[v] != runs_a_version for v in VCFZ_VERSIONS) or any(
            DECODES[v] != runs_a_version for v in VCFZ_DECODE_VERSIONS):
        raise SystemExit(f"phase 3c: device encodes {dict(ENCODES)}, decodes {dict(DECODES)}: "
                         f"not {runs_a_version} a version")
    print(f"phase 3c: launches over the .vcfz path {counts}; device encodes {dict(ENCODES)}; "
          f"device decodes {dict(DECODES)}")
    container, back, queried, container2, back2 = _cli_vcfz_round_trip(prefix, region)
    queried_lines = queried.count(b"\n")
    prefix_vcfc = host_reference(prefix)
    if (container != vcfz.vcfz_from_vcfc(prefix_vcfc) or back != prefix
            or queried != full_scan(prefix, region)):
        raise SystemExit("phase 3c: CLI compress-z / decompress-z / query-z round trip differs")
    if container2 != vcfz.vcfz_from_vcfc(prefix_vcfc, version=VCFZ_CLI_VERSION) or back2 != prefix:
        raise SystemExit(f"phase 3c: CLI v{VCFZ_CLI_VERSION} compress-z / decompress-z round trip "
                         "under VCFZ_PACK=device differs")
    print(f"phase 3c: CLI compress-z (VCFZ_PACK=device) / decompress-z / query-z round trip ok "
          f"({CLI_LINES} lines, {len(container):,} bytes, {queried_lines} lines queried); "
          f"v{VCFZ_CLI_VERSION} compress-z / decompress-z under VCFZ_PACK=device ok "
          f"({len(container2):,} bytes); phase 3c in {time.perf_counter() - start:.1f} s")
    return counts, results


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


def phase5_huffman(dispatch, stats, launches, int_rate):
    """H1 on the cohort's v1 decode dispatch, beside its plain version on
    the card (a few calls: each is some ten thousand launches); returns its
    row of the "kernels" line."""
    words, limits, adjust, s1, s2, blocks = dispatch
    B, W = words.shape
    x = torch.from_numpy(words).cuda()
    xs = rotated(x)
    ms = median_ms(lambda w, _n: cuda_decode_bits(w, limits, adjust, s1=s1, s2=s2), xs, 0)
    plain_ms = median_ms(lambda w, _n: decode_bits_plain(w, limits, adjust, s1=s1, s2=s2),
                         xs, 0, trials=3, launches=1)
    row = _kernel_row("huffman_decode_bits", HUFFMAN_SOURCE, DECODE_KERNELS[
        "huffman_decode_bits"][2], launches["huffman_decode_bits"], stats, (B, W), ms, plain_ms)
    print(f"phase 5: huffman_decode_bits on the cohort's v1 decode dispatch ({B} of its {blocks} "
          f"block payloads, {W} words = s1 {s1} x s2 {s2} bits each): kernel {ms:.5f} ms (median "
          f"of {TRIALS} trials of {LAUNCHES_PER_TRIAL} launches, cycling through {len(xs)} copies "
          f"of the words), plain {plain_ms:.5f} ms (median of 3 calls), bound "
          f"{row['bound_ms']:.5f} ms by bytes ({row['bound_ms'] / ms:.1%} of the kernel's time), "
          f"plain-op line {plain_ops_ms('huffman_decode_bits', B, W, int_rate):.5f} ms")
    return row


def phase5_compact(dispatch, nbits, stats, launches, int_rate):
    """S1 on the cohort's masked v1 decode plane, beside its plain version
    and the JAX package's formulation (a stable sort and a gather, timed as
    library_ms); returns its row of the "kernels" line."""
    plane, mask = masked_plane(dispatch, nbits)
    B, n = plane.shape
    kernel = COMPACT_KERNELS["sort_compact"][0]
    got = kernel(plane, mask)
    library = sort_compact_library(plane, mask)
    if not (torch.equal(got[0], library[0]) and torch.equal(got[1], library[1])):
        raise SystemExit("phase 5: sort_compact and its library formulation disagree")
    del got, library
    xs = [(plane, mask)]  # 335 MB a launch: past the L2 on every launch
    ms = median_ms(lambda pm, _n: kernel(*pm), xs, 0)
    plain_ms = median_ms(lambda pm, _n: sort_compact_plain(*pm), xs, 0)
    library_ms = median_ms(lambda pm, _n: sort_compact_library(*pm), xs, 0, trials=5, launches=5)
    row = _kernel_row("sort_compact", COMPACT_SOURCE, COMPACT_KERNELS["sort_compact"][2],
                      launches["sort_compact"], stats, (B, n), ms, plain_ms)
    row["library_ms"] = library_ms
    masked = int(mask.sum())
    print(f"phase 5: sort_compact on the cohort's v1 decode plane ({B} x {n} cells, {masked:,} "
          f"masked, {masked / (B * n):.4f} of them): kernel {ms:.5f} ms (median of {TRIALS} "
          f"trials of {LAUNCHES_PER_TRIAL} launches), plain {plain_ms:.5f} ms, library (stable "
          f"torch.sort and a gather) {library_ms:.5f} ms (median of 5 trials of 5 calls), bound "
          f"{row['bound_ms']:.5f} ms by bytes ({row['bound_ms'] / ms:.1%} of the kernel's time), "
          f"plain-op line {plain_ops_ms('sort_compact', B, n, int_rate):.5f} ms")
    return row


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
    # C6 and C7 get their rows here, with their launches from this phase
    for probe in TEXT_PROBES:
        LAUNCHES[probe] = 0
    rows, probe_rows = [], {}
    for name, (kernel, plain, replaces) in KERNELS.items():
        x = inputs[name]
        xs = rotated(x)
        warm_ms = median_ms(kernel, [x], SAMPLES)
        probe, cells = EARLIER_DESIGN[name]
        earlier = CHECKED[probe][0]
        if cells is not None:
            earlier = functools.partial(earlier, cells=cells)
        ms, earlier_ms = in_turns(kernel, earlier, xs, xs, SAMPLES)
        plain_ms = median_ms(plain, xs, SAMPLES)
        row = _kernel_row(name, SOURCE, replaces, launches[name], stats, (L, W), ms, plain_ms)
        ops_ms = plain_ops_ms(name, L, W, int_rate)
        print(f"phase 5: {name} {L}x{W}: kernel {ms:.5f} ms (one input, L2-warm: "
              f"{warm_ms:.5f} ms), plain {plain_ms:.5f} ms, bound {row['bound_ms']:.5f} ms by "
              f"bytes ({row['bound_ms'] / ms:.1%} of the kernel's time), plain-op line "
              f"{ops_ms:.5f} ms (median of {TRIALS} trials of "
              f"{LAUNCHES_PER_TRIAL} launches, cycling through {len(xs)} copies of the input)")
        copy = torch.empty_like(x)
        copy_ms = median_ms(lambda src, _n: copy.copy_(src), xs, SAMPLES)
        shown = probe + ("" if cells is None else f" at {cells} cells")
        earlier_bound = bound(probe, L, W)
        print(f"phase 5: {name} {L}x{W} in turns with its earlier design {shown}: "
              f"{ms:.5f} ms against {earlier_ms:.5f} ms ({ms / earlier_ms:.1%}); bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_ms'] / ms:.1%} and "
              f"{earlier_bound / earlier_ms:.1%} of their times), plain-op lines "
              f"{ops_ms:.5f} and {plain_ops_ms(probe, L, W, int_rate):.5f} ms; a device copy "
              f"of its input plane (Tensor.copy_, {x.nbytes:,} bytes in and out) "
              f"{copy_ms:.5f} ms")
        if probe in TEXT_PROBES:
            probe_rows[probe] = (earlier_ms, plain_ms)
        del xs
        rows.append(row)
    for probe, (ms, plain_ms) in probe_rows.items():
        rows.append(_kernel_row(probe, PROBE_SOURCE, TEXT_PROBES[probe][2], LAUNCHES[probe],
                                stats, (L, W), ms, plain_ms))
    return rows


def trace_copies(trace: dict) -> dict:
    """{copy kind: {"count", "bytes", "ms"}} of the memcpy events of a
    profiler's chrome trace, by their name (e.g. "Memcpy DtoH (Device ->
    Pinned)"); "bytes" is None where the trace carries no byte count."""
    copies = {}
    for ev in trace.get("traceEvents", []):
        name = ev.get("name", "")
        if ev.get("cat") != "gpu_memcpy" and not name.startswith("Memcpy"):
            continue
        c = copies.setdefault(name, {"count": 0, "bytes": 0, "ms": 0.0})
        c["count"] += 1
        c["ms"] += ev.get("dur", 0) / 1e3
        nbytes = ev.get("args", {}).get("bytes")
        c["bytes"] = None if nbytes is None or c["bytes"] is None else c["bytes"] + int(nbytes)
    return copies


def d2h(copies: dict) -> tuple:
    """(bytes, ms) of the device-to-host copies of trace_copies' result;
    bytes None where the trace carries none."""
    kinds = [c for name, c in copies.items() if "DtoH" in name]
    nbytes = [c["bytes"] for c in kinds]
    return (None if None in nbytes else sum(nbytes)), sum(c["ms"] for c in kinds)


def _copies(copies: dict) -> str:
    return "; ".join(f"{name} x{c['count']} "
                     f"{'bytes not measured' if c['bytes'] is None else format(c['bytes'], ',')}"
                     f" {c['ms']:.3f} ms" for name, c in sorted(copies.items()))


def _device_busy(fn, labels=(), copies=None):
    """Run fn under torch.profiler; returns (wall ms, busy ms, ms by kind,
    ms by name, {label: ms}) from the events on the CUDA device only
    (kernels and memcpys): busy is the union of their intervals, host
    runtime and aten rows never count.  Each of ``labels`` is a
    record_function inside fn: its device time is that of the device events
    linked to the ops its calls ran (the profiler also links the label's own
    span on the device to it, which neither it nor busy counts).  A dict
    given as ``copies`` is filled with trace_copies() of the run's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    if copies is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                copies.update(trace_copies(json.load(f)))
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in labels]
    if not events:
        raise SystemExit("phase 6: the profiler recorded no CUDA-device events")
    kinds = {"h2d": 0.0, "d2h": 0.0, "kernel": 0.0, "other": 0.0}
    by_name, spans = {}, []
    def device_us(e):
        return (sum(k.duration for k in e.kernels if k.name not in labels)
                + sum(device_us(child) for child in e.cpu_children))

    by_label = dict.fromkeys(labels, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in by_label:
            by_label[e.name] += device_us(e) / 1e3
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
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
    return wall_ms, busy_us / 1e3, kinds, by_name, by_label


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
            print(f"phase 6: {route} {call} host clock (phase 3's median run, "
                  f"{statistics.median(run[call + '_s']):.3f} s): "
                  + ", ".join(f"{layer} {s:.3f} s" for layer, s in seconds.items())
                  + " (a device layer's clock holds its staging, its copies out of the "
                  "pinned buffers and its waits on the card)")
        calls = [("decompress", lambda: engine.decompress(run["vcfc"]))]
        if run["compress_s"] is not None:
            calls.insert(0, ("compress", lambda: engine.compress(vcf)))
        with route_env(ROUTES[route][0]):
            for call, fn in calls:
                wall, busy, kinds, _by_name, _labels = _device_busy(fn)
                if busy > wall:
                    raise SystemExit(f"phase 6: {route} {call} device busy {busy} ms exceeds "
                                     f"its wall {wall} ms")
                print(f"phase 6: {route} {call} profiled wall {wall:.3f} ms, device busy "
                      f"{busy:.3f} ms, device idle share {1 - busy / wall:.4f}; "
                      + ", ".join(f"{kind} {ms:.3f} ms" for kind, ms in kinds.items()))


def phase6_overlap_control(vcf: bytes, runs):
    """The control of the batch pipeline's overlap: each route's calls in
    turns with engine._SLOTS staging slots and with one, which keeps the
    pinned buffers and the streams but stages a batch only once the one
    before it is fetched, so nothing overlaps.  Prints the medians of the
    call and of its device layer on the host clock; every run's output is
    checked."""
    overlapped = engine._SLOTS
    for route, run in runs.items():
        env, _kernels, layers = ROUTES[route]
        calls = [("decompress", lambda: engine.decompress(run["vcfc"]), vcf)]
        if run["compress_s"] is not None:
            calls.insert(0, ("compress", lambda: engine.compress(vcf), run["vcfc"]))
        with route_env(env):
            for call, fn, want in calls:
                device_layer = {"device layer": layers[call]["device layer"]}
                times = {overlapped: ([], []), 1: ([], [])}  # slots -> (call s, layer s)
                try:
                    for _ in range(CONTROL_TURNS):
                        for slots, (call_s, layer_s) in times.items():
                            engine._SLOTS = slots
                            with layer_clock(device_layer) as clock:
                                t = time.perf_counter()
                                out = fn()
                                call_s.append(time.perf_counter() - t)
                            if out != want:
                                raise SystemExit(f"phase 6: {route} {call} with {slots} staging "
                                                 "slots: output differs")
                            layer_s.append(clock["device layer"])
                            del out
                finally:
                    engine._SLOTS = overlapped
                print(f"phase 6: {route} {call} overlap control ({CONTROL_TURNS} runs each, "
                      "in turns): " + "; ".join(
                          f"{slots} staging slot{'s' * (slots > 1)}: call {spread(call_s)}, "
                          f"device layer median {statistics.median(layer_s):.3f} s"
                          for slots, (call_s, layer_s) in times.items()))


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


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], [COMPACT_AB_FLAG]):
        print(f"usage: python3 chip_smoke.py [{COMPACT_AB_FLAG}]", file=sys.stderr)
        return 2
    wall = time.perf_counter()
    vcf = phase1_build()
    reference = host_reference(vcf)
    t = time.perf_counter()
    v1 = vcfz.vcfz_from_vcfc(reference, version=1)
    dispatch = cohort_dispatch(v1)
    nbits = dispatch_bits(v1, dispatch[0].shape[0])
    del v1
    print(f"phase 1: the cohort's v1 .vcfz by the host writer and its first decode dispatch "
          f"({dispatch[0].shape[0]} streams x {dispatch[0].shape[1]} words) in "
          f"{time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(SEED)
    stats = phase2_kernels(rng, vcf, dispatch, nbits)
    prefix = cli_prefix(vcf)
    runs = phase3_main_path(vcf, reference, prefix)
    sharded_counts, sharded_times = phase3b_sharded(vcf, reference, prefix,
                                                    runs["parse route"]["vcfc"])
    vcfz_counts, vcfz_results = phase3c_vcfz(vcf, reference, prefix,
                                             compact_ab=argv == [COMPACT_AB_FLAG])

    # path -> (its counts, the kernels it must launch)
    paths = {route: (runs[route]["counts"], kernels)
             for route, (_env, kernels, _layers) in ROUTES.items()}
    paths["sharded path"] = (sharded_counts, SHARDED_KERNELS)
    paths[".vcfz path"] = (vcfz_counts, VCFZ_KERNELS)
    launches_by_path = {}  # kernel -> {path: launches}
    for path, (counts, kernels) in paths.items():
        if not all(counts[name] > 0 for name in kernels):
            raise SystemExit(f"phase 4: a kernel did not run on the {path}: {counts}")
        print(f"phase 4: {path}: " + ", ".join(f"{name} {counts[name]}" for name in kernels))
        for name in kernels:
            launches_by_path.setdefault(name, {})[path] = counts[name]
    launches = {name: sum(by_path.values()) for name, by_path in launches_by_path.items()}
    print(f"phase 4: every kernel launched on each of its paths; totals {launches}")

    int_rate = int32_ops_per_s()
    kernel_rows = phase5_times(vcf, stats, launches, int_rate)
    kernel_rows.append(phase5_huffman(dispatch, stats, launches, int_rate))
    kernel_rows.append(phase5_compact(dispatch, nbits, stats, launches, int_rate))
    del dispatch
    for row in kernel_rows:
        row["launches_by_path"] = launches_by_path.get(row["name"], {})
    text_bytes = SAMPLES * LINES * 4  # "a|b\t" per genotype cell

    def median(seconds):
        return None if seconds is None else statistics.median(seconds)

    def rate(seconds):
        return None if seconds is None else text_bytes / median(seconds) / 1e9

    print(json.dumps({"e2e": {
        "samples": SAMPLES, "lines": LINES, "vcf_bytes": len(vcf),
        "genotype_text_bytes": text_bytes, "routes": {
            route: {"vcfc_bytes": len(run["vcfc"]), "compress_s": median(run["compress_s"]),
                    "decompress_s": median(run["decompress_s"]),
                    "compress_runs_s": run["compress_s"], "decompress_runs_s": run["decompress_s"],
                    "compress_genotype_GB_per_s": rate(run["compress_s"]),
                    "decompress_genotype_GB_per_s": rate(run["decompress_s"])}
            for route, run in runs.items()},
        "sharded": {name: {**t, "compress_median_s": median(t["compress_s"]),
                           "decompress_median_s": median(t["decompress_s"])}
                    for name, t in sharded_times.items()},
        "vcfz": {f"v{version}": numbers for version, numbers in vcfz_results.items()}}}))
    phase6_breakdown(vcf, runs)
    phase6_overlap_control(vcf, runs)
    kernel_rows += phase7_ablation(stats, int_rate)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - wall:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
