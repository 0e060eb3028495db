"""ctypes binding to the native host runtime (native/libvcfc_host.so).

The port's copy of ``vcfc_tpu/host/native.py``, cut to the entry points
the port calls.  ``native/`` is the repo's shared C++ host runtime: the
library is built from ``native/vcfc_host.cpp`` with ``make -C native
libvcfc_host.so`` at first use, under a lock so that concurrent processes
build it once.  It provides thread-parallel byte plumbing around the device
kernels: line indexing and classification of VCF text, .vcfc stream
walking, positional-flag unpack with escape discovery, two-pass encode
assembly and escape-splicing decode rendering.  Every entry point the
engine needs has a numpy/Python fallback in host/parse.py +
host/assemble.py; ``available()`` gates usage and VCFC_NO_NATIVE=1
disables the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB = _NATIVE_DIR / "libvcfc_host.so"
_SOURCE = _NATIVE_DIR / "vcfc_host.cpp"
_LOCK = Path(__file__).resolve().parent.parent / "_build" / "native.lock"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64

_SIGNATURES = {  # entry point -> (restype, argtypes)
    "vcfc_scan": (_i64, [_u8p, _i64, _i64, _i64, _i64p, _i32p, _i32p]),
    "vcfc_unpack": (None, [_u8p, _i64p, _i32p, _i32p, _i64, _i64, _i64, _u8p, _i32p, _u8p]),
    "vcfc_scan_packed": (
        None, [_u8p, _i64p, _i32p, _i32p, _i64, _i64, _i64, _u8p, _i32p, _i32p, _u8p]),
    "vcfc_collect_escapes": (
        None, [_u8p, _i64p, _i32p, _i32p, _i32p, _i64p, _i64, _i64, _i32p, _i64p, _i32p]),
    "vcfc_measure": (None, [_u8p, _i64p, _i64p, _u8p, _u8p, _i64, _i64, _i64, _i64p]),
    "vcfc_write": (
        None, [_u8p, _i64p, _i64p, _u8p, _u8p, _i64p, _i64p, _i64, _i64, _i64, _u8p]),
    "vcfc_measure_render": (None, [_i32p, _i32p, _i64p, _i32p, _i64, _i64, _i64p]),
    "vcfc_render": (None, [_u8p, _i64p, _i32p, _u8p, _i32p, _i64p, _i32p, _i64p, _i32p,
                           _u8p, _i64p, _i64, _i64, _i64, _u8p]),
    "vcfc_render_text": (None, [_u8p, _i64p, _i32p, _u8p, _i32p, _i64p, _i32p, _i64p, _i32p,
                                _u8p, _i64p, _i64, _i64, _i64, _u8p]),
    "vcfc_gather_text": (None, [_u8p, _i64p, _u8p, _i64, _i64, _i64, _u8p]),
    "vcfc_rle_encode": (None, [_u8p, _i64, _i64, _i64, _u8p, _i32p]),
    "vcfc_expand_codes": (None, [_u8p, _i64, _i64, _i64, _u8p]),
    "vcfc_count_lines": (_i64, [_u8p, _i64, _i64, _i64, _i64p]),
    "vcfc_index_lines": (None, [_u8p, _i64, _i64, _i64, _i64p, _i64p, _i64p, _i64p]),
    "vcfc_classify": (None, [_u8p, _i64p, _i64p, _i64, _i64, _u8p, _u8p]),
}


def _stale(binary: Path, source: Path) -> bool:
    """True when the binary is missing or older than its source."""
    if not binary.exists():
        return True
    try:
        return source.stat().st_mtime > binary.stat().st_mtime
    except OSError:
        return False


def _build() -> None:
    """``make -C native libvcfc_host.so`` under an exclusive file lock; a
    failed build leaves the numpy fallback in charge."""
    if not (_NATIVE_DIR / "Makefile").exists():
        return
    _LOCK.parent.mkdir(exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(_LIB, _SOURCE):
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), "libvcfc_host.so"],
                capture_output=True, timeout=300, check=False,
            )


@lru_cache(maxsize=1)
def _load():
    if _stale(_LIB, _SOURCE):
        _build()
    if not _LIB.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    # env check FIRST: VCFC_NO_NATIVE must not trigger the in-tree build
    if os.environ.get("VCFC_NO_NATIVE", "") != "":
        return False
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def scan_vcfc(raw: np.ndarray, data_offset: int, max_lines: int):
    """Returns (line_off int64[L], line_len int32[L], req_len int32[L])."""
    lib = _load()
    line_off = np.empty(max_lines, np.int64)
    line_len = np.empty(max_lines, np.int32)
    req_len = np.empty(max_lines, np.int32)
    n = lib.vcfc_scan(
        _ptr(raw, _u8p), len(raw), data_offset, max_lines,
        _ptr(line_off, _i64p), _ptr(line_len, _i32p), _ptr(req_len, _i32p),
    )
    if n < 0:
        raise ValueError(f"vcfc_scan failed with {n}")
    return line_off[:n], line_len[:n], req_len[:n]


def unpack(raw, line_off, line_len, req_len, S: int, width: int):
    """File sample bytes -> positional flags + escape counts + status."""
    lib = _load()
    L = len(line_off)
    flagpos = np.zeros((L, width), np.uint8)
    esc_count = np.zeros(L, np.int32)
    status = np.zeros(L, np.uint8)
    lib.vcfc_unpack(
        _ptr(raw, _u8p), _ptr(line_off, _i64p), _ptr(line_len, _i32p),
        _ptr(req_len, _i32p), L, S, width,
        _ptr(flagpos, _u8p), _ptr(esc_count, _i32p), _ptr(status, _u8p),
    )
    return flagpos, esc_count, status


def scan_packed(raw, line_off, line_len, req_len, S: int, M: int):
    """File sample bytes -> PACKED flag bytes (L, M) + counts + escape
    counts + status — the device-unpack route's host side (the positional
    expansion happens on device, ops/rle.py::unpack_packed_flags)."""
    lib = _load()
    L = len(line_off)
    packed = np.zeros((L, M), np.uint8)
    nflags = np.zeros(L, np.int32)
    esc_count = np.zeros(L, np.int32)
    status = np.zeros(L, np.uint8)
    lib.vcfc_scan_packed(
        _ptr(raw, _u8p), _ptr(line_off, _i64p), _ptr(line_len, _i32p),
        _ptr(req_len, _i32p), L, S, M,
        _ptr(packed, _u8p), _ptr(nflags, _i32p), _ptr(esc_count, _i32p),
        _ptr(status, _u8p),
    )
    return packed, nflags, esc_count, status


def collect_escapes(raw, line_off, line_len, req_len, esc_count, esc_base, S: int):
    lib = _load()
    L = len(line_off)
    total = int(esc_count.sum())
    esc_sample = np.empty(total, np.int32)
    esc_off = np.empty(total, np.int64)
    esc_len = np.empty(total, np.int32)
    lib.vcfc_collect_escapes(
        _ptr(raw, _u8p), _ptr(line_off, _i64p), _ptr(line_len, _i32p),
        _ptr(req_len, _i32p), _ptr(esc_count, _i32p), _ptr(esc_base, _i64p),
        L, S, _ptr(esc_sample, _i32p), _ptr(esc_off, _i64p), _ptr(esc_len, _i32p),
    )
    return esc_sample, esc_off, esc_len


def measure(body, line_start, sample_start, flagpos, irregular, S, sizes):
    lib = _load()
    L, W = flagpos.shape
    lib.vcfc_measure(
        _ptr(body, _u8p), _ptr(line_start, _i64p), _ptr(sample_start, _i64p),
        _ptr(flagpos, _u8p), _ptr(irregular, _u8p), L, W, S, _ptr(sizes, _i64p),
    )


def write(body, line_start, sample_start, flagpos, irregular, out_off, sizes, S, out):
    lib = _load()
    L, W = flagpos.shape
    lib.vcfc_write(
        _ptr(body, _u8p), _ptr(line_start, _i64p), _ptr(sample_start, _i64p),
        _ptr(flagpos, _u8p), _ptr(irregular, _u8p), _ptr(out_off, _i64p),
        _ptr(sizes, _i64p), L, W, S, _ptr(out, _u8p),
    )


def measure_render(req_len, esc_count, esc_base, esc_len, S, sizes):
    lib = _load()
    L = len(req_len)
    lib.vcfc_measure_render(
        _ptr(req_len, _i32p), _ptr(esc_count, _i32p), _ptr(esc_base, _i64p),
        _ptr(esc_len, _i32p), L, S, _ptr(sizes, _i64p),
    )


def render(raw, line_off, req_len, codes, esc_count, esc_base, esc_sample,
           esc_off, esc_len, skip, out_off, S, out):
    lib = _load()
    L, CW = codes.shape
    lib.vcfc_render(
        _ptr(raw, _u8p), _ptr(line_off, _i64p), _ptr(req_len, _i32p),
        _ptr(codes, _u8p), _ptr(esc_count, _i32p), _ptr(esc_base, _i64p),
        _ptr(esc_sample, _i32p), _ptr(esc_off, _i64p), _ptr(esc_len, _i32p),
        _ptr(skip, _u8p), _ptr(out_off, _i64p), L, CW, S, _ptr(out, _u8p),
    )


def render_text_plane(raw, line_off, req_len, text, esc_count, esc_base,
                      esc_sample, esc_off, esc_len, skip, out_off, S, out):
    """Decode assembly from a device-rendered (L, TW)-byte text plane
    (VCFC_PARSE=device): sample runs memcpy from the plane, escapes
    splice their ASCII over the "?|?" placeholder."""
    lib = _load()
    L, TW = text.shape
    lib.vcfc_render_text(
        _ptr(raw, _u8p), _ptr(line_off, _i64p), _ptr(req_len, _i32p),
        _ptr(text, _u8p), _ptr(esc_count, _i32p), _ptr(esc_base, _i64p),
        _ptr(esc_sample, _i32p), _ptr(esc_off, _i64p), _ptr(esc_len, _i32p),
        _ptr(skip, _u8p), _ptr(out_off, _i64p), L, TW, S, _ptr(out, _u8p),
    )


def gather_text(body, sample_start, irregular, S: int, s_pad: int) -> np.ndarray:
    """Gather regular lines' genotype regions into a (L, 4*s_pad) uint8
    plane (one "a|b\\t" int32 word per sample when viewed as int32) for
    the device classify route; irregular rows stay zero."""
    lib = _load()
    L = len(sample_start)
    text = np.zeros((L, 4 * s_pad), np.uint8)
    lib.vcfc_gather_text(
        _ptr(body, _u8p), _ptr(sample_start, _i64p), _ptr(irregular, _u8p),
        L, S, 4 * s_pad, _ptr(text, _u8p),
    )
    return text


def rle_encode_host(codes: np.ndarray, S: int):
    """Host-executor encode: genotype codes -> positional flags (run-scan)."""
    lib = _load()
    L, W = codes.shape
    flagpos = np.zeros((L, W), np.uint8)
    nseg = np.zeros(L, np.int32)
    lib.vcfc_rle_encode(_ptr(codes, _u8p), L, W, S, _ptr(flagpos, _u8p), _ptr(nseg, _i32p))
    return flagpos, nseg


def expand_codes(flagpos: np.ndarray, S: int) -> np.ndarray:
    """Host-executor decode: positional flags -> genotype codes (run-fill)."""
    lib = _load()
    L, W = flagpos.shape
    codes = np.zeros((L, W), np.uint8)
    lib.vcfc_expand_codes(_ptr(flagpos, _u8p), L, W, S, _ptr(codes, _u8p))
    return codes


def index_lines(raw: np.ndarray, data_offset: int, workers: int = 0):
    """Find data-line boundaries and sample starts (9th-tab + 1) in VCF
    text.  Returns (line_start, line_end, sample_start) int64 arrays;
    sample_start is -1 for lines with fewer than 9 tabs."""
    lib = _load()
    if workers <= 0:
        workers = min(os.cpu_count() or 4, 16)
    per_chunk = np.zeros(workers, np.int64)
    total = lib.vcfc_count_lines(
        _ptr(raw, _u8p), len(raw), data_offset, workers, _ptr(per_chunk, _i64p)
    )
    chunk_base = np.zeros(workers, np.int64)
    np.cumsum(per_chunk[:-1], out=chunk_base[1:])
    line_start = np.empty(total, np.int64)
    line_end = np.empty(total, np.int64)
    sample_start = np.empty(total, np.int64)
    lib.vcfc_index_lines(
        _ptr(raw, _u8p), len(raw), data_offset, workers, _ptr(chunk_base, _i64p),
        _ptr(line_start, _i64p), _ptr(line_end, _i64p), _ptr(sample_start, _i64p),
    )
    return line_start, line_end, sample_start


def classify(body, sample_start, line_end, S):
    lib = _load()
    L = len(sample_start)
    codes = np.zeros((L, S), np.uint8)
    regular = np.ones(L, np.uint8)
    lib.vcfc_classify(
        _ptr(body, _u8p), _ptr(sample_start, _i64p), _ptr(line_end, _i64p),
        L, S, _ptr(codes, _u8p), _ptr(regular, _u8p),
    )
    return codes, regular
