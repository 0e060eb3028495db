"""Native-accelerated host paths (thread-parallel C++ via ctypes).

The port's copy of ``vcfc_tpu/host/fast.py``.

Mirrors host/assemble.py's interfaces on the positional-flag
representation.  Unlike the numpy fallback, the native decode path
splices escape columns itself — only structurally unsupported lines
(escape flags with count != 1, which the reference encoder never emits)
fall back to the Python oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..format.lines import decode_data_line, encode_data_line
from ..format.vcf import parse_metadata_headers
from . import native
from .assemble import ParsedVcfc
from .parse import ParsedVcf


def assemble_vcfc_native(
    parsed: ParsedVcf,
    flagpos: np.ndarray,  # (L, S_pad) uint8 positional flags
    nseg: np.ndarray,
) -> bytes:
    L, S = parsed.n_lines, parsed.n_samples
    header_blob = b"".join(parsed.header.meta_lines) + parsed.header.header_line

    irregular = parsed.irregular.astype(np.uint8)
    sizes = np.zeros(L, np.int64)
    oracle_lines: dict[int, bytes] = {}
    for i in np.flatnonzero(parsed.irregular):
        enc = encode_data_line(parsed.line_text(int(i)), add_newline=True)
        oracle_lines[int(i)] = enc
        sizes[i] = len(enc)

    native.measure(
        parsed.data, parsed.line_start, parsed.sample_start, flagpos, irregular,
        S, sizes,
    )
    base = len(header_blob)
    out_off = np.zeros(L, np.int64)  # zeros: L == 0 stays valid
    if L > 1:
        np.cumsum(sizes[:-1], out=out_off[1:])
    out_off += base
    total = base + int(sizes.sum())

    out = np.empty(total, np.uint8)
    out[:base] = np.frombuffer(header_blob, np.uint8)
    native.write(
        parsed.data, parsed.line_start, parsed.sample_start, flagpos, irregular,
        out_off, sizes, S, out,
    )
    for i, enc in oracle_lines.items():
        out[out_off[i] : out_off[i] + len(enc)] = np.frombuffer(enc, np.uint8)
    return out.tobytes()


@dataclass
class NativeParsedVcfc(ParsedVcfc):
    """ParsedVcfc extended with the native escape side channel."""

    esc_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    esc_base: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    esc_sample: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    esc_off: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    esc_len: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))


def scan_vcfc_stream(raw: bytes) -> tuple:
    """Parse the header of a .vcfc stream and index its compressed lines.
    Returns (header, line_off, line_len, req_len)."""
    header = parse_metadata_headers(raw)
    max_lines = max((len(raw) - header.data_offset) // 10 + 2, 16)
    line_off, line_len, req_len = native.scan_vcfc(
        np.frombuffer(raw, np.uint8), header.data_offset, max_lines
    )
    return header, line_off, line_len, req_len


def parse_vcfc_native(
    raw: bytes, width: int | None = None, scan=None
) -> NativeParsedVcfc:
    """``scan`` may carry ``scan_vcfc_stream(raw)``'s result, so gating
    callers (engine.decompress_device_unpack's declining pre-gate) don't
    pay the header parse + stream scan twice."""
    header, line_off, line_len, req_len = scan or scan_vcfc_stream(raw)
    raw_np = np.frombuffer(raw, np.uint8)
    S = header.schema.sample_count
    L = len(line_off)
    W = width or max(S, 1)
    if L == 0:
        return NativeParsedVcfc(
            header, raw, line_off, line_len, req_len,
            np.zeros((0, W), np.uint8), np.zeros(0, np.int32), np.zeros(0, bool),
        )
    flagpos, esc_count, status = native.unpack(
        raw_np, line_off, line_len, req_len, S, W
    )
    bad = status == 1
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        from ..format.lines import VcfValidationError

        raise VcfValidationError(f"malformed compressed line at offset {int(line_off[i])}")
    oracle_line = status != 0
    esc_count = np.where(oracle_line, 0, esc_count).astype(np.int32)
    esc_base = np.zeros(L, np.int64)
    if L > 1:
        np.cumsum(esc_count[:-1], out=esc_base[1:], dtype=np.int64)
    esc_sample, esc_off, esc_len = native.collect_escapes(
        raw_np, line_off, line_len, req_len, esc_count, esc_base, S
    )
    nflags = (flagpos > 0).sum(axis=1).astype(np.int32)
    return NativeParsedVcfc(
        header, raw, line_off, line_len, req_len, flagpos, nflags, oracle_line,
        esc_count, esc_base, esc_sample, esc_off, esc_len,
    )


def parse_vcfc_packed_native(raw: bytes, scan=None) -> NativeParsedVcfc:
    """Like parse_vcfc_native, but ``flags`` holds PACKED (left-aligned)
    flag bytes and ``nflags`` their counts — the device-unpack decode
    route (ops/rle.py::unpack_rle_decode): the host never materializes
    the O(L*W) positional plane, so host work and host->device traffic
    scale with the compressed size instead of the cohort width.
    ``scan`` may carry ``scan_vcfc_stream(raw)``'s result, so gating
    callers don't pay the stream scan twice."""
    header, line_off, line_len, req_len = scan or scan_vcfc_stream(raw)
    raw_np = np.frombuffer(raw, np.uint8)
    S = header.schema.sample_count
    L = len(line_off)
    if L == 0:
        return NativeParsedVcfc(
            header, raw, line_off, line_len, req_len,
            np.zeros((0, 128), np.uint8), np.zeros(0, np.int32), np.zeros(0, bool),
        )
    # per-line flag-byte upper bound: the whole sample region (escape
    # text inflates it, but escape-heavy lines are rare); cap at S since
    # every flag covers >= 1 sample
    max_body = int((line_len.astype(np.int64) - 4 - req_len - 1).max())
    M = min(max(max_body, 1), max(S, 1))
    M = (M + 127) // 128 * 128
    packed, nflags, esc_count, status = native.scan_packed(
        raw_np, line_off, line_len, req_len, S, M
    )
    bad = status == 1
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        from ..format.lines import VcfValidationError

        raise VcfValidationError(f"malformed compressed line at offset {int(line_off[i])}")
    oracle_line = status != 0
    esc_count = np.where(oracle_line, 0, esc_count).astype(np.int32)
    esc_base = np.zeros(L, np.int64)
    if L > 1:
        np.cumsum(esc_count[:-1], out=esc_base[1:], dtype=np.int64)
    esc_sample, esc_off, esc_len = native.collect_escapes(
        raw_np, line_off, line_len, req_len, esc_count, esc_base, S
    )
    return NativeParsedVcfc(
        header, raw, line_off, line_len, req_len, packed, nflags, oracle_line,
        esc_count, esc_base, esc_sample, esc_off, esc_len,
    )


def assemble_vcf_from_text(
    parsed: NativeParsedVcfc,
    text: np.ndarray,  # (L, TW) uint8 device-rendered "a|b\t" byte plane
    decoded: np.ndarray,
) -> bytes:
    """Decode assembly from a device-rendered text plane (the
    VCFC_PARSE=device route): identical output to assemble_vcf_native,
    but sample runs are memcpys from ``text`` instead of LUT renders
    from codes; escape columns splice their raw ASCII over the device's
    "?|?" placeholder (native/vcfc_host.cpp::vcfc_render_text)."""
    from ..format.lines import VcfValidationError

    S = parsed.header.schema.sample_count
    L = parsed.n_lines
    header_blob = b"".join(parsed.header.meta_lines) + parsed.header.header_line
    base = len(header_blob)

    bad = (~parsed.oracle_line) & (decoded != S)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise VcfValidationError(
            f"line {i}: decoded {int(decoded[i])} samples, expected {S}"
        )

    sizes = np.zeros(L, np.int64)
    native.measure_render(
        parsed.required_length, parsed.esc_count, parsed.esc_base,
        parsed.esc_len, S, sizes,
    )
    oracle_lines: dict[int, bytes] = {}
    for i in np.flatnonzero(parsed.oracle_line):
        line, _ = decode_data_line(parsed.raw, int(parsed.line_offset[i]), S)
        oracle_lines[int(i)] = line
        sizes[i] = len(line)

    out_off = np.zeros(L, np.int64)
    if L > 1:
        np.cumsum(sizes[:-1], out=out_off[1:])
    out_off += base
    total = base + int(sizes.sum())

    out = np.empty(total, np.uint8)
    out[:base] = np.frombuffer(header_blob, np.uint8)
    native.render_text_plane(
        np.frombuffer(parsed.raw, np.uint8), parsed.line_offset,
        parsed.required_length, text, parsed.esc_count, parsed.esc_base,
        parsed.esc_sample, parsed.esc_off, parsed.esc_len,
        parsed.oracle_line.astype(np.uint8), out_off, S, out,
    )
    for i, line in oracle_lines.items():
        out[out_off[i] : out_off[i] + len(line)] = np.frombuffer(line, np.uint8)
    return out.tobytes()


def assemble_vcf_native(
    parsed: NativeParsedVcfc,
    codes: np.ndarray,  # (L, CW) decoded genotype codes, CW >= S
    decoded: np.ndarray,
) -> bytes:
    from ..format.lines import VcfValidationError

    S = parsed.header.schema.sample_count
    L = parsed.n_lines
    header_blob = b"".join(parsed.header.meta_lines) + parsed.header.header_line
    base = len(header_blob)

    bad = (~parsed.oracle_line) & (decoded != S)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise VcfValidationError(
            f"line {i}: decoded {int(decoded[i])} samples, expected {S}"
        )

    sizes = np.zeros(L, np.int64)
    native.measure_render(
        parsed.required_length, parsed.esc_count, parsed.esc_base,
        parsed.esc_len, S, sizes,
    )
    oracle_lines: dict[int, bytes] = {}
    for i in np.flatnonzero(parsed.oracle_line):
        line, _ = decode_data_line(parsed.raw, int(parsed.line_offset[i]), S)
        oracle_lines[int(i)] = line
        sizes[i] = len(line)

    out_off = np.zeros(L, np.int64)  # zeros: L == 0 stays valid
    if L > 1:
        np.cumsum(sizes[:-1], out=out_off[1:])
    out_off += base
    total = base + int(sizes.sum())

    out = np.empty(total, np.uint8)
    out[:base] = np.frombuffer(header_blob, np.uint8)
    native.render(
        np.frombuffer(parsed.raw, np.uint8), parsed.line_offset,
        parsed.required_length, codes, parsed.esc_count, parsed.esc_base,
        parsed.esc_sample, parsed.esc_off, parsed.esc_len,
        parsed.oracle_line.astype(np.uint8), out_off, S, out,
    )
    for i, line in oracle_lines.items():
        out[out_off[i] : out_off[i] + len(line)] = np.frombuffer(line, np.uint8)
    return out.tobytes()
