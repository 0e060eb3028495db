"""Byte-exact .vcfc data-line codec (pure Python/numpy reference oracle).

The port's copy of ``vcfc_tpu/format/lines.py``, so that
``vcfc_tpu_torch`` imports nothing of ``vcfc_tpu``; it leaves out that
module's ``VCFC_DEBUG`` trace lines, which write only to stderr.

This module re-implements the reference's line format exactly (encoder:
src/compress.cpp:5-203; decoder: src/compress.cpp:741-986).  The fast
paths (device kernels and ``native/``) must agree with it bit-for-bit.
"""

from __future__ import annotations

from .constants import (
    MAX_RUN_00,
    MAX_RUN_HET,
    SAMPLE_MASK_00,
    SAMPLE_MASK_01_10_11,
    SAMPLE_MASK_UNCOMPRESSED,
    SAMPLE_MASKED_00,
    SAMPLE_MASKED_01,
    SAMPLE_MASKED_10,
    SAMPLE_MASKED_11,
    SAMPLE_MASKED_UNCOMPRESSED,
    VCF_REQUIRED_COL_COUNT,
)
from .headers import decode_line_headers, encode_length_header

GT_00 = b"0|0"
GT_01 = b"0|1"
GT_10 = b"1|0"
GT_11 = b"1|1"

_FLAG_OF_GT = {GT_01: SAMPLE_MASKED_01, GT_10: SAMPLE_MASKED_10, GT_11: SAMPLE_MASKED_11}
_GT_OF_MASK = {SAMPLE_MASKED_01: GT_01, SAMPLE_MASKED_10: GT_10, SAMPLE_MASKED_11: GT_11}


class VcfValidationError(ValueError):
    """Mirror of the reference's VcfValidationError (utils.hpp:117-123)."""


def split_terms(line: bytes) -> list[bytes]:
    """Tab-split that drops empty terms, matching split_string
    (utils.cpp:82-112: only pushes terms with size > 0)."""
    return [t for t in line.split(b"\t") if t]


def encode_data_line(line: bytes, add_newline: bool = True) -> bytes:
    """Compress one VCF data line to .vcfc bytes (compress.cpp:5-203).

    Layout: [4B line-length hdr][4B required-cols hdr][CHROM..INFO tab-joined]
    ["\\t"+FORMAT if present]["\\t" if samples follow][RLE sample bytes]["\\n"].
    """
    terms = split_terms(line)
    if len(terms) < VCF_REQUIRED_COL_COUNT:
        raise VcfValidationError("VCF data line did not contain at least 8 terms")

    out = bytearray(8)  # two header placeholders, backpatched below
    required = terms[:VCF_REQUIRED_COL_COUNT]
    out += b"\t".join(required)
    required_length = 7 + sum(len(t) for t in required)

    if len(terms) > VCF_REQUIRED_COL_COUNT:
        fmt = terms[VCF_REQUIRED_COL_COUNT]
        out += b"\t" + fmt
        required_length += len(fmt) + 1

    samples = terms[VCF_REQUIRED_COL_COUNT + 1 :]
    if samples:
        out += b"\t"
        required_length += 1

    out[4:8] = encode_length_header(required_length)

    n = len(samples)
    i = 0
    while i < n:
        val = samples[i]
        if val == GT_00:
            count = 1
            i += 1
            while count < MAX_RUN_00 and i < n and samples[i] == GT_00:
                count += 1
                i += 1
            out.append(count)
        elif val in _FLAG_OF_GT:
            count = 1
            i += 1
            while count < MAX_RUN_HET and i < n and samples[i] == val:
                count += 1
                i += 1
            out.append(_FLAG_OF_GT[val] | count)
        else:
            # escape path: flag byte with count 1, then raw ASCII column,
            # then '\t' unless this is the last sample (compress.cpp:171-185)
            out.append(SAMPLE_MASKED_UNCOMPRESSED | 1)
            out += val
            if i < n - 1:
                out += b"\t"
            i += 1

    if add_newline:
        out.append(ord("\n"))

    out[0:4] = encode_length_header(len(out) - 4)
    return bytes(out)


def decode_data_line(buf: bytes, offset: int, sample_count: int) -> tuple[bytes, int]:
    """Decompress one data line starting at ``offset``.

    Returns (vcf_line_including_newline, compressed_bytes_consumed).
    Mirrors decompress2_data_line (compress.cpp:741-986).
    """
    start = offset
    if offset + 8 > len(buf):
        raise VcfValidationError("Truncated line length headers")
    line_length, required_length = decode_line_headers(buf, offset)
    offset += 8

    required = buf[offset : offset + required_length]
    if len(required) < required_length:
        raise VcfValidationError("Truncated required columns")
    offset += required_length

    tab_count = required.count(b"\t")
    if tab_count != VCF_REQUIRED_COL_COUNT + 1 and not (
        tab_count == VCF_REQUIRED_COL_COUNT and sample_count == 0
    ):
        raise VcfValidationError("Did not read all uncompressed columns")

    out = bytearray(required)
    produced = 0
    while produced < sample_count:
        if offset >= len(buf):
            raise VcfValidationError(
                f"Missing samples, expected {sample_count}, received {produced}"
            )
        b = buf[offset]
        offset += 1
        if (b & SAMPLE_MASK_00) == SAMPLE_MASKED_00:
            count = b & ~SAMPLE_MASK_00 & 0xFF
            out += (GT_00 + b"\t") * count
            produced += count
            if produced >= sample_count:
                out.pop()  # drop trailing tab at end of line (compress.cpp:865-868)
        elif (b & SAMPLE_MASK_UNCOMPRESSED) == SAMPLE_MASKED_UNCOMPRESSED:
            ucount = b & ~SAMPLE_MASK_UNCOMPRESSED & 0xFF
            seen = 0
            while seen < ucount:
                if offset >= len(buf):
                    raise VcfValidationError("Truncated escape column")
                c = buf[offset]
                offset += 1
                if c == ord("\n"):
                    seen += 1
                    produced += 1
                    if seen != ucount:
                        raise VcfValidationError(
                            "Reached end of line before reading all decompressed columns"
                        )
                    offset -= 1  # ending newline handled below (compress.cpp:891)
                elif c == ord("\t"):
                    seen += 1
                    produced += 1
                    if produced < sample_count:
                        out.append(c)
                else:
                    out.append(c)
        else:
            masked = b & SAMPLE_MASK_01_10_11
            gt = _GT_OF_MASK.get(masked)
            if gt is None:
                raise VcfValidationError("unrecognized bitmask during decompression")
            count = b & ~SAMPLE_MASK_01_10_11 & 0xFF
            for _ in range(count):
                out += gt
                produced += 1
                if produced < sample_count:
                    out.append(ord("\t"))

    if offset >= len(buf) or buf[offset] != ord("\n"):
        raise VcfValidationError("Sample line did not end in a newline")
    out.append(ord("\n"))
    offset += 1
    return bytes(out), offset - start
