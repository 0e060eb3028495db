"""VCF metadata/header handling and whole-file reference codec.

The port's copy of ``vcfc_tpu/format/vcf.py``, so that ``vcfc_tpu_torch``
imports nothing of ``vcfc_tpu``; it leaves out that module's timing probe
around the header parse.

The .vcfc container passes ``##`` metadata lines and the ``#CHROM`` header
line through verbatim (compress.cpp:222-238); everything after is
compressed data lines.  This module provides the byte-exact whole-file
compress/decompress used as the conformance oracle and for small inputs;
the performance paths are in host/ + ops/.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .constants import VCF_REQUIRED_COL_COUNT
from .lines import VcfValidationError, decode_data_line, encode_data_line


@dataclass
class VcfcSchema:
    """Mirror of VcfCompressionSchema (utils.hpp:125-131)."""

    sample_count: int = 0
    alt_allele_count: int = 0


@dataclass
class VcfcHeader:
    """Parsed verbatim header section of a .vcfc (or .vcf) byte stream."""

    meta_lines: list[bytes] = field(default_factory=list)  # include trailing \n
    header_line: bytes = b""  # includes trailing \n
    schema: VcfcSchema = field(default_factory=VcfcSchema)
    data_offset: int = 0  # byte offset of the first data line


def parse_metadata_headers(buf: bytes) -> VcfcHeader:
    """Parse ``##`` meta lines and the ``#`` header line from the start of a
    stream, mirroring decompress2_metadata_headers' state machine
    (compress.cpp:995-1098): meta before header, header required, sample
    count = tabs beyond the 8 required columns on the header line.
    """
    out = VcfcHeader()
    offset = 0
    got_meta = False
    got_header = False
    n = len(buf)

    while True:
        if offset >= n:
            if not got_header or not got_meta:
                raise VcfValidationError("File ended before a header or metadata line")
            # deliberate divergence: the reference DECOMPRESSOR rejects a
            # stream that ends right after the header line (stale-char
            # quirk, compress.cpp:1036), but its ENCODER accepts data-less
            # VCFs — this parser serves both sides, so we accept
            break
        c1 = buf[offset]
        if c1 != ord("#"):
            if not got_meta or not got_header:
                raise VcfValidationError("File was missing headers or metadata")
            break
        if got_header:
            raise VcfValidationError(
                "Read a metadata or header row after already reading a header"
            )
        end = buf.find(b"\n", offset)
        if end < 0:
            raise VcfValidationError("Failed to read the rest of the metadata or header row!")
        line = buf[offset : end + 1]
        if offset + 1 >= n:
            raise VcfValidationError("Invalid format, empty header row")
        if buf[offset + 1] == ord("#"):
            got_meta = True
            out.meta_lines.append(line)
        else:
            if not got_meta:
                raise VcfValidationError("Got a header line but no metadata lines")
            got_header = True
            out.header_line = line
            tab_count = line.count(b"\t")
            if tab_count > VCF_REQUIRED_COL_COUNT:
                out.schema.sample_count = tab_count - VCF_REQUIRED_COL_COUNT
        offset = end + 1

    out.data_offset = offset
    return out


def compress_bytes(vcf: bytes) -> bytes:
    """Whole-file compress, mirroring compress (compress.cpp:205-257)."""
    out = bytearray()
    for raw in vcf.split(b"\n"):
        if not raw:
            continue  # empty input lines are ignored (compress.cpp:219-221)
        if raw.startswith(b"##"):
            out += raw + b"\n"
        elif raw.startswith(b"#"):
            terms = [t for t in raw.split(b"\t") if t]
            if len(terms) < VCF_REQUIRED_COL_COUNT:
                raise VcfValidationError("VCF Header did not have enough columns")
            out += raw + b"\n"
        else:
            out += encode_data_line(raw, add_newline=True)
    return bytes(out)


def decompress_bytes(vcfc: bytes) -> bytes:
    """Whole-file decompress, mirroring decompress2_fd (compress.cpp:1214-1257)."""
    header = parse_metadata_headers(vcfc)
    out = bytearray()
    for line in header.meta_lines:
        out += line
    out += header.header_line
    offset = header.data_offset
    while offset < len(vcfc):
        line, consumed = decode_data_line(vcfc, offset, header.schema.sample_count)
        out += line
        offset += consumed
    return bytes(out)
