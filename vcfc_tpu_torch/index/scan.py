"""Skeleton scan of a .vcfc stream: per-line offsets and required columns.

The port's copy of ``vcfc_tpu/index/scan.py``, so that ``vcfc_tpu_torch``
imports nothing of ``vcfc_tpu``.

Every index builder and query engine needs to walk compressed lines
reading only the uncompressed required-columns region and skipping the
sample bytes by length header (the pattern of create_binned_index4,
main.cpp:1329-1619, without the byte-at-a-time I/O).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..format.headers import decode_line_headers
from ..format.vcf import VcfcHeader, parse_metadata_headers
from ..query.coordinate import alt_is_structural, compute_end_position


@dataclass
class LineRecord:
    offset: int  # absolute offset of the line (start of header #1)
    line_length: int  # header #1 value
    required_length: int  # header #2 value
    chrom: bytes
    pos: int
    id: bytes
    ref: bytes
    alt: bytes
    qual: bytes
    filter: bytes
    info: bytes

    def end_position(self) -> int:
        return compute_end_position(self.pos, self.ref, self.alt, self.info)

    @property
    def is_structural(self) -> bool:
        return alt_is_structural(self.alt)


def scan_lines(vcfc: bytes, header: VcfcHeader | None = None):
    """Yield a LineRecord per compressed data line."""
    if header is None:
        header = parse_metadata_headers(vcfc)
    offset = header.data_offset
    n = len(vcfc)
    while offset < n:
        line_length, required_length = decode_line_headers(vcfc, offset)
        blob = vcfc[offset + 8 : offset + 8 + required_length]
        cols = blob.split(b"\t")
        if len(cols) < 8:
            raise ValueError(f"line at offset {offset} has {len(cols)} required columns")
        yield LineRecord(
            offset,
            line_length,
            required_length,
            cols[0],
            int(cols[1]),
            cols[2],
            cols[3],
            cols[4],
            cols[5],
            cols[6],
            cols[7],
        )
        offset += 4 + line_length


def header_at(header: VcfcHeader, offset: int) -> VcfcHeader:
    """Clone a parsed header with data_offset pinned to a line offset so
    scan_lines can start mid-file (shared by the index query engines)."""
    from copy import copy

    h = copy(header)
    h.data_offset = offset
    return h
