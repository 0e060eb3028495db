"""Line-length header codec.

The port's copy of ``vcfc_tpu/format/headers.py``, so that
``vcfc_tpu_torch`` imports nothing of ``vcfc_tpu``.

A compressed data line starts with two 4-byte big-endian headers
(reference: src/utils.hpp:141-247, src/compress.cpp:32-49):

  byte 0: top 2 bits = "extension count" (always 3 => 3 extra bytes follow),
          low 6 bits = bits 29..24 of the length
  bytes 1..3: bits 23..0 of the length

Header #1 is the total line length measured from byte 4 onward (i.e. it
covers the second header, the required columns, the sample bytes, and the
trailing newline, but NOT itself).  Header #2 is the byte length of the
uncompressed required-columns region (CHROM..INFO, plus "\tFORMAT" and a
trailing '\t' when sample columns exist).
"""

from __future__ import annotations

import struct

from .constants import LINE_LENGTH_HEADER_MAX_VALUE

HEADER_SIZE = 4
LINE_HEADERS_SIZE = 8


def encode_length_header(length: int) -> bytes:
    """Serialize a 30-bit length with extension count 3 (utils.hpp:182-196)."""
    if length > LINE_LENGTH_HEADER_MAX_VALUE:
        raise ValueError(f"length {length} exceeds 30-bit header max")
    return struct.pack(">I", length | 0xC000_0000)


def decode_length_header(buf: bytes, offset: int = 0) -> int:
    """Deserialize a 4-byte header; raises if extension count != 3
    (utils.hpp:198-239)."""
    (word,) = struct.unpack_from(">I", buf, offset)
    ext = (word >> 30) & 0x3
    if ext != 3:
        raise ValueError(f"Extension count {ext} not implemented, must be 3")
    return word & LINE_LENGTH_HEADER_MAX_VALUE


def decode_line_headers(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Read (line_length, required_columns_length) from an 8-byte prefix
    (compress.cpp:270-330)."""
    return (
        decode_length_header(buf, offset),
        decode_length_header(buf, offset + HEADER_SIZE),
    )
