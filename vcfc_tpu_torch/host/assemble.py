"""Host-side assembly (numpy fallback): device kernel outputs <-> byte
streams.

The port's copy of ``vcfc_tpu/host/assemble.py``, so that
``vcfc_tpu_torch`` imports nothing of ``vcfc_tpu``.

Encode: merge *positional* flag bytes from ``ops.rle.rle_encode``
(flag value at each segment-end sample position, 0 elsewhere) with verbatim
required-column blobs and the escape side channel into the exact .vcfc
stream (layout per compress.cpp:5-203).

Decode: walk a .vcfc stream into positional flag matrices for
``rle_decode``; splice rendered sample text back into VCF lines.  Lines
containing escape columns are decoded by the oracle in this fallback (the
native path in host/fast.py splices them without the oracle).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format.constants import SAMPLE_MASK_UNCOMPRESSED, SAMPLE_MASKED_UNCOMPRESSED
from ..format.headers import decode_line_headers, encode_length_header
from ..format.lines import decode_data_line, encode_data_line
from ..format.vcf import VcfcHeader, parse_metadata_headers
from .parse import ParsedVcf

_ESC = SAMPLE_MASKED_UNCOMPRESSED


def assemble_vcfc(
    parsed: ParsedVcf,
    flagpos: np.ndarray,  # (L, S_pad) uint8 positional flag bytes
    nseg: np.ndarray,  # (L,) int32
) -> bytes:
    """Merge device-encoded positional flags with host blobs into .vcfc."""
    out = bytearray()
    for line in parsed.header.meta_lines:
        out += line
    out += parsed.header.header_line

    S = parsed.n_samples
    for i in range(parsed.n_lines):
        if parsed.irregular[i]:
            out += encode_data_line(parsed.line_text(i), add_newline=True)
            continue
        row = flagpos[i]
        positions = np.flatnonzero(row[:S])
        blob = parsed.required_blob(i)
        req_len = len(blob)
        flags = row[positions]
        if not (flags & SAMPLE_MASK_UNCOMPRESSED == _ESC).any():
            body = flags.tobytes()
        else:
            pieces = []
            for j, f in zip(positions.tolist(), flags.tolist()):
                pieces.append(bytes([f]))
                if (f & SAMPLE_MASK_UNCOMPRESSED) == _ESC:
                    pieces.append(parsed.sample_field(i, j))
                    if j < S - 1:
                        pieces.append(b"\t")
            body = b"".join(pieces)
        line_length = 4 + req_len + len(body) + 1
        out += encode_length_header(line_length)
        out += encode_length_header(req_len)
        out += blob
        out += body
        out += b"\n"
    return bytes(out)


@dataclass
class ParsedVcfc:
    """A .vcfc stream decomposed for the device decode path."""

    header: VcfcHeader
    raw: bytes
    line_offset: np.ndarray  # (L,) int64 — absolute offset of each data line
    line_length: np.ndarray  # (L,) int32 — header #1 value
    required_length: np.ndarray  # (L,) int32 — header #2 value
    flags: np.ndarray  # (L, W) uint8 — positional flag bytes
    nflags: np.ndarray  # (L,) int32 — flag count per line
    oracle_line: np.ndarray  # (L,) bool — lines decoded by the oracle

    @property
    def n_lines(self) -> int:
        return len(self.line_offset)

    def required_blob(self, i: int) -> bytes:
        off = int(self.line_offset[i]) + 8
        return self.raw[off : off + int(self.required_length[i])]


def parse_vcfc_bytes(raw: bytes, width: int | None = None) -> ParsedVcfc:
    """Walk a .vcfc stream into positional flag matrices (numpy fallback).

    Escape-free lines yield rows with flags at their segment-end positions;
    lines containing escape bytes (>= 0xE0 in the sample region) are
    marked ``oracle_line`` and decoded by the oracle in assemble_vcf.
    """
    header = parse_metadata_headers(raw)
    S = header.schema.sample_count
    W = width or max(S, 1)
    offsets, lengths, req_lengths, rows, counts, oracle = [], [], [], [], [], []
    offset = header.data_offset
    n = len(raw)
    while offset < n:
        line_length, required_length = decode_line_headers(raw, offset)
        if required_length > line_length - 5:
            # a negative frombuffer count means "to EOF" in numpy — a
            # corrupt header pair would otherwise swallow the rest of the
            # stream as one line's body (the native path rejects the same
            # input via unpack status=1)
            from ..format.lines import VcfValidationError

            raise VcfValidationError(
                f"line at offset {offset}: required length {required_length} "
                f"exceeds line length {line_length}"
            )
        offsets.append(offset)
        lengths.append(line_length)
        req_lengths.append(required_length)
        body = np.frombuffer(
            raw,
            np.uint8,
            count=line_length - 4 - required_length - 1,
            offset=offset + 8 + required_length,
        )
        if bool((body >= _ESC).any()):
            oracle.append(True)
            rows.append(None)
            counts.append(0)
        else:
            oracle.append(False)
            # positional placement: flag k sits at the LAST sample
            # position of its segment (cumulative run length - 1)
            fi = body.astype(np.int32)
            run_len = np.where(fi & 0x80 == 0, fi & 0x7F, fi & 0x1F)
            ends = np.cumsum(run_len) - 1
            row = np.zeros(W, np.uint8)
            if ends.size and (ends[-1] >= W or run_len.min() < 1):
                raise ValueError(f"malformed flag stream at line offset {offset}")
            row[ends] = body
            rows.append(row)
            counts.append(len(body))
        offset += 4 + line_length

    L = len(offsets)
    flags = np.zeros((L, W), np.uint8)
    for i, r in enumerate(rows):
        if r is not None:
            flags[i] = r
    return ParsedVcfc(
        header,
        raw,
        np.array(offsets, np.int64),
        np.array(lengths, np.int32),
        np.array(req_lengths, np.int32),
        flags,
        np.array(counts, np.int32),
        np.array(oracle, bool),
    )


def assemble_vcf(
    parsed: ParsedVcfc,
    text: np.ndarray,  # (L, TW) uint8 rendered sample text from rle_decode
    decoded: np.ndarray,  # (L,) int32 samples produced per line
) -> bytes:
    """Merge rendered sample text with required blobs into VCF bytes."""
    from ..format.lines import VcfValidationError

    S = parsed.header.schema.sample_count
    out = bytearray()
    for line in parsed.header.meta_lines:
        out += line
    out += parsed.header.header_line

    for i in range(parsed.n_lines):
        if parsed.oracle_line[i]:
            line, _ = decode_data_line(parsed.raw, int(parsed.line_offset[i]), S)
            out += line
            continue
        if int(decoded[i]) != S:
            raise VcfValidationError(
                f"line {i}: decoded {int(decoded[i])} samples, expected {S}"
            )
        out += parsed.required_blob(i)
        out += text[i, : 4 * S - 1].tobytes()  # drop the trailing tab
        out += b"\n"
    return bytes(out)
