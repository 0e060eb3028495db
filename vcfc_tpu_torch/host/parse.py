"""Host-side VCF parsing: text -> dense device-ready arrays.

The port's copy of ``vcfc_tpu/host/parse.py``, so that
``vcfc_tpu_torch`` imports nothing of ``vcfc_tpu``.

The host/device boundary of the engine (SURVEY.md §7 layer 2): VCF data
lines are parsed with vectorized numpy into

  * per-line required-column blobs (CHROM..INFO + "\tFORMAT\t", verbatim
    ASCII — these pass through compression untouched, compress.cpp:51-93)
  * a dense (lines x samples) uint8 genotype-code matrix for the device
    RLE kernels (codes 0..3 for the four biallelic phased GTs, 4=escape)
  * an escape side channel: the raw ASCII of any sample field that is not
    one of 0|0 / 0|1 / 1|0 / 1|1

Fast path: every sample field is exactly 3 bytes wide (true for GT-only
cohort VCFs like 1000 Genomes, including escapes such as "2|0" or "./.").
Lines with wider fields (e.g. "10|2") fall back to a per-line path that
still feeds the same device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format.vcf import VcfcHeader, parse_metadata_headers
from ..format.lines import VcfValidationError, split_terms

TAB = 9
NL = 10


@dataclass
class ParsedVcf:
    """A VCF file decomposed for the device encode path."""

    header: VcfcHeader
    data: np.ndarray  # uint8 view of the full body (data region)
    line_start: np.ndarray  # (L,) int64 offsets into `data`
    line_end: np.ndarray  # (L,) exclusive, excludes the newline
    sample_start: np.ndarray  # (L,) offset of first sample field
    codes: np.ndarray  # (L, S) uint8 genotype codes
    irregular: np.ndarray  # (L,) bool — lines needing the slow escape path

    @property
    def n_lines(self) -> int:
        return len(self.line_start)

    @property
    def n_samples(self) -> int:
        return self.codes.shape[1] if self.codes.ndim == 2 else 0

    def required_blob(self, i: int) -> bytes:
        """Required-columns region of line i incl. the trailing tab."""
        return self.data[self.line_start[i] : self.sample_start[i]].tobytes()

    def sample_field(self, i: int, j: int) -> bytes:
        """Raw ASCII of sample j on (regular) line i — 3-byte fast layout."""
        off = self.sample_start[i] + 4 * j
        return self.data[off : off + 3].tobytes()

    def line_text(self, i: int) -> bytes:
        return self.data[self.line_start[i] : self.line_end[i]].tobytes()


def parse_vcf_bytes(raw: bytes) -> ParsedVcf:
    """Parse a VCF byte stream for the device encode path (replaces the
    reference's per-line getline + split_string hot loop,
    compress.cpp:218-244).  Uses the thread-parallel native indexer and
    classifier when available, vectorized numpy otherwise."""
    from . import native

    if native.available():
        return _parse_vcf_bytes_native(raw)
    return _parse_vcf_bytes_numpy(raw)


def _parse_vcf_bytes_native(raw: bytes) -> ParsedVcf:
    from . import native

    header = parse_metadata_headers(raw)
    S = header.schema.sample_count
    raw_np = np.frombuffer(raw, np.uint8)
    # offsets come back relative to the data region (ParsedVcf.data contract)
    line_start, line_end, sample_start = native.index_lines(
        raw_np, header.data_offset
    )
    keep = line_end > line_start  # drop empty lines (compress.cpp:219-221)
    line_start, line_end = line_start[keep], line_end[keep]
    sample_start = sample_start[keep]
    body = raw_np[header.data_offset :]
    L = len(line_start)
    if L == 0:
        return ParsedVcf(
            header, body, line_start, line_end,
            np.zeros(0, np.int64), np.zeros((0, S), np.uint8), np.zeros(0, bool),
        )
    if S == 0:
        # sample-less cohort (header ends at FORMAT or INFO): nothing to
        # classify; the engine routes S == 0 through the format oracle
        return ParsedVcf(
            header, body, line_start, line_end, sample_start,
            np.zeros((L, 0), np.uint8), np.zeros(L, bool),
        )
    if (sample_start < 0).any():
        bad = int(np.flatnonzero(sample_start < 0)[0])
        raise VcfValidationError(
            f"data line {bad} has no FORMAT column (fewer than 9 tabs)"
        )
    codes, regular = native.classify(body, sample_start, line_end, S)
    irregular = regular == 0
    if irregular.any():
        _classify_irregular(body, line_start, line_end, codes, irregular, S)
    return ParsedVcf(header, body, line_start, line_end, sample_start, codes, irregular)


def _classify_irregular(body, line_start, line_end, codes, irregular, S):
    for i in np.flatnonzero(irregular):
        line = body[line_start[i] : line_end[i]].tobytes()
        terms = split_terms(line)
        samples = terms[9:]
        if len(samples) != S:
            raise VcfValidationError(
                f"line {i}: expected {S} samples, found {len(samples)}"
            )
        for j, s in enumerate(samples):
            if s == b"0|0":
                codes[i, j] = 0
            elif s == b"0|1":
                codes[i, j] = 1
            elif s == b"1|0":
                codes[i, j] = 2
            elif s == b"1|1":
                codes[i, j] = 3
            else:
                codes[i, j] = 4


def _parse_vcf_bytes_numpy(raw: bytes) -> ParsedVcf:
    header = parse_metadata_headers(raw)
    body = np.frombuffer(raw, np.uint8)[header.data_offset :]
    S = header.schema.sample_count

    if body.size and body[-1] != NL:
        body = np.concatenate([body, np.array([NL], np.uint8)])

    nl = np.flatnonzero(body == NL).astype(np.int64)
    line_start = np.concatenate([[0], nl[:-1] + 1]) if nl.size else np.zeros(0, np.int64)
    line_end = nl
    # drop empty lines (compress.cpp:219-221)
    keep = line_end > line_start
    line_start, line_end = line_start[keep], line_end[keep]
    L = len(line_start)
    if L == 0:
        return ParsedVcf(
            header, body, line_start, line_end,
            np.zeros(0, np.int64), np.zeros((0, S), np.uint8), np.zeros(0, bool),
        )

    if S == 0:
        # sample-less cohort: nothing to classify; the engine routes
        # S == 0 through the format oracle
        return ParsedVcf(
            header, body, line_start, line_end,
            np.full(L, -1, np.int64), np.zeros((L, 0), np.uint8),
            np.zeros(L, bool),
        )

    # locate the 9th tab of each line (end of FORMAT, start of samples)
    tabs = np.flatnonzero(body == TAB).astype(np.int64)
    owner = np.searchsorted(line_end, tabs, "right")  # line index of each tab
    # tabs in dropped empty lines can't exist; owner maps into kept lines
    tab_counts = np.bincount(owner, minlength=L)
    if (tab_counts < 9).any():
        bad = int(np.flatnonzero(tab_counts < 9)[0])
        raise VcfValidationError(
            f"data line {bad} has {int(tab_counts[bad])} tabs; expected FORMAT column"
        )
    first_tab = np.concatenate([[0], np.cumsum(tab_counts)[:-1]])
    sample_start = tabs[first_tab + 8] + 1

    sample_len = line_end - sample_start
    regular = sample_len == (4 * S - 1)

    codes = np.zeros((L, S), np.uint8)
    if regular.any():
        reg_idx = np.flatnonzero(regular)
        # gather each regular line's sample region plus a virtual trailing tab
        offs = sample_start[reg_idx][:, None] + np.arange(4 * S - 1)
        fields = body[offs]  # (R, 4S-1)
        b0 = fields[:, 0::4][:, :S]
        b1 = fields[:, 1::4][:, :S]
        b2 = fields[:, 2::4][:, :S]
        valid = ((b0 == 48) | (b0 == 49)) & (b1 == 124) & ((b2 == 48) | (b2 == 49))
        # separator check: every 4th byte must be a tab or we mis-sliced
        seps_ok = (fields[:, 3::4] == TAB).all(axis=1)
        codes_reg = np.where(valid, (b0 - 48) * 2 + (b2 - 48), 4).astype(np.uint8)
        codes[reg_idx] = codes_reg
        # lines with non-tab separators are actually irregular
        regular = regular.copy()
        regular[reg_idx[~seps_ok]] = False

    irregular = ~regular
    if irregular.any():
        _classify_irregular(body, line_start, line_end, codes, irregular, S)

    return ParsedVcf(header, body, line_start, line_end, sample_start, codes, irregular)
