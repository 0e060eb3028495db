"""Coordinate query model.

The port's copy of ``vcfc_tpu/query/coordinate.py``, so that ``vcfc_tpu_torch``
imports nothing of ``vcfc_tpu``.

Mirrors VcfCoordinateQuery (main.cpp:35-178), the region-string parser
(main.cpp:3993-4026), and the SV-aware end-position computation
(main.cpp:737-852).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.refmap import reference_to_int


@dataclass
class CoordinateQuery:
    reference_name: str = ""
    start_position: int = 0
    end_position: int = 0
    has_start: bool = False
    has_end: bool = False

    @classmethod
    def ref_only(cls, reference_name: str) -> "CoordinateQuery":
        return cls(reference_name)

    @classmethod
    def range(cls, reference_name: str, start: int, end: int) -> "CoordinateQuery":
        return cls(reference_name, start, end, True, True)

    def has_criteria(self) -> bool:
        return bool(self.reference_name) or self.has_start or self.has_end

    def matches(self, reference_name: str, position: int) -> bool:
        """Point containment (main.cpp:75-86)."""
        if self.reference_name and self.reference_name != reference_name:
            return False
        if self.has_start and position < self.start_position:
            return False
        if self.has_end and position > self.end_position:
            return False
        return True

    def compare_to(self, reference_name: str, position: int) -> int:
        """3-way compare of this query against a point: 1 if the query is
        after the point, -1 if before, 0 if the point is inside
        (main.cpp:88-108)."""
        a = reference_to_int(reference_name)
        b = reference_to_int(self.reference_name)
        if a < b or (a == b and position < self.start_position):
            return 1
        if a > b or (a == b and position > self.end_position):
            return -1
        return 0

    def compare_to_range(self, reference_name: str, start: int, end: int) -> int:
        """3-way compare against an interval [start, end] (main.cpp:110-137):
        1 if the query is entirely after it, -1 if entirely before, 0 on
        overlap."""
        a = reference_to_int(reference_name)
        b = reference_to_int(self.reference_name)
        if a < b or (a == b and end < self.start_position):
            return 1
        if a > b or (a == b and start > self.end_position):
            return -1
        return 0


def parse_coordinate_string(s: str) -> CoordinateQuery:
    """Parse "<ref>" or "<ref>:<start>-<end>" (main.cpp:3993-4026)."""
    if ":" not in s:
        return CoordinateQuery.ref_only(s)
    ref, _, rest = s.partition(":")
    if "-" not in rest:
        raise ValueError("Query must contain a dash character: <ref>:<start>-<end>")
    start_s, _, end_s = rest.partition("-")
    try:
        start, end = int(start_s), int(end_s)
    except ValueError as e:
        raise ValueError(f"Failed to parse positions from query: {s}") from e
    return CoordinateQuery.range(ref, start, end)


def alt_is_structural(alt: bytes | str) -> bool:
    """An ALT containing '<' denotes a symbolic/structural allele
    (main.cpp:759-761)."""
    if isinstance(alt, str):
        return "<" in alt
    return b"<" in alt


def parse_info_kvp(info: bytes) -> dict[bytes, bytes]:
    """Split INFO on ';' then '=' (main.cpp:737-757). Flag keys map to
    empty values; duplicate keys keep the last occurrence."""
    out: dict[bytes, bytes] = {}
    for pair in info.split(b";"):
        parts = [p for p in pair.split(b"=") if p]
        if len(parts) == 2:
            out[parts[0]] = parts[1]
        elif len(parts) == 1:
            out[parts[0]] = b""
        elif pair:
            raise ValueError(f"Invalid kvp format: {info!r}")
    return out


def compute_end_position(pos: int, ref: bytes, alt: bytes, info: bytes) -> int:
    """SV-aware end position of a variant (main.cpp:763-852).

    Structural ALTs use INFO END (max over comma-separated values) or
    SVLEN (pos + max|svlen| - 1), defaulting to pos.  Non-structural
    variants span pos + max(len(REF), longest ALT) - 1.
    """
    if alt_is_structural(alt):
        kvp = parse_info_kvp(info)
        if b"END" in kvp:
            # the reference folds with max_end = 0 and only `end > max_end`
            # updates (main.cpp:800-809): empty or all-negative END values
            # yield 0, not pos — observable in .vcfci entry bytes
            ends = [int(v) for v in kvp[b"END"].split(b",") if v]
            return max([*ends, 0])
        if b"SVLEN" in kvp:
            # same fold with abs(): empty SVLEN yields pos + 0 - 1
            svlens = [abs(int(v)) for v in kvp[b"SVLEN"].split(b",") if v]
            return pos + max([*svlens, 0]) - 1
        return pos
    alts = [a for a in alt.split(b",") if a]
    max_alt = max((len(a) for a in alts), default=0)
    if len(ref) >= max_alt:
        return pos + len(ref) - 1
    return pos + max_alt - 1
