"""Edge cases of the group arithmetic of K1-K4, as seeded numpy planes.

K1-K4 (``csrc/rle_kernels.cu``) give each lane groups of 16 cells and
each warp rounds of 512; K1 and K3 seed one remainder at a group's first
cell and find at most one cap wrap per group, K2 and K4 fill a group from
its own flags or from the code carried in from its right, and K3 checks
each group's separators below n - 1.  These planes put run starts, run
ends, cap wraps, escapes, flags and bad separators on those edges:

- ``encode_edge_cases``: rows of one code (0, 1 and 7: the caps 127 and
  31, and a byte past the five codes) in runs of cap - 1, cap, cap + 1
  and 2 cap cells that start, wrap or end at cells 15, 16, 31, 32, 511 and
  512, on a background of code 2 or of escapes, with n at the width and
  cutting inside runs; and rows with escapes on both sides of group
  edges.
- ``flag_edge_cases``: flag planes whose only flags sit on group and
  round edges, and rows with one flag each.
- ``separator_edge_cases``: text-word planes with one separator that is
  not a tab a row, on those edges and around n - 1; ``text_edge_cases``
  adds the encode cases as words (``as_words``).

Every plane has 256 rows, which the Pallas kernels' tile height divides
at every width here.
"""

from __future__ import annotations

import numpy as np

ROWS = 256
WIDTH = 1024
ANCHORS = (15, 16, 31, 32, 511, 512)
RUN_CODES = (0, 1, 7)
FLAG_WIDTH, FLAG_SAMPLES = 2560, 2504  # one engine batch's width


def _cap(code: int) -> int:
    return 127 if code == 0 else 31


def _run_rows(rng, background: int) -> np.ndarray:
    """One row per (code, run length, anchor, placement) that fits the row:
    the run starts at the anchor, its first cap wrap falls on it, the
    segment before that wrap ends on it, or the run ends on it; the rows
    left up to ROWS hold runs of those lengths end to end in random codes."""
    rows = []
    for code in RUN_CODES:
        cap = _cap(code)
        for length in (cap - 1, cap, cap + 1, 2 * cap):
            for t in ANCHORS:
                for start in sorted({t, t - cap, t + 1 - cap, t + 1 - length}):
                    if start < 0:
                        continue
                    row = np.full(WIDTH, background, np.uint8)
                    row[start : start + length] = code
                    rows.append(row)
    while len(rows) < ROWS:
        row = np.empty(WIDTH, np.uint8)
        pos = 0
        while pos < WIDTH:
            code = int(rng.choice([0, 1, 2, 3, 4, 7]))
            cap = _cap(code)
            length = int(rng.choice([1, cap - 1, cap, cap + 1, 2 * cap]))
            row[pos : pos + length] = code
            pos += length
        rows.append(row)
    return np.stack(rows[:ROWS])


def _escape_edge_rows(rng) -> np.ndarray:
    """Long runs of 0 or 1 with escapes at cells 16k - 1 and 16k: on one
    side of a group edge, the other, or both; every row has the pairs
    (15, 16) and (511, 512)."""
    codes = np.zeros((ROWS, WIDTH), np.uint8)
    codes[ROWS // 2 :] = 1
    edges = np.arange(16, WIDTH, 16)
    for row in codes:
        side = rng.integers(0, 3, edges.size)  # 0: before, 1: after, 2: both
        pick = rng.random(edges.size) < 0.3
        row[edges[pick & (side != 1)] - 1] = 4
        row[edges[pick & (side != 0)]] = 4
        row[[15, 16, 511, 512]] = 4
    return codes


def encode_edge_cases(seed: int = 6) -> list[tuple[str, np.ndarray, int]]:
    """(name, codes (ROWS, WIDTH) uint8, n_samples) for K1."""
    rng = np.random.default_rng(seed)
    cases = []
    for background, what in ((2, "code 2"), (4, "escape")):
        rows = _run_rows(rng, background)
        for n in (WIDTH, 600, 512):
            cases.append((f"runs on edges, {what} background, n={n}", rows, n))
    escapes = _escape_edge_rows(rng)
    for n in (WIDTH, 513):
        cases.append((f"escapes at group edges, n={n}", escapes, n))
    return cases


def flag_edge_cases(seed: int = 7) -> list[tuple[str, np.ndarray, int]]:
    """(name, flags (ROWS, FLAG_WIDTH) uint8, n_samples) for K2: random
    flag bytes only at cells 16k and 16k + 15 (group edges), only at 512k
    and 512k + 511 (round edges), or one flag a row on such a cell (none
    in every eighth row)."""
    rng = np.random.default_rng(seed)
    col = np.arange(FLAG_WIDTH)

    def plane(allowed, p):
        flags = rng.integers(1, 256, (ROWS, FLAG_WIDTH), dtype=np.uint8)
        flags[~(allowed[None, :] & (rng.random((ROWS, FLAG_WIDTH)) < p))] = 0
        return flags

    group_edges = plane((col % 16 == 0) | (col % 16 == 15), 0.25)
    round_edges = plane((col % 512 == 0) | (col % 512 == 511), 0.5)
    one = np.zeros((ROWS, FLAG_WIDTH), np.uint8)
    places = [0, 15, 16, 31, 32, 511, 512, 2047, 2048, FLAG_WIDTH - 1]
    for r in range(ROWS):
        if r % 8:
            one[r, places[r % len(places)]] = rng.integers(1, 256)
    return [
        ("flags on group edges", group_edges, FLAG_SAMPLES),
        ("flags on group edges, n=width", group_edges, FLAG_WIDTH),
        ("flags on round edges", round_edges, FLAG_SAMPLES),
        ("one flag a row on an edge", one, FLAG_SAMPLES),
    ]


VALID_WORDS = (b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t")
ESCAPE_WORDS = (b"./.\t", b"2|0\t", b"0/1\t", b"9|9\t", b"1|2\t", b".|.\t")


def _as_uint32(fields) -> np.ndarray:
    return np.array([int.from_bytes(f, "little") for f in fields], np.uint32)


def as_words(codes: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """A code plane as (L, W) int32 little-endian "a|b<sep>" words: codes
    0-3 as their genotype, any other byte (the escape 4, the non-code 7)
    as an escape word picked from ESCAPE_WORDS, tab separators, '\\n' on
    sample n - 1 and zero words from sample n on."""
    rng = np.random.default_rng(seed)
    words = _as_uint32(ESCAPE_WORDS)[rng.integers(0, len(ESCAPE_WORDS), codes.shape)]
    ok = codes < 4
    words[ok] = _as_uint32(VALID_WORDS)[codes[ok]]
    if 0 < n <= codes.shape[1]:
        words[:, n - 1] = (words[:, n - 1] & 0x00FFFFFF) | (10 << 24)
    words[:, max(n, 0) :] = 0
    return words.view(np.int32)


def text_edge_cases() -> list[tuple[str, np.ndarray, int]]:
    """(name, words (ROWS, WIDTH) int32, n_samples) for K3: every
    encode_edge_cases plane as words, then separator_edge_cases."""
    cases = [(f"{name}, as words", as_words(codes, n, seed), n)
             for seed, (name, codes, n) in enumerate(encode_edge_cases())]
    return cases + separator_edge_cases()


def separator_edge_cases(seed: int = 8) -> list[tuple[str, np.ndarray, int]]:
    """(name, words (ROWS, WIDTH) int32, n_samples) for K3: little-endian
    "a|b<sep>" words of genotypes and escapes, '\\n' on sample n - 1 and
    zero words past it, with one separator byte that is not a tab a row on
    cell 0, a group or round edge, n - 2 (the last cell checked), n - 1 or
    n (not checked), and none in every eighth row."""
    rng = np.random.default_rng(seed)
    fields = _as_uint32(VALID_WORDS + ESCAPE_WORDS[:2])
    bad_seps = np.frombuffer(b"x\n |\x00\xff", np.uint8).astype(np.uint32)
    cases = []
    for n in (WIDTH, 600, 513):
        words = fields[rng.choice(len(fields), (ROWS, WIDTH), p=[0.6, 0.1, 0.1, 0.1, 0.05, 0.05])]
        words[:, n - 1] = (words[:, n - 1] & 0x00FFFFFF) | (10 << 24)
        words[:, n:] = 0
        places = [c for c in (0, *ANCHORS, n - 2, n - 1, n) if c < WIDTH]
        for r in range(ROWS):
            if r % 8:
                c = places[r % len(places)]
                words[r, c] = (words[r, c] & 0x00FFFFFF) | (rng.choice(bad_seps) << 24)
        cases.append((f"bad separators on edges, n={n}", words.view(np.int32), n))
    return cases
