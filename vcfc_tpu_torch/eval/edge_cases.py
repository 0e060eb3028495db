"""Edge cases of K1's and K2's group arithmetic, as seeded numpy planes.

K1 and K2 (``csrc/rle_kernels.cu``) give each lane groups of 16 cells and
each warp rounds of 512; K1 seeds one remainder at a group's first cell
and finds at most one cap wrap per group, K2 fills a group from its own
flags or from the code carried in from its right.  These planes put run
starts, run ends, cap wraps, escapes and flags on those edges:

- ``encode_edge_cases``: rows of one code (0, 1 and 7: the caps 127 and
  31, and a byte past the five codes) in runs of cap - 1, cap, cap + 1
  and 2 cap cells that start, wrap or end at cells 15, 16, 31, 32, 511 and
  512, on a background of code 2 or of escapes, with n at the width and
  cutting inside runs; and rows with escapes on both sides of group
  edges.
- ``flag_edge_cases``: flag planes whose only flags sit on group and
  round edges, and rows with one flag each.

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
