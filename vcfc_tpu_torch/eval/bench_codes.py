"""The benchmark's genotype-code plane: the port's copy of ``bench._gt_codes``."""

from __future__ import annotations

import numpy as np

# 1000 Genomes-like code frequencies: 0|0, 0|1, 1|0, 1|1, escape
GT_CODE_P = [0.81, 0.072, 0.072, 0.0264, 0.0196]


def gt_codes(L: int, S: int, seed: int = 0) -> np.ndarray:
    """(L, S) uint8 genotype codes drawn from ``GT_CODE_P``: the same bytes
    as ``bench._gt_codes(L, S, seed)``."""
    rng = np.random.default_rng(seed)
    return rng.choice(5, size=(L, S), p=GT_CODE_P).astype(np.uint8)
