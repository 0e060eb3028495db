"""Reference-name ordinals.

The port's copy of ``vcfc_tpu/utils/refmap.py``, so that ``vcfc_tpu_torch``
imports nothing of ``vcfc_tpu``.

Chromosome names "1".."22","X","Y","M" map to 1..25; unknown names map to 0
— the reference relies on std::map operator[] default-insertion for this
(utils.cpp:16-25, utils.hpp:90-103), and the 0 ordinal is observable in
index entries and query comparisons, so we preserve it deliberately.
"""

from __future__ import annotations

_NAMES = [str(i) for i in range(1, 23)] + ["X", "Y", "M"]
_ORD = {name: i + 1 for i, name in enumerate(_NAMES)}


def reference_to_int(name: str | bytes) -> int:
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    return _ORD.get(name, 0)


def known_references() -> list[str]:
    return list(_NAMES)
