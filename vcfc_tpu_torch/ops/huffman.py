"""Context classes of the .vcfz entropy coder: the port's copy of
``vcfc_tpu/ops/huffman.py``, cut to what the port calls so far (the
context count and the initial context, which ``ops.histogram`` uses).

Context-classed coding (.vcfz v2): each symbol is coded with the codebook
selected by the CLASS of the previous symbol: 0 = full 0|0 run (0x7F),
1 = shorter 0|0 run, 2 = het run, 3 = escape-dictionary symbol.  Class 1
is the fixed initial context of every block, so blocks decode
independently.
"""

from __future__ import annotations

N_CTX = 4
CTX_INIT = 1
