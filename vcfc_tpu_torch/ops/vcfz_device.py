"""Device-side `.vcfz` entropy coding, in PyTorch: the port of the parts of
``vcfc_tpu/ops/vcfz_device.py`` that the versions without the vertical
transform (v1, v2, v3, v5, v8) run.

Three ops, on whatever device their tensors lie on (XLA ops in the JAX
package, PyTorch ops here, the same code on the CPU and the card):

  ``sympos_v3``   the positional flag bytes ARE the v1-v3 symbols; escape
                  flags swap to their dictionary symbol 256 + id
  ``ctx_plane``   each cell's coding context: the class of the previous
                  valid cell, by one packed cummax ((cell << 3) | class)
  ``pack_cells``  the Huffman bit pack of each block's cells into
                  positional 32-bit words: a (ctx, symbol) -> (length <<
                  16) | code lookup, exclusive bit offsets, each code split
                  into its word's bits and the spill into the next word, and
                  the per-word OR as a segmented sum (the bits of a word are
                  disjoint)

The host compacts the positional words into payload bytes
(``compact_payloads``, numpy), as it compacts positional flags.  The bit
arithmetic runs in int64 and comes back as int32 with the JAX package's
values (a word whose bit 31 is set is negative, as there); ``total_bits``
is int32.  The JAX package's vertical transform (``symbol_grid``,
``sympos_v4``), its on-device compaction (``pack_cells_compact``,
``sort_compact``, ``esc_plane_device``) and its decode (``resolve_match_grid``)
are not ported yet (ROADMAP A.2).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _pad_left(x: torch.Tensor, value) -> torch.Tensor:
    """x shifted one column right along the last axis, ``value`` in front."""
    return torch.cat([torch.full_like(x[:, :1], value), x[:, :-1]], dim=1)


def _cells(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement), the
    JAX package's int32 wrap-around."""
    return (((x & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def sympos_v3(flagpos: torch.Tensor, esc_grid: torch.Tensor) -> torch.Tensor:
    """v1-v3 positional symbols straight from positional FLAGS: the flag
    bytes ARE the symbols (so non-greedy runs transcode byte-exactly),
    with escape flags replaced by their dictionary symbol 256 + id.
    (L, S_pad) uint8 flags and int32 ids -> (L, S_pad) int32."""
    f = flagpos.to(torch.int32)
    return torch.where((f & 0xE0) == 0xE0, 256 + esc_grid.to(torch.int32), f)


def _cell_class(sym: torch.Tensor, m_base: int, *, v4: bool) -> torch.Tensor:
    """Alphabet class of a symbol (ops/huffman.py::symbol_classes), as
    selects: 0 = full 0|0 run, 1 = short 0|0 run, 2 = het run, 3 = escape,
    4 = vertical-match (v4)."""
    cls = torch.full_like(sym, 3)
    cls = torch.where(sym < 0x100, 2, cls)
    cls = torch.where(sym < 0x80, 1, cls)
    cls = torch.where(sym == 0x7F, 0, cls)
    if v4:
        cls = torch.where(sym >= m_base, 4, cls)
    return cls


def ctx_plane(sym: torch.Tensor, valid: torch.Tensor, m_base: int, ctx_init: int,
              *, v4: bool) -> torch.Tensor:
    """Per-cell coding context of a (n_blocks, B) int32 positional symbol
    grid: the class of the previous valid cell, by a cummax of (cell << 3)
    | class (< 0: no previous symbol, ``ctx_init``).  ``pack_cells`` uses
    it, and so does v8's context-SPLIT packing: the caller masks each
    ``pack_cells`` call to one context's cells so every sub-payload gets
    its own bitstream.  int32."""
    if sym.shape[1] >= (1 << 28):
        raise ValueError(f"{sym.shape[1]} cells a block exceed the packed-cummax range")
    packed = torch.where(valid, (_cells(sym) << 3) | _cell_class(sym, m_base, v4=v4), -1)
    prev = _pad_left(torch.cummax(packed, dim=1).values, -1)
    return torch.where(prev < 0, ctx_init, prev & 7).to(torch.int32)


def pack_entries(books) -> np.ndarray:
    """(n_ctx * alphabet,) int32 packed (length << 16) | code lookup
    table for ``pack_cells`` (host-built, tiny)."""
    lengths = np.stack([b.lengths for b in books]).astype(np.int32)
    codes = np.stack([b.codes for b in books]).astype(np.int32)
    return ((lengths << 16) | codes).reshape(-1)


def _segmented_sum(contrib: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented SUM along the last axis, reset where
    ``seg_start``: one int64 cumsum minus its exclusive value at each
    segment's first cell (found by a cummax of the start indices).  The
    JAX package runs a log-depth Hillis-Steele loop instead; integer sums
    agree modulo 2^32 in any order, so the wrapped words are the same."""
    incl = torch.cumsum(contrib, dim=1)
    start = torch.cummax(torch.where(seg_start, _cells(contrib), 0), dim=1).values
    excl_at_start = torch.gather(incl - contrib, 1, start.long())
    return incl - excl_at_start


def pack_cells(sym: torch.Tensor, valid: torch.Tensor, entries: torch.Tensor, m_base: int,
               ctx_init: int, *, n_ctx: int, v4: bool):
    """Huffman-pack each block's symbol cells into positional 32-bit words.

    Args:
      sym:      (n_blocks, B) int32 cell symbols in stream order (B =
                block_lines * S_pad cells; invalid cells interleave)
      valid:    (n_blocks, B) bool, the cells that hold a symbol
      entries:  (n_ctx * alphabet,) int32 packed (len << 16) | code
      m_base:   first vertical-match symbol (classes of v4 only)
      ctx_init: context of each block's first symbol
      n_ctx:    number of context codebooks (1 = order-0)
      v4:       classes include the match band

    Returns:
      word_val:   (n_blocks, B + 1) int32, the assembled word at each
                  word's last cell (elsewhere: partial sums, masked by emit)
      emit:       (n_blocks, B + 1) bool, cells holding a finished payload
                  word (host compaction: flatnonzero per row)
      total_bits: (n_blocks,) int32
      bad:        (n_blocks,) bool, a valid cell had no codeword
    """
    # one trailing invalid cell guarantees a landing site for the final
    # cell's cross-word spill (the injection below shifts by one cell)
    sym = torch.nn.functional.pad(sym.to(torch.int32), (0, 1))
    valid = torch.nn.functional.pad(valid, (0, 1))
    A = entries.shape[0] // n_ctx
    if n_ctx == 1:
        ctx = torch.zeros_like(sym)
    else:
        ctx = ctx_plane(sym, valid, m_base, ctx_init, v4=v4)
    return _pack_from_ctx(sym, valid, ctx, entries, A)


def _pack_from_ctx(sym, valid, ctx, entries, A):
    """The bit assembly: per-cell codeword lookup, exclusive bit offsets,
    cross-word spill injection, and the segmented word sum, in int64."""
    entry = entries[ctx.long() * A + torch.where(valid, sym, 0).long()].long()
    length = torch.where(valid, entry >> 16, 0)
    code = torch.where(valid, entry & 0xFFFF, 0)
    bad = (valid & (length == 0)).any(dim=1)

    ends = torch.cumsum(length, dim=1)
    off = ends - length  # exclusive bit offset
    total_bits = ends[:, -1]

    w_id = off >> 5
    sh = off & 31
    spill = torch.clamp(sh + length - 32, min=0)  # bits landing in the next word
    n_hi = length - spill
    # valid cells have sh + n_hi <= 32, so these shifts stay in 0..32 and
    # every value below 2^32; the selects drop what invalid cells compute
    hi = torch.where(valid, (code >> spill) << (32 - sh - n_hi), 0)
    lo = torch.where(spill > 0, (code << (32 - spill)) & _MASK32, 0)

    # a straddler's spill belongs to the NEXT word, whose segment begins
    # at the very next cell: inject it there (shift by one cell)
    contrib = hi | _pad_left(lo, 0)

    # per-word OR == segmented SUM over the sorted word ids (bits disjoint)
    seg_start = w_id != _pad_left(w_id, -1)
    word_val = _wrap32(_segmented_sum(contrib, seg_start))
    word_last = torch.cat([seg_start[:, 1:], torch.ones_like(seg_start[:, :1])], dim=1)
    # the trailing segment (cells past the final bit) owns no payload word
    # when the stream ends exactly on a word boundary: mask it so the host
    # compaction is a bare flatnonzero
    emit = word_last & (w_id * 32 < total_bits[:, None])
    return word_val, emit, total_bits.to(torch.int32), bad


def compact_payloads(word_val, emit, total_bits) -> list[bytes]:
    """Host compaction of positional words into per-block payload bytes
    (big-endian words, truncated to ceil(bits / 8)): the O(outputs) host
    transform of the positional contract.  Takes numpy arrays (or CPU
    tensors)."""
    word_val = np.asarray(word_val)
    emit = np.asarray(emit)
    total_bits = np.asarray(total_bits)
    out = []
    for b in range(word_val.shape[0]):
        bits = int(total_bits[b])
        words = word_val[b, emit[b]].astype(">u4")
        out.append(words.tobytes()[: (bits + 7) >> 3])
    return out
