"""Device-side `.vcfz` entropy coding, in PyTorch: the port of the parts of
``vcfc_tpu/ops/vcfz_device.py`` that the versions without the vertical
transform (v1, v2, v3, v5, v8) run.

Ops on whatever device their tensors lie on (XLA ops in the JAX package,
PyTorch ops here, the same code on the CPU and the card):

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
  ``pack_cells_compact``  ``pack_cells`` on front-compacted symbol rows,
                  the context of a symbol the class of the lane before it
  ``esc_plane_device``  a batch's escape-id plane scattered on the device
                  from its sparse (line, sample, id) triples

and the on-device compaction, which ``VCFZ_COMPACT`` selects
(``device_compaction``): ``sort_compact`` moves each row's masked values to
its front, in order, and counts them.  It dispatches on the tensor's
device: ``sort_compact_plain`` (a cumsum and one scatter, the spec and the
CPU path) for a CPU tensor; for a CUDA tensor the hand-written Hopper
kernel S1 (``cuda_compact.cuda_sort_compact``, from
``csrc/compact_kernels.cu``), or an exception.  The JAX package sorts
instead (a stable ``lax.sort_key_val``); the result is the same, the whole
row included.  The host then brings back only a leading slice of each
row, its width bucketed (``_bucket``), through a pinned buffer
(``HostStage``): ``compact_payloads_device`` does so for the packed words.
Without compaction the host compacts the positional words itself
(``compact_payloads``, numpy), as it compacts positional flags.

The bit arithmetic runs in int64 and comes back as int32 with the JAX
package's values (a word whose bit 31 is set is negative, as there);
``total_bits`` is int32.  The JAX package's vertical transform
(``symbol_grid``, ``sympos_v4``), ``compact_symbols_device`` and its decode
(``resolve_match_grid``) are not ported yet (ROADMAP A.2.1, A.2.3).
"""

from __future__ import annotations

import math
import os

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


def _check_pair(values: torch.Tensor, mask: torch.Tensor) -> None:
    if values.dim() != 2 or mask.shape != values.shape:
        raise ValueError(f"sort_compact takes 2-D values and a mask of their shape, got "
                         f"{tuple(values.shape)} and {tuple(mask.shape)}")


def sort_compact_plain(values: torch.Tensor, mask: torch.Tensor):
    """``sort_compact`` as PyTorch ops, on the values' device: with c the
    inclusive cumsum of the mask along the row, a masked cell goes to
    c - 1 and an unmasked one to count + i - c, by one scatter.  The spec
    of the kernel S1, and the CPU path."""
    _check_pair(values, mask)
    m = mask.to(torch.bool)
    c = torch.cumsum(m, dim=1, dtype=torch.int64)
    count = c[:, -1:] if values.shape[1] else c.new_zeros((c.shape[0], 1))
    i = torch.arange(values.shape[1], dtype=torch.int64, device=values.device)[None, :]
    dst = torch.where(m, c - 1, count + i - c)
    return torch.empty_like(values).scatter_(1, dst, values), count[:, 0].to(torch.int32)


def sort_compact(values: torch.Tensor, mask: torch.Tensor):
    """Order-preserving compaction of each row of a (B, n) tensor: its
    masked values first, in order, then its unmasked values, in order (the
    JAX package's stable sort keyed by the cell index where the mask is
    set).  Returns (the compacted (B, n) values, (B,) int32 masked counts).

    A CPU tensor takes ``sort_compact_plain``; a CUDA tensor the Hopper
    kernel S1 (int32 values, a bool or uint8 mask, both contiguous), which
    raises if it cannot build or launch."""
    _check_pair(values, mask)
    if values.device.type == "cpu":
        return sort_compact_plain(values, mask)
    from .cuda_compact import cuda_sort_compact

    return cuda_sort_compact(values, mask)


def device_compaction(device) -> bool:
    """Whether the `.vcfz` device routes compact on ``device`` (sort_compact,
    a bucketed slice of O(outputs) brought back) instead of bringing the
    dense planes to the host.

    ``VCFZ_COMPACT=device|host`` forces it either way, as in the JAX
    package.  Unset, a CPU device takes ``host``, as the JAX package's CPU
    backend does (the two branches were not timed against each other on
    the CPU), and a CUDA device takes ``device``: on the cohort of
    ``chip_smoke.py`` (2,504 samples x 65,536 lines) the A/B of its phase
    3c (``python3 chip_smoke.py --compact-ab``) found compaction on the
    card faster end to end for every version it runs (PERF.md section 5)."""
    mode = os.environ.get("VCFZ_COMPACT")
    if mode == "device":
        return True
    if mode == "host":
        return False
    return torch.device(device).type == "cuda"


# D2H slice widths are bucketed to multiples of this (the JAX package's
# width, so the slices and the payloads agree with it cell for cell)
_SLICE_BUCKET = 4096


def _bucket(k: int, n: int) -> int:
    return min(n, -(-max(k, 1) // _SLICE_BUCKET) * _SLICE_BUCKET)


class HostStage:
    """A host buffer that one call reuses across its dispatches: pinned
    when the device is a CUDA device (copies run at the pinned rate, and a
    non-blocking H2D from it is asynchronous), plain memory on the CPU.
    The caller rewrites it only once the copies that read it are done."""

    def __init__(self, device):
        self.pinned = torch.device(device).type == "cuda"
        self.buf = torch.empty(0, dtype=torch.uint8)

    def take(self, shape, dtype) -> torch.Tensor:
        """A (shape) tensor of dtype over the buffer's first bytes, the
        buffer grown if it is too small."""
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)
        return self.buf[:nbytes].view(dtype).view(shape)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """The host copy of t, which must be contiguous, in the buffer (the
        copy is synchronous), as a numpy view."""
        host = self.take(t.shape, t.dtype)
        host.copy_(t)
        return host.numpy()


def pack_cells_compact(sym_c: torch.Tensor, counts: torch.Tensor, entries: torch.Tensor,
                       m_base: int, ctx_init: int, *, n_ctx: int, v4: bool):
    """``pack_cells`` on FRONT-COMPACTED symbol rows: row b holds its
    block's counts[b] symbols in its first lanes (``sort_compact``'s output
    sliced to a bucketed width), so the codeword lookup runs over O(symbols)
    lanes.  A symbol's context is the class of the lane before it
    (``ctx_init`` at lane 0), and the words are bit for bit the dense
    packer's (the same offsets and spill injection: a straddler's next
    cell IS the next symbol).

    Args:
      sym_c:  (n_blocks, k) int32, symbols front-compacted per row
      counts: (n_blocks,) int32, the symbols of each row
      rest as ``pack_cells``.

    Returns ``pack_cells``' (word_val, emit, total_bits, bad) in compact
    cell space, (n_blocks, k + 1).  ``bad`` also marks a row whose count
    exceeds k, which the JAX package would cut short without a word."""
    sym_c = torch.nn.functional.pad(sym_c.to(torch.int32), (0, 1))
    counts = counts.to(device=sym_c.device, dtype=torch.int32)
    A = entries.shape[0] // n_ctx
    valid = _cells(sym_c) < counts[:, None]
    if n_ctx == 1:
        ctx = torch.zeros_like(sym_c)
    else:
        ctx = _pad_left(_cell_class(sym_c, m_base, v4=v4), ctx_init).to(torch.int32)
    word_val, emit, total_bits, bad = _pack_from_ctx(sym_c, valid, ctx, entries, A)
    return word_val, emit, total_bits, bad | (counts > sym_c.shape[1] - 1)


def compact_payloads_device(word_val, emit, total_bits, stage: HostStage | None = None
                            ) -> list[bytes]:
    """``compact_payloads`` with the compaction on the words' device:
    ``sort_compact`` brings each row's emitted words to its front, and only
    a leading slice of ceil(max bits / 32) words (bucketed) comes back to
    the host, through ``stage`` (a new one if None), instead of the dense
    word plane and emit mask.  The same bytes."""
    stage = HostStage(word_val.device) if stage is None else stage
    wsorted, _ = sort_compact(word_val, emit)
    bits = total_bits.cpu().numpy()
    nwords = (bits.astype(np.int64) + 31) >> 5
    kb = _bucket(int(nwords.max(initial=0)), word_val.shape[1])
    host = stage.fetch(wsorted[:, :kb].contiguous())
    return [host[b, : nwords[b]].astype(">u4").tobytes()[: (int(bits[b]) + 7) >> 3]
            for b in range(host.shape[0])]


def esc_plane_device(lines, samples, ids, lpb: int, s_pad: int, device) -> torch.Tensor:
    """One batch's (lpb, s_pad) int32 escape-id plane built on ``device``
    from its sparse (line, sample, id) triples (numpy arrays; lines within
    the batch): O(escapes) H2D instead of a dense 4-byte-a-cell plane.
    Only the real triples are scattered (the JAX package pads them to a
    bucketed count for its jit cache and drops the pads)."""
    plane = torch.zeros((lpb, s_pad), dtype=torch.int32, device=device)
    if len(lines):
        trip = torch.from_numpy(np.stack([lines, samples, ids]).astype(np.int64)).to(device)
        plane[trip[0], trip[1]] = trip[2].to(torch.int32)
    return plane
