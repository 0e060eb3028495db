"""Order-0 canonical Huffman DECODE on the device: the port of
``vcfc_tpu/ops/huffman_device.py``.

What ``decode_bits`` computes (the JAX package's formulation):

1.  For CANONICAL codes the code length at any bit offset is pure
    arithmetic: with ``lim_l = (base_l + count_l) << (15 - l)`` monotone in
    l, the length of the codeword starting at bit b is ``1 + sum_l
    [window15(b) >= lim_l]`` (14 compares), and its ordinal is
    ``(window15 >> (15 - len)) + (offset_len - base_len)``.
2.  The bits that START a symbol are the reachability of b -> b + len(b)
    from bit 0: a recurrence over a 15-bit state m (bit k: a symbol starts
    k bits from here), ``start = m & 1``, ``m' = (m >> 1) | (start << (len
    - 1))``.  A segment's composed transition is a 15x15 boolean matrix.
3.  Two levels: each segment's matrix by folding the 15 basis states over
    its bits, the segments' true input states by chaining the matrices from
    e_0, then a final fold that emits the start bits.

The output is a POSITIONAL plane: ``ordinal + 1`` at each start bit, 0
elsewhere; the host compacts it (``device_unpack_symbols``).

``decode_bits`` dispatches on the words' device: ``decode_bits_plain``, the
three passes as PyTorch ops (the spec, and the CPU path), for a CPU tensor;
the hand-written Hopper kernel (``cuda_huffman.cuda_decode_bits``, from
``csrc/huffman_kernels.cu``) for a CUDA tensor, or an exception.

Torch's ``>>`` on int32 is arithmetic, where the JAX package shifts right
logically: the windows are built in int64 from the words' unsigned values,
and every state the passes shift is below 2^15, where the two agree.

``device_unpack_symbols`` ports both of the JAX package's branches, which
``VCFZ_COMPACT`` selects (``ops.vcfz_device.device_compaction``).  The dense
branch brings the plane back to the host, which cuts each row to its
stream's bits and compacts it.  The compaction branch masks each row to its
stream's bits, compacts the plane on the device (``sort_compact``, the
Hopper kernel S1 on the card), brings the counts back (one small
synchronising copy a dispatch), and then only a leading slice of each row,
its width bucketed from the largest count.  It stages the words (H2D) and
the slice (D2H) through pinned host buffers that the dispatches of a call
reuse.
"""

from __future__ import annotations

import numpy as np
import torch

from .huffman import MAX_CODE_LEN, Codebook

_W = MAX_CODE_LEN  # 15: window width, state bits, basis count


def device_decode_tables(book: Codebook):
    """Host-side constants for the arithmetic canonical decode.

    Returns (limits (15,) int32, idx_adjust (15,) int32, sorted_syms
    (n_present,) int32), numpy arrays, with limits[l-1] the EXCLUSIVE
    window15 upper bound for code length <= l and idx_adjust[l-1] =
    first_ordinal_of_length_l - base_l."""
    lengths = np.asarray(book.lengths)
    limits = np.zeros(_W, np.int32)
    idx_adjust = np.zeros(_W, np.int32)
    sorted_syms = []
    code = 0
    ordinal = 0
    for l in range(1, _W + 1):
        syms = np.flatnonzero(lengths == l)
        base = code
        idx_adjust[l - 1] = ordinal - base
        sorted_syms.extend(syms.tolist())
        code += len(syms)
        ordinal += len(syms)
        limits[l - 1] = min(code << (_W - l), 1 << _W)
        code <<= 1
    return limits, idx_adjust, np.asarray(sorted_syms, np.int32)


def _windows15(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 big-endian words -> (B, W*32) int32: the 15-bit window
    starting at every bit position (zeros past the row's last word)."""
    B, W = words.shape
    u = words.to(torch.int64) & 0xFFFFFFFF  # the words' unsigned values
    nxt = torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)
    pair = (u << 32) | nxt  # 64 bits; bit 63 lands in the sign, shifted out below
    j = torch.arange(32, dtype=torch.int64, device=words.device)
    # bits j..j+14 of the pair, counted from its top: shift right by 49 - j
    # (>= 18, so the arithmetic shift's sign copies fall outside the mask)
    win = (pair[:, :, None] >> (49 - j)) & ((1 << _W) - 1)
    return win.to(torch.int32).reshape(B, W * 32)


def _lens_and_syms(window, limits, idx_adjust):
    """Per-bit code length (1..15) and symbol ordinal, arithmetically."""
    ln = torch.ones_like(window)
    for l in range(1, _W):  # 14 compares: len = 1 + #(window >= lim_l)
        ln = ln + (window >= limits[l - 1]).to(torch.int32)
    idx = torch.zeros_like(window)
    for l in range(1, _W + 1):
        cand = (window >> (_W - l)) + idx_adjust[l - 1]  # window >= 0: logical
        idx = torch.where(ln == l, cand, idx)
    return ln, idx


def _check_grid(words: torch.Tensor, s1: int, s2: int) -> None:
    if words.dim() != 2:
        raise ValueError(f"words must be a 2-D (B, W) tensor, got {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if s1 < 1 or s2 < 1 or words.shape[1] * 32 != s1 * s2:
        raise ValueError("word count does not tile the (s1, s2) bit grid")


def decode_bits_plain(words, limits, idx_adjust, *, s1: int, s2: int) -> torch.Tensor:
    """``decode_bits`` as PyTorch ops, on the words' device: passes A and C
    fold over the s2 bits of every segment at once, pass B chains the
    segment matrices along s1.  The spec of the kernel, and the CPU path."""
    _check_grid(words, s1, s2)
    dev = words.device
    limits = torch.as_tensor(np.asarray(limits, np.int32), device=dev)
    idx_adjust = torch.as_tensor(np.asarray(idx_adjust, np.int32), device=dev)
    B = words.shape[0]
    window = _windows15(words)
    ln, idx = _lens_and_syms(window, limits, idx_adjust)
    lens = ln.reshape(B, s1, s2)

    # pass A: segment transfer matrices; column k is the image of basis e_k
    state = (1 << torch.arange(_W, dtype=torch.int32, device=dev)).expand(B, s1, _W)
    for t in range(s2):
        fire = state & 1
        state = (state >> 1) | (fire << (lens[:, :, t, None] - 1))
    m_seg = state  # (B, s1, 15)

    # pass B: each segment's true input state, chaining the matrices from e_0
    vec = torch.ones(B, dtype=torch.int32, device=dev)
    seg_in = torch.empty((B, s1), dtype=torch.int32, device=dev)
    for s in range(s1):
        seg_in[:, s] = vec
        out = torch.zeros_like(vec)
        for k in range(_W):
            out = out | torch.where(((vec >> k) & 1) == 1, m_seg[:, s, k], 0)
        vec = out

    # pass C: the final fold with the true inputs, emitting the start bits
    fires = torch.empty((B, s1, s2), dtype=torch.int32, device=dev)
    state = seg_in
    for t in range(s2):
        fire = state & 1
        fires[:, :, t] = fire
        state = (state >> 1) | (fire << (lens[:, :, t] - 1))
    start = fires.reshape(B, s1 * s2)
    return torch.where(start == 1, idx + 1, 0)


def decode_bits(words, limits, idx_adjust, *, s1: int, s2: int) -> torch.Tensor:
    """Order-0 canonical Huffman decode of B independent bitstreams.

    Args:
      words: (B, W) int32, big-endian 32-bit words of each stream,
             zero-padded; W*32 must equal s1*s2
      limits, idx_adjust: device_decode_tables constants (host arrays)
      s1: segments per stream (the chained axis)
      s2: bits per segment (the folded axis)

    Returns (B, s1*s2) int32 on the words' device: ``symbol ordinal + 1``
    at each bit that starts a codeword (chained from bit 0), 0 elsewhere.
    A CPU tensor takes ``decode_bits_plain``; a CUDA tensor the Hopper
    kernel, which raises if it cannot build or launch."""
    _check_grid(words, s1, s2)
    if words.device.type == "cpu":
        return decode_bits_plain(words, limits, idx_adjust, s1=s1, s2=s2)
    from .cuda_huffman import cuda_decode_bits

    return cuda_decode_bits(words, limits, idx_adjust, s1=s1, s2=s2)


def _split_grid(nbits_max: int) -> tuple[int, int]:
    """Pick (s1, s2) for a stream of <= nbits_max bits: s2 (the folded axis)
    near 2048, grown so that the chain s1 stays <= 4096 segments."""
    total = max((nbits_max + 32 * 128 - 1) // (32 * 128), 1) * 32 * 128
    s2 = 2048
    while s2 > total:
        s2 //= 2
    while (total + s2 - 1) // s2 > 4096:
        s2 *= 2
    s1 = (total + s2 - 1) // s2
    return s1, s2


# bits per decode dispatch (the JAX package's): the plain passes hold an
# int64 window and a few int32 planes per bit (windows, lengths, ordinals,
# starts, the output), about 2 GB at 64M bits; the kernel holds only the
# words and the output plane
_MAX_DISPATCH_BITS = 64 * 1024 * 1024


def stream_words(payloads: list[bytes], s1: int, s2: int, out: np.ndarray | None = None
                 ) -> np.ndarray:
    """(B, s1*s2/32) int32: each payload's big-endian 32-bit words,
    zero-padded to the grid; written into ``out`` (a C-contiguous int32
    array of that shape) when it is given."""
    shape = (len(payloads), s1 * s2 // 32)
    if out is None:
        out = np.empty(shape, np.int32)
    if out.shape != shape or out.dtype != np.int32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous int32 array of shape {shape}")
    raw = out.view(np.uint8)
    raw[:] = 0
    for i, p in enumerate(payloads):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    if np.little_endian:  # the bytes are big-endian words
        out.byteswap(inplace=True)
    return out


def device_unpack_symbols(
    payloads: list[bytes], n_syms: list[int], book: Codebook, device=None
) -> list[np.ndarray]:
    """Decode order-0 payloads block-parallel on ``device`` (None: the CUDA
    device); returns the symbol array per payload.  Raises ValueError on
    streams whose chained decode does not yield at least n_syms symbols, or
    yields an ordinal outside the book (the host decoders' 'invalid Huffman
    stream').

    Each dispatch of at most ``_MAX_DISPATCH_BITS`` bits goes through the
    same steps: the words built on the host (``stream_words``), sent to
    the device (``_upload``), decoded (``decode_bits``); then, under
    compaction (``device_compaction``), compacted on the device with the
    counts brought back (``_compact_rows``); brought back (``_download``:
    the dense plane, or the compacted slice through a pinned buffer); and
    cut, gated and mapped to symbols on the host (``_rows_to_symbols``)."""
    if not payloads:
        return []
    from .. import engine
    from .vcfz_device import HostStage, _bucket, device_compaction

    device = engine._device(device)
    limits, idx_adjust, sorted_syms = device_decode_tables(book)
    max_bytes = max(len(p) for p in payloads)
    s1, s2 = _split_grid(max_bytes * 8)
    group = max(_MAX_DISPATCH_BITS // (s1 * s2), 1)
    compact = device_compaction(device)
    # under compaction the words and the slices pass through pinned buffers
    # that every dispatch reuses; the dense branch copies from and to
    # pageable memory
    words_in, slice_out = (HostStage(device), HostStage(device)) if compact else (None, None)
    out: list[np.ndarray] = []
    for g0 in range(0, len(payloads), group):
        chunk = payloads[g0 : g0 + group]
        nbits = [len(p) * 8 for p in chunk]
        if compact:  # the last dispatch's copies are done: its counts came back
            host_words = words_in.take((len(chunk), s1 * s2 // 32), torch.int32)
            stream_words(chunk, s1, s2, out=host_words.numpy())
        else:
            host_words = torch.from_numpy(stream_words(chunk, s1, s2))
        words = _upload(host_words, device)
        plane = decode_bits(words, limits, idx_adjust, s1=s1, s2=s2)
        del words
        counts = None
        if compact:
            plane, counts = _compact_rows(plane, nbits)
            plane = plane[:, : _bucket(int(counts.max(initial=0)), plane.shape[1])]
        host = _download(plane, slice_out)
        del plane
        out += _rows_to_symbols(host, nbits, n_syms[g0 : g0 + len(chunk)], sorted_syms, counts)
    return out


def _upload(words: torch.Tensor, device) -> torch.Tensor:
    """The words to the device, without blocking from a pinned buffer."""
    return words.to(device, non_blocking=words.is_pinned())


def _compact_rows(plane: torch.Tensor, nbits: list[int]):
    """Compact each row's start bits within its stream's true bit length
    to its front on the plane's device (``sort_compact``); returns (the
    compacted plane on the device, the counts on the host).  Masking to
    the bit length keeps the truncated-stream gate: spurious starts in the
    zero padding past a stream's end must not count."""
    from .vcfz_device import sort_compact

    cells = torch.arange(plane.shape[1], device=plane.device)[None, :]
    valid = cells < torch.tensor(nbits, dtype=torch.int64).to(plane.device)[:, None]
    compacted, counts = sort_compact(plane, (plane != 0) & valid)
    return compacted, counts.cpu().numpy()


def _download(plane: torch.Tensor, stage) -> np.ndarray:
    """The plane (or its compacted slice) to the host: through the pinned
    ``stage`` after a device copy that makes the slice contiguous; else
    (``stage`` None) a pageable ``.cpu()``."""
    if stage is None:
        return plane.cpu().numpy()
    return stage.fetch(plane.contiguous())


def _rows_to_symbols(host: np.ndarray, nbits: list[int], n_syms, sorted_syms, counts
                     ) -> list[np.ndarray]:
    """Each row's first n_syms ordinals mapped to symbols, behind both
    'invalid Huffman stream' gates.  A dense row (``counts`` None) is cut to
    its stream's bits and compacted here (starts in the final byte's padding
    are spurious, so only the first n count); a compacted row starts with
    its ``counts[i]`` ordinals."""
    out = []
    for i, n in enumerate(n_syms):
        if counts is None:
            row = host[i, : nbits[i]]
            vals = row[np.flatnonzero(row)] - 1
            if len(vals) < n:
                raise ValueError("invalid Huffman stream")
            vals = vals[:n]
        else:
            if counts[i] < n:
                raise ValueError("invalid Huffman stream")
            vals = host[i, :n] - 1
        if len(vals) and (vals >= len(sorted_syms)).any():
            raise ValueError("invalid Huffman stream")
        out.append(sorted_syms[vals])
    return out
