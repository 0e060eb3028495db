"""Device-route `.vcfz` writer and reader: the port of
``vcfc_tpu/format/vcfz_device.py``'s ``vcfz_from_vcfc_device`` for the
versions without the vertical transform (v1, v2, v3, v5 and v8), and of its
``vcfz_to_vcfc_device`` for the order-0 versions (v1, v5 and v8), each
with and without the on-device compaction.

The output is BYTE-IDENTICAL to the host writer (``format/vcfz.py``):

  symbol emission   the positional flag bytes already ARE the symbol stream
                    (escape flags swap to their dictionary symbol):
                    ``ops.vcfz_device.sympos_v3``, so non-greedy streams
                    transcode byte-exactly like the host walker
  Huffman bit pack  ``ops.vcfz_device.pack_cells`` per block (cumsum bit
                    offsets, word assembly by a segmented sum) for the
                    symbol payloads, v8's per-context sub-payloads (masked
                    by ``ctx_plane``) and the v3+ order-0 required-columns
                    payloads

Dense O(cells) work runs as PyTorch ops on ``device`` (None: the CUDA
device); the codebook builds are tiny and run on the host, and the escape
dictionary and the per-(context, symbol) frequencies stay on the host:
they are O(symbols), and they anchor the byte contract to the same
``context_codebooks`` the host writer uses.  ``VCFZ_COMPACT``
(``ops.vcfz_device.device_compaction``: unset, ``device`` on a CUDA
device, ``host`` on the CPU) picks where the O(outputs) compactions run,
with the same bytes either way:

  host     the escape-id plane is built dense on the host and sent; the
           dense word plane and emit mask come back and the host compacts
           them (``compact_payloads``)
  device   the escape-id plane is scattered on the device from its sparse
           triples (``esc_plane_device``); ``sort_compact`` (the Hopper
           kernel S1 on the card) front-compacts each block's symbols and
           ``pack_cells_compact`` packs a slice of them bucketed from the
           counts (v8: one sort and one pack a context); the packed words
           are compacted on the device too (``compact_payloads_device``)
           and only a bucketed slice comes back, through a pinned buffer

Returns None (the caller falls back to the host writer) for structurally
unsupported inputs only: zero lines, zero samples, or lines the native
parser routes to the oracle (escape flags with count != 1, which none of
the encoders produce).  Without the native library it raises.  v4, v6 and
v7 (the vertical transform) raise NotImplementedError: they come in the
next slice (ROADMAP A.2).  Each container the route encodes adds one to
``ENCODES[version]``.

The decode (``vcfz_to_vcfc_device``) entropy-decodes every order-0 stream
of a container block-parallel on the device (``ops.huffman_device``, the
Hopper kernel of ``csrc/huffman_kernels.cu`` on the card): v1/v5 symbol
payloads, v8's per-context sub-payloads (re-merged on the host by
``_merge_ctx_streams``) and the v3+ required-columns payloads; under
``VCFZ_COMPACT=device`` the decoded planes are compacted on the device
(S1) and only their symbols come back.  The host then assembles the .vcfc
lines from the decoded streams.  Each container it decodes adds one to
``DECODES[version]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import engine
from ..host import native
from ..host.fast import parse_vcfc_native
from ..ops import vcfz_device as ops
from ..ops.huffman import CTX_INIT, N_CTX, Codebook, context_codebooks
from ..ops.huffman_device import device_unpack_symbols
from .vcfz import (
    VcfzReader,
    _assemble_container,
    _merge_ctx_streams,
    _scan_geometry,
    _symbol_streams_native,
    req_codebook,
)

DEVICE_VERSIONS = (1, 2, 3, 5, 8)  # the versions this route encodes
ENCODES = dict.fromkeys(DEVICE_VERSIONS, 0)  # version -> containers encoded on the device
DECODE_VERSIONS = (1, 5, 8)  # the versions this route decodes
DECODES = dict.fromkeys(DECODE_VERSIONS, 0)  # version -> containers decoded on the device

# cells per pack dispatch: pack_cells holds ~15 working planes, so 16M
# cells keeps the peak device footprint a few GB (its int64 planes)
_MAX_CELLS = 16 * 1024 * 1024


def _lines_per_batch(block_lines: int, s_pad: int) -> int:
    per = max(_MAX_CELLS // max(s_pad, 1), block_lines)
    return (per // block_lines) * block_lines


class _BatchFeed:
    """Per-batch (flags, escape-id) planes, built lazily so the host never
    materializes an O(L * S_pad) int32 escape plane.  Escape occurrences
    arrive as (line, sample, id) triples sorted by line: ids from the
    compacted v3 symbol stream (first-occurrence order, the byte contract),
    positions from the native escape side channel, both enumerated in
    (line, sample) order."""

    def __init__(self, parsed, all_syms: np.ndarray, S_pad: int, lpb: int,
                 device_eb: bool = False):
        self.flags = parsed.flags
        self.W = parsed.flags.shape[1]
        self.S_pad = S_pad
        self.lpb = lpb
        self.L = parsed.n_lines
        self.device_eb = device_eb
        self.esc_lines = np.repeat(
            np.arange(self.L, dtype=np.int64),
            parsed.esc_count.astype(np.int64),
        )
        self.esc_samples = parsed.esc_sample
        self.esc_ids = (all_syms[all_syms >= 256] - 256).astype(np.int32)

    def batch(self, b0: int, device):
        """(flag plane, escape-id plane) of the batch at line b0, on
        ``device``.  With ``device_eb`` the escape plane is scattered on the
        device from the sparse triples (O(escapes) H2D) instead of being
        built dense on the host and sent (4 bytes a cell)."""
        b1 = min(b0 + self.lpb, self.L)
        fb = np.zeros((self.lpb, self.S_pad), np.uint8)
        fb[: b1 - b0, : self.W] = self.flags[b0:b1]
        k0, k1 = np.searchsorted(self.esc_lines, [b0, b1])
        if self.device_eb:
            eb = ops.esc_plane_device(
                (self.esc_lines[k0:k1] - b0).astype(np.int32),
                self.esc_samples[k0:k1].astype(np.int32), self.esc_ids[k0:k1],
                self.lpb, self.S_pad, device)
        else:
            eb = np.zeros((self.lpb, self.S_pad), np.int32)
            if k1 > k0:
                eb[self.esc_lines[k0:k1] - b0, self.esc_samples[k0:k1]] = self.esc_ids[k0:k1]
            eb = torch.from_numpy(eb).to(device)
        return torch.from_numpy(fb).to(device), eb


def _payloads(packed, stage) -> list[bytes]:
    """A packer's outputs -> per-block payload bytes: compacted on the
    device and brought back through the pinned ``stage``, or (``stage``
    None) brought back dense and compacted on the host."""
    word_val, emit, total_bits, bad = packed
    if bool(bad.any()):  # the books cover the streams they were built from
        raise RuntimeError("device packer: symbol without codeword")
    if stage is not None:
        return ops.compact_payloads_device(word_val, emit, total_bits, stage)
    return ops.compact_payloads(word_val.cpu().numpy(), emit.cpu().numpy(),
                                total_bits.cpu().numpy())


def _pack_compact(cells, mask, entries, m_base: int, ctx_init: int, n_ctx: int):
    """The compact-space pack (the JAX package's, under compaction): one
    ``sort_compact`` brings each block's masked symbols to its front, in
    stream order, and ``pack_cells_compact`` packs a leading slice whose
    width is bucketed from the same counts, so no row is cut.  Returns (the
    packer's outputs, the counts on the host)."""
    compacted, counts = ops.sort_compact(cells, mask)
    counts_host = counts.cpu().numpy()
    kb = ops._bucket(int(counts_host.max(initial=0)), cells.shape[1])
    packed = ops.pack_cells_compact(compacted[:, :kb], counts, entries, m_base, ctx_init,
                                    n_ctx=n_ctx, v4=False)
    return packed, counts_host


def vcfz_from_vcfc_device(
    vcfc: bytes, block_lines: int, version: int, device=None
) -> bytes | None:
    """.vcfc -> .vcfz bytes of ``version`` (1, 2, 3, 5 or 8), encoded on
    ``device`` (None: the CUDA device; raises without one), or None for
    the structural cases the host writer takes (see the module)."""
    if version in (4, 6, 7):
        raise NotImplementedError(
            f".vcfz v{version} needs the vertical transform (symbol_grid, sympos_v4) on "
            "the device, which is not ported to vcfc_tpu_torch yet: ROADMAP A.2, the "
            "next slice; the host writer (route=None) encodes it"
        )
    if version not in DEVICE_VERSIONS:
        raise ValueError(f"unsupported .vcfz version {version}")
    device = engine._device(device)
    if not native.available():
        raise RuntimeError(
            "the .vcfz device route needs the native host library "
            "(make -C native libvcfc_host.so, which the port runs at first use)"
        )
    parsed = parse_vcfc_native(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or parsed.oracle_line.any():
        return None
    fast = _symbol_streams_native(vcfc, parsed)
    if fast is None:  # pragma: no cover - native.available() checked above
        return None
    all_syms3, nsym3, esc_list = fast
    nsym3 = nsym3.astype(np.int64)

    geo = _scan_geometry(vcfc)
    W = parsed.flags.shape[1]
    S_pad = (W + 127) // 128 * 128
    block_ranges = [(lo, min(lo + block_lines, L)) for lo in range(0, L, block_lines)]
    n_blocks = len(block_ranges)
    # a batch never holds more blocks than the input has (padding rows are
    # not packed; the JAX package pads a short input to a full batch)
    lpb = min(_lines_per_batch(block_lines, S_pad), n_blocks * block_lines)
    bpb = lpb // block_lines  # blocks per batch
    batch_starts = list(range(0, L, lpb))
    compact = ops.device_compaction(device)
    # under compaction every packed slice comes back through one pinned buffer
    stage = ops.HostStage(device) if compact else None
    feed = _BatchFeed(parsed, all_syms3, S_pad, lpb, device_eb=compact)

    n_symbols = 256 + len(esc_list)
    m_base = n_symbols  # no vertical-match band: m_base only bounds the classes
    n_ctx = 1 if version in (1, 5) else N_CTX

    # ---- the codebooks, on the host, from the natively compacted streams
    nsym = nsym3.astype(np.uint32)
    sym_ends = np.cumsum(nsym3)
    per_block_syms = []
    for lo, hi in block_ranges:
        s0 = 0 if lo == 0 else int(sym_ends[lo - 1])
        per_block_syms.append(all_syms3[s0 : int(sym_ends[hi - 1])].astype(np.int64))
    if version in (1, 5):
        books = [Codebook.from_frequencies(np.bincount(all_syms3, minlength=n_symbols))]
    else:
        books = context_codebooks(per_block_syms, n_symbols)

    # ---- on the device, batch by batch: symbol emission, then the Huffman
    # bit packing of every block's cells
    payloads: list[bytes] = []
    ctx_meta: list[bytes] | None = [] if version == 8 else None
    if version == 8:
        entries_by_ctx = [torch.from_numpy(ops.pack_entries([bk])).to(device) for bk in books]
    else:
        entries = torch.from_numpy(ops.pack_entries(books)).to(device)
    for gi, b0 in enumerate(batch_starts):
        take = min(n_blocks - gi * bpb, bpb)
        fb, eb = feed.batch(b0, device)
        sp = ops.sympos_v3(fb, eb)
        # the batch's blocks, one row each (rows past the last block hold
        # only padding and are not packed)
        cells = sp.reshape(bpb, block_lines * S_pad)[:take]
        del fb, eb, sp
        present = cells != 0
        if version == 8:
            # context-SPLIT packing: the ctx plane (the cummax pack_cells
            # uses) masks one pack per context, so each sub-payload is an
            # independent bitstream under its own (order-0) book
            ctxp = ops.ctx_plane(cells, present, m_base, CTX_INIT, v4=False)
            parts_by_ctx, counts_by_ctx = [], []
            for c in range(N_CTX):
                mask = present & (ctxp == c)
                if compact:  # each sub-stream order-0: no context carry
                    packed, counts = _pack_compact(cells, mask, entries_by_ctx[c], m_base, 0, 1)
                else:
                    packed = ops.pack_cells(cells, mask, entries_by_ctx[c], m_base, 0, n_ctx=1,
                                            v4=False)
                    counts = mask.sum(dim=1).cpu().numpy()
                parts_by_ctx.append(_payloads(packed, stage))
                counts_by_ctx.append(counts)
                del mask, packed
            del ctxp
            for k in range(take):
                parts = [parts_by_ctx[c][k] for c in range(N_CTX)]
                payloads.append(b"".join(parts))
                ctx_meta.append(
                    np.array([int(counts_by_ctx[c][k]) for c in range(N_CTX)], np.uint32).tobytes()
                    + np.array([len(p) for p in parts], np.uint32).tobytes()
                )
        elif compact:
            packed, _counts = _pack_compact(cells, present, entries, m_base, CTX_INIT, n_ctx)
            payloads.extend(_payloads(packed, stage))
        else:
            payloads.extend(_payloads(
                ops.pack_cells(cells, present, entries, m_base, CTX_INIT, n_ctx=n_ctx, v4=False),
                stage))
        del cells, present

    # ---- required-columns payloads (v3+): order-0 device pack
    req_book = req_codebook(geo.req_blob) if version >= 3 else None
    req_payloads: list[bytes] = []
    if version >= 3:
        req_starts = np.zeros(L + 1, np.int64)
        np.cumsum(geo.req_lens, out=req_starts[1:])
        req_np = np.frombuffer(geo.req_blob, np.uint8)
        blk_req_len = np.array(
            [int(req_starts[hi] - req_starts[lo]) for lo, hi in block_ranges], np.int64
        )
        R_pad = (int(blk_req_len.max()) + 127) // 128 * 128
        req_entries = torch.from_numpy(ops.pack_entries([req_book])).to(device)
        # req blocks are small (block_lines * ~40 B); batch them so the
        # dispatch count stays low without exceeding the cell budget
        rbpb = max(_MAX_CELLS // max(R_pad, 1), 1)
        for r0 in range(0, n_blocks, rbpb):
            r1 = min(r0 + rbpb, n_blocks)
            g = np.zeros((r1 - r0, R_pad), np.int32)
            v = np.zeros((r1 - r0, R_pad), bool)
            for k in range(r0, r1):
                lo, hi = block_ranges[k]
                n = int(blk_req_len[k])
                g[k - r0, :n] = req_np[int(req_starts[lo]) : int(req_starts[hi])]
                v[k - r0, :n] = True
            req_payloads.extend(_payloads(ops.pack_cells(
                torch.from_numpy(g).to(device), torch.from_numpy(v).to(device), req_entries,
                0, 0, n_ctx=1, v4=False), stage))

    out = _assemble_container(
        version, block_lines, geo, esc_list, books, req_book, nsym,
        block_ranges, payloads, req_payloads,
        [len(s) for s in per_block_syms],
        ctx_meta=ctx_meta,
    )
    ENCODES[version] += 1
    return out


def vcfz_to_vcfc_device(vcfz: bytes, device=None) -> bytes | None:
    """.vcfz -> .vcfc bytes, the order-0 entropy decode on ``device`` (None:
    the CUDA device; raises without one).

    v1/v5 symbol payloads, v8's per-context sub-payloads (each order-0
    under its context's book, re-merged on the host by the O(symbols)
    context automaton) and the v3+ required-columns payloads decode
    block-parallel through ``device_unpack_symbols``; the host assembles
    the lines (``block_lines_vcfc``) from the decoded streams.  v2 and v3
    are context-coded streams, which the JAX package decodes on the host
    by design: they return None and the caller takes the host
    reconstruction.  v4, v6 and v7 need the vertical-match resolve on the
    device, not ported yet: they raise NotImplementedError."""
    device = engine._device(device)
    reader = VcfzReader.parse(vcfz)
    version = reader.version
    if version in (4, 6, 7):
        raise NotImplementedError(
            f".vcfz v{version} decodes through the vertical-match resolve on the device "
            "(_block_classpos, _resolve_blocks_device, resolve_match_grid), which is not "
            "ported to vcfc_tpu_torch yet: ROADMAP A.2.3; the host decode (route=None) "
            "decodes it"
        )
    if version not in DECODE_VERSIONS:
        return None
    base = reader.payload_base
    if version == 8:
        # context-SPLIT streams: every (block, context) sub-payload is
        # order-0 under its own book, decoded per book on the device
        per_ctx_payloads: list[list[bytes]] = [[] for _ in range(N_CTX)]
        per_ctx_counts: list[list[int]] = [[] for _ in range(N_CTX)]
        for blk in reader.blocks:
            off = base + blk["payload_off"]
            for c in range(N_CTX):
                pl = int(blk["ctx_plen"][c])
                per_ctx_payloads[c].append(bytes(reader.raw[off : off + pl]))
                per_ctx_counts[c].append(int(blk["ctx_nsym"][c]))
                off += pl
        per_ctx_syms = [
            device_unpack_symbols(per_ctx_payloads[c], per_ctx_counts[c], reader.books[c], device)
            for c in range(N_CTX)
        ]
        classes = reader._classes()
        sym_lists = [
            _merge_ctx_streams([per_ctx_syms[c][b] for c in range(N_CTX)], classes,
                               int(blk["n_symbols"]))
            for b, blk in enumerate(reader.blocks)
        ]
    else:
        payloads = [
            bytes(reader.raw[base + blk["payload_off"] : base + blk["payload_off"] + blk["payload_len"]])
            for blk in reader.blocks
        ]
        n_syms = [int(blk["n_symbols"]) for blk in reader.blocks]
        sym_lists = device_unpack_symbols(payloads, n_syms, reader.books[0], device)

    req_lists = None
    if version >= 3:
        req_payloads, n_req = [], []
        for b, blk in enumerate(reader.blocks):
            lo = b * reader.block_lines
            hi = min(lo + reader.block_lines, reader.n_lines)
            off = blk["req_payload_off"]
            req_payloads.append(bytes(reader.req_blob[off : off + blk["req_payload_len"]]))
            n_req.append(
                int(reader.req_starts[hi - 1]) + int(reader.req_lens[hi - 1])
                - int(reader.req_starts[lo])
                if hi > lo
                else 0
            )
        req_lists = device_unpack_symbols(req_payloads, n_req, reader.req_book, device)

    out = bytearray(reader.header_blob)
    for b in range(len(reader.blocks)):
        req_arg = None
        if req_lists is not None:
            lo = b * reader.block_lines
            req_arg = (
                req_lists[b].astype(np.uint8).tobytes(),
                int(reader.req_starts[lo]) if reader.n_lines else 0,
            )
        for line in reader.block_lines_vcfc(b, req=req_arg, symbols=sym_lists[b]):
            out += line
    DECODES[version] += 1
    return bytes(out)
