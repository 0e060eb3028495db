"""End-to-end .vcfc codec on a PyTorch device: the port of ``vcfc_tpu/engine.py``.

``compress`` is host parse -> RLE encode on the device (K1) -> native
assembly; ``decompress`` is native .vcfc parse -> RLE decode on the device
(K2) -> native render.  Under ``VCFC_PARSE=device`` (with the native
runtime) the text route runs instead: compress gathers each line's
genotype text and classifies and encodes it on the device (K3), and
decompress decodes and renders the text on the device (K4), which the host
then memcpys.  Under ``VCFC_UNPACK=device`` (with the native runtime)
decompress takes the packed-unpack route: the host extracts each line's
packed flag bytes, and the device unpacks them to the positional plane and
decodes it (K2).  The host layers are the port's own ``host`` and ``format``
packages, copies of ``vcfc_tpu``'s.  Lines go to the device in
zero-padded batches of the JAX engine's layout (multiples of 256 rows by
``S_pad = round_up(S, 128)`` columns), so the planes handed to the native
assembly are the same.  Output is byte-for-byte the reference encoder's,
like ``vcfc_tpu.engine``'s.

Every public function takes ``device``: None means ``cuda``, and raises
when PyTorch sees no CUDA device; ``"cpu"`` runs the plain PyTorch kernels.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .format.headers import decode_line_headers
from .format.lines import VcfValidationError
from .format.vcf import compress_bytes, decompress_bytes, parse_metadata_headers
from .host import fast, native
from .host.assemble import assemble_vcf, assemble_vcfc, parse_vcfc_bytes
from .host.parse import ParsedVcf, parse_vcf_bytes
from .ops.rle import (
    render_text,
    rle_decode,
    rle_encode,
    text_rle_decode,
    text_rle_encode,
    unpack_rle_decode,
)

_LINE_BATCH = 2048  # a multiple of the 256-row batch granularity
# Below this many genotype cells the device round trip costs more than the
# host oracle; such inputs go to the oracle.
_DEVICE_MIN_CELLS = 1 << 18
# Cap genotype cells per device batch: wide cohorts shrink the line batch
# instead of growing the buffer (~64 MB per uint8 batch at any width).
_TARGET_BATCH_CELLS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _force_device(flag: bool) -> bool:
    """VCFC_FORCE_DEVICE=1 disables the min-cells gate, so that the device
    route runs even on tiny inputs."""
    return flag or os.environ.get("VCFC_FORCE_DEVICE", "") not in ("", "0")


def _adaptive_line_batch(line_batch: int, s_pad: int) -> int:
    """Shrink the line batch for wide sample axes so a batch holds at most
    ~_TARGET_BATCH_CELLS cells (a multiple of 256 rows, at least 256)."""
    cap = _TARGET_BATCH_CELLS // s_pad // 256 * 256
    return max(256, min(line_batch, cap))


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible to PyTorch: pass device='cpu' to run "
                "the plain PyTorch kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def _text_route() -> bool:
    return native.available() and os.environ.get("VCFC_PARSE") == "device"


def encode_on_device(codes: np.ndarray, S: int, line_batch: int, device) -> tuple:
    """RLE-encode (L, >= S) codes batch by batch (H2D copy, K1, D2H copy).

    Returns (flagpos (L, S_pad) uint8, nseg (L,) int32)."""
    L = codes.shape[0]
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, S_pad), np.uint8)
        batch[: hi - lo, :S] = codes[lo:hi, :S]
        f, k = rle_encode(torch.from_numpy(batch).to(device), S)
        flagpos[lo:hi] = f[: hi - lo].cpu().numpy()
        nseg[lo:hi] = k[: hi - lo].cpu().numpy()
    return flagpos, nseg


def decode_on_device(flags: np.ndarray, S: int, line_batch: int, device) -> tuple:
    """RLE-decode (L, W) positional flags batch by batch (H2D copy, K2,
    D2H copy).  Returns (codes (L, S_pad) uint8, decoded (L,) int32)."""
    L, W = flags.shape
    S_pad = max(_round_up(max(S, W), 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, S_pad), np.uint8)
        batch[: hi - lo, :W] = flags[lo:hi]
        c, d = rle_decode(torch.from_numpy(batch).to(device), S)
        codes[lo:hi] = c[: hi - lo].cpu().numpy()
        decoded[lo:hi] = d[: hi - lo].cpu().numpy()
    return codes, decoded


def encode_text_on_device(text: np.ndarray, S: int, device) -> tuple:
    """Classify and RLE-encode one batch of gathered genotype text (H2D
    copy, K3, D2H copy): ``text`` is (B, 4 * S_pad) uint8, one "a|b\\t"
    word per sample.  Returns (flagpos (B, S_pad) uint8, nseg (B,) int32,
    seps_ok (B,) int32)."""
    f, k, r = text_rle_encode(torch.from_numpy(text).view(torch.int32).to(device), S)
    return f.cpu().numpy(), k.cpu().numpy(), r.cpu().numpy()


def compress_device_text(vcf: bytes, line_batch: int, force_device: bool, device) -> bytes | None:
    """The VCFC_PARSE=device compress route: the host indexes the lines and
    gathers each batch's genotype text (memcpy-class work), the device
    classifies and encodes it (K3), and native assembly splices escapes
    straight from the text.  Replaces the reference's per-sample scan
    (compress.cpp:124-186).  Returns None to fall back (tiny input)."""
    header = parse_metadata_headers(vcf)
    S = header.schema.sample_count
    raw_np = np.frombuffer(vcf, np.uint8)
    line_start, line_end, sample_start = native.index_lines(raw_np, header.data_offset)
    keep = line_end > line_start  # drop empty lines (compress.cpp:219-221)
    line_start, line_end = line_start[keep], line_end[keep]
    sample_start = sample_start[keep]
    body = raw_np[header.data_offset :]
    L = len(line_start)
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None
    if (sample_start < 0).any():
        bad = int(np.flatnonzero(sample_start < 0)[0])
        raise VcfValidationError(f"data line {bad} has no FORMAT column (fewer than 9 tabs)")
    irregular = (line_end - sample_start) != (4 * S - 1)
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    seps = np.ones(L, np.int32)
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        # padded per-batch views; pad rows are marked irregular and stay zero
        ss = np.zeros(line_batch, np.int64)
        ss[: hi - lo] = sample_start[lo:hi]
        ir = np.ones(line_batch, np.uint8)
        ir[: hi - lo] = irregular[lo:hi]
        text = native.gather_text(body, ss, ir, S, S_pad)
        f, k, r = encode_text_on_device(text, S, device)
        flagpos[lo:hi] = f[: hi - lo]
        nseg[lo:hi] = k[: hi - lo]
        seps[lo:hi] = r[: hi - lo]
    # rows whose separator bytes are not tabs were mis-sliced: oracle path
    irregular |= seps == 0
    # the native assembly never reads codes (it splices escape ASCII
    # straight from the text); a (0, S) array just carries the width
    parsed = ParsedVcf(
        header, body, line_start, line_end, sample_start, np.zeros((0, S), np.uint8), irregular
    )
    return fast.assemble_vcfc_native(parsed, flagpos, nseg)


def decode_text_on_device(flags: np.ndarray, S: int, line_batch: int, device) -> tuple:
    """RLE-decode (L, W) positional flags and render the text batch by
    batch (H2D copy, K4, D2H copy).  Returns (text (L, 4 * S_pad) uint8,
    the little-endian bytes of the words, decoded (L,) int32)."""
    L, W = flags.shape
    S_pad = max(_round_up(max(S, W), 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    text = np.zeros((L, 4 * S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, S_pad), np.uint8)
        batch[: hi - lo, :W] = flags[lo:hi]
        t, _c, d = text_rle_decode(torch.from_numpy(batch).to(device), S)
        text[lo:hi] = t[: hi - lo].cpu().numpy().view(np.uint8)
        decoded[lo:hi] = d[: hi - lo].cpu().numpy()
    return text, decoded


def decompress_device_text(parsed, line_batch: int, force_device: bool, device) -> bytes | None:
    """The VCFC_PARSE=device decompress route: the device decodes and
    renders "a|b\\t" words (K4); native assembly memcpys the text plane and
    splices escapes over the "?|?" placeholders, with no host render pass.
    The D2H copy moves 4 text bytes a sample instead of 1 code byte.
    Returns None to fall back (tiny input)."""
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None
    text, decoded = decode_text_on_device(parsed.flags, S, line_batch, device)
    return fast.assemble_vcf_from_text(parsed, text, decoded)


def unpack_decode_on_device(packed: np.ndarray, nflags: np.ndarray, S: int, line_batch: int,
                            device) -> tuple:
    """Unpack (L, M) packed flag bytes to the positional plane and
    RLE-decode it, batch by batch (H2D copy of the packed bytes and the
    counts, unpack, K2, D2H copy).  Returns (codes (L, S_pad) uint8,
    decoded (L,) int32)."""
    L, M = packed.shape
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, M), np.uint8)
        batch[: hi - lo] = packed[lo:hi]
        counts = np.zeros(line_batch, np.int32)
        counts[: hi - lo] = nflags[lo:hi]
        c, d = unpack_rle_decode(torch.from_numpy(batch).to(device),
                                 torch.from_numpy(counts).to(device), S, out_width=S_pad)
        codes[lo:hi] = c[: hi - lo].cpu().numpy()
        decoded[lo:hi] = d[: hi - lo].cpu().numpy()
    return codes, decoded


def decompress_device_unpack(vcfc: bytes, line_batch: int, force_device: bool, device):
    """The VCFC_UNPACK=device decompress route: the host extracts PACKED
    flag bytes (O(compressed size)), and the device unpacks them to the
    positional plane and decodes it (``unpack_decode_on_device``), so no
    O(L * W) positional plane is built on the host.  The packed width M is
    set by the longest line body in the file.  Returns (bytes, None), or
    (None, scan) to fall back (tiny input): the scan tuple spares the
    fallback parse the header parse and stream scan already paid."""
    # cheap pre-gate (header + native scan) BEFORE the packed extraction:
    # a declining call must not pay the full parse twice
    scan = fast.scan_vcfc_stream(vcfc)
    header, line_off = scan[0], scan[1]
    S = header.schema.sample_count
    L = len(line_off)
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None, scan
    parsed = fast.parse_vcfc_packed_native(vcfc, scan=scan)
    codes, decoded = unpack_decode_on_device(parsed.flags, parsed.nflags, S, line_batch, device)
    return fast.assemble_vcf_native(parsed, codes, decoded), None


def compress(
    vcf: bytes, line_batch: int = _LINE_BATCH, force_device: bool = False, device=None
) -> bytes:
    """VCF bytes -> .vcfc bytes: parse -> RLE encode on the device -> assemble."""
    device = _device(device)
    force_device = _force_device(force_device)
    line_batch = _round_up(max(line_batch, 1), 256)
    if _text_route():
        out = compress_device_text(vcf, line_batch, force_device, device)
        if out is not None:
            return out
    parsed = parse_vcf_bytes(vcf)
    L, S = parsed.n_lines, parsed.n_samples
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return compress_bytes(vcf)

    if native.available() and os.environ.get("VCFC_EXECUTOR", "device") == "host":
        flagpos, nseg = native.rle_encode_host(parsed.codes, S)
    else:
        flagpos, nseg = encode_on_device(parsed.codes, S, line_batch, device)

    if native.available():
        return fast.assemble_vcfc_native(parsed, flagpos, nseg)
    return assemble_vcfc(parsed, flagpos, nseg)


def decompress(
    vcfc: bytes, line_batch: int = _LINE_BATCH, force_device: bool = False, device=None
) -> bytes:
    """.vcfc bytes -> VCF bytes: unpack -> RLE decode on the device -> render."""
    device = _device(device)
    force_device = _force_device(force_device)
    line_batch = _round_up(max(line_batch, 1), 256)
    use_native = native.available()
    scan = None
    if use_native and os.environ.get("VCFC_UNPACK") == "device":
        out, scan = decompress_device_unpack(vcfc, line_batch, force_device, device)
        if out is not None:
            return out
    if use_native:
        parsed = fast.parse_vcfc_native(vcfc, scan=scan)
        if _text_route():
            out = decompress_device_text(parsed, line_batch, force_device, device)
            if out is not None:
                return out
    else:
        parsed = parse_vcfc_bytes(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return decompress_bytes(vcfc)

    if use_native and os.environ.get("VCFC_EXECUTOR", "device") == "host":
        # host executor: thread-parallel run-fill in C++
        codes = native.expand_codes(parsed.flags, S)
        decoded = np.full(L, S, np.int32)  # the unpack already validated the rows
    else:
        codes, decoded = decode_on_device(parsed.flags, S, line_batch, device)

    if use_native:
        return fast.assemble_vcf_native(parsed, codes, decoded)
    return assemble_vcf(parsed, render_text(codes), decoded)


# ---------------------------------------------------------------------------
# Streaming file codec: the same engine over bounded line-aligned chunks, so
# inputs larger than memory work.  Every data line is self-contained, so the
# chunks' outputs concatenate to the whole-buffer engine's bytes.

_STREAM_CHUNK = 64 << 20  # default chunk; VCFC_STREAM_CHUNK overrides


def _stream_chunk(chunk_bytes: int | None) -> int:
    if chunk_bytes:
        return max(int(chunk_bytes), 1 << 12)
    return max(int(os.environ.get("VCFC_STREAM_CHUNK", _STREAM_CHUNK)), 1 << 12)


def _open_pair(src, dst):
    """(src, dst) as binary file objects; paths are opened here and closed
    by the caller through the returned closers."""
    closers = []
    if isinstance(src, (str, bytes, os.PathLike)):
        src = open(src, "rb")
        closers.append(src)
    if isinstance(dst, (str, bytes, os.PathLike)):
        dst = open(dst, "wb")
        closers.append(dst)
    return src, dst, closers


def _read_header_lines(f):
    """Consume the '#' header lines of a stream; returns (header,
    header_blob, carry), where carry holds the bytes past the header that
    readline() consumed (only ever prepended to the first chunk)."""
    lines = []
    carry = b""
    while True:
        line = f.readline()
        if not line:
            break
        if line[:1] == b"#":
            lines.append(line)
        else:
            carry = line
            break
    header_blob = b"".join(lines)
    header = parse_metadata_headers(header_blob)  # validates + sample count
    return header, header_blob, carry


def compress_stream(src, dst, chunk_bytes: int | None = None, device=None) -> int:
    """Chunked compress of a VCF path or stream into a .vcfc path or
    stream, byte-identical to ``compress`` of the whole file.  Returns the
    number of compressed bytes written."""
    device = _device(device)
    chunk = _stream_chunk(chunk_bytes)
    fin, fout, closers = _open_pair(src, dst)
    try:
        _header, header_blob, carry = _read_header_lines(fin)
        fout.write(header_blob)
        written = hb = len(header_blob)
        eof = False
        while not eof or carry:
            data = fin.read(chunk)
            if not data:
                eof = True
            buf = carry + data
            if not buf:
                break
            if eof:
                piece, carry = buf, b""
            else:
                cut = buf.rfind(b"\n")
                if cut < 0:  # a single line longer than the chunk: grow
                    carry = buf
                    continue
                piece, carry = buf[: cut + 1], buf[cut + 1 :]
            if not piece:
                continue
            out = compress(header_blob + piece, device=device)
            fout.write(out[hb:])
            written += len(out) - hb
        return written
    finally:
        for f in closers:
            f.close()


def decompress_stream(src, dst, chunk_bytes: int | None = None, device=None) -> int:
    """Chunked decompress of a .vcfc path or stream into a VCF path or
    stream, split at compressed-line boundaries by hopping the 4-byte
    length headers.  Byte-identical to ``decompress`` of the whole file;
    returns the bytes written."""
    device = _device(device)
    chunk = _stream_chunk(chunk_bytes)
    fin, fout, closers = _open_pair(src, dst)
    try:
        _header, header_blob, carry = _read_header_lines(fin)
        fout.write(header_blob)
        written = hb = len(header_blob)
        eof = False
        while not eof or carry:
            data = fin.read(chunk)
            if not data:
                eof = True
            buf = carry + data
            if not buf:
                break
            # complete compressed lines only: a line is 4 + line_length
            # bytes and starts with both 4-byte headers
            pos, n = 0, len(buf)
            while pos + 8 <= n:
                line_length, _req = decode_line_headers(buf, pos)
                if pos + 4 + line_length > n:
                    break
                pos += 4 + line_length
            if pos == 0:
                if eof:
                    raise VcfValidationError("truncated .vcfc stream: partial line at EOF")
                carry = buf  # a line longer than the chunk: grow
                continue
            piece, carry = buf[:pos], buf[pos:]
            text = decompress(header_blob + piece, device=device)
            fout.write(text[hb:])
            written += len(text) - hb
        if carry:
            raise VcfValidationError("truncated .vcfc stream: partial line at EOF")
        return written
    finally:
        for f in closers:
            f.close()
