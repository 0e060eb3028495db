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
assembly are the same.  On a CUDA device the batches overlap: pinned
staging buffers, a copy stream for the H2D copies and a compute stream for
the kernel and the D2H copies, ordered by events (``_pipeline``), so the
host stages a batch while the ones before it are on the card.  ``compress_sharded`` / ``decompress_sharded`` run the
sharded steps of ``parallel.shard`` over a mesh of local devices.  Output
is byte-for-byte the reference encoder's, like ``vcfc_tpu.engine``'s.

Every public function takes ``device``: None means ``cuda``, and raises
when PyTorch sees no CUDA device; ``"cpu"`` runs the plain PyTorch kernels
one batch after the other.  The sharded functions take ``mesh`` instead:
None means every visible CUDA device.
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
from .parallel.mesh import make_data_mesh
from .parallel.shard import make_sharded_decode_step, make_sharded_encode_step

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


_SLOTS = 3  # staging buffers a call: the host stages a batch while two are on the card


def _stage(bufs, lo, hi, line_batch, stage) -> None:
    if hi - lo < line_batch:  # rows a fuller batch left behind
        for buf in bufs:
            buf[hi - lo :] = 0
    stage(lo, hi, bufs)


class _Slot:
    """One batch in flight: pinned staging buffers, device inputs, and the
    events that order their reuse."""

    def __init__(self, inputs, line_batch: int, device: torch.device):
        self.host_in = [torch.zeros((line_batch, *shape), dtype=dtype, pin_memory=True)
                        for shape, dtype in inputs]
        self.device_in = [torch.empty_like(h, device=device) for h in self.host_in]
        self.host_out = None  # pinned, shaped at the first fetch
        self.loaded = torch.cuda.Event()  # H2D of host_in done
        self.fetched = torch.cuda.Event()  # the kernel and its D2H into host_out done


def _pipeline(L, line_batch, device, inputs, stage, kernel, outputs) -> None:
    """``_run_batches`` on a CUDA device: H2D on a copy stream, the kernel
    and its D2H into pinned memory on a compute stream, ordered by events,
    so the host stages batch i + 1 while batch i is on the card.  The host
    rewrites a pinned input only once its last H2D has completed, and reads
    a D2H result only once it has landed; a device input is rewritten only
    once the kernel that read it has run.  The kernel's outputs are made
    and copied out on the compute stream, so the allocator may reuse them
    as soon as the copy is queued."""
    copy_in, compute = torch.cuda.Stream(device), torch.cuda.Stream(device)
    slots = [_Slot(inputs, line_batch, device) for _ in range(min(_SLOTS, -(-L // line_batch)))]
    pending = []
    # the device inputs may reuse memory the caller's stream still reads
    copy_in.wait_stream(torch.cuda.current_stream(device))

    def fetch():
        lo, hi, slot = pending.pop(0)
        slot.fetched.synchronize()
        for plane, host in zip(outputs, slot.host_out):
            # torch's copy runs on the intra-op threads (numpy's on one)
            torch.from_numpy(plane[lo:hi]).copy_(host[: hi - lo])

    try:
        for b, lo in enumerate(range(0, L, line_batch)):
            hi = min(lo + line_batch, L)
            slot = slots[b % len(slots)]
            slot.loaded.synchronize()
            _stage([h.numpy() for h in slot.host_in], lo, hi, line_batch, stage)
            copy_in.wait_event(slot.fetched)  # the slot's last kernel has read device_in
            with torch.cuda.stream(copy_in):
                for dev, host in zip(slot.device_in, slot.host_in):
                    dev.copy_(host, non_blocking=True)
            slot.loaded.record(copy_in)
            compute.wait_event(slot.loaded)
            with torch.cuda.stream(compute):
                results = kernel(*slot.device_in)
                if slot.host_out is None:
                    slot.host_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                                     for o in results]
                for host, out in zip(slot.host_out, results):  # the slot was fetched
                    host.copy_(out, non_blocking=True)
            slot.fetched.record(compute)
            pending.append((lo, hi, slot))
            if len(pending) == len(slots):
                fetch()
        while pending:
            fetch()
    finally:  # nothing in flight may outlive the buffers
        copy_in.synchronize()
        compute.synchronize()


def _run_batches(L, line_batch, device, inputs, stage, kernel, outputs) -> None:
    """Run ``kernel`` over the rows [0, L) in batches of ``line_batch`` rows.

    ``inputs`` lists the kernel's inputs as (row shape, torch dtype): each
    batch, ``stage(lo, hi, bufs)`` fills rows [0, hi - lo) of one
    (line_batch, *shape) numpy buffer per input; the buffers' other rows
    and every cell ``stage`` does not write are zero.  ``kernel(*tensors)``
    returns a tuple of (line_batch, ...) tensors; rows [0, hi - lo) of the
    k-th land in rows [lo, hi) of the numpy plane ``outputs[k]``.  On a
    CUDA device the batches overlap (``_pipeline``); on the CPU they run
    one after the other."""
    device = torch.device(device)
    if device.type == "cuda":
        _pipeline(L, line_batch, device, inputs, stage, kernel, outputs)
        return
    bufs = [torch.zeros((line_batch, *shape), dtype=dtype) for shape, dtype in inputs]
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        _stage([b.numpy() for b in bufs], lo, hi, line_batch, stage)
        for plane, out in zip(outputs, kernel(*(b.to(device) for b in bufs))):
            plane[lo:hi] = out[: hi - lo].cpu().numpy()


def encode_on_device(codes: np.ndarray, S: int, line_batch: int, device) -> tuple:
    """RLE-encode (L, >= S) codes batch by batch (H2D copy, K1, D2H copy).

    Returns (flagpos (L, S_pad) uint8, nseg (L,) int32)."""
    L = codes.shape[0]
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo, :S] = codes[lo:hi, :S]

    _run_batches(L, line_batch, device, [((S_pad,), torch.uint8)], stage,
                 lambda batch: rle_encode(batch, S), [flagpos, nseg])
    return flagpos, nseg


def decode_on_device(flags: np.ndarray, S: int, line_batch: int, device) -> tuple:
    """RLE-decode (L, W) positional flags batch by batch (H2D copy, K2,
    D2H copy).  Returns (codes (L, S_pad) uint8, decoded (L,) int32)."""
    L, W = flags.shape
    S_pad = max(_round_up(max(S, W), 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo, :W] = flags[lo:hi]

    _run_batches(L, line_batch, device, [((S_pad,), torch.uint8)], stage,
                 lambda batch: rle_decode(batch, S), [codes, decoded])
    return codes, decoded


def encode_text_on_device(body: np.ndarray, sample_start: np.ndarray, irregular: np.ndarray,
                          S: int, line_batch: int, device) -> tuple:
    """Gather each batch's genotype text (``native.gather_text``, one
    "a|b\\t" word per sample; irregular lines stay zero), then classify and
    RLE-encode it (H2D copy, K3, D2H copy); on a CUDA device the gather of
    a batch runs while the batches before it are on the card.  Returns
    (flagpos (L, S_pad) uint8, nseg (L,) int32, seps_ok (L,) int32)."""
    L = len(sample_start)
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    seps = np.ones(L, np.int32)

    def stage(lo, hi, bufs):
        # padded per-batch views; pad rows are marked irregular and stay zero
        ss = np.zeros(line_batch, np.int64)
        ss[: hi - lo] = sample_start[lo:hi]
        ir = np.ones(line_batch, np.uint8)
        ir[: hi - lo] = irregular[lo:hi]
        native.gather_text(body, ss, ir, S, S_pad, out=bufs[0])

    _run_batches(L, line_batch, device, [((4 * S_pad,), torch.uint8)], stage,
                 lambda text: text_rle_encode(text.view(torch.int32), S), [flagpos, nseg, seps])
    return flagpos, nseg, seps


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
    flagpos, nseg, seps = encode_text_on_device(body, sample_start, irregular, S, line_batch,
                                                device)
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

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo, :W] = flags[lo:hi]

    def kernel(batch):
        words, _codes, n = text_rle_decode(batch, S)
        return words, n

    _run_batches(L, line_batch, device, [((S_pad,), torch.uint8)], stage, kernel,
                 [text.view(np.int32), decoded])
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

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo] = packed[lo:hi]
        bufs[1][: hi - lo] = nflags[lo:hi]

    _run_batches(L, line_batch, device, [((M,), torch.uint8), ((), torch.int32)], stage,
                 lambda batch, counts: unpack_rle_decode(batch, counts, S, out_width=S_pad),
                 [codes, decoded])
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


# ---------------------------------------------------------------------------
# Sharded codec: the encode and decode steps of parallel.shard over a mesh of
# local devices (data parallelism across the line axis), byte-identical to
# compress / decompress.


def _shard_chunk(s_pad: int, n_dev: int) -> int:
    """Lines a sharded step takes at once: the single-device batch cap,
    rounded up to 256 rows a shard."""
    return _round_up(max(_adaptive_line_batch(_LINE_BATCH, s_pad), 1), 256 * n_dev)


def compress_sharded(vcf: bytes, mesh=None) -> bytes:
    """Compress with the encode step sharded over ``mesh`` (devices; every
    visible CUDA device by default): host parse, the sharded K1 step chunk
    by chunk, native assembly.  Byte-identical to ``compress``; like the
    JAX package's, it takes the parse route and has no min-cells gate."""
    parsed = parse_vcf_bytes(vcf)
    L, S = parsed.n_lines, parsed.n_samples
    if L == 0 or S == 0:
        return compress_bytes(vcf)
    mesh = make_data_mesh(devices=mesh)
    S_pad = max(_round_up(S, 128), 128)
    chunk = _shard_chunk(S_pad, len(mesh))
    step = make_sharded_encode_step(mesh, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo, :S] = parsed.codes[lo:hi]

    # chunks staged on the host, one after the other: the step moves each
    # shard to its device and returns once every shard is done
    _run_batches(L, chunk, "cpu", [((S_pad,), torch.uint8)], stage,
                 lambda codes: step(codes, S)[:2], [flagpos, nseg])
    if native.available():
        return fast.assemble_vcfc_native(parsed, flagpos, nseg)
    return assemble_vcfc(parsed, flagpos, nseg)


def decompress_sharded(vcfc: bytes, mesh=None) -> bytes:
    """Decompress with the decode step sharded over ``mesh``: .vcfc parse,
    the sharded K2 step chunk by chunk, render.  Byte-identical to
    ``decompress`` (the reference's sequential spec: decompress2_fd,
    compress.cpp:1214)."""
    use_native = native.available()
    parsed = fast.parse_vcfc_native(vcfc) if use_native else parse_vcfc_bytes(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0:
        return decompress_bytes(vcfc)
    mesh = make_data_mesh(devices=mesh)
    W = parsed.flags.shape[1]
    S_pad = max(_round_up(max(S, W), 128), 128)
    chunk = _shard_chunk(S_pad, len(mesh))
    step = make_sharded_decode_step(mesh, S_pad)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)

    def stage(lo, hi, bufs):
        bufs[0][: hi - lo, :W] = parsed.flags[lo:hi]

    _run_batches(L, chunk, "cpu", [((S_pad,), torch.uint8)], stage,
                 lambda flags: step(flags, S), [codes, decoded])
    if use_native:
        return fast.assemble_vcf_native(parsed, codes, decoded)
    return assemble_vcf(parsed, render_text(codes), decoded)
