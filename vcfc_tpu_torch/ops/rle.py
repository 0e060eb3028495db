"""RLE codec on (lines x samples) genotype planes, in PyTorch.

The port of ``vcfc_tpu/ops/rle.py``: the same positional-flag
representation (each segment's flag byte at its LAST sample position, 0
elsewhere) and the same greedy 127/31/1 run caps.  ``rle_encode_plain``
and ``rle_decode_plain`` are plain PyTorch versions of ``rle_encode`` and
``rle_decode`` there, and ``text_rle_encode_plain`` /
``text_rle_decode_plain`` of ``text_rle_encode`` / ``text_rle_decode``
(the same codec on one little-endian int32 "a|b\\t" word per sample);
they are the spec that the CUDA kernels of ``cuda_rle`` are held to.

The public ``rle_encode`` / ``rle_decode`` / ``text_rle_encode`` /
``text_rle_decode`` dispatch on the tensor's device: a CPU tensor gets the
plain version, a CUDA tensor the kernel.  ``unpack_packed_flags`` (the
packed file flags to the positional plane) is the same PyTorch ops on
either device; ``unpack_rle_decode`` follows it with ``rle_decode``.

Genotype codes: 0="0|0", 1="0|1", 2="1|0", 3="1|1", 4=escape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.constants import (
    CODE_ESCAPE,
    SAMPLE_MASKED_01,
    SAMPLE_MASKED_10,
    SAMPLE_MASKED_11,
    SAMPLE_MASKED_UNCOMPRESSED,
)

from .cuda_rle import cuda_rle_decode, cuda_rle_encode, cuda_text_decode, cuda_text_encode

_BIG = 0x7FFFFFFF  # reverse-min sentinel: its low byte 0xFF decodes as an escape


def _flag_base(c: torch.Tensor) -> torch.Tensor:
    """Flag-byte base value per code (int32 in, int32 out)."""
    base = torch.full_like(c, SAMPLE_MASKED_UNCOMPRESSED)
    base = torch.where(c == 3, SAMPLE_MASKED_11, base)
    base = torch.where(c == 2, SAMPLE_MASKED_10, base)
    base = torch.where(c == 1, SAMPLE_MASKED_01, base)
    return torch.where(c == 0, 0, base)


def _columns(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]


def rle_encode_plain(codes: torch.Tensor, n_samples: int):
    """Encode a (L, S_pad) uint8 code plane into positional flag bytes.

    Columns >= ``n_samples`` are padding and produce no flags.
    Returns (flagpos (L, S_pad) uint8, nseg (L,) int32)."""
    c = codes.to(torch.int32)
    idx = _columns(c)
    prev = torch.cat([torch.full_like(c[:, :1], -1), c[:, :-1]], dim=1)
    new_run = (c != prev) | (c == CODE_ESCAPE) | (prev == CODE_ESCAPE)
    run_start = torch.cummax(torch.where(new_run, idx, -1), dim=1).values
    d = idx - run_start
    rem = torch.where(c == 0, d % 127, d % 31)
    boundary = (rem == 0) & (idx < n_samples)
    next_boundary = torch.cat([boundary[:, 1:], torch.zeros_like(boundary[:, :1])], dim=1)
    last = next_boundary | (idx == n_samples - 1)
    flagpos = torch.where(last, _flag_base(c) | (rem + 1), 0).to(torch.uint8)
    nseg = boundary.sum(dim=1, dtype=torch.int32)
    return flagpos, nseg


def _next_set_scan(values: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Each position takes the next present value at or after it, by one
    reverse cummin over (position << 8) | value keys; positions after the
    last present one take 0xFF."""
    if values.shape[1] >= (1 << 23):
        raise ValueError(f"sample width {values.shape[1]} exceeds the packed-scan range")
    packed = torch.where(present, (_columns(values) << 8) | values.to(torch.int32), _BIG)
    filled = torch.cummin(packed.flip(1), dim=1).values.flip(1)
    return filled & 0xFF


def rle_decode_plain(flagpos: torch.Tensor, n_samples: int):
    """Decode positional flag bytes back to codes.

    Returns (codes (L, S_pad) uint8, decoded (L,) int32 — the samples the
    flags cover below ``n_samples``, == n_samples iff the row is well-formed)."""
    present = flagpos > 0
    filled = _next_set_scan(flagpos, present)
    masked = filled & 0xE0
    code = torch.full_like(filled, 3)
    code = torch.where(masked == SAMPLE_MASKED_10, 2, code)
    code = torch.where(masked == SAMPLE_MASKED_01, 1, code)
    code = torch.where(masked == 0xE0, CODE_ESCAPE, code)
    code = torch.where((filled & 0x80) == 0, 0, code).to(torch.uint8)

    fi = flagpos.to(torch.int32)
    run_len = torch.where((fi & 0xE0) == 0xE0, 1, fi & 0x1F)
    run_len = torch.where((fi & 0x80) == 0, fi & 0x7F, run_len)
    valid = _columns(fi) < n_samples
    decoded = (run_len * valid).sum(dim=1, dtype=torch.int32)
    return code, decoded


def _classify_words(text: torch.Tensor):
    """(L, S_pad) int32 little-endian "a|b<sep>" words -> (codes int32,
    separator byte int32).  A word is 2a + b when a and b are '0' or '1'
    and its middle byte is '|', and an escape (4) otherwise: the
    reference's four-GT match (compress.cpp:126-170)."""
    b0 = text & 0xFF
    b1 = (text >> 8) & 0xFF
    b2 = (text >> 16) & 0xFF
    sep = (text >> 24) & 0xFF
    valid = (((b0 - 48) & ~1) == 0) & (b1 == 124) & (((b2 - 48) & ~1) == 0)
    return torch.where(valid, (b0 - 48) * 2 + (b2 - 48), CODE_ESCAPE), sep


def _render_words(code: torch.Tensor, n_samples: int) -> torch.Tensor:
    """int32 codes -> int32 "a|b<sep>" words: escapes render the "?|?"
    placeholder, the separator is '\\n' at sample n - 1 and '\\t' elsewhere."""
    esc = code == CODE_ESCAPE
    b0 = torch.where(esc, 63, 48 + (code >> 1))
    b2 = torch.where(esc, 63, 48 + (code & 1))
    sep = torch.where(_columns(code) == n_samples - 1, 10, 9).to(torch.int32)
    return b0 | (124 << 8) | (b2 << 16) | (sep << 24)


def text_rle_encode_plain(text: torch.Tensor, n_samples: int):
    """Classify (L, S_pad) int32 text words, then RLE-encode the codes.

    Returns (flagpos (L, S_pad) uint8, nseg (L,) int32, seps_ok (L,)
    int32): seps_ok is 0 where a separator before sample n - 1 is not a
    tab, which marks a mis-sliced line."""
    codes, sep = _classify_words(text)
    ok = torch.where(_columns(text) < n_samples - 1, (sep == 9).to(torch.int32), 1)
    flagpos, nseg = rle_encode_plain(codes.to(torch.uint8), n_samples)
    return flagpos, nseg, ok.amin(dim=1)


def text_rle_decode_plain(flagpos: torch.Tensor, n_samples: int):
    """RLE-decode (L, S_pad) uint8 flags, then render each code as a word.

    Returns (text (L, S_pad) int32 words, codes (L, S_pad) uint8,
    decoded (L,) int32)."""
    code, decoded = rle_decode_plain(flagpos, n_samples)
    return _render_words(code.to(torch.int32), n_samples), code, decoded


def _dispatch(x: torch.Tensor, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"no RLE kernel for device {x.device}")


def rle_encode(codes: torch.Tensor, n_samples: int):
    """(L, S_pad) uint8 codes -> (flagpos uint8, nseg int32): the plain
    version on a CPU tensor, the CUDA kernel K1 on a CUDA tensor."""
    return _dispatch(codes, rle_encode_plain, cuda_rle_encode)(codes, n_samples)


def rle_decode(flagpos: torch.Tensor, n_samples: int):
    """(L, S_pad) uint8 flags -> (codes uint8, decoded int32): the plain
    version on a CPU tensor, the CUDA kernel K2 on a CUDA tensor."""
    return _dispatch(flagpos, rle_decode_plain, cuda_rle_decode)(flagpos, n_samples)


def text_rle_encode(text: torch.Tensor, n_samples: int):
    """(L, S_pad) int32 words -> (flagpos uint8, nseg int32, seps_ok
    int32): the plain version on a CPU tensor, K3 on a CUDA tensor."""
    return _dispatch(text, text_rle_encode_plain, cuda_text_encode)(text, n_samples)


def text_rle_decode(flagpos: torch.Tensor, n_samples: int):
    """(L, S_pad) uint8 flags -> (text int32 words, codes uint8, decoded
    int32): the plain version on a CPU tensor, K4 on a CUDA tensor."""
    return _dispatch(flagpos, text_rle_decode_plain, cuda_text_decode)(flagpos, n_samples)


def unpack_packed_flags(flags: torch.Tensor, nflags: torch.Tensor, out_width: int):
    """Packed (left-aligned) flag bytes -> the positional plane: the port
    of ``vcfc_tpu.ops.rle.unpack_packed_flags``.

    ``flags`` is (L, M) uint8, 0-padded; ``nflags`` (L,) int32 holds each
    line's flag count.  Flag slot j lands at end_j = cumsum(run_len)_j - 1,
    the last sample of its segment.  Slots past the count, with a zero run
    length (0x80, 0xA0, ...) or ending at or past ``out_width`` are dropped:
    they are scattered to one sink cell after the plane, which is then cut
    off.  Returns (L, out_width) uint8."""
    L, M = flags.shape
    fi = flags.to(torch.int32)
    valid = torch.arange(M, dtype=torch.int32, device=flags.device)[None, :] < nflags[:, None]
    run_len = torch.where((fi & 0xE0) == 0xE0, 1, fi & 0x1F)
    run_len = torch.where((fi & 0x80) == 0, fi & 0x7F, run_len)
    run_len = torch.where(valid, run_len, 0)
    ends = torch.cumsum(run_len, dim=1, dtype=torch.int32) - 1
    ok = valid & (run_len > 0) & (ends < out_width)
    rows = torch.arange(L, dtype=torch.int64, device=flags.device)[:, None] * out_width
    sink = L * out_width
    target = torch.where(ok, rows + ends.to(torch.int64), sink)
    out = torch.zeros(sink + 1, dtype=torch.uint8, device=flags.device)
    out.scatter_(0, target.reshape(-1), flags.reshape(-1))
    return out[:sink].view(L, out_width)


def unpack_rle_decode(flags: torch.Tensor, nflags: torch.Tensor, n_samples: int, out_width: int):
    """Decode from packed file flag bytes: ``unpack_packed_flags``, then
    ``rle_decode`` (K2 on a CUDA tensor).  Returns (codes (L, out_width)
    uint8, decoded (L,) int32)."""
    return rle_decode(unpack_packed_flags(flags, nflags, out_width), n_samples)


def render_text(codes) -> np.ndarray:
    """ASCII "a|b\\t" per code, (L, S_pad) -> (L, 4 * S_pad) uint8 (the
    render of the numpy host path; the native renderer works from codes)."""
    lut = np.zeros((5, 4), np.uint8)
    for c, s in enumerate([b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t", b"?|?\t"]):
        lut[c] = np.frombuffer(s, np.uint8)
    codes = np.asarray(codes)
    L, S_pad = codes.shape
    return lut[codes].reshape(L, S_pad * 4)
