"""Sharded codec steps over a mesh of local devices: the port of the
``.vcfc`` steps of ``vcfc_tpu/parallel/shard.py``.

Each ``make_sharded_*_step(mesh, ...)`` returns a callable with the JAX
step's arguments and outputs.  It splits the rows of its sharded inputs
into ``len(mesh)`` contiguous equal shards, by index, and runs the port's
public ops on each shard on its device and stream (the CUDA kernels K1-K4
on a CUDA device, their plain versions on the CPU: dispatch is by device).
Then, in the JAX step's place:

  * ``psum`` is the sum of the shard histograms on ``mesh[0]``,
  * ``all_gather`` + ``axis_index`` is the exclusive prefix of the
    per-shard flag counts in shard order: each shard's output byte offset,
    fixed by shard index rather than arrival order.

Inputs are host arrays (numpy or CPU tensors); every output is a CPU
tensor of the JAX step's global shape and dtype.  Lines are independent,
so the shards need no communication but these sums.  The ``.vcfz`` steps
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.histogram import ctx_flag_histogram, masked_code_histogram
from ..ops.rle import rle_decode, rle_encode, text_rle_decode, text_rle_encode, unpack_rle_decode


def _streams(mesh) -> list:
    """A stream of its own for each CUDA shard (None for a CPU shard)."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None for d in mesh]


def _run_shards(mesh, streams, body, sharded, width: int = 0) -> list[tuple]:
    """Run ``body(*shard inputs)`` on each shard's device and stream, and
    return each shard's outputs (on its device) once every stream is done.

    ``sharded`` are the row-sharded inputs; each splits into len(mesh)
    contiguous equal row blocks.  ``width``, when not 0, is the plane width
    the step was built for."""
    tensors = [torch.from_numpy(a if a.flags.writeable else a.copy())
               if isinstance(a, np.ndarray) else a for a in sharded]
    rows = tensors[0].shape[0]
    if rows % len(mesh) or any(t.shape[0] != rows for t in tensors):
        raise ValueError(f"{rows} rows do not split into {len(mesh)} equal shards")
    if width and tensors[0].shape[1] != width:
        raise ValueError(f"the step was built for width {width}, got {tensors[0].shape[1]}")
    per = rows // len(mesh)
    out = []
    for i, (device, stream) in enumerate(zip(mesh, streams)):
        with torch.cuda.stream(stream):  # None (a CPU shard): no stream to set
            shard = [t[i * per : (i + 1) * per].to(device, non_blocking=True) for t in tensors]
            out.append(body(*shard))
    for stream in streams:
        if stream is not None:
            stream.synchronize()
    return out


def _cat(outputs, k: int) -> torch.Tensor:
    """Output k of every shard, concatenated along the rows on the host."""
    return torch.cat([o[k].cpu() for o in outputs])


def _psum(outputs, k: int, mesh) -> torch.Tensor:
    """Output k of every shard summed on mesh[0], then copied to the host
    (the copy waits for the sum, and ``outputs`` holds the shards' tensors
    until then)."""
    total = outputs[0][k].to(mesh[0])
    for o in outputs[1:]:
        total = total + o[k].to(mesh[0])
    return total.cpu()


def _exclusive_offsets(counts) -> torch.Tensor:
    """The exclusive prefix of the per-shard counts in shard order."""
    counts = torch.stack([c.cpu() for c in counts]).to(torch.int32)
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


def make_sharded_encode_step(mesh, s_pad: int = 0):
    """fn(codes (L, S_pad) u8, n_samples) -> (flagpos (L, S_pad) u8, nseg
    (L,) i32, global_hist (5,) i32, shard_offset (n_dev,) i32).

    shard_offset is the exclusive scan of the per-shard flag counts
    (deterministic output placement).  ``s_pad``, when not 0, is the width
    the step takes; a plane of another width raises."""
    streams = _streams(mesh)

    def body(codes, n):
        flagpos, nseg = rle_encode(codes, n)
        return flagpos, nseg, masked_code_histogram(codes, n), nseg.sum()

    def step(codes, n_samples):
        n = int(n_samples)
        out = _run_shards(mesh, streams, lambda c: body(c, n), [codes], s_pad)
        return (_cat(out, 0), _cat(out, 1), _psum(out, 2, mesh),
                _exclusive_offsets([o[3] for o in out]))

    return step


def make_sharded_codebook_step(mesh):
    """fn(codes, n_samples) -> (flagpos, nseg, ctx_hist (4, 256) i32):
    every shard RLE-encodes its lines and the (context, flag) histograms
    sum over the shards, the input of the .vcfz v2 codebooks."""
    streams = _streams(mesh)

    def body(codes, n):
        flagpos, nseg = rle_encode(codes, n)
        return flagpos, nseg, ctx_flag_histogram(flagpos, n)

    def step(codes, n_samples):
        n = int(n_samples)
        out = _run_shards(mesh, streams, lambda c: body(c, n), [codes])
        return _cat(out, 0), _cat(out, 1), _psum(out, 2, mesh)

    return step


def make_sharded_decode_step(mesh, s_pad: int = 0):
    """fn(flagpos (L, S_pad) u8, n_samples) -> (codes (L, S_pad) u8,
    decoded (L,) i32): every shard run-fills its lines (the reference's
    sequential spec is decompress2_fd, compress.cpp:1214-1257).  ``s_pad``
    as in ``make_sharded_encode_step``."""
    streams = _streams(mesh)

    def step(flagpos, n_samples):
        n = int(n_samples)
        out = _run_shards(mesh, streams, lambda f: rle_decode(f, n), [flagpos], s_pad)
        return _cat(out, 0), _cat(out, 1)

    return step


def make_sharded_unpack_decode_step(mesh, out_width: int):
    """fn(flags (L, M) u8 packed, nflags (L,) i32, n_samples) -> (codes
    (L, out_width) u8, decoded (L,) i32): every shard unpacks its packed
    file flag bytes to the positional plane and run-fills it, the sharded
    twin of the VCFC_UNPACK=device route."""
    streams = _streams(mesh)

    def step(flags, nflags, n_samples):
        n = int(n_samples)
        out = _run_shards(
            mesh, streams, lambda f, k: unpack_rle_decode(f, k, n, out_width), [flags, nflags])
        return _cat(out, 0), _cat(out, 1)

    return step


def make_sharded_text_step(mesh):
    """fn(text (L, S_pad) i32, n_samples) -> (text', flagpos, nseg,
    seps_ok): every shard classifies its "a|b\\t" words and RLE-encodes
    them (K3), then decodes and renders the flags back to words (K4)."""
    streams = _streams(mesh)

    def body(text, n):
        flagpos, nseg, seps_ok = text_rle_encode(text, n)
        text2, _codes, _decoded = text_rle_decode(flagpos, n)
        return text2, flagpos, nseg, seps_ok

    def step(text, n_samples):
        n = int(n_samples)
        out = _run_shards(mesh, streams, lambda t: body(t, n), [text])
        return tuple(_cat(out, k) for k in range(4))

    return step


def make_sharded_roundtrip_step(mesh):
    """fn(codes, n_samples) -> (decoded codes (L, S_pad) u8, n_ok i32,
    hist (5,) i32): every shard encodes and decodes its lines; n_ok counts
    the shards whose decode restored their codes below ``n_samples`` and
    every row's sample count."""
    streams = _streams(mesh)

    def body(codes, n):
        flagpos, _nseg = rle_encode(codes, n)
        decoded_codes, decoded = rle_decode(flagpos, n)
        valid = torch.arange(codes.shape[1], device=codes.device)[None, :] < n
        ok = torch.where(valid, decoded_codes == codes, True).all() & (decoded == n).all()
        return decoded_codes, ok.to(torch.int32), masked_code_histogram(codes, n)

    def step(codes, n_samples):
        n = int(n_samples)
        out = _run_shards(mesh, streams, lambda c: body(c, n), [codes])
        return _cat(out, 0), _psum(out, 1, mesh), _psum(out, 2, mesh)

    return step
