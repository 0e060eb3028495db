"""Genotype symbol histograms, in PyTorch: the port of
``vcfc_tpu/ops/histogram.py``.

Per-shard histograms of the 5 genotype codes and of (context, flag byte)
pairs, which the sharded steps of ``parallel.shard`` sum over the shards
(the JAX package's ``psum``).  They are PyTorch ops on either device, as
the JAX package's are XLA ops: ``torch.bincount`` into a few bins instead
of the JAX version's (L, S, 5) one-hot.  Every output is int32, of the
JAX version's shape.
"""

from __future__ import annotations

import torch

from .huffman import CTX_INIT, N_CTX

N_SYMBOLS = 5


def _code_counts(values: torch.Tensor) -> torch.Tensor:
    """(5,) int32 counts of the codes 0-4 among ``values``; other values
    count nowhere."""
    counts = torch.bincount(values.reshape(-1), minlength=N_SYMBOLS)
    return counts[:N_SYMBOLS].to(torch.int32)


def code_histogram(codes: torch.Tensor) -> torch.Tensor:
    """Occurrences of each code 0-4 in a (L, S) uint8 plane -> (5,) int32."""
    return _code_counts(codes)


def masked_code_histogram(codes: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Histogram over the first ``n_samples`` columns only (padding
    ignored).  Rows are not masked: a zero-padded row counts code 0 in
    each of its first ``n_samples`` columns, as in the JAX version."""
    n = min(max(int(n_samples), 0), codes.shape[1])
    return _code_counts(codes[:, :n])


def ctx_flag_histogram(flagpos: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(N_CTX, 256) int32 context-classed histogram of the flag bytes of a
    (L, S_pad) positional-flag plane.

    The context of a flag is the class of the previous flag in its row
    (``ops.huffman``), ``CTX_INIT`` at the row start; only flags in the
    first ``n_samples`` columns count.  As the JAX version, it is
    codebook-grade: .vcfz chains contexts across the lines of a block, so
    up to one symbol a line is counted under ``CTX_INIT`` instead of its
    cross-line context."""
    L, S_pad = flagpos.shape
    if S_pad >= (1 << 23):
        raise ValueError(f"sample width {S_pad} exceeds the packed-scan range")
    f = flagpos.to(torch.int32)
    present = f > 0
    idx = torch.arange(S_pad, dtype=torch.int32, device=f.device)[None, :]
    # previous present flag per position: the last (position << 8) | flag
    # at or before it by a cummax, shifted one column right
    filled = torch.cummax(torch.where(present, (idx << 8) | f, -1), dim=1).values
    prev = torch.cat([torch.full_like(filled[:, :1], -1), filled[:, :-1]], dim=1)
    prev_flag = prev & 0xFF
    ctx = torch.where(prev_flag < 0xE0, 2, 3)
    ctx = torch.where(prev_flag < 0x80, 1, ctx)
    ctx = torch.where(prev_flag == 0x7F, 0, ctx)
    ctx = torch.where(prev < 0, CTX_INIT, ctx)
    valid = present & (idx < int(n_samples))
    # flags outside the count go to one sink bin past the table
    sink = N_CTX * 256
    bins = torch.where(valid, ctx * 256 + f, sink)
    hist = torch.bincount(bins.reshape(-1), minlength=sink + 1)[:sink]
    return hist.to(torch.int32).reshape(N_CTX, 256)
