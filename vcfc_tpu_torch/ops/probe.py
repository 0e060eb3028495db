"""Ablation probes of the RLE kernels K1/K2, in PyTorch.

The port of the Pallas probe kernels of ``scripts/kernel_ceiling.py``
(P1: ``enc_scan_only``, ``enc_noscan``, ``rt_kernel``) and
``scripts/swar_probe.py`` (P2: the full encode over a blocked scan, and the
scan alone).  Each keeps part of K1's or K2's work, so that timing it
beside them splits where their time goes; C5, K2's earlier tile design,
has K2's plain version.  The plain versions here are the spec that the
CUDA probes of ``cuda_rle`` (C1-C5) are held to; the public
``probe_*`` functions dispatch on the tensor's device: a CPU tensor gets
the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import functools

import torch

from ..format.constants import CODE_ESCAPE
from .cuda_rle import (
    _check_cells,
    cuda_probe_blocked_encode,
    cuda_probe_roundtrip,
    cuda_probe_scan_only,
    cuda_probe_scan_replaced,
    cuda_probe_tile_decode,
)
from .rle import _columns, _dispatch, _flag_base, rle_decode_plain, rle_encode_plain


def _new_run(c: torch.Tensor) -> torch.Tensor:
    """A run starts where the code changes or either neighbour is an
    escape; column 0 always starts one."""
    prev = torch.cat([torch.full_like(c[:, :1], -1), c[:, :-1]], dim=1)
    return (c != prev) | (c == CODE_ESCAPE) | (prev == CODE_ESCAPE)


def scan_only_plain(codes: torch.Tensor, n_samples: int):
    """K1's run scan alone (``enc_scan_only``): the prefix max of ``new_run
    ? idx : -1`` over the whole row, padding included.  ``n_samples`` is
    unused, as in the TPU probe.  Returns (m & 0x7F (L, S_pad) uint8,
    m[:, 0] (L,) int32), and m[:, 0] is always 0."""
    c = codes.to(torch.int32)
    m = torch.cummax(torch.where(_new_run(c), _columns(c), -1), dim=1).values
    return (m & 0x7F).to(torch.uint8), m[:, 0].contiguous()


def scan_replaced_plain(codes: torch.Tensor, n_samples: int):
    """K1 with its scan replaced (``enc_noscan``): ``run_start = new_run ?
    idx : idx & ~127``, every other step as in ``rle_encode_plain``.
    Returns (flags (L, S_pad) uint8, nseg (L,) int32)."""
    c = codes.to(torch.int32)
    idx = _columns(c)
    d = idx - torch.where(_new_run(c), idx, idx & ~127)
    rem = torch.where(c == 0, d % 127, d % 31)
    boundary = (rem == 0) & (idx < n_samples)
    next_boundary = torch.cat([boundary[:, 1:], torch.zeros_like(boundary[:, :1])], dim=1)
    last = next_boundary | (idx == n_samples - 1)
    flags = torch.where(last, _flag_base(c) | (rem + 1), 0).to(torch.uint8)
    return flags, boundary.sum(dim=1, dtype=torch.int32)


def roundtrip_plain(codes: torch.Tensor, n_samples: int):
    """K2 on K1's flags (``rt_kernel``): (codes (L, S_pad) uint8, decoded
    (L,) int32).  On K1's flags the Pallas 128-cell-halo decode equals
    this whole-row fill, padding columns included."""
    return rle_decode_plain(rle_encode_plain(codes, n_samples)[0], n_samples)


def probe_scan_only(codes: torch.Tensor, n_samples: int, cells: int = 16):
    """C1 on a CUDA tensor (``cells`` cells a thread), the plain version
    on a CPU tensor."""
    kernel = functools.partial(cuda_probe_scan_only, cells=_check_cells(cells))
    return _dispatch(codes, scan_only_plain, kernel)(codes, n_samples)


def probe_scan_replaced(codes: torch.Tensor, n_samples: int):
    """C2 on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch(codes, scan_replaced_plain, cuda_probe_scan_replaced)(codes, n_samples)


def probe_roundtrip(codes: torch.Tensor, n_samples: int):
    """C3 on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch(codes, roundtrip_plain, cuda_probe_roundtrip)(codes, n_samples)


def probe_blocked_encode(codes: torch.Tensor, n_samples: int, cells: int = 16):
    """C4 on a CUDA tensor (K1 at ``cells`` cells a thread); on a CPU
    tensor ``rle_encode_plain``, whose outputs every ``cells`` gives."""
    kernel = functools.partial(cuda_probe_blocked_encode, cells=_check_cells(cells))
    return _dispatch(codes, rle_encode_plain, kernel)(codes, n_samples)


def probe_tile_decode(flagpos: torch.Tensor, n_samples: int):
    """C5 on a CUDA tensor (K2's earlier tile design); on a CPU tensor
    ``rle_decode_plain``, whose outputs C5 gives."""
    return _dispatch(flagpos, rle_decode_plain, cuda_probe_tile_decode)(flagpos, n_samples)
