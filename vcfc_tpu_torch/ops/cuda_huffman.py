"""Wrapper of the hand-written Hopper Huffman decode (``csrc/huffman_kernels.cu``).

``cuda_decode_bits`` replaces ``vcfc_tpu/ops/huffman_device.py::decode_bits``
on the card: it takes CUDA tensors only, allocates the plane and the
kernel's scratch with ``torch.empty``, launches on the current stream
without synchronising, and raises when the build or the launch fails.

``LAUNCHES`` counts its launches, so that a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

LAUNCHES = {"huffman_decode_bits": 0}
_W = 15  # the canonical tables' length


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("huffman_kernels")
    lib.vcfc_cuda_huffman_decode_bits.argtypes = [
        *[ctypes.c_void_p] * 4,  # words, out, seg_map, seg_in
        *[ctypes.c_longlong] * 4,  # B, nwords, s1, s2
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),  # limits, idx_adjust
        ctypes.c_void_p,  # stream
    ]
    lib.vcfc_cuda_huffman_decode_bits.restype = ctypes.c_int
    lib.vcfc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcfc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _table(x) -> ctypes.Array:
    """A 15-entry int32 host table as a ctypes array."""
    a = np.asarray(x, np.int32).reshape(-1)
    if a.shape != (_W,):
        raise ValueError(f"a decode table has {_W} entries, got {a.shape[0]}")
    return (ctypes.c_int * _W)(*a.tolist())


def cuda_decode_bits(words: torch.Tensor, limits, idx_adjust, *, s1: int, s2: int):
    """(B, W) int32 words on a CUDA device -> (B, s1*s2) int32 plane,
    ``ordinal + 1`` at each start bit (``decode_bits``).  ``limits`` and
    ``idx_adjust`` are ``device_decode_tables``' host arrays."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise TypeError(f"words must be a 2-D int32 tensor, got {words.dtype} {tuple(words.shape)}")
    if words.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got one on {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    B, W = words.shape
    if s1 < 1 or s2 < 1 or W * 32 != s1 * s2:
        raise ValueError("word count does not tile the (s1, s2) bit grid")
    out = torch.empty((B, W * 32), dtype=torch.int32, device=words.device)
    if B == 0:
        return out
    lim, adj = _table(limits), _table(idx_adjust)
    seg_map = torch.empty(B * s1 * _W, dtype=torch.uint8, device=words.device)
    seg_in = torch.empty(B * s1, dtype=torch.uint8, device=words.device)
    lib = _lib()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcfc_cuda_huffman_decode_bits(
            words.data_ptr(), out.data_ptr(), seg_map.data_ptr(), seg_in.data_ptr(),
            B, W, s1, s2, lim, adj, stream)
    if err:
        msg = lib.vcfc_cuda_error_string(err).decode()
        raise RuntimeError(f"huffman_decode_bits kernel launch failed: cudaError {err} ({msg})")
    LAUNCHES["huffman_decode_bits"] += 1
    return out
