"""Wrapper of the hand-written Hopper row compaction (``csrc/compact_kernels.cu``).

``cuda_sort_compact`` replaces ``vcfc_tpu/ops/vcfz_device.py::sort_compact``
on the card: it takes CUDA tensors only (int32 values, a bool or uint8 mask
of the same 2-D shape, both contiguous), allocates the outputs and the
kernel's scratch with ``torch.empty``, launches on the current stream
without synchronising, and raises when the build or the launch fails.

``LAUNCHES`` counts its launches, so that a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

LAUNCHES = {"sort_compact": 0}
CHUNK = 4096  # cells a block owns (csrc/compact_kernels.cu)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("compact_kernels")
    lib.vcfc_cuda_sort_compact.argtypes = [
        *[ctypes.c_void_p] * 6,  # values, mask, out, counts, chunk_count, chunk_base
        ctypes.c_longlong, ctypes.c_longlong,  # B, n
        ctypes.c_void_p,  # stream
    ]
    lib.vcfc_cuda_sort_compact.restype = ctypes.c_int
    lib.vcfc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcfc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cuda_sort_compact(values: torch.Tensor, mask: torch.Tensor):
    """(B, n) int32 values and a (B, n) bool/uint8 mask on a CUDA device ->
    ((B, n) int32, each row's masked values first and its unmasked ones
    after, both in order; (B,) int32 masked counts): ``sort_compact``."""
    if values.dim() != 2 or values.dtype != torch.int32:
        raise TypeError(f"values must be a 2-D int32 tensor, got {values.dtype} "
                        f"{tuple(values.shape)}")
    if mask.shape != values.shape or mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be a bool or uint8 tensor of the values' shape, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    for name, t in (("values", values), ("mask", mask)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask.device != values.device:
        raise ValueError(f"values on {values.device} and mask on {mask.device}")
    B, n = values.shape
    out = torch.empty_like(values)
    if B == 0 or n == 0:
        return out, torch.zeros(B, dtype=torch.int32, device=values.device)
    counts = torch.empty(B, dtype=torch.int32, device=values.device)
    n_chunks = -(-n // CHUNK)
    scratch = torch.empty(2 * B * n_chunks, dtype=torch.int32, device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcfc_cuda_sort_compact(
            values.data_ptr(), mask.data_ptr(), out.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), scratch[B * n_chunks :].data_ptr(), B, n, stream)
    if err:
        msg = lib.vcfc_cuda_error_string(err).decode()
        raise RuntimeError(f"sort_compact kernel launch failed: cudaError {err} ({msg})")
    LAUNCHES["sort_compact"] += 1
    return out, counts
