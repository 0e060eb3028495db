"""Wrappers of the hand-written Hopper RLE kernels (``csrc/rle_kernels.cu``).

The counterpart of ``vcfc_tpu/ops/pallas_rle.py``: ``cuda_rle_encode``
launches K1 (which replaces ``_encode_kernel``), ``cuda_rle_decode`` K2
(``_decode_kernel``), ``cuda_text_encode`` K3 (``_text_encode_kernel``)
and ``cuda_text_decode`` K4 (``_text_decode_kernel``).  Each takes CUDA
tensors only, allocates its outputs with ``torch.empty``, launches on the
current stream without synchronising, and raises when the launch is
refused.

``LAUNCHES`` counts each kernel's launches, so that a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

LAUNCHES = {"rle_encode": 0, "rle_decode": 0, "text_encode": 0, "text_decode": 0}

# kernel -> (output planes' dtypes, per-row outputs): every entry point
# takes (in, *outputs, rows, width, n_samples, stream)
_OUTPUTS = {
    "rle_encode": ((torch.uint8,), 1),
    "rle_decode": ((torch.uint8,), 1),
    "text_encode": ((torch.uint8,), 2),
    "text_decode": ((torch.int32, torch.uint8), 1),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rle_kernels")
    for kernel, (planes, per_row) in _OUTPUTS.items():
        fn = getattr(lib, f"vcfc_cuda_{kernel}")
        fn.argtypes = [
            *[ctypes.c_void_p] * (1 + len(planes) + per_row),  # in, outputs
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, width, n_samples
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    lib.vcfc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcfc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_plane(x: torch.Tensor, kernel: str, dtype: torch.dtype = torch.uint8) -> None:
    what = f"{kernel} input"
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what} must be a non-empty 2-D (L, S_pad) plane, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got one on {x.device}")
    if max(x.shape) >= 1 << 31:
        raise ValueError(f"{what} shape {tuple(x.shape)} exceeds the kernel's int32 range")


def _launch(kernel: str, x: torch.Tensor, n_samples: int):
    n = int(n_samples)
    if not -(1 << 31) <= n < (1 << 31):
        raise ValueError(f"n_samples {n} is outside the int32 range")
    lib = _lib()
    planes, per_row = _OUTPUTS[kernel]
    rows, width = x.shape
    outputs = [torch.empty(x.shape, dtype=dtype, device=x.device) for dtype in planes]
    outputs += [torch.empty(rows, dtype=torch.int32, device=x.device) for _ in range(per_row)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"vcfc_cuda_{kernel}")(
            x.data_ptr(), *(o.data_ptr() for o in outputs), rows, width, n, stream
        )
    if err:
        msg = lib.vcfc_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err} ({msg})")
    LAUNCHES[kernel] += 1
    return tuple(outputs)


def cuda_rle_encode(codes: torch.Tensor, n_samples: int):
    """K1: (L, S_pad) uint8 codes -> (flagpos (L, S_pad) uint8, nseg (L,) int32)."""
    _check_plane(codes, "rle_encode")
    return _launch("rle_encode", codes, n_samples)


def cuda_rle_decode(flagpos: torch.Tensor, n_samples: int):
    """K2: (L, S_pad) uint8 flags -> (codes (L, S_pad) uint8, decoded (L,) int32)."""
    _check_plane(flagpos, "rle_decode")
    return _launch("rle_decode", flagpos, n_samples)


def cuda_text_encode(text: torch.Tensor, n_samples: int):
    """K3: (L, S_pad) int32 "a|b\\t" words -> (flagpos (L, S_pad) uint8,
    nseg (L,) int32, seps_ok (L,) int32)."""
    _check_plane(text, "text_encode", torch.int32)
    return _launch("text_encode", text, n_samples)


def cuda_text_decode(flagpos: torch.Tensor, n_samples: int):
    """K4: (L, S_pad) uint8 flags -> (text (L, S_pad) int32 words, codes
    (L, S_pad) uint8, decoded (L,) int32)."""
    _check_plane(flagpos, "text_decode")
    return _launch("text_decode", flagpos, n_samples)
