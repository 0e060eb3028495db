"""Wrappers of the hand-written Hopper RLE kernels (``csrc/rle_kernels.cu``)
and of their ablation probes (``csrc/probe_kernels.cu``).

The counterpart of ``vcfc_tpu/ops/pallas_rle.py``: ``cuda_rle_encode``
launches K1 (which replaces ``_encode_kernel``), ``cuda_rle_decode`` K2
(``_decode_kernel``), ``cuda_text_encode`` K3 (``_text_encode_kernel``)
and ``cuda_text_decode`` K4 (``_text_decode_kernel``).  The probes replace
the Pallas kernels of ``scripts/kernel_ceiling.py`` and
``scripts/swar_probe.py`` and keep K1's and K2's earlier tile design
measurable: ``cuda_probe_scan_only`` (C1, the tile encode's scan alone),
``cuda_probe_scan_replaced`` (C2, the tile encode without its scan),
``cuda_probe_roundtrip`` (C3, the tile encode then the tile decode with
the flags kept on chip), ``cuda_probe_blocked_encode`` (C4, the tile
encode at 1 to 16 cells a thread) and ``cuda_probe_tile_decode`` (C5, the
tile decode).  Each
takes CUDA tensors only, allocates its outputs with ``torch.empty``,
launches on the current stream without synchronising, and raises when the
launch is refused.

``LAUNCHES`` counts each kernel's launches, so that a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

LAUNCHES = {
    "rle_encode": 0, "rle_decode": 0, "text_encode": 0, "text_decode": 0,
    "probe_scan_only": 0, "probe_scan_replaced": 0, "probe_roundtrip": 0,
    "probe_blocked_encode": 0, "probe_tile_decode": 0,
}
PROBE_CELLS = (1, 2, 4, 8, 16)  # the cells a thread owns in C1 and C4

# kernel -> (library, output planes' dtypes, per-row outputs, takes cells):
# every entry point takes (in, *outputs, rows, width, n_samples, [cells,]
# stream)
_KERNELS = {
    "rle_encode": ("rle_kernels", (torch.uint8,), 1, False),
    "rle_decode": ("rle_kernels", (torch.uint8,), 1, False),
    "text_encode": ("rle_kernels", (torch.uint8,), 2, False),
    "text_decode": ("rle_kernels", (torch.int32, torch.uint8), 1, False),
    "probe_scan_only": ("probe_kernels", (torch.uint8,), 1, True),
    "probe_scan_replaced": ("probe_kernels", (torch.uint8,), 1, False),
    "probe_roundtrip": ("probe_kernels", (torch.uint8,), 1, False),
    "probe_blocked_encode": ("probe_kernels", (torch.uint8,), 1, True),
    "probe_tile_decode": ("probe_kernels", (torch.uint8,), 1, False),
}
# vcfc_cuda_rle_kernel_info's kernel argument
_INFO_KERNELS = {"rle_encode": 0, "rle_decode": 1}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for kernel, (source, planes, per_row, cells) in _KERNELS.items():
        if source != name:
            continue
        fn = getattr(lib, f"vcfc_cuda_{kernel}")
        fn.argtypes = [
            *[ctypes.c_void_p] * (1 + len(planes) + per_row),  # in, outputs
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, width, n_samples
            *[ctypes.c_int] * cells,  # cells
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    lib.vcfc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcfc_cuda_error_string.restype = ctypes.c_char_p
    if name == "rle_kernels":
        lib.vcfc_cuda_rle_kernel_info.argtypes = [ctypes.c_int, *[ctypes.POINTER(ctypes.c_int)] * 3]
        lib.vcfc_cuda_rle_kernel_info.restype = ctypes.c_int
    if name == "probe_kernels":
        lib.vcfc_cuda_probe_roundtrip_max_width.argtypes = []
        lib.vcfc_cuda_probe_roundtrip_max_width.restype = ctypes.c_int
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


def _launch(kernel: str, x: torch.Tensor, n_samples: int, *cells: int):
    n = int(n_samples)
    if not -(1 << 31) <= n < (1 << 31):
        raise ValueError(f"n_samples {n} is outside the int32 range")
    library, planes, per_row, _ = _KERNELS[kernel]
    lib = _lib(library)
    rows, width = x.shape
    outputs = [torch.empty(x.shape, dtype=dtype, device=x.device) for dtype in planes]
    outputs += [torch.empty(rows, dtype=torch.int32, device=x.device) for _ in range(per_row)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"vcfc_cuda_{kernel}")(
            x.data_ptr(), *(o.data_ptr() for o in outputs), rows, width, n, *cells, stream
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


def kernel_info(kernel: str) -> dict:
    """K1's or K2's ("rle_encode" or "rle_decode") registers a thread, local
    memory bytes a thread and resident blocks per SM on the current
    device."""
    lib = _lib("rle_kernels")
    values = [ctypes.c_int() for _ in range(3)]
    err = lib.vcfc_cuda_rle_kernel_info(_INFO_KERNELS[kernel], *map(ctypes.byref, values))
    if err:
        msg = lib.vcfc_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} attributes: cudaError {err} ({msg})")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), (v.value for v in values)))


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


def _check_cells(cells: int) -> int:
    if cells not in PROBE_CELLS:
        raise ValueError(f"cells must be one of {PROBE_CELLS}, got {cells}")
    return cells


def cuda_probe_scan_only(codes: torch.Tensor, n_samples: int, cells: int = 16):
    """C1: (L, S_pad) uint8 codes -> (latest run start & 0x7F (L, S_pad)
    uint8, cell 0's run start (L,) int32), ``cells`` cells a thread."""
    _check_plane(codes, "probe_scan_only")
    return _launch("probe_scan_only", codes, n_samples, _check_cells(cells))


def cuda_probe_scan_replaced(codes: torch.Tensor, n_samples: int):
    """C2: (L, S_pad) uint8 codes -> (flags (L, S_pad) uint8, nseg (L,)
    int32) of K1 with its scan replaced by ``idx & ~127``."""
    _check_plane(codes, "probe_scan_replaced")
    return _launch("probe_scan_replaced", codes, n_samples)


def cuda_probe_roundtrip(codes: torch.Tensor, n_samples: int):
    """C3: (L, S_pad) uint8 codes -> (codes (L, S_pad) uint8, decoded (L,)
    int32) of K2 on K1's flags, which stay in shared memory.  Raises on a
    row wider than the shared memory a block can hold."""
    _check_plane(codes, "probe_roundtrip")
    with torch.cuda.device(codes.device):
        limit = _lib("probe_kernels").vcfc_cuda_probe_roundtrip_max_width()
    if limit < 0:
        raise RuntimeError("probe_roundtrip: the device's shared memory could not be queried")
    if codes.shape[1] > limit:
        raise ValueError(f"probe_roundtrip keeps a row's flags in shared memory: width "
                         f"{codes.shape[1]} exceeds the {limit} bytes a block can hold")
    return _launch("probe_roundtrip", codes, n_samples)


def cuda_probe_blocked_encode(codes: torch.Tensor, n_samples: int, cells: int = 16):
    """C4: K1 at ``cells`` cells a thread: (L, S_pad) uint8 codes ->
    (flagpos (L, S_pad) uint8, nseg (L,) int32), K1's outputs."""
    _check_plane(codes, "probe_blocked_encode")
    return _launch("probe_blocked_encode", codes, n_samples, _check_cells(cells))


def cuda_probe_tile_decode(flagpos: torch.Tensor, n_samples: int):
    """C5: K2's earlier tile design: (L, S_pad) uint8 flags -> (codes (L,
    S_pad) uint8, decoded (L,) int32), K2's outputs."""
    _check_plane(flagpos, "probe_tile_decode")
    return _launch("probe_tile_decode", flagpos, n_samples)
