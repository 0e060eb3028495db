"""Device meshes: the port of ``vcfc_tpu/parallel/mesh.py``.

The engine is data-parallel over variant lines (every compressed line is
self-contained, compress.cpp:5).  A mesh is a tuple of ``torch.device``,
one shard each, along the line axis ``DATA_AXIS``; the sharded steps of
``parallel.shard`` give each shard a stream of its own, so a device may
appear more than once (several shards on one card, or CPU shards in
tests, as the JAX tests' virtual devices).
"""

from __future__ import annotations

import torch

DATA_AXIS = "data"


def make_data_mesh(n_devices: int | None = None, devices=None) -> tuple[torch.device, ...]:
    """The mesh over ``devices`` (any ``torch.device`` specs), or over the
    first ``n_devices`` visible CUDA devices, every one by default.  Raises
    when PyTorch sees no CUDA device, or fewer than ``n_devices``."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "no CUDA device visible to PyTorch: pass devices=('cpu',) * n to "
                "shard over CPU devices"
            )
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise ValueError(f"asked for {n} CUDA devices, {count} visible")
        mesh = tuple(torch.device("cuda", i) for i in range(n))
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh
