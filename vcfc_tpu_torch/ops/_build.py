"""Build the CUDA sources of ``vcfc_tpu_torch/csrc`` into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and may include the
shared headers ``csrc/*.cuh``.  At first use it is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``vcfc_tpu_torch/_build/<name>-<hash>.so``,
the hash taken over the source and the headers, and loaded with ctypes; a
later call with the same sources loads the library already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` if it exists, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on PATH"
        )
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{name}-", suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {src}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, compiling it if need be."""
    return ctypes.CDLL(str(build(name)))
