"""vcfc_tpu_torch — the .vcfc genotype codec on PyTorch and CUDA (Hopper).

The port of ``vcfc_tpu`` from JAX on a TPU to PyTorch on an NVIDIA H100.
The system has no weights: its state is the data.  The public functions
take and return the JAX package's numpy layouts unchanged (uint8
``(L, S_pad)`` code and flag planes, int32 ``(L, S_pad)`` text-word planes,
int32 ``(L,)`` per-row counts, bytes for whole files), so the same numpy
array goes to both packages, here as ``torch.from_numpy(arr.copy())`` (the
copy because arrays over a bytes buffer are read-only).

Ported so far: ``engine.compress`` / ``engine.decompress`` and their
streaming forms, on the hand-written CUDA kernels of
``csrc/rle_kernels.cu``: the parse route (K1/K2), the
``VCFC_PARSE=device`` text route (K3/K4) and the ``VCFC_UNPACK=device``
decompress route (packed flags unpacked on the device, then K2); and the
K1/K2 ablation ``eval.kernel_ceiling`` on the probes of
``csrc/probe_kernels.cu`` (C1-C4).  The host layers (``host``,
``format``, ``eval.random_vcf``, ``eval.bench_codes``) are the port's own
copies of the JAX package's; this package imports neither ``jax`` nor
``vcfc_tpu``.
"""

__version__ = "0.3.0"
