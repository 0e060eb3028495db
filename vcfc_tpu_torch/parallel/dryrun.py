"""Multichip dry run of the sharded ``.vcfc`` steps: the port's twin of the
``.vcfc`` legs of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip`` builds an n-shard mesh, runs each sharded step once
on tiny shapes and checks what the JAX dry run checks:
the histogram total, monotone offsets, ``n_ok == n_devices``, the
context-histogram sum equal to the flag count, the decode and unpack-decode
inverses, and the text step's round trip of the rendered words.
"""

from __future__ import annotations

import numpy as np

from .mesh import make_data_mesh
from .shard import (
    make_sharded_codebook_step,
    make_sharded_decode_step,
    make_sharded_encode_step,
    make_sharded_roundtrip_step,
    make_sharded_text_step,
    make_sharded_unpack_decode_step,
)


def example_codes(L: int = 256, S_pad: int = 128, seed: int = 0) -> np.ndarray:
    """The JAX dry run's genotype-code batch (``__graft_entry__._example_codes``)."""
    rng = np.random.default_rng(seed)
    return rng.choice(5, size=(L, S_pad), p=[0.8, 0.07, 0.07, 0.04, 0.02]).astype(np.uint8)


def _check(ok, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def pack_flags(flagpos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed (left-aligned) flag bytes of a positional plane, the width
    rounded up to 128, and each row's flag count."""
    nflags = (flagpos > 0).sum(axis=1).astype(np.int32)
    M = -(-max(int(nflags.max()), 1) // 128) * 128
    packed = np.zeros((len(flagpos), M), np.uint8)
    for i, row in enumerate(flagpos):
        nz = row[row > 0]
        packed[i, : len(nz)] = nz
    return packed, nflags


def code_words(codes: np.ndarray, n_samples: int) -> np.ndarray:
    """int32 "a|b\\t" words of a code plane: escapes as "?|?", '\\n' after
    sample n_samples - 1."""
    c = codes.astype(np.int32)
    esc = c == 4
    b0 = np.where(esc, 63, 48 + (c >> 1))
    b2 = np.where(esc, 63, 48 + (c & 1))
    sep = np.full_like(c, 9)
    sep[:, n_samples - 1] = 10
    return (b0 | (124 << 8) | (b2 << 16) | (sep << 24)).astype(np.int32)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Build an ``n_devices``-shard mesh (over ``devices`` when given), run
    every sharded ``.vcfc`` step once on an (8 * n_devices, 128) batch and
    raise AssertionError where a check fails."""
    mesh = make_data_mesh(n_devices, devices)
    _check(len(mesh) == n_devices, f"mesh has {len(mesh)} shards, want {n_devices}")
    L, S_pad, n = 8 * n_devices, 128, 100
    codes = example_codes(L=L, S_pad=S_pad, seed=1)

    flagpos, nseg, hist, offsets = make_sharded_encode_step(mesh)(codes, n)
    total = int(hist.sum())
    _check(total == L * n, f"global histogram counted {total}, want {L * n}")
    _check(bool((offsets.diff() >= 0).all()), "shard offsets must be monotone")

    decoded, n_ok, hist2 = make_sharded_roundtrip_step(mesh)(codes, n)
    _check(int(n_ok) == n_devices, f"per-shard roundtrip: {int(n_ok)} of {n_devices} shards")
    np.testing.assert_array_equal(hist.numpy(), hist2.numpy())
    np.testing.assert_array_equal(decoded.numpy()[:, :n], codes[:, :n])

    flagpos2, nseg2, ctx_hist = make_sharded_codebook_step(mesh)(codes, n)
    _check(int(ctx_hist.sum()) == int(nseg.sum()),
           "ctx histogram must count every emitted flag byte")
    np.testing.assert_array_equal(flagpos2.numpy(), flagpos.numpy())
    np.testing.assert_array_equal(nseg2.numpy(), nseg.numpy())

    codes2, decoded2 = make_sharded_decode_step(mesh)(flagpos, n)
    _check(bool((decoded2 == n).all()), "sharded decode sample counts")
    np.testing.assert_array_equal(codes2.numpy()[:, :n], codes[:, :n])

    packed, nflags = pack_flags(flagpos.numpy())
    codes3, decoded3 = make_sharded_unpack_decode_step(mesh, S_pad)(packed, nflags, n)
    _check(bool((decoded3 == n).all()), "sharded unpack-decode sample counts")
    np.testing.assert_array_equal(codes3.numpy()[:, :n], codes[:, :n])

    text = code_words(codes, n)
    text2, flag_t, _nseg_t, seps_ok = make_sharded_text_step(mesh)(text, n)
    _check(bool((seps_ok == 1).all()), "sharded text separator check")
    np.testing.assert_array_equal(flag_t.numpy(), flagpos.numpy())
    np.testing.assert_array_equal(text2.numpy()[:, :n], text[:, :n])

