"""The port's RLE kernels (vcfc_tpu_torch.ops) against vcfc_tpu's.

The same seeded numpy planes go through vcfc_tpu.ops.rle (XLA on the CPU),
vcfc_tpu.ops.pallas_rle (Pallas in interpret mode, as tests/test_pallas.py
runs it) and the port's plain PyTorch versions.  Every output is integers,
so every comparison is exact.  The CUDA kernels are held to the plain
versions in tests/test_torch_cuda.py; here, numpy models of their group
arithmetic (the per-group remainder recurrence, and K1's and K2's word
operations as csrc/rle_kernels.cu writes them) are held to the plain
versions on the same planes and on the edge cases of
vcfc_tpu_torch.eval.edge_cases.
"""

import numpy as np
import pytest
import torch

from vcfc_tpu.ops import rle as jax_rle
from vcfc_tpu.ops.pallas_rle import _block_l, pallas_rle_decode, pallas_rle_encode
from vcfc_tpu_torch.eval import geometry_sweep
from vcfc_tpu_torch.eval.edge_cases import encode_edge_cases, flag_edge_cases
from vcfc_tpu_torch.ops import _build, cuda_rle
from vcfc_tpu_torch.ops import rle as torch_rle

P = [0.81, 0.072, 0.072, 0.0264, 0.0196]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _runs(rng, L, W, max_len):
    """Rows of runs of random length (1..max_len) and random code."""
    codes = np.zeros((L, W), np.uint8)
    for row in codes:
        pos = 0
        while pos < W:
            n = int(rng.integers(1, max_len))
            row[pos : pos + n] = rng.integers(0, 5)
            pos += n
    return codes


def _case(name):
    """(codes (L, W) uint8, n_samples) for an encode case; L is the Pallas
    tile height at W, so each case runs through the Pallas kernels too."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("pallas-"):  # the shapes of tests/test_pallas.py
        S = int(name.split("-")[1])
        codes = rng.choice(5, size=(256, 384), p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.uint8)
        codes[:, S:] = 0
        return codes, S
    if name == "runs-cross-128-and-4096":
        S, W = 8200, 8320
        codes = _runs(rng, _block_l(W), W, 6000)
        codes[:5, :S] = np.arange(5, dtype=np.uint8)[:, None]  # uniform rows
        codes[:, S:] = 0
        return codes, S
    if name == "escape-heavy":
        codes = rng.choice(5, size=(256, 1024), p=[0.1, 0.05, 0.05, 0.05, 0.75]).astype(np.uint8)
        return codes, 1000
    if name == "padding-past-n":
        # nonzero codes in the padding columns must produce no flags
        return rng.choice(5, size=(256, 384), p=P).astype(np.uint8), 200
    if name == "n-equals-width":
        return rng.choice(5, size=(256, 384), p=P).astype(np.uint8), 384
    if name == "width-16384":
        S, W = 16300, 16384
        codes = np.zeros((_block_l(W), W), np.uint8)
        codes[:, :S] = rng.choice(5, size=(_block_l(W), S), p=P)
        codes[0, :S] = 0
        codes[1, :S] = 3
        return codes, S
    raise KeyError(name)


CASES = [
    "pallas-300", "pallas-384", "pallas-127", "runs-cross-128-and-4096",
    "escape-heavy", "padding-past-n", "n-equals-width", "width-16384",
]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_xla(name):
    codes, S = _case(name)
    _assert_equal(torch_rle.rle_encode_plain(_t(codes), S), jax_rle.rle_encode(codes, S))


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_pallas(name):
    codes, S = _case(name)
    _assert_equal(
        torch_rle.rle_encode_plain(_t(codes), S),
        pallas_rle_encode(codes, S, interpret=True),
    )


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_xla_and_inverts_encode(name):
    codes, S = _case(name)
    flags = np.asarray(jax_rle.rle_encode(codes, S)[0])
    got = torch_rle.rle_decode_plain(_t(flags), S)
    _assert_equal(got, jax_rle.rle_decode(flags, S))
    n = min(S, codes.shape[1])
    np.testing.assert_array_equal(got[0].numpy()[:, :n], codes[:, :n])
    assert (got[1].numpy() == n).all()


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_pallas(name):
    codes, S = _case(name)
    flags = np.asarray(jax_rle.rle_encode(codes, S)[0])
    _assert_equal(
        torch_rle.rle_decode_plain(_t(flags), S),
        pallas_rle_decode(flags, S, interpret=True),
    )


@pytest.mark.parametrize("seed,W,S", [(40, 384, 300), (41, 2560, 2504), (42, 128, 1)])
def test_decode_malformed_planes_match_xla(seed, W, S):
    """Random flag bytes with gaps past 127 cells, empty rows, zero tails
    and rows full of flags: the whole-row fill of rle_decode, tail cells
    (0xFF -> escape) included."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 256, (64, W), dtype=np.uint8)
    flags[rng.random((64, W)) < 0.97] = 0
    flags[:4] = 0
    flags[4:8, W // 2 :] = 0
    flags[8:12] = rng.integers(1, 256, (4, W), dtype=np.uint8)
    _assert_equal(torch_rle.rle_decode_plain(_t(flags), S), jax_rle.rle_decode(flags, S))


def test_encode_arbitrary_code_bytes_match_xla():
    """Bytes past the five codes take the escape base with a 31 cap."""
    rng = np.random.default_rng(43)
    codes = rng.integers(0, 256, (16, 1000), dtype=np.uint8)
    codes[:4, :500] = 7
    _assert_equal(torch_rle.rle_encode_plain(_t(codes), 990), jax_rle.rle_encode(codes, 990))


def test_render_text_matches_jax():
    codes = np.random.default_rng(44).integers(0, 5, (8, 256), dtype=np.uint8)
    np.testing.assert_array_equal(torch_rle.render_text(codes), jax_rle.render_text(codes))


def test_cpu_tensors_take_the_plain_version():
    codes, S = _case("pallas-300")
    before = dict(cuda_rle.LAUNCHES)
    _assert_equal(torch_rle.rle_encode(_t(codes), S), torch_rle.rle_encode_plain(_t(codes), S))
    flags = torch_rle.rle_encode_plain(_t(codes), S)[0]
    _assert_equal(torch_rle.rle_decode(flags, S), torch_rle.rle_decode_plain(flags, S))
    assert cuda_rle.LAUNCHES == before


def test_packed_scan_width_guard():
    flags = torch.zeros((1, 1 << 23), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packed-scan range"):
        torch_rle.rle_decode_plain(flags, 1)


@pytest.mark.parametrize(
    "plane,error",
    [
        (torch.zeros((4, 128), dtype=torch.int32), TypeError),
        (torch.zeros(128, dtype=torch.uint8), ValueError),
        (torch.zeros((128, 4), dtype=torch.uint8).t(), ValueError),
        (torch.zeros((0, 128), dtype=torch.uint8), ValueError),
        (torch.zeros((4, 128), dtype=torch.uint8), ValueError),  # a CPU tensor
    ],
    ids=["dtype", "1-D", "non-contiguous", "empty", "cpu"],
)
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(plane, error):
    for wrapper in (cuda_rle.cuda_rle_encode, cuda_rle.cuda_rle_decode):
        with pytest.raises(error):
            wrapper(plane, 100)


def test_nvcc_lookup_is_cuda_home_then_path(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    on_path = tmp_path / "empty" / "nvcc"
    on_path.parent.mkdir()
    on_path.write_text("#!/bin/sh\n")
    on_path.chmod(0o755)
    assert _build.nvcc() == str(on_path)
    home = tmp_path / "bin" / "nvcc"
    home.parent.mkdir()
    home.write_text("#!/bin/sh\n")
    home.chmod(0o755)
    assert _build.nvcc() == str(home)


EDGE = {name: (codes, n) for name, codes, n in encode_edge_cases()}
FLAG_EDGE = {name: (flags, n) for name, flags, n in flag_edge_cases()}


def _encode_case(name):
    return EDGE[name] if name in EDGE else _case(name)


@pytest.mark.parametrize("name", list(EDGE))
def test_edge_encode_matches_xla_and_pallas(name):
    codes, S = EDGE[name]
    got = torch_rle.rle_encode_plain(_t(codes), S)
    _assert_equal(got, jax_rle.rle_encode(codes, S))
    _assert_equal(got, pallas_rle_encode(codes, S, interpret=True))


@pytest.mark.parametrize("name", list(EDGE))
def test_edge_decode_matches_xla_and_pallas(name):
    codes, S = EDGE[name]
    flags = np.asarray(jax_rle.rle_encode(codes, S)[0])
    got = torch_rle.rle_decode_plain(_t(flags), S)
    _assert_equal(got, jax_rle.rle_decode(flags, S))
    _assert_equal(got, pallas_rle_decode(flags, S, interpret=True))
    # bytes past the five codes (7 here) come back as escapes
    np.testing.assert_array_equal(got[0].numpy()[:, :S], np.minimum(codes, 4)[:, :S])


@pytest.mark.parametrize("name", list(FLAG_EDGE))
def test_flag_edge_decode_matches_xla(name):
    """Flags only on group and round edges leave gaps past 127 cells, so
    only the XLA decoder's whole-row fill is the reference (ROADMAP C.2)."""
    flags, S = FLAG_EDGE[name]
    _assert_equal(torch_rle.rle_decode_plain(_t(flags), S), jax_rle.rle_decode(flags, S))


# --- numpy models of the kernels' group arithmetic --------------------------

_BASE = np.array([0x00, 0xA0, 0xC0, 0x80, 0xE0], np.int64)  # flag base by min(code, 4)


def _run_starts(c):
    prev = np.concatenate([np.full((c.shape[0], 1), -1), c[:, :-1]], axis=1)
    return (c != prev) | (c == 4) | (prev == 4)


def _counter_model(codes, n, group):
    """K1 as groups of ``group`` cells: each group seeds one d % cap at its
    first cell (d from the latest run start at or before it) and counts
    from there, resetting at a run start and wrapping at cap - 1, through
    its cells and the next group's first; its flags come from those
    remainders alone."""
    c = codes.astype(np.int64)
    L, W = c.shape
    starts = _run_starts(c)
    cap = np.where(c == 0, 127, 31)
    latest = np.maximum.accumulate(np.where(starts, np.arange(W), -1), axis=1)
    flags = np.zeros((L, W), np.uint8)
    nseg = np.zeros(L, np.int64)
    for p0 in range(0, W, group):
        cells = range(p0, min(p0 + group + 1, W))  # the group and the next cell
        rems = [(p0 - latest[:, p0]) % cap[:, p0]]
        for i in cells[1:]:
            r = rems[-1]
            rems.append(np.where(starts[:, i] | (r == cap[:, i] - 1), 0, r + 1))
        for k, i in enumerate(cells[: group]):
            seg_start_next = k + 1 < len(rems) and i + 1 < n
            last = (rems[k + 1] == 0 if seg_start_next else False) | (i == n - 1)
            flags[:, i] = np.where(last, _BASE[np.minimum(c[:, i], 4)] | (rems[k] + 1), 0)
            nseg += (rems[k] == 0) & (i < n)
    return flags, nseg.astype(np.int32)


@pytest.mark.parametrize("name", CASES + list(EDGE))
@pytest.mark.parametrize("group", [4, 16, 80])
def test_group_counter_model_matches_plain(group, name):
    codes, S = _encode_case(name)
    _assert_equal(_counter_model(codes, S, group), torch_rle.rle_encode_plain(_t(codes), S))


# SIMD-within-a-word operations on uint32 arrays, as CUDA defines them
_U = np.uint32


def _u(x):
    return np.asarray(x, dtype=np.int64).astype(_U)


def _bytes(x):
    return np.ascontiguousarray(_u(x)).view(np.uint8).reshape(np.shape(x) + (4,))


def _word(b):
    return np.ascontiguousarray(b.astype(np.uint8)).view(_U).reshape(b.shape[:-1])


def _byte_perm(x, y, s):
    x, y, s = np.broadcast_arrays(_u(x), _u(y), _u(s))
    src = np.concatenate([_bytes(x), _bytes(y)], axis=-1)
    sel = np.stack([(s >> _U(4 * i)) & _U(7) for i in range(4)], axis=-1).astype(np.intp)
    return _word(np.take_along_axis(src, sel, axis=-1))


def _below(t):
    t = np.asarray(t, np.int64)
    return _u(np.where(t <= 0, 0, np.where(t >= 32, 0xFFFFFFFF, (1 << np.clip(t, 0, 31)) - 1)))


_MSBS, _LOW7 = _U(0x80808080), _U(0x7F7F7F7F)


def _nonzero(t):
    return (((t & _LOW7) + _LOW7) | t) & _MSBS


def _byte_msbs(s):
    return (s * _U(0x00204081)) >> _U(28)


def _msbs_to_bytes(s):
    return (s >> _U(7)) * _U(0xFF)


def _funnelshift_l(lo, hi, shift):
    return (hi << _U(shift)) | (lo >> _U(32 - shift))


def _bits_to_bytes(b):
    return (((b & _U(0xF)) * _U(0x00204081)) & _U(0x01010101)) * _U(0xFF)


def _nibbles(m):
    t = m | (m >> _U(4))
    return (t & _U(0xFF)) | ((t >> _U(8)) & _U(0xFF00))


def _splat(b):
    return _u(b) * _U(0x01010101)


def _bit(mask, k):
    return (mask >> _U(k)) & _U(1)


def _popc(mask):
    return sum(_bit(mask, k).astype(np.int64) for k in range(32))


def _group_words(plane, p0):
    """The 16 cells at p0 of every row as four words; 0 past the width."""
    group = np.zeros((plane.shape[0], 16), np.uint8)
    cut = plane[:, p0 : p0 + 16]
    group[:, : cut.shape[1]] = cut
    return [_word(group[:, 4 * j : 4 * j + 4]) for j in range(4)]


def _k1_word_model(codes, n):
    """K1's group arithmetic (rle_encode_rows_kernel), group by group left
    to right over all rows at once; the warp scan is the running max."""
    L, W = codes.shape
    end = min(n, W)
    flags = np.zeros((L, W), np.uint8)
    count = np.zeros(L, np.int64)
    carry = np.full(L, -1, np.int64)
    for p0 in range(0, W, 16):
        x = _group_words(codes, p0)
        prev = codes[:, p0 - 1].astype(np.int64) if p0 > 0 else None
        S = np.zeros(L, _U)
        word_before = _u(prev) << _U(24) if prev is not None else np.zeros(L, _U)
        esc_before = _u(np.where(prev == 4, 0x80000000, 0)) if prev is not None else np.zeros(L, _U)
        for j in range(4):
            esc = _nonzero(x[j] ^ _splat(4)) ^ _MSBS
            s = (_nonzero(x[j] ^ _funnelshift_l(word_before, x[j], 8)) | esc
                 | _funnelshift_l(esc_before, esc, 8))
            S |= _byte_msbs(s) << _U(4 * j)
            word_before, esc_before = x[j], esc
        if prev is None:
            S |= _U(1)
        if p0 + 16 < W:
            nxt, last_code = codes[:, p0 + 16].astype(np.int64), (x[3] >> _U(24)).astype(np.int64)
            S |= np.where((nxt != last_code) | (nxt == 4) | (last_code == 4), _U(1 << 16), _U(0))
        S &= _below(W - p0)
        own = (S & _U(0xFFFF)).astype(np.int64)
        hb = np.full(L, -1, np.int64)
        for k in range(16):
            hb = np.where((own >> k) & 1, k, hb)
        run_start = carry
        carry = np.maximum(carry, np.where(own > 0, p0 + hb, -1))
        c0 = (x[0] & _U(0xFF)).astype(np.int64)
        cap0 = np.where(c0 == 0, 127, 31)
        d0 = np.where(_bit(S, 0) > 0, 0, p0 - run_start)
        rem0 = np.where(c0 == 0, d0 % 127, d0 % 31)
        B = S.copy()
        wrap = np.where(rem0 == 0, 0, cap0 - rem0)
        ok = (wrap <= 16) & ((S & _below(wrap)) == 0)
        B |= np.where(ok, _u(1) << _u(np.minimum(wrap, 16)), _U(0))
        B &= _below(W - p0)
        count += _popc(B & _below(min(end - p0, 16)))
        Lm = (B >> _U(1)) & _below(end - p0 - 1)
        if n > p0 and n - p0 <= 16 and n <= W:
            Lm |= _U(1 << (n - 1 - p0))
        F_in, seen_in = np.zeros(L, _U), np.zeros(L, _U)
        f = []
        for j in range(4):
            k1 = _U(0x04030201) + _splat(4 * j)
            seen = _bits_to_bytes(B >> _U(4 * j))
            F = k1 & seen
            F |= ~seen & (F << _U(8))
            seen |= seen << _U(8)
            F |= ~seen & (F << _U(16))
            seen |= seen << _U(16)
            F |= ~seen & F_in
            seen |= seen_in
            F_in = _byte_perm(F, 0, 0x3333)
            seen_in = _u(np.where(seen >> _U(31), 0xFFFFFFFF, 0))
            rem = (seen & (k1 - F)) | (~seen & (_splat(rem0) + k1 - _splat(1)))
            low = _byte_perm(0x80C0A000, 0, _nibbles(x[j] & _splat(3)))
            high = _msbs_to_bytes(_nonzero(x[j] & _splat(0xFC)))
            base = (low & ~high) | (high & _splat(0xE0))
            f.append((base | (rem + _splat(1))) & _bits_to_bytes(Lm >> _U(4 * j)))
        out = np.stack([_bytes(w) for w in f], axis=1).reshape(L, 16)
        flags[:, p0 : p0 + 16] = out[:, : min(16, W - p0)]
    return flags, count.astype(np.int32)


def _k2_word_model(flags, n):
    """K2's group arithmetic (rle_decode_rows_kernel), group by group right
    to left over all rows at once."""
    L, W = flags.shape
    end = min(n, W)
    codes = np.zeros((L, W), np.uint8)
    total = np.zeros(L, np.int64)
    carry = np.full(L, 4, np.int64)
    for p0 in range((W - 1) // 16 * 16, -1, -16):
        x = _group_words(flags, p0)
        P = np.zeros(L, _U)
        for j in range(4):
            P |= _byte_msbs(_nonzero(x[j])) << _U(4 * j)
        in_code = carry
        first = np.full(L, -1, np.int64)
        for k in range(15, -1, -1):
            word = x[k // 4]
            code = _byte_perm(0, 0x04020103, (word >> _U(8 * (k % 4) + 5)) & _U(7)) & _U(0xFF)
            first = np.where(_bit(P, k) > 0, code.astype(np.int64), first)
        carry = np.where(first >= 0, first, carry)
        fill = _u(in_code)
        c = [None] * 4
        for j in range(3, -1, -1):
            known = _msbs_to_bytes(_nonzero(x[j]))
            v = _byte_perm(0, 0x04020103, _nibbles((x[j] >> _U(5)) & _U(0x07070707))) & known
            v |= ~known & (v >> _U(8))
            known |= known >> _U(8)
            v |= ~known & (v >> _U(16))
            known |= known >> _U(16)
            c[j] = v | (~known & _splat(fill))
            fill = c[j] & _U(0xFF)
        below_n = end - p0
        halves = np.zeros(L, _U)
        for j in range(4 if below_n > 0 else 0):
            hi = _msbs_to_bytes(x[j] & _MSBS)
            esc = _msbs_to_bytes(x[j] & (x[j] << _U(1)) & (x[j] << _U(2)) & _MSBS)
            run_len = x[j] & (_LOW7 ^ (hi & _splat(0x60)))
            run_len = (run_len & ~esc) | (esc & _splat(1))
            if below_n < 16:
                run_len &= _bits_to_bytes(_below(below_n) >> _U(4 * j))
            halves += (run_len & _U(0x00FF00FF)) + ((run_len >> _U(8)) & _U(0x00FF00FF))
        total += ((halves & _U(0xFFFF)) + (halves >> _U(16))).astype(np.int64)
        out = np.stack([_bytes(w) for w in c], axis=1).reshape(L, 16)
        codes[:, p0 : p0 + 16] = out[:, : min(16, W - p0)]
    return codes, total.astype(np.int32)


@pytest.mark.parametrize("name", CASES + list(EDGE))
def test_k1_word_model_matches_plain(name):
    codes, S = _encode_case(name)
    _assert_equal(_k1_word_model(codes, S), torch_rle.rle_encode_plain(_t(codes), S))


@pytest.mark.parametrize("name", CASES + list(EDGE) + list(FLAG_EDGE) + ["malformed"])
def test_k2_word_model_matches_plain(name):
    if name in FLAG_EDGE:
        flags, S = FLAG_EDGE[name]
    elif name == "malformed":
        rng = np.random.default_rng(45)
        flags, S = rng.integers(0, 256, (64, 1000), dtype=np.uint8), 990
        flags[rng.random((64, 1000)) < 0.9] = 0
    else:
        codes, S = _encode_case(name)
        flags = torch_rle.rle_encode_plain(_t(codes), S)[0].numpy()
    _assert_equal(_k2_word_model(flags, S), torch_rle.rle_decode_plain(_t(flags), S))


def test_build_compiles_once_per_source(monkeypatch, tmp_path):
    commands = []

    def fake_nvcc(cmd, **kwargs):
        commands.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    lib = _build.build("rle_kernels")
    assert lib.exists() and "sm_90a" in " ".join(commands[0])
    assert not any(arg.startswith("-D") for arg in commands[0])
    assert _build.build("rle_kernels") == lib and len(commands) == 1  # built once


@pytest.mark.parametrize("rows,blocks", geometry_sweep.GRID)
def test_geometry_sweep_patches_only_a_copy(rows, blocks):
    """The sweep's copy differs from rle_kernels.cu in K1's and K2's
    geometry alone; the package's source keeps one warp a row, four rows a
    CTA and no minimum blocks."""
    source = (_build.CSRC / "rle_kernels.cu").read_text()
    patched = geometry_sweep.patched_source(rows, blocks)
    assert f"constexpr int CTA_WARPS = {rows};" in patched
    assert patched.count(f"__launch_bounds__(CTA_THREADS, {blocks})") == 2
    changed = [(a, b) for a, b in zip(source.splitlines(), patched.splitlines()) if a != b]
    assert len(changed) == 2 + (rows != 4)
    assert len(source.splitlines()) == len(patched.splitlines())
    assert "constexpr int CTA_WARPS = 4;" in source
