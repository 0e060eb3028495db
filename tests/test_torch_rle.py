"""The port's RLE kernels (vcfc_tpu_torch.ops) against vcfc_tpu's.

The same seeded numpy planes go through vcfc_tpu.ops.rle (XLA on the CPU),
vcfc_tpu.ops.pallas_rle (Pallas in interpret mode, as tests/test_pallas.py
runs it) and the port's plain PyTorch versions.  Every output is integers,
so every comparison is exact.  The CUDA kernels are held to the plain
versions in tests/test_torch_cuda.py; here, numpy models of their group
arithmetic (the per-group remainder recurrence, and K1's and K2's word
operations as csrc/rle_kernels.cu writes them, from
tests/_torch_word_models.py) are held to the plain versions on the same
planes and on the edge cases of vcfc_tpu_torch.eval.edge_cases.
"""

import numpy as np
import pytest
import torch

from _torch_word_models import k1_word_model, k2_word_model

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


@pytest.mark.parametrize("name", CASES + list(EDGE))
def test_k1_word_model_matches_plain(name):
    codes, S = _encode_case(name)
    _assert_equal(k1_word_model(codes, S), torch_rle.rle_encode_plain(_t(codes), S))


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
    _assert_equal(k2_word_model(flags, S), torch_rle.rle_decode_plain(_t(flags), S))


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


def _sweep_result(kernels):
    builds = [{"rows_per_cta": r, "min_blocks": b,
               **{k: {"registers": 40 + i, "local_bytes": 0, "blocks_per_sm": 9}
                  for i, k in enumerate(kernels)}} for r, b in geometry_sweep.GRID]
    ms = {plane: {f"{r},{b}": {k: 0.01 * (1 + i) for i, k in enumerate(kernels)}
                  for r, b in geometry_sweep.GRID}
          for plane in ("cohort batch 2048x2560", "gt_codes 8192x2560")}
    return {"device": "card", "builds": builds, "ms": ms}


def test_geometry_sweep_table_lists_k1_to_k4():
    """The sweep times and reports all four kernels, in the order of
    vcfc_cuda_rle_kernel_info, on both planes."""
    assert geometry_sweep.KERNELS == tuple(cuda_rle._INFO_KERNELS)
    lines = geometry_sweep.table(_sweep_result(geometry_sweep.KERNELS))
    heads = [line for line in lines if "rows/CTA" in line]
    assert len(heads) == 3 and all(h.split()[-4:] == ["K1", "K2", "K3", "K4"] for h in heads)
    rows = [line.split() for line in lines if line.startswith("  ") and "rows/CTA" not in line]
    assert len(rows) == 3 * len(geometry_sweep.GRID)
    assert rows[0][2:] == ["0.01000", "0.02000", "0.03000", "0.04000"]
    assert rows[-1][2:] == ["40/0/9", "41/0/9", "42/0/9", "43/0/9"]
    assert all(line == line.rstrip() for line in lines)


@pytest.mark.parametrize("kernel", geometry_sweep.KERNELS)
def test_geometry_sweep_outputs_are_the_plain_versions(kernel):
    """The sweep's ctypes launch allocates each kernel's outputs as its
    plain version returns them, so a build is held to it with torch.equal;
    the text kernels take the codes rendered as words."""
    codes, n = _encode_case(CASES[0])
    flags = torch_rle.rle_encode_plain(_t(codes), n)[0]
    x = {"rle_encode": _t(codes), "rle_decode": flags, "text_decode": flags,
         "text_encode": torch_rle.text_rle_decode_plain(flags, n)[0]}[kernel]
    want = geometry_sweep.PLAIN[kernel](x, n)
    spec = geometry_sweep.OUTPUTS[kernel]
    assert len(want) == len(spec)
    for out, dtype in zip(want, spec):
        assert out.dtype == (dtype or torch.int32)
        assert out.shape == (x.shape if dtype else x.shape[:1])
