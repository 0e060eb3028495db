"""The port's sharded codec (vcfc_tpu_torch.parallel, engine.compress_sharded /
decompress_sharded) against vcfc_tpu's.

Each of the six ``.vcfc`` shard steps runs over an 8-shard CPU mesh
(``make_data_mesh(devices=("cpu",) * 8)``) beside the JAX step on
``make_data_mesh(8)``, the conftest's 8 virtual devices, on the same
seeded numpy inputs: flags, counts, histograms, offsets, n_ok and text
words must be equal element by element.  The sharded codec must give
``vcfc_tpu.engine``'s bytes and the format oracle's at 1, 2 and 8 shards.
The CUDA shards are held to these in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from test_fuzz import make_vcf

from vcfc_tpu import engine as jax_engine
from vcfc_tpu.format import compress_bytes
from vcfc_tpu.ops.rle import rle_encode as jax_rle_encode
from vcfc_tpu.parallel import mesh as jax_mesh
from vcfc_tpu.parallel import shard as jax_shard
from vcfc_tpu_torch import engine
from vcfc_tpu_torch.parallel import dryrun, shard
from vcfc_tpu_torch.parallel.mesh import DATA_AXIS, make_data_mesh

CPU8 = ("cpu",) * 8
P = [0.8, 0.07, 0.07, 0.04, 0.02]
# (L, S_pad, n): the dry run's batch, and a wider one with n < S_pad
SHAPES = [(64, 128, 100), (128, 384, 300)]


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_data_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return make_data_mesh(devices=CPU8)


def _codes(L, S_pad, n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.choice(5, size=(L, S_pad), p=P).astype(np.uint8)
    codes[:, n:] = 0
    codes[-3:] = 0  # zero-padded rows, as the engine pads a chunk
    return codes


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), w)


def test_mesh_of_listed_devices():
    assert make_data_mesh(devices=CPU8) == (torch.device("cpu"),) * 8
    assert make_data_mesh(devices=["cpu"]) == (torch.device("cpu"),)
    assert DATA_AXIS == jax_mesh.DATA_AXIS


def test_default_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.compress_sharded(make_vcf(40, 20, 10))


def test_rows_must_split_evenly(mesh8):
    step = shard.make_sharded_decode_step(mesh8)
    with pytest.raises(ValueError, match="equal shards"):
        step(np.zeros((60, 128), np.uint8), 100)
    with pytest.raises(ValueError, match="built for width 256"):
        shard.make_sharded_encode_step(mesh8, 256)(np.zeros((64, 128), np.uint8), 100)


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_encode_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad)
    got = shard.make_sharded_encode_step(mesh8, S_pad)(codes, n)
    want = jax_shard.make_sharded_encode_step(jax_mesh8)(codes, n)
    _assert_equal(got, want)
    # the offsets are the exclusive prefix of the per-shard flag counts
    per_shard = got[1].numpy().reshape(8, -1).sum(axis=1)
    np.testing.assert_array_equal(got[3].numpy(), np.cumsum(per_shard) - per_shard)
    assert int(got[2].sum()) == L * n


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_codebook_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad + 1)
    got = shard.make_sharded_codebook_step(mesh8)(codes, n)
    _assert_equal(got, jax_shard.make_sharded_codebook_step(jax_mesh8)(codes, np.int32(n)))
    assert int(got[2].sum()) == int(got[1].sum())


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_decode_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad + 2)
    flagpos = np.asarray(jax_rle_encode(codes, n)[0])
    got = shard.make_sharded_decode_step(mesh8, S_pad)(flagpos, n)
    _assert_equal(got, jax_shard.make_sharded_decode_step(jax_mesh8)(flagpos, n))
    np.testing.assert_array_equal(got[0].numpy()[:, :n], codes[:, :n])


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_unpack_decode_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad + 3)
    packed, nflags = dryrun.pack_flags(np.asarray(jax_rle_encode(codes, n)[0]))
    got = shard.make_sharded_unpack_decode_step(mesh8, S_pad)(packed, nflags, n)
    want = jax_shard.make_sharded_unpack_decode_step(jax_mesh8, S_pad)(packed, nflags, np.int32(n))
    _assert_equal(got, want)
    np.testing.assert_array_equal(got[0].numpy()[:, :n], codes[:, :n])


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_text_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad + 4)
    text = dryrun.code_words(codes, n)
    text[5, 7] = (text[5, 7] & 0x00FFFFFF) | (ord("x") << 24)  # a mis-sliced row
    got = shard.make_sharded_text_step(mesh8)(text, n)
    _assert_equal(got, jax_shard.make_sharded_text_step(jax_mesh8)(text, n))
    assert int(got[3][5]) == 0 and int(got[3].sum()) == L - 1


@pytest.mark.parametrize("L,S_pad,n", SHAPES)
def test_roundtrip_step_matches_jax(jax_mesh8, mesh8, L, S_pad, n):
    codes = _codes(L, S_pad, n, seed=S_pad + 5)
    got = shard.make_sharded_roundtrip_step(mesh8)(codes, n)
    _assert_equal(got, jax_shard.make_sharded_roundtrip_step(jax_mesh8)(codes, n))
    assert int(got[1]) == 8


def test_roundtrip_counts_the_shards_that_match(mesh8, monkeypatch):
    """n_ok counts shards, not rows: one wrong cell in the second shard's
    decode leaves 7 of 8."""
    real_decode = shard.rle_decode
    calls = []

    def decode(flagpos, n):
        codes, decoded = real_decode(flagpos, n)
        calls.append(flagpos.shape)
        if len(calls) == 2:
            codes = codes.clone()
            codes[0, 0] ^= 1
        return codes, decoded

    monkeypatch.setattr(shard, "rle_decode", decode)
    _codes_out, n_ok, _hist = shard.make_sharded_roundtrip_step(mesh8)(_codes(64, 128, 100, 9), 100)
    assert int(n_ok) == 7 and calls == [(8, 128)] * 8


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_compress_sharded_matches_jax_and_oracle(n_shards):
    vcf = make_vcf(901 + n_shards, 140, 90, sv_every=13)
    want = compress_bytes(vcf)
    got = engine.compress_sharded(vcf, ("cpu",) * n_shards)
    assert got == want
    assert got == jax_engine.compress_sharded(vcf, jax_mesh.make_data_mesh(n_shards))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_decompress_sharded_matches_jax_and_oracle(n_shards):
    vcf = make_vcf(911 + n_shards, 140, 90, sv_every=13)
    vcfc = compress_bytes(vcf)
    got = engine.decompress_sharded(vcfc, ("cpu",) * n_shards)
    assert got == vcf
    assert got == jax_engine.decompress_sharded(vcfc, jax_mesh.make_data_mesh(n_shards))


@pytest.mark.parametrize("seed,samples,variants", [(921, 1, 40), (922, 60, 4500), (923, 1000, 30)])
def test_sharded_codec_on_more_corpora(seed, samples, variants):
    """One sample, three chunks of 2,048 lines, and a width past 128."""
    vcf = make_vcf(seed, samples, variants, sv_every=9)
    vcfc = compress_bytes(vcf)
    assert engine.compress_sharded(vcf, CPU8) == vcfc
    assert engine.decompress_sharded(vcfc, CPU8) == vcf


def test_sharded_codec_without_native(monkeypatch, small_vcf, small_vcfc):
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")
    assert engine.compress_sharded(small_vcf, CPU8) == small_vcfc
    assert engine.decompress_sharded(small_vcfc, CPU8) == small_vcf


def test_sharded_codec_of_a_header_only_file(small_vcf):
    header = small_vcf[: small_vcf.index(b"\n", small_vcf.index(b"#CHROM")) + 1]
    assert engine.compress_sharded(header, CPU8) == compress_bytes(header)
    assert engine.decompress_sharded(compress_bytes(header), CPU8) == header


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_dryrun_multichip_on_cpu_shards(n_devices):
    dryrun.dryrun_multichip(n_devices, devices=("cpu",) * n_devices)


def test_dryrun_refuses_a_mesh_of_another_size():
    with pytest.raises(AssertionError, match="want 8"):
        dryrun.dryrun_multichip(8, devices=("cpu",) * 4)


def test_dryrun_batch_is_the_jax_dry_runs():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for L, S_pad, seed in ((64, 128, 1), (256, 128, 0)):
        np.testing.assert_array_equal(dryrun.example_codes(L, S_pad, seed),
                                      mod._example_codes(L, S_pad, seed))
