"""The port's engine and CLI (vcfc_tpu_torch) against vcfc_tpu's.

Byte-for-byte against the golden fixtures, the JAX engine on its CPU
backend and the format oracle, on the plain PyTorch kernels
(``device="cpu"``).
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_fuzz import make_vcf

from vcfc_tpu import engine as jax_engine
from vcfc_tpu.format import compress_bytes, decompress_bytes
from vcfc_tpu_torch import cli, engine

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=["small", "sv"])
def fixture_pair(request, data_dir):
    return (
        (data_dir / f"{request.param}.vcf").read_bytes(),
        (data_dir / f"{request.param}.vcfc").read_bytes(),
    )


def test_golden_fixtures_on_the_device_path(fixture_pair):
    vcf, vcfc = fixture_pair
    assert engine.compress(vcf, force_device=True, device=CPU) == vcfc
    assert engine.decompress(vcfc, force_device=True, device=CPU) == vcf


def test_golden_fixtures_through_the_size_gate(fixture_pair):
    vcf, vcfc = fixture_pair  # too small for the device: the oracle route
    assert engine.compress(vcf, device=CPU) == vcfc
    assert engine.decompress(vcfc, device=CPU) == vcf


@pytest.mark.parametrize(
    "seed,samples,variants",
    [(31, 1, 40), (32, 127, 90), (33, 300, 120), (34, 1000, 40)],
)
def test_random_vcfs_match_the_jax_engine_and_oracle(seed, samples, variants):
    """Escapes, 0|0 rows longer than 127 (every 23rd row is uniform) and
    SV lines."""
    vcf = make_vcf(seed, samples, variants, sv_every=9)
    got = engine.compress(vcf, force_device=True, device=CPU)
    assert got == jax_engine.compress(vcf, force_device=True)
    assert got == compress_bytes(vcf)
    back = engine.decompress(got, force_device=True, device=CPU)
    assert back == jax_engine.decompress(got, force_device=True) == vcf
    assert decompress_bytes(got) == vcf


@pytest.mark.parametrize("line_batch", [1, 256, 700])
def test_line_batches_split_rows_alike(line_batch):
    vcf = make_vcf(35, 200, 700)
    got = engine.compress(vcf, line_batch=line_batch, force_device=True, device=CPU)
    assert got == compress_bytes(vcf)
    assert engine.decompress(got, line_batch=line_batch, force_device=True, device=CPU) == vcf


def test_host_executor(fixture_pair, monkeypatch):
    vcf, vcfc = fixture_pair
    monkeypatch.setenv("VCFC_EXECUTOR", "host")
    assert engine.compress(vcf, force_device=True, device=CPU) == vcfc
    assert engine.decompress(vcfc, force_device=True, device=CPU) == vcf


def test_numpy_host_path_without_native(fixture_pair, monkeypatch):
    vcf, vcfc = fixture_pair
    monkeypatch.setenv("VCFC_NO_NATIVE", "1")
    assert engine.compress(vcf, force_device=True, device=CPU) == vcfc
    assert engine.decompress(vcfc, force_device=True, device=CPU) == vcf


def test_force_device_env(small_vcf, small_vcfc, monkeypatch):
    def oracle(_vcf):
        raise AssertionError("the oracle route was taken")

    monkeypatch.setenv("VCFC_FORCE_DEVICE", "1")
    monkeypatch.setattr(engine, "compress_bytes", oracle)
    assert engine.compress(small_vcf, device=CPU) == small_vcfc


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 14, 1 << 16])
def test_streams_match_whole_buffers(chunk):
    vcf = make_vcf(36, 130, 900, sv_every=9)
    vcfc = engine.compress(vcf, device=CPU)
    out = io.BytesIO()
    n = engine.compress_stream(io.BytesIO(vcf), out, chunk_bytes=chunk, device=CPU)
    assert out.getvalue() == vcfc and n == len(vcfc)
    back = io.BytesIO()
    n = engine.decompress_stream(io.BytesIO(vcfc), back, chunk_bytes=chunk, device=CPU)
    assert back.getvalue() == vcf and n == len(vcf)


@pytest.mark.parametrize("native_env", [None, "1"], ids=["native", "numpy"])
def test_truncated_vcfc_raises_as_the_jax_engine_does(small_vcfc, monkeypatch, native_env):
    if native_env:
        monkeypatch.setenv("VCFC_NO_NATIVE", native_env)
    for cut in (660, 5000, len(small_vcfc) - 1):
        bad = small_vcfc[:cut]
        with pytest.raises(Exception) as want:
            jax_engine.decompress(bad, force_device=True)
        with pytest.raises(ValueError) as got:
            engine.decompress(bad, force_device=True, device=CPU)
        # the port raises its own copy of the JAX package's exception class
        assert got.type.__name__ == want.type.__name__
        assert [c.__name__ for c in got.type.__mro__] == [c.__name__ for c in want.type.__mro__]


def test_truncated_stream_raises(small_vcfc):
    from vcfc_tpu_torch.format.lines import VcfValidationError

    with pytest.raises(VcfValidationError, match="truncated"):
        engine.decompress_stream(io.BytesIO(small_vcfc[:-3]), io.BytesIO(), device=CPU)


@pytest.mark.parametrize("stream", ["0", "1"])
def test_cli_verbs(tmp_path, small_vcf, small_vcfc, monkeypatch, stream):
    monkeypatch.setattr(engine, "_device", lambda _device: torch.device(CPU))
    monkeypatch.setenv("VCFC_FORCE_DEVICE", "1")
    monkeypatch.setenv("VCFC_STREAM", stream)
    src, mid, out = tmp_path / "in.vcf", tmp_path / "in.vcfc", tmp_path / "out.vcf"
    src.write_bytes(small_vcf)
    assert cli.main(["compress", str(src), str(mid)]) == 0
    assert mid.read_bytes() == small_vcfc
    assert cli.main(["decompress", str(mid), str(out)]) == 0
    assert out.read_bytes() == small_vcf


def test_cli_usage_errors(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(engine, "_device", lambda _device: torch.device(CPU))
    assert cli.main([]) == 1
    assert cli.main(["compress", "only-one"]) == 1
    assert cli.main(["compress", str(tmp_path / "missing"), "b"]) == 1
    assert "does not exist" in capsys.readouterr().out
    assert cli.main(["query", "x.vcfc", "1"]) == 2
    assert "not ported" in capsys.readouterr().err
    monkeypatch.setenv("VCFC_SHARDED", "1")
    assert cli.main(["compress", "a", "b"]) == 2


@pytest.mark.parametrize("var", ["VCFC_PARSE", "VCFC_UNPACK"])
def test_later_slice_routes_raise(small_vcf, small_vcfc, monkeypatch, var):
    """Each env-selected device route runs instead of the parse route (on
    the plain kernel versions here): VCFC_PARSE=device the text route in
    both directions, VCFC_UNPACK=device the packed-unpack route in
    decompress."""
    monkeypatch.setenv(var, "device")

    def parse_route(*_args):
        raise AssertionError("the parse route was taken")

    if var == "VCFC_PARSE":
        monkeypatch.setattr(engine, "encode_on_device", parse_route)
    monkeypatch.setattr(engine, "decode_on_device", parse_route)
    assert engine.compress(small_vcf, force_device=True, device=CPU) == small_vcfc
    assert engine.decompress(small_vcfc, force_device=True, device=CPU) == small_vcf


def test_default_device_needs_cuda(small_vcf, small_vcfc, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: engine.compress(small_vcf),
        lambda: engine.decompress(small_vcfc),
        lambda: engine.compress_stream(io.BytesIO(small_vcf), io.BytesIO()),
        lambda: engine.decompress_stream(io.BytesIO(small_vcfc), io.BytesIO()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    src = tmp_path / "in.vcf"
    src.write_bytes(small_vcf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["compress", str(src), str(tmp_path / "out.vcfc")])


def test_port_imports_neither_jax_nor_triton():
    """Every module of the port, and chip_smoke, loads no jax, no triton
    and nothing of the JAX package vcfc_tpu."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import vcfc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vcfc_tpu_torch.__path__, 'vcfc_tpu_torch.')\n"
        "         if m.name != 'vcfc_tpu_torch.__main__']  # __main__ runs the CLI\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton', 'vcfc_tpu') "
        "or m.startswith(('jax.', 'triton.', 'vcfc_tpu.'))]\n"
        "print(json.dumps({'imported': names, 'bad': sorted(bad)}))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    out = json.loads(r.stdout)
    assert out["bad"] == []
    assert {"vcfc_tpu_torch.engine", "vcfc_tpu_torch.host.native",
            "vcfc_tpu_torch.eval.random_vcf", "vcfc_tpu_torch.ops.cuda_rle",
            "vcfc_tpu_torch.ops.probe", "vcfc_tpu_torch.eval.kernel_ceiling",
            "vcfc_tpu_torch.eval.bench_codes", "vcfc_tpu_torch.eval.timing"} <= set(out["imported"])
