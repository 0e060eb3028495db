"""Command line of the port, with the reference's argv shapes:

  python -m vcfc_tpu_torch compress <input.vcf> <output.vcfc>
  python -m vcfc_tpu_torch decompress <input.vcfc> <output.vcf>
  python -m vcfc_tpu_torch compress-z <input.vcf|.vcfc> <output.vcfz> [version]
  python -m vcfc_tpu_torch decompress-z <input.vcfz> <output.vcf>
  python -m vcfc_tpu_torch query-z <input.vcfz> <region>

Inputs larger than VCFC_STREAM_THRESHOLD bytes (1 GiB by default), or any
input when VCFC_STREAM=1, go through the bounded-memory streaming engine,
as in ``vcfc_tpu.cli``.  VCFC_SHARDED=1 runs ``engine.compress_sharded`` /
``decompress_sharded`` over every visible CUDA device instead, on the whole
input (no streaming).  The .vcfz verbs are ``vcfc_tpu.cli``'s:
``compress-z`` compresses a VCF with ``engine.compress`` first (K1 on the
card) and writes the container of ``format.vcfz``, on the device route for
v1, v2, v3, v5 and v8 when VCFZ_PACK=device; ``decompress-z`` decodes the
reconstructed .vcfc with ``engine.decompress`` (K2 on the card).  A route
not ported yet (VCFZ_PACK=device for v4, v6 and v7, and for decompress-z)
prints why and exits 2, as do the other verbs of ``vcfc_tpu.cli``.
"""

from __future__ import annotations

import os
import struct
import sys

USAGE = """usage: python -m vcfc_tpu_torch <action> <input> <output>
actions: compress decompress compress-z decompress-z query-z"""

Z_VERBS = ("compress-z", "decompress-z", "query-z")


def parse_coordinate_string(s: str):
    """Region parse with the reference's clean-error behavior: a bad
    region prints the message and exits 1 instead of a traceback."""
    from .query.coordinate import parse_coordinate_string as parse

    try:
        return parse(s)
    except ValueError as e:
        print(e)
        raise SystemExit(1)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _emit(chunks) -> None:
    out = sys.stdout.buffer
    for chunk in chunks:
        out.write(chunk)
    out.flush()


def _z_verb(action: str, args: list[str]) -> int:
    """The .vcfz extension verbs, with ``vcfc_tpu.cli``'s argv shapes,
    messages and exit codes."""
    if action == "compress-z":
        if len(args) not in (2, 3):
            print("Usage: vcfc compress-z <input.vcf|.vcfc> <output.vcfz> [version]")
            return 1
        from . import engine
        from .format.headers import decode_length_header
        from .format.vcf import parse_metadata_headers
        from .format.vcfz import VERSION, vcfz_from_vcfc

        try:
            z_version = int(args[2]) if len(args) == 3 else VERSION
        except ValueError:
            z_version = 0
        if z_version not in (1, 2, 3, 4, 5, 6, 7, 8):
            print("vcfz version must be 1-8")
            return 1
        data = _read(args[0])
        # accept plain VCF (compress first) or an existing .vcfc: a .vcfc
        # data line starts with a 0xC0-flagged length header, ASCII never does
        h = parse_metadata_headers(data)
        is_vcfc = False
        if h.data_offset < len(data):
            try:
                decode_length_header(data, h.data_offset)
                is_vcfc = True
            except (ValueError, struct.error):  # short/odd tail: treat as VCF text
                is_vcfc = False
        vcfc = data if is_vcfc else engine.compress(data)
        _write(args[1], vcfz_from_vcfc(vcfc, version=z_version))
        return 0

    if action == "decompress-z":
        if len(args) != 2:
            print("Usage: vcfc decompress-z <input.vcfz> <output.vcf>")
            return 1
        from .format.vcfz import decompress_vcfz

        _write(args[1], decompress_vcfz(_read(args[0])))
        return 0

    if len(args) != 2:
        print("Usage: vcfc query-z <input.vcfz> <region>")
        return 1
    from .format.vcfz import query_vcfz

    query = parse_coordinate_string(args[1])
    _emit(query_vcfz(_read(args[0]), query))
    return 0


def main(argv: list[str] | None = None) -> int:
    """Run one verb on the CUDA device."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    action, args = argv[0], argv[1:]
    if action in Z_VERBS:
        try:
            return _z_verb(action, args)
        except NotImplementedError as e:
            print(f"{action}: {e}", file=sys.stderr)
            return 2
    if action not in ("compress", "decompress"):
        print(f"{action}: not ported to vcfc_tpu_torch yet (use python -m vcfc_tpu.cli)",
              file=sys.stderr)
        return 2
    if len(args) != 2:
        print(USAGE, file=sys.stderr)
        return 1
    input_filename, output_filename = args
    if not os.path.exists(input_filename):
        print(f"Input file does not exist: {input_filename}")
        return 1
    if input_filename == output_filename:
        raise RuntimeError("input and output file are the same")
    from . import engine

    sharded = os.environ.get("VCFC_SHARDED", "") not in ("", "0")
    stream_env = os.environ.get("VCFC_STREAM", "")
    threshold = int(os.environ.get("VCFC_STREAM_THRESHOLD", str(1 << 30)))
    use_stream = not sharded and (
        stream_env not in ("", "0")
        or (stream_env == "" and os.path.getsize(input_filename) > threshold)
    )
    if use_stream:
        run = engine.compress_stream if action == "compress" else engine.decompress_stream
        run(input_filename, output_filename)
        return 0
    data = _read(input_filename)
    if sharded:  # the sharded steps over every visible CUDA device
        run = engine.compress_sharded if action == "compress" else engine.decompress_sharded
    else:
        run = engine.compress if action == "compress" else engine.decompress
    _write(output_filename, run(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
