"""Command line of the port, with the reference's argv shapes:

  python -m vcfc_tpu_torch compress <input.vcf> <output.vcfc>
  python -m vcfc_tpu_torch decompress <input.vcfc> <output.vcf>

Inputs larger than VCFC_STREAM_THRESHOLD bytes (1 GiB by default), or any
input when VCFC_STREAM=1, go through the bounded-memory streaming engine,
as in ``vcfc_tpu.cli``.  VCFC_SHARDED=1 runs ``engine.compress_sharded`` /
``decompress_sharded`` over every visible CUDA device instead, on the whole
input (no streaming).  The other verbs of ``vcfc_tpu.cli`` are not ported.
"""

from __future__ import annotations

import os
import sys

USAGE = """usage: python -m vcfc_tpu_torch <action> <input> <output>
actions: compress decompress"""


def main(argv: list[str] | None = None) -> int:
    """Run one verb on the CUDA device."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    action, args = argv[0], argv[1:]
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
    with open(input_filename, "rb") as f:
        data = f.read()
    if sharded:  # the sharded steps over every visible CUDA device
        run = engine.compress_sharded if action == "compress" else engine.decompress_sharded
    else:
        run = engine.compress if action == "compress" else engine.decompress
    result = run(data)
    with open(output_filename, "wb") as f:
        f.write(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
