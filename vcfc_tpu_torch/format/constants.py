"""Byte-level constants of the .vcfc format.

The port's copy of ``vcfc_tpu/format/constants.py``, so that
``vcfc_tpu_torch`` imports nothing of ``vcfc_tpu``.

The flag scheme packs a run of identical genotype strings into one byte
(reference: src/utils.hpp:44-56, src/compress.cpp:124-186):

  0xxxxxxx  run of "0|0", 7-bit count (1..127)
  101xxxxx  run of "0|1", 5-bit count (1..31)
  110xxxxx  run of "1|0", 5-bit count (1..31)
  100xxxxx  run of "1|1", 5-bit count (1..31)
  111xxxxx  N uncompressed sample columns follow as raw ASCII
            (the reference always emits N=1; each escaped column is
            followed by a '\t' unless it is the last sample column)
"""

VCF_REQUIRED_COL_COUNT = 8

# Flag masks (utils.hpp:44-56)
SAMPLE_MASK_00 = 0b1000_0000
SAMPLE_MASKED_00 = 0b0000_0000
SAMPLE_MASK_01_10_11 = 0b1110_0000
SAMPLE_MASKED_01 = 0b1010_0000  # 0xA0
SAMPLE_MASKED_10 = 0b1100_0000  # 0xC0
SAMPLE_MASKED_11 = 0b1000_0000  # 0x80
SAMPLE_MASK_UNCOMPRESSED = 0b1110_0000
SAMPLE_MASKED_UNCOMPRESSED = 0b1110_0000  # 0xE0

MAX_RUN_00 = 0x7F  # 127 (compress.cpp:126)
MAX_RUN_HET = 0x1F  # 31 (compress.cpp:127)

# Dense genotype symbol codes used on device (ours, not the reference's).
CODE_00 = 0
CODE_01 = 1
CODE_10 = 2
CODE_11 = 3
CODE_ESCAPE = 4

GT_STRINGS = {CODE_00: b"0|0", CODE_01: b"0|1", CODE_10: b"1|0", CODE_11: b"1|1"}

# flag byte "base" value per code; run count is OR'd in
CODE_FLAG_BASE = {
    CODE_00: 0x00,
    CODE_01: SAMPLE_MASKED_01,
    CODE_10: SAMPLE_MASKED_10,
    CODE_11: SAMPLE_MASKED_11,
    CODE_ESCAPE: SAMPLE_MASKED_UNCOMPRESSED,
}

# run-length cap per code (escape bytes always carry count=1 in the reference)
CODE_RUN_CAP = {
    CODE_00: MAX_RUN_00,
    CODE_01: MAX_RUN_HET,
    CODE_10: MAX_RUN_HET,
    CODE_11: MAX_RUN_HET,
    CODE_ESCAPE: 1,
}

VCFC_BINNING_INDEX_EXTENSION = ".vcfci"
LINE_LENGTH_HEADER_MAX_VALUE = 0x3FFF_FFFF
