"""Seeded synthetic VCF generator: a 1000-Genomes-like cohort.

The port's copy of ``generate_realistic_vcf`` from
``vcfc_tpu/eval/random_vcf.py``: the same arguments give the same bytes.
"""

from __future__ import annotations

import math

import numpy as np

BASES = ["A", "T", "G", "C"]


# 1000 Genomes phase-3 autosome proportions (variant share per contig,
# roughly tracking contig length); X appended at ~3.9%.  Used by the
# realistic generator's default full-contig sweep.
_CONTIG_WEIGHTS = (
    ("1", 0.081), ("2", 0.089), ("3", 0.074), ("4", 0.075), ("5", 0.067),
    ("6", 0.064), ("7", 0.060), ("8", 0.058), ("9", 0.045), ("10", 0.051),
    ("11", 0.051), ("12", 0.049), ("13", 0.037), ("14", 0.034),
    ("15", 0.031), ("16", 0.033), ("17", 0.029), ("18", 0.029),
    ("19", 0.023), ("20", 0.023), ("21", 0.014), ("22", 0.014),
    ("X", 0.039), ("Y", 0.002), ("MT", 0.001),
)


def generate_realistic_vcf(
    sample_count: int = 2504,
    variant_count: int = 10_000,
    seed: int = 5,
    start_pos: int = 16_050_075,
    pos_step: int = 32,
    maf_min: float | None = None,
    missing_rate: float = 0.004,
    unphased_rate: float = 0.0,
    multiallelic_rate: float = 0.05,
    indel_rate: float = 0.04,
    mutation_rate: float = 1.0,
    contigs: tuple[tuple[str, float], ...] | None = None,
    unknown_contigs: tuple[str, ...] = (),
) -> bytes:
    """1000-Genomes-workload-faithful synthetic cohort (VERDICT r4 #6).

    The plain generators of ``vcfc_tpu/eval/random_vcf.py`` reproduce the
    reference's own crude distribution (other/random_vcf.py:66-70: fixed per-haplotype allele
    probs, single contig, no missing data).  Real population VCFs (the
    reference's actual eval corpus, evaluation_main.py:36-64) differ in
    ways that hit every codec path:

      allele-frequency spectrum  per-variant MAF drawn from the neutral
          1/f site-frequency spectrum (most variants rare — long 0|0
          runs; occasional common variants — dense het/hom lines),
          f = maf_min * (0.5/maf_min)**u, the inverse-CDF of 1/f on
          [maf_min, 0.5]; maf_min defaults to one carrier chromosome
          (1/(2N), the singleton floor)
      missing genotypes   './.' cells at ``missing_rate`` (escape path)
      unphased calls      'a/b' separators at ``unphased_rate`` (escape)
      multi-allelic sites a second ALT at ``multiallelic_rate`` whose
          allele-2 carriers ride the escape dictionary ('2|0', ...)
      indels              REF/ALT length > 1 at ``indel_rate`` (stresses
          required-column entropy + END-position query arithmetic)
      real INFO           AC/AF/AN recomputed from the drawn genotypes
          (required-column bytes carry the spectrum, like real data)
      full contig set     variants spread over 1-22/X/Y/MT by real
          proportions (``contigs`` overrides); ``unknown_contigs`` emits
          leading contigs OUTSIDE the known ordinal map — they all map
          to ordinal 0 (utils/refmap.py unknown->0, the reference's
          footgun) and the file stays ordinal-sorted because 0 sorts
          first
      LD                  ``mutation_rate`` < 1 copies the previous
          line's cells per sample (same mechanism as
          generate_correlated_vcf), composing with all of the above

    Output is plain VCFv4.1 text, GT-only FORMAT, byte-deterministic in
    ``seed``.
    """
    rng = np.random.default_rng(seed)
    if maf_min is None:
        maf_min = 1.0 / max(2 * sample_count, 4)
    if contigs is None:
        contigs = _CONTIG_WEIGHTS
    plan: list[tuple[str, int]] = []
    total_w = sum(w for _c, w in contigs)
    left = variant_count
    for k, (name, w) in enumerate(contigs):
        n = left if k == len(contigs) - 1 else min(
            int(round(variant_count * w / total_w)), left
        )
        if n > 0:
            plan.append((name, n))
        left -= n
    if unknown_contigs:
        # unknown names map to ordinal 0 (< every known contig), so they
        # must LEAD the file for it to remain ordinal-sorted
        n_unk = max(variant_count // 50, 1)
        plan = [(c, n_unk) for c in unknown_contigs] + plan

    out = bytearray()
    out += b"##fileformat=VCFv4.1\n"
    out += b'##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    out += b'##INFO=<ID=AC,Number=A,Type=Integer,Description="Alt allele count">\n'
    out += b'##INFO=<ID=AF,Number=A,Type=Float,Description="Alt allele frequency">\n'
    out += b'##INFO=<ID=AN,Number=1,Type=Integer,Description="Alleles genotyped">\n'
    out += b"##fileDate=20150218\n"
    header = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
    digits = max(int(math.ceil(math.log10(max(sample_count, 2)))), 1)
    header += [f"HG{j:0{digits}d}" for j in range(sample_count)]
    out += "\t".join(header).encode() + b"\n"

    # all cells are 4 bytes ('a|b\t', './.\t') — one dense (S, 4) plane
    gt_bytes = np.zeros((3, 3, 4), np.uint8)
    for a in range(3):
        for b in range(3):
            gt_bytes[a, b] = np.frombuffer(f"{a}|{b}\t".encode(), np.uint8)
    missing_cell = np.frombuffer(b"./.\t", np.uint8)

    S = sample_count
    a1 = np.zeros(S, np.int64)
    a2 = np.zeros(S, np.int64)
    for chrom, n_lines in plan:
        pos = start_pos
        first_of_contig = True
        for _ in range(n_lines):
            # neutral-spectrum MAF; multi-allelic sites split the ALT
            # mass 70/30 between alleles 1 and 2
            f = maf_min * (0.5 / maf_min) ** rng.random()
            multi = rng.random() < multiallelic_rate
            p2 = 0.3 * f if multi else 0.0
            probs = (1.0 - f, f - p2, p2)
            n1 = rng.choice(3, size=S, p=probs)
            n2 = rng.choice(3, size=S, p=probs)
            if mutation_rate < 1.0 and not first_of_contig:
                redraw = rng.random(S) < mutation_rate
                a1 = np.where(redraw, n1, a1)
                a2 = np.where(redraw, n2, a2)
            else:
                a1, a2 = n1, n2
            first_of_contig = False

            row = gt_bytes[a1, a2].copy()
            if unphased_rate:
                unph = rng.random(S) < unphased_rate
                row[unph, 1] = ord("/")
            if missing_rate:
                miss = rng.random(S) < missing_rate
                row[miss] = missing_cell
            else:
                miss = None

            # INFO recomputed from the drawn cells (AF carries the
            # spectrum into the required-column byte stream)
            called = ~miss if miss is not None else np.ones(S, bool)
            an = 2 * int(called.sum())
            ac1 = int((a1[called] == 1).sum() + (a2[called] == 1).sum())
            if multi:
                ac2 = int((a1[called] == 2).sum() + (a2[called] == 2).sum())
            ref = BASES[rng.integers(4)]
            alts = [b for b in BASES if b != ref]
            if rng.random() < indel_rate:
                if rng.random() < 0.5:  # deletion: multi-base REF
                    ref = ref + "".join(
                        BASES[rng.integers(4)] for _ in range(rng.integers(1, 4))
                    )
                    alt_field = ref[0]
                else:  # insertion: multi-base ALT
                    alt_field = ref + "".join(
                        BASES[rng.integers(4)] for _ in range(rng.integers(1, 4))
                    )
            else:
                alt_field = alts[0]
            if multi:
                alt_field = f"{alt_field},{alts[1] if alts[1] != alt_field else alts[2]}"
            if an:
                if multi:
                    info = (
                        f"AC={ac1},{ac2};AF={ac1 / an:.4f},{ac2 / an:.4f};AN={an}"
                    )
                else:
                    info = f"AC={ac1};AF={ac1 / an:.4f};AN={an}"
            else:
                info = "AN=0"
            rsid = f"rs{int(rng.integers(1_000_000, 200_000_000))}" if rng.random() < 0.95 else "."
            prefix = "\t".join(
                [chrom, str(pos), rsid, ref, alt_field, "100", "PASS", info, "GT"]
            )
            line_cells = row.reshape(-1)[:-1]
            out += prefix.encode() + b"\t" + line_cells.tobytes() + b"\n"
            pos += int(rng.integers(1, 2 * pos_step))
    return bytes(out)

