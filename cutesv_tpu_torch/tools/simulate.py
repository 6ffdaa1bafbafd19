"""Synthetic long-read SV simulator.

Invents a DEL/INS truth set on a grid over a random reference and writes
a random reference FASTA, a truth bed in the VISOR HACk column layout,
and a coordinate-sorted BAM of perfect long reads carrying the planted
SVs at the requested zygosity (the ``simulate`` mode of
``cutesv_tpu/tools/simulate.py``, written with this package's own
BamWriter).
"""
from __future__ import annotations

from typing import List

import numpy as np


def _codes_to_str(codes) -> str:
    return (np.frombuffer(b"ACGT", np.uint8)[codes]).tobytes().decode()


# hg38 primary-contig lengths in Mb (chr1..chr22, X, Y) — the shape used
# by --human_layout to scale a synthetic genome to a human-like contig
# size distribution (largest ~5x the smallest autosome, 24 contigs)
_HUMAN_MB = [249, 242, 198, 190, 182, 171, 159, 145, 138, 134, 135, 133,
             114, 107, 102, 90, 83, 80, 59, 64, 47, 51, 156, 57]


def simulate(out_prefix: str, genome_mb: float = 10.0, n_chroms: int = 2,
             coverage: int = 20, read_len: int = 20_000,
             sv_spacing: int = 50_000, seed: int = 0,
             zygosity: str = "het", human_layout: bool = False):
    from cutesv_tpu_torch.io.bam import BamWriter

    rng = np.random.default_rng(seed)
    if human_layout:
        total = int(genome_mb * 1_000_000)
        scale = total / (sum(_HUMAN_MB) * 1_000_000)
        sizes = [max(read_len + 200_001,
                     int(mb * 1_000_000 * scale)) for mb in _HUMAN_MB]
        chroms = ["chr%d" % (i + 1) for i in range(22)] + ["chrX", "chrY"]
    else:
        sizes = [int(genome_mb * 1_000_000) // n_chroms] * n_chroms
        chroms = ["chr%d" % (i + 1) for i in range(n_chroms)]
    bam = out_prefix + ".bam"
    fa = out_prefix + ".fa"
    bed = out_prefix + ".truth.bed"
    gt_bed = out_prefix + ".zygosity.bed"
    n_reads = 0
    step = max(1, read_len // coverage)
    with BamWriter(bam, list(zip(chroms, sizes))) as w, \
            open(fa, "w") as fa_out, open(bed, "w") as bed_out, \
            open(gt_bed, "w") as gt_out:
        for chrom_id, chrom in enumerate(chroms):
            n = sizes[chrom_id]
            ref = rng.integers(0, 4, size=n, dtype=np.uint8)
            sv_loci = []
            p = 100_000
            k = 0
            while p < n - 100_000:
                svlen = int(rng.integers(60, 400))
                svtype = "deletion" if k % 2 == 0 else "insertion"
                sv_loci.append((p, svtype, svlen,
                                rng.integers(0, 4, size=svlen,
                                             dtype=np.uint8)))
                if svtype == "deletion":
                    bed_out.write("%s\t%d\t%d\t%s\t%d\t0\n"
                                  % (chrom, p, p + svlen, svtype, svlen))
                else:
                    bed_out.write("%s\t%d\t%d\t%s\t%s\t0\n"
                                  % (chrom, p, p, svtype,
                                     _codes_to_str(sv_loci[-1][3])))
                k += 1
                p += sv_spacing
            frac = {"het": 50.0, "hom": 100.0}[zygosity]
            gt_out.write("%s\t0\t%d\th1\t%.1f\n" % (chrom, n, frac))

            for ridx, start in enumerate(range(0, n - read_len, step)):
                carrier = (zygosity == "hom") or (ridx % 2 == 0)
                qname = "%s_r%06d" % (chrom, ridx)
                events = ([(p, t, l, s) for p, t, l, s in sv_loci
                           if start + 500 < p < start + read_len - 500]
                          if carrier else [])
                cigar: List = []
                chunks = []
                cur = start
                for p, t, l, s in events:
                    m = p - cur
                    cigar.append((0, m))
                    chunks.append(ref[cur:p])
                    if t == "deletion":
                        cigar.append((2, l))
                        cur = p + l
                    else:
                        cigar.append((1, l))
                        chunks.append(s)
                        cur = p
                end = start + read_len
                cigar.append((0, end - cur))
                chunks.append(ref[cur:end])
                w.write(qname, 0, chrom_id, start, 60, cigar,
                        _codes_to_str(np.concatenate(chunks)))
                n_reads += 1

            fa_out.write(">%s\n" % chrom)
            s = _codes_to_str(ref)
            for i in range(0, n, 10_000):
                fa_out.write(s[i:i + 10_000] + "\n")
    return dict(bam=bam, fa=fa, bed=bed, gt=gt_bed, n_reads=n_reads)
