"""Synthetic long-read SV simulator (CLI).

The generators of ``cutesv_tpu/tools/simulate.py``, written with this
package's own BamWriter (with the same inputs and seed they write the
same bytes):

* :func:`simulate` invents a DEL/INS truth set on a grid over a random
  reference and writes a random reference FASTA, a truth bed in the
  VISOR HACk column layout, and a coordinate-sorted BAM of perfect long
  reads carrying the planted SVs at the requested zygosity;
* :func:`simulate_messy` (``--messy``) writes a heterogeneous stress
  corpus: ONT-like noise, coverage waves, chimeric reads, clip storms;
* :func:`replay` (``--from_bed``) consumes VISOR HACk truth beds
  restricted to a genome window and synthesizes a reference + reads that
  carry every replayable record (CIGAR indels for small DEL/INS, SA-tag
  split reads for large DEL, DUP, INV and reciprocal-translocation
  breakends), with translocation mates remapped into small synthetic
  mate chromosomes.

Run as ``python -m cutesv_tpu_torch.tools.simulate OUT_PREFIX [options]``.
"""
from __future__ import annotations

import argparse
import gzip
import logging
import sys
import time
from typing import Dict, List

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


def simulate_messy(out_prefix: str, genome_mb: float = 20.0,
                   n_chroms: int = 2, seed: int = 0):
    """HG002-shaped stress corpus (round-2 verdict item 7): ONT-like
    noise density, lognormal read lengths, coverage waves (~5-32x),
    chimeric reads with cross-chromosome SA junctions, soft-clip storms,
    mixed mapq and secondary records — plus a DEL/INS truth set (chr1
    het, chr2 hom) in the same truth/zygosity bed format as
    :func:`simulate`. Reference protocol being proxied:
    real-data heterogeneity per src/documentation/README.md:96-139."""
    from cutesv_tpu_torch.io.bam import BamWriter

    rng = np.random.default_rng(seed)
    n = int(genome_mb * 1_000_000) // n_chroms
    chroms = ["chr%d" % (i + 1) for i in range(n_chroms)]
    bam = out_prefix + ".bam"
    fa = out_prefix + ".fa"
    bed = out_prefix + ".truth.bed"
    gt_bed = out_prefix + ".zygosity.bed"
    n_reads = 0
    with BamWriter(bam, [(c, n) for c in chroms]) as w, \
            open(fa, "w") as fa_out, open(bed, "w") as bed_out, \
            open(gt_bed, "w") as gt_out:
        refs = [rng.integers(0, 4, size=n, dtype=np.uint8)
                for _ in range(n_chroms)]
        for chrom_id, chrom in enumerate(chroms):
            ref = refs[chrom_id]
            hom = chrom_id % 2 == 1
            sv_loci = []
            p = 100_000
            k = 0
            while p < n - 100_000:
                svlen = int(rng.integers(50, 1500))
                svtype = "deletion" if k % 2 == 0 else "insertion"
                seq = rng.integers(0, 4, size=svlen, dtype=np.uint8)
                sv_loci.append((p, svtype, svlen, seq))
                if svtype == "deletion":
                    bed_out.write("%s\t%d\t%d\t%s\t%d\t0\n"
                                  % (chrom, p, p + svlen, svtype, svlen))
                else:
                    bed_out.write("%s\t%d\t%d\t%s\t%s\t0\n"
                                  % (chrom, p, p, svtype,
                                     _codes_to_str(seq)))
                k += 1
                p += 40_000
            gt_out.write("%s\t0\t%d\th1\t%.1f\n"
                         % (chrom, n, 100.0 if hom else 50.0))

            # soft-clip storm loci (clips without SA produce no
            # signatures in the reference either; parser stress only)
            storms = [int(x) for x in rng.integers(50_000, n - 50_000, 10)]

            records = []  # (start, qname, flag, mapq, cigar, seq, tags)
            start = 0
            ridx = 0
            while start < n - 45_000:
                ridx += 1
                qname = "%s_m%06d" % (chrom, ridx)
                rlen = int(np.clip(np.exp(rng.normal(np.log(12_000),
                                                     0.6)), 3_000, 40_000))
                rlen = min(rlen, n - start - 1_000)
                cov = 5.0 + 27.0 * (1 + np.sin(2 * np.pi * start / 2e6)) / 2
                carrier = hom or rng.random() < 0.5
                mapq = 60
                r = rng.random()
                if r < 0.08:
                    mapq = 10     # below min_mapq: census-excluded
                elif r < 0.18:
                    mapq = 20     # exactly at the default gate
                flag = 256 if rng.random() < 0.02 else 0
                events = []
                if carrier:
                    for p0, t, ln, sq in sv_loci:
                        if start + 500 < p0 < start + rlen - 500:
                            events.append((p0, t, ln, sq))
                # ONT-like noise: dense sub-threshold + medium indels
                for _ in range(max(1, rlen // 300)):
                    off = int(rng.integers(600, max(700, rlen - 600)))
                    events.append((start + off,
                                   "deletion" if rng.random() < 0.5
                                   else "insertion",
                                   int(rng.integers(1, 9)), None))
                for _ in range(max(1, rlen // 5_000)):
                    off = int(rng.integers(600, max(700, rlen - 600)))
                    events.append((start + off,
                                   "deletion" if rng.random() < 0.5
                                   else "insertion",
                                   int(rng.integers(10, 40)), None))
                events.sort(key=lambda e: e[0])
                cigar: List = []
                chunks = []
                cur = start
                for p0, t, ln, sq in events:
                    if p0 <= cur or p0 >= start + rlen - 60 \
                            or (t == "deletion"
                                and p0 + ln >= start + rlen - 60):
                        continue
                    cigar.append((0, p0 - cur))
                    chunks.append(ref[cur:p0])
                    if t == "deletion":
                        cigar.append((2, ln))
                        cur = p0 + ln
                    else:
                        cigar.append((1, ln))
                        chunks.append(sq if sq is not None else
                                      rng.integers(0, 4, size=ln,
                                                   dtype=np.uint8))
                        cur = p0
                end = start + rlen
                cigar.append((0, end - cur))
                chunks.append(ref[cur:end])
                seq = _codes_to_str(np.concatenate(chunks))
                tags = None
                if rng.random() < 0.03 and flag == 0:
                    # chimeric read: SA junction to a random locus on the
                    # next chromosome (scattered; below min_support)
                    cid2 = (chrom_id + 1) % n_chroms
                    p2 = int(rng.integers(10_000, n - 10_000))
                    tags = {"SA": "%s,%d,+,%dS%dM,60,0;"
                            % (chroms[cid2], p2 + 1, len(seq) // 2,
                               len(seq) - len(seq) // 2)}
                records.append((start, qname, flag, mapq, cigar, seq,
                                tags))
                start += max(150, int(rlen / cov))
            for si, sp in enumerate(storms):
                for j in range(8):
                    pos = sp + j * 11
                    m = 2_000
                    clip = 1_400
                    seq = _codes_to_str(np.concatenate([
                        ref[pos:pos + m],
                        rng.integers(0, 4, size=clip, dtype=np.uint8)]))
                    records.append((pos, "%s_clip%02d_%02d"
                                    % (chrom, si, j), 0, 60,
                                    [(0, m), (4, clip)], seq, None))
            records.sort(key=lambda r: r[0])
            for start, qname, flag, mapq, cigar, seq, tags in records:
                w.write(qname, flag, chrom_id, start, mapq, cigar, seq,
                        tags)
                n_reads += 1
            fa_out.write(">%s\n" % chrom)
            s = _codes_to_str(ref)
            for i in range(0, n, 10_000):
                fa_out.write(s[i:i + 10_000] + "\n")
    return dict(bam=bam, fa=fa, bed=bed, gt=gt_bed, n_reads=n_reads)



def _load_visor_records(paths: List[str], chrom: str, wstart: int,
                        wend: int, margin: int):
    """Read VISOR HACk bed rows on ``chrom`` whose footprint (or, for
    translocations, whose breakend-1 anchor) fits the window with margin."""
    recs = []
    for path in paths:
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) < 5 or f[0] != chrom:
                    continue
                s, e = int(f[1]), int(f[2])
                if wstart + margin <= s and e <= wend - margin:
                    recs.append([f[0], s, e, f[3], f[4]])
    recs.sort(key=lambda r: r[1])
    return recs


def _bnd_breakends(start: int, end: int, start2: int, s1: str, s2: str):
    """The breakend (pos1, pos2) pairs eval_sim's truth expansion accepts
    for a reciprocal translocation (tools/eval_sim.py::load_ans;
    reference eval_sim.py:182-229). One read cluster is planted per pair."""
    d = end - start
    if s1[0] == "f":
        if s2[0] == "f":
            return [(start, start2), (end, start2 + d)]
        return [(start, start2), (start, start2 + d),
                (end, start2), (end, start2 + d)]
    if s2[0] == "f":
        return [(start, start2 + d), (start, start2),
                (end, start2), (end, start2 + d)]
    return [(start, start2 + d), (end, start2)]


def replay(out_prefix: str, beds: List[str], window: str,
           coverage: int = 20, seed: int = 0, mate_cap: int = 400_000,
           min_gap: int = 2500, margin: int = 6000):
    """Replay VISOR truth beds inside ``window`` (chrom:start-end).

    Builds a random reference for the window chromosome (plus small mate
    chromosomes for translocations), plants per-record carrier read
    clusters over background tiling, and writes bam/fa/truth/zygosity
    files. Returns counts. Carrier encodings:

    * DEL <= 5 kb / INS: CIGAR D / I events (reference parse_read path,
      cuteSV:606-681);
    * DEL > 5 kb: 2-segment same-strand split with a reference gap;
    * DUP: 2-segment split with a backward reference jump
      (cuteSV:225-257);
    * INV: 2-segment opposite-strand head-to-head split (cuteSV:50-94);
    * BND: one split cluster per truth breakend expansion row
      (cuteSV:97-188), mates remapped into synthetic mate chromosomes.
    """
    rng = np.random.default_rng(seed)
    chrom, span = window.split(":")
    wstart, wend = (int(x) for x in span.replace(",", "").split("-"))
    if wend - wstart > 64_000_000:
        # only the window span is allocated (bed coordinates stay valid
        # via offset indexing), so the cap bounds the actual allocation
        raise ValueError("window too wide (>64Mb): %s" % window)
    recs = _load_visor_records(beds, chrom, wstart, wend, margin)

    # conflict pruning: breakpoints of accepted records keep >= min_gap
    # distance so carrier flanks never interleave between records
    reserved: List[int] = []

    def free(points):
        return all(abs(p - q) >= min_gap for p in points for q in reserved)

    FLANK = 1000
    n_carriers = max(4, coverage // 2)
    accepted, dropped = [], 0
    mate_len: Dict[str, int] = {}
    for rec in recs:
        _, s, e, svtype, info = rec
        if svtype == "reciprocal translocation":
            f = info.split(":")
            chr2, start2, s1, s2 = f[1], int(f[2]), f[3], f[4]
            if chr2 == chrom:
                dropped += 1  # same-chrom "translocation": not replayable
                continue
            d = e - s
            # remap the mate anchor into a small synthetic chromosome
            r2 = margin + (start2 * 9973) % max(mate_cap - 2 * margin - d, 1)
            pairs = _bnd_breakends(s, e, r2, s1, s2)
            pts = [p for p, _ in pairs]
            if not free(pts):
                dropped += 1
                continue
            reserved.extend(pts)
            mate_len[chr2] = max(mate_len.get(chr2, 0),
                                 r2 + d + margin + FLANK)
            rec = rec + [("bnd", pairs, chr2, r2, s1, s2)]
        elif svtype in ("deletion", "insertion", "tandem duplication",
                        "inversion"):
            pts = [s] if svtype == "insertion" else [s, e]
            if not free(pts):
                dropped += 1
                continue
            reserved.extend(pts)
            rec = rec + [(svtype,)]
        else:
            # VISOR types without a carrier encoding here (e.g. inverted
            # tandem duplication, SNP) are dropped, not crashed on
            dropped += 1
            continue
        accepted.append(rec)

    class OffsetRef:
        """Random sequence for [base, length) of a declared-length contig;
        slicing uses absolute coordinates. Bases below `base` are filler
        'A' (never touched by reads: all reads live in the window)."""

        def __init__(self, length, base=0):
            self.length = length
            self.base = base
            self.arr = rng.integers(0, 4, size=length - base,
                                    dtype=np.uint8)

        def __getitem__(self, sl):
            return self.arr[sl.start - self.base:sl.stop - self.base]

    win_base = max(0, wstart - margin)
    chroms = [(chrom, wend)] + [(c, mate_len[c]) for c in sorted(mate_len)]
    seqs = {c: OffsetRef(n, win_base if c == chrom else 0)
            for c, n in chroms}
    chrom_id = {c: k for k, (c, _) in enumerate(chroms)}

    reads: Dict[str, list] = {c: [] for c, _ in chroms}
    # background tiling on every chromosome: the reference haplotype.
    # Long enough that reads overlapping a breakpoint usually also cover
    # the +-1000 genotype window (cuteSV_resolveINDEL.py:312), so het
    # sites genotype as het like they would with real 10-20 kb reads.
    BG_LEN = 8000
    bg_step = max(1, int(BG_LEN / max(1, coverage // 2)))
    for c, n in chroms:
        lo = wstart if c == chrom else 0
        for k, start in enumerate(range(lo, n - BG_LEN, bg_step)):
            reads[c].append((start, "%s_bg%06d" % (c, k), 0,
                             [(0, BG_LEN)], None, None))

    def sa(c, pos0, strand, cig):
        return "%s,%d,%s,%s,60,0;" % (c, pos0 + 1, strand, cig)

    ref = seqs[chrom]
    rid = 0
    for rec in accepted:
        _, s, e, svtype, info, plan = rec
        for k in range(n_carriers):
            j = k * 5
            rid += 1
            q = "sv_r%06d" % rid
            kind = plan[0]
            if kind == "deletion" and e - s <= 5000:
                a = FLANK + (k * 37) % 200
                seq = np.concatenate([ref[s - a:s], ref[e:e + FLANK]])
                reads[chrom].append((s - a, q, 0,
                                     [(0, a), (2, e - s), (0, FLANK)],
                                     seq, None))
            elif kind == "deletion":
                p = s - FLANK - j
                seq = np.concatenate([ref[p:s], ref[e:e + FLANK]])
                reads[chrom].append(
                    (p, q, 0, [(0, s - p), (4, FLANK)], seq,
                     {"SA": sa(chrom, e, "+",
                               "%dS%dM" % (s - p, FLANK))}))
            elif kind == "insertion":
                lut = np.zeros(256, np.uint8)
                lut[ord("C")] = 1
                lut[ord("G")] = 2
                lut[ord("T")] = 3
                ins = lut[np.frombuffer(info.upper().encode("ascii"),
                                        np.uint8)]
                a = FLANK + (k * 37) % 200
                seq = np.concatenate([ref[s - a:s], ins,
                                      ref[s:s + FLANK]])
                reads[chrom].append((s - a, q, 0,
                                     [(0, a), (1, len(ins)), (0, FLANK)],
                                     seq, None))
            elif kind == "tandem duplication":
                # primary covers [e-FLANK, e); supplementary re-aligns the
                # clipped tail back at s -> DUP(s, e)
                p = e - FLANK - j
                seq = np.concatenate([ref[p:p + FLANK], ref[s:s + FLANK]])
                reads[chrom].append(
                    (p, q, 0, [(0, FLANK), (4, FLANK)], seq,
                     {"SA": sa(chrom, s - j, "+",
                               "%dS%dM" % (FLANK, FLANK))}))
            elif kind == "inversion":
                # '+' primary ending at s, '-' supplementary ending at e
                # -> ("++", s, e) head-to-head signature
                p = s - FLANK - j
                seq = np.concatenate(
                    [ref[p:p + FLANK], 3 - ref[e - FLANK:e][::-1]])
                reads[chrom].append(
                    (p, q, 0, [(0, FLANK), (4, FLANK)], seq,
                     {"SA": sa(chrom, e - FLANK - j, "-",
                               "%dM%dS" % (FLANK, FLANK))}))
            else:  # bnd: one cluster per truth expansion pair
                _, pairs, chr2, _, _, _ = plan
                for ci, (p1, p2) in enumerate(pairs):
                    rid += 1
                    qb = "sv_r%06d_%d" % (rid, ci)
                    base = p1 + ci * 150  # separate same-pos1 clusters
                    p = base - FLANK - j
                    seq = np.concatenate([ref[p:p + FLANK],
                                          seqs[chr2][p2:p2 + FLANK]])
                    reads[chrom].append(
                        (p, qb, 0, [(0, FLANK), (4, FLANK)], seq,
                         {"SA": sa(chr2, p2, "+",
                                   "%dS%dM" % (FLANK, FLANK))}))

    bam = out_prefix + ".bam"
    fa = out_prefix + ".fa"
    bed = out_prefix + ".truth.bed"
    gt_bed = out_prefix + ".zygosity.bed"
    n_reads = 0
    from cutesv_tpu_torch.io.bam import BamWriter

    with BamWriter(bam, chroms) as w:
        for c, _ in chroms:
            reads[c].sort(key=lambda r: r[0])
            for pos, q, flag, cigar, seq, tags in reads[c]:
                if seq is None:
                    seq = seqs[c][pos:pos + BG_LEN]
                w.write(q, flag, chrom_id[c], pos, 60, cigar,
                        _codes_to_str(seq), tags)
                n_reads += 1
    with open(fa, "w") as fh:
        for c, n in chroms:
            fh.write(">%s\n" % c)
            base = seqs[c].base
            filler = "A" * 10_000
            for i in range(0, base - base % 10_000, 10_000):
                fh.write(filler + "\n")
            if base % 10_000:
                fh.write("A" * (base % 10_000) + "\n")
            sstr = _codes_to_str(seqs[c].arr)
            for i in range(0, n - base, 10_000):
                fh.write(sstr[i:i + 10_000] + "\n")
    with open(bed, "w") as fh:
        for rec in accepted:
            _, s, e, svtype, info, plan = rec
            if plan[0] == "bnd":
                _, _, chr2, r2, s1, s2 = plan
                info = "h1:%s:%d:%s:%s" % (chr2, r2, s1, s2)
            fh.write("%s\t%d\t%d\t%s\t%s\t0\n" % (chrom, s, e, svtype,
                                                  info))
    with open(gt_bed, "w") as fh:
        for c, n in chroms:
            fh.write("%s\t0\t%d\th1\t50.0\n" % (c, n))
    return dict(bam=bam, fa=fa, bed=bed, gt=gt_bed, n_reads=n_reads,
                n_sv=len(accepted), n_dropped=dropped)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="simulate",
        description="Generate a synthetic SV truth set + reads "
                    "(BAM/FASTA/truth bed) for evaluation, or replay "
                    "existing VISOR truth beds with --from_bed.")
    p.add_argument("out_prefix", type=str)
    p.add_argument("--genome_mb", type=float, default=10.0)
    p.add_argument("--chroms", type=int, default=2)
    p.add_argument("--coverage", type=int, default=20)
    p.add_argument("--read_len", type=int, default=20_000)
    p.add_argument("--sv_spacing", type=int, default=50_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zygosity", choices=["het", "hom"], default="het")
    p.add_argument("--from_bed", type=str, default=None,
                   help="Comma-separated VISOR HACk beds to replay "
                        "(e.g. the reference's sim_*.bed.gz).")
    p.add_argument("--window", type=str, default=None,
                   help="chrom:start-end window to replay (required "
                        "with --from_bed).")
    p.add_argument("--mate_cap", type=int, default=400_000,
                   help="Synthetic mate-chromosome size for replayed "
                        "translocations.")
    p.add_argument("--messy", action="store_true",
                   help="Generate the heterogeneous stress corpus "
                        "(ONT-like noise, coverage waves, chimeras, "
                        "clip storms) instead of the clean simulator.")
    p.add_argument("--human_layout", action="store_true",
                   help="24 contigs (chr1-22, X, Y) with hg38-"
                        "proportional sizes scaled to --genome_mb "
                        "(overrides --chroms).")
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    t0 = time.time()
    if args.messy:
        info = simulate_messy(args.out_prefix, args.genome_mb,
                              args.chroms, args.seed)
        logging.info("Simulated %d messy reads -> %s (%0.2fs)"
                     % (info["n_reads"], info["bam"], time.time() - t0))
        return 0
    if args.from_bed:
        if not args.window:
            p.error("--from_bed requires --window chrom:start-end")
        info = replay(args.out_prefix, args.from_bed.split(","),
                      args.window, args.coverage, args.seed,
                      args.mate_cap)
        logging.info("Replayed %d SVs (%d dropped) into %d reads -> %s "
                     "(%0.2fs)" % (info["n_sv"], info["n_dropped"],
                                   info["n_reads"], info["bam"],
                                   time.time() - t0))
        return 0
    info = simulate(args.out_prefix, args.genome_mb, args.chroms,
                    args.coverage, args.read_len, args.sv_spacing,
                    args.seed, args.zygosity,
                    human_layout=args.human_layout)
    logging.info("Simulated %d reads -> %s (%0.2fs)"
                 % (info["n_reads"], info["bam"], time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
