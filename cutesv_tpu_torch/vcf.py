"""VCF 4.2 emission, byte-compatible with the reference's generate_output
(cuteSV_genotype.py:242-468) and Generation_VCF_header
(cuteSV_Description.py:265-305).

Candidate rows arrive in per-chromosome lists ordered
[DEL..., INS..., INV..., DUP..., TRA...] (the reference's task submission
order, cuteSV:1116-1189); a stable sort by POS then fixes the final record
order, and <SVID> counters are assigned while concatenating chromosomes in
lexicographic order (cuteSV:1214,1225-1236).
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

from cutesv_tpu_torch import __version__

_TRANS = str.maketrans("RYSWKMBDHV", "ACCAGACAAA")


def vcf_header(contig_info: Sequence[Tuple[str, int]], sample: str,
               argv: Sequence[str]) -> str:
    lines = []
    a = lines.append
    a("##fileformat=VCFv4.2")
    a("##source=cuteSV-TPU-%s" % __version__)
    a("##fileDate=%s" % time.strftime("%Y-%m-%d %H:%M:%S %w-%Z",
                                      time.localtime()))
    for name, length in contig_info:
        a("##contig=<ID=%s,length=%d>" % (name, length))
    a('##ALT=<ID=INS,Description="Insertion of novel sequence relative to the reference">')
    a('##ALT=<ID=DEL,Description="Deletion relative to the reference">')
    a('##ALT=<ID=DUP,Description="Region of elevated copy number relative to the reference">')
    a('##ALT=<ID=INV,Description="Inversion of reference sequence">')
    a('##ALT=<ID=BND,Description="Breakend of translocation">')
    a('##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="Precise structural variant">')
    a('##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variant">')
    a('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">')
    a('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Difference in length between REF and ALT alleles">')
    a('##INFO=<ID=CHR2,Number=1,Type=String,Description="Chromosome for END coordinate in case of a translocation">')
    a('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant described in this record">')
    a('##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS for imprecise variants">')
    a('##INFO=<ID=CILEN,Number=2,Type=Integer,Description="Confidence interval around inserted/deleted material between breakends">')
    a('##INFO=<ID=RE,Number=1,Type=Integer,Description="Number of read support this record">')
    a('##INFO=<ID=STRAND,Number=A,Type=String,Description="Strand orientation of the adjacency in BEDPE format (DEL:+-, DUP:-+, INV:++/--)">')
    a('##INFO=<ID=RNAMES,Number=.,Type=String,Description="Supporting read names of SVs (comma separated)">')
    a('##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency.">')
    a('##FILTER=<ID=q5,Description="Quality below 5">')
    a('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    a('##FORMAT=<ID=DR,Number=1,Type=Integer,Description="# High-quality reference reads">')
    a('##FORMAT=<ID=DV,Number=1,Type=Integer,Description="# High-quality variant reads">')
    a('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="# Phred-scaled genotype likelihoods rounded to the closest integer">')
    a('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="# Genotype quality">')
    a('##CommandLine="cuteSV %s"' % " ".join(argv))
    a("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s" % sample)
    return "\n".join(lines) + "\n"


def _af_suffix(re_s: str, dr_s: str) -> str:
    try:
        return ";AF=" + str(round(int(re_s) / (int(re_s) + int(dr_s)), 4))
    except Exception:
        return ";AF=."


def _filter_label(qual_s) -> str:
    if qual_s == "." or qual_s is None:
        return "PASS"
    return "PASS" if float(qual_s) >= 5.0 else "q5"


def format_chrom_records(cfg, rows: List[list], ref_chrom: str,
                         chrom: str) -> List[Tuple[str, str]]:
    """Render one chromosome's candidate rows to (svtype, line) pairs with
    a <SVID> placeholder; mirrors generate_output field-for-field."""
    rows = sorted(rows, key=lambda x: int(x[2]))  # stable
    action = cfg.genotype
    out = []
    for i in rows:
        svtype = i[1]
        if svtype in ("DEL", "INS"):
            svlen = abs(int(float(i[3])))
            if svlen > cfg.max_size and cfg.max_size != -1:
                continue
            if svlen < cfg.min_size:
                continue
            pos = int(i[2])
            cal_end = pos if svtype == "INS" else pos + svlen
            info = "%s;SVTYPE=%s;SVLEN=%s;END=%s;CIPOS=%s;CILEN=%s;RE=%s%s" % (
                "IMPRECISE" if i[8] == "0/0" else "PRECISE", svtype, i[3],
                cal_end, i[5], i[6], i[4],
                ";RNAMES=" + i[12] if cfg.report_readid else "")
            if action:
                info += _af_suffix(i[4], i[7])
            if svtype == "DEL":
                info += ";STRAND=+-"
            if cfg.ignore_sequence:
                ref_seq, alt_seq = "N", "<%s>" % svtype
            elif svtype == "INS":
                ref_seq = ref_chrom[max(pos - 1, 0)]
                alt_seq = ref_chrom[max(pos - 1, 0)] + i[13]
            else:
                ref_seq = ref_chrom[max(pos - 1, 0):pos - int(i[3])]
                alt_seq = ref_chrom[max(pos - 1, 0)]
            out.append((svtype,
                        "%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s:%s:%s:%s:%s\n"
                        % (i[0], pos, "cuteSV.%s.<SVID>" % svtype,
                           ref_seq.translate(_TRANS), alt_seq, i[11],
                           _filter_label(i[11]), info, "GT:DR:DV:PL:GQ",
                           i[8], i[7], i[4], i[9], i[10])))
        elif svtype == "DUP":
            svlen = abs(int(float(i[3])))
            if svlen > cfg.max_size and cfg.max_size != -1:
                continue
            pos = int(i[2])
            cal_end = pos + 1 + svlen
            info = "%s;SVTYPE=DUP;SVLEN=%s;END=%s;RE=%s;STRAND=-+%s" % (
                "IMPRECISE" if i[6] == "0/0" else "PRECISE", i[3], cal_end,
                i[4], ";RNAMES=" + i[10] if cfg.report_readid else "")
            if action:
                info += _af_suffix(i[4], i[5])
            ref_seq = ref_chrom[pos]
            out.append(("DUP",
                        "%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s:%s:%s:%s:%s\n"
                        % (i[0], pos + 1, "cuteSV.DUP.<SVID>",
                           ref_seq.translate(_TRANS), "<DUP>", i[9],
                           _filter_label(i[9]),
                           info, "GT:DR:DV:PL:GQ",
                           i[6], i[5], i[4], i[7], i[8])))
        elif svtype == "INV":
            svlen = abs(int(float(i[3])))
            if svlen > cfg.max_size and cfg.max_size != -1:
                continue
            # "++" breakpoints are end-type (already 1-based-valid), "--"
            # are start-type and need +1 (cuteSV_genotype.py:353-365)
            if i[7] == "++":
                pos_inv = int(i[2])
                ref_idx = max(pos_inv - 1, 0)
            else:
                pos_inv = int(i[2]) + 1
                ref_idx = int(i[2])
            cal_end = pos_inv + svlen
            info = "%s;SVTYPE=INV;SVLEN=%s;END=%s;RE=%s;STRAND=%s%s" % (
                "IMPRECISE" if i[6] == "0/0" else "PRECISE", i[3], cal_end,
                i[4], i[7], ";RNAMES=" + i[11] if cfg.report_readid else "")
            if action:
                info += _af_suffix(i[4], i[5])
            ref_seq = ref_chrom[ref_idx]
            out.append(("INV",
                        "%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s:%s:%s:%s:%s\n"
                        % (i[0], pos_inv, "cuteSV.INV.<SVID>",
                           ref_seq.translate(_TRANS), "<INV>", i[10],
                           _filter_label(i[10]),
                           info, "GT:DR:DV:PL:GQ",
                           i[6], i[5], i[4], i[8], i[9])))
        else:
            # BND; i[1] is the ALT skeleton with the N placeholder at one end
            info = "%s;SVTYPE=BND;RE=%s%s" % (
                "IMPRECISE" if i[7] == "0/0" else "PRECISE", i[5],
                ";RNAMES=" + i[11] if cfg.report_readid else "")
            if action:
                info += _af_suffix(i[5], i[6])
            # A/B ALTs lead with N (end-type coord, 1-based-valid); C/D
            # trail with N (start-type, +1) (cuteSV_genotype.py:419-443)
            if i[1][0] == "N":
                pos_bnd = int(i[2])
                try:
                    ref_bnd = ref_chrom[max(pos_bnd - 1, 0)]
                except IndexError:
                    ref_bnd = "N"
                alt_bnd = ref_bnd + i[1][1:]
            else:
                pos_bnd = int(i[2]) + 1
                try:
                    ref_bnd = ref_chrom[int(i[2])]
                except IndexError:
                    ref_bnd = "N"
                alt_bnd = i[1][:-1] + ref_bnd
            out.append(("BND",
                        "%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s:%s:%s:%s:%s\n"
                        % (i[0], pos_bnd, "cuteSV.BND.<SVID>",
                           ref_bnd.translate(_TRANS), alt_bnd, i[10],
                           _filter_label(i[10]),
                           info, "GT:DR:DV:PL:GQ",
                           i[7], i[6], i[5], i[8], i[9])))
    return out


def write_vcf(path: str, cfg, per_chrom: Dict[str, List[Tuple[str, str]]],
              contig_info, argv):
    """Serial merge with per-type SVID renumbering (cuteSV:1225-1236)."""
    svid = {"INS": 0, "DEL": 0, "BND": 0, "DUP": 0, "INV": 0}
    with open(path, "w") as fh:
        fh.write(vcf_header(contig_info, cfg.sample, argv))
        for chrom in sorted(per_chrom):
            for svtype, line in per_chrom[chrom]:
                fh.write(line.replace("<SVID>", str(svid[svtype])))
                svid[svtype] += 1
