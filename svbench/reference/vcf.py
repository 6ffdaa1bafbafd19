"""VCF body of the plain reference: the record lines of cuteSV's
generate_output, field for field, and the per-type <SVID> numbering of
its serial merge. A copy of ``cutesv_tpu_torch/vcf.py`` without the
header (the comparison reads bodies only), kept here so that the
reference shares no code with the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

_TRANS = str.maketrans("RYSWKMBDHV", "ACCAGACAAA")


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


def vcf_body(per_chrom: Dict[str, List[Tuple[str, str]]]) -> List[str]:
    """Record lines, chromosomes in lexicographic order, with per-type
    <SVID> counters (cuteSV:1225-1236)."""
    svid = {"INS": 0, "DEL": 0, "BND": 0, "DUP": 0, "INV": 0}
    out = []
    for chrom in sorted(per_chrom):
        for svtype, line in per_chrom[chrom]:
            out.append(line.replace("<SVID>", str(svid[svtype])))
            svid[svtype] += 1
    return out
