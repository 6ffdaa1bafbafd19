"""The output check's second witness: every call's DEL and INS records
held to the sites that the corpus planted, by cuteSV 2.1.4's documented
rules, computed here from the read plans alone.

It shares no code with the program and none with the frozen copy in
``reference/``. What it knows of cuteSV is its rules:

* a planted DEL or INS is called when at least ``-s`` reads support it:
  its carriers that are not secondary and pass ``--min_mapq``;
* the call's POS is the planted breakpoint, SVLEN and END its length, REF
  and ALT the deleted or inserted bases after the base before it;
* RE and DV count those carriers; DR counts the primary reads that pass
  ``--min_mapq`` and span the genotype window (the breakpoint less and plus
  ``max_cluster_bias_DEL`` for a DEL, 1,000 bp for an INS), less the
  carriers among them;
* GT, PL, GQ and QUAL are cuteSV's genotype likelihood of (DR, DV), AF is
  DV / (DR + DV), FILTER is PASS from QUAL 5 up and q5 below.

Records of other types (DUP, INV, BND) have no planted truth here and are
left to the comparison with the frozen copy.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from svbench import corpus

MODELLED = ("DEL", "INS")
INS_WINDOW = 1000          # cuteSV's fixed genotype window of an INS
ERR, PRIOR = 0.1, 1.0 / 3.0
NUMBERS = ("truth_sites_missed", "truth_sites_split", "truth_records_extra",
           "truth_alleles_off", "truth_counts_off", "truth_genotypes_off")


def likelihood(dr: int, dv: int):
    """(GT, PL, GQ, QUAL) of cuteSV's genotype likelihood of ``dr``
    reference and ``dv`` variant reads, the counts first scaled to at
    most 100 reads."""
    if dr + dv > 100:
        dr = int(100 * (dr / (dr + dv)))
        dv = 100 - dr
    logs = [math.log10((1 - ERR) ** dr * ERR ** dv * (1 - PRIOR) / 2),
            math.log10(0.5 ** (dr + dv) * PRIOR),
            math.log10(ERR ** dr * (1 - ERR) ** dv * (1 - PRIOR) / 2)]
    top = max(logs)
    total = top + math.log10(sum(10.0 ** (x - top) for x in logs))
    norm = [min(x - total, 0.0) for x in logs]
    p = [10.0 ** x for x in norm]
    pl = [int(np.around(-10 * math.log10(x))) for x in p]
    gq = max(int(-10 * math.log10(p[1] + p[2])),
             int(-10 * math.log10(p[0] + p[2])),
             int(-10 * math.log10(p[0] + p[1])))
    qual = abs(np.around(-10 * math.log10(p[0]), 1))
    gt = ("0/0", "0/1", "1/1")[norm.index(max(norm))]
    return gt, "%d,%d,%d" % tuple(pl), gq, float(qual)


def _text(codes) -> str:
    return corpus.codes_to_bytes(codes).decode()


def contig_sites(plan, ref: np.ndarray, svs: List[dict],
                 values: dict) -> List[dict]:
    """The DEL and INS records cuteSV makes of one contig's planted
    sites, as dicts of the VCF fields the check compares."""
    ops, lens = plan.ops, plan.lens
    n = len(plan)
    if n == 0:
        return []
    rec = np.repeat(np.arange(n), np.diff(plan.op_off))
    adv = np.where((ops == corpus.OP_M) | (ops == corpus.OP_D), lens, 0)
    before = np.cumsum(adv) - adv
    first = before[plan.op_off[:-1]]
    at = plan.pos[rec] + before - first[rec]     # reference position of op
    end = plan.pos + np.add.reduceat(adv, plan.op_off[:-1])
    flag, mapq = plan.flag, plan.mapq
    passing = mapq >= values["min_mapq"]
    supports = passing & ((flag & 0x100) == 0)
    primary = passing & ((flag & 0x900) == 0)
    p_start, p_end = plan.pos[primary], end[primary]
    sized = np.nonzero(((ops == corpus.OP_D) | (ops == corpus.OP_I))
                       & (lens >= values["min_size"]))[0]
    out = []
    for sv in svs:
        kind = sv["kind"]
        if kind not in MODELLED:
            continue
        ln, s = sv["len"], sv["s"]
        if not values["min_size"] <= ln <= values["max_size"]:
            continue
        op = corpus.OP_D if kind == "DEL" else corpus.OP_I
        hit = sized[(ops[sized] == op) & (at[sized] == s)
                    & (lens[sized] == ln)]
        carriers = np.unique(rec[hit])
        carriers = carriers[supports[carriers]]
        dv = len(carriers)
        if dv < values["min_support"]:
            continue
        half = (values["max_cluster_bias_DEL"] if kind == "DEL"
                else INS_WINDOW)
        w0, w1 = max(s - half, 0), s + half
        spans = int(np.count_nonzero((p_start <= w0) & (p_end >= w1)))
        c = carriers[primary[carriers]]
        dr = spans - int(np.count_nonzero((plan.pos[c] <= w0)
                                          & (end[c] >= w1)))
        gt, pl, gq, qual = likelihood(dr, dv)
        base = _text(ref[s - 1:s])
        if kind == "DEL":
            alleles = (_text(ref[s - 1:s + ln]), base)
        else:
            alleles = (base, base + _text(sv["seq"]))
        out.append(dict(chrom=plan.chrom, svtype=kind, pos=s,
                        svlen=-ln if kind == "DEL" else ln,
                        end=s + ln if kind == "DEL" else s,
                        alleles=alleles, re=dv, dr=dr, dv=dv,
                        af=round(dv / (dv + dr), 4), gt=gt, pl=pl, gq=gq,
                        qual=qual, filter="PASS" if qual >= 5.0 else "q5"))
    return out


def _parse(line: str) -> dict:
    f = line.rstrip("\n").split("\t")
    info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
    fmt = dict(zip(f[8].split(":"), f[9].split(":"))) if len(f) > 9 else {}
    return dict(chrom=f[0], pos=int(f[1]), alleles=(f[3], f[4]), qual=f[5],
                filter=f[6], info=info, fmt=fmt)


def _counts_match(r: dict, site: dict) -> bool:
    return (r["info"].get("RE") == str(site["re"])
            and r["fmt"].get("DR") == str(site["dr"])
            and r["fmt"].get("DV") == str(site["dv"]))


def _genotype_matches(r: dict, site: dict) -> bool:
    try:
        qual = float(r["qual"])
    except ValueError:
        return False
    return (r["fmt"].get("GT") == site["gt"]
            and r["fmt"].get("PL") == site["pl"]
            and r["fmt"].get("GQ") == str(site["gq"])
            and qual == site["qual"] and r["filter"] == site["filter"]
            and r["info"].get("AF") == str(site["af"]))


def check(body: List[str], sites: List[dict],
          bias: Dict[str, int]) -> Dict[str, int]:
    """How one call's VCF body departs from the planted sites:
    ``truth_sites_missed``, sites with no record of their type within the
    preset's cluster bias of their breakpoint; ``truth_sites_split``, sites
    with more than one; ``truth_records_extra``, DEL and INS records near
    no site; and of the sites with one record, ``truth_alleles_off``
    (POS, SVLEN, END, REF or ALT), ``truth_counts_off`` (RE, DR or DV) and
    ``truth_genotypes_off`` (GT, PL, GQ, QUAL, FILTER or AF) differing."""
    by_key: Dict[tuple, List[dict]] = {}
    for line in body:
        r = _parse(line)
        kind = r["info"].get("SVTYPE")
        if kind in MODELLED:
            by_key.setdefault((r["chrom"], kind), []).append(r)
    for rows in by_key.values():
        rows.sort(key=lambda r: r["pos"])
    n = dict.fromkeys(NUMBERS, 0)
    used = set()
    for site in sites:
        rows = by_key.get((site["chrom"], site["svtype"]), [])
        b = bias[site["svtype"]]
        near = [r for r in rows if abs(r["pos"] - site["pos"]) <= b]
        used.update(id(r) for r in near)
        if not near:
            n["truth_sites_missed"] += 1
            continue
        if len(near) > 1:
            n["truth_sites_split"] += 1
            continue
        r = near[0]
        info = r["info"]
        if (r["pos"] != site["pos"] or r["alleles"] != site["alleles"]
                or info.get("SVLEN") != str(site["svlen"])
                or info.get("END") != str(site["end"])):
            n["truth_alleles_off"] += 1
        if not _counts_match(r, site):
            n["truth_counts_off"] += 1
        if not _genotype_matches(r, site):
            n["truth_genotypes_off"] += 1
    n["truth_records_extra"] = sum(1 for rows in by_key.values()
                                   for r in rows if id(r) not in used)
    return n


def cluster_bias(values: dict) -> Dict[str, int]:
    """The preset's cluster bias of each modelled type, within which a
    record is taken to be a site's call."""
    return dict(DEL=values["max_cluster_bias_DEL"],
                INS=values["max_cluster_bias_INS"])
