"""Simulation truth-set evaluation (src/benchmarks/eval_sim.py equivalent,
generalized to any number of callsets).

Matching rules preserved from the reference: 0.7 size ratio + offset bp for
INS; interval-overlap + size ratio for DEL/INV/DUP; both-breakend offset
for BND; genotype-aware TP levels (1 = present, 2 = genotype match) using
per-chromosome coverage-derived zygosity (load_gt:231-245).
Truth beds use the VISOR HACk column layout (simulation/sim_*.bed).
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List

TYPETRANS = {"insertion": "INS", "deletion": "DEL", "inversion": "INV",
             "tandem duplication": "DUP", "reciprocal translocation": "BND"}


def parse_info(seq: str) -> dict:
    info = {"SVLEN": 0, "END": 0, "SVTYPE": "", "RE": 0, "CHR2": ""}
    for kv in seq.split(";"):
        parts = kv.split("=")
        if parts[0] in ("SVLEN", "END", "RE"):
            try:
                info[parts[0]] = abs(int(float(parts[1])))
            except (ValueError, IndexError):
                pass
        elif parts[0] == "CHR2" and len(parts) > 1:
            info["CHR2"] = parts[1]
        elif parts[0] == "SVTYPE" and len(parts) > 1:
            info["SVTYPE"] = parts[1][:3]
    return info


def phase_gt(sample: str) -> str:
    gt = sample.split(":")[0]
    if gt in ("0/1", "1/0"):
        return "het"
    if gt == "1/1":
        return "hom"
    return "unknown"


def _parse_bnd_alt(alt: str):
    if alt[0] == "]":
        return "]]N", alt.split(":")[0][1:], int(alt.split(":")[1][:-2])
    if alt[0] == "[":
        return "[[N", alt.split(":")[0][1:], int(alt.split(":")[1][:-2])
    if alt[1] == "]":
        return "N]]", alt.split(":")[0][2:], int(alt.split(":")[1][:-1])
    return "N[[", alt.split(":")[0][2:], int(alt.split(":")[1][:-1])


def load_callset(path: str, svtype_list: List[str]):
    """Calls as match rows; DUP counted as INS in the 3-type IID mode
    (eval_sim.py:44-45)."""
    callset: Dict[str, list] = {}
    abtype: Dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            seq = line.strip("\n").split("\t")
            if not seq[0] or seq[0][0] == "#":
                continue
            chrom = seq[0]
            pos = int(seq[1])
            info = parse_info(seq[7])
            if len(svtype_list) == 3 and info["SVTYPE"] == "DUP":
                info["SVTYPE"] = "INS"
            if info["SVTYPE"] not in svtype_list:
                abtype[info["SVTYPE"]] = abtype.get(info["SVTYPE"], 0) + 1
                continue
            gt = phase_gt(seq[9]) if len(seq) > 9 else "unknown"
            if info["SVTYPE"] == "BND":
                form, chr2, pos2 = _parse_bnd_alt(seq[4])
                callset.setdefault("BND", [])
                if info["END"] == 0:
                    info["CHR2"] = chr2
                    info["END"] = pos2
                try:
                    if int(chrom) <= int(info["CHR2"]):
                        if form == "N[[":
                            form = "]]N"
                        if form == "]]N":
                            form = "N[["
                        callset["BND"].append([chrom, pos, info["CHR2"],
                                               info["END"], form, gt, 0])
                    else:
                        callset["BND"].append([info["CHR2"], info["END"],
                                               chrom, pos, form, gt, 0])
                except ValueError:
                    callset["BND"].append([chrom, pos, info["CHR2"],
                                           info["END"], form, gt, 0])
            else:
                callset.setdefault(info["SVTYPE"], [])
                if info["SVLEN"] == 0:
                    info["SVLEN"] = info["END"] - pos + 1
                callset[info["SVTYPE"]].append([chrom, pos, info["END"],
                                                info["SVLEN"], gt, 0])
    return callset, abtype


def load_ans(path: str, n_slots: int = 4):
    """VISOR HACk truth bed -> per-type answer rows with per-callset match
    slots (eval_sim.py:182-229, incl. reciprocal-translocation breakend
    expansion by strand). ``n_slots`` defaults to the reference's fixed 4
    and grows when more than 4 callsets are evaluated."""
    slots = [0] * n_slots
    ansbed: Dict[str, list] = {}
    with open(path) as fh:
        for line in fh:
            seq = line.strip("\n").split("\t")
            chrom = seq[0]
            svtype = TYPETRANS[seq[3]]
            start, end = int(seq[1]), int(seq[2])
            ansbed.setdefault(svtype, [])
            if svtype == "INS":
                ansbed[svtype].append([chrom, start, len(seq[4])] + slots)
            elif svtype == "BND":
                f = seq[4].split(":")
                chr2, start2 = f[1], int(f[2])
                s1, s2 = f[3], f[4]
                rows = []
                if s1[0] == "f":
                    if s2[0] == "f":
                        rows = [[chrom, start, chr2, start2, "N[["],
                                [chrom, end, chr2, start2 + end - start,
                                 "N[["]]
                    else:
                        rows = [[chrom, start, chr2, start2, "N[["],
                                [chrom, start, chr2, start2 + end - start,
                                 "[[N"],
                                [chrom, end, chr2, start2, "N]]"],
                                [chrom, end, chr2, start2 + end - start,
                                 "]]N"]]
                else:
                    if s2[0] == "f":
                        rows = [[chrom, start, chr2, start2 + end - start,
                                 "N]]"],
                                [chrom, start, chr2, start2, "]]N"],
                                [chrom, end, chr2, start2, "[[N"],
                                [chrom, end, chr2, start2 + end - start,
                                 "N[["]]
                    else:
                        rows = [[chrom, start, chr2, start2 + end - start,
                                 "N]]"],
                                [chrom, end, chr2, start2, "N]]"]]
                for r in rows:
                    ansbed[svtype].append(r + slots)
            else:
                ansbed[svtype].append(
                    [chrom, start, end, end - start + 1] + slots)
    return ansbed


def load_gt(path: str):
    """Per-chromosome zygosity from coverage fractions: >80 hom,
    (20, 80] het (eval_sim.py:231-245)."""
    gt: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            seq = line.strip("\n").split("\t")
            frac = float(seq[-1])
            gt[seq[0]] = ("hom" if frac > 80.0
                          else "het" if frac > 20.0 else "None")
    return gt


def evaluate(call, ans, bias, offset, opt, genotype):
    """Mark matches in both callset (row[-1]) and answers (slot 2/3/4+opt)
    at levels 1 (presence) / 2 (genotype) (eval_sim.py:97-144)."""
    for svtype in call:
        if svtype not in ans:
            if svtype == "INS":
                for i in call[svtype]:
                    for key in ans:
                        for j in ans[key]:
                            if i[0] == j[0] and abs(i[1] - j[1]) <= offset \
                                    and float(min(i[3], j[3])
                                              / max(i[3], j[3])) >= bias:
                                i[-1] = 1
                                j[3 + opt] = 1
                                if i[4] == genotype.get(j[0]):
                                    i[-1] = 2
                                    j[3 + opt] = 2
            continue
        for i in call[svtype]:
            for j in ans[svtype]:
                if i[0] != j[0]:
                    continue
                if svtype == "INS":
                    if abs(i[1] - j[1]) <= offset and float(
                            min(i[3], j[2]) / max(i[3], j[2])) >= bias:
                        j[2 + opt] = 1
                        i[-1] = 1
                        if i[4] == genotype.get(j[0]):
                            j[2 + opt] = 2
                            i[-1] = 2
                elif svtype == "BND":
                    if i[2] != j[2]:
                        continue
                    if abs(i[1] - j[1]) <= offset and \
                            abs(i[3] - j[3]) <= offset:
                        i[-1] = 1
                        j[4 + opt] = 1
                        if i[5] == genotype.get(j[0]) \
                                or i[5] == genotype.get(j[2]):
                            i[-1] = 2
                            j[4 + opt] = 2
                else:
                    if max(i[1] - offset, j[1]) <= min(i[2] + offset,
                                                       j[2]) and float(
                            min(i[3], j[3]) / max(i[3], j[3])) >= bias:
                        j[3 + opt] = 1
                        i[-1] = 1
                        if i[4] == genotype.get(j[0]):
                            j[3 + opt] = 2
                            i[-1] = 2


def statistics(call, ans, opt, res) -> dict:
    """TP/total per type at level ``res``; returns a summary dict and logs
    the reference's lines."""
    out = {}
    for svtype in call:
        tp = sum(1 for ele in call[svtype] if ele[-1] >= res)
        total = len(call[svtype])
        logging.info("TP-%d of %s:\t%d\t%d" % (res, svtype, tp, total))
        out[("call", svtype)] = (tp, total)
    for svtype in ans:
        slot = {"INS": 2, "BND": 4}.get(svtype, 3) + opt
        fn = sum(1 for ele in ans[svtype] if ele[slot] >= res)
        total = len(ans[svtype])
        logging.info("TN-%d of %s:\t%d\t%d" % (res, svtype, fn, total))
        out[("ans", svtype)] = (fn, total)
    return out


MODES = {"IID": ["INS", "INV", "DEL"], "DUP": ["INS", "DUP"],
         "BND": ["BND"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="eval_sim",
        description="Evaluate SV callsets against simulation ground truth.")
    p.add_argument("choice", type=str, choices=list(MODES),
                   help="SV-type mode [IID/DUP/BND]")
    p.add_argument("ans", type=str, help="Ground-truth bed (VISOR HACk).")
    p.add_argument("gt", type=str, help="Per-chromosome zygosity bed.")
    p.add_argument("callsets", nargs="+", type=str,
                   help="One or more VCF callsets to evaluate.")
    p.add_argument("-b", "--bias", default=0.7, type=float)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    t0 = time.time()
    ans = load_ans(args.ans, n_slots=max(4, len(args.callsets)))
    genotype = load_gt(args.gt)
    for opt, path in enumerate(args.callsets, start=1):
        callset, abnormal = load_callset(path, MODES[args.choice])
        logging.info("Callset %s abnormal types:" % path)
        for key, n in abnormal.items():
            logging.info("<%s>\t%d." % (key, n))
        evaluate(callset, ans, args.bias, args.offect, opt, genotype)
        statistics(callset, ans, opt, 1)
        statistics(callset, ans, opt, 2)
    logging.info("Finished in %0.2f seconds." % (time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
