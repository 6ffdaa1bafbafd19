"""Callset comparison toolkit.

One matching engine behind the reference's family of comparison CLIs
(src/benchmarks/: eval_BND.py, eval_trio.py, multi_platform.py,
sta_venn.py, cmp_NA19240.py — all share the same load + pairwise-match
logic with per-script bookkeeping):

* :func:`load_callset` — VCF rows to match records per type (BND ALT
  parsed into mate coordinates + bracket form).
* :func:`match` — the reference's criteria: INS by position offset + size
  ratio; DEL/INV/DUP by padded interval overlap + size ratio; BND by mate
  chrom/form equality + both-breakend offset.
* CLIs:
  - ``eval_bnd``        false-positive count of one BND callset vs a base
  - ``eval_trio``       Mendelian-consistency stats for a trio
  - ``concordance``     N-way overlap matrix (multi-platform / Venn)
"""
from __future__ import annotations

import argparse
import itertools
import logging
import sys
import time
from typing import Dict

from cutesv_tpu_torch.tools.eval_sim import (_parse_bnd_alt, parse_info,
                                             phase_gt)


def load_callset(path: str, min_bnd_dv: int = 0,
                 bnd_numeric_swap: bool = False) -> Dict[str, list]:
    """Rows: DEL/INS/DUP/INV -> [chrom, pos, end, len, gt, flags];
    BND -> [chrom, pos, chr2, end2, form, gt, flags].

    ``bnd_numeric_swap``: for numeric chromosome pairs, mirror
    eval_BND.py:66-77 / eval_sim.py:66-77 — smaller chromosome first;
    in the non-swap branch the sequential ifs collapse ']]N' into 'N[['
    ('N[[' itself round-trips). eval_bnd uses it; the trio/concordance
    scripts don't."""
    callset: Dict[str, list] = {}
    with open(path) as fh:
        for line in fh:
            seq = line.strip("\n").split("\t")
            if not seq[0] or seq[0][0] == "#":
                continue
            chrom = seq[0]
            pos = int(seq[1])
            info = parse_info(seq[7])
            svtype = info["SVTYPE"]
            if svtype == "TRA":
                svtype = "BND"
            gt = phase_gt(seq[9]) if len(seq) > 9 else "unknown"
            if svtype in ("DEL", "INS", "DUP", "INV"):
                if info["SVLEN"] == 0:
                    # reference fallback (eval_trio.py:45-46); when END is
                    # also absent this goes negative there too — kept
                    # faithful, the scorers are differential-pinned
                    info["SVLEN"] = info["END"] - pos + 1
                callset.setdefault(svtype, []).append(
                    [chrom, pos, info["END"], info["SVLEN"], gt, set()])
            elif svtype == "BND":
                try:
                    form, chr2, pos2 = _parse_bnd_alt(seq[4])
                except (IndexError, ValueError):
                    continue
                if info["END"] == 0:
                    info["CHR2"] = chr2
                    info["END"] = pos2
                if info["CHR2"] == "":
                    info["CHR2"] = chr2
                if min_bnd_dv > 0 and len(seq) > 9:
                    try:
                        if int(seq[9].split(":")[2]) < min_bnd_dv:
                            continue
                    except (IndexError, ValueError):
                        pass
                row = [chrom, pos, info["CHR2"], info["END"], form, gt,
                       set()]
                if bnd_numeric_swap:
                    try:
                        if int(chrom) > int(info["CHR2"]):
                            row = [info["CHR2"], info["END"], chrom, pos,
                                   form, gt, set()]
                        elif form == "]]N":
                            row[4] = "N[["
                    except ValueError:
                        pass
                callset.setdefault("BND", []).append(row)
    return callset


def records_match(svtype, a, b, bias, offset, match_bnd_form=True) -> bool:
    if a[0] != b[0]:
        return False
    if svtype == "INS":
        return (abs(a[1] - b[1]) <= offset
                and min(a[3], b[3]) / max(a[3], b[3]) >= bias)
    if svtype == "BND":
        if a[2] != b[2]:
            return False
        if match_bnd_form and a[4] != b[4]:
            return False
        return abs(a[1] - b[1]) <= offset and abs(a[3] - b[3]) <= offset
    return (max(a[1] - offset, b[1]) <= min(a[2] + offset, b[2])
            and min(a[3], b[3]) / max(a[3], b[3]) >= bias)


def match(call_a, call_b, bias, offset, tag_a, tag_b,
          gt_filter_b=None, match_bnd_form=True):
    """Mark matching records in both callsets by adding the given tags to
    their flag sets. ``gt_filter_b`` restricts which B records participate
    (the trio eval matches only hom parents, eval_trio.py:86-88)."""
    for svtype in call_a:
        if svtype not in call_b:
            continue
        for b in call_b[svtype]:
            if gt_filter_b is not None and b[-2] not in gt_filter_b:
                continue
            for a in call_a[svtype]:
                if records_match(svtype, a, b, bias, offset,
                                 match_bnd_form):
                    a[-1].add(tag_a)
                    b[-1].add(tag_b)


def eval_bnd(argv=None) -> int:
    """FP count of a BND callset vs a base callset (eval_BND.py:82-99)."""
    p = argparse.ArgumentParser(prog="eval_bnd")
    p.add_argument("base", type=str)
    p.add_argument("comp", type=str)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    _setup_logging()
    base = load_callset(args.base, bnd_numeric_swap=True)
    comp = load_callset(args.comp, bnd_numeric_swap=True)
    tp = 0
    for i in comp.get("BND", []):
        for j in base.get("BND", []):
            if (i[0] == j[0] and i[2] == j[2]
                    and abs(i[1] - j[1]) <= args.offect
                    and abs(i[3] - j[3]) <= args.offect):
                tp += 1
                break
    total = len(comp.get("BND", []))
    logging.info("False positive in BND: %d" % (total - tp))
    logging.info("Total amount of BND: %d" % total)
    return 0


def eval_trio(argv=None) -> int:
    """Trio Mendelian-consistency statistics (eval_trio.py:127-146)."""
    p = argparse.ArgumentParser(prog="eval_trio")
    p.add_argument("MP", type=str, help="Male parent callset")
    p.add_argument("FP", type=str, help="Female parent callset")
    p.add_argument("F1", type=str, help="Offspring callset")
    p.add_argument("-b", "--bias", default=0.7, type=float)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    _setup_logging()
    child = load_callset(args.F1)
    father = load_callset(args.MP)
    mother = load_callset(args.FP)
    # hom calls in a parent must appear in the child; any child call must
    # appear in a parent
    match(child, father, args.bias, args.offect, "x", "m",
          gt_filter_b=["hom"])
    match(child, mother, args.bias, args.offect, "x", "m",
          gt_filter_b=["hom"])
    match(father, child, args.bias, args.offect, "x", "m",
          gt_filter_b=["hom", "het"])
    match(mother, child, args.bias, args.offect, "x", "m",
          gt_filter_b=["hom", "het"])

    def stats(callset, label, gts):
        for svtype in ["DEL", "INS", "INV", "BND", "DUP", "ALL"]:
            rows = (itertools.chain.from_iterable(callset.values())
                    if svtype == "ALL" else callset.get(svtype, []))
            rec = consistent = 0
            for r in rows:
                if r[-2] in gts:
                    rec += 1
                    if "m" in r[-1]:
                        consistent += 1
            pct = 100 * consistent / rec if rec else 0.0
            logging.info("%s-%s: %d\t%d\t%.2f." % (label, svtype, rec,
                                                   consistent, pct))

    stats(child, "F1", ["hom", "het"])
    stats(father, "MP", ["hom"])
    stats(mother, "FP", ["hom"])
    return 0


def concordance(argv=None) -> int:
    """N-way callset overlap counts per SV type (generalizes
    multi_platform.py's 3-way matrix and sta_venn.py's 4-way Venn)."""
    p = argparse.ArgumentParser(prog="sv_concordance")
    p.add_argument("callsets", nargs="+", type=str)
    p.add_argument("-b", "--bias", default=0.7, type=float)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    _setup_logging()
    sets = [load_callset(path) for path in args.callsets]
    names = [str(i) for i in range(len(sets))]
    for i, j in itertools.combinations(range(len(sets)), 2):
        match(sets[i], sets[j], args.bias, args.offect, names[j], names[i])
    svtypes = sorted({t for s in sets for t in s})
    for idx, (path, cs) in enumerate(zip(args.callsets, sets)):
        logging.info("Callset %d: %s" % (idx, path))
        for svtype in svtypes:
            rows = cs.get(svtype, [])
            patterns: Dict[str, int] = {}
            for r in rows:
                key = "".join("1" if names[k] in r[-1] else "0"
                              for k in range(len(sets)) if k != idx)
                patterns[key] = patterns.get(key, 0) + 1
            logging.info("%s total of callset %d:\t%d"
                         % (svtype, idx, len(rows)))
            for key in sorted(patterns):
                logging.info("  shared-with[%s]:\t%d" % (key,
                                                         patterns[key]))
    return 0


def cmp_base(argv=None) -> int:
    """Recall of N callsets against a published base callset
    (cmp_NA19240.py equivalent): 50..100000 bp size window, DUP counted as
    INS, INS by position+ratio, others by padded overlap+ratio."""
    p = argparse.ArgumentParser(prog="cmp_base")
    p.add_argument("base", type=str, help="Base (published) VCF.")
    p.add_argument("callsets", nargs="+", type=str)
    p.add_argument("-b", "--bias", default=0.7, type=float)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    _setup_logging()

    def load(path):
        out: Dict[str, list] = {}
        cs = load_callset(path)
        for svtype, rows in cs.items():
            if svtype == "BND":
                continue
            t = "INS" if svtype == "DUP" else svtype
            for chrom, pos, end, svlen, gt, flags in rows:
                if svtype != "INV" and not 50 <= svlen <= 100000:
                    continue
                out.setdefault(t, []).append([chrom, pos, end, svlen, gt,
                                              flags])
        return out

    base = load(args.base)
    for path in args.callsets:
        comp = load(path)
        match(comp, base, args.bias, args.offect, "hit", path)
        for svtype in sorted(comp):
            tp = sum(1 for r in comp[svtype] if "hit" in r[-1])
            logging.info("%s %s: matched %d / %d"
                         % (path, svtype, tp, len(comp[svtype])))
        for svtype in sorted(base):
            found = sum(1 for r in base[svtype] if path in r[-1])
            logging.info("base %s vs %s: recalled %d / %d"
                         % (svtype, path, found, len(base[svtype])))
    return 0


def _na_info(info_str: str) -> dict:
    """pase_base_info (cmp_NA19240.py:24-36): abs-int SVLEN/END/RE,
    3-char SVTYPE."""
    info = {"SVLEN": 0, "END": 0, "SVTYPE": "", "RE": 0}
    for kv in info_str.split(";"):
        k = kv.split("=")[0]
        if k in ("SVLEN", "END", "RE"):
            try:
                info[k] = abs(int(kv.split("=")[1]))
            except (IndexError, ValueError):
                pass
        if k == "SVTYPE":
            info[k] = kv.split("=")[1][0:3]
    return info


def _na_load(path: str, flavor: str):
    """The four caller-specific loaders of cmp_NA19240.py, faithful to
    each quirk:

    - ``base``/``svim``: SV type from the symbolic ALT (seq[4][1:4]);
      INV rows use END-pos+1 as length with NO size filter; base maps
      DUP->INS.
    - ``cutesv``: type from the ID column (``cuteSV.DEL.n`` -> chars
      7:10); 50..100000 size filter on every type; a run of INVs is
      collapsed to its longest member, flushed only when a later
      non-INV record arrives (a trailing INV run is silently dropped,
      cmp_NA19240.py:95-102).
    - ``sniffles``: like cutesv but the type comes from INFO.
    - ``pbsv``: type from INFO; INV direct with END-pos+1 and no size
      filter; others filtered.
    """
    out: Dict[str, dict] = {}
    last_inv: list = []

    def add(svtype, chrom, row):
        out.setdefault(svtype, {}).setdefault(chrom, []).append(row)

    with open(path) as fh:
        for line in fh:
            seq = line.strip("\n").split("\t")
            if not seq[0] or seq[0][0] == "#":
                continue
            chrom = seq[0]
            pos = int(seq[1])
            info = _na_info(seq[7])
            if flavor in ("base", "svim"):
                svtype = seq[4][1:4]
                if svtype not in ("INS", "INV", "DEL", "DUP"):
                    continue
                if flavor == "base" and svtype == "DUP":
                    svtype = "INS"
                out.setdefault(svtype, {}).setdefault(chrom, [])
                if svtype == "INV":
                    add(svtype, chrom,
                        [pos, info["END"] - pos + 1, info["END"], 0])
                elif 50 <= info["SVLEN"] <= 100000:
                    add(svtype, chrom, [pos, info["SVLEN"], info["END"],
                                        0])
            else:
                if flavor == "cutesv":
                    svtype = seq[2][7:10]
                else:
                    svtype = info["SVTYPE"]
                if svtype not in ("INS", "INV", "DEL", "DUP"):
                    continue
                out.setdefault(svtype, {}).setdefault(chrom, [])
                if flavor == "pbsv":
                    if svtype == "INV":
                        add(svtype, chrom,
                            [pos, info["END"] - pos + 1, info["END"], 0])
                    elif 50 <= info["SVLEN"] <= 100000:
                        add(svtype, chrom, [pos, info["SVLEN"],
                                            info["END"], 0])
                elif 50 <= info["SVLEN"] <= 100000:
                    if svtype == "INV":
                        last_inv.append([svtype, chrom, pos,
                                         info["SVLEN"], info["END"],
                                         info["RE"]])
                    else:
                        add(svtype, chrom, [pos, info["SVLEN"],
                                            info["END"], 0])
                        if last_inv:
                            last_inv.sort(key=lambda x: -x[3])
                            add(last_inv[0][0], last_inv[0][1],
                                [last_inv[0][2], last_inv[0][3],
                                 last_inv[0][4], 0])
                            last_inv = []
    return out


def _na_score(base, call, flag, bias, offect):
    """cmp_callsets (cmp_NA19240.py:207-263): padded-overlap + size-ratio
    flag marking, then precision/recall/F over INS+DEL+INV."""
    for svtype in base:
        if svtype not in call:
            continue
        for chrom in base[svtype]:
            for i in base[svtype].get(chrom, []):
                for j in call[svtype].get(chrom, []):
                    if (i[0] - offect <= j[0] <= i[2] + offect
                            or i[0] - offect <= j[2] <= i[2] + offect
                            or j[0] - offect <= i[0] <= j[2] + offect):
                        if min(i[1], j[1]) / max(i[1], j[1]) >= bias:
                            i[3] = flag
                            j[3] = flag
    tp_base = total_base = tp_call = total_call = 0
    for svtype in ("INS", "DEL", "INV"):
        for chrom in base.get(svtype, {}):
            for i in base[svtype][chrom]:
                total_base += 1
                tp_base += i[3] == flag
        for chrom in call.get(svtype, {}):
            for i in call[svtype][chrom]:
                total_call += 1
                tp_call += i[3] == flag
    logging.info("Camp count: %d" % total_call)
    logging.info("TP-call count: %d" % tp_call)
    # the reference divides unguarded (cmp_NA19240.py); report 0 instead
    # of ZeroDivisionError on empty/disjoint callsets
    logging.info("Precision: %.2f"
                 % (100.0 * tp_call / total_call if total_call else 0.0))
    logging.info("Recall: %.2f"
                 % (100.0 * tp_base / total_base if total_base else 0.0))
    f_den = total_base * tp_call + tp_base * total_call
    logging.info("F-measure: %.2f"
                 % (200.0 * tp_base * tp_call / f_den if f_den else 0.0))
    return tp_base, total_base, tp_call, total_call


def cmp_na19240(argv=None) -> int:
    """Faithful cmp_NA19240.py: compare caller VCFs against a published
    base callset with the reference's exact loaders and scoring."""
    p = argparse.ArgumentParser(prog="cmp_na19240")
    p.add_argument("base", type=str)
    p.add_argument("callsets", nargs="+", type=str,
                   help="caller VCFs as flavor:path "
                        "(flavor in cutesv/sniffles/pbsv/svim)")
    p.add_argument("-b", "--bias", default=0.7, type=float)
    p.add_argument("-o", "--offect", default=1000, type=int)
    args = p.parse_args(argv)
    _setup_logging()
    base = _na_load(args.base, "base")
    for flag, spec in enumerate(args.callsets, start=1):
        flavor, _, path = spec.partition(":")
        if not path:
            flavor, path = "cutesv", spec
        logging.info("====%s====" % path)
        _na_score(base, _na_load(path, flavor), flag, args.bias,
                  args.offect)
    return 0


def _setup_logging():
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")


if __name__ == "__main__":
    raise SystemExit(concordance())
