"""The planted pair and translocation sites of a benchmark sample: the
DUP, INV and BND records that cuteSV 2.1.4 prints for the split carriers
that ``svbench/corpus.py`` plants, computed from the generator's plans
and cuteSV's documented rules alone.

It shares no code with the program (``cutesv_tpu_torch``), none with the
frozen copy in ``svbench/reference/`` and none with JAX. It reads the
read plans that ``corpus.contig_plan`` makes from the seed and the SVs
that ``corpus.sv_plan`` plants, and knows cuteSV only by these rules:

* **Signatures** (cuteSV's split-read analysis, two segments). A record
  that is primary (FLAG 0 or 16), passes ``--min_mapq``, is at least
  ``--min_read_len`` long and carries one ``SA`` alignment gives two
  segments, each (read start, read end, reference start, reference end,
  contig, strand) in the primary's orientation: the primary's from its
  clips, the SA's from its soft clips and the bases its CIGAR takes on
  the reference. In read order they make: on one contig and strand,
  where the first ends at least ``--min_size`` past the second's start
  and by more than the read bases between them, a DUP (second start,
  first end); on one contig and opposite strands, an INV, '++' joining
  the two ends or '--' the two starts, when they lie ``--min_size`` apart
  and the second's read start lies past the first's read end less half
  that distance; on two contigs with at most 100 read bases between
  them, a BND at the junction (the first's end or start as it is forward
  or reverse, the second's start or end), of type A, B, C or D by the
  two strands (N[, N], [N, ]N), placed on the contig whose name sorts
  first, with the type that contig sees.
* **Clusters**, per contig, over the rows sorted and with exact
  duplicates dropped. DUP: a pos1 gap of more than
  ``max_cluster_bias_DUP`` opens a cluster, a gap in the pos2-sorted rows
  a sub-cluster; POS and END are the means of the 40-60th percentile band
  of the sub-cluster (its middle row where the band is empty). INV: a
  strand change or a forward gap in either breakpoint opens a cluster, a
  gap in the bp2-sorted rows a group; the breakpoints are the group's
  means, rounded. BND: a change of mate contig or type, or a pos1 gap of
  more than ``max_cluster_bias_TRA``, opens a cluster; the pos2-sorted
  rows split at pos2 gaps into sub-clusters whose sums count the
  cluster's first row twice; the one or two sub-clusters with the most
  reads are kept when together they hold ``diff_ratio_filtering_TRA`` of
  the cluster's rows. Every cluster and sub-cluster needs ``-s`` distinct
  reads (and as many rows); DUP and INV lengths lie within
  ``--min_size`` and ``--max_size``.
* **Records**: RE counts the distinct reads; a DUP's POS is its start
  plus one, END POS plus SVLEN, REF the base at POS; an INV '++' sits at
  its start (REF the base before it), '--' one base later, END POS plus
  SVLEN; a BND of type A or B sits at its breakpoint, C or D one base
  later, its ALT the bracketed mate (plus one for A and C) beside the REF
  base.

Each record is then tied to what the generator planted (``corpus.sv_plan``,
``corpus.bnd_breakends``; :func:`_planted_for`). :func:`sites` returns one
site per record, each with the planted SV it stands for (``planted``),
so that a test can hold the sites to the plan: every planted DUP and
INV, and every breakend pair of a planted BND, that has at least ``-s``
carriers is one site.

Not modelled: reads of three or more segments, and the INS and DEL that
split reads can give (the corpus's carriers make neither); the genotype
fields of these records (DR, GT, PL, GQ, QUAL, FILTER, AF), left to the
frozen copy. REF is the reference base as it is (the corpus's bases are
ACGT, which cuteSV's IUPAC translation leaves alone).
"""
from __future__ import annotations

import re
from typing import Dict, List

from svbench import corpus

NUMBERS = ("pair_sites_missed", "pair_sites_split", "pair_records_extra",
           "pair_alleles_off", "pair_counts_off")
TYPES = ("DUP", "INV", "BND")
# cuteSV 2.1.4's defaults of the settings these records depend on (no
# preset changes them)
DEFAULTS = dict(min_support=10, min_mapq=20, min_read_len=500, min_size=30,
                max_size=100_000, max_split_parts=7,
                max_cluster_bias_DUP=500, max_cluster_bias_INV=500,
                max_cluster_bias_TRA=50, diff_ratio_filtering_TRA=0.6)
_FLAGS = {"-s": "min_support", "--min_support": "min_support",
          "-q": "min_mapq", "--min_mapq": "min_mapq",
          "-r": "min_read_len", "--min_read_len": "min_read_len",
          "-l": "min_size", "--min_size": "min_size",
          "-L": "max_size", "--max_size": "max_size",
          "-p": "max_split_parts", "--max_split_parts": "max_split_parts",
          **{"--" + k: k for k in ("max_cluster_bias_DUP",
                                   "max_cluster_bias_INV",
                                   "max_cluster_bias_TRA",
                                   "diff_ratio_filtering_TRA")}}
# (first strand, second strand) -> the BND type seen from the first
# segment's contig, and from the second's
_BND_TYPE = {("+", "+"): ("A", "D"), ("+", "-"): ("B", "B"),
             ("-", "+"): ("C", "C"), ("-", "-"): ("D", "A")}
_MATE = re.compile(r"[\[\]]([^\[\]:]+):(\d+)[\[\]]")
# BAM CIGAR codes: M I D N S H P = X
_QUERY_OPS = (0, 1, 4, 7, 8)
_REF_OPS = (0, 2, 3, 7, 8)
_CLIP_OPS = (4, 5)


def settings(argv: List[str]) -> dict:
    """cuteSV's defaults, then the configuration's explicit flags."""
    values = dict(DEFAULTS)
    for k, tok in enumerate(argv[:-1]):
        if tok in _FLAGS:
            key = _FLAGS[tok]
            values[key] = type(DEFAULTS[key])(argv[k + 1])
    return values


def _within(n: int, top: int) -> bool:
    return n <= top or top == -1


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _sa_segment(entry: str, total: int) -> list:
    chrom, pos, strand, cigar = entry.split(",")[:4]
    items = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDNSHP=X])",
                                                  cigar)]
    first = items[0][0] if items[0][1] == "S" else 0
    last = items[-1][0] if items[-1][1] == "S" else 0
    start = int(pos) - 1
    end = start + sum(n for n, op in items if op in "MD=X")
    if strand == "+":
        return [first, total - last, start, end, chrom, "+"]
    return [last, total - first, start, end, chrom, "-"]


def _flip(seg: list, total: int) -> list:
    return [total - seg[1], total - seg[0]] + seg[2:]


def _read_signatures(segments: list, total: int, name: str,
                     min_size: int, out: Dict[str, list]) -> None:
    """Add the DUP, INV or BND signature of one read's two segments to
    ``out`` (rows per type, each led by the contig it is placed on)."""
    e1, e2 = sorted(segments, key=lambda s: s[0])
    if e1[4] != e2[4]:
        if e2[0] - e1[1] > 100:
            return
        bp1 = e1[3] if e1[5] == "+" else e1[2]
        bp2 = e2[2] if e2[5] == "+" else e2[3]
        seen1, seen2 = _BND_TYPE[(e1[5], e2[5])]
        if e1[4] < e2[4]:
            out["BND"].append((e1[4], e2[4], seen1, bp1, bp2, name))
        else:
            out["BND"].append((e2[4], e1[4], seen2, bp2, bp1, name))
        return
    chrom = e1[4]
    if e1[5] != e2[5]:
        ends = (e1[3], e2[3]) if e1[5] == "+" else (e1[2], e2[2])
        strand = "++" if e1[5] == "+" else "--"
        lo, hi = min(ends), max(ends)
        if hi - lo >= min_size and e2[0] + 0.5 * (hi - lo) >= e1[1]:
            out["INV"].append((chrom, strand, lo, hi, name))
        return
    if e1[5] == "-":
        e1, e2 = _flip(e2, total), _flip(e1, total)
    overlap = e1[3] - e2[2]
    if overlap >= min_size and e2[0] - e1[1] < overlap:
        out["DUP"].append((chrom, e2[2], e1[3], name))


def _contig_signatures(args) -> Dict[str, list]:
    """Worker: the signatures of contig ``ci``'s split reads, and the SVs
    planted on it."""
    seed, ci, config, traffic, values = args
    plan, _, svs = corpus.contig_plan(seed, ci, config, traffic)
    out: Dict[str, list] = {t: [] for t in TYPES}
    for r, sa in sorted(plan.sa.items()):
        flag, mapq = int(plan.flag[r]), int(plan.mapq[r])
        if flag not in (0, 16) or mapq < values["min_mapq"]:
            continue
        cig = plan.cigar(r)
        total = sum(n for op, n in cig if op in _QUERY_OPS)
        if total < values["min_read_len"]:
            continue
        left = cig[0][1] if cig[0][0] in _CLIP_OPS else 0
        right = cig[-1][1] if cig[-1][0] in _CLIP_OPS else 0
        start = int(plan.pos[r])
        end = start + sum(n for op, n in cig if op in _REF_OPS)
        if flag == 0:
            primary = [left, total - right, start, end, plan.chrom, "+"]
        else:
            primary = [right, total - left, start, end, plan.chrom, "-"]
        segments = [primary] + [_sa_segment(e, total)
                                for e in sa.split(";") if e]
        if len(segments) == 2 and _within(2, values["max_split_parts"]):
            _read_signatures(segments, total, plan.names[r],
                             values["min_size"], out)
    out["planted"] = [dict(sv, chrom=plan.chrom) for sv in svs
                      if sv["kind"] in TYPES]
    return out


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def _runs(rows: list, breaks) -> List[list]:
    """``rows`` cut where ``breaks(previous, row)`` holds."""
    out: List[list] = []
    for row in rows:
        if not out or breaks(out[-1][-1], row):
            out.append([])
        out[-1].append(row)
    return out


def _distinct(names) -> int:
    return len(set(names))


def dup_records(rows: list, v: dict) -> List[dict]:
    """DUP rows (pos1, pos2, name) of one contig -> (bp1, bp2, RE)."""
    bias, rc = v["max_cluster_bias_DUP"], v["min_support"]
    out = []
    for cl in _runs(rows, lambda a, b: b[0] - a[0] > bias):
        if len(cl) < rc or _distinct(r[2] for r in cl) < rc:
            continue
        for sub in _runs(sorted(cl, key=lambda r: r[1]),
                         lambda a, b: b[1] - a[1] > bias):
            support = _distinct(r[2] for r in sub)
            if support < rc:
                continue
            lo, hi = int(len(sub) * 0.4), int(len(sub) * 0.6)
            band = sub[lo:hi] or [sub[lo]]
            bp1 = int(sum(r[0] for r in band) / len(band))
            bp2 = int(sum(r[1] for r in band) / len(band))
            if v["min_size"] <= bp2 - bp1 and _within(bp2 - bp1,
                                                      v["max_size"]):
                out.append(dict(bp1=bp1, bp2=bp2, re=support))
    return out


def inv_records(rows: list, v: dict) -> List[dict]:
    """INV rows (strand, bp1, bp2, name) of one contig -> records."""
    bias, rc = v["max_cluster_bias_INV"], v["min_support"]
    out = []
    for cl in _runs(rows, lambda a, b: (a[0] != b[0] or b[1] - a[1] > bias
                                        or b[2] - a[2] > bias)):
        if len(cl) < rc or _distinct(r[3] for r in cl) < rc:
            continue
        for grp in _runs(sorted(cl, key=lambda r: r[2]),
                         lambda a, b: b[2] - a[2] > bias):
            support = _distinct(r[3] for r in grp)
            bp1 = round(sum(r[1] for r in grp) / len(grp))
            bp2 = round(sum(r[2] for r in grp) / len(grp))
            if (len(grp) >= rc and support >= rc
                    and bp2 - bp1 >= v["min_size"]
                    and _within(bp2 - bp1, v["max_size"])):
                out.append(dict(strand=grp[0][0], bp1=bp1, bp2=bp2,
                                re=support))
    return out


def bnd_records(rows: list, v: dict) -> List[dict]:
    """BND rows (mate contig, type, pos1, pos2, name) of one contig ->
    records."""
    bias, rc = v["max_cluster_bias_TRA"], v["min_support"]
    ratio = v["diff_ratio_filtering_TRA"]
    out = []
    for cl in _runs(rows, lambda a, b: (a[:2] != b[:2]
                                        or b[2] - a[2] > bias)):
        if len(cl) < rc or _distinct(r[4] for r in cl) < rc:
            continue
        by2 = sorted(cl, key=lambda r: r[3])
        subs = _runs(by2, lambda a, b: b[3] - a[3] > bias)
        # the sums start from the first row and then add every row, the
        # first again
        sums = [[sum(r[2] for r in s), sum(r[3] for r in s), len(s),
                 _distinct(r[4] for r in s)] for s in subs]
        sums[0][0] += by2[0][2]
        sums[0][1] += by2[0][3]
        sums[0][2] += 1
        sums.sort(key=lambda s: -s[3])
        if len(sums) > 1 and sums[1][3] >= 0.5 * rc:
            kept = sums[:2] if sums[0][3] + sums[1][3] >= len(cl) * ratio \
                else []
        else:
            kept = sums[:1] if sums[0][3] >= len(cl) * ratio else []
        for s1, s2, n, support in kept:
            out.append(dict(mate=cl[0][0], kind=cl[0][1], p1=int(s1 / n),
                            p2=int(s2 / n), re=support))
    return out


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------

def _base(ref, k: int) -> str:
    return "ACGT"[int(ref[k])]


def _breakend_pairs(planted: List[dict], names: List[str]) -> List[tuple]:
    """(contig, mate contig, pos, mate pos, which of the two the carriers'
    primary alignments give, SV) of every breakend pair of the planted
    BNDs, placed as a record places them: on the contig whose name sorts
    first."""
    out = []
    for sv in planted:
        if sv["kind"] != "BND":
            continue
        mate = names[sv["ci2"]]
        for p1, p2 in corpus.bnd_breakends(sv["s"], sv["e"], sv["p2"],
                                           sv["s1"], sv["s2"]):
            if sv["chrom"] < mate:
                out.append((sv["chrom"], mate, p1, p2, 0, sv))
            else:
                out.append((mate, sv["chrom"], p2, p1, 1, sv))
    return out


def _planted_for(site: dict, planted: List[dict], pairs: List[tuple]):
    """The planted SV a site stands for. A DUP or INV: the planted SV of
    its kind whose start and end lie within the type's cluster bias of
    the site's breakpoints. A BND: the breakend pair whose SA side (the
    position the carriers' SA tags name) lies within the cluster bias of
    the site's, and whose primary side is the nearest, within
    ``corpus.FLANK``: the generator staggers a translocation's carriers
    along their primary alignments, by 150 bp a breakend pair and 5 bp a
    read."""
    b = site["bias"]
    if site["svtype"] != "BND":
        for sv in planted:
            if (sv["kind"] == site["svtype"] and sv["chrom"] == site["chrom"]
                    and abs(site["bp1"] - sv["s"]) <= b
                    and abs(site["bp2"] - sv["e"]) <= b):
                return sv
        return None
    best = None
    for chrom, mate, p1, p2, primary, sv in pairs:
        if chrom != site["chrom"] or mate != site["mate_chrom"]:
            continue
        at = (site["bp1"], site["bp2"])
        want = (p1, p2)
        gap = abs(at[primary] - want[primary])
        if (abs(at[1 - primary] - want[1 - primary]) <= b
                and gap <= corpus.FLANK and (best is None or gap < best[0])):
            best = (gap, sv)
    return best and best[1]


def sites(seed: int, config: dict, traffic: dict,
          workers: int = 1) -> List[dict]:
    """The DUP, INV and BND records cuteSV prints for the sample of
    ``seed``: dicts of the VCF fields :func:`check` compares, each with
    the cluster bias within which a record is its call (``bias``) and the
    planted SV it stands for (``planted``, None where none is near)."""
    v = settings(config["argv"])
    sizes = corpus.contig_sizes(config)
    names = config["genome"]["contigs"]
    tasks = [(seed, ci, config, traffic, v) for ci in range(len(sizes))]
    if workers <= 1:
        parts = [_contig_signatures(t) for t in tasks]
    else:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(_contig_signatures, tasks)
    rows: Dict[tuple, list] = {}
    planted: List[dict] = []
    for part in parts:
        planted.extend(part.pop("planted"))
        for kind, sigs in part.items():
            for sig in sigs:
                rows.setdefault((kind, sig[0]), []).append(sig[1:])
    pairs = _breakend_pairs(planted, names)
    out = []
    for ci, chrom in enumerate(names):
        got = {k: sorted(set(rows.get((k, chrom), ()))) for k in TYPES}
        if not any(got.values()):
            continue
        ref = corpus.contig_ref(seed, ci, sizes[ci])
        for r in dup_records(got["DUP"], v):
            svlen = r["bp2"] - r["bp1"]
            out.append(dict(chrom=chrom, svtype="DUP", pos=r["bp1"] + 1,
                            ref=_base(ref, r["bp1"]), alt="<DUP>",
                            svlen=svlen, end=r["bp1"] + 1 + svlen,
                            strand="-+", re=r["re"], bp1=r["bp1"],
                            bp2=r["bp2"], bias=v["max_cluster_bias_DUP"]))
        for r in inv_records(got["INV"], v):
            svlen = r["bp2"] - r["bp1"]
            pos = r["bp1"] if r["strand"] == "++" else r["bp1"] + 1
            out.append(dict(chrom=chrom, svtype="INV", pos=pos,
                            ref=_base(ref, max(pos - 1, 0)), alt="<INV>",
                            svlen=svlen, end=pos + svlen,
                            strand=r["strand"], re=r["re"], bp1=r["bp1"],
                            bp2=r["bp2"], bias=v["max_cluster_bias_INV"]))
        for r in bnd_records(got["BND"], v):
            kind, p1, p2 = r["kind"], r["p1"], r["p2"]
            mate = p2 + 1 if kind in "AC" else p2
            bracket = "[" if kind in "AC" else "]"
            joined = "%s%s:%d%s" % (bracket, r["mate"], mate, bracket)
            pos = p1 if kind in "AB" else p1 + 1
            base = _base(ref, max(pos - 1, 0))
            out.append(dict(chrom=chrom, svtype="BND", pos=pos, ref=base,
                            alt=(base + joined if kind in "AB"
                                 else joined + base),
                            mate_chrom=r["mate"], mate_pos=mate,
                            re=r["re"], bp1=p1, bp2=p2,
                            bias=v["max_cluster_bias_TRA"]))
    for site in out:
        site["planted"] = _planted_for(site, planted, pairs)
    return out


def planted_calls(seed: int, config: dict, traffic: dict) -> Dict[str, int]:
    """How many records the plan asks for, per type: every planted DUP and
    INV, and every breakend pair of a planted BND, whose carriers (every
    split carrier is primary at MAPQ 60) number at least ``-s``."""
    v = settings(config["argv"])
    sizes = corpus.contig_sizes(config)
    carriers = max(4, config["reads"]["coverage"] // 2)
    want = dict.fromkeys(TYPES, 0)
    if carriers < v["min_support"]:
        return want
    for ci in range(len(sizes)):
        for sv in corpus.sv_plan(seed, ci, sizes, traffic):
            if sv["kind"] == "BND":
                want["BND"] += len(corpus.bnd_breakends(
                    sv["s"], sv["e"], sv["p2"], sv["s1"], sv["s2"]))
            elif sv["kind"] in want:
                want[sv["kind"]] += 1
    return want


def _parse(line: str) -> dict:
    f = line.rstrip("\n").split("\t")
    info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
    r = dict(chrom=f[0], pos=int(f[1]), ref=f[3], alt=f[4], info=info,
             svtype=info.get("SVTYPE"))
    mate = _MATE.search(f[4]) if r["svtype"] == "BND" else None
    if mate:
        r.update(mate_chrom=mate.group(1), mate_pos=int(mate.group(2)))
    return r


def _near(r: dict, site: dict) -> bool:
    if r["chrom"] != site["chrom"] or r["svtype"] != site["svtype"]:
        return False
    if abs(r["pos"] - site["pos"]) > site["bias"]:
        return False
    if site["svtype"] != "BND":
        return True
    return (r.get("mate_chrom") == site["mate_chrom"]
            and abs(r["mate_pos"] - site["mate_pos"]) <= site["bias"])


def _alleles_match(r: dict, site: dict) -> bool:
    if (r["pos"], r["ref"], r["alt"]) != (site["pos"], site["ref"],
                                          site["alt"]):
        return False
    if site["svtype"] == "BND":
        return True
    info = r["info"]
    return (info.get("SVLEN") == str(site["svlen"])
            and info.get("END") == str(site["end"])
            and info.get("STRAND") == site["strand"])


def check(body: List[str], sites: List[dict]) -> Dict[str, int]:
    """How one call's VCF body departs from the planted pair sites:
    ``pair_sites_missed``, sites with no record of their type (and, for a
    BND, of their mate contig) within the type's cluster bias of their
    position (and mate position); ``pair_sites_split``, sites with more
    than one; ``pair_records_extra``, DUP, INV and BND records near no
    site; and of the sites with one record, ``pair_alleles_off`` (POS,
    REF, ALT, SVLEN, END or STRAND differing) and ``pair_counts_off``
    (RE differing)."""
    records = [r for r in map(_parse, body) if r["svtype"] in TYPES]
    n = dict.fromkeys(NUMBERS, 0)
    used = set()
    for site in sites:
        near = [k for k, r in enumerate(records) if _near(r, site)]
        used.update(near)
        if not near:
            n["pair_sites_missed"] += 1
        elif len(near) > 1:
            n["pair_sites_split"] += 1
        else:
            r = records[near[0]]
            n["pair_alleles_off"] += not _alleles_match(r, site)
            n["pair_counts_off"] += r["info"].get("RE") != str(site["re"])
    n["pair_records_extra"] = len(records) - len(used)
    return n
