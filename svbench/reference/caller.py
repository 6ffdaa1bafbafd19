"""The plain reference caller: cuteSV's semantics on the benchmark's own
read plans, in plain Python and NumPy.

It takes the same inputs as the program, the reads that
``svbench/corpus.py`` makes from the seed, but from the plans themselves
and not from the BAM, and computes the VCF body that cuteSV 2.1.4 gives
for them: per-read signature extraction (``extract``), the signature
store (``sigstore``), the host resolvers (``host``), the genotype counts
on the host (``genotype``) and the record lines (``vcf``), all copies in
this folder. The orchestration below follows the Python-decoder and
``--engine host`` paths of ``cutesv_tpu_torch/pipeline.py``. It imports
nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from svbench import corpus, truth
from svbench.reference import extract, genotype, host, sigstore, vcf

# cuteSV 2.1.4's defaults (cuteSV_Description.py) and the presets the
# configurations name (its documented per-platform settings)
DEFAULTS = dict(
    max_split_parts=7, min_mapq=20, min_read_len=500, merge_del_threshold=0,
    merge_ins_threshold=100, min_support=10, min_size=30, max_size=100_000,
    min_siglength=10, genotype=False, gt_round=500, read_range=1000,
    max_cluster_bias_INS=100, diff_ratio_merging_INS=0.3,
    max_cluster_bias_DEL=200, diff_ratio_merging_DEL=0.5,
    max_cluster_bias_INV=500, max_cluster_bias_DUP=500,
    max_cluster_bias_TRA=50, diff_ratio_filtering_TRA=0.6,
    remain_reads_ratio=1.0, report_readid=False, ignore_sequence=False)
PRESETS = {
    "ccs": dict(max_cluster_bias_INS=1000, diff_ratio_merging_INS=0.9,
                max_cluster_bias_DEL=1000, diff_ratio_merging_DEL=0.5),
    "ont": dict(max_cluster_bias_INS=100, diff_ratio_merging_INS=0.3,
                max_cluster_bias_DEL=100, diff_ratio_merging_DEL=0.3),
}
_FLAGS = {"-s": "min_support", "--min_support": "min_support",
          "-q": "min_mapq", "-l": "min_size", "-L": "max_size"}


@dataclasses.dataclass
class Settings:
    values: dict

    def __getattr__(self, name):
        try:
            return self.values[name]
        except KeyError:
            raise AttributeError(name) from None


def settings(argv: List[str]) -> Settings:
    """The run's settings from the configuration's arguments: cuteSV's
    defaults, then the preset, then the explicit flags."""
    values = dict(DEFAULTS)
    explicit = {}
    k = 0
    while k < len(argv):
        tok = argv[k]
        if tok == "--genotype":
            values["genotype"] = True
        elif tok == "--preset":
            values.update(PRESETS[argv[k + 1]])
            k += 1
        elif tok in _FLAGS:
            explicit[_FLAGS[tok]] = int(argv[k + 1])
            k += 1
        else:
            raise ValueError("the reference does not know %r" % tok)
        k += 1
    values.update(explicit)
    return Settings(values)


class _Seq:
    """A record's query sequence, built from its plan on demand: the
    extraction slices it only at its insertions."""

    def __init__(self, plan, r, ref):
        self.plan, self.r, self.ref = plan, r, ref

    def __getitem__(self, sl):
        return corpus.codes_to_bytes(
            self.plan.query(self.r, self.ref)[sl]).decode()


@dataclasses.dataclass
class Record:
    qname: str
    flag: int
    pos: int
    mapq: int
    cigar: list
    query_length: int
    reference_end: int
    seq: object
    tags: dict


def extract_contig(args):
    """Worker: signatures and census rows of one contig, as the Python
    decoder's loop makes them (``pipeline._decode_bam_python``)."""
    seed, ci, config, traffic, values = args
    cfg = Settings(values)
    plan, ref, svs = corpus.contig_plan(seed, ci, config, traffic)
    sites = truth.contig_sites(plan, ref, svs, values)
    chrom = plan.chrom
    out = extract.new_candidate_dict()
    census, allread = [], []
    for r in range(len(plan)):
        cigar = plan.cigar(r)
        qlen = sum(ln for op, ln in cigar if op in (0, 1, 4, 7, 8))
        end = plan.pos[r] + sum(ln for op, ln in cigar
                                if op in (0, 2, 3, 7, 8))
        flag = int(plan.flag[r])
        tags = {"SA": plan.sa[r]} if r in plan.sa else {}
        seq = (corpus.codes_to_bytes(plan.query(r, ref)).decode() if tags
               else _Seq(plan, r, ref))
        rec = Record(plan.names[r], flag, int(plan.pos[r]),
                     int(plan.mapq[r]), cigar, qlen, int(end), seq, tags)
        primary = 1 if flag in (0, 16) else 0
        allread.append((rec.pos, rec.reference_end, primary, rec.qname,
                        chrom))
        if flag in (256, 272):
            continue
        extract.extract_read(rec, out, chrom, cfg.min_size, cfg.min_mapq,
                             cfg.max_split_parts, cfg.min_read_len,
                             cfg.min_siglength, cfg.merge_del_threshold,
                             cfg.merge_ins_threshold, cfg.max_size)
        if rec.mapq >= cfg.min_mapq:
            census.append((rec.pos, rec.reference_end, primary, rec.qname,
                           chrom))
    return ci, out, census, allread, sites


def _fill_gt_del_ins(cands, jobs, store, chrom):
    if chrom not in store.census:
        return []
    rows = genotype.assign_gt_del_ins([j["window"] for j in jobs],
                                      [j["support"] for j in jobs],
                                      store.census[chrom])
    for cand, (dv, dr, gt, pl, gq, qual) in zip(cands, rows):
        cand[7:12] = [str(dr), str(gt), str(pl), str(gq), str(qual)]
    return cands


def _fill_gt_two_windows(cands, jobs, store, chrom, idxs):
    """DUP/INV genotypes: the union of the two breakpoint windows' covers
    less the support reads covering either (cuteSV_resolveDUP.py:137-160,
    cuteSV_resolveINV.py:208-230)."""
    census = store.census.get(chrom)
    if census is None:
        return []
    if not jobs:
        return cands
    prim = census["is_primary"] == 1
    st, en = census["start"][prim], census["end"][prim]
    w1 = [j["window1"] for j in jobs]
    w2 = [j["window2"] for j in jobs]
    hull = [(min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(w1, w2)]
    c1, c2, ch = (np.asarray(genotype.cover_counts(w, st, en), np.int64)
                  for w in (w1, w2, hull))
    p_names = [census["name"][i] for i in np.nonzero(prim)[0]]
    name_iv = {n: (st[k], en[k]) for k, n in enumerate(p_names)}
    dr_i, gt_i, pl_i, gq_i, qual_i = idxs
    table = genotype.gl_table()
    for cand, job, union in zip(cands, jobs, (c1 + c2 - ch).tolist()):
        (s1, e1), (s2, e2) = job["window1"], job["window2"]
        inter = 0
        for name in job["support"]:
            iv = name_iv.get(name)
            if iv is not None and ((iv[0] <= s1 and iv[1] >= e1)
                                   or (iv[0] <= s2 and iv[1] >= e2)):
                inter += 1
        dr = union - inter
        gt, pl, gq, qual = table.lookup(dr, len(job["support"]))
        cand[dr_i], cand[gt_i], cand[pl_i] = str(dr), str(gt), str(pl)
        cand[gq_i], cand[qual_i] = str(gq), str(qual)
    return cands


def resolve(store, cfg) -> Dict[str, List]:
    """Cluster and genotype every chromosome (``resolve_all`` with
    ``--engine host``), rows in cuteSV's DEL, INS, INV, DUP, TRA order."""
    action = cfg.genotype
    sig = {t: {c: sigstore.drop_sentinel_rows(t, s)
               for c, s in store.sigs[t].items()} for t in sigstore.SVTYPES}
    sup5 = min(cfg.min_support, 5)
    results: Dict[str, List] = {}

    def add(chrom, rows):
        if rows:
            results.setdefault(chrom, []).extend(rows)

    for svtype, fn, ratio, bias in (
            ("DEL", host.resolve_del, cfg.diff_ratio_merging_DEL,
             cfg.max_cluster_bias_DEL),
            ("INS", host.resolve_ins, cfg.diff_ratio_merging_INS,
             cfg.max_cluster_bias_INS)):
        for chrom, sigs in sig[svtype].items():
            cands, jobs = fn(sigs, chrom, cfg.min_support, ratio, bias,
                             sup5, cfg.remain_reads_ratio, action)
            if action:
                cands = _fill_gt_del_ins(cands, jobs, store, chrom)
            add(chrom, cands)
    for svtype, fn, bias, idxs in (
            ("INV", host.resolve_inv, cfg.max_cluster_bias_INV,
             (5, 6, 8, 9, 10)),
            ("DUP", host.resolve_dup, cfg.max_cluster_bias_DUP,
             (5, 6, 7, 8, 9))):
        for chrom, sigs in sig[svtype].items():
            cands, jobs = fn(sigs, chrom, cfg.min_support, bias,
                             cfg.min_size, cfg.max_size, action)
            if action:
                cands = _fill_gt_two_windows(cands, jobs, store, chrom,
                                             idxs)
            add(chrom, cands)
    for chrom, sigs in sig["TRA"].items():
        add(chrom, host.resolve_tra(
            sigs, chrom, cfg.min_support, cfg.diff_ratio_filtering_TRA,
            cfg.max_cluster_bias_TRA, store.read_tables, store.chrom_lengths,
            action, cfg.gt_round))
    return results


def reference_body(seed: int, config: dict, traffic: dict, workers: int,
                   control: bool = False) -> List[str]:
    """The VCF body lines of :func:`reference`."""
    return reference(seed, config, traffic, workers, control)[0]


def reference(seed: int, config: dict, traffic: dict, workers: int,
              control: bool = False):
    """(The VCF body lines cuteSV gives for the sample of ``seed``, the
    planted sites of ``truth.contig_sites``.) With ``control``, the output
    check's control: the DEL/INS/DUP/INV genotypes break the
    configurations' DR guarantee by counting the supporting reads that
    cover a window among its reference reads."""
    cfg = settings(config["argv"])
    sizes = corpus.contig_sizes(config)
    names = config["genome"]["contigs"]
    tasks = [(seed, ci, config, traffic, cfg.values)
             for ci in range(len(sizes))]
    if workers <= 1:
        parts = [extract_contig(t) for t in tasks]
    else:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(extract_contig, tasks)
    candidates = extract.new_candidate_dict()
    census, allread, sites = [], [], []
    for _, out, cen, alr, sit in sorted(parts, key=lambda p: p[0]):
        for t in candidates:
            candidates[t].extend(out[t])
        census.extend(cen)
        allread.extend(alr)
        sites.extend(sit)
    del parts
    store = sigstore.build_store(candidates, census, allread,
                                 dict(zip(names, sizes)))
    if control:
        # no census name matches a supporting read's, so DR keeps them
        store.census = {c: dict(cen, name=[n + "\0" for n in cen["name"]])
                        for c, cen in store.census.items()}
    results = resolve(store, cfg)
    per_chrom = {}
    for chrom, rows in results.items():
        ci = names.index(chrom)
        ref = corpus.codes_to_bytes(
            corpus.contig_ref(seed, ci, sizes[ci])).decode()
        per_chrom[chrom] = vcf.format_chrom_records(cfg, rows, ref, chrom)
    return vcf.vcf_body(per_chrom), sites
