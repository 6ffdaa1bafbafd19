"""End-to-end calling pipeline on one GPU.

BAM decode (Python reader) -> signature store -> resolution (DEL/INS on
the device, DUP/INV/TRA on the host oracle) -> genotype fill (the CUDA
cover-count kernel for DEL/INS) -> VCF. The slice of
``cutesv_tpu/pipeline.py`` the port carries so far; whatever lies
outside it raises NotImplementedError naming its ROADMAP.md item rather
than quietly taking another path.
"""
from __future__ import annotations

import functools
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from cutesv_tpu_torch import extract, sigstore, vcf
from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.genotype import (assign_gt_del_ins, cover_counts,
                                       gl_table, support_inter_counts)
from cutesv_tpu_torch.io.bam import BamReader
from cutesv_tpu_torch.io.fasta import FastaFile
from cutesv_tpu_torch.models import device as device_models
from cutesv_tpu_torch.models import host as host_models
from cutesv_tpu_torch.ops.cover import cover_counts_cuda
from cutesv_tpu_torch.utils.torchsetup import resolve_device

log = logging.getLogger("cutesv_tpu_torch")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        "%s is not ported to cutesv_tpu_torch yet (ROADMAP.md, Queue 1 "
        "item %d); run it with the cutesv_tpu package" % (what, item))


def check_slice(cfg: Config) -> None:
    """Raise for every option this slice of the port does not carry."""
    if cfg.decoder == "native":
        raise _not_ported("--decoder native", 6)
    if cfg.Ivcf is not None:
        raise _not_ported("force calling (-Ivcf)", 14)
    if cfg.n_shards > 1:
        raise _not_ported("--n_shards > 1", 11)
    if cfg.distributed:
        raise _not_ported("--distributed", 12)
    if cfg.profile:
        raise _not_ported("--profile", 13)
    if os.environ.get("CUTESV_STREAM_DISPATCH") == "1":
        raise _not_ported("streaming decode dispatch", 10)


def load_bed_regions(path: Optional[str]) -> Optional[Dict[str, list]]:
    """Padded include regions per chrom (load_bed, cuteSV_genotype.py:704).

    The reference assigns regions to extraction tasks and tests reads
    against their task's regions; with streaming decode we test against all
    regions of the read's chromosome (equivalent unless a read is longer
    than a genome batch)."""
    if path is None:
        return None
    regions: Dict[str, list] = {}
    with open(path) as fh:
        for line in fh:
            seq = line.strip().split("\t")
            regions.setdefault(seq[0], []).append(
                (int(seq[1]) - 1000, int(seq[2]) + 1000))
    for chrom in regions:
        regions[chrom].sort()
    return regions


def decode_bam(cfg: Config):
    """Stream the BAM once, extracting signatures + read census, with the
    pure-Python reader (the only decoder of this slice)."""
    with open(cfg.input, "rb") as probe:
        if probe.read(4) == b"CRAM":
            raise _not_ported("CRAM input", 15)
    if cfg.decoder == "auto":
        log.info("decoder auto: using the python BAM reader (the native "
                 "decoder is not ported yet)")
    return _decode_bam_python(cfg)


def _decode_bam_python(cfg: Config):
    candidates = extract.new_candidate_dict()
    census_rows: List[tuple] = []
    allread_rows: List[tuple] = []
    bed = load_bed_regions(cfg.include_bed)
    reader = BamReader(cfg.input)
    chrom_names = [n for n, _ in reader.references]
    chrom_lengths = {n: l for n, l in reader.references}
    n_records = 0
    prev_ref = -1
    prev_pos = -1
    seen_refs = set()
    for rec in reader:
        if rec.ref_id < 0 or rec.flag & 0x4:
            continue
        n_records += 1
        if rec.ref_id != prev_ref:
            if rec.ref_id in seen_refs:
                raise ValueError(
                    "input is not coordinate-sorted (%s appears in more "
                    "than one block); sort it first, e.g. 'samtools sort'"
                    % chrom_names[rec.ref_id])
            seen_refs.add(rec.ref_id)
            prev_ref = rec.ref_id
            prev_pos = rec.pos
        elif rec.pos < prev_pos:
            raise ValueError(
                "input is not coordinate-sorted (%s:%d after %s:%d); "
                "sort it first, e.g. 'samtools sort'"
                % (chrom_names[rec.ref_id], rec.pos,
                   chrom_names[rec.ref_id], prev_pos))
        else:
            prev_pos = rec.pos
        chrom = chrom_names[rec.ref_id]
        pos_start = rec.pos
        pos_end = rec.reference_end
        allread_rows.append((pos_start, pos_end,
                             1 if rec.flag in (0, 16) else 0,
                             rec.qname, chrom))
        if rec.flag in (256, 272):
            continue
        if bed is not None:
            regions = bed.get(chrom, [])
            if not any(pos_end > r0 and pos_start < r1
                       for r0, r1 in regions):
                continue
        extract.extract_read(rec, candidates, chrom, cfg.min_size,
                             cfg.min_mapq, cfg.max_split_parts,
                             cfg.min_read_len, cfg.min_siglength,
                             cfg.merge_del_threshold, cfg.merge_ins_threshold,
                             cfg.max_size)
        if rec.mapq >= cfg.min_mapq:
            census_rows.append((pos_start, pos_end,
                                1 if rec.flag in (0, 16) else 0,
                                rec.qname, chrom))
    reader.close()
    store = sigstore.build_store(candidates, census_rows, allread_rows,
                                 chrom_lengths)
    return store, candidates, reader.references, n_records


def _fill_gt_del_ins(cands: List[list], jobs: List[dict], store, chrom,
                     cover_fn) -> List[list]:
    """call_gt for DEL/INS (cuteSV_resolveINDEL.py:441-479); ``cover_fn``
    counts the covering reads (the CUDA kernel on the device engine)."""
    if chrom not in store.census:
        return []
    windows = [j["window"] for j in jobs]
    supports = [j["support"] for j in jobs]
    rows = assign_gt_del_ins(windows, supports, store.census[chrom],
                             cover_fn=cover_fn)
    for cand, (dv, dr, gt, pl, gq, qual) in zip(cands, rows):
        cand[7] = str(dr)
        cand[8] = str(gt)
        cand[9] = str(pl)
        cand[10] = str(gq)
        cand[11] = str(qual)
    return cands


def _two_window_inter_counts(census, jobs) -> np.ndarray:
    """#(support entries whose primary alignment covers window1 OR
    window2) per job. Rank-identity censuses answer via the shared
    searchsorted table; string censuses via a per-census cached dict
    (last primary per name wins in both)."""
    n_sv = len(jobs)
    name_col = census["name"]
    if (isinstance(name_col, np.ndarray)
            and np.issubdtype(name_col.dtype, np.integer)):
        return support_inter_counts(census,
                                    [j["support"] for j in jobs],
                                    [[j["window1"] for j in jobs],
                                     [j["window2"] for j in jobs]])
    name_iv = census.get("_prim_iv")
    if name_iv is None:
        prim = census["is_primary"] == 1
        p_start = census["start"][prim]
        p_end = census["end"][prim]
        p_names = [census["name"][i] for i in np.nonzero(prim)[0]]
        name_iv = {n: (p_start[k], p_end[k])
                   for k, n in enumerate(p_names)}
        census["_prim_iv"] = name_iv
    inters = np.zeros(n_sv, np.int64)
    for i, job in enumerate(jobs):
        (s1, e1), (s2, e2) = job["window1"], job["window2"]
        inter = 0
        for name in job["support"]:
            iv = name_iv.get(name)
            if iv is None:
                continue
            if ((iv[0] <= s1 and iv[1] >= e1)
                    or (iv[0] <= s2 and iv[1] >= e2)):
                inter += 1
        inters[i] = inter
    return inters


def _two_window_apply(cands, jobs, census, c1, c2, ch, idxs) -> None:
    """Host half of the DUP/INV genotype: union of the two breakpoint
    window covers minus support reads covering either window
    (cuteSV_resolveDUP.py:137-160, cuteSV_resolveINV.py:208-230)."""
    dr_i, gt_i, pl_i, gq_i, qual_i = idxs
    table = gl_table()
    unions = (np.asarray(c1, np.int64) + np.asarray(c2, np.int64)
              - np.asarray(ch, np.int64)).tolist()
    inters = _two_window_inter_counts(census, jobs)
    for cand, job, union, inter in zip(cands, jobs, unions, inters):
        dr = union - int(inter)
        gt, pl, gq, qual = table.lookup(dr, len(job["support"]))
        cand[dr_i] = str(dr)
        cand[gt_i] = str(gt)
        cand[pl_i] = str(pl)
        cand[gq_i] = str(gq)
        cand[qual_i] = str(qual)


def _two_window_groups(jobs):
    w1 = [j["window1"] for j in jobs]
    w2 = [j["window2"] for j in jobs]
    hull = [(min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(w1, w2)]
    return [w1, w2, hull]


def _fill_gt_two_windows(cands: List[list], jobs: List[dict], store, chrom,
                         idxs) -> List[list]:
    """call_gt for DUP/INV on the host: exact host cover counts of both
    breakpoint windows and their hull (candidates on a chromosome without
    census rows are dropped, as in the JAX package's batched pass)."""
    if not jobs:
        return cands
    census = store.census.get(chrom)
    if census is None:
        return []
    prim = census["is_primary"] == 1
    c1, c2, ch = (cover_counts(g, census["start"][prim], census["end"][prim])
                  for g in _two_window_groups(jobs))
    _two_window_apply(cands, jobs, census, c1, c2, ch, idxs)
    return cands


def resolve_all(store: sigstore.SigStore, cfg: Config,
                device=None) -> Dict[str, List]:
    """Cluster + genotype every chromosome; returns chrom -> candidate rows
    in the reference's DEL, INS, INV, DUP, TRA submission order.

    ``cfg.engine`` "device"/"auto": DEL/INS cluster on ``device`` and
    their genotypes count covers with the CUDA kernel (the plain version
    on a CPU device); DUP/INV/TRA resolve on the host oracle, whose
    output equals the JAX package's device engine. "host": the numpy
    oracle for every type."""
    device = resolve_device(device)
    check_slice(cfg)
    action = cfg.genotype
    results: Dict[str, List] = {}
    # resolution-side sentinel filter (the reference's seeded cluster loops
    # silently discard (0,0)-coordinate rows; stage 2 keeps them)
    sig = {t: {c: sigstore.drop_sentinel_rows(t, s)
               for c, s in store.sigs[t].items()}
           for t in sigstore.SVTYPES}
    names = store.names  # rank -> string (rank stores); None on this path
    use_device = cfg.engine != "host"

    def add(chrom, rows):
        if rows:
            results.setdefault(chrom, []).extend(rows)

    min_sup5 = min(cfg.min_support, 5)
    if use_device:
        # both cluster programs are enqueued before either n_kept is read
        del_state = device_models.resolve_indel_multi_start(
            list(sig["DEL"].items()), False, cfg.min_support,
            cfg.max_cluster_bias_DEL, device)
        ins_state = device_models.resolve_indel_multi_start(
            list(sig["INS"].items()), True, cfg.min_support,
            cfg.max_cluster_bias_INS, device)
        device_models.prefetch_counts(del_state, ins_state)
        device_models.resolve_indel_multi_compact(del_state)
        device_models.resolve_indel_multi_compact(ins_state)
        device_models.prefetch_to_host(del_state, ins_state)
        del_res = device_models.resolve_indel_multi_finish(
            del_state, cfg.diff_ratio_merging_DEL, min_sup5,
            cfg.remain_reads_ratio, action, need_names=cfg.report_readid)
        ins_res = device_models.resolve_indel_multi_finish(
            ins_state, cfg.diff_ratio_merging_INS, min_sup5,
            cfg.remain_reads_ratio, action, need_names=cfg.report_readid)
        cover_fn = functools.partial(cover_counts_cuda, device=device)
    else:
        del_res = {
            chrom: host_models.resolve_del(
                sigs, chrom, cfg.min_support, cfg.diff_ratio_merging_DEL,
                cfg.max_cluster_bias_DEL, min_sup5, cfg.remain_reads_ratio,
                action, names=names)
            for chrom, sigs in sig["DEL"].items()}
        ins_res = {
            chrom: host_models.resolve_ins(
                sigs, chrom, cfg.min_support, cfg.diff_ratio_merging_INS,
                cfg.max_cluster_bias_INS, min_sup5, cfg.remain_reads_ratio,
                action, names=names)
            for chrom, sigs in sig["INS"].items()}
        cover_fn = None
    inv_res = {
        chrom: host_models.resolve_inv(
            sigs, chrom, cfg.min_support, cfg.max_cluster_bias_INV,
            cfg.min_size, cfg.max_size, action, names=names)
        for chrom, sigs in sig["INV"].items()}
    dup_res = {
        chrom: host_models.resolve_dup(
            sigs, chrom, cfg.min_support, cfg.max_cluster_bias_DUP,
            cfg.min_size, cfg.max_size, action, names=names)
        for chrom, sigs in sig["DUP"].items()}
    tra_out = {
        chrom: host_models.resolve_tra(
            sigs_t, chrom, cfg.min_support, cfg.diff_ratio_filtering_TRA,
            cfg.max_cluster_bias_TRA, store.read_tables, store.chrom_lengths,
            action, cfg.gt_round, names=names)
        for chrom, sigs_t in sig["TRA"].items()}
    for res, svtype in ((del_res, "DEL"), (ins_res, "INS")):
        for chrom in sig[svtype]:
            cands, jobs = res[chrom]
            if action:
                cands = _fill_gt_del_ins(cands, jobs, store, chrom, cover_fn)
            log.info("Finished %s:%s." % (chrom, svtype))
            add(chrom, cands)
    for res, svtype, idxs in ((inv_res, "INV", (5, 6, 8, 9, 10)),
                              (dup_res, "DUP", (5, 6, 7, 8, 9))):
        for chrom in sig[svtype]:
            cands, jobs = res[chrom]
            if action:
                cands = _fill_gt_two_windows(cands, jobs, store, chrom, idxs)
            log.info("Finished %s:%s." % (chrom, svtype))
            add(chrom, cands)
    for chrom in sig["TRA"]:
        log.info("Finished %s:%s." % (chrom, "TRA/BND"))
        add(chrom, tra_out[chrom])
    return results


def run_pipeline(cfg: Config, argv: Optional[List[str]] = None,
                 device=None) -> dict:
    """Full discovery run on ``device`` (CUDA unless the caller asks for
    the CPU); returns stage timing + counters."""
    argv = argv if argv is not None else []
    device = resolve_device(device)
    check_slice(cfg)
    # input validation up front (cuteSV:999-1011)
    if not os.path.isfile(cfg.reference):
        raise FileNotFoundError(
            "[Errno 2] No such file: '%s'" % cfg.reference)
    if not os.path.isfile(cfg.input):
        raise FileNotFoundError("[Errno 2] No such file: '%s'" % cfg.input)
    ckpt = os.path.join(cfg.work_dir, "sigstore.pickle") if cfg.work_dir \
        else None
    if cfg.work_dir and not cfg.resume:
        # refuse to clobber a previous run's signature artifacts
        # (cuteSV:1005-1011); --resume reuses them instead
        for item in list(sigstore.SVTYPES) + ["sigstore"]:
            for suffix in (".sigs", ".pickle"):
                path = os.path.join(cfg.work_dir, item + suffix)
                if os.path.exists(path) and not (
                        item == "sigstore" and suffix == ".sigs"):
                    raise FileExistsError(
                        "[Errno 2] File exists: '%s' "
                        "(use --resume to reuse, or clean the work dir)"
                        % path)
    stats = {}
    t0 = time.time()
    # open + index the reference FASTA on a side thread: the emitter needs
    # it only after resolve, and the open cost is page-in/IO wait that
    # hides completely under the decode stage
    fasta_box: List = []

    def _open_fasta():
        try:
            fasta_box.append(FastaFile(cfg.reference))
        except BaseException as exc:  # re-raised at emit time
            fasta_box.append(exc)

    fasta_thread = threading.Thread(target=_open_fasta, daemon=True)
    fasta_thread.start()
    if cfg.resume and ckpt and os.path.exists(ckpt):
        log.info("Resuming from signature checkpoint %s" % ckpt)
        store = sigstore.load_store(cfg.work_dir)
        candidates = None
        references = [(c, l) for c, l in store.chrom_lengths.items()]
        n_records = -1
    else:
        store, candidates, references, n_records = decode_bam(cfg)
    stats["decode_s"] = time.time() - t0
    stats["n_records"] = n_records
    stats["n_sigs"] = {t: sum(len(v) for v in store.sigs[t].values())
                       for t in sigstore.SVTYPES}
    log.info("Decoded %d records; signatures: %s"
             % (n_records, " ".join("%s=%d" % kv
                                    for kv in stats["n_sigs"].items())))

    if cfg.work_dir:
        os.makedirs(cfg.work_dir, exist_ok=True)
        if cfg.retain_work_dir and not cfg.resume:
            sigstore.save_store(store, cfg.work_dir)
        if cfg.write_old_sigs:
            if candidates is not None:
                sigstore.write_old_sigs(store, cfg.work_dir, candidates)
            else:
                sigstore.write_old_sigs_native(store, cfg.work_dir)

    t1 = time.time()
    results = resolve_all(store, cfg, device)
    stats["resolve_s"] = time.time() - t1
    stats["n_calls"] = sum(len(v) for v in results.values())

    t2 = time.time()
    fasta_thread.join()
    fasta = fasta_box[0]
    if isinstance(fasta, BaseException):
        raise fasta
    per_chrom = {}
    for chrom, rows in results.items():
        if chrom not in fasta:
            raise KeyError(
                "No corresponding contig in reference with %s." % chrom)
        per_chrom[chrom] = vcf.format_chrom_records(
            cfg, rows, fasta.fetch_lazy(chrom), chrom)
    vcf.write_vcf(cfg.output, cfg, per_chrom, references, argv)
    stats["emit_s"] = time.time() - t2
    stats["total_s"] = time.time() - t0
    return stats
