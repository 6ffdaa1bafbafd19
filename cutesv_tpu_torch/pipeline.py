"""End-to-end calling pipeline on one GPU.

BAM decode (the C++ decoder by default, the Python reader on request) ->
signature store -> resolution (DEL/INS on the device, DUP/INV/TRA on the
host oracle) -> genotype fill (one batched pass of the CUDA cover-count
kernel per int32-safe flush) -> VCF. The slice of
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
    """Stream the BAM once, extracting signatures + read census.

    ``cfg.decoder`` "native" or "auto": the C++ decoder (native/), built
    with g++ at first use; a failed build or load raises, with no
    fallback. "python": the pure-Python reader, the behavioral oracle.
    The store carries ``decode_breakdown``: which decoder ran and, for
    the native one, its record-walk wall and inflate / record-parse
    core-seconds."""
    with open(cfg.input, "rb") as probe:
        if probe.read(4) == b"CRAM":
            raise _not_ported("CRAM input", 15)
    if cfg.decoder in ("native", "auto"):
        return _decode_bam_native(cfg)
    if cfg.decoder != "python":
        raise ValueError("unknown decoder %r (use native, python or auto)"
                         % cfg.decoder)
    return _decode_bam_python(cfg)


def _decode_bam_native(cfg: Config):
    from cutesv_tpu_torch.io import native as native_io
    bed_ids = None
    if cfg.include_bed is not None:
        bed = load_bed_regions(cfg.include_bed)
        # map chrom names to header ids via a cheap header-only read
        header = BamReader(cfg.input)
        name_to_id = {n: i for i, (n, _) in enumerate(header.references)}
        header.close()
        bc, bs, be = [], [], []
        for chrom, regions in bed.items():
            cid = name_to_id.get(chrom)
            if cid is None:
                continue
            for r0, r1 in regions:
                bc.append(cid)
                bs.append(r0)
                be.append(r1)
        if not bc:
            # no BED chrom matches the header (or the BED is empty): the
            # Python reader excludes EVERY read (bed.get(chrom, []) -> no
            # overlap); an empty region list would instead disable the
            # native filter entirely, so pass one impossible region to
            # keep it enabled-and-excluding
            bc, bs, be = [0], [-2], [-1]
        bed_ids = (np.array(bc, np.int32), np.array(bs, np.int64),
                   np.array(be, np.int64))
    nd = native_io.decode(cfg.input, cfg, bed_ids)
    _check_coordinate_sorted(nd.arrays["all_chr"], nd.arrays["all_start"],
                             nd.chroms)
    store = sigstore.build_store_native(nd)
    store.decode_breakdown = dict(decoder="native", walk_s=nd.walk_s,
                                  inflate_core_s=nd.inflate_core_s,
                                  records_core_s=nd.records_core_s)
    references = [(nd.chroms[i], int(nd.ref_lengths[i]))
                  for i in range(len(nd.ref_lengths))]
    return store, None, references, nd.n_records


def _check_coordinate_sorted(chr_ids, starts, chrom_names) -> None:
    """Reject inputs that are not coordinate-sorted (the Python reader
    makes the same checks record by record): a chromosome's starts must
    not decrease, and each chromosome must form one block."""
    ch = np.asarray(chr_ids)
    if len(ch) < 2:
        return
    st = np.asarray(starts)
    step = np.diff(ch)
    same = step == 0
    bad = np.flatnonzero(same & (np.diff(st) < 0))
    if len(bad):
        k = int(bad[0]) + 1
        raise ValueError(
            "input is not coordinate-sorted (%s:%d after %s:%d); "
            "sort it first, e.g. 'samtools sort'"
            % (chrom_names[int(ch[k])], int(st[k]),
               chrom_names[int(ch[k - 1])], int(st[k - 1])))
    run_starts = ch[np.r_[0, np.flatnonzero(step != 0) + 1]].tolist()
    if len(set(run_starts)) != len(run_starts):
        seen = set()
        rep = next(c for c in run_starts if c in seen or seen.add(c))
        raise ValueError(
            "input is not coordinate-sorted (%s appears in more than one "
            "block); sort it first, e.g. 'samtools sort'"
            % chrom_names[int(rep)])


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
    store.decode_breakdown = dict(decoder="python")
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


# doubled coordinates must stay inside int32 in the cover kernel, so one
# flush holds at most 1e9 (offset) bp of windows and reads
_FLUSH_BP = 1_000_000_000


def _batched_cover_multi(specs, store, cover_fn=None,
                         extra_blocks=()) -> None:
    """Cross-chromosome AND cross-SV-type cover-kernel batching shared by
    every genotype pass: windows and primary read intervals are offset
    into disjoint coordinate ranges so ONE kernel launch serves all
    chromosomes of all SV types of a flush. Only the positional cover
    counting is batched; the support-interval intersection stays per
    chromosome — read names can carry primary alignments on several
    chromosomes, and each chromosome's genotype must only see its own
    (call_gt's per-chrom reads list, cuteSV_resolveINDEL.py:443-448).
    Candidates on chromosomes without census rows are dropped (the
    empty-chrom contract).

    ``specs``: list of (per_chrom, win_groups_fn, apply_fn) passes.
    ``win_groups_fn(jobs)`` returns one or more window lists (each the
    length of ``jobs``); ``apply_fn(chrom, cands, jobs, census, counts)``
    receives the per-group cover-count slices in the same order.
    ``cover_fn(windows, starts, ends)``: the cover count of a flush (the
    CUDA kernel's wrapper on the device engine); None counts on the host.

    ``extra_blocks``: additional (windows, starts, ends, sink) dicts
    counted in the SAME kernel call against their own interval sets.
    Each sink(counts) receives its windows' counts."""
    cover = cover_fn or cover_counts
    state = dict(offset=0, windows=[], starts=[], ends=[], spans=[],
                 extras=[])

    def flush():
        if state["spans"] or state["extras"]:
            allc = cover(state["windows"],
                         np.concatenate(state["starts"]),
                         np.concatenate(state["ends"]))
            for si, chrom, ranges in state["spans"]:
                per_chrom, _, apply_fn = specs[si]
                cands, jobs = per_chrom[chrom]
                counts = [allc[lo:lo + m] for lo, m in ranges]
                apply_fn(chrom, cands, jobs, store.census[chrom], counts)
            for lo, m, sink in state["extras"]:
                sink(allc[lo:lo + m])
        state.update(offset=0, windows=[], starts=[], ends=[], spans=[],
                     extras=[])

    # chromosome union in first-appearance order: each chromosome's
    # census is appended once, shared by every spec active on it
    chrom_order: List[str] = []
    seen = set()
    for per_chrom, _, _ in specs:
        for c in per_chrom:
            if per_chrom[c][1] and c not in seen:
                seen.add(c)
                chrom_order.append(c)

    for chrom in chrom_order:
        census = store.census.get(chrom)
        active = [si for si, (per_chrom, _, _) in enumerate(specs)
                  if per_chrom.get(chrom, (None, None))[1]]
        if census is None:
            for si in active:
                per_chrom = specs[si][0]
                per_chrom[chrom] = ([], per_chrom[chrom][1])
            continue
        wgs = {si: specs[si][1](specs[si][0][chrom][1]) for si in active}
        hi = int(census["end"].max()) if len(census["end"]) else 0
        for si in active:
            for g in wgs[si]:
                if g:
                    hi = max(hi, int(max(w[1] for w in g)))
        span = hi + 2
        if span > _FLUSH_BP:
            # a single chromosome beyond the int32-safe coordinate budget
            # (the kernel doubles coordinates): count its covers exactly
            # on the host instead of wrapping int32 on the device
            prim_h = census["is_primary"] == 1
            for si in active:
                per_chrom, _, apply_fn = specs[si]
                cands, jobs = per_chrom[chrom]
                counts = [np.asarray(cover_counts(
                    g, census["start"][prim_h], census["end"][prim_h]))
                    for g in wgs[si]]
                apply_fn(chrom, cands, jobs, census, counts)
            continue
        if state["offset"] + span > _FLUSH_BP:
            flush()
        offset = state["offset"]
        prim = census["is_primary"] == 1
        for si in active:
            ranges = []
            for g in wgs[si]:
                lo = len(state["windows"])
                state["windows"].extend((a + offset, b + offset)
                                        for a, b in g)
                ranges.append((lo, len(g)))
            state["spans"].append((si, chrom, ranges))
        state["starts"].append(census["start"][prim] + offset)
        state["ends"].append(census["end"][prim] + offset)
        state["offset"] = offset + span
    for blk in extra_blocks:
        wins, starts, ends, sink = (blk["windows"], blk["starts"],
                                    blk["ends"], blk["sink"])
        if not wins:
            sink(np.zeros(0, np.int64))
            continue
        hi = int(ends.max()) + 2 if len(ends) else 0
        hi = max(hi, max(e for _, e in wins) + 2)
        if hi > _FLUSH_BP or len(wins) * 32 < len(starts):
            # host sweep when forced by the int32 budget — or when this
            # block's PRIVATE interval set dwarfs its window count: an
            # extra block ships its own intervals (the specs' censuses
            # are shared across window groups, these are not), so a host
            # searchsorted answers few windows in O(m log n) for less
            # than the upload of the whole table
            sink(np.asarray(cover_counts(wins, starts, ends)))
            continue
        if state["offset"] + hi > _FLUSH_BP:
            flush()
        off = state["offset"]
        lo = len(state["windows"])
        state["windows"].extend((a + off, b + off) for a, b in wins)
        state["extras"].append((lo, len(wins), blk["sink"]))
        state["starts"].append(starts + off)
        state["ends"].append(ends + off)
        state["offset"] = off + hi
    flush()


def _batched_cover_pass(per_chrom: Dict[str, tuple], store, cover_fn,
                        win_groups_fn, apply_fn) -> None:
    """Single-pass form of :func:`_batched_cover_multi`."""
    _batched_cover_multi([(per_chrom, win_groups_fn, apply_fn)], store,
                         cover_fn)


def _del_ins_apply(chrom, cands, jobs, census, counts):
    covers = counts[0]
    supports = [set(j["support"]) for j in jobs]
    inter = _support_inter_counts(census, jobs, supports)
    drs = (np.asarray(covers, np.int64)
           - np.asarray(inter, np.int64)).tolist()
    table = gl_table()
    for i, (cand, job) in enumerate(zip(cands, jobs)):
        dr = drs[i]
        dv = len(supports[i])
        gt, pl, gq, qual = table.lookup(dr, dv)
        cand[7] = str(dr)
        cand[8] = str(gt)
        cand[9] = str(pl)
        cand[10] = str(gq)
        cand[11] = str(qual)


def _del_ins_cover_spec(per_chrom: Dict[str, tuple]):
    return (per_chrom, lambda jobs: [[j["window"] for j in jobs]],
            _del_ins_apply)


def _support_inter_counts(census, jobs, supports=None) -> np.ndarray:
    """#(support reads whose primary alignment on THIS chromosome covers
    the window) per job; identities are integer ranks.
    ``supports``: optional precomputed [set(j["support"])] to share with
    the caller's DV counting."""
    if supports is None:
        supports = [set(j["support"]) for j in jobs]
    return support_inter_counts(census, supports,
                                [[j["window"] for j in jobs]])


def _two_windows_cover_spec(per_chrom: Dict[str, tuple], idxs):
    return (per_chrom, _two_window_groups,
            lambda chrom, cands, jobs, census, counts: _two_window_apply(
                cands, jobs, census, counts[0], counts[1], counts[2],
                idxs))


def _fill_gt_two_windows_batched(per_chrom: Dict[str, tuple], store,
                                 cover_fn, idxs) -> None:
    """call_gt for DUP/INV, all chromosomes in one cover pass."""
    _batched_cover_multi([_two_windows_cover_spec(per_chrom, idxs)],
                         store, cover_fn)


def _fill_gt_two_windows(cands: List[list], jobs: List[dict], store, chrom,
                         idxs) -> List[list]:
    """call_gt for DUP/INV, one chromosome at a time with host cover
    counts (host-engine path); delegates to the batched pass with a
    single-chromosome dict."""
    one = {chrom: (cands, jobs)}
    _fill_gt_two_windows_batched(one, store, None, idxs)
    return one[chrom][0]


def resolve_all(store: sigstore.SigStore, cfg: Config,
                device=None) -> Dict[str, List]:
    """Cluster + genotype every chromosome; returns chrom -> candidate rows
    in the reference's DEL, INS, INV, DUP, TRA submission order.

    ``cfg.engine`` "device"/"auto": DEL/INS cluster on ``device``;
    DUP/INV/TRA resolve on the host oracle, whose output equals the JAX
    package's device engine. The DUP/INV genotypes, and on a native
    (rank-keyed) store the DEL/INS ones too, count their covers in one
    batched pass: one CUDA kernel launch per int32-safe flush (the plain
    version on a CPU device). On a Python store DEL/INS genotypes count
    per chromosome. TRA genotypes stay inline in the host resolver.
    "host": the numpy oracle for every type, host cover counts."""
    device = resolve_device(device)
    check_slice(cfg)
    action = cfg.genotype
    results: Dict[str, List] = {}
    # resolution-side sentinel filter (the reference's seeded cluster loops
    # silently discard (0,0)-coordinate rows; stage 2 keeps them)
    sig = {t: {c: sigstore.drop_sentinel_rows(t, s)
               for c, s in store.sigs[t].items()}
           for t in sigstore.SVTYPES}
    names = store.names  # rank -> string (native store); None otherwise
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
        def rows_of(sigs):
            # native columnar stream -> resolver tuple rows
            return sigs.tuples() if hasattr(sigs, "tuples") else sigs
        del_res = {
            chrom: host_models.resolve_del(
                rows_of(sigs), chrom, cfg.min_support,
                cfg.diff_ratio_merging_DEL, cfg.max_cluster_bias_DEL,
                min_sup5, cfg.remain_reads_ratio, action, names=names)
            for chrom, sigs in sig["DEL"].items()}
        ins_res = {
            chrom: host_models.resolve_ins(
                rows_of(sigs), chrom, cfg.min_support,
                cfg.diff_ratio_merging_INS, cfg.max_cluster_bias_INS,
                min_sup5, cfg.remain_reads_ratio, action, names=names)
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
    # ONE read-support cover pass for every batched SV type and
    # chromosome: the census uploads once per flush and the kernel
    # launches once per flush
    specs = []
    filled = action and use_device and names is not None
    if filled:
        specs.append(_del_ins_cover_spec(del_res))
        specs.append(_del_ins_cover_spec(ins_res))
    if action and use_device:
        specs.append(_two_windows_cover_spec(inv_res, (5, 6, 8, 9, 10)))
        specs.append(_two_windows_cover_spec(dup_res, (5, 6, 7, 8, 9)))
        _batched_cover_multi(specs, store, cover_fn)
    for res, svtype in ((del_res, "DEL"), (ins_res, "INS")):
        for chrom in sig[svtype]:
            cands, jobs = res[chrom]
            if action and not filled:
                cands = _fill_gt_del_ins(cands, jobs, store, chrom, cover_fn)
            log.info("Finished %s:%s." % (chrom, svtype))
            add(chrom, cands)
    for res, svtype, idxs in ((inv_res, "INV", (5, 6, 8, 9, 10)),
                              (dup_res, "DUP", (5, 6, 7, 8, 9))):
        for chrom in sig[svtype]:
            cands, jobs = res[chrom]
            if action and not use_device:
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
        stats["decoder"] = "checkpoint"
        candidates = None
        references = [(c, l) for c, l in store.chrom_lengths.items()]
        n_records = -1
    else:
        store, candidates, references, n_records = decode_bam(cfg)
        stats.update(store.decode_breakdown)
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
