"""Host (oracle) resolvers for INS/DEL/DUP/INV/TRA clusters.

Reproduces the per-chromosome clustering semantics of the reference:
cuteSV_resolveINDEL.py, cuteSV_resolveDUP.py, cuteSV_resolveINV.py,
cuteSV_resolveTRA.py — gap clustering, per-read dedup (keep max length),
allele splitting on length diffs, breakpoint refinement via
closest-to-mean means, and the per-type genotype window construction.

All functions take already-merged, sorted, deduplicated per-chromosome
signature lists (the sigstore contract) and return the reference's
"candidate row" string lists, ready for the VCF emitter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from cutesv_tpu_torch.genotype import ReadTable, cal_CIPOS, call_gt_tra


def _gap_clusters(rows: Sequence, pos_of, read_count: int, bias: int,
                  also_break=None):
    """Split a sorted signature stream into clusters: a new cluster starts
    when pos - prev_pos > bias (or ``also_break(prev, cur)``); only clusters
    with >= read_count members (counting duplicates) are yielded.

    This is the distilled form of the reference's sentinel-seeded loop
    (cuteSV_resolveINDEL.py:49-100 and per-type variants): the [0,0,''] seed
    never survives into a generated cluster, so plain gap clustering with a
    size gate is equivalent.
    """
    out = []
    cur: List = []
    prev = None
    for row in rows:
        if prev is not None and (pos_of(row) - pos_of(prev) > bias
                                 or (also_break and also_break(prev, row))):
            if len(cur) >= read_count:
                out.append(cur)
            cur = []
        cur.append(row)
        prev = row
    if len(cur) >= read_count:
        out.append(cur)
    return out


def _dedup_keep_max(cluster: Sequence, len_idx: int, read_idx: int):
    """Per-read dedup keeping the max-length signature; first occurrence
    wins ties and keeps its stream position (dict-insertion semantics of
    cuteSV_resolveINDEL.py:125-131)."""
    tag: Dict = {}
    for row in cluster:
        name = row[read_idx]
        if name not in tag:
            tag[name] = row
        elif row[len_idx] > tag[name][len_idx]:
            tag[name] = row
    return list(tag.values())


def _closest_to_mean_mean(values: List, remain: int) -> float:
    """Mean over the ``remain`` members closest to the mean, selection
    ordered by (|v - mean|, index) (cuteSV_resolveINDEL.py:169-187)."""
    mean = np.mean(values)
    order = sorted(((abs(v - mean), i) for i, v in enumerate(values)))
    picked = [values[order[i][1]] for i in range(remain)]
    return np.mean(picked), picked


def finalize_indel_allele(poss, lens, support: int,
                          remain_reads_ratio: float) -> dict:
    """Float finalization of one DEL/INS allele: breakpoint/length means over
    the closest-to-mean members + CIPOS/CILEN
    (cuteSV_resolveINDEL.py:165-194). Shared by the host and device engines
    so f64 behavior is identical."""
    remain = max(int(remain_reads_ratio * support), 1)
    bp_mean, bp_picked = _closest_to_mean_mean(poss, remain)
    len_mean, _ = _closest_to_mean_mean(lens, remain)
    return dict(
        support=support,
        breakpoint=bp_mean,
        search_threshold=bp_picked[0],
        signal_len=len_mean,
        cipos=cal_CIPOS(np.std(poss), len(poss)),
        cilen=cal_CIPOS(np.std(lens), len(lens)),
    )


def _resolve_alleles_indel(cluster, read_count, threshold_gloab,
                           minimum_support_reads, remain_reads_ratio,
                           is_ins: bool):
    """Shared DEL/INS allele machinery (generate_del_cluster /
    generate_ins_cluster). Yields per-allele dicts."""
    dedup = _dedup_keep_max(cluster, len_idx=1, read_idx=2)
    if len(dedup) < read_count:
        return
    rows = sorted(dedup, key=lambda x: x[1])  # stable: ties keep stream order
    global_len = [r[1] for r in rows]
    threshold = threshold_gloab * np.mean(global_len)

    alleles = [[rows[0]]]
    last_len = rows[0][1]
    for r in rows[1:]:
        if r[1] - last_len > threshold:
            alleles.append([])
        alleles[-1].append(r)
        last_len = r[1]
    # process in increasing-support order (allele_sort on [count],
    # cuteSV_resolveINDEL.py:163); Python sort is stable so equal-support
    # alleles keep length order.
    for allele in sorted(alleles, key=lambda a: len(a)):
        support = len(allele)
        if support < minimum_support_reads:
            continue
        poss = [r[0] for r in allele]
        lens = [r[1] for r in allele]
        res = finalize_indel_allele(poss, lens, support, remain_reads_ratio)
        res["rows"] = allele
        yield res


def resolve_del(sigs: Sequence, chrom: str, read_count: int,
                threshold_gloab: float, max_cluster_bias: int,
                minimum_support_reads: int, remain_reads_ratio: float,
                action: bool, names: Optional[Sequence[str]] = None):
    """DEL resolution (resolution_DEL, cuteSV_resolveINDEL.py:17-108).

    ``sigs`` rows: (pos:int, len:int, read_key) sorted by (pos, len, key).
    Returns (candidates, gt_jobs) where gt_jobs carries the genotype windows
    and support sets when ``action``. ``names`` renders integer read keys
    (native decode path) to strings; string keys render as themselves.
    """
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    if remain_reads_ratio > 1:
        remain_reads_ratio = 1
    candidates = []
    gt_jobs = []
    clusters = _gap_clusters(sigs, lambda r: r[0], read_count,
                             max_cluster_bias)
    for cluster in clusters:
        for al in _resolve_alleles_indel(cluster, read_count, threshold_gloab,
                                         minimum_support_reads,
                                         remain_reads_ratio, is_ins=False):
            keys = [r[2] for r in al["rows"]]
            rnames = ",".join(render(k) for k in keys)
            if action:
                anchor = int(al["search_threshold"])
                gt_jobs.append(dict(
                    window=(max(anchor - max_cluster_bias, 0),
                            anchor + max_cluster_bias),
                    support=keys))
                candidates.append([chrom, "DEL", str(int(al["breakpoint"])),
                                   str(int(-al["signal_len"])),
                                   str(al["support"]), al["cipos"],
                                   al["cilen"], None, None, None, None, None,
                                   rnames])
            else:
                candidates.append([chrom, "DEL", str(int(al["breakpoint"])),
                                   str(int(-al["signal_len"])),
                                   str(al["support"]), al["cipos"],
                                   al["cilen"], ".", "./.", ".,.,.", ".",
                                   ".", rnames])
    return candidates, gt_jobs


def resolve_ins(sigs: Sequence, chrom: str, read_count: int,
                threshold_gloab: float, max_cluster_bias: int,
                minimum_support_reads: int, remain_reads_ratio: float,
                action: bool, names: Optional[Sequence[str]] = None):
    """INS resolution (resolution_INS, cuteSV_resolveINDEL.py:222-317).

    ``sigs`` rows: (pos:float, len:int, read_key, seq) sorted by
    (int(pos), len, key, seq). Genotype windows use the hardcoded 1000 bp
    bias (cuteSV_resolveINDEL.py:312). ``names`` renders integer read keys
    (native decode path) to strings; string keys render as themselves.
    """
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    if remain_reads_ratio > 1:
        remain_reads_ratio = 1
    candidates = []
    gt_jobs = []
    clusters = _gap_clusters(sigs, lambda r: r[0], read_count,
                             max_cluster_bias)
    for cluster in clusters:
        for al in _resolve_alleles_indel(cluster, read_count, threshold_gloab,
                                         minimum_support_reads,
                                         remain_reads_ratio, is_ins=True):
            breakpoint = al["breakpoint"]
            signal_len = al["signal_len"]
            # representative sequence: first member (length order) whose
            # sequence is long enough; drop the allele otherwise
            # (cuteSV_resolveINDEL.py:398-405)
            ideal_seq = None
            for r in al["rows"]:
                if len(r[3]) >= int(signal_len):
                    breakpoint = r[0]
                    ideal_seq = r[3][:int(signal_len)]
                    break
            if ideal_seq is None:
                continue
            keys = [r[2] for r in al["rows"]]
            rnames = ",".join(render(k) for k in keys)
            if action:
                anchor = int(breakpoint)
                gt_jobs.append(dict(window=(max(anchor - 1000, 0),
                                            anchor + 1000),
                                    support=keys))
                candidates.append([chrom, "INS", str(int(breakpoint)),
                                   str(int(signal_len)), str(al["support"]),
                                   al["cipos"], al["cilen"], None, None,
                                   None, None, None, rnames,
                                   ideal_seq])
            else:
                candidates.append([chrom, "INS", str(int(breakpoint)),
                                   str(int(signal_len)), str(al["support"]),
                                   al["cipos"], al["cilen"], ".", "./.",
                                   ".,.,.", ".", ".", rnames,
                                   ideal_seq])
    return candidates, gt_jobs


def resolve_dup(sigs: Sequence, chrom: str, read_count: int,
                max_cluster_bias: int, sv_size: int, max_size: int,
                action: bool, names: Optional[Sequence[str]] = None):
    """DUP resolution (resolution_DUP, cuteSV_resolveDUP.py:17-131).

    ``sigs`` rows: (pos1:int, pos2:int, read_key) sorted by
    (pos1, pos2, key). Breakpoints = means of the 40-60th percentile band
    of the pos2-sorted sub-cluster. ``names`` renders integer read keys
    (native decode path) to strings; string keys render as themselves.
    """
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    candidates = []
    gt_jobs = []
    clusters = _gap_clusters(sigs, lambda r: r[0], read_count,
                             max_cluster_bias)
    for cluster in clusters:
        dup_cluster_emit(cluster, chrom, read_count, max_cluster_bias,
                         sv_size, max_size, action, render, candidates,
                         gt_jobs)
    return candidates, gt_jobs


def dup_cluster_emit(cluster, chrom, read_count, max_cluster_bias, sv_size,
                     max_size, action, render, candidates, gt_jobs):
    """Per-cluster DUP sub-clustering + emission
    (generate_dup_cluster, cuteSV_resolveDUP.py:79-131). ``cluster`` rows
    may arrive pre-sorted by pos2 (stable ties by stream order) — the sort
    here is stable so the result is identical."""
    support_all = _stable_unique([r[2] for r in cluster])
    if len(support_all) < read_count:
        return
    by_p2 = sorted(cluster, key=lambda r: r[1])
    sub: List[List] = [[by_p2[0]]]
    last = by_p2[0][1]
    for r in by_p2[1:]:
        if r[1] - last > max_cluster_bias:
            sub.append([])
        sub[-1].append(r)
        last = r[1]
    for rows in sub:
        support = _stable_unique([r[2] for r in rows])
        if len(support) < read_count:
            continue
        low_b = int(len(rows) * 0.4)
        up_b = int(len(rows) * 0.6)
        if low_b == up_b:
            bp1, bp2 = rows[low_b][0], rows[low_b][1]
        else:
            band = rows[low_b:up_b]
            bp1 = int(sum(r[0] for r in band) / len(band))
            bp2 = int(sum(r[1] for r in band) / len(band))
        if not (sv_size <= bp2 - bp1 <= max_size
                or (sv_size <= bp2 - bp1 and max_size == -1)):
            continue
        if action:
            ncb = min(max_cluster_bias, bp2 - bp1)
            gt_jobs.append(dict(
                window1=(max(bp1 - ncb / 2, 0), bp1 + ncb / 2),
                window2=(max(bp2 - ncb / 2, 0), bp2 + ncb / 2),
                support=support))
            candidates.append([chrom, "DUP", str(bp1), str(bp2 - bp1),
                               str(len(support)), None, None, None, None,
                               None, ",".join(render(k)
                                              for k in support)])
        else:
            candidates.append([chrom, "DUP", str(bp1), str(bp2 - bp1),
                               str(len(support)), ".", "./.", ".,.,.",
                               ".", ".",
                               ",".join(render(k) for k in support)])


def resolve_inv(sigs: Sequence, chrom: str, read_count: int,
                max_cluster_bias: int, sv_size: int, max_size: int,
                action: bool, names: Optional[Sequence[str]] = None):
    """INV resolution (resolution_INV, cuteSV_resolveINV.py:6-203).

    ``sigs`` rows: (strand, bp1:int, bp2:int, read_name) sorted by
    (strand, bp1, bp2, name). Clusters break on bp1 gap, bp2 gap, or strand
    change; sub-clusters on sorted-bp2 gaps with running-mean breakpoints.
    """
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    candidates = []
    gt_jobs = []

    def also_break(prev, cur):
        return (cur[2] - prev[2] > max_cluster_bias
                or cur[0] != prev[0])

    clusters = _gap_clusters(sigs, lambda r: r[1], read_count,
                             max_cluster_bias, also_break=also_break)
    for cluster in clusters:
        inv_cluster_emit(cluster, chrom, read_count, max_cluster_bias,
                         sv_size, max_size, action, render, candidates,
                         gt_jobs)
    return candidates, gt_jobs


def inv_cluster_emit(cluster, chrom, read_count, max_cluster_bias, sv_size,
                     max_size, action, render, candidates, gt_jobs):
    """Per-cluster INV sub-clustering + emission
    (generate_semi_inv_cluster, cuteSV_resolveINV.py:101-203)."""
    strand = cluster[0][0]
    if len(_stable_unique([r[3] for r in cluster])) < read_count:
        return
    by_b2 = sorted(cluster, key=lambda r: r[2])
    # running sub-cluster accumulation (cuteSV_resolveINV.py:114-203)
    groups: List[List] = [[by_b2[0]]]
    last_bp = by_b2[0][2]
    for r in by_b2[1:]:
        if r[2] - last_bp > max_cluster_bias:
            groups.append([])
        groups[-1].append(r)
        last_bp = r[2]
    for rows in groups:
        temp_count = len(rows)
        if temp_count < read_count:
            continue
        ids = _stable_unique([r[3] for r in rows])
        max_count_id = len(ids)
        bp1 = round(sum(r[1] for r in rows) / temp_count)
        bp2 = round(sum(r[2] for r in rows) / temp_count)
        inv_len = bp2 - bp1
        if inv_len < sv_size or max_count_id < read_count:
            continue
        if not (inv_len <= max_size or max_size == -1):
            continue
        if action:
            gt_jobs.append(dict(
                window1=(max(bp1 - max_cluster_bias / 2, 0),
                         bp1 + max_cluster_bias / 2),
                window2=(max(bp2 - max_cluster_bias / 2, 0),
                         bp2 + max_cluster_bias / 2),
                support=ids))
            candidates.append([chrom, "INV", str(int(bp1)),
                               str(int(inv_len)), str(max_count_id),
                               None, None, strand, None, None, None,
                               ",".join(render(k) for k in ids)])
        else:
            candidates.append([chrom, "INV", str(int(bp1)),
                               str(int(inv_len)), str(max_count_id),
                               ".", "./.", strand, ".,.,.", ".", ".",
                               ",".join(render(k) for k in ids)])


def _stable_unique(items: Sequence) -> List:
    seen = set()
    out = []
    for x in items:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def _equality_codes(values: Sequence) -> np.ndarray:
    """Equality-preserving integer codes for a homogeneous value list
    (int ranks on the native path, strings on the oracle path)."""
    arr = np.asarray(values)
    _, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64)


def resolve_tra(sigs: Sequence, chr_1: str, read_count: int,
                overlap_size: float, max_cluster_bias: int,
                tables: Optional[Dict[str, ReadTable]],
                chrom_lengths: Dict[str, int], action: bool, gt_round: int,
                names: Optional[Sequence[str]] = None):
    """TRA/BND resolution (resolution_TRA, cuteSV_resolveTRA.py:30-254),
    array-at-a-time.

    ``sigs`` rows: (bnd_type, pos1:int, chr2, pos2:int, read_name) sorted
    by (chr2, bnd_type, pos1, pos2, name). Cluster boundaries (chr2/type
    change or pos1 gap), the p2-sorted sub-cluster segmentation and the
    running sums — including the double-counted first element
    (cuteSV_resolveTRA.py:113-124) — are numpy segment reductions; only
    the per-cluster top-2 selection and candidate emission remain scalar.
    Byte-equal to the reference's per-row loops (differential suite +
    fuzz parity vs resolve_tra_oracle)."""
    n = len(sigs)
    if n == 0:
        return []
    ty = np.fromiter((ord(r[0][0]) for r in sigs), np.int16, n)
    p1 = np.fromiter((r[1] for r in sigs), np.int64, n)
    p2 = np.fromiter((r[3] for r in sigs), np.int64, n)
    c2 = _equality_codes([r[2] for r in sigs])
    rid = _equality_codes([r[4] for r in sigs])

    # ---- cluster ids: break on chr2 change, type change, pos1 gap ----
    new_cl = np.ones(n, bool)
    if n > 1:
        new_cl[1:] = ((c2[1:] != c2[:-1]) | (ty[1:] != ty[:-1])
                      | (p1[1:] - p1[:-1] > max_cluster_bias))
    cid = np.cumsum(new_cl) - 1
    n_clusters = int(cid[-1]) + 1
    csize = np.bincount(cid, minlength=n_clusters)

    # ---- p2-sorted rows within each cluster (stable, like sorted()) --
    order = np.lexsort((np.arange(n), p2, cid))
    p1s, p2s, cids = p1[order], p2[order], cid[order]
    rids = rid[order]

    # ---- distinct support per cluster, then the kept-cluster gate ----
    o3 = np.lexsort((rid, cid))
    cid3, rid3 = cid[o3], rid[o3]
    fp3 = np.r_[True, (cid3[1:] != cid3[:-1]) | (rid3[1:] != rid3[:-1])]
    cl_distinct = np.bincount(cid3[fp3], minlength=n_clusters)

    keep_cl = (csize >= read_count) & (cl_distinct >= read_count)
    sel = np.flatnonzero(keep_cl[cids])
    if sel.size == 0:
        return []
    compact = np.cumsum(keep_cl)[cids[sel]] - 1
    return _tra_emit_clusters(
        sigs, order[sel], p1s[sel], p2s[sel], rids[sel], compact,
        csize[keep_cl], chr_1, read_count, overlap_size, max_cluster_bias,
        tables, chrom_lengths, action, gt_round, names)


def _tra_emit_clusters(sigs: Sequence, order_rows, p1s, p2s, rids, cids,
                       csizes, chr_1: str, read_count: int,
                       overlap_size: float, max_cluster_bias: int,
                       tables, chrom_lengths: Dict[str, int], action: bool,
                       gt_round: int, names: Optional[Sequence[str]] = None,
                       jobs_out: Optional[list] = None) -> List[list]:
    """Emission half of TRA resolution over KEPT clusters only
    (generate_semi_tra_cluster, cuteSV_resolveTRA.py:106-254).

    Rows are cluster-major and p2-sorted (stable) — the order the
    reference walks; ``order_rows`` maps each row back to its ``sigs``
    index, ``cids`` is the compact kept-cluster id per row (ascending),
    ``csizes[c]`` the reference's len(cluster). Shared by the host
    resolver (numpy clustering) and the device resolver (pair-cluster
    kernel). When ``jobs_out`` is a list, genotyping is deferred: the
    candidate carries placeholders and jobs_out collects the batched
    cover-pass inputs (pipeline._tra_cover_pass)."""
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    m = len(order_rows)
    candidates: List[list] = []
    if m == 0:
        return candidates
    seg_new = np.ones(m, bool)
    if m > 1:
        seg_new[1:] = ((cids[1:] != cids[:-1])
                       | (p2s[1:] - p2s[:-1] > max_cluster_bias))
    sid = np.cumsum(seg_new) - 1
    n_segs = int(sid[-1]) + 1
    seg_starts = np.flatnonzero(seg_new)
    sum_p1 = np.add.reduceat(p1s, seg_starts)
    sum_p2 = np.add.reduceat(p2s, seg_starts)
    cnt = np.diff(np.append(seg_starts, m))
    # the reference seeds temp with the first (p2-sorted) element and
    # then iterates it again: double-count it in its (first) segment
    cl_first = np.flatnonzero(np.r_[True, cids[1:] != cids[:-1]])
    first_seg = sid[cl_first]  # one per cluster, unique
    sum_p1[first_seg] += p1s[cl_first]
    sum_p2[first_seg] += p2s[cl_first]
    cnt[first_seg] += 1
    # distinct support per segment
    o2 = np.lexsort((rids, sid))
    sid2, rid2 = sid[o2], rids[o2]
    fp = np.r_[True, (sid2[1:] != sid2[:-1]) | (rid2[1:] != rid2[:-1])]
    seg_distinct = np.bincount(sid2[fp], minlength=n_segs)
    n_clusters = int(cids[-1]) + 1
    seg_hi = np.append(first_seg[1:], n_segs)
    seg_row_hi = np.append(seg_starts[1:], m)

    def emit(seg: int, bnd_type: str, chr_2: str):
        p1_c = int(int(sum_p1[seg]) / int(cnt[seg]))
        p2_c = int(int(sum_p2[seg]) / int(cnt[seg]))
        # A/C mate positions are start-type (0-based) and need +1
        # (cuteSV_resolveTRA.py:137-141)
        mate = "%s:%s" % (chr_2, p2_c + (1 if bnd_type in ("A", "C") else 0))
        alt = _BND_FMT[bnd_type] % mate
        lo = int(seg_starts[seg])
        hi = int(seg_row_hi[seg])
        seg_names = [sigs[int(order_rows[k])][4] for k in range(lo, hi)]
        support = set(seg_names)
        if action and jobs_out is not None:
            dr, gt, gl, gq, qual = "?", "?", "?", "?", "?"
        elif action:
            dv, dr, gt, gl, gq, qual = call_gt_tra(
                tables, chrom_lengths, p1_c, p2_c, chr_1, chr_2, support,
                max_cluster_bias, gt_round)
        else:
            dr, gt, gl, gq, qual = ".", "./.", ".,.,.", ".", "."
        cand = [chr_1, alt, str(p1_c), chr_2, str(p2_c),
                str(len(support)), str(dr), str(gt), str(gl),
                str(gq), str(qual),
                ",".join(render(k) for k in _stable_unique(seg_names))]
        if action and jobs_out is not None:
            jobs_out.append(dict(support=support, pos1=p1_c, pos2=p2_c,
                                 chr2=chr_2, cand=cand))
        candidates.append(cand)

    for c in range(n_clusters):
        s0, s1 = int(first_seg[c]), int(seg_hi[c])
        row0 = int(order_rows[cl_first[c]])
        bnd_type = sigs[row0][0]
        chr_2 = sigs[row0][2]
        ds = seg_distinct[s0:s1]
        top = np.argsort(-ds, kind="stable")  # stable, like list.sort
        d0 = int(ds[top[0]])
        if s1 - s0 > 1 and int(ds[top[1]]) >= 0.5 * read_count:
            if d0 + int(ds[top[1]]) >= int(csizes[c]) * overlap_size:
                emit(s0 + int(top[0]), bnd_type, chr_2)
                emit(s0 + int(top[1]), bnd_type, chr_2)
        else:
            if d0 >= int(csizes[c]) * overlap_size:
                emit(s0 + int(top[0]), bnd_type, chr_2)
    return candidates


def resolve_tra_oracle(sigs: Sequence, chr_1: str, read_count: int,
                       overlap_size: float, max_cluster_bias: int,
                       tables: Optional[Dict[str, ReadTable]],
                       chrom_lengths: Dict[str, int], action: bool,
                       gt_round: int,
                       names: Optional[Sequence[str]] = None):
    """Per-row loop form of :func:`resolve_tra` (the round-1
    implementation), kept as the fuzz-parity oracle and the BND-storm
    bench baseline (tools/bench_tra.py)."""
    candidates = []
    # group by chr2 (stream is sorted by chr2 first)
    i = 0
    n = len(sigs)
    while i < n:
        j = i
        chr_2 = sigs[i][2]
        while j < n and sigs[j][2] == chr_2:
            j += 1
        block = sigs[i:j]
        i = j
        # clusters break on pos1 gap or bnd-type change
        clusters = _gap_clusters(block, lambda r: r[1], read_count,
                                 max_cluster_bias,
                                 also_break=lambda p, c: c[0] != p[0])
        for cluster in clusters:
            _generate_tra_cluster(cluster, chr_1, chr_2, read_count,
                                  overlap_size, max_cluster_bias,
                                  candidates, tables, chrom_lengths, action,
                                  gt_round, names)
    return candidates


_BND_FMT = {"A": "N[%s[", "B": "N]%s]", "C": "[%s[N", "D": "]%s]N"}


def _generate_tra_cluster(cluster, chr_1, chr_2, read_count, overlap_size,
                          max_cluster_bias, candidates, tables,
                          chrom_lengths, action, gt_round, names=None):
    """generate_semi_tra_cluster (cuteSV_resolveTRA.py:106-254)."""
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    bnd_type = cluster[0][0]
    by_p2 = sorted(cluster, key=lambda r: r[3])
    read_tag = set()
    # running-sum sub-clusters; the first element is seeded AND iterated,
    # double-counting it exactly as the reference does
    # (cuteSV_resolveTRA.py:113-124)
    temp = [[by_p2[0][1], by_p2[0][3], [by_p2[0][4]]]]
    last = by_p2[0][3]
    for r in by_p2:
        if r[3] - last > max_cluster_bias:
            temp.append([r[1], r[3], [r[4]]])
        else:
            temp[-1][0] += r[1]
            temp[-1][1] += r[3]
            temp[-1][2].append(r[4])
        last = r[3]
        read_tag.add(r[4])
    if len(read_tag) < read_count:
        return
    temp.sort(key=lambda t: -len(set(t[2])))

    def emit(entry):
        p1 = int(entry[0] / len(entry[2]))
        p2 = int(entry[1] / len(entry[2]))
        # A/C mate positions are start-type (0-based) and need +1
        # (cuteSV_resolveTRA.py:137-141)
        mate = "%s:%s" % (chr_2, p2 + (1 if bnd_type in ("A", "C") else 0))
        alt = _BND_FMT[bnd_type] % mate
        support = set(entry[2])
        if action:
            dv, dr, gt, gl, gq, qual = call_gt_tra(
                tables, chrom_lengths, p1, p2, chr_1, chr_2, support,
                max_cluster_bias, gt_round)
        else:
            dr, gt, gl, gq, qual = ".", "./.", ".,.,.", ".", "."
        candidates.append([chr_1, alt, str(p1), chr_2, str(p2),
                           str(len(support)), str(dr), str(gt), str(gl),
                           str(gq), str(qual),
                           ",".join(render(k)
                                    for k in _stable_unique(entry[2]))])

    if len(temp) > 1 and len(set(temp[1][2])) >= 0.5 * read_count:
        if (len(set(temp[0][2])) + len(set(temp[1][2]))
                >= len(cluster) * overlap_size):
            emit(temp[0])
            emit(temp[1])
    else:
        if len(set(temp[0][2])) >= len(cluster) * overlap_size:
            emit(temp[0])
