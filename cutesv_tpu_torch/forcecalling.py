"""Force calling / regenotyping of a given VCF (-Ivcf).

Reproduces the reference's force-calling machinery
(cuteSV_forcecalling.py:41-678 + generate_pvcf cuteSV_genotype.py:472-668)
— which its CLI disables (cuteSV:999-1000) — as a working feature: for each
record of an input VCF, matching signatures are collected from the decoded
signature store by windowed binary search (with same-read sig-pair/triple
merging and the KMeans(2) bimodal split for multi-allelic sites), read
support is re-counted, and genotypes re-assigned.

Text VCF parsing is self-contained (no pysam): positions are the 1-based
POS column, matching pysam.VariantFile's record.pos that the reference
feeds into its (0-based) signature windows.

The port of ``cutesv_tpu/forcecalling.py``. It runs no device program:
the input is decoded plainly (no streaming dispatch) and the read counts
are host numpy, as in the JAX package. The one other difference is the
bimodal split, whose KMeans(2) is written out in numpy
(:func:`_kmeans_split`) so that the port needs no scikit-learn.
"""
from __future__ import annotations

import logging
import math
import os
import re
import time
from typing import Dict, List

import numpy as np

from cutesv_tpu_torch.genotype import cal_CIPOS, cover_counts, gl_table
from cutesv_tpu_torch.utils.torchsetup import resolve_device
from cutesv_tpu_torch.vcf import vcf_header

log = logging.getLogger("cutesv_tpu_torch")

_BND_MATE_RE = re.compile(r"[\[\]]([^\[\]]+)[\[\]]")


# ---------------------------------------------------------------------------
# input VCF parsing (parse_record, cuteSV_forcecalling.py:11-101)
# ---------------------------------------------------------------------------

def _parse_svtype(sv_type: str) -> str:
    for t in ("DEL", "INS", "INV", "DUP", "TRA", "BND"):
        if t in sv_type:
            return t
    return "NA"


def _first_int(value) -> int:
    if value is None:
        return 0
    if isinstance(value, str):
        return int(value.split(",")[0])
    return int(value)


def parse_vcf_records(path: str):
    """Yield normalized rows (sv_type, chrom1, chrom2, start, end, svlen,
    strand, svid, ref, alts) from a text VCF."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            chrom, pos_s, svid, ref, alt = f[0], f[1], f[2], f[3], f[4]
            info = {}
            for kv in f[7].split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    info[k] = v
                else:
                    info[kv] = True
            if "SVTYPE" not in info:
                continue
            sv_type = _parse_svtype(str(info["SVTYPE"]))
            start = int(pos_s)
            chrom2 = chrom
            end = None
            alts = alt.split(",")[0]
            if "SVLEN" in info:
                svlen = abs(_first_int(info["SVLEN"]))
            elif alts[:1] != "<" and sv_type not in ("TRA", "BND"):
                svlen = abs(len(alts) - len(ref))
            else:
                svlen = 0
            if sv_type in ("TRA", "BND"):
                # mate coordinates from the bracket-delimited ALT segment.
                # (Deviation: the reference slices assuming an N-leading
                # ALT and silently mis-parses base-leading breakends —
                # including its own emitted ones, cuteSV_forcecalling.py:
                # 57-77; extracting between the brackets handles both.)
                try:
                    mate = _BND_MATE_RE.search(alts)
                    if mate and ":" in mate.group(1):
                        chrom2 = mate.group(1).split(":")[0]
                        end = int(mate.group(1).split(":")[1])
                except Exception:
                    pass
            if end is None:
                if "END" in info:
                    end = _first_int(info["END"])
                else:
                    end = start + svlen
            if "CHR2" in info:
                chrom2 = str(info["CHR2"])
            strand = "."
            if "STRAND" in info:
                strand = str(info["STRAND"]).split(",")[0]
            elif "STRANDS" in info:
                strand = str(info["STRANDS"]).split(",")[0]
            if "SEQ" in info:
                if info["SVTYPE"] == "INS" and alts == "<INS>":
                    alts = str(info["SEQ"])
                if info["SVTYPE"] == "DEL" and alts == "<DEL>":
                    ref = str(info["SEQ"])
            yield (sv_type, chrom, chrom2, start, end, svlen, strand, svid,
                   ref, alts)


# ---------------------------------------------------------------------------
# signature matching (find_in_list / find_in_indel_list,
# cuteSV_forcecalling.py:160-495)
# ---------------------------------------------------------------------------

def _check_same_variant(sv_type, end1, end2, bias) -> bool:
    if sv_type in ("INS", "DEL"):
        return 0.7 < min(end1, end2) / max(end1, end2) <= 1
    return abs(end1 - end2) < bias


def _bisect_pos(var_list, pos):
    left, right = 0, len(var_list) - 1
    while left < right:
        mid = (left + right) >> 1
        if var_list[mid][1] < pos:
            left = mid + 1
        else:
            right = mid
    return right


def find_in_list(sv_type, var_list, bias, pos, sv_end):
    """Windowed support search for DUP/INV/TRA rows [chrom, p1, p2, read]."""
    if len(var_list) == 0:
        return [], pos, pos
    right = _bisect_pos(var_list, pos)
    read_ids = set()
    search_start = search_end = -1
    if right > 0 and pos - var_list[right - 1][1] <= bias:
        for i in range(right - 1, -1, -1):
            if _check_same_variant(sv_type, var_list[i][2], sv_end, bias):
                read_ids.add(var_list[i][3])
                search_start = var_list[i][1]
            if i > 0 and (var_list[i][1] - var_list[i - 1][1] > bias
                          or pos - var_list[i - 1][1] > bias):
                break
    if var_list[right][1] - pos <= bias:
        for i in range(right, len(var_list)):
            if _check_same_variant(sv_type, var_list[i][2], sv_end, bias):
                read_ids.add(var_list[i][3])
                search_end = var_list[i][1]
            if i < len(var_list) - 1 and (
                    var_list[i + 1][1] - var_list[i][1] > bias
                    or var_list[i + 1][1] - pos > bias):
                break
    if search_start == -1:
        search_start = pos
    if search_end == -1:
        search_end = pos
    if search_start > search_end:
        search_start, search_end = search_end, search_start
    if search_start == search_end:
        search_end += 1
    return list(read_ids), search_start, search_end


_KMEANS_MAX_ITER = 300
_KMEANS_TOL = 1e-4


def _kmeans_assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest of two centers by ||c||^2 - 2xc (the ||x||^2 term does not
    change the argmin); a tie goes to label 0."""
    d = (centers * centers)[None, :] + (-2.0) * (x[:, None]
                                                 * centers[None, :])
    return (d[:, 1] < d[:, 0]).astype(np.int32)


def _kmeans_split(lens: List[int]):
    """1-D 2-means with the reference's index-valued init centers
    (cuteSV_forcecalling.py:326-331). Returns labels array.

    The reference fits scikit-learn's ``KMeans(n_clusters=2, init=<those
    centers>, n_init=1)``; this is that fit's Lloyd iteration in numpy,
    step for step, so that the labels are the same: data and centers
    centered on the data mean, squared distances as ||c||^2 - 2xc, a
    sequential sum per cluster, an empty cluster moved to the point
    farthest from its center, averaging by the reciprocal weight, stop
    on unchanged labels or a total squared center shift within 1e-4
    times the data variance, and a last assignment to the final centers
    unless the labels had stopped changing."""
    data = np.array(lens, dtype=float).reshape(-1, 1)
    tol = np.mean(np.var(data, axis=0)) * _KMEANS_TOL
    init = np.array([int(len(lens) / 4), int(len(lens) / 4 * 3)],
                    dtype=float).reshape(-1, 1)
    mean = data.mean(axis=0)
    x = (data - mean)[:, 0]
    centers = (init - mean)[:, 0]
    labels_old = np.full(len(x), -1, np.int32)
    strict = False
    for _ in range(_KMEANS_MAX_ITER):
        labels = _kmeans_assign(x, centers)
        weight = np.array([np.sum(labels == 0), np.sum(labels == 1)],
                          dtype=float)
        sums = np.array([np.add.accumulate(x[labels == j])[-1]
                         if weight[j] else 0.0 for j in (0, 1)])
        empty = np.flatnonzero(weight == 0)
        if len(empty):
            dist = (x - centers[labels]) ** 2
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            if np.max(dist) != 0:
                for new_id, far_idx in zip(empty, far):
                    old_id = labels[far_idx]
                    sums[old_id] -= x[far_idx]
                    sums[new_id] = x[far_idx]
                    weight[new_id] = 1.0
                    weight[old_id] -= 1.0
        biggest = int(np.argmax(weight))
        new = sums.copy()
        for j in (0, 1):
            if weight[j] > 0:
                new[j] = new[j] * (1.0 / weight[j])
            else:
                new[j] = new[biggest]
        shift = np.sqrt((new - centers) * (new - centers))
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _kmeans_assign(x, centers)
    return labels


def find_in_indel_list(sv_type, var_list, bias, pos, sv_end,
                       threshold_gloab, multi_allele):
    """INS/DEL support search with same-read merging, running-mean allele
    clustering, target-length allele selection and optional bimodal split.
    Rows: [chrom, start, len, read_id(, seq_tag)]."""
    if len(var_list) == 0:
        return [], pos, pos, ".,.", ".,."
    right = _bisect_pos(var_list, pos)
    candidates = []
    if right > 0 and pos - var_list[right - 1][1] <= bias:
        for i in range(right - 1, -1, -1):
            candidates.append(var_list[i])
            if i > 0 and (var_list[i][1] - var_list[i - 1][1] > bias
                          or pos - var_list[i - 1][1] > 2 * bias):
                break
    if var_list[right][1] - pos <= bias:
        for i in range(right, len(var_list)):
            candidates.append(var_list[i])
            if i < len(var_list) - 1 and (
                    var_list[i + 1][1] - var_list[i][1] > bias
                    or var_list[i + 1][1] - pos > 2 * bias):
                break
    if len(candidates) == 0:
        return [], pos, pos, ".,.", ".,."
    read_tag: Dict = {}
    for element in candidates:
        read_tag.setdefault(element[3], []).append(element)

    # same-read pair/triple merges (cuteSV_forcecalling.py:243-271)
    rows = []
    for read_id in read_tag:
        group = read_tag[read_id]
        for i in range(len(group)):
            rows.append(group[i])
            if i + 1 < len(group):
                j = i + 1
                merged = [group[i][0],
                          int((group[i][1] + group[j][1]) / 2),
                          group[i][2] + group[j][2], group[i][3]]
                if sv_type != "DEL":
                    merged.append(group[i][4])
                rows.append(merged)
                if j + 1 < len(group):
                    k = j + 1
                    merged = [group[i][0],
                              int((group[i][1] + group[j][1]
                                   + group[k][1]) / 3),
                              group[i][2] + group[j][2] + group[k][2],
                              group[i][3]]
                    if sv_type != "DEL":
                        merged.append(group[i][4])
                    rows.append(merged)

    rows = sorted(rows, key=lambda x: x[2])
    # running-mean allele clustering (cuteSV_forcecalling.py:278-298)
    last_len = rows[0][2]
    cur_bias = last_len * threshold_gloab
    has_seq = sv_type == "INS"
    alleles = [[[rows[0][1]], [rows[0][2]], [], [rows[0][3]]]
               + ([[rows[0][4]]] if has_seq else [])]
    for r in rows[1:]:
        if r[2] - last_len > cur_bias:
            alleles[-1][2].append(len(alleles[-1][0]))
            alleles.append([[], [], [], []] + ([[]] if has_seq else []))
        alleles[-1][0].append(r[1])
        alleles[-1][1].append(r[2])
        alleles[-1][3].append(r[3])
        if has_seq:
            alleles[-1][4].append(r[4])
        last_len = (last_len * (len(alleles[-1][0]) - 1)
                    + r[2]) / len(alleles[-1][0])
        cur_bias = last_len * threshold_gloab
    alleles[-1][2].append(len(alleles[-1][0]))

    # select allele nearest the target length with >0.7 ratio
    allele_idx = -1
    nearest_gap = 0x3f3f3f3f
    for i, allele in enumerate(alleles):
        signal_len = np.mean(allele[1])
        if min(signal_len, sv_end) / max(signal_len, sv_end) > 0.7:
            if abs(signal_len - sv_end) < nearest_gap:
                allele_idx = i
                nearest_gap = abs(signal_len - sv_end)
    if allele_idx == -1:
        # reference quirk preserved: filters allele_collect[-1] (index -1)
        lower, upper = sv_end * 0.7, sv_end / 0.7
        final = [[], [], [], []]
        for i in range(len(alleles[allele_idx][0])):
            if lower <= alleles[allele_idx][1][i] <= upper:
                final[0].append(alleles[allele_idx][0][i])
                final[1].append(alleles[allele_idx][1][i])
                final[3].append(alleles[allele_idx][3][i])
    else:
        final = alleles[allele_idx]

    if multi_allele:
        data = final[1]
        if len(data) > 1 and data[0] != data[-1]:
            labels = _kmeans_split(data)
            cate = 0
            for i in range(len(labels) - 1):
                if labels[i] != labels[i + 1]:
                    cate = i + 1
                    break
            if sv_type == "DEL":
                delta0 = math.ceil(cate / 8) if cate >= 3 else 0
                delta1 = (math.ceil((len(labels) - cate + 1) / 8)
                          if len(labels) - cate >= 3 else 0)
            else:
                delta0 = math.ceil(cate / 8) if cate >= 5 else 0
                delta1 = (math.ceil((len(labels) - cate) / 8)
                          if len(labels) - cate >= 5 else 0)
            min_alleles = [data[delta0], data[cate + delta1]]
            max_alleles = [data[cate - delta0 - 1],
                           data[len(labels) - delta1 - 1]]
            chosen = [[], [], [], []]
            if abs(max_alleles[0] - max_alleles[1]) >= max(
                    3 * max(max_alleles[0] - min_alleles[0],
                            max_alleles[1] - min_alleles[1]), 6):
                allele0 = np.mean(data[delta0:(cate - delta0)])
                allele1 = (np.mean(data[cate + delta1:]) if delta1 == 0
                           else np.mean(data[cate + delta1:-delta1]))
                r0 = min(allele0, sv_end) / max(allele0, sv_end)
                r1 = min(allele1, sv_end) / max(allele1, sv_end)
                if r0 >= r1:
                    if (min(min_alleles[0], sv_end)
                            / max(min_alleles[0], sv_end) > 0.9
                            and min(max_alleles[0], sv_end)
                            / max(max_alleles[0], sv_end) > 0.9):
                        if cate >= max(3, len(labels) / 5):
                            for i in range(cate):
                                for j in (0, 1, 3):
                                    chosen[j].append(final[j][i])
                elif (min(min_alleles[1], sv_end)
                        / max(min_alleles[1], sv_end) > 0.9
                        and min(max_alleles[1], sv_end)
                        / max(max_alleles[1], sv_end) > 0.9):
                    if len(labels) - cate >= max(3, len(labels) / 5):
                        for i in range(cate, len(labels)):
                            for j in (0, 1, 3):
                                chosen[j].append(final[j][i])
            if len(chosen[0]) > 0:
                final = chosen

    if len(final[3]) > 0:
        read_id_set = set(final[3])
        cipos = cal_CIPOS(np.std(final[0]), len(final[0]))
        cilen = cal_CIPOS(np.std(final[1]), len(final[1]))
        search_start = min(final[0])
        search_end = max(final[0])
    else:
        read_id_set = set()
        cipos = cilen = "-0,0"
        search_start = search_end = pos
    return list(read_id_set), search_start, search_end, cipos, cilen


# ---------------------------------------------------------------------------
# per-chromosome genotyping driver (solve_fc, cuteSV_forcecalling.py:575-678)
# ---------------------------------------------------------------------------

def _sig_rows_fc(store):
    """Project the sig store onto the FC matching layout.

    Read identities stay store keys (rank ints on the native path) so
    support membership tests line up with census keys; rendering to
    strings happens once at emission. NOTE: the INV list keeps the
    store's strand-major sort (chr, strand, b1, b2) even though
    find_in_list binary-searches it by position — faithful to the
    reference, which re-sorts only TRA (cuteSV_forcecalling.py:157) and
    inherits the same potential miss; re-sorting by position here would
    silently break byte-parity."""
    sv_dict: Dict[str, dict] = {"DEL": {}, "INS": {}, "DUP": {}, "INV": {},
                                "TRA": {}}
    for chrom, stream in store.sigs["DEL"].items():
        if hasattr(stream, "pos"):
            rows = [[chrom, int(p), int(l), int(r)] for p, l, r in
                    zip(stream.pos, stream.length, stream.rid)]
        else:
            rows = [[chrom, r[0], r[1], r[2]] for r in stream]
        sv_dict["DEL"][chrom] = rows
    for chrom, stream in store.sigs["INS"].items():
        if hasattr(stream, "pos"):
            rows = [[chrom, int(p), int(l), int(r), "<INS>"] for p, l, r in
                    zip(stream.pos, stream.length, stream.rid)]
        else:
            rows = [[chrom, r[0], r[1], r[2], "<INS>"] for r in stream]
        sv_dict["INS"][chrom] = rows
    for chrom, rows in store.sigs["DUP"].items():
        sv_dict["DUP"][chrom] = [[chrom, r[0], r[1], r[2]] for r in rows]
    for chrom, rows in store.sigs["INV"].items():
        sv_dict["INV"][chrom] = [[chrom, r[1], r[2], r[3]] for r in rows]
    for chrom, rows in store.sigs["TRA"].items():
        per2: Dict[str, list] = {}
        for ty, p1, chr2, p2, rid in rows:
            per2.setdefault(chr2, []).append([chr2, p1, p2, rid])
        for chr2 in per2:
            per2[chr2].sort(key=lambda x: x[1])
        sv_dict["TRA"][chrom] = per2
    return sv_dict


def _overlap_cover_counts(windows, census):
    """Per window: (#distinct primary covering, #distinct primary
    overlapping) — the cover/overlap sets of overlap_cover
    (cuteSV_genotype.py:95-159) as counts + membership arrays."""
    prim = census["is_primary"] == 1
    p_start = census["start"][prim]
    p_end = census["end"][prim]
    covers = cover_counts(windows, p_start, p_end)
    s_sorted = np.sort(p_start)
    e_sorted = np.sort(p_end)
    n = len(p_start)
    overlaps = []
    for s, e in windows:
        # overlap == start < e and end > s
        n_start_ge_e = n - np.searchsorted(s_sorted, e, "left")
        n_end_le_s = np.searchsorted(e_sorted, s, "right")
        overlaps.append(n - n_start_ge_e - n_end_le_s)
    return covers, np.array(overlaps, np.int64)


def force_call(cfg, argv, store=None, device=None) -> dict:
    """Run force calling; returns the per-chromosome rows, the header
    references, the record count, ``decoder`` (which decoder ran, or
    "store"), the decode's ``breakdown`` (``decode_breakdown``; empty for
    an injected store) and the decode and call seconds. ``store`` injects a
    prebuilt SigStore (differential tests); decoded from cfg.input on
    ``device`` (CUDA unless the caller asks for the CPU) otherwise."""
    t0 = time.time()
    if store is None:
        from cutesv_tpu_torch.pipeline import decode_bam

        store, _, n_records = decode_bam(cfg, resolve_device(device))
        breakdown = store.decode_breakdown
        decoder = breakdown["decoder"]
    else:
        n_records = -1  # not decoded here (same sentinel as --resume)
        breakdown = {}
        decoder = "store"
    references = list(store.chrom_lengths.items())
    t1 = time.time()
    names = store.names
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    sv_dict = _sig_rows_fc(store)

    bias_dict = {"INS": cfg.max_cluster_bias_INS,
                 "DEL": cfg.max_cluster_bias_DEL,
                 "DUP": cfg.max_cluster_bias_DUP,
                 "INV": cfg.max_cluster_bias_INV,
                 "TRA": cfg.max_cluster_bias_TRA}
    gloab_dict = {"INS": cfg.diff_ratio_merging_INS,
                  "DEL": cfg.diff_ratio_merging_DEL}

    svs_by_chrom: Dict[str, list] = {}
    pos_counts: Dict[str, Dict[int, int]] = {}
    for row in parse_vcf_records(cfg.Ivcf):
        (sv_type, chrom, chrom2, start, end, svlen, strand, svid, ref,
         alts) = row
        if sv_type not in ("DEL", "INS", "DUP", "INV", "TRA", "BND"):
            continue
        svs_by_chrom.setdefault(chrom, []).append(
            [sv_type, chrom2, start, end, svlen, svid, ref, alts, strand,
             chrom])
        pos_counts.setdefault(chrom, {})
        pos_counts[chrom][start] = pos_counts[chrom].get(start, 0) + 1
    svs_multi = {c: {p for p, k in d.items() if k == 2}
                 for c, d in pos_counts.items()}

    table = gl_table()
    result: Dict[str, list] = {}
    for chrom, records in svs_by_chrom.items():
        windows = []
        read_id_lists = []
        svtypes = []
        cis = []
        for rec in records:
            sv_type, sv_chr2, sv_start, sv_end, sv_len = (
                rec[0], rec[1], rec[2], rec[3], rec[4])
            if sv_type in ("TRA", "BND"):
                search = sv_dict["TRA"].get(chrom, {}).get(sv_chr2, [])
            else:
                search = sv_dict.get(sv_type, {}).get(chrom, [])
            if sv_type in ("INS", "DEL"):
                multi = sv_start in svs_multi.get(chrom, set())
                read_ids, ss, se, cipos, cilen = find_in_indel_list(
                    sv_type, search, bias_dict[sv_type], sv_start, sv_len,
                    gloab_dict[sv_type], multi)
            else:
                sigs_bias = bias_dict["TRA" if sv_type == "BND" else sv_type]
                if sv_len / 2 > sigs_bias:
                    sigs_bias = sv_len / 2
                read_ids, ss, se = find_in_list(sv_type, search, sigs_bias,
                                                sv_start, sv_end)
                cipos = cilen = "."
            mcb = max(abs(sv_start - ss), abs(sv_start - se))
            mcb = max(cfg.read_range, mcb)
            if sv_type in ("INS", "TRA", "BND"):
                windows.append((max(sv_start - mcb, 0), sv_start + mcb))
            elif sv_type == "DEL":
                if cfg.read_range < 500:
                    windows.append((max(sv_start - mcb, 0), sv_start + mcb))
                else:
                    windows.append((max(sv_start + abs(sv_len) / 5, 0),
                                    sv_start + abs(sv_len)
                                    - abs(sv_len) / 5))
            elif sv_type == "INV":
                windows.append((ss, se + 1))
            else:  # DUP
                windows.append((sv_start, sv_end))
            read_id_lists.append(read_ids)
            svtypes.append(sv_type)
            cis.append((cipos, cilen))

        census = store.census.get(chrom)
        if census is not None and len(records):
            covers, overlaps = _overlap_cover_counts(windows, census)
            # membership of support reads in cover/overlap sets
            prim = census["is_primary"] == 1
            p_start = census["start"][prim]
            p_end = census["end"][prim]
            if names is not None:
                key_iv = {}
                key_col = census["name"][prim]
                for k in range(len(p_start)):
                    key_iv[int(key_col[k])] = (p_start[k], p_end[k])
            else:
                key_col = [census["name"][i] for i in np.nonzero(prim)[0]]
                key_iv = {n: (p_start[k], p_end[k])
                          for k, n in enumerate(key_col)}
        else:
            covers = np.zeros(len(records), np.int64)
            overlaps = np.zeros(len(records), np.int64)
            key_iv = {}

        out_rows = []
        for i, rec in enumerate(records):
            support = read_id_lists[i]
            s, e = windows[i]
            inter = 0
            for key in set(support):
                iv = key_iv.get(key)
                if iv is None:
                    continue
                if svtypes[i] == "DEL":
                    if iv[0] < e and iv[1] > s:
                        inter += 1
                else:
                    if iv[0] <= s and iv[1] >= e:
                        inter += 1
            base = overlaps[i] if svtypes[i] == "DEL" else covers[i]
            dr = int(base) - inter
            dv = len(set(support))
            gt, pl, gq, qual = table.lookup(dr, dv)
            assign = [dv, dr, gt, pl, gq, qual]
            rname = ",".join(render(k) for k in support)
            if rname == "":
                rname = "Unknown"
            if rec[7] in ("<TRA>", "<BND>"):
                seq = "%s:%s" % (rec[1], rec[3])
            else:
                seq = "<%s>" % rec[0]
            out_rows.append([rec[9], rec[2], gt, rec[0], rec[3],
                             cis[i][0], cis[i][1], assign, rname, rec[5],
                             rec[6], rec[7], rec[8], seq, rec[4]])
        result[chrom] = out_rows
        log.info("Finished calling %s." % chrom)
    return dict(result=result, references=references,
                n_records=n_records, decoder=decoder, breakdown=breakdown,
                decode_s=t1 - t0, call_s=time.time() - t1)


# ---------------------------------------------------------------------------
# output (generate_pvcf, cuteSV_genotype.py:472-668)
# ---------------------------------------------------------------------------

def generate_pvcf_lines(cfg, rows, ref_chrom: str) -> List[str]:
    lines = []
    for i in rows:
        if not i:
            continue
        qual = i[7][5]
        filt = ("PASS" if qual in (".", None)
                else ("PASS" if float(qual) >= 2.5 else "q5"))
        precision = "IMPRECISE" if i[2] == "0/0" else "PRECISE"
        rn = ";RNAMES=" + i[8] if cfg.report_readid else ""
        try:
            af = ";AF=" + str(round(i[7][0] / (i[7][0] + i[7][1]), 4))
        except Exception:
            af = ";AF=."
        fmt = "GT:DR:DV:PL:GQ"
        sample = "%s:%s:%s:%s:%s" % (i[2], i[7][1], i[7][0], i[7][3],
                                     i[7][4])
        if i[3] == "INS":
            if abs(i[14]) > cfg.max_size and cfg.max_size != -1:
                continue
            ref = str(ref_chrom[max(i[1] - 1, 0)])
            alt = i[11]
            info = ("%s;SVTYPE=INS;SVLEN=%s;END=%s;CIPOS=%s;CILEN=%s;RE=%s"
                    "%s%s" % (precision, i[14], i[1], i[5], i[6], i[7][0],
                              rn, af))
        elif i[3] == "DEL":
            if abs(i[14]) > cfg.max_size and cfg.max_size != -1:
                continue
            ref, alt = i[10], i[11]
            info = ("%s;SVTYPE=DEL;SVLEN=%s;END=%s;CIPOS=%s;CILEN=%s;RE=%s"
                    "%s;STRAND=+-%s" % (precision, -abs(i[14]),
                                        i[1] + abs(i[14]), i[5], i[6],
                                        i[7][0], rn, af))
        elif i[3] == "DUP":
            if abs(i[4] - i[1]) > cfg.max_size and cfg.max_size != -1:
                continue
            ref, alt = i[10], i[11]
            info = ("%s;SVTYPE=DUP;SVLEN=%s;END=%s;RE=%s%s;STRAND=-+%s"
                    % (precision, abs(i[4] - i[1]), i[4], i[7][0], rn, af))
        elif i[3] == "INV":
            if abs(i[4] - i[1]) > cfg.max_size and cfg.max_size != -1:
                continue
            ref, alt = i[10], i[11]
            info = "%s;SVTYPE=INV;SVLEN=%s;END=%s;RE=%s%s" % (
                precision, i[4] - i[1], i[4], i[7][0], rn)
            if i[12] != ".":
                info += ";STRAND=" + i[12]
            info += af
        else:  # BND
            ref, alt = i[10], i[11]
            info = "%s;SVTYPE=%s;RE=%s%s" % (precision, i[3], i[7][0], rn)
            if i[14] != 0:
                info += ";SVLEN=%d" % i[14]
            info += af
        lines.append("%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\n" % (
            i[0], i[1], i[9], ref, alt, qual, filt, info, fmt, sample))
    return lines


def run_force_calling(cfg, argv, device=None) -> dict:
    """Force-call ``cfg.Ivcf`` against ``cfg.input`` and write the VCF;
    the decode runs on ``device`` (CUDA unless the caller asks for the
    CPU). Returns the decode's breakdown (``decode_breakdown``) with the
    site count, ``decoder`` and the decode, call and emit seconds. Under
    ``--distributed`` each process makes the same whole-file force call,
    as in the JAX package: no process group is joined, so the decode is
    plain and unsharded."""
    from cutesv_tpu_torch.io.fasta import FastaFile

    if not os.path.isfile(cfg.Ivcf):
        raise FileNotFoundError("[Errno 2] No such file: '%s'" % cfg.Ivcf)
    if not os.path.isfile(cfg.reference):
        raise FileNotFoundError(
            "[Errno 2] No such file: '%s'" % cfg.reference)
    out = force_call(cfg, argv, device=device)
    t2 = time.time()
    fasta = FastaFile(cfg.reference)
    with open(cfg.output, "w") as fh:
        fh.write(vcf_header(out["references"], cfg.sample, argv))
        for chrom in sorted(out["result"]):
            if chrom not in fasta:
                raise KeyError(
                    "No corresponding contig in reference with %s." % chrom)
            for line in generate_pvcf_lines(cfg, out["result"][chrom],
                                            fasta.fetch_lazy(chrom)):
                fh.write(line)
    sites = sum(len(v) for v in out["result"].values())
    log.info("Force calling finished: %d sites" % sites)
    return dict(out["breakdown"], sites=sites, decoder=out["decoder"],
                decode_s=out["decode_s"], call_s=out["call_s"],
                emit_s=time.time() - t2, n_records=out["n_records"])
