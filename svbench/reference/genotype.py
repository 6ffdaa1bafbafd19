"""Genotype-likelihood engine of the plain reference: a copy of
``cutesv_tpu_torch/genotype.py``, kept here so that the reference shares
no code with the program under test.

Reproduces cal_GL / overlap_cover / assign_gt / count_coverage semantics
(cuteSV_genotype.py:10-190) with an array-first design:

* ``cal_GL`` maps rescaled integer read counts (DR, DV) with DR+DV <= 100
  onto closed-form likelihoods. Since the post-rescale domain is a tiny
  integer grid, we precompute the exact scalar results once into a lookup
  table (``GLTable``); the device path then genotypes thousands of sites with
  one gather instead of per-site transcendentals. Bit-identical to the
  reference by construction.
* ``overlap_cover`` is re-posed as counting, per SV window [s, e):
      cover(sv)   = #{primary reads: start <= s and end >= e}
      (the reference's sweep-line set algebra reduces to exactly this;
       see the endpoint-ordering analysis in tests/test_genotype.py)
  DR = cover - |{support reads whose primary alignment covers the window}|.
* TRA genotyping replays the reference's BAM re-scan (count_coverage,
  cuteSV_genotype.py:72-93) from the in-memory read census instead of
  re-fetching, preserving the iteration-order-dependent early-exit behavior.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

ERR = 0.1
PRIOR = 1.0 / 3.0
GENOTYPES = ("0/0", "0/1", "1/1")
MAX_READS = 100


def rescale_read_counts(c0: int, c1: int, max_allowed: int = MAX_READS):
    """cuteSV_genotype.py:25-31 — cap total reads at 100."""
    total = c0 + c1
    if total > max_allowed:
        c0 = int(max_allowed * float(c0 / total))
        c1 = max_allowed - c0
    return c0, c1


def _cal_gl_exact(c0: int, c1: int):
    """Scalar closed-form genotype likelihood for rescaled counts
    (cuteSV_genotype.py:33-56). Returns (GT, PL-string, GQ, QUAL)."""
    if c0 == 3 and c1 == 1:
        return "0/1", "3,3,24", 3, 3.0
    if c0 == 6 and c1 == 2:
        return "0/1", "3,3,45", 3, 3.0
    c0, c1 = rescale_read_counts(c0, c1)
    gl00 = np.float64(pow(1 - ERR, c0) * pow(ERR, c1) * (1 - PRIOR) / 2)
    gl11 = np.float64(pow(ERR, c0) * pow(1 - ERR, c1) * (1 - PRIOR) / 2)
    gl01 = np.float64(pow(0.5, c0 + c1) * PRIOR)
    logs = [math.log10(gl00), math.log10(gl01), math.log10(gl11)]
    m = max(logs)
    lse = m + math.log10(sum(pow(10.0, x - m) for x in logs))
    prob = list(np.minimum(np.array(logs) - lse, 0.0))
    gl_p = [pow(10, x) for x in prob]
    pl = [int(np.around(-10 * math.log10(x))) for x in gl_p]
    gq = [int(-10 * math.log10(gl_p[1] + gl_p[2])),
          int(-10 * math.log10(gl_p[0] + gl_p[2])),
          int(-10 * math.log10(gl_p[0] + gl_p[1]))]
    qual = abs(np.around(-10 * math.log10(gl_p[0]), 1))
    gt = GENOTYPES[prob.index(max(prob))]
    return gt, "%d,%d,%d" % tuple(pl), max(gq), qual


class GLTable:
    """Precomputed cal_GL over the full rescaled integer grid.

    After rescale, (c0, c1) satisfies 0 <= c0, c1 and c0 + c1 <= 100; plus
    the two special-cased pairs. The table indexes raw (pre-rescale) counts
    after applying the same rescale, so lookup(DR, DV) == cal_GL(DR, DV).
    """

    def __init__(self):
        self.gt: Dict[Tuple[int, int], Tuple[str, str, int, float]] = {}
        for c0 in range(MAX_READS + 1):
            for c1 in range(MAX_READS + 1 - c0):
                self.gt[(c0, c1)] = _cal_gl_exact(c0, c1)
        # special-cased pairs are inside the grid already ((3,1),(6,2))

    def lookup(self, c0: int, c1: int):
        key = rescale_read_counts(c0, c1)
        if (c0, c1) in ((3, 1), (6, 2)):
            return self.gt[(c0, c1)]
        return self.gt[key]


_GL_TABLE: GLTable | None = None


def gl_table() -> GLTable:
    global _GL_TABLE
    if _GL_TABLE is None:
        _GL_TABLE = GLTable()
    return _GL_TABLE


# ---------------------------------------------------------------------------
# interval cover counting (replaces the sweep-line of overlap_cover)
# ---------------------------------------------------------------------------

def cover_counts(sv_windows: Sequence[Tuple[float, float]],
                 read_starts: np.ndarray, read_ends: np.ndarray) -> np.ndarray:
    """#{reads: start <= s and end >= e} per SV window [s, e).

    Host implementation, vectorized via the set identity

        cover = #{start <= s} - #{end < e} + #{start > s and end < e}

    (|A \\ B| = |A| - |B| + |A^c ∩ B|): two searchsorteds over the
    sorted starts/ends, plus the third term, which only reads SHORTER
    than the window can contribute (a read strictly inside (s, e)) —
    zero for long-read data, and counted exactly over the short-read
    subset when present. Falls back to the original Fenwick sweep
    (kept below as the oracle) when that subset is too large to
    broadcast. The device implementation in ops/sweep.py computes the
    same counts with blocked comparisons."""
    n_sv = len(sv_windows)
    out = np.zeros(n_sv, np.int64)
    if n_sv == 0 or len(read_starts) == 0:
        return out
    rs = np.asarray(read_starts)
    re_ = np.asarray(read_ends)
    s_arr = np.fromiter((w[0] for w in sv_windows), np.float64, n_sv)
    e_arr = np.fromiter((w[1] for w in sv_windows), np.float64, n_sv)
    wmax = float(np.max(e_arr - s_arr))
    small = (re_ - rs) < wmax
    n_small = int(np.count_nonzero(small))
    base = (np.searchsorted(np.sort(rs), s_arr, "right")
            - np.searchsorted(np.sort(re_), e_arr, "left"))
    if n_small:
        ss, ee = rs[small], re_[small]
        if n_small * n_sv > 8_000_000:
            # too large to broadcast — but ONLY the small-read subset
            # needs the dominance sweep, not the whole read table (the
            # old fallback re-swept all R reads; R >> n_small on
            # long-read data, and this loop's python cost was the
            # largest single host-CPU item left in the bench profile)
            inside = _inside_counts_fenwick(ss, ee, s_arr, e_arr)
        else:
            inside = ((ss[None, :] > s_arr[:, None])
                      & (ee[None, :] < e_arr[:, None])).sum(axis=1)
        base = base + inside
    return base.astype(np.int64)


def _inside_counts_fenwick(ss, ee, s_arr, e_arr) -> np.ndarray:
    """#{j: ss[j] > s_i and ee[j] < e_i} per window i — the broadcast
    term of cover_counts computed by an offline dominance sweep when the
    dense (n_small x n_sv) matrix would not fit the budget. Reads enter
    a Fenwick tree over compressed end ranks in DECREASING start order
    while windows are visited in decreasing s."""
    n_sv = len(s_arr)
    n_r = len(ss)
    out = np.zeros(n_sv, np.int64)
    order_r = np.argsort(-ss, kind="stable")
    ssd = ss[order_r]
    uniq_ends = np.unique(ee)
    er = np.searchsorted(uniq_ends, ee[order_r])
    m = len(uniq_ends)
    tree = [0] * (m + 1)
    e_rank = np.searchsorted(uniq_ends, e_arr, side="left")
    sv_order = np.argsort(-np.asarray(s_arr), kind="stable")
    ptr = 0
    for i in sv_order:
        s = s_arr[i]
        while ptr < n_r and ssd[ptr] > s:
            k = int(er[ptr]) + 1
            while k <= m:
                tree[k] += 1
                k += k & -k
            ptr += 1
        k = int(e_rank[i])  # ends < e_i
        below = 0
        while k > 0:
            below += tree[k]
            k -= k & -k
        out[i] = below
    return out


def _coord_safe_cover_fn(cover_fn, sv_windows, p_end):
    """Device cover kernels double coordinates into int32; a chromosome
    beyond that budget falls back to the exact host sweep (same guard as
    the batched pass, pipeline._batched_cover_multi)."""
    if cover_fn is None or cover_fn is cover_counts:
        return cover_counts
    hi = int(np.max(p_end)) if len(p_end) else 0
    if sv_windows:
        hi = max(hi, int(max(w[1] for w in sv_windows)))
    return cover_counts if hi + 2 > 1_000_000_000 else cover_fn


def assign_gt_del_ins(sv_windows, support_sets, reads_chrom,
                      cover_fn=None) -> list:
    """DR/GT assignment for DEL/INS/DUP/INV candidates.

    ``reads_chrom``: dict with arrays 'start','end','is_primary','name' for
    the census of one chromosome (cuteSV:729-733 rows).
    ``support_sets``: list of read-name collections per SV.
    Returns rows [DV, DR, GT, PL, GQ, QUAL] (assign_gt contract,
    cuteSV_genotype.py:161-173).
    """
    prim = reads_chrom["is_primary"] == 1
    p_start = reads_chrom["start"][prim]
    p_end = reads_chrom["end"][prim]
    p_name = [reads_chrom["name"][i] for i in np.nonzero(prim)[0]]
    name_to_interval = {n: (p_start[k], p_end[k])
                        for k, n in enumerate(p_name)}
    cover = _coord_safe_cover_fn(cover_fn, sv_windows, p_end)
    covers = cover(sv_windows, p_start, p_end)
    table = gl_table()
    rows = []
    for i, (s, e) in enumerate(sv_windows):
        support = support_sets[i]
        inter = 0
        seen = set()
        for name in support:
            if name in seen:
                continue
            seen.add(name)
            iv = name_to_interval.get(name)
            if iv is not None and iv[0] <= s and iv[1] >= e:
                inter += 1
        dr = int(covers[i]) - inter
        dv = len(set(support))
        gt, pl, gq, qual = table.lookup(dr, dv)
        rows.append([dv, dr, gt, pl, gq, qual])
    return rows


# ---------------------------------------------------------------------------
# TRA genotyping: count_coverage replay from the full read table
# ---------------------------------------------------------------------------

def threshold_ref_count(num: int) -> int:
    """cuteSV_genotype.py:62-70."""
    if num <= 2:
        return 20 * num
    if 3 <= num <= 5:
        return 9 * num
    if 6 <= num <= 15:
        return 7 * num
    return 5 * num


class ReadTable:
    """Per-chromosome record table standing in for BAM re-fetch.

    Rows are every mapped record in file (coordinate) order with
    (start, end, flag_primary, qname); ``fetch`` yields rows whose alignment
    span overlaps [s, e), preserving order — the order htslib's fetch
    produces on a coordinate-sorted BAM.
    """

    def __init__(self, start, end, is_primary_flag, names):
        self.start = np.asarray(start, np.int64)
        self.end = np.asarray(end, np.int64)
        self.prim = np.asarray(is_primary_flag, np.int8)
        self.names = names
        self._sorted: Optional[bool] = None  # start ascending? (lazy)
        self._max_len = 0

    def _window(self, s, e):
        """[lo, hi) provably containing every row overlapping [s, e),
        via start-sortedness (file order on a coordinate-sorted BAM is
        start order per chromosome); None when the table isn't sorted
        (arbitrary tables in tests keep the exact full-scan path)."""
        if self._sorted is None:
            st = self.start
            self._sorted = bool(st.size < 2 or np.all(st[1:] >= st[:-1]))
            if self._sorted and st.size:
                self._max_len = int(np.max(self.end - st))
        if not self._sorted:
            return None
        hi = int(np.searchsorted(self.start, e, "left"))     # start < e
        lo = int(np.searchsorted(self.start, s - self._max_len, "left"))
        return lo, hi

    def fetch_idx(self, s, e):
        w = self._window(s, e)
        if w is None:
            return np.nonzero((self.start < e) & (self.end > s))[0]
        lo, hi = w
        return lo + np.nonzero(self.end[lo:hi] > s)[0]


def count_coverage_replay(table: ReadTable, s: int, e: int,
                          read_count: set, up_bound: int, itround: int) -> int:
    """Exact replay of count_coverage (cuteSV_genotype.py:72-93),
    array-at-a-time: the fetch is a sorted-window slice instead of a
    full-table scan, the primary/covering tests vectorize over the (at
    most ``itround``) fetched rows, and only the handful of covering
    rows walk the set-dedup up_bound early exit in order."""
    idx = table.fetch_idx(s, e)
    prim = table.prim[idx] == 1
    pp = np.nonzero(prim)[0]
    # the reference's non-primary `continue` skips its iteration-cap
    # check, so the cap fires at the first PRIMARY row whose 1-based
    # fetch position reaches itround (possibly past itround itself)
    cap_at = -1
    kth = int(np.searchsorted(pp, itround - 1, "left"))
    if kth < pp.size:
        cap_at = int(pp[kth])
    lim = cap_at + 1 if cap_at >= 0 else idx.size
    head = idx[:lim]
    covering = prim[:lim] & (table.start[head] < s) & (table.end[head] > e)
    for k in np.nonzero(covering)[0]:
        # the reference checks the bound after each covering add and
        # before its iteration-cap check, so up_bound wins ties
        read_count.add(table.names[int(head[k])])
        if len(read_count) >= up_bound:
            return 1
    if cap_at >= 0:
        return 1 if float((kth + 1) / lim) <= 0.2 else -1
    return 0


def call_gt_tra(tables: Dict[str, ReadTable], chrom_lengths: Dict[str, int],
                pos_1: int, pos_2: int, chr_1: str, chr_2: str,
                read_id_list: set, max_cluster_bias: int, gt_round: int):
    """TRA genotype (cuteSV_resolveTRA.py:260-309) from the census tables."""
    if chr_1 not in chrom_lengths or chr_2 not in chrom_lengths:
        # SA-tag contig absent from the BAM header: the reference would
        # fail the whole chromosome task here (bare except, cuteSV:1193);
        # we degrade to the "unresolvable" genotype instead.
        return len(read_id_list), ".", "./.", ".,.,.", ".", "."
    querydata: set = set()
    search_start = max(int(pos_1) - max_cluster_bias, 0)
    search_end = min(int(pos_1) + max_cluster_bias, chrom_lengths[chr_1])
    up_bound = threshold_ref_count(len(read_id_list))
    empty = ReadTable([], [], [], [])
    t1 = tables.get(chr_1, empty)
    status = count_coverage_replay(t1, search_start, search_end, querydata,
                                   up_bound, gt_round)
    if status == -1:
        return len(read_id_list), ".", "./.", ".,.,.", ".", "."
    if status == 1:
        dr = sum(1 for q in querydata if q not in read_id_list)
        gt, gl, gq, qual = gl_table().lookup(dr, len(read_id_list))
        return len(read_id_list), dr, gt, gl, gq, qual
    search_start = max(int(pos_2) - max_cluster_bias, 0)
    search_end = min(int(pos_2) + max_cluster_bias, chrom_lengths[chr_2])
    t2 = tables.get(chr_2, empty)
    count_coverage_replay(t2, search_start, search_end, querydata,
                          up_bound, gt_round)
    dr = sum(1 for q in querydata if q not in read_id_list)
    gt, gl, gq, qual = gl_table().lookup(dr, len(read_id_list))
    return len(read_id_list), dr, gt, gl, gq, qual


def cal_CIPOS(std: float, num: int) -> str:
    """cuteSV_genotype.py:58-60."""
    pos = int(1.96 * std / num ** 0.5)
    return "-%d,%d" % (pos, pos)
