"""Signature store: merge, sort, dedup and per-chromosome grouping.

Stands in for the reference's stage-2 spill-merge (process_process_sigs_type,
cuteSV:750-857): per SV type, signatures are sorted with the reference's
exact keys, exact duplicates removed, and grouped per chromosome. The engine
keeps everything in memory as tuples (oracle path) or numpy SoA (device
path); ``save``/``load`` provide the checkpoint that replaces the
reference's pickle work_dir (its checkpoint/resume story, cuteSV:1101-1102).

Two constructors: :func:`build_store` from the Python decoder's tuple streams
(read identity = name string) and :func:`build_store_native` from the C++
decoder's arrays (read identity = lexicographic name rank);
:func:`store_from_state` builds a store from plain dicts of arrays and
tuples.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from cutesv_tpu_torch.genotype import ReadTable

SVTYPES = ("DEL", "INS", "DUP", "INV", "TRA")

# sort keys per type, matching cuteSV:763-810 (tuple layouts documented in
# cutesv_tpu_torch/extract.py)
_SORT_KEYS = {
    "DEL": lambda x: (x[4], int(x[0]), x[1], x[2]),
    "INS": lambda x: (x[5], int(x[0]), x[1], x[2], x[3]),
    "DUP": lambda x: (x[4], int(x[0]), int(x[1]), x[2]),
    "INV": lambda x: (x[5], x[0], int(x[1]), x[2], x[3]),
    "TRA": lambda x: (x[6], x[2], x[0], int(x[1]), x[3], x[4]),
}
_CHROM_IDX = {"DEL": 4, "INS": 5, "DUP": 4, "INV": 5, "TRA": 6}


def _dedup_sorted(rows: List[tuple]) -> List[tuple]:
    """Remove exact-duplicate tuples from a sorted list
    (remove_duplicates_sorted, cuteSV:958-969)."""
    out = []
    prev = None
    for r in rows:
        if r != prev:
            out.append(r)
            prev = r
    return out


@dataclass
class SigStore:
    """Merged signature streams + read census, grouped per chromosome.

    :func:`build_store` populates this from the Python decoder's tuple
    streams (read identity = name string), :func:`build_store_native`
    from the C++ decoder's arrays (read identity = lexicographic name
    rank, rendered to strings via ``names``), :func:`store_from_state`
    from plain dicts. DEL/INS streams of the native store are columnar
    (models.device.IndelStream); DUP/INV/TRA stay small tuple lists.
    """

    # per type: chrom -> list of resolver-format rows (or IndelStream)
    sigs: Dict[str, Dict[str, object]] = field(default_factory=dict)
    # chrom -> census arrays (mapq-passing, bed-passing, non-256/272 records)
    census: Dict[str, dict] = field(default_factory=dict)
    # chrom -> full record table (TRA count_coverage replay source)
    read_tables: Dict[str, ReadTable] = field(default_factory=dict)
    chrom_lengths: Dict[str, int] = field(default_factory=dict)
    # identity-rank -> read-name string (native path only)
    names: List[str] = None

    def chroms(self, svtype: str) -> List[str]:
        return list(self.sigs.get(svtype, {}))


def build_store(candidates: Dict[str, List[tuple]],
                census_rows: List[tuple],
                allread_rows: List[tuple],
                chrom_lengths: Dict[str, int]) -> SigStore:
    """Merge raw extraction output into a SigStore.

    ``candidates``: dict of per-type signature tuples (extract.py layouts).
    ``census_rows``: (start, end, is_primary, qname, chrom) per kept record.
    ``allread_rows``: (start, end, primary01, qname, chrom) per mapped
    record regardless of filters, in file order.
    """
    store = SigStore(chrom_lengths=dict(chrom_lengths))
    for svtype in SVTYPES:
        rows = sorted(candidates.get(svtype, []), key=_SORT_KEYS[svtype])
        rows = _dedup_sorted(rows)
        per_chrom: Dict[str, List[tuple]] = {}
        cidx = _CHROM_IDX[svtype]
        for r in rows:
            per_chrom.setdefault(r[cidx], []).append(
                _to_resolver_row(svtype, r))
        store.sigs[svtype] = per_chrom
    # census grouped by chrom, preserving file order (coordinate sorted)
    grouped: Dict[str, List[tuple]] = {}
    for r in census_rows:
        grouped.setdefault(r[4], []).append(r)
    for chrom, rows in grouped.items():
        store.census[chrom] = dict(
            start=np.array([r[0] for r in rows], np.int64),
            end=np.array([r[1] for r in rows], np.int64),
            is_primary=np.array([r[2] for r in rows], np.int8),
            name=[r[3] for r in rows],
        )
    ag: Dict[str, List[tuple]] = {}
    for r in allread_rows:
        ag.setdefault(r[4], []).append(r)
    for chrom, rows in ag.items():
        store.read_tables[chrom] = ReadTable(
            [r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows], [r[3] for r in rows])
    return store


def _to_resolver_row(svtype: str, r: tuple) -> tuple:
    """Project a merged signature tuple onto the per-type resolver layout,
    applying the reference's int() coercions at resolution load time
    (e.g. cuteSV_resolveINDEL.py:57-58,263-264)."""
    if svtype == "DEL":
        return (int(r[0]), int(r[1]), r[2])
    if svtype == "INS":
        return (int(r[0]), int(r[1]), r[2], r[3])
    if svtype == "DUP":
        return (int(r[0]), int(r[1]), r[2])
    if svtype == "INV":
        return (r[0], int(r[1]), int(r[2]), r[3])
    # TRA
    return (r[0], int(r[1]), r[2], int(r[3]), r[4])


def _lexsort_packed(keys) -> np.ndarray:
    """``np.lexsort(keys)`` with adjacent non-negative int keys packed
    into single int64 columns when both fit 31 bits — each packed pair
    is one fewer stable argsort pass (lexsort keys are least-significant
    first, so ``keys[i+1]`` is the more significant of a pair). Exact:
    packing two keys a (low) and b (high) as (b << 31) | a orders by
    (b, a) precisely when 0 <= a,b < 2**31."""
    out = []
    i = 0
    keys = [np.asarray(k) for k in keys]
    while i < len(keys):
        k = keys[i]
        if i + 1 < len(keys) and len(k):
            k2 = keys[i + 1]
            if (k.dtype.kind in "iu" and k2.dtype.kind in "iu"
                    and int(k.min()) >= 0 and int(k.max()) < (1 << 31)
                    and int(k2.min()) >= 0 and int(k2.max()) < (1 << 31)):
                out.append((k2.astype(np.int64) << np.int64(31))
                           | k.astype(np.int64))
                i += 2
                continue
        out.append(k)
        i += 1
    return np.lexsort(tuple(out))


def _dedup_mask(*keys) -> np.ndarray:
    """True for rows differing from the previous row in any key."""
    n = len(keys[0])
    if n == 0:
        return np.zeros(0, bool)
    keep = np.zeros(n, bool)
    keep[0] = True
    for k in keys:
        keep[1:] |= k[1:] != k[:-1]
    return keep


def prepare_snapshot(snap: dict, is_ins: bool):
    """Sort + dedup one chromosome's streaming-decode snapshot with the
    exact per-chromosome sort keys of build_store_native. The snapshot's
    LOCAL name/seq ranks are order-isomorphic to the final global ranks
    restricted to the same rows, so the resulting permutation equals the
    final store's — as long as no later read added rows to this
    chromosome. Signature rows are append-only, so build_store_native
    validates a snapshot by raw row COUNT: equal count means the exact
    same rows, and the store then reuses these columns instead of
    re-sorting them.

    Returns (store_cols, dispatch): store_cols = {pos (raw; INS pos*2),
    length, name_id[, seq_off, seq_len], n_raw} post-sort+dedup, ready
    to become the final per-chromosome store stream (rid = global
    rank[name_id]); dispatch = {pos (INS: int(pos)), length, rid (local
    ranks)} for the cluster program."""
    lrank = snap["name_lrank"]
    n_raw = len(snap["pos"])
    if is_ins:
        px2, ln, sq = snap["pos"], snap["length"], snap["seq_lrank"]
        order = _lexsort_packed((sq, lrank, ln, px2 >> 1))
        px2, ln, lrank, sq = (px2[order], ln[order], lrank[order],
                              sq[order])
        nid = snap["name_id"][order]
        soff = snap["seq_off"][order]
        slen = snap["seq_len"][order]
        keep = _dedup_mask(px2, ln, lrank, sq)
        px2, ln, lrank, nid = px2[keep], ln[keep], lrank[keep], nid[keep]
        soff, slen = soff[keep], slen[keep]
        # dispatch mirrors resolution's sentinel filter (drop_sentinel_rows)
        # so the early program's rows equal the filtered store stream;
        # the store columns stay unfiltered (store identity)
        live = ~(((px2 >> 1) == 0) & (ln == 0))
        return (dict(pos=px2, length=ln, name_id=nid, seq_off=soff,
                     seq_len=slen, n_raw=n_raw),
                dict(pos=(px2 >> 1)[live], length=ln[live], rid=lrank[live]))
    pos, ln = snap["pos"], snap["length"]
    order = _lexsort_packed((lrank, ln, pos))
    pos, ln, lrank = pos[order], ln[order], lrank[order]
    nid = snap["name_id"][order]
    keep = _dedup_mask(pos, ln, lrank)
    pos, ln, lrank, nid = pos[keep], ln[keep], lrank[keep], nid[keep]
    live = ~((pos == 0) & (ln == 0))
    return (dict(pos=pos, length=ln, name_id=nid, n_raw=n_raw),
            dict(pos=pos[live], length=ln[live], rid=lrank[live]))


def prepare_snapshot_pair(svtype: str, snap: dict):
    """DUP/INV counterpart of :func:`prepare_snapshot`: sort + dedup one
    chromosome's streaming snapshot with the store's exact keys
    (DUP: (p1, p2, name); INV: (strand, b1, b2, name), cuteSV:763-810)
    and strip sentinel rows, yielding pair-cluster program args whose row
    order equals the final store's filtered per-chromosome tuples.
    Returns (fingerprint, {k1, k2, aux, keys})."""
    n_raw = len(snap["pos"])
    k1, k2, lrank = snap["pos"], snap["length"], snap["name_lrank"]
    if svtype == "INV":
        st = snap["strand"]
        order = _lexsort_packed((lrank, k2, k1, st))
        st, k1, k2, lr = st[order], k1[order], k2[order], lrank[order]
        keep = _dedup_mask(st, k1, k2, lr)
        st, k1, k2, lr = st[keep], k1[keep], k2[keep], lr[keep]
        aux = st.astype(np.int64)
    else:
        order = _lexsort_packed((lrank, k2, k1))
        k1, k2, lr = k1[order], k2[order], lrank[order]
        keep = _dedup_mask(k1, k2, lr)
        k1, k2, lr = k1[keep], k2[keep], lr[keep]
        aux = np.zeros(len(k1), np.int64)
    # resolution-side sentinel filter (drop_sentinel_rows semantics over
    # the program's two coordinates)
    live = ~((k1 == 0) & (k2 == 0))
    return (dict(n_raw=n_raw),
            dict(k1=k1[live], k2=k2[live], aux=aux[live], keys=lr[live]))


def build_store_native(nd, early=None) -> SigStore:
    """Merge the native decoder's signature arrays (io.native.NativeDecode)
    into a SigStore.

    Reproduces the stage-2 sort keys (cuteSV:763-810) with numpy lexsorts
    over integer rank columns: chromosome names, read names and INS
    sequences are compared via precomputed lexicographic ranks, which makes
    integer sorting equal string sorting. Exact-duplicate removal compares
    full rows (INS compares pos*2 exactly and sequences by content rank).

    ``early``: optional {(svtype, chrom_name): fingerprint} from
    :func:`prepare_snapshot` / :func:`prepare_snapshot_pair`; chromosomes
    whose final raw row count matches their snapshot's are recorded in
    ``store.early_valid`` (a late read's SA tag can add rows to an earlier
    chromosome, in which case the early work is discarded), and their
    DEL/INS streams reuse the snapshot's sorted columns.
    """
    from cutesv_tpu_torch.models.device import IndelStream

    A = nd.arrays
    rank = np.asarray(nd.name_rank, np.int64)
    # vectorized scatter (object arrays keep the strings by reference)
    _nbr = np.empty(len(nd.names), object)
    _nbr[rank] = np.asarray(nd.names, dtype=object)
    names_by_rank = _nbr.tolist()
    chrom_order = sorted(range(len(nd.chroms)), key=lambda i: nd.chroms[i])
    chrom_rank = np.zeros(len(nd.chroms), np.int64)
    for r, i in enumerate(chrom_order):
        chrom_rank[i] = r
    chrom_by_rank = [nd.chroms[i] for i in chrom_order]

    store = SigStore(chrom_lengths={
        nd.chroms[i]: int(nd.ref_lengths[i])
        for i in range(len(nd.ref_lengths))})
    store.names = names_by_rank

    def per_chrom_slices(ck_sorted):
        """Yield (chrom_name, lo, hi) for contiguous chrom groups."""
        n = len(ck_sorted)
        if n == 0:
            return
        bounds = np.flatnonzero(np.diff(ck_sorted)) + 1
        lo = 0
        for hi in list(bounds) + [n]:
            yield chrom_by_rank[int(ck_sorted[lo])], lo, int(hi)
            lo = int(hi)

    store.early_valid = set()

    def early_cols(svtype, chr_col):
        """{chrom_id: store_cols} for chromosomes whose streaming-decode
        snapshot still matches the final arrays. Rows are append-only, so
        an equal raw per-chromosome row count means the snapshot saw the
        exact same rows — no sorted-column comparison needed, and the
        store can reuse the snapshot's sorted/deduped columns instead of
        re-sorting them."""
        if not early:
            return {}
        cnts = np.bincount(chr_col, minlength=len(nd.chroms))
        out = {}
        for cid in range(len(nd.chroms)):
            cols = early.get((svtype, nd.chroms[cid]))
            if cols is not None and cols["n_raw"] == int(cnts[cid]):
                out[cid] = cols
                store.early_valid.add((svtype, nd.chroms[cid]))
        return out

    def merge_streams(ev, global_streams, make_early):
        """Per-chrom streams in chromosome-rank order (the dict order the
        all-global path produces), merging early and globally-sorted
        chromosomes."""
        out = {}
        for cid in chrom_order:
            name = nd.chroms[cid]
            if cid in ev:
                out[name] = make_early(ev[cid])
            elif name in global_streams:
                out[name] = global_streams[name]
        return out

    # ---- DEL: key (chr, pos, len, name) --------------------------------
    ev = early_cols("DEL", A["del_chr"])
    if ev:
        sel = ~np.isin(A["del_chr"],
                       np.fromiter(ev, np.int64, len(ev)))
        d_chr, d_pos, d_len, d_name = (A["del_chr"][sel], A["del_pos"][sel],
                                       A["del_len"][sel], A["del_name"][sel])
    else:
        d_chr, d_pos, d_len, d_name = (A["del_chr"], A["del_pos"],
                                       A["del_len"], A["del_name"])
    rid = rank[d_name]
    ck = chrom_rank[d_chr]
    order = _lexsort_packed((rid, d_len, d_pos, ck))
    ck, pos, ln, rid = ck[order], d_pos[order], d_len[order], rid[order]
    keep = _dedup_mask(ck, pos, ln, rid)
    ck, pos, ln, rid = ck[keep], pos[keep], ln[keep], rid[keep]
    dels = {
        chrom: IndelStream.from_arrays(pos[lo:hi], ln[lo:hi], rid[lo:hi],
                                       names_by_rank)
        for chrom, lo, hi in per_chrom_slices(ck)}
    store.sigs["DEL"] = merge_streams(
        ev, dels, lambda c: IndelStream.from_arrays(
            c["pos"], c["length"], rank[c["name_id"]], names_by_rank))

    # ---- INS: key (chr, int(pos), len, name, seq) ----------------------
    ev = early_cols("INS", A["ins_chr"])
    if ev:
        sel = ~np.isin(A["ins_chr"],
                       np.fromiter(ev, np.int64, len(ev)))
        i_chr, i_px2, i_len, i_name = (A["ins_chr"][sel],
                                       A["ins_posx2"][sel],
                                       A["ins_len"][sel],
                                       A["ins_name"][sel])
        i_sq, i_soff, i_slen = (A["ins_seq_rank"][sel],
                                A["ins_seq_off"][sel],
                                A["ins_seq_len"][sel])
    else:
        i_chr, i_px2, i_len, i_name = (A["ins_chr"], A["ins_posx2"],
                                       A["ins_len"], A["ins_name"])
        i_sq, i_soff, i_slen = (A["ins_seq_rank"], A["ins_seq_off"],
                                A["ins_seq_len"])
    rid = rank[i_name]
    ck = chrom_rank[i_chr]
    ipos = i_px2 >> 1
    order = _lexsort_packed((i_sq, rid, i_len, ipos, ck))
    ck, px2, ln, rid, sq = (ck[order], i_px2[order], i_len[order],
                            rid[order], i_sq[order])
    soff, slen = i_soff[order], i_slen[order]
    keep = _dedup_mask(ck, px2, ln, rid, sq)
    ck, px2, ln, rid = ck[keep], px2[keep], ln[keep], rid[keep]
    soff, slen = soff[keep], slen[keep]
    ipos = px2 >> 1  # resolution-time int(pos) truncation
    inss = {
        chrom: IndelStream.from_arrays(ipos[lo:hi], ln[lo:hi], rid[lo:hi],
                                       names_by_rank, seq_len=slen[lo:hi],
                                       seq_blob=nd.ins_seq_blob,
                                       seq_off=soff[lo:hi])
        for chrom, lo, hi in per_chrom_slices(ck)}
    store.sigs["INS"] = merge_streams(
        ev, inss, lambda c: IndelStream.from_arrays(
            c["pos"] >> 1, c["length"], rank[c["name_id"]], names_by_rank,
            seq_len=c["seq_len"], seq_blob=nd.ins_seq_blob,
            seq_off=c["seq_off"]))

    # ---- DUP: key (chr, pos1, pos2, name); tuple rows ------------------
    # (early pair-program validation only needs the row-count fingerprint;
    # the tuple lists are still built globally for host emission)
    early_cols("DUP", A["dup_chr"])
    rid = rank[A["dup_name"]]
    ck = chrom_rank[A["dup_chr"]]
    order = _lexsort_packed((rid, A["dup_p2"], A["dup_p1"], ck))
    ck, p1, p2, rid = (ck[order], A["dup_p1"][order], A["dup_p2"][order],
                       rid[order])
    keep = _dedup_mask(ck, p1, p2, rid)
    ck, p1, p2, rid = ck[keep], p1[keep], p2[keep], rid[keep]
    store.sigs["DUP"] = {
        chrom: list(zip(p1[lo:hi].tolist(), p2[lo:hi].tolist(),
                        rid[lo:hi].tolist()))
        for chrom, lo, hi in per_chrom_slices(ck)}

    # ---- INV: key (chr, strand, bp1, bp2, name); tuple rows ------------
    early_cols("INV", A["inv_chr"])
    rid = rank[A["inv_name"]]
    ck = chrom_rank[A["inv_chr"]]
    st = A["inv_strand"].astype(np.int64)
    order = _lexsort_packed((rid, A["inv_b2"], A["inv_b1"], st, ck))
    ck, st, b1, b2, rid = (ck[order], st[order], A["inv_b1"][order],
                           A["inv_b2"][order], rid[order])
    keep = _dedup_mask(ck, st, b1, b2, rid)
    ck, st, b1, b2, rid = ck[keep], st[keep], b1[keep], b2[keep], rid[keep]
    strands = np.array(["++", "--"])
    store.sigs["INV"] = {
        chrom: list(zip(strands[st[lo:hi]].tolist(), b1[lo:hi].tolist(),
                        b2[lo:hi].tolist(), rid[lo:hi].tolist()))
        for chrom, lo, hi in per_chrom_slices(ck)}

    # ---- TRA: key (chr1, chr2, type, pos1, pos2, name); tuple rows -----
    rid = rank[A["tra_name"]]
    ck1 = chrom_rank[A["tra_chr1"]]
    ck2 = chrom_rank[A["tra_chr2"]]
    ty = A["tra_type"].astype(np.int64)
    order = _lexsort_packed((rid, A["tra_p2"], A["tra_p1"], ty, ck2, ck1))
    ck1, ck2, ty, p1, p2, rid = (ck1[order], ck2[order], ty[order],
                                 A["tra_p1"][order], A["tra_p2"][order],
                                 rid[order])
    keep = _dedup_mask(ck1, ck2, ty, p1, p2, rid)
    ck1, ck2, ty, p1, p2, rid = (ck1[keep], ck2[keep], ty[keep], p1[keep],
                                 p2[keep], rid[keep])
    types = np.array(["A", "B", "C", "D"])
    store.sigs["TRA"] = {
        chrom: [(t, int(a), chrom_by_rank[int(c2)], int(b), int(r))
                for t, a, c2, b, r in zip(
                    types[ty[lo:hi]].tolist(), p1[lo:hi], ck2[lo:hi],
                    p2[lo:hi], rid[lo:hi])]
        for chrom, lo, hi in per_chrom_slices(ck1)}

    # ---- census / read tables (stable per-chrom grouping) --------------
    cen_ck = A["cen_chr"].astype(np.int64)
    order = np.argsort(cen_ck, kind="stable")
    cs, ce, cp, cn, cc = (A["cen_start"][order], A["cen_end"][order],
                          A["cen_prim"][order], rank[A["cen_name"]][order],
                          cen_ck[order])
    n = len(cc)
    bounds = list(np.flatnonzero(np.diff(cc)) + 1) + ([n] if n else [])
    lo = 0
    for hi in bounds:
        chrom = nd.chroms[int(cc[lo])]
        store.census[chrom] = dict(start=cs[lo:hi], end=ce[lo:hi],
                                   is_primary=cp[lo:hi].astype(np.int8),
                                   name=cn[lo:hi])
        lo = int(hi)

    all_ck = A["all_chr"].astype(np.int64)
    order = np.argsort(all_ck, kind="stable")
    s, e, p, nm, cc = (A["all_start"][order], A["all_end"][order],
                       A["all_prim"][order], rank[A["all_name"]][order],
                       all_ck[order])
    n = len(cc)
    bounds = list(np.flatnonzero(np.diff(cc)) + 1) + ([n] if n else [])
    lo = 0
    for hi in bounds:
        chrom = nd.chroms[int(cc[lo])]
        store.read_tables[chrom] = ReadTable(s[lo:hi], e[lo:hi], p[lo:hi],
                                             nm[lo:hi])
        lo = int(hi)
    return store


def store_from_state(state: dict) -> SigStore:
    """Build a store from plain data: ``state`` holds ``sigs`` ({svtype:
    {chrom: [resolver-format tuple rows]}}), ``census`` ({chrom: {start,
    end, is_primary, name}}), ``read_tables`` ({chrom: {start, end,
    primary, name}} lists or arrays), ``chrom_lengths`` and, optionally,
    ``names``. Arrays are copied, so the store shares nothing with
    ``state``."""
    store = SigStore(chrom_lengths=dict(state["chrom_lengths"]),
                     names=state.get("names"))
    for svtype in SVTYPES:
        store.sigs[svtype] = {
            chrom: [tuple(r) for r in rows]
            for chrom, rows in state["sigs"].get(svtype, {}).items()}
    for chrom, cen in state["census"].items():
        name = cen["name"]
        store.census[chrom] = dict(
            start=np.array(cen["start"], np.int64),
            end=np.array(cen["end"], np.int64),
            is_primary=np.array(cen["is_primary"], np.int8),
            name=(np.array(name) if isinstance(name, np.ndarray)
                  else list(name)))
    for chrom, tbl in state["read_tables"].items():
        store.read_tables[chrom] = ReadTable(
            np.array(tbl["start"]), np.array(tbl["end"]),
            np.array(tbl["primary"]), list(tbl["name"]))
    return store


# per-type positions of the two coordinates the reference's sentinel test
# inspects (semi_*_cluster[-1][0] == [-1][1] == 0 over the RESOLVER row
# layout; for TRA the layout is [pos1, pos2, rid, type] built from row
# fields 1 and 3, for INV [bp1, bp2, rid, strand] from fields 1 and 2)
_SENTINEL_COORDS = {"DEL": (0, 1), "INS": (0, 1), "DUP": (0, 1),
                    "INV": (1, 2), "TRA": (1, 3)}


def drop_sentinel_rows(svtype: str, stream):
    """Drop signature rows whose two sentinel-checked coordinates are both
    zero, as the reference's resolution loops do.

    The reference seeds every per-chromosome cluster loop with a [0, 0, …]
    sentinel and restarts the cluster whenever the LAST element is
    (0, 0)-valued (cuteSV_resolveINDEL.py:62-83/272-298,
    cuteSV_resolveDUP.py:36-58, cuteSV_resolveINV.py:57-80,
    cuteSV_resolveTRA.py:65-88). Because merged streams are sorted, a REAL
    row matching the sentinel pattern always sits at the front of its
    cluster segment, so the restart (or the flush's sentinel `pass`)
    silently discards it — i.e. resolution never sees such rows, though
    stage 2 keeps them (.sigs files include them). Resolution-side filter
    only; the store is left intact.
    """
    i, j = _SENTINEL_COORDS[svtype]
    if hasattr(stream, "select"):            # columnar IndelStream
        keep = ~((stream.pos == 0) & (stream.length == 0))
        return stream if bool(keep.all()) else stream.select(keep)
    if any(r[i] == 0 and r[j] == 0 for r in stream):
        return [r for r in stream if not (r[i] == 0 and r[j] == 0)]
    return stream


def save_store(store: SigStore, work_dir: str):
    """Checkpoint the store (signature tensors = natural resume point
    between extract and cluster, SURVEY §5). The streaming decode's
    program handles (device tensors and CUDA events, which do not
    pickle) never enter the checkpoint."""
    path = os.path.join(work_dir, "sigstore.pickle")
    kernels = store.__dict__.pop("early_kernels", None)
    try:
        with open(path, "wb") as fh:
            pickle.dump(store, fh, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        if kernels is not None:
            store.early_kernels = kernels
    return path


def load_store(work_dir: str) -> SigStore:
    with open(os.path.join(work_dir, "sigstore.pickle"), "rb") as fh:
        return pickle.load(fh)


def _write_reads_sigs(store: SigStore, work_dir: str):
    """Legacy reads.sigs (cuteSV:811-816): the mapq/bed-passing census,
    stable-sorted by chromosome name only (within a chromosome the file
    order is preserved; the reference's sort key is just ``x[-1]``)."""
    names = store.names
    with open(os.path.join(work_dir, "reads.sigs"), "w") as fh:
        for chrom in sorted(store.census):
            cen = store.census[chrom]
            starts, ends, prim = cen["start"], cen["end"], cen["is_primary"]
            nm = cen["name"]
            for k in range(len(starts)):
                q = nm[k] if names is None else names[int(nm[k])]
                fh.write("%s\t%d\t%d\t%d\t%s\n" % (
                    chrom, starts[k], ends[k], prim[k], q))


def write_old_sigs_native(store: SigStore, work_dir: str):
    """Legacy .sigs text from a store alone (no raw candidates dict):
    used for native decodes and for ``--resume`` runs, where only the
    store survives. Streams are already in the reference's merged sort
    order and chrom groups concatenate in chrom order (rank order on
    native stores, sorted-string order on oracle stores — the same
    order), so the bytes match :func:`write_old_sigs`. Handles both
    store flavors: columnar rank-keyed streams and oracle tuple rows
    with string read names."""
    names = store.names
    name_of = (lambda r: r) if names is None else (
        lambda r: names[int(r)])

    def indel_rows(stream, with_seq):
        if hasattr(stream, "pos"):       # native columnar stream
            for k in range(len(stream)):
                row = (int(stream.pos[k]), int(stream.length[k]),
                       names[int(stream.rid[k])])
                yield row + (stream.seq_of(k),) if with_seq else row
        else:                             # oracle tuple rows
            for row in stream:
                base = (row[0], row[1], name_of(row[2]))
                yield base + (row[3],) if with_seq else base

    with open(os.path.join(work_dir, "DEL.sigs"), "w") as fh:
        for chrom, stream in store.sigs["DEL"].items():
            for pos, ln, q in indel_rows(stream, False):
                fh.write("DEL\t%s\t%d\t%d\t%s\n" % (chrom, pos, ln, q))
    with open(os.path.join(work_dir, "INS.sigs"), "w") as fh:
        for chrom, stream in store.sigs["INS"].items():
            for pos, ln, q, seq in indel_rows(stream, True):
                fh.write("INS\t%s\t%d\t%d\t%s\t%s\n" % (chrom, pos, ln,
                                                        q, seq))
    with open(os.path.join(work_dir, "DUP.sigs"), "w") as fh:
        for chrom, rows in store.sigs["DUP"].items():
            for p1, p2, rid in rows:
                fh.write("DUP\t%s\t%d\t%d\t%s\n" % (chrom, p1, p2,
                                                    name_of(rid)))
    with open(os.path.join(work_dir, "INV.sigs"), "w") as fh:
        for chrom, rows in store.sigs["INV"].items():
            for st, b1, b2, rid in rows:
                fh.write("INV\t%s\t%s\t%d\t%d\t%s\n" % (chrom, st, b1, b2,
                                                        name_of(rid)))
    with open(os.path.join(work_dir, "TRA.sigs"), "w") as fh:
        for chrom, rows in store.sigs["TRA"].items():
            for ty, p1, chr2, p2, rid in rows:
                fh.write("TRA\t%s\t%s\t%d\t%s\t%d\t%s\n" % (
                    chrom, ty, p1, chr2, p2, name_of(rid)))
    _write_reads_sigs(store, work_dir)


def write_old_sigs(store: SigStore, work_dir: str,
                   candidates: Dict[str, List[tuple]]):
    """Legacy text .sigs files (--write_old_sigs, cuteSV:766-816)."""
    fmts = {
        "DEL": ("%s\t%s\t%d\t%d\t%s\n",
                lambda e: ("DEL", e[4], e[0], e[1], e[2])),
        "INS": ("%s\t%s\t%d\t%d\t%s\t%s\n",
                lambda e: ("INS", e[5], e[0], e[1], e[2], e[3])),
        "DUP": ("%s\t%s\t%d\t%d\t%s\n",
                lambda e: ("DUP", e[4], e[0], e[1], e[2])),
        "INV": ("%s\t%s\t%s\t%d\t%d\t%s\n",
                lambda e: ("INV", e[5], e[0], e[1], e[2], e[3])),
        "TRA": ("%s\t%s\t%s\t%d\t%s\t%d\t%s\n",
                lambda e: ("TRA", e[6], e[0], e[1], e[2], e[3], e[4])),
    }
    for svtype in SVTYPES:
        rows = sorted(candidates.get(svtype, []), key=_SORT_KEYS[svtype])
        rows = _dedup_sorted(rows)
        fmt, proj = fmts[svtype]
        with open(os.path.join(work_dir, "%s.sigs" % svtype), "w") as fh:
            for e in rows:
                fh.write(fmt % proj(e))
    _write_reads_sigs(store, work_dir)
