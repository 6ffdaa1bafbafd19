"""Signature store: merge, sort, dedup and per-chromosome grouping.

Stands in for the reference's stage-2 spill-merge (process_process_sigs_type,
cuteSV:750-857): per SV type, signatures are sorted with the reference's
exact keys, exact duplicates removed, and grouped per chromosome. The engine
keeps everything in memory as tuples (oracle path) or numpy SoA (device
path); ``save``/``load`` provide the checkpoint that replaces the
reference's pickle work_dir (its checkpoint/resume story, cuteSV:1101-1102).

This is the Python-decoder half of ``cutesv_tpu/sigstore.py`` (read
identity = name string); :func:`store_from_state` builds a store from
plain dicts of arrays and tuples.
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
    streams (read identity = name string); :func:`store_from_state` from
    plain dicts. ``names`` (identity-rank -> read name) is set only by
    rank-keyed stores.
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
    between extract and cluster, SURVEY §5)."""
    path = os.path.join(work_dir, "sigstore.pickle")
    with open(path, "wb") as fh:
        pickle.dump(store, fh, protocol=pickle.HIGHEST_PROTOCOL)
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
