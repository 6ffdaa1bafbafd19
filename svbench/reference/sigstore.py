"""Signature store of the plain reference: merge, sort, dedup and
per-chromosome grouping of the extraction's tuple streams, and the
resolution-side sentinel filter. A copy of the Python-decoder half of
``cutesv_tpu_torch/sigstore.py`` (``build_store``), kept here so that the
reference shares no code with the program under test.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from svbench.reference.genotype import ReadTable

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
    if any(r[i] == 0 and r[j] == 0 for r in stream):
        return [r for r in stream if not (r[i] == 0 and r[j] == 0)]
    return stream
