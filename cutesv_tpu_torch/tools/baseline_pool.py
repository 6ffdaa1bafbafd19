"""Pool-parallel reference-equivalent python baseline.

Mirrors cuteSV's multiprocessing architecture on this repo's python
oracle stack (python BGZF/BAM decode + host numpy resolvers), so the
benchmark's denominator parallelizes the way the reference does
(round-3 verdict: a single-process python baseline understates the
reference on any multi-core host):

* stage 1 — ``Pool`` over per-chromosome decode tasks, each worker
  inflating only its chromosome's BGZF blocks via a one-time cached
  virtual-offset index (the ``.bai`` equivalent pysam's ``fetch`` uses;
  building it is untimed, like ``samtools index``)
  (cuteSV:1058-1076),
* stage 2 — ``Pool`` over the per-SV-type merge/sort/dedup streams
  (cuteSV:1079-1093); the read census/read tables build in the parent
  meanwhile (the reference's 6th "reads" stream),
* stages 3+4 — ``Pool`` over per-chromosome resolution + genotyping +
  VCF formatting (cuteSV:1113-1189, 1218-1223),
* stage 5 — serial merge with SVID renumbering (cuteSV:1225-1236).

Workers read their inputs from a module global under ``fork`` (the
parent's arrays are shared copy-on-write — the generous analogue of the
reference's pickle-file IPC; generosity here can only lower the
headline ratio). Output is byte-identical to the single-process python
pipeline (pinned by tests/test_torch_baseline.py).

A forked child cannot use CUDA, so the run's device is resolved once, in
the parent, and handed to the workers through the fork-shared inputs.
With the host engine (the baseline's oracle stack) nothing reaches the
card, whichever device that is; a device engine on a CUDA device is
refused before the first fork.
"""
from __future__ import annotations

import json
import os
import struct
from multiprocessing import Pool
from typing import Dict, List

import numpy as np

from cutesv_tpu_torch import extract, sigstore, vcf
from cutesv_tpu_torch.genotype import ReadTable
from cutesv_tpu_torch.io.bam import BamReader
from cutesv_tpu_torch.io.bgzf import BgzfReader, scan_block_table
from cutesv_tpu_torch.io.fasta import FastaFile
from cutesv_tpu_torch.utils.torchsetup import resolve_device

# fork-shared worker inputs (set in the parent before each Pool spawns)
_G: dict = {}


def build_chrom_index(path: str, cache: bool = True) -> dict:
    """First-record virtual offset per reference id, cached as JSON next
    to the BAM (``<bam>.pooledidx.json``). The scan decodes record
    *headers* only (4-byte length + ref_id), skipping bodies; this is
    the one-time index build a reference run gets from ``samtools
    index`` and is therefore not part of the timed pipeline."""
    idx_path = path + ".pooledidx.json"
    if cache and os.path.exists(idx_path) and (
            os.path.getmtime(idx_path) >= os.path.getmtime(path)):
        with open(idx_path) as fh:
            return json.load(fh)
    offs, isizes = scan_block_table(path)
    cum = np.concatenate([[0], np.cumsum(isizes)])

    def voff(upos: int):
        b = int(np.searchsorted(cum, upos, "right") - 1)
        return [int(offs[b]), int(upos - cum[b])]

    bg = BgzfReader(path)
    upos = 0

    def read_exact(n):
        nonlocal upos
        data = bg.read(n)
        if len(data) != n:
            raise EOFError("truncated BAM while indexing %s" % path)
        upos += n
        return data

    if read_exact(4) != b"BAM\x01":
        raise ValueError("not a BAM file: %s" % path)
    (l_text,) = struct.unpack("<i", read_exact(4))
    read_exact(l_text)
    (n_ref,) = struct.unpack("<i", read_exact(4))
    chroms: List[List] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", read_exact(4))
        name = read_exact(l_name)[:-1].decode("ascii")
        (l_ref,) = struct.unpack("<i", read_exact(4))
        chroms.append([name, l_ref])
    voffs: Dict[str, list] = {}
    while True:
        at = upos
        head = bg.read(4)
        if not head:
            break
        upos += len(head)
        if len(head) < 4:
            raise EOFError("truncated BAM record in %s" % path)
        (block_size,) = struct.unpack("<i", head)
        ref_id = struct.unpack("<i", read_exact(4))[0]
        read_exact(block_size - 4)
        key = str(ref_id)
        if ref_id >= 0 and key not in voffs:
            voffs[key] = voff(at)
    bg.close()
    index = {"chroms": chroms, "voffs": voffs}
    if cache:
        with open(idx_path, "w") as fh:
            json.dump(index, fh)
    return index


def _iter_from(path: str, coff: int, uoff: int):
    """Yield BamRecords starting at virtual offset (coff, uoff)."""
    fh = open(path, "rb")
    fh.seek(coff)
    bg = BgzfReader(fh)
    try:
        if uoff:
            if len(bg.read(uoff)) != uoff:
                raise EOFError("bad virtual offset in %s" % path)
        parse = BamReader._parse_record
        while True:
            head = bg.read(4)
            if not head:
                return
            if len(head) < 4:
                raise EOFError("truncated BAM record in %s" % path)
            (block_size,) = struct.unpack("<i", head)
            buf = bg.read(block_size)
            if len(buf) != block_size:
                raise EOFError("truncated BAM record in %s" % path)
            yield parse(buf)
    finally:
        bg.close()


def _stage1(task):
    """Decode one chromosome's span; mirrors the per-record body of
    pipeline._decode_bam_python (minus the sortedness re-check — the
    index build already walked the file in order)."""
    cid, chrom, coff, uoff = task
    cfg = _G["cfg"]
    candidates = extract.new_candidate_dict()
    census_rows: List[tuple] = []
    allread_rows: List[tuple] = []
    n_records = 0
    for rec in _iter_from(_G["bam"], coff, uoff):
        if rec.ref_id != cid:
            break
        if rec.flag & 0x4:
            continue
        n_records += 1
        pos_start = rec.pos
        pos_end = rec.reference_end
        allread_rows.append((pos_start, pos_end,
                             1 if rec.flag in (0, 16) else 0,
                             rec.qname, chrom))
        if rec.flag in (256, 272):
            continue
        extract.extract_read(rec, candidates, chrom, cfg.min_size,
                             cfg.min_mapq, cfg.max_split_parts,
                             cfg.min_read_len, cfg.min_siglength,
                             cfg.merge_del_threshold,
                             cfg.merge_ins_threshold, cfg.max_size)
        if rec.mapq >= cfg.min_mapq:
            census_rows.append((pos_start, pos_end,
                                1 if rec.flag in (0, 16) else 0,
                                rec.qname, chrom))
    return cid, candidates, census_rows, allread_rows, n_records


def _stage2(svtype):
    """Merge/sort/dedup one SV type's stream -> per-chrom resolver rows
    (process_process_sigs_type, cuteSV:750-857)."""
    rows = sorted(_G["candidates"][svtype], key=sigstore._SORT_KEYS[svtype])
    rows = sigstore._dedup_sorted(rows)
    per_chrom: Dict[str, List[tuple]] = {}
    cidx = sigstore._CHROM_IDX[svtype]
    for r in rows:
        per_chrom.setdefault(r[cidx], []).append(
            sigstore._to_resolver_row(svtype, r))
    return svtype, per_chrom


def _stage34(chrom):
    """Resolve + genotype + format one chromosome (cuteSV stage 3's
    per-(type,chrom) tasks and stage 4's per-chrom output task, fused at
    the reference's own per-chromosome granularity)."""
    from cutesv_tpu_torch.pipeline import resolve_all

    cfg = _G["cfg"]
    store = _G["store"]
    sub = sigstore.SigStore(
        sigs={t: ({chrom: per[chrom]} if chrom in per else {})
              for t, per in store.sigs.items()},
        census=store.census, read_tables=store.read_tables,
        chrom_lengths=store.chrom_lengths, names=None)
    rows = resolve_all(sub, cfg, device=_G["device"]).get(chrom, [])
    fasta = FastaFile(cfg.reference)
    return chrom, vcf.format_chrom_records(cfg, rows,
                                           fasta.fetch_lazy(chrom), chrom)


def run_pool_baseline(cfg, argv: List[str], n_procs: int = 0,
                      device=None) -> dict:
    """Full pooled run; returns the pipeline stats dict. ``cfg`` must use
    the python/host oracle stack (the whole point of the baseline).
    ``device`` (CUDA unless the caller asks for the CPU) is resolved here,
    before any worker forks; a non-host engine on a CUDA device raises,
    because its workers would run the device programs in forked
    children."""
    import time

    if cfg.include_bed is not None:
        raise ValueError("pooled baseline: no --include_bed")
    device = resolve_device(device)
    if cfg.engine != "host" and device.type == "cuda":
        raise ValueError(
            "pooled baseline: engine %r on %s would run the device programs "
            "in forked workers, and a forked child cannot use CUDA; use "
            "engine='host' (the baseline's oracle stack) or device='cpu'"
            % (cfg.engine, device))
    n_procs = n_procs or (os.cpu_count() or 1)
    t0 = time.time()
    index = build_chrom_index(cfg.input)
    chroms = index["chroms"]
    tasks = [(cid, chroms[cid][0], coff, uoff)
             for cid_s, (coff, uoff) in sorted(
                 index["voffs"].items(), key=lambda kv: int(kv[0]))
             for cid in [int(cid_s)]]
    stats: dict = {}

    _G.clear()
    _G["cfg"] = cfg
    _G["bam"] = cfg.input
    _G["device"] = device
    with Pool(min(n_procs, max(len(tasks), 1))) as pool:
        parts = pool.map(_stage1, tasks)
    candidates = extract.new_candidate_dict()
    census_rows: List[tuple] = []
    allread_rows: List[tuple] = []
    n_records = 0
    for _, cand, cen, allr, nr in parts:  # tasks are in file order
        for t in candidates:
            candidates[t].extend(cand[t])
        census_rows.extend(cen)
        allread_rows.extend(allr)
        n_records += nr
    stats["decode_s"] = time.time() - t0
    stats["n_records"] = n_records

    t1 = time.time()
    _G["candidates"] = candidates
    with Pool(min(n_procs, len(sigstore.SVTYPES))) as pool:
        res = pool.map_async(_stage2, sigstore.SVTYPES)
        # the parent builds the census/read tables meanwhile (the
        # reference's 6th pooled "reads" stream)
        store = sigstore.SigStore(
            chrom_lengths={name: length for name, length in chroms})
        grouped: Dict[str, List[tuple]] = {}
        for r in census_rows:
            grouped.setdefault(r[4], []).append(r)
        for chrom, rows in grouped.items():
            store.census[chrom] = dict(
                start=np.array([r[0] for r in rows], np.int64),
                end=np.array([r[1] for r in rows], np.int64),
                is_primary=np.array([r[2] for r in rows], np.int8),
                name=[r[3] for r in rows])
        ag: Dict[str, List[tuple]] = {}
        for r in allread_rows:
            ag.setdefault(r[4], []).append(r)
        for chrom, rows in ag.items():
            store.read_tables[chrom] = ReadTable(
                [r[0] for r in rows], [r[1] for r in rows],
                [r[2] for r in rows], [r[3] for r in rows])
        for svtype, per_chrom in res.get():
            store.sigs[svtype] = per_chrom
    stats["n_sigs"] = {t: sum(len(v) for v in store.sigs[t].values())
                       for t in sigstore.SVTYPES}

    _G.pop("candidates")
    _G["store"] = store
    # chromosomes with any signature stream, in header order (resolution
    # results only ever key chromosomes that have signatures)
    active = [name for name, _ in chroms
              if any(name in store.sigs[t] for t in sigstore.SVTYPES)]
    with Pool(min(n_procs, max(len(active), 1))) as pool:
        emitted = pool.map(_stage34, active)
    stats["resolve_s"] = time.time() - t1

    t2 = time.time()
    per_chrom = dict(emitted)
    stats["n_calls"] = sum(len(v) for v in per_chrom.values())
    references = [(name, length) for name, length in chroms]
    vcf.write_vcf(cfg.output, cfg, per_chrom, references, argv)
    stats["emit_s"] = time.time() - t2
    stats["total_s"] = time.time() - t0
    _G.clear()
    return stats
