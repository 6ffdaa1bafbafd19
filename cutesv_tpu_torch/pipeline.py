"""End-to-end calling pipeline on one GPU.

BAM or CRAM decode (the C++ decoder by default, the Python reader on
request or for a CRAM feature the C++ decoder does not implement) ->
signature store -> resolution (DEL/INS and DUP/INV/TRA clustering on the
device, emission on the host) -> genotype fill (one batched pass of the
CUDA cover-count kernel per int32-safe flush, TRA windows included) ->
VCF. On the device engine the native decode streams (:func:`stream_rule`):
each chromosome's cluster programs are dispatched as soon as the decoder
finishes it, and its DEL/INS emission and genotype run under the
remaining decode.
Under ``--distributed`` (``parallel/distributed.py``) each process
decodes its byte range of the input, the partial decodes are exchanged
and merged, each process resolves its own chromosome bucket on its own
device, and process 0 gathers the rows and writes the VCF.
Every stage of a call is a span of ``utils/trace.py`` (returned as
``stats["trace"]``); ``--profile`` adds the call's ``torch.profiler``
trace of the device, with the spans merged into it.
``--n_shards N`` (device engine) cuts each cluster stream at gaps wider
than the bias and runs the cuts on N devices (``parallel/mesh.py``), and
splits each flush's cover windows over them, one kernel launch per
slice; with fewer than N cards the serial programs run on the run's
device, as the JAX package's do with too few devices. The port of
``cutesv_tpu/pipeline.py``.
"""
from __future__ import annotations

import functools
import logging
import os
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from cutesv_tpu_torch import extract, sigstore, vcf
from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.genotype import (assign_gt_del_ins, call_gt_tra,
                                       cover_counts, gl_table,
                                       support_inter_counts,
                                       threshold_ref_count)
from cutesv_tpu_torch.io import native as native_io
from cutesv_tpu_torch.io.bam import BamReader
from cutesv_tpu_torch.io.fasta import FastaFile
from cutesv_tpu_torch.models import device as device_models
from cutesv_tpu_torch.models import host as host_models
from cutesv_tpu_torch.ops import cover as cover_ops
from cutesv_tpu_torch.ops.cover import cover_counts_cuda
from cutesv_tpu_torch.parallel import mesh as pmesh
from cutesv_tpu_torch.parallel.sharded_cover import make_sharded_cover
from cutesv_tpu_torch.utils import trace
from cutesv_tpu_torch.utils.torchsetup import resolve_device

log = logging.getLogger("cutesv_tpu_torch")


def _shard_plan(cfg: Config, device, shard_devices=None):
    """The device list of a device-engine ``--n_shards`` run
    (``parallel/mesh.py::shard_devices``: ``shard_devices`` when given,
    else :func:`~cutesv_tpu_torch.parallel.mesh.pick_devices`), or None
    for the serial programs. The host engine ignores ``--n_shards``, as
    the JAX package's does."""
    if cfg.engine == "host":
        return None
    return pmesh.shard_devices(cfg.n_shards, device, shard_devices)


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


def decode_bam(cfg: Config, device=None):
    """Stream the BAM or CRAM once, extracting signatures + read census.
    A CRAM is decoded against ``cfg.reference``, its FASTA. Returns
    (store, candidates, records): the store's ``chrom_lengths`` are the
    header's references in header order; ``candidates`` are the Python
    reader's raw signatures (``--write_old_sigs`` writes them), None from
    the C++ decoder.

    ``cfg.decoder`` "native" or "auto": the C++ decoder (native/), built
    with g++ at first use; a failed build or load, or a malformed file,
    raises. A CRAM feature the C++ decoder does not implement (a legacy
    lzma-"alone" block, a CRAM 2.x file: ``NativeUnsupported``) is read
    by the Python reader instead, as in the JAX package; the run logs it
    and reports ``decoder="python"``. Where :func:`stream_rule` says so,
    the native decode streams and dispatches cluster programs on
    ``device`` while it runs. "python": the pure-Python reader, the
    behavioral oracle. The store carries ``decode_breakdown``: which
    decoder ran and, for the native one, its record-walk wall and its
    counters (``io/native.py::COUNTERS``: inflate / record-parse
    core-seconds, the BGZF blocks inflated on the card and on the host,
    the card's batches and launches), plus the early work of a streaming
    decode and the exchange of a ranged one. A BAM's blocks inflate on
    the card of a CUDA ``device``, in zlib threads otherwise."""
    with open(cfg.input, "rb") as probe:
        is_cram = probe.read(4) == b"CRAM"
    if cfg.decoder in ("native", "auto"):
        try:
            store, n_records = _decode_bam_native(cfg, device, is_cram)
            return store, None, n_records
        except native_io.NativeUnsupported as exc:
            log.info("native decoder: %s; using the python reader", exc)
    elif cfg.decoder != "python":
        raise ValueError("unknown decoder %r (use native, python or auto)"
                         % cfg.decoder)
    return _decode_bam_python(cfg)


class StreamRule(NamedTuple):
    """How a native decode runs (:func:`stream_rule`)."""

    # the poll loop snapshots each chromosome as the decoder completes it
    # and dispatches its cluster programs while later ones decode
    stream: bool
    # a DEL/INS chromosome completed before the walk's end runs the full
    # tail there (emission and genotype)...
    tail: bool
    # ... the range's first chromosome too
    tail_first: bool = True
    # ... the final batch's chromosomes too: never by the rule (with no
    # decode left to hide under they keep the batched cover launch);
    # tests substitute the rule to run the tail on fixtures that decode
    # in one poll
    tail_done: bool = False


def stream_rule(cfg: Config, is_cram: bool, byte_range=None) -> StreamRule:
    """How a native decode runs, decided once before it starts from what
    the run can observe. ``byte_range``: this process's range of a
    multi-process ``--distributed`` run (None: the whole file).

    The decode streams on the device engine, but not under force
    calling (``-Ivcf`` uses no early program); a whole-file decode does
    not stream under ``--distributed`` (a run of one process), a ranged
    one streams a BAM only: the JAX package's gate, without its core
    count and its environment. A streaming decode runs the full tail
    unless ``--report_readid`` (the tail renders no read names); a
    ranged one never for its first chromosome past the file's start
    (another range owns its prefix, so its local census may be short,
    and the count fingerprints audit signature streams only) nor for
    its final batch (the range-end chromosome's census may be cut by the
    budget)."""
    if byte_range is None:
        stream = not cfg.distributed
    else:
        stream = not is_cram
    stream = stream and cfg.engine in ("device", "auto") and not cfg.Ivcf
    return StreamRule(stream=stream, tail=stream and not cfg.report_readid,
                      tail_first=byte_range is None or byte_range[0] <= 0)


def _tails(rule: StreamRule, sd, c: int, finished: bool) -> bool:
    """Whether chromosome ``c`` of the streaming decode ``sd`` runs the
    full DEL/INS tail under ``rule``, ``finished``: in the DONE batch."""
    return (rule.tail and (not finished or rule.tail_done)
            and (rule.tail_first or c != sd.range_refids()[0]))


class _NativeBlobView:
    """Lazy view over the native decoder's (append-only) INS sequence
    blob: slicing copies the span under the decoder's merge lock, so
    mid-decode emission can render ALT sequences without materializing
    the blob."""

    def __init__(self, sd):
        self._sd = sd

    def __getitem__(self, sl):
        return self._sd.ins_seq_spans([sl.start], [sl.stop - sl.start])

    def spans(self, offs, lens):
        """Batched span read (one lock acquisition + ctypes call)."""
        return self._sd.ins_seq_spans(offs, lens)


def _stream_tail_emit(sd, cfg: Config, svtype: str, c: int, cols,
                      nk_comp, census_cache, counters):
    """Mid-decode per-chromosome tail for DEL/INS: fetch the cluster
    program's rows, run host emission and (under --genotype) the
    cover/genotype fill, all under the remaining chromosomes' decode.
    Read identities are the decoder's interned name ids (one consistent
    space with the census snapshot); candidate chrom fields carry a
    placeholder patched after join. Byte-identical to the post-decode
    path (same _emit_* / _del_ins_apply functions; the host cover counts
    equal the kernel's). Results are only trusted once the chromosome's
    fingerprint validates against the final arrays. ``counters`` (the
    tail's span counters) receives the genotype windows counted on the
    host."""
    is_ins = svtype == "INS"
    res = device_models._cluster_stream_fetch(nk_comp)
    if res is None:
        return ([], [])
    cid, pos, length, sidx = res
    if is_ins:
        live = ~(((cols["pos"] >> 1) == 0) & (cols["length"] == 0))
        stream = device_models.IndelStream(
            (cols["pos"] >> 1)[live], cols["length"][live],
            cols["name_id"][live], seq_len=cols["seq_len"][live],
            seq_blob=_NativeBlobView(sd), seq_off=cols["seq_off"][live])
    else:
        live = ~((cols["pos"] == 0) & (cols["length"] == 0))
        stream = device_models.IndelStream(
            cols["pos"][live], cols["length"][live], cols["name_id"][live])
    emit = device_models._emit_ins if is_ins else device_models._emit_del
    thr = (cfg.diff_ratio_merging_INS if is_ins
           else cfg.diff_ratio_merging_DEL)
    bias = (cfg.max_cluster_bias_INS if is_ins
            else cfg.max_cluster_bias_DEL)
    cands, jobs = emit(cid, pos, length, sidx, stream, None, thr, bias,
                       min(cfg.min_support, 5), cfg.remain_reads_ratio,
                       cfg.genotype, need_names=False)
    if cfg.genotype and cands:
        census = census_cache.get(c)
        if census is None:
            s = sd.snapshot("CEN", c)
            census = census_cache[c] = dict(
                start=s["start"], end=s["end"],
                is_primary=s["is_primary"].astype(np.int8),
                name=s["name"])
        if len(census["start"]) == 0:
            return ([], [])  # the batched pass's empty-chrom contract
        prim = census["is_primary"] == 1
        covers = cover_counts([j["window"] for j in jobs],
                              census["start"][prim], census["end"][prim])
        counters["windows"] = len(jobs)
        _del_ins_apply(None, cands, jobs, census, [covers])
    return (cands, [])


# the poll loop's longest sleep in the decoder: a guard against a lost
# wake-up only, since every progress store wakes it
_WAIT_GUARD_MS = 100


def _streaming_poll_loop(sd, cfg: Config, device, rule: StreamRule):
    """Poll/dispatch loop of a streaming decode: as each chromosome
    completes, snapshot its rows, sort/dedup them with the store's exact
    keys and dispatch its cluster programs on ``device`` (plus, where
    ``rule`` says so, the full mid-decode DEL/INS tail). Runs until the
    decode thread reports DONE; the caller joins and validates
    fingerprints. A failing dispatch or tail raises: there is no
    fallback to a plain decode.

    Between passes the loop sleeps in the decoder until the next
    chromosome completes (``sd.wait``), so none waits undispatched. A
    pass compacts the previous pass's programs after dispatching its
    own, so their counts are on the host by then and the compaction
    does not wait on the device; a pass after which no newer chromosome
    has completed compacts its own before it sleeps.

    Spans: ``decode.dispatch`` around each chromosome's snapshot,
    prepare and program dispatch (counter ``chroms`` = 1), around each
    program's compaction (which reads its count from the device) and
    around the DONE batch's prefetch of the counts; ``decode.tail``
    around each full tail; the spans of the programs the DONE batch
    dispatched carry the counter ``done`` = 1.

    Returns (handles, fingerprints, early_results), each keyed
    (svtype, chrom_id)."""
    handles: Dict[tuple, object] = {}
    fingerprints: Dict[tuple, dict] = {}
    early_results: Dict[tuple, tuple] = {}
    census_cache: Dict[int, dict] = {}
    done = set()

    def dispatch(c):
        """Snapshot chromosome ``c``'s rows and dispatch its programs."""
        pending = []
        for svtype, is_ins, bias in (
                ("DEL", False, cfg.max_cluster_bias_DEL),
                ("INS", True, cfg.max_cluster_bias_INS)):
            snap = sd.snapshot(svtype, c)
            if len(snap["pos"]) == 0:
                continue
            fp, disp = sigstore.prepare_snapshot(snap, is_ins)
            stream = device_models.IndelStream(
                disp["pos"], disp["length"], disp["rid"])
            handle = device_models._cluster_stream_dispatch(
                stream, cfg.min_support, bias, device)
            pending.append((svtype, c, "indel", handle))
            fingerprints[(svtype, c)] = fp
        for svtype, is_inv, bias in (
                ("DUP", False, cfg.max_cluster_bias_DUP),
                ("INV", True, cfg.max_cluster_bias_INV)):
            snap = sd.snapshot(svtype, c)
            if len(snap["pos"]) == 0:
                continue
            fp, disp = sigstore.prepare_snapshot_pair(svtype, snap)
            handle = device_models._pair_cluster_start(
                disp["k1"], disp["k2"], disp["aux"], disp["keys"],
                cfg.min_support, bias, is_inv, device)
            pending.append((svtype, c, "pair", handle))
            fingerprints[(svtype, c)] = fp
        return pending

    def compact(item):
        # mid-decode, blocking here for n_kept and starting the
        # compaction + host copy costs the decode nothing (it runs on
        # native threads); resolve later finds the rows local
        _, _, kind, handle = item
        if kind == "pair":
            nk_comp = device_models._pair_cluster_compact(handle)
        else:
            nk_comp = device_models._cluster_stream_compact(handle)
        if nk_comp is not None and nk_comp[1] is not None:
            device_models._start_host_copies(nk_comp[1])
        return nk_comp

    def finish(item, nk_comp, finished):
        svtype, c, kind, _ = item
        if kind == "indel" and _tails(rule, sd, c, finished):
            # chromosomes completed before end-of-decode run the FULL
            # tail here (emission + genotype), under the remaining
            # decode; the final batch keeps the batched kernel cover
            # path (no decode left to hide under, and one kernel launch
            # beats per-chromosome sweeps). The program output is
            # consumed by the tail.
            with trace.span("decode.tail", done=int(finished),
                            windows=0) as counters:
                res = _stream_tail_emit(sd, cfg, svtype, c,
                                        fingerprints[(svtype, c)], nk_comp,
                                        census_cache, counters)
            early_results[(svtype, c)] = res
        else:
            handles[(svtype, c)] = nk_comp

    def settle(items):
        """Compact and finish ``items``: (program, dispatched in the
        DONE batch) pairs."""
        for item, at_done in items:
            with trace.span("decode.dispatch", done=int(at_done)):
                nk_comp = compact(item)
            finish(item, nk_comp, at_done)

    carry = []   # the previous pass's programs, not yet compacted
    p = sd.poll()
    while True:
        finished = p == sd.DONE
        if finished:
            # the run finished: every remaining chromosome's rows are
            # final, so snapshot them too — their prepared columns
            # become the store streams (no global re-sort) and their
            # cluster programs dispatch before the store is built
            p = sd.n_refs()
        pending = []
        for c in range(0, p):
            if c in done:
                continue
            done.add(c)
            with trace.span("decode.dispatch", done=int(finished), chroms=1):
                pending += [(item, finished) for item in dispatch(c)]
        if finished and (carry or pending):
            # decode is over, so blocking reads are no longer hidden:
            # start every n_kept copy before the compact phase blocks on
            # any of them
            with trace.span("decode.dispatch", done=1):
                device_models.prefetch_counts(
                    *[item[3] for item, _ in carry + pending])
        settle(carry)
        carry = pending
        if finished or sd.poll() == p:
            # nothing newer to dispatch: compact now, not after the sleep
            settle(carry)
            carry = []
        if finished:
            return handles, fingerprints, early_results
        p = sd.wait(p, _WAIT_GUARD_MS)


def _attach_early_to_store(store, nd, handles, early_results) -> None:
    """Keep the early program handles / full-tail results whose
    fingerprints validated against the final arrays; patch the tails'
    chromosome-name placeholders. A chromosome that did not validate (a
    late SA row changed it) is resolved again after the join, on the
    same device."""
    valid = getattr(store, "early_valid", set())
    store.early_kernels = {
        (t, nd.chroms[c]): h for (t, c), h in handles.items()
        if (t, nd.chroms[c]) in valid}
    store.early_results = {}
    for (t, c), res in early_results.items():
        chrom = nd.chroms[c]
        if (t, chrom) not in valid:
            continue  # a late SA row invalidated the chromosome
        for cand in res[0]:
            cand[0] = chrom  # placeholder patched now the name is known
        store.early_results[(t, chrom)] = res
    n_early = len(handles) + len(early_results)
    log.info("streaming decode: %d early kernels + %d full tails "
             "validated of %d dispatched"
             % (len(store.early_kernels), len(store.early_results),
                n_early))


def _bed_ids(cfg: Config, is_cram: bool):
    """``--include_bed``'s padded regions as the C++ decoder's (chr_id,
    start, end) arrays in header chrom-id space, or None."""
    if cfg.include_bed is None:
        return None
    bed = load_bed_regions(cfg.include_bed)
    # map chrom names to header ids via a cheap header-only read
    if is_cram:
        from cutesv_tpu_torch.io.cram import CramReader
        header = CramReader(cfg.input, reference=cfg.reference or None)
    else:
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
    return (np.array(bc, np.int32), np.array(bs, np.int64),
            np.array(be, np.int64))


def _decode_bam_native(cfg: Config, device, is_cram: bool):
    """The C++ decoder's run, on its own thread: over the whole file, or
    over this process's byte range of a multi-process ``--distributed``
    run (BGZF blocks for a BAM, containers for a CRAM), whose partial
    decodes are then exchanged and merged
    (``parallel/distributed.py::exchange_decodes``); beside it, where
    :func:`stream_rule` says so, the poll loop. Returns (store,
    records).

    Streaming: as each chromosome completes, the loop snapshots its rows,
    sorts/dedups them with the store's exact keys (local name/seq ranks
    are order-isomorphic to the final global ranks restricted to the
    same rows) and dispatches its cluster programs. After the join (and
    the merge) the store validates each snapshot fingerprint against the
    final rows (a later read's SA tag, or another range, can add
    signatures to an already-passed chromosome) and only validated
    chromosomes reuse the early work; resolve re-dispatches the rest. A
    ranged decode first remaps its snapshot columns into the merged
    name-id / sequence-blob spaces.

    Collective discipline: every process of a ranged decode runs the
    exchange exactly once. A local failure raises before it (there is no
    fallback); the failing process's exit closes its gloo sockets, so its
    peers' allgather raises rather than waits."""
    native_io.get_lib()  # a failed decoder build raises before the device
    device = resolve_device(device)
    rng = None
    if cfg.distributed:
        from cutesv_tpu_torch.parallel import distributed as dist
        n, k = dist.process_count(), dist.process_index()
        if n > 1:
            plan = (dist.plan_cram_shard_ranges if is_cram
                    else dist.plan_shard_ranges)
            ranges = plan(cfg.input, n)
            rng = ranges[k][:2]
    rule = stream_rule(cfg, is_cram, rng)
    # a CRAM is read with its FASTA; a BAM's BGZF blocks inflate on the
    # card of a CUDA device
    sd = native_io.StreamingDecode(
        cfg.input, cfg, _bed_ids(cfg, is_cram),
        cfg.reference if is_cram else None, rng,
        device=None if is_cram else device)
    early = None
    try:
        if rule.stream:
            early = _streaming_poll_loop(sd, cfg, device, rule)
    except BaseException:
        sd.free()
        raise
    with trace.span("decode.join"), sd:  # the join, then the decoder's free
        nd = sd.join()
    if rng is None:
        return _finish_native(nd, nd, early), nd.n_records
    log.info("sharded decode: shard %d/%d decoded %d records, walk %.2fs%s",
             k, n, nd.n_records, nd.walk_s,
             " (streaming)" if rule.stream else "")
    gather: dict = {}
    merged = dist.exchange_decodes(nd, ranges, gather)
    if early is not None:
        # the snapshot columns' name ids and blob offsets, into the merged
        # decode's spaces
        handles, fingerprints, early_results = early
        remap = merged.part_name_remaps[k]
        blob_base = merged.part_blob_bases[k]
        moved = {}
        for key, fp in fingerprints.items():
            fp = dict(fp)
            if "name_id" in fp:
                fp["name_id"] = remap[fp["name_id"]]
            if "seq_off" in fp:
                fp["seq_off"] = fp["seq_off"] + blob_base
            moved[key] = fp
        early = handles, moved, early_results
    store = _finish_native(
        merged, nd, early, sharded=True, shard=k, shards=n,
        shard_records=nd.n_records, allgather_mb=gather["local_mb"],
        allgather_total_mb=gather["total_mb"], allgather_s=gather["seconds"])
    store.part_census_counts = merged.part_census_counts
    return store, merged.n_records


def _finish_native(nd, walk, early, **exchange) -> sigstore.SigStore:
    """The store of a joined native decode ``nd`` (this process's, or a
    ranged decode's merged one) with the poll loop's ``early`` work
    (:func:`_streaming_poll_loop`'s, its fingerprints in ``nd``'s
    spaces; None for a plain decode) validated and attached: the
    sortedness check, the store and ``decode_breakdown``. ``walk``: the
    decode this process's decoder ran (``nd`` itself, or its part of
    ``nd``), whose walk is the span ``decode.walk`` and whose wall and
    counters the breakdown reports, with ``exchange``, a ranged decode's
    shard and allgather, and the early work's counts."""
    _walk_span(walk)
    _check_coordinate_sorted(nd.arrays["all_chr"], nd.arrays["all_start"],
                             nd.chroms)
    breakdown = dict(decoder="native", streaming=early is not None,
                     walk_s=walk.walk_s, **native_io.counters(walk),
                     **exchange)
    if early is None:
        store = _build_store(nd)
    else:
        handles, fingerprints, early_results = early
        store = _build_store(nd, early={
            (t, nd.chroms[c]): fp for (t, c), fp in fingerprints.items()})
        _attach_early_to_store(store, nd, handles, early_results)
        breakdown.update(early_dispatched=len(handles) + len(early_results),
                         early_kernels=len(store.early_kernels),
                         early_tails=len(store.early_results))
    store.decode_breakdown = breakdown
    return store


def _walk_span(nd) -> None:
    """The native decoder's record walk as the span ``decode.walk`` (its
    own start and end on the epoch clock, on the decoder's thread) with
    its records and the decoder's counters (``io/native.py::COUNTERS``:
    core-seconds, the BGZF blocks that the card and the zlib threads
    inflated, the header's too, and the card's batches and launches);
    none when the walk did not run."""
    if nd.walk_t1_ns > nd.walk_t0_ns > 0:
        trace.add_span("decode.walk", nd.walk_t0_ns, nd.walk_t1_ns,
                       "decoder", records=nd.n_records,
                       **native_io.counters(nd))


def _n_sigs(store) -> Dict[str, int]:
    return {t: sum(len(v) for v in store.sigs[t].values())
            for t in sigstore.SVTYPES}


def _build_store(nd, early=None) -> sigstore.SigStore:
    """``sigstore.build_store_native`` as the span ``store``, with the
    signatures per type."""
    with trace.span("store") as counters:
        store = sigstore.build_store_native(nd, early=early)
        counters.update(("signatures." + t, n)
                        for t, n in _n_sigs(store).items())
    return store


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
    from cutesv_tpu_torch.io.cram import open_alignment_file

    candidates = extract.new_candidate_dict()
    census_rows: List[tuple] = []
    allread_rows: List[tuple] = []
    bed = load_bed_regions(cfg.include_bed)
    reader = open_alignment_file(cfg.input, reference=cfg.reference or None)
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
    return store, candidates, n_records


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
    Each sink(counts) receives its windows' counts.

    The pass is the span ``genotype``, each flush the span
    ``genotype.flush`` (its windows, reads and kernel launches, and among
    its windows those of the DUP/INV two-window specs, ``windows_pair``,
    and of the extra blocks, ``windows_tra``; an extra block counted on
    the host rides no flush)."""
    with trace.span("genotype"):
        cover = cover_fn or cover_counts
        state = dict(offset=0, windows=[], starts=[], ends=[], spans=[],
                     extras=[])

        def flush():
            if state["spans"] or state["extras"]:
                wins = state["windows"]
                starts = np.concatenate(state["starts"])
                launches = cover_ops.LAUNCHES
                # the DUP/INV specs' windows (two breakpoints and their
                # hull a job) and the TRA extra blocks' windows
                pair = sum(m for si, _, ranges in state["spans"]
                           if specs[si][1] is _two_window_groups
                           for _, m in ranges)
                tra = sum(m for _, m, _ in state["extras"])
                with trace.span("genotype.flush", windows=len(wins),
                                reads=len(starts), windows_pair=pair,
                                windows_tra=tra) as fc:
                    allc = cover(wins, starts, np.concatenate(state["ends"]))
                    fc["launches"] = cover_ops.LAUNCHES - launches
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


def _tra_cover_prepare(per_chrom: Dict[str, tuple], store, cfg: Config):
    """Batched TRA genotyping (call_gt_tra, cuteSV_resolveTRA.py:260-309),
    riding the shared cover-kernel launch: returns (extra_blocks,
    finalize) for :func:`_batched_cover_multi` — the strict covering
    counts of every candidate's two breakpoint windows are counted in the
    SAME launch as the DEL/INS/DUP/INV genotype windows. The reference's
    early-exit semantics — the gt_round iteration cap and the
    threshold_ref_count bound, both order-sensitive — are detected with
    cheap searchsorted prechecks, and only candidates that could hit them
    (or whose read tables carry ambiguous primary names) replay the exact
    per-candidate host loop. Byte-identical to the inline path."""
    jobs: List[dict] = []
    for chrom, (cands, js) in per_chrom.items():
        for j in js:
            j["chr1"] = chrom
            jobs.append(j)
    if not jobs:
        return [], lambda: None
    tables = store.read_tables
    lengths = store.chrom_lengths
    bias = cfg.max_cluster_bias_TRA

    # the fast path requires globally-unambiguous primary names (each name
    # has at most one primary record across all tables): then row counts
    # equal distinct-name counts and the two windows' covering sets are
    # disjoint
    names_ok = getattr(store, "_tra_prim_unique", None)
    if names_ok is None:
        parts = [np.asarray(t.names)[np.asarray(t.prim) == 1]
                 for t in tables.values()]
        total = sum(len(p) for p in parts)
        cat = (np.concatenate(parts) if total
               else np.array([], np.int64))
        names_ok = bool(len(np.unique(cat)) == total)
        store._tra_prim_unique = names_ok

    # cached on the store: derived views of the read tables
    info: Dict[str, Optional[dict]] = getattr(store, "_tra_tinfo", None)
    if info is None:
        info = store._tra_tinfo = {}

    def tinfo(chrom):
        if chrom in info:
            return info[chrom]
        t = tables.get(chrom)
        if t is None:
            info[chrom] = None
        else:
            starts = np.asarray(t.start)
            prim = np.asarray(t.prim) == 1
            ps = starts[prim]
            pe = np.asarray(t.end)[prim]
            # file order on a coordinate-sorted BAM IS start order, so
            # the precheck's sorted-starts view needs no re-sort
            if starts.size < 2 or np.all(starts[1:] >= starts[:-1]):
                as_sorted = starts
            else:
                as_sorted = np.sort(starts)
            info[chrom] = dict(ps=ps, pe=pe,
                               # ALL rows, not just primaries: the
                               # gt_round cap fires on a primary's fetch
                               # POSITION among every overlapping row
                               # (secondary/supplementary included), so
                               # the conservative no-cap precheck needs
                               # the total overlap count
                               as_sorted=as_sorted,
                               ae_sorted=np.sort(np.asarray(t.end)),
                               census=dict(start=starts,
                                           end=np.asarray(t.end),
                                           is_primary=np.asarray(t.prim),
                                           name=np.asarray(t.names)))
        return info[chrom]

    # per-job windows; group (job, which-window) pairs by chromosome
    win_by_chrom: Dict[str, List[tuple]] = {}
    resolvable = np.zeros(len(jobs), bool)
    for k, j in enumerate(jobs):
        if j["chr1"] not in lengths or j["chr2"] not in lengths:
            continue
        resolvable[k] = True
        for which, (chrom, pos) in enumerate(
                ((j["chr1"], j["pos1"]), (j["chr2"], j["pos2"]))):
            s = max(int(pos) - bias, 0)
            e = min(int(pos) + bias, lengths[chrom])
            win_by_chrom.setdefault(chrom, []).append((k, which, s, e))

    # ---- covering counts ride the SHARED cover-kernel launch -----------
    # strict covering (start < s and end > e, count_coverage's test) is
    # the kernel's non-strict test on the (s-1, e+1) window
    covers = np.zeros((len(jobs), 2), np.int64)
    inters = np.zeros((len(jobs), 2), np.int64)
    overlaps = np.zeros((len(jobs), 2), np.int64)
    blocks = []

    def make_sink(ks, ws):
        def sink(counts):
            covers[ks, ws] = np.asarray(counts, np.int64)
        return sink

    for chrom, wl in win_by_chrom.items():
        ti = tinfo(chrom)
        if ti is None or len(ti["ps"]) == 0:
            continue
        m = len(wl)
        ks = np.fromiter((k for k, _, _, _ in wl), np.int64, m)
        ws = np.fromiter((w for _, w, _, _ in wl), np.int64, m)
        ss = np.fromiter((s for _, _, s, _ in wl), np.int64, m)
        es = np.fromiter((e for _, _, _, e in wl), np.int64, m)
        # searchsorted precheck inputs: ALL rows overlapping the fetch
        # window (#start < e minus #end <= s). count_coverage's
        # iteration cap fires when a primary row's position among every
        # fetched row reaches gt_round, so fewer than gt_round TOTAL
        # overlapping rows is the conservative no-cap guarantee (a
        # primary-only count misses caps behind secondary pileups)
        overlaps[ks, ws] = (
            np.searchsorted(ti["as_sorted"], es, "left")
            - np.searchsorted(ti["ae_sorted"], ss, "right"))
        shifted = np.stack([ss - 1, es + 1], axis=1)
        blocks.append(dict(
            windows=list(map(tuple, shifted.tolist())),
            starts=ti["ps"], ends=ti["pe"], sink=make_sink(ks, ws)))
        # support-covering counts (vectorized; strict via shifted window)
        supports = [jobs[k]["support"] for k, _, _, _ in wl]
        inter = support_inter_counts(ti["census"], supports,
                                     [shifted.tolist()])
        inters[ks, ws] = np.asarray(inter, np.int64)

    def finalize():
        # fast path or exact replay, after the pass filled ``covers``
        table = gl_table()
        stats = dict(fast=0, replay=0, unresolvable=0)
        for k, j in enumerate(jobs):
            cand = j["cand"]
            if not resolvable[k]:
                # SA-tag contig absent from the header (call_gt_tra's
                # degraded "unresolvable" genotype)
                dr, gt, gl, gq, qual = ".", "./.", ".,.,.", ".", "."
                stats["unresolvable"] += 1
            else:
                support = j["support"]
                up_bound = threshold_ref_count(len(support))
                c1, c2 = int(covers[k, 0]), int(covers[k, 1])
                fast = (names_ok
                        and int(overlaps[k, 0]) < cfg.gt_round
                        and int(overlaps[k, 1]) < cfg.gt_round
                        and c1 < up_bound and c1 + c2 < up_bound)
                if fast:
                    dr = ((c1 - int(inters[k, 0]))
                          + (c2 - int(inters[k, 1])))
                    gt, gl, gq, qual = table.lookup(dr, len(support))
                    stats["fast"] += 1
                else:
                    _, dr, gt, gl, gq, qual = call_gt_tra(
                        tables, lengths, j["pos1"], j["pos2"], j["chr1"],
                        j["chr2"], support, bias, cfg.gt_round)
                    stats["replay"] += 1
            cand[6] = str(dr)
            cand[7] = str(gt)
            cand[8] = str(gl)
            cand[9] = str(gq)
            cand[10] = str(qual)
        store.tra_cover_stats = stats

    return blocks, finalize


def _tra_cover_pass(per_chrom: Dict[str, tuple], store, cfg: Config,
                    cover_fn=None) -> None:
    """Standalone form of the batched TRA genotype pass; the pipeline
    rides the shared cover launch instead."""
    blocks, finalize = _tra_cover_prepare(per_chrom, store, cfg)
    _batched_cover_multi([], store, cover_fn, extra_blocks=blocks)
    finalize()


def resolve_all(store: sigstore.SigStore, cfg: Config, device=None,
                shard_devices=None) -> Dict[str, List]:
    """Cluster + genotype every chromosome; returns chrom -> candidate rows
    in the reference's DEL, INS, INV, DUP, TRA submission order.

    ``cfg.engine`` "device"/"auto": every cluster program (DEL/INS per
    int32-safe batch, DUP/INV/TRA per chromosome) is dispatched on
    ``device`` before any is fetched, reusing the streaming decode's
    validated early programs (``store.early_kernels``) and skipping the
    chromosomes whose full tail already ran (``store.early_results``).
    Genotypes count their covers in one batched pass: one CUDA kernel
    launch per int32-safe flush (the plain version on a CPU device) for
    the DUP/INV windows and, on a native (rank-keyed) store, the DEL/INS
    and TRA windows too. On a Python store DEL/INS genotypes count per
    chromosome and TRA genotypes stay inline, as in the JAX package.
    With ``cfg.n_shards`` > 1 and a shard device list (:func:`_shard_plan`)
    the cluster programs of every chromosome without an early program run
    on gap-aligned cuts, one per device, and each cover flush launches
    once per device's slice of its windows.
    "host": the numpy oracle for every type, host cover counts.

    Counters: ``resolve.pair`` has, per type, the signatures in
    (``sigs_DUP``, ``sigs_INV``), the cluster slices the device engine's
    host finish walks (``clusters_DUP``, ``clusters_INV``) and the
    candidates out (``records_DUP``, ``records_INV``); the first
    ``resolve.tra`` the same of TRA (``sigs``, ``clusters``,
    ``records``), the second (the TRA genotypes' finalize, after the
    cover pass) none. The host engine walks no cluster slices, so its
    spans carry no ``clusters`` counters."""
    device = resolve_device(device)
    devices = _shard_plan(cfg, device, shard_devices)
    shard = dict(n_shards=len(devices) if devices else 1,
                 shard_devices=devices)
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
        with trace.span("resolve.programs"):
            early_k = getattr(store, "early_kernels", None) or {}
            # chromosomes whose FULL tail (emission + genotype) already ran
            # during the streaming decode skip resolution entirely
            early_res = getattr(store, "early_results", None) or {}
            del_state = device_models.resolve_indel_multi_start(
                [(c, s) for c, s in sig["DEL"].items()
                 if ("DEL", c) not in early_res], False, cfg.min_support,
                cfg.max_cluster_bias_DEL, device,
                early={c: h for (t, c), h in early_k.items() if t == "DEL"},
                **shard)
            ins_state = device_models.resolve_indel_multi_start(
                [(c, s) for c, s in sig["INS"].items()
                 if ("INS", c) not in early_res], True, cfg.min_support,
                cfg.max_cluster_bias_INS, device,
                early={c: h for (t, c), h in early_k.items() if t == "INS"},
                **shard)

            def pair_state(svtype, chrom, sigs, is_inv, bias):
                # reuse the streaming decode's early pair program (already
                # compacted and copying to the host) when it validated
                h = early_k.get((svtype, chrom))
                if h is not None:
                    return ("pending", h)
                return device_models.resolve_pair_start(
                    sigs, is_inv, cfg.min_support, bias, device, **shard)

            inv_states = {
                chrom: pair_state("INV", chrom, sigs, True,
                                  cfg.max_cluster_bias_INV)
                for chrom, sigs in sig["INV"].items()}
            dup_states = {
                chrom: pair_state("DUP", chrom, sigs, False,
                                  cfg.max_cluster_bias_DUP)
                for chrom, sigs in sig["DUP"].items()}
            tra_states = {
                chrom: device_models.resolve_tra_start(
                    sigs, cfg.min_support, cfg.max_cluster_bias_TRA, device,
                    **shard)
                for chrom, sigs in sig["TRA"].items()}
            device_models.prefetch_counts(
                del_state, ins_state, *inv_states.values(),
                *dup_states.values(), *tra_states.values())
            device_models.resolve_indel_multi_compact(del_state)
            device_models.resolve_indel_multi_compact(ins_state)
            inv_states = {c: device_models.resolve_pair_compact(s)
                          for c, s in inv_states.items()}
            dup_states = {c: device_models.resolve_pair_compact(s)
                          for c, s in dup_states.items()}
            tra_states = {c: device_models.resolve_tra_compact(s)
                          for c, s in tra_states.items()}
            device_models.prefetch_to_host(
                del_state, ins_state, *inv_states.values(),
                *dup_states.values(), *tra_states.values())
        with trace.span("resolve.indel"):
            del_res = device_models.resolve_indel_multi_finish(
                del_state, cfg.diff_ratio_merging_DEL, min_sup5,
                cfg.remain_reads_ratio, action, need_names=cfg.report_readid)
            ins_res = device_models.resolve_indel_multi_finish(
                ins_state, cfg.diff_ratio_merging_INS, min_sup5,
                cfg.remain_reads_ratio, action, need_names=cfg.report_readid)
            for (t, c), res in early_res.items():
                (del_res if t == "DEL" else ins_res)[c] = res
        cover_fn = (make_sharded_cover(shard["n_shards"], devices)
                    or functools.partial(cover_counts_cuda, device=device))
    else:
        def rows_of(sigs):
            # native columnar stream -> resolver tuple rows
            return sigs.tuples() if hasattr(sigs, "tuples") else sigs
        with trace.span("resolve.indel"):
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
    with trace.span("resolve.pair") as counters:
        inv_res, dup_res = {}, {}
        walked = {"INV": [], "DUP": []}
        for chrom, sigs in sig["INV"].items():
            if use_device:
                inv_res[chrom] = device_models.resolve_pair_finish(
                    inv_states[chrom], sigs, True, chrom, cfg.min_support,
                    cfg.max_cluster_bias_INV, cfg.min_size, cfg.max_size,
                    action, names=names, clusters_out=walked["INV"])
            else:
                inv_res[chrom] = host_models.resolve_inv(
                    sigs, chrom, cfg.min_support, cfg.max_cluster_bias_INV,
                    cfg.min_size, cfg.max_size, action, names=names)
        for chrom, sigs in sig["DUP"].items():
            if use_device:
                dup_res[chrom] = device_models.resolve_pair_finish(
                    dup_states[chrom], sigs, False, chrom, cfg.min_support,
                    cfg.max_cluster_bias_DUP, cfg.min_size, cfg.max_size,
                    action, names=names, clusters_out=walked["DUP"])
            else:
                dup_res[chrom] = host_models.resolve_dup(
                    sigs, chrom, cfg.min_support, cfg.max_cluster_bias_DUP,
                    cfg.min_size, cfg.max_size, action, names=names)
        for svtype, res in (("DUP", dup_res), ("INV", inv_res)):
            counters["sigs_" + svtype] = sum(map(len, sig[svtype].values()))
            if use_device:
                counters["clusters_" + svtype] = sum(walked[svtype])
            counters["records_" + svtype] = sum(len(r[0])
                                                for r in res.values())
    # TRA resolution happens BEFORE the cover pass so its genotype
    # windows ride the same kernel launch (candidates and logs still emit
    # in the reference's DEL, INS, INV, DUP, TRA order below)
    tra_batch = action and use_device and names is not None
    tra_res: Dict[str, tuple] = {}
    tra_out: Dict[str, list] = {}
    tra_finalize = None
    tra_blocks = []
    with trace.span("resolve.tra") as counters:
        walked_tra: List[int] = []
        for chrom, sigs_t in sig["TRA"].items():
            if use_device:
                jobs_t: Optional[list] = [] if tra_batch else None
                tra_out[chrom] = device_models.resolve_tra_finish(
                    tra_states.get(chrom), sigs_t, chrom, cfg.min_support,
                    cfg.diff_ratio_filtering_TRA, cfg.max_cluster_bias_TRA,
                    store.read_tables, store.chrom_lengths, action,
                    cfg.gt_round, names=names, jobs_out=jobs_t,
                    clusters_out=walked_tra)
                if tra_batch:
                    tra_res[chrom] = (tra_out[chrom], jobs_t)
            else:
                tra_out[chrom] = host_models.resolve_tra(
                    sigs_t, chrom, cfg.min_support,
                    cfg.diff_ratio_filtering_TRA, cfg.max_cluster_bias_TRA,
                    store.read_tables, store.chrom_lengths, action,
                    cfg.gt_round, names=names)
        counters["sigs"] = sum(map(len, sig["TRA"].values()))
        if use_device:
            counters["clusters"] = sum(walked_tra)
        counters["records"] = sum(map(len, tra_out.values()))
        if tra_batch:
            tra_blocks, tra_finalize = _tra_cover_prepare(tra_res, store,
                                                          cfg)
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
    if specs or tra_blocks:
        _batched_cover_multi(specs, store, cover_fn,
                             extra_blocks=tra_blocks)
    if tra_finalize is not None:
        with trace.span("resolve.tra"):
            tra_finalize()
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


def _filter_store_chroms(store: sigstore.SigStore, keep) -> sigstore.SigStore:
    """Shallow copy of the store with signature streams restricted to the
    chromosomes ``keep(chrom)`` selects. Census/read tables stay complete:
    TRA genotyping replays coverage on the mate chromosome too."""
    out = sigstore.SigStore(
        sigs={t: {c: v for c, v in per.items() if keep(c)}
              for t, per in store.sigs.items()},
        census=store.census, read_tables=store.read_tables,
        chrom_lengths=store.chrom_lengths, names=store.names)
    # early programs / full-tail results follow their chromosome's owner
    # (a dropped chromosome's early work is simply unused on this process)
    for attr in ("early_kernels", "early_results"):
        src = getattr(store, attr, None)
        if src:
            setattr(out, attr, {(t, c): v for (t, c), v in src.items()
                                if keep(c)})
    return out


def _bucket_plan(store: sigstore.SigStore, n: int) -> Dict[str, int]:
    """Chromosome -> process plan of an ``n``-process run, derived from
    the exchanged decode and the merged store, so identical on every
    process with no communication: range-affine (each chromosome
    resolves on the process whose decode range produced most of its
    census rows, so its mid-decode tails land in that process's own
    bucket) when the store's part counts come from ``n`` parts, LPT
    otherwise (a --resume with another --num_processes, or a store with
    no part counts)."""
    from cutesv_tpu_torch.parallel.distributed import (
        assign_chroms_by_decode_range, assign_chroms_lpt)

    pcc = getattr(store, "part_census_counts", None)
    if pcc and len(pcc) == n:
        return assign_chroms_by_decode_range(pcc, store, n)
    return assign_chroms_lpt(store, n)


def _gather_results(results: Dict[str, List], info: dict = None):
    """Multi-host merge: allgather each process's per-chromosome candidate
    rows onto every process; process 0 returns the merged dict, the
    others return None and skip the VCF emit (the reference's stage 4 is
    serial too, cuteSV:1218-1247). ``info`` receives the allgather's
    sizes and seconds."""
    from cutesv_tpu_torch.parallel.distributed import (allgather_obj,
                                                       is_emitter)

    parts = allgather_obj(results, info)
    if not is_emitter():
        return None
    merged: Dict[str, List] = {}
    for part in parts:
        for chrom, rows in part.items():
            merged.setdefault(chrom, []).extend(rows)
    return merged


def _write_profile(cfg: Config, prof, recorded: dict) -> str:
    """The call's profile, ``work_dir/torch_trace/run.json`` (chrome trace
    format): ``prof``'s device operations (None on a CPU device, which
    has none) with the spans of ``recorded`` (``stats["trace"]``) merged
    in as host events. Returns the path."""
    trace_dir = os.path.join(cfg.work_dir, "torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "run.json")
    device_path = None
    if prof is not None:
        device_path = os.path.join(trace_dir, "device.json")
        prof.export_chrome_trace(device_path)
    trace.merge_chrome_trace(recorded, path, device_path)
    if device_path is not None:
        os.remove(device_path)
    log.info("Profiler trace written to %s" % path)
    return path


def _span_stats(spans: List[dict]) -> dict:
    """The stage times of a call, from its spans: ``decode_s`` (the
    decode span, which holds the store), ``resolve_s``, ``emit_s``,
    ``total_s`` (the call) and, for a native decode, its split:
    ``native_s`` (decode start to the end of ``decode.join``, the
    decoder's join and free), ``store_s`` (the rest of decode: the
    exchange of a multi-process decode, the sortedness check, the store,
    attaching the early work),
    ``overlap_work_s`` / ``done_tail_s`` (a streaming decode's poll loop's
    dispatch and tail spans before / in the DONE batch; 0 for a plain
    one) and ``tail_windows`` (the genotype windows the mid-decode tails
    counted on the host)."""
    out = dict(decode_s=trace.seconds(spans, "decode"),
               resolve_s=trace.seconds(spans, "resolve"),
               emit_s=trace.seconds(spans, "emit"),
               total_s=trace.seconds(spans, "call"))
    joins = [s for s in spans if s["name"] == "decode.join"]
    decode = [s for s in spans if s["name"] == "decode"]
    if joins and decode:
        out.update(
            native_s=(joins[0]["t1_ns"] - decode[0]["t0_ns"]) / 1e9,
            store_s=(decode[0]["t1_ns"] - joins[0]["t1_ns"]) / 1e9,
            overlap_work_s=sum(trace.seconds(spans, n, done=0) for n in
                               ("decode.dispatch", "decode.tail")),
            done_tail_s=sum(trace.seconds(spans, n, done=1) for n in
                            ("decode.dispatch", "decode.tail")),
            tail_windows=sum(s["counters"]["windows"] for s in spans
                             if s["name"] == "decode.tail"))
    return out


def run_pipeline(cfg: Config, argv: Optional[List[str]] = None,
                 device=None, shard_devices=None) -> dict:
    """Full discovery run on ``device`` (CUDA unless the caller asks for
    the CPU); returns stage timing + counters, and ``trace``: the call's
    spans (``utils/trace.py``). Under ``cfg.distributed``
    the process joins the run's process group first (with more than one
    process): it resolves only its chromosome bucket, and a process
    other than 0 returns after the result exchange, with ``n_calls`` 0
    and no VCF written. ``shard_devices``: the devices of a
    ``--n_shards`` run in place of :func:`pmesh.pick_devices` (a list
    may repeat a device); the stats name the devices used
    (``shard_devices``, [] when the serial programs ran). ``--profile``
    (with a work dir) writes the call's trace, ``profile_trace``: the
    device's operations (``torch.profiler``, CUDA activity only) and
    the spans."""
    argv = argv if argv is not None else []
    device = resolve_device(device)
    devices = _shard_plan(cfg, device, shard_devices)
    if devices is not None:
        log.info("--n_shards %d: sharded over %s"
                 % (cfg.n_shards, ", ".join(str(d) for d in devices)))
    elif cfg.n_shards > 1 and cfg.engine != "host":
        log.info("--n_shards %d: %d CUDA device(s) visible, too few; the "
                 "serial programs run on %s"
                 % (cfg.n_shards, torch.cuda.device_count(), device))
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
    dist_active = False
    if cfg.distributed:
        from cutesv_tpu_torch.parallel import distributed as dist
        dist_active = dist.init_distributed(
            cfg.coordinator, cfg.num_processes, cfg.process_id)
    profiling = bool(cfg.profile and cfg.work_dir)
    prof = None
    if profiling and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    try:
        with trace.recording() as rec:
            with trace.span("call"):
                stats = _run_stages(cfg, argv, device, devices, ckpt,
                                    dist_active)
    finally:
        if prof is not None:
            torch.cuda.synchronize(device)
            prof.stop()
        if dist_active:
            # gloo's threads must stop before the interpreter exits (a
            # group left to the exit's destructors can abort the process)
            dist.shutdown_distributed()
    stats.update(_span_stats(rec.spans))
    stats["trace"] = rec.export()
    if profiling:
        stats["profile_trace"] = _write_profile(cfg, prof, stats["trace"])
    return stats


def _run_stages(cfg: Config, argv: List[str], device, devices,
                ckpt: Optional[str], dist_active: bool) -> dict:
    """Decode, resolve and emit of :func:`run_pipeline`, after its input
    checks, each stage a span (``decode``, ``resolve``, ``emit``);
    ``devices``: the shard device list (None: serial); ``dist_active``:
    this process is one of a multi-process run's group."""
    stats = dict(shard_devices=[str(d) for d in devices or []])
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
    with trace.span("decode"):
        fasta_thread.start()
        if cfg.resume and ckpt and os.path.exists(ckpt):
            log.info("Resuming from signature checkpoint %s" % ckpt)
            store = sigstore.load_store(cfg.work_dir)
            stats["decoder"] = "checkpoint"
            candidates = None
            n_records = -1
        else:
            store, candidates, n_records = decode_bam(cfg, device)
            stats.update(store.decode_breakdown)
    stats["n_records"] = n_records
    stats["n_sigs"] = _n_sigs(store)
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

    if dist_active:
        # every process decoded the input; this one resolves only its
        # chromosome bucket, on its own device
        from cutesv_tpu_torch.parallel.distributed import (process_count,
                                                           process_index)
        k = process_index()
        assign = _bucket_plan(store, process_count())
        store = _filter_store_chroms(store,
                                     lambda c: assign.get(c, 0) == k)
        stats["chroms_resolved"] = sorted(c for c, b in assign.items()
                                          if b == k)
    with trace.span("resolve"):
        results = resolve_all(store, cfg, device, devices)
        if dist_active:
            gather: dict = {}
            results = _gather_results(results, gather)
            stats.update(gather_mb=gather["local_mb"],
                         gather_total_mb=gather["total_mb"],
                         gather_s=gather["seconds"])
    if results is None:  # not the emitter: done after the exchange
        stats["n_calls"] = 0
        return stats
    stats["n_calls"] = sum(len(v) for v in results.values())

    with trace.span("emit"):
        fasta_thread.join()
        fasta = fasta_box[0]
        if isinstance(fasta, BaseException):
            raise fasta
        per_chrom = {}
        with trace.span("emit.format"):
            for chrom, rows in results.items():
                if chrom not in fasta:
                    raise KeyError(
                        "No corresponding contig in reference with %s."
                        % chrom)
                per_chrom[chrom] = vcf.format_chrom_records(
                    cfg, rows, fasta.fetch_lazy(chrom), chrom)
        with trace.span("emit.write"):
            vcf.write_vcf(cfg.output, cfg, per_chrom,
                          list(store.chrom_lengths.items()), argv)
    return stats
