"""Multi-host runs (``--distributed``) over torch.distributed.

One process per host (or several on one machine), joined into one gloo
process group:

    python -m cutesv_tpu_torch.cli in.bam ref.fa out.vcf wd/ --distributed \\
        --coordinator host0:29500 --num_processes 4 --process_id $IDX

``--coordinator host:port`` becomes the group's ``tcp://host:port``
rendezvous. A coordinator, count or rank left out is read from torch's
``env://`` variables (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, as
``torchrun`` sets them); where neither gives it, the run raises. With
``--num_processes 1`` no group is made and the run is the
single-process one.

Division of labour:

* decode is SHARDED over compressed byte ranges
  (``pipeline._decode_bam_native``, :func:`exchange_decodes`):
  each process inflates only ~1/N of the BGZF blocks (CRAM: of the
  containers), finds its first record boundary by validated chaining,
  and the small signature/census partials are allgathered and merged,
  so every process ends with the exact whole-file decode. Cross-shard
  boundaries are checked equal before anything is used.
* each process resolves the chromosomes of its own bucket
  (:func:`assign_chroms_by_decode_range`, else :func:`assign_chroms_lpt`)
  on its own device: the cluster programs and the cover kernel run on
  its card. The census and read tables stay whole on every process (TRA
  genotypes replay coverage on the mate chromosome).
* the per-chromosome candidate rows are allgathered and process 0 writes
  the VCF.

Why gloo and not NCCL: both exchanges carry host objects (numpy arrays
and Python rows, pickled). NCCL moves device buffers only, so it would
add a host -> device -> host round trip to each, and it refuses two
ranks on one GPU, which a run of several processes on one card needs.
The device work stays on each process's card whatever the backend.
"""
from __future__ import annotations

import heapq
import io
import logging
import os
import pickle
import time

import numpy as np
import torch

log = logging.getLogger("cutesv_tpu_torch.distributed")


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> bool:
    """Join the gloo process group; returns True when this call made the
    process part of a multi-process run (False for ``num_processes`` <=
    1, where no group is made)."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        log.info("distributed: single process; no process group")
        return False
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator = "%s:%s" % (env["MASTER_ADDR"], env["MASTER_PORT"])
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    missing = [name for name, v in (
        ("--coordinator (or MASTER_ADDR and MASTER_PORT)", coordinator),
        ("--num_processes (or WORLD_SIZE)", num_processes),
        ("--process_id (or RANK)", process_id)) if v is None]
    if missing:
        raise ValueError("distributed: %s not given" % ", ".join(missing))
    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)
    log.info("distributed: process %d/%d (gloo, tcp://%s)",
             dist.get_rank(), dist.get_world_size(), coordinator)
    if dist.get_world_size() != num_processes:
        # without this check every process would run the WHOLE file
        # alone: N duplicate runs pretending to be one distributed run
        raise RuntimeError(
            "distributed: the process group reports %d process(es) but "
            "--num_processes %d was requested"
            % (dist.get_world_size(), num_processes))
    return True


def shutdown_distributed() -> None:
    """Leave the process group, where there is one: gloo's threads must
    stop before the interpreter exits."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes of the run: the group's size, 1 without a group."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank: 0 without a group."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_emitter() -> bool:
    """True on the process that writes the merged VCF (process 0)."""
    return process_index() == 0


def chrom_bucket(chrom: str, num_processes: int) -> int:
    """Deterministic chromosome -> host assignment for the decode split
    (stable across hosts: a cheap byte-sum hash, not PYTHONHASHSEED
    dependent). Size-blind fallback — the pipeline prefers
    :func:`assign_chroms_lpt` once the census is known."""
    return sum(chrom.encode()) % max(1, num_processes)


def part_census_counts(parts) -> list:
    """Per-part {chrom_name: census rows} — computed from the allgathered
    partial decodes, so identical on every host."""
    out = []
    for p in parts:
        ids, counts = np.unique(p.arrays["cen_chr"], return_counts=True)
        out.append({p.chroms[int(c)]: int(n)
                    for c, n in zip(ids, counts)})
    return out


def assign_chroms_by_decode_range(part_counts, store,
                                  num_processes: int) -> dict:
    """Range-affine chromosome -> host assignment: a chromosome resolves
    on the host whose decode range produced most of its census rows, so
    the mid-decode full tails each host ran land in its OWN resolve
    bucket. The decode ranges split compressed bytes ~equally, so
    affinity is also ~load-balanced; chromosomes with no census rows
    anywhere fall back to the LPT plan. Deterministic: derived from the
    allgathered parts + the merged store, identical on every host."""
    assign = {}
    chroms = set()
    for pc in part_counts:
        chroms.update(pc)
    for chrom in chroms:
        counts = [pc.get(chrom, 0) for pc in part_counts]
        if max(counts) > 0:
            # ties break to the lowest part index (deterministic)
            assign[chrom] = int(np.argmax(counts)) % max(1, num_processes)
    for c, b in assign_chroms_lpt(store, num_processes).items():
        assign.setdefault(c, b)
    return assign


def assign_chroms_lpt(store, num_processes: int) -> dict:
    """Size-aware chromosome -> host assignment: greedy
    longest-processing-time over per-chromosome work weights (census
    rows + signature rows, both known post-decode and identical on every
    host, so each process derives the same plan with no communication).
    Human chr1 (249 Mb) and chr21 (47 Mb) weigh ~5x apart, so a
    size-blind hash would leave per-host resolve wall to luck. The
    reference's counterpart is the density-adaptive task list
    (cuteSV:1026-1044)."""
    weights = {}
    for chrom, census in store.census.items():
        weights[chrom] = weights.get(chrom, 0) + len(census["start"])
    for per in store.sigs.values():
        for chrom, stream in per.items():
            weights.setdefault(chrom, 0)
            weights[chrom] += len(stream)
    n = max(1, num_processes)
    # deterministic LPT: heaviest first, ties by name; least-loaded
    # bucket wins, ties by bucket id (heap orders (load, bucket))
    order = sorted(weights, key=lambda c: (-weights[c], c))
    heap = [(0, b) for b in range(n)]
    heapq.heapify(heap)
    assign = {}
    for chrom in order:
        load, b = heapq.heappop(heap)
        assign[chrom] = b
        heapq.heappush(heap, (load + weights[chrom], b))
    return assign


# ---------------------------------------------------------------------------
# sharded decode: each host inflates only its block-aligned byte range
# (the reference's counterpart is the density-adaptive per-interval task
# list, cuteSV:1026-1076 — here the split is on compressed bytes, which
# is what actually costs)
# ---------------------------------------------------------------------------

def plan_shard_ranges(path: str, n: int):
    """Block-aligned decode ranges splitting the BAM's compressed bytes
    ~equally over ``n`` shards. Every process derives the identical plan
    from the file alone (no communication). Returns a list of
    (range_start, range_ulen, u_base) per shard:

    * range_start — compressed offset of the shard's first BGZF block
      (0 for shard 0, which also decodes the header),
    * range_ulen — uncompressed byte budget: records whose uncompressed
      start offset (relative to range_start) is below it belong to this
      shard; 0 (unbounded) for the last shard so truncated-file
      detection stays active; -1 (own nothing) for shards left empty
      when the file has fewer blocks than shards,
    * u_base — global uncompressed offset of range_start, turning the
      decoder's relative boundary reports into global coordinates for
      the cross-shard agreement check.
    """
    from cutesv_tpu_torch.io.bgzf import scan_block_table

    offs, isizes = scan_block_table(path)
    n_blocks = len(offs)
    cum_u = np.concatenate([np.zeros(1, np.int64), np.cumsum(isizes)])
    splits = [0]
    for k in range(1, n):
        idx = int(np.searchsorted(offs, k * (offs[-1] + 1) // n))
        splits.append(min(max(idx, splits[-1]), n_blocks))
    splits.append(n_blocks)
    fsize = os.path.getsize(path)
    ranges = []
    for k in range(n):
        b0, b1 = splits[k], splits[k + 1]
        start = int(offs[b0]) if b0 < n_blocks else fsize
        ulen = int(cum_u[b1] - cum_u[b0])
        if k == n - 1:
            ulen = 0  # unbounded: keep cut-file detection live
        elif ulen == 0:
            ulen = -1  # empty shard: own nothing (0 would mean unbounded)
        ranges.append((start, ulen, int(cum_u[b0])))
    return ranges


def plan_cram_shard_ranges(path: str, n: int):
    """Container-aligned decode ranges for CRAM sharded decode. CRAM
    containers are independently decodable (the format's random-access
    design), so the plan is simply a contiguous split of the data
    container chain by cumulative compressed bytes — no record-boundary
    discovery. Every process scans the same header chain (a few dozen
    bytes per container + one seek) and derives the identical plan.

    Returns (range_start, range_clen, u_base=0) per shard: containers
    whose header offset lies in [range_start, range_start+range_clen)
    are owned; range_clen 0 = unbounded (last shard), -1 = own nothing
    (more shards than containers; range_start then points at the chain
    end so the boundary chain stays contiguous). Every shard still
    decodes the SAM header container."""
    from cutesv_tpu_torch.io.cram import _read_container_header

    offs = []
    with open(path, "rb") as fh:
        if fh.read(4) != b"CRAM":
            raise ValueError("not a CRAM file: %s" % path)
        fh.seek(26)  # file definition: magic + version + 20-byte id
        hdr = _read_container_header(fh)  # SAM header container
        if hdr is None:
            raise ValueError("truncated CRAM header container")
        fh.seek(max(0, hdr["length"]), 1)
        while True:
            co = fh.tell()
            hdr = _read_container_header(fh)
            if (hdr is None
                    or (hdr["ref_id"] == -1 and hdr["start"] == 4542278)
                    or (hdr["n_records"] == 0 and hdr["length"] <= 0)):
                end = co
                break
            offs.append(co)
            fh.seek(max(0, hdr["length"]), 1)

    n_cont = len(offs)
    bounds = np.asarray(offs + [end], np.int64)
    total = int(bounds[-1] - bounds[0]) if n_cont else 0
    splits = [0]
    for k in range(1, n):
        # cut at the container whose offset first reaches k/n of the
        # compressed span (monotone, so splits stay ordered)
        target = int(bounds[0]) + k * total // n
        idx = int(np.searchsorted(bounds[:-1], target))
        splits.append(min(max(idx, splits[-1]), n_cont))
    splits.append(n_cont)
    ranges = []
    for k in range(n):
        b0, b1 = splits[k], splits[k + 1]
        if b0 >= n_cont or b1 <= b0:
            # own nothing; anchor at the successor's boundary so the
            # first_u/next_u chain stays contiguous through empty shards
            ranges.append((int(bounds[b0]), -1, 0))
        elif k == n - 1:
            ranges.append((int(bounds[b0]), 0, 0))  # unbounded tail
        else:
            ranges.append((int(bounds[b0]),
                           int(bounds[b1] - bounds[b0]), 0))
    return ranges


def check_shard_boundaries(ranges, reports):
    """``reports``: per shard (first_u, next_u) in range-local
    coordinates. Converts to global uncompressed offsets and asserts
    each shard stopped exactly where its successor started — the
    record-boundary discovery heuristic is statistically unambiguous,
    and this check makes silent disagreement structurally impossible."""
    firsts = [u_base + f for (_, _, u_base), (f, _) in zip(ranges, reports)]
    nexts = [u_base + nx for (_, _, u_base), (_, nx) in zip(ranges,
                                                            reports)]
    for k in range(len(ranges) - 1):
        if nexts[k] != firsts[k + 1]:
            raise RuntimeError(
                "sharded decode boundary mismatch between shards %d and "
                "%d (%d != %d); file layout not understood — rerun "
                "without --distributed" % (k, k + 1, nexts[k],
                                           firsts[k + 1]))


def merge_partial_decodes(parts):
    """Merge per-shard NativeDecode partials (shard order == file order)
    into one NativeDecode equal to the whole-file decode.

    Name ids are re-interned globally (first occurrence wins, preserving
    file order); INS sequence blobs concatenate with offset shifts; the
    name lexicographic ranks and INS sequence content ranks are
    recomputed globally (per-part ranks are only locally valid)."""
    from cutesv_tpu_torch.io.native import NativeDecode

    if not parts:
        raise ValueError("no partial decodes to merge")
    head = parts[0]
    for p in parts[1:]:
        if p.chroms != head.chroms:
            raise ValueError("header mismatch across shards")

    # global name table (file order) + per-part id remaps — one
    # np.unique over the concatenated name arrays instead of a per-name
    # python dict loop
    part_names = [np.asarray(p.names, dtype=object) for p in parts]
    counts = [len(a) for a in part_names]
    cat = (np.concatenate(part_names) if sum(counts)
           else np.empty(0, object))
    uniq, first_idx, inv = np.unique(cat, return_index=True,
                                     return_inverse=True)
    # global ids in first-occurrence (file) order, matching the
    # whole-file decode's interning order exactly
    order_first = np.argsort(first_idx, kind="stable")
    gid_of_uniq = np.empty(len(uniq), np.int64)
    gid_of_uniq[order_first] = np.arange(len(uniq))
    gid = gid_of_uniq[inv]
    names = [str(s) for s in uniq[order_first]]
    name_rank = np.empty(len(uniq), np.int64)
    name_rank[gid_of_uniq] = np.arange(len(uniq))  # uniq is sorted
    remaps = []
    lo = 0
    for c in counts:
        remaps.append(gid[lo:lo + c])
        lo += c

    name_cols = {"del_name", "ins_name", "dup_name", "inv_name",
                 "tra_name", "cen_name", "all_name"}
    arrays = {}
    for key in head.arrays:
        if key == "ins_seq_rank":
            continue  # recomputed below
        cols = []
        for p, remap in zip(parts, remaps):
            a = p.arrays[key]
            if key in name_cols:
                a = remap[a]
            # ins_seq_off is shifted below with the blob
            cols.append(np.asarray(a))
        arrays[key] = (np.concatenate(cols) if cols[0].ndim
                       else np.asarray(cols))

    # INS seq blob concat + offset shift
    blob = bytearray()
    shifted = []
    for p in parts:
        off = len(blob)
        blob += p.ins_seq_blob
        shifted.append(np.asarray(p.arrays["ins_seq_off"]) + off)
    arrays["ins_seq_off"] = (np.concatenate(shifted) if shifted
                             else np.empty(0, np.int64))
    blob = bytes(blob)

    # global INS content ranks from per-part REPRESENTATIVES: the
    # per-part ranks already encode content equality within a part, so
    # one byte extraction per distinct content per part (not one per
    # row) suffices to align rank spaces
    rep_bytes: list = []
    rep_ranks = []
    for p in parts:
        pr = np.asarray(p.arrays["ins_seq_rank"])
        po = np.asarray(p.arrays["ins_seq_off"])
        pl = np.asarray(p.arrays["ins_seq_len"])
        u, fidx = np.unique(pr, return_index=True)
        rep_ranks.append(u)
        pb = p.ins_seq_blob
        rep_bytes.extend(pb[int(po[i]):int(po[i]) + int(pl[i])]
                         for i in fidx)
    if rep_bytes:
        _, g_inv = np.unique(np.asarray(rep_bytes, object),
                             return_inverse=True)
        out_ranks = []
        lo = 0
        for p, u in zip(parts, rep_ranks):
            m = np.empty(int(u.max()) + 1 if len(u) else 0, np.int64)
            m[u] = g_inv[lo:lo + len(u)]
            lo += len(u)
            out_ranks.append(m[np.asarray(p.arrays["ins_seq_rank"])])
        arrays["ins_seq_rank"] = np.concatenate(out_ranks).astype(np.int64)
    else:
        arrays["ins_seq_rank"] = np.empty(0, np.int64)

    nd = NativeDecode(
        names=names, name_rank=name_rank, chroms=list(head.chroms),
        ref_lengths=head.ref_lengths,
        n_records=sum(p.n_records for p in parts),
        arrays=arrays, ins_seq_blob=blob)
    # per-part local->merged id/offset maps: the streaming sharded
    # decode remaps its own part's snapshot fingerprints into the
    # merged spaces before validating them against the merged arrays
    nd.part_name_remaps = remaps
    bases = []
    off = 0
    for p in parts:
        bases.append(off)
        off += len(p.ins_seq_blob)
    nd.part_blob_bases = bases
    return nd


class _HostPickler(pickle.Pickler):
    """Pickler that refuses torch tensors: a CUDA tensor inside a
    gathered object would unpickle onto the peer's card (silently right
    on one card, broken across hosts), so the exchanges carry numpy
    arrays and Python values only."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError(
                "allgather_obj: a torch.Tensor on %s inside the gathered "
                "object; the exchange carries host values only (numpy "
                "arrays, Python objects)" % obj.device)
        return NotImplemented


def allgather_obj(obj, info: dict = None):
    """Allgather one picklable object per process over the gloo group;
    returns every process's object in rank order (the list of this one
    object without a group). torch sends the pickles' sizes as int64.
    ``info``, where given, receives the local and gathered MB and the
    seconds the exchange took."""
    import torch.distributed as dist

    t0 = time.time()
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    blob = buf.getvalue()
    if dist.is_initialized():
        blobs = [None] * dist.get_world_size()
        dist.all_gather_object(blobs, blob)
    else:
        blobs = [blob]
    out = [pickle.loads(b) for b in blobs]
    local_mb = len(blob) / 1e6
    total_mb = sum(len(b) for b in blobs) / 1e6
    seconds = time.time() - t0
    log.info("allgather: local %.1f MB, gathered %.1f MB total in %.2fs",
             local_mb, total_mb, seconds)
    if info is not None:
        info.update(local_mb=local_mb, total_mb=total_mb, seconds=seconds)
    return out


def exchange_decodes(nd, ranges, info: dict = None):
    """The whole-file decode from this process's ranged decode ``nd`` of
    the plan ``ranges`` (:func:`plan_shard_ranges`,
    :func:`plan_cram_shard_ranges`): the partial decodes are allgathered
    (signatures + census are ~2% of the compressed input), their
    boundaries checked equal before anything is used, and merged
    (:func:`merge_partial_decodes`), so each host ends with the exact
    whole-file decode while the dominant stage's wall drops
    ~1/num_processes. The merged decode carries the parts' census counts
    (``part_census_counts``). ``info`` receives the allgather's sizes and
    seconds."""
    parts = allgather_obj(nd, info)
    check_shard_boundaries(ranges,
                           [(p.first_u, p.next_u) for p in parts])
    merged = merge_partial_decodes(parts)
    merged.part_census_counts = part_census_counts(parts)
    return merged
