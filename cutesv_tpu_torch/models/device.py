"""Device (PyTorch/CUDA) resolvers for DEL/INS, DUP/INV and TRA.

Splits the work device-first:
  * device — the O(N log N) integer work over the full signature stream:
    sorting, gap clustering, per-read dedup, support gates, and the allele
    stream ordering (ops/indel_cluster.py); the DUP/INV/TRA gap
    clusters and support gates (ops/pair_cluster.py);
  * host  — per-allele f64 finalization (means of the closest-to-mean
    members, CIPOS/CILEN), which must match numpy's f64 semantics exactly
    and touches only ~1e3-1e5 small slices.

Integer-exactness note: the allele-split threshold is
``ratio * np.mean(lengths)``; lengths are integers, so np.mean's pairwise
f64 summation is exact and equals bincount_sum/count computed here.

Every entry point takes an explicit ``device`` (``resolve_device``: CUDA
unless the caller asks for the CPU). With ``n_shards`` > 1 (the
``--n_shards`` path) a stream is cut at gaps wider than the bias, so no
cluster spans two cuts, and each cut runs the unchanged program on its
own device of the shard list (``parallel/mesh.py::shard_devices``); the
rows are joined in shard order. Outputs are identical to models/host.py
and to the JAX package's models/device.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cutesv_tpu_torch.genotype import cal_CIPOS
from cutesv_tpu_torch.models.host import (_equality_codes,
                                          _tra_emit_clusters,
                                          dup_cluster_emit,
                                          finalize_indel_allele,
                                          inv_cluster_emit)
from cutesv_tpu_torch.ops.indel_cluster import (indel_cluster_structure,
                                                pack_cluster_ids,
                                                sharded_cluster_structure)
from cutesv_tpu_torch.ops.pair_cluster import (compact_pair_outputs,
                                               pair_cluster_structure,
                                               sharded_pair_cluster)
from cutesv_tpu_torch.ops.segments import padded_size
from cutesv_tpu_torch.parallel import mesh as pmesh
from cutesv_tpu_torch.utils import trace
from cutesv_tpu_torch.utils.torchsetup import resolve_device


class IndelStream:
    """Columnar view over one chromosome's merged DEL or INS stream.

    ``pos``/``length`` int64 arrays; ``rid`` int read identities whose
    numeric order equals read-name string order. Two storage modes share
    one row API (``seq_of``/``names_of``/``keys_of``): tuple-backed
    (oracle path, string identities) and array-backed (native decode
    path, rank-id identities). Plain attributes only, so signature
    checkpoints pickle cleanly.
    """

    def __init__(self, pos, length, rid, rows=None, names_table=None,
                 seq_len=None, seq_blob=None, seq_off=None):
        self.pos = pos
        self.length = length
        self.rid = rid
        self._rows = rows               # tuple mode
        self._names_table = names_table  # array mode
        self.seq_len = seq_len
        self._seq_blob = seq_blob
        self._seq_off = seq_off

    def __len__(self):
        return len(self.pos)

    def seq_of(self, k):
        if self._rows is not None:
            return self._rows[k][3]
        o = int(self._seq_off[k])
        return self._seq_blob[o:o + int(self.seq_len[k])].decode("ascii")

    def seqs_of(self, ks, lens):
        """``seq_of(k)[:l]`` over parallel lists — batched so a native
        blob view pays ONE span call for the whole emission instead of
        one ctypes round trip per allele."""
        if self._rows is not None:
            return [self._rows[int(k)][3][:l] for k, l in zip(ks, lens)]
        offs = [int(self._seq_off[k]) for k in ks]
        tl = [min(int(self.seq_len[k]), int(l)) for k, l in zip(ks, lens)]
        blob = self._seq_blob
        if hasattr(blob, "spans"):
            data = blob.spans(offs, tl)
            out, p = [], 0
            for l in tl:
                out.append(data[p:p + l].decode("ascii"))
                p += l
            return out
        return [blob[o:o + l].decode("ascii")
                for o, l in zip(offs, tl)]

    def tuples(self):
        """Materialize resolver-format tuple rows (host-engine path over a
        native store); read identities stay rank keys."""
        if self._rows is not None:
            return self._rows
        if self.seq_len is not None:
            return [(int(self.pos[k]), int(self.length[k]),
                     int(self.rid[k]), self.seq_of(k))
                    for k in range(len(self.pos))]
        return list(zip(self.pos.tolist(), self.length.tolist(),
                        self.rid.tolist()))

    def names_of(self, idx) -> list:
        """Vectorized name_of over an index array (one pass instead of a
        python call per row)."""
        if self._rows is not None:
            rows = self._rows
            return [rows[int(k)][2] for k in idx]
        tbl = self._names_table
        return [tbl[r] for r in self.rid[idx].tolist()]

    def keys_of(self, idx) -> list:
        """Vectorized key_of over an index array."""
        if self._rows is not None:
            rows = self._rows
            return [rows[int(k)][2] for k in idx]
        return self.rid[idx].tolist()

    @classmethod
    def from_tuples(cls, rows: Sequence, is_ins: bool) -> "IndelStream":
        n = len(rows)
        pos = np.fromiter((r[0] for r in rows), np.int64, n)
        length = np.fromiter((r[1] for r in rows), np.int64, n)
        names = np.array([r[2] for r in rows]) if n else np.empty(0, "U1")
        _, rid = np.unique(names, return_inverse=True)
        kw = {}
        if is_ins:
            kw = dict(seq_len=np.fromiter((len(r[3]) for r in rows),
                                          np.int64, n))
        return cls(pos, length, rid.astype(np.int64), rows=list(rows), **kw)

    @classmethod
    def from_arrays(cls, pos, length, rid, names_table, seq_len=None,
                    seq_blob=None, seq_off=None) -> "IndelStream":
        return cls(np.asarray(pos, np.int64), np.asarray(length, np.int64),
                   np.asarray(rid, np.int64), names_table=names_table,
                   seq_len=seq_len, seq_blob=seq_blob, seq_off=seq_off)

    def select(self, keep: np.ndarray) -> "IndelStream":
        """Row-filtered copy (both storage modes)."""
        rows = None
        if self._rows is not None:
            rows = [r for r, k in zip(self._rows, keep) if k]
        return IndelStream(
            self.pos[keep], self.length[keep], self.rid[keep], rows=rows,
            names_table=self._names_table,
            seq_len=None if self.seq_len is None else self.seq_len[keep],
            seq_blob=self._seq_blob,
            seq_off=None if self._seq_off is None else self._seq_off[keep])


# The largest padded size at which the DEL/INS program replays a captured
# CUDA graph; above it the program runs eagerly. A graph's private pool
# keeps the program's intermediates for the life of the process, and at
# the post-decode batches' millions of rows the card's work dwarfs the
# ~60 launches a graph saves (PERF.md §6).
GRAPH_MAX_ROWS = 65_536

# captured programs by (CUDA device index, padded size), for the life of
# the process; the lock makes a capture, and each replay's three enqueued
# steps, whole against another thread dispatching the same graph
_GRAPHS: Dict[tuple, "_ClusterGraph"] = {}
_GRAPHS_LOCK = threading.Lock()


def _stage(stream: IndelStream, cap: int, bias: int, read_count: int,
           pinned: bool):
    """The program's input as one int32 host buffer of ``3 * cap + 3``:
    ``pos``, ``length`` and ``rid`` zero-padded to ``cap`` rows each,
    then ``n_valid``, ``bias`` and ``read_count``. Filled through a numpy
    view (no CPU torch op runs); ``pinned`` for a non-blocking copy to a
    card, whose staging buffer the caching host allocator keeps until
    the copy has run."""
    n = len(stream)
    buf = torch.empty(3 * cap + 3, dtype=torch.int32, pin_memory=pinned)
    view = buf.numpy()
    for k, col in enumerate((stream.pos, stream.length, stream.rid)):
        view[k * cap:k * cap + n] = col
        view[k * cap + n:(k + 1) * cap] = 0
    view[3 * cap:] = (n, bias, read_count)
    return buf


def _unstage(buf, cap: int):
    """The program's arguments from a :func:`_stage` layout: the three
    columns as views and the three scalars as 0-d tensors."""
    return (buf[:cap], buf[cap:2 * cap], buf[2 * cap:3 * cap], buf[3 * cap],
            buf[3 * cap + 1], buf[3 * cap + 2])


def _program(buf, cap: int) -> dict:
    """The DEL/INS cluster program over a staged buffer, with the packed
    column over the full padded size (a compaction is then a slice):
    ``pos``, ``length``, ``packed`` and ``n_kept``."""
    pos, length, rid, n_valid, bias, read_count = _unstage(buf, cap)
    out = indel_cluster_structure(pos, length, rid, n_valid, bias,
                                  read_count, cap)
    return dict(pos=out["pos"], length=out["length"],
                packed=pack_cluster_ids(out["cid"], out["stream_idx"]),
                n_kept=out["n_kept"])


class _ClusterGraph:
    """:func:`_program` captured once on one card at one padded size.
    Its static input is the :func:`_stage` layout, so one graph serves
    DEL and INS and every stream of the size; its static output is
    ``pos | length | packed | n_kept``, which each replay's caller copies
    out before another replay can overwrite it."""

    def __init__(self, device, cap: int):
        self.cap = cap
        self.input = torch.zeros(3 * cap + 3, dtype=torch.int32,
                                 device=device)
        self.output = torch.empty(3 * cap + 1, dtype=torch.int32,
                                  device=device)
        # warm up on a side stream: the sorts size their workspace on
        # their first run
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread-local: the decoder's submitter thread keeps copying and
        # synchronising on its own streams while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._run()

    def _run(self):
        out = _program(self.input, self.cap)
        c = self.cap
        for k, key in enumerate(("pos", "length", "packed")):
            self.output[k * c:(k + 1) * c].copy_(out[key])
        self.output[3 * c].copy_(out["n_kept"])

    def replay(self, staged) -> dict:
        """Copy the pinned ``staged`` input up, replay, and copy the
        outputs into a fresh tensor; returns views of it by key."""
        self.input.copy_(staged, non_blocking=True)
        self.graph.replay()
        out = self.output.clone()
        c = self.cap
        return dict(pos=out[:c], length=out[c:2 * c],
                    packed=out[2 * c:3 * c], n_kept=out[3 * c])


def _cluster_stream_dispatch(stream: IndelStream, read_count: int,
                             bias: int, device):
    """Stage the stream and enqueue the cluster program on ``device``
    (asynchronous on CUDA); returns its output dict of tensors (see
    :func:`_program`), or None for an empty stream. On a card, up to
    ``GRAPH_MAX_ROWS`` padded rows, the program is the replay of a graph
    captured at the stream's first dispatch of its padded size; on the
    CPU and above the ceiling it runs eagerly. Span ``cluster.dispatch``
    with counters ``graph`` (1 for a replay), ``captured`` (1 where this
    dispatch captured) and ``rows`` (the padded size)."""
    n = len(stream)
    if n == 0:
        return None
    cap = padded_size(n)
    on_card = device.type == "cuda"
    with trace.span("cluster.dispatch", graph=0, captured=0,
                    rows=cap) as counters:
        staged = _stage(stream, cap, bias, read_count, pinned=on_card)
        if not on_card or cap > GRAPH_MAX_ROWS:
            return _program(staged.to(device, non_blocking=True), cap)
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        with _GRAPHS_LOCK, torch.cuda.device(index):
            graph = _GRAPHS.get((index, cap))
            if graph is None:
                graph = _GRAPHS[(index, cap)] = _ClusterGraph(
                    torch.device("cuda", index), cap)
                counters["captured"] = 1
            counters["graph"] = 1
            return graph.replay(staged)


def _upload(a, cap: int, device):
    """``a`` as a zero-padded int32 tensor of length ``cap`` on ``device``.
    On CUDA the rows are staged in pinned host memory (filled through a
    numpy view, so no CPU torch op runs) and copied ``non_blocking``: the
    dispatch does not wait for the transfer, and the caching host
    allocator keeps the staging buffer until the copy has run."""
    a = np.asarray(a)
    n = len(a)
    if device.type != "cuda":
        buf = np.zeros(cap, np.int32)
        buf[:n] = a
        return torch.from_numpy(buf)
    host = torch.empty(cap, dtype=torch.int32, pin_memory=True)
    view = host.numpy()
    view[:n] = a
    view[n:] = 0
    return host.to(device, non_blocking=True)


def _copy_to_host(t):
    """Start a device->host copy of ``t``: on CUDA a ``non_blocking`` copy
    into pinned host memory behind a recorded event; on the CPU the
    tensor itself (a plain copy is all there is)."""
    if t.device.type != "cuda":
        return (t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return (host, ev)


def _host(pending) -> np.ndarray:
    """Numpy view of a :func:`_copy_to_host` result, once it landed."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _handles(state) -> list:
    """The program handles a resolver state holds: the dispatched jobs of
    a DEL/INS multi-state, a raw program output (a streaming dispatch),
    or the payload of a ``("pending", handle)`` pair state or a
    ``("pending", handle, arrays)`` TRA state. Sharded jobs and ``"done"``
    states hold none (their programs ran to the end already, or run at
    the finish)."""
    if state is None:
        return []
    if isinstance(state, dict):
        if "jobs" not in state:
            return [state]
        return [h for _, _, kind, h in state["jobs"] if kind == "kernel"]
    if isinstance(state, tuple) and len(state) in (2, 3) \
            and state[0] == "pending":
        return [state[1]]
    return []


def prefetch_counts(*states):
    """Start the device->host copies of every dispatched program's
    ``n_kept`` scalar BEFORE the compact phases block on them one program
    at a time, so the waits overlap instead of queueing."""
    for st in states:
        for h in _handles(st):
            if isinstance(h, dict) and "_n_kept_host" not in h:
                h["_n_kept_host"] = _copy_to_host(h["n_kept"])


def _start_host_copies(comp: dict) -> dict:
    """Start (once) the device->host copies of every tensor of a compacted
    output; returns the pending copies by key."""
    if "_host" not in comp:
        comp["_host"] = {k: _copy_to_host(v) for k, v in comp.items()
                         if torch.is_tensor(v)}
    return comp["_host"]


def prefetch_to_host(*states):
    """Start the device->host copies of every compacted output held by
    the given resolver states (DEL/INS multi-states, pair and TRA
    states); the finish phase then finds the rows on the host, and the
    copies overlap host emission."""
    for st in states:
        for h in _handles(st):
            if isinstance(h, tuple) and h[1] is not None:
                _start_host_copies(h[1])


def _cluster_stream_compact(out):
    """Read n_kept and cut the outputs to the kept rows' padded size;
    returns (n_kept, compact_handle). Compacting before the host copy
    cuts the device->host bytes to the kept rows only."""
    if out is None:
        return None
    if isinstance(out, tuple):
        return out  # already compacted
    pending = out.get("_n_kept_host") or _copy_to_host(out["n_kept"])
    nk = int(_host(pending))
    if nk == 0:
        return (0, None)
    cap_out = min(padded_size(nk), int(out["pos"].shape[0]))
    return (nk, {k: out[k][:cap_out] for k in ("pos", "length", "packed")})


def _cluster_stream_fetch(out):
    """Fetch dispatched program outputs; accepts either the raw output
    dict or a (n_kept, compact_handle) pair from
    :func:`_cluster_stream_compact`."""
    if out is None:
        return None
    if not isinstance(out, tuple):
        out = _cluster_stream_compact(out)
    nk, comp = out
    if nk == 0:
        return None
    got = {k: _host(v) for k, v in _start_host_copies(comp).items()}
    # int32 on the device with the flag in the sign bit: the uint32 view
    # is the JAX package's packed layout
    packed = got["packed"][:nk].view(np.uint32)
    sidx = (packed & np.uint32(0x7FFFFFFF)).astype(np.int64)
    cid = np.cumsum(packed >> np.uint32(31)).astype(np.int64) - 1
    return (cid,
            got["pos"][:nk].astype(np.int64),
            got["length"][:nk].astype(np.int64),
            sidx)


def _cluster_stream(stream: IndelStream, read_count: int, bias: int,
                    device):
    """Run the cluster program; returns kept rows in allele-stream order
    as (cid, pos, length, stream_idx) numpy arrays."""
    return _cluster_stream_fetch(
        _cluster_stream_dispatch(stream, read_count, bias, device))


def _allele_slices(cid, length, threshold_gloab):
    """Exact allele segmentation of the kept stream + processing order
    (clusters in stream order, alleles by ascending support, stable)."""
    nk = len(cid)
    csum = np.bincount(cid, weights=length.astype(np.float64))
    ccnt = np.bincount(cid)
    with np.errstate(invalid="ignore", divide="ignore"):
        thr = threshold_gloab * (csum / np.maximum(ccnt, 1))
    new_cluster = np.ones(nk, bool)
    new_cluster[1:] = cid[1:] != cid[:-1]
    boundary = new_cluster.copy()
    dlen = length[1:] - length[:-1]
    boundary[1:] |= (~new_cluster[1:]) & (dlen > thr[cid[1:]])
    aid = np.cumsum(boundary) - 1
    n_alleles = aid[-1] + 1 if nk else 0
    support = np.bincount(aid, minlength=n_alleles)
    first_row = np.nonzero(boundary)[0]
    a_cluster = cid[first_row]
    order = np.lexsort((np.arange(n_alleles), support, a_cluster))
    return first_row, support, order


def _as_stream(sigs, is_ins: bool) -> IndelStream:
    return sigs if isinstance(sigs, IndelStream) else \
        IndelStream.from_tuples(sigs, is_ins)


def _cipos_vectorized(values, first_row, support, aid, means):
    """Batched cal_CIPOS(np.std(slice), n) per allele.

    np.std's pairwise summation of squared deviations can differ from
    reduceat's sequential sum in the last ulp; that only matters when
    1.96*std/sqrt(n) sits within rounding distance of an integer (int()
    truncation boundary), so those rare alleles are recomputed with np.std
    itself. Returns the "-d,d" strings.
    """
    dev = values.astype(np.float64) - means[aid]
    sq = dev * dev
    sums = np.add.reduceat(sq, first_row)
    n = support.astype(np.float64)
    std = np.sqrt(sums / n)
    raw = 1.96 * std / np.sqrt(n)
    d = raw.astype(np.int64)
    # ulp-boundary guard: recompute exactly where truncation is ambiguous.
    # sums == 0 (singletons / identical values) is exact in both
    # algorithms, so only non-degenerate near-integer values are risky.
    risky = (np.abs(raw - np.round(raw)) < 1e-6) & (sums != 0)
    out = ["-%d,%d" % (x, x) for x in d]
    for a in np.nonzero(risky)[0]:
        lo = first_row[a]
        hi = first_row[a + 1] if a + 1 < len(first_row) else len(values)
        out[a] = cal_CIPOS(np.std(values[lo:hi]), int(support[a]))
    return out


def _finalize_vectorized(cid, pos, length, first_row, support):
    """Batched allele finalization for remain_reads_ratio == 1.

    Bit-identical to finalize_indel_allele: means of integers are exact in
    f64 regardless of summation order, so sum/n == np.mean over the picked
    permutation; the search anchor is the member minimizing
    (|pos - mean|, index-within-allele).
    Returns (bp_mean, len_mean, search_thr) arrays per allele.
    """
    nk = len(cid)
    n_alleles = len(first_row)
    aid = np.zeros(nk, np.int64)
    aid[first_row] = 1
    aid = np.cumsum(aid) - 1
    possum = np.bincount(aid, weights=pos.astype(np.float64),
                         minlength=n_alleles)
    lensum = np.bincount(aid, weights=length.astype(np.float64),
                         minlength=n_alleles)
    sup = support.astype(np.float64)
    bp_mean = possum / sup
    len_mean = lensum / sup
    # anchor: first member (by in-allele index) at min |pos - mean|
    dev = np.abs(pos.astype(np.float64) - bp_mean[aid])
    order = np.lexsort((np.arange(nk), dev, aid))
    o_aid = aid[order]
    first_of_allele = np.ones(nk, bool)
    first_of_allele[1:] = o_aid[1:] != o_aid[:-1]
    search_thr = np.zeros(n_alleles, pos.dtype)
    search_thr[o_aid[first_of_allele]] = pos[order[first_of_allele]]
    return bp_mean, len_mean, search_thr, aid


def resolve_del_device(sigs, chrom: str, read_count: int,
                       threshold_gloab: float, max_cluster_bias: int,
                       minimum_support_reads: int,
                       remain_reads_ratio: float, action: bool,
                       device=None):
    """Device counterpart of models.host.resolve_del; identical outputs."""
    stream = _as_stream(sigs, is_ins=False)
    res = _cluster_stream(stream, read_count, max_cluster_bias,
                          resolve_device(device))
    if res is None or len(res[0]) == 0:
        return [], []
    cid, pos, length, sidx = res
    return _emit_del(cid, pos, length, sidx, stream, chrom, threshold_gloab,
                     max_cluster_bias, minimum_support_reads,
                     remain_reads_ratio, action)


def _emit_del(cid, pos, length, sidx, stream, chrom, threshold_gloab,
              max_cluster_bias, minimum_support_reads, remain_reads_ratio,
              action, need_names=True):
    """Allele finalize + candidate build over kept DEL rows (allele-stream
    order) of one chromosome. ``need_names=False`` skips rendering the
    RNAMES column (only consumed under --report_readid)."""
    if remain_reads_ratio > 1:
        remain_reads_ratio = 1
    candidates: List[list] = []
    gt_jobs: List[dict] = []
    # densify cluster ids: sharded streams offset each shard's ids by
    # k*(shard_rows+2), so a plain -cid[0] shift would leave huge gaps and
    # _allele_slices' bincounts would allocate O(max_id) instead of
    # O(#clusters); ids are nondecreasing in allele-stream order
    cid = np.cumsum(np.diff(cid, prepend=cid[0]) != 0)
    first_row, support, order = _allele_slices(cid, length, threshold_gloab)
    fast = remain_reads_ratio == 1
    if fast:
        bp_v, len_v, thr_v, aid = _finalize_vectorized(cid, pos, length,
                                                       first_row, support)
        cipos_v = _cipos_vectorized(pos, first_row, support, aid, bp_v)
        cilen_v = _cipos_vectorized(length, first_row, support, aid, len_v)
        # int() truncation (all positive); python ints via tolist()
        # because str()/int() on numpy scalars is several times slower
        bp_i = bp_v.astype(np.int64).tolist()
        len_i = len_v.astype(np.int64).tolist()
        thr_i = thr_v.astype(np.int64).tolist()
    sup_l = support.tolist()
    fr_l = first_row.tolist()
    all_names = stream.names_of(sidx) if need_names else None
    all_keys = stream.keys_of(sidx)
    n_rows = len(cid)
    n_alleles = len(fr_l)
    # sub-threshold (noise) alleles vastly outnumber kept ones on real
    # corpora — filter in numpy so the python loop visits only emitters
    order = order[support[order] >= minimum_support_reads]
    for a in order.tolist():
        sup = sup_l[a]
        lo = fr_l[a]
        hi = fr_l[a + 1] if a + 1 < n_alleles else n_rows
        if fast:
            bp_s = str(bp_i[a])
            ln_s = str(-len_i[a])
            anchor = thr_i[a]
            cipos, cilen = cipos_v[a], cilen_v[a]
        else:
            al = finalize_indel_allele([int(p) for p in pos[lo:hi]],
                                       [int(v) for v in length[lo:hi]],
                                       sup, remain_reads_ratio)
            bp_s = str(int(al["breakpoint"]))
            ln_s = str(int(-al["signal_len"]))
            anchor = int(al["search_threshold"])
            cipos, cilen = al["cipos"], al["cilen"]
        names = ",".join(all_names[lo:hi]) if need_names else ""
        if action:
            gt_jobs.append(dict(
                window=(max(anchor - max_cluster_bias, 0),
                        anchor + max_cluster_bias),
                support=all_keys[lo:hi]))
            candidates.append([chrom, "DEL", bp_s, ln_s, str(sup),
                               cipos, cilen, None, None, None,
                               None, None, names])
        else:
            candidates.append([chrom, "DEL", bp_s, ln_s, str(sup),
                               cipos, cilen, ".", "./.",
                               ".,.,.", ".", ".", names])
    return candidates, gt_jobs


def resolve_ins_device(sigs, chrom: str, read_count: int,
                       threshold_gloab: float, max_cluster_bias: int,
                       minimum_support_reads: int,
                       remain_reads_ratio: float, action: bool,
                       device=None):
    """Device counterpart of models.host.resolve_ins; identical outputs."""
    stream = _as_stream(sigs, is_ins=True)
    res = _cluster_stream(stream, read_count, max_cluster_bias,
                          resolve_device(device))
    if res is None or len(res[0]) == 0:
        return [], []
    cid, pos, length, sidx = res
    return _emit_ins(cid, pos, length, sidx, stream, chrom, threshold_gloab,
                     max_cluster_bias, minimum_support_reads,
                     remain_reads_ratio, action)


def _emit_ins(cid, pos, length, sidx, stream, chrom, threshold_gloab,
              max_cluster_bias, minimum_support_reads, remain_reads_ratio,
              action, need_names=True):
    if remain_reads_ratio > 1:
        remain_reads_ratio = 1
    candidates: List[list] = []
    gt_jobs: List[dict] = []
    seq_fetch: List[tuple] = []  # (candidate idx, stream row, trunc len)
    cid = np.cumsum(np.diff(cid, prepend=cid[0]) != 0)  # densify (see _emit_del)
    first_row, support, order = _allele_slices(cid, length, threshold_gloab)
    fast = remain_reads_ratio == 1
    if fast:
        bp_v, len_v, thr_v, aid = _finalize_vectorized(cid, pos, length,
                                                       first_row, support)
        cipos_v = _cipos_vectorized(pos, first_row, support, aid, bp_v)
        cilen_v = _cipos_vectorized(length, first_row, support, aid, len_v)
        # int() truncation, all positive; python ints via tolist()
        len_i = len_v.astype(np.int64).tolist()
    sup_l = support.tolist()
    fr_l = first_row.tolist()
    all_names = stream.names_of(sidx) if need_names else None
    all_keys = stream.keys_of(sidx)
    row_seq_len = stream.seq_len[sidx] if len(sidx) else np.empty(0, np.int64)
    n_rows = len(cid)
    n_alleles = len(fr_l)
    order = order[support[order] >= minimum_support_reads]
    for a in order.tolist():
        sup = sup_l[a]
        lo = fr_l[a]
        hi = fr_l[a + 1] if a + 1 < n_alleles else n_rows
        if fast:
            isl = len_i[a]
            cipos, cilen = cipos_v[a], cilen_v[a]
        else:
            al = finalize_indel_allele([int(p) for p in pos[lo:hi]],
                                       [int(v) for v in length[lo:hi]],
                                       sup, remain_reads_ratio)
            isl = int(al["signal_len"])
            cipos, cilen = al["cipos"], al["cilen"]
        ok = np.nonzero(row_seq_len[lo:hi] >= isl)[0]
        if len(ok) == 0:
            continue
        k = lo + int(ok[0])
        breakpoint = int(pos[k])
        seq_fetch.append((len(candidates), int(sidx[k]), isl))
        names = ",".join(all_names[lo:hi]) if need_names else ""
        if action:
            gt_jobs.append(dict(window=(max(breakpoint - 1000, 0),
                                        breakpoint + 1000),
                                support=all_keys[lo:hi]))
            candidates.append([chrom, "INS", str(breakpoint),
                               str(isl), str(sup), cipos,
                               cilen, None, None, None, None, None,
                               names, None])
        else:
            candidates.append([chrom, "INS", str(breakpoint),
                               str(isl), str(sup), cipos,
                               cilen, ".", "./.", ".,.,.", ".", ".",
                               names, None])
    # ALT sequences in one batched blob read (one native span call per
    # chromosome, not one per allele)
    if seq_fetch:
        seqs = stream.seqs_of([r for _, r, _ in seq_fetch],
                              [l for _, _, l in seq_fetch])
        for (ci, _, _), s in zip(seq_fetch, seqs):
            candidates[ci][13] = s
    return candidates, gt_jobs


# ---------------------------------------------------------------------------
# DUP / INV / TRA device resolvers (ops/pair_cluster.py + host emission)
# ---------------------------------------------------------------------------

def _pair_cluster_start(k1, k2, aux, keys, read_count, bias, break_on_k2,
                        device):
    """Upload the rows and enqueue the pair-cluster program on ``device``
    (asynchronous on CUDA); fetch with :func:`_pair_cluster_finish`.
    Splitting dispatch from fetch lets the DUP, INV and TRA programs run
    on the device while DEL/INS emission runs on the host."""
    n = len(k1)
    if n == 0:
        return None
    _, rid = np.unique(np.asarray(keys), return_inverse=True)
    cap = padded_size(n)
    return pair_cluster_structure(
        _upload(k1, cap, device), _upload(k2, cap, device),
        _upload(aux, cap, device), _upload(rid, cap, device), n, bias,
        read_count, cap, bool(break_on_k2))


def _pair_cluster_compact(out):
    """Read n_kept and enqueue the pair-output compaction; returns
    (n_kept, {"packed": tensor})."""
    if out is None or isinstance(out, tuple):
        return out
    pending = out.get("_n_kept_host") or _copy_to_host(out["n_kept"])
    nk = int(_host(pending))
    if nk == 0:
        return (0, None)
    cap_out = min(padded_size(nk), int(out["cid"].shape[0]))
    return (nk, dict(packed=compact_pair_outputs(out["cid"],
                                                 out["stream_idx"],
                                                 cap_out)))


def _pair_cluster_finish(out):
    """Fetch a dispatched pair-cluster program; returns slices of
    program-order row indices (stream_idx) per kept cluster. Accepts the
    raw output or the (n_kept, packed) pair from
    :func:`_pair_cluster_compact`."""
    if out is None:
        return []
    if not isinstance(out, tuple):
        out = _pair_cluster_compact(out)
    nk, comp = out
    if nk == 0:
        return []
    packed = _host(_start_host_copies(comp)["packed"])[:nk].view(np.uint32)
    sidx = (packed & np.uint32(0x7FFFFFFF)).astype(np.int64)
    bounds = np.flatnonzero(packed[1:] >> np.uint32(31)) + 1
    slices = []
    lo = 0
    for hi in list(bounds) + [nk]:
        slices.append(sidx[lo:int(hi)])
        lo = int(hi)
    return slices


def _pair_cluster_slices(k1, k2, aux, keys, read_count, bias, break_on_k2,
                         device):
    """Run the pair-cluster program on ``device`` to the end."""
    return _pair_cluster_finish(_pair_cluster_start(
        k1, k2, aux, keys, read_count, bias, break_on_k2, device))


def _fetch_shards(outs, keys) -> list:
    """Host copies of each shard output's first ``n_kept`` rows of
    ``keys``: every n_kept copy starts before any is read, and every row
    copy before any is read. Returns [(n_kept, {key: numpy})] in shard
    order."""
    counts = [_copy_to_host(o["n_kept"]) for o in outs]
    nks = [int(_host(c)) for c in counts]
    pending = [{k: _copy_to_host(o[k][:nk]) for k in keys} if nk else {}
               for o, nk in zip(outs, nks)]
    return [(nk, {k: _host(v) for k, v in p.items()})
            for nk, p in zip(nks, pending)]


def _shard_bounds(k1, n_shards: int, bias: int):
    """[0, cuts..., n] of a stream of ``n`` rows and its padded shard
    size, or None where the JAX package runs the serial program (fewer
    than 4 rows per shard, or no clean cut)."""
    n = len(k1)
    if n < 4 * n_shards:
        return None
    cuts = _gap_cuts(np.asarray(k1, np.int64), n_shards, bias)
    if cuts is None:
        return None
    bounds = [0] + cuts + [n]
    return bounds, padded_size(max(hi - lo for lo, hi in zip(bounds,
                                                             bounds[1:])))


def _pair_cluster_slices_sharded(k1, k2, aux, keys, read_count, bias,
                                 break_on_k2, devices, device):
    """Sharded :func:`_pair_cluster_slices`: the program on each k1-gap
    cut (a k1 gap > bias always opens a cluster, so no cluster spans two
    shards), shard k on ``devices[k]``. The serial program runs on
    ``device`` where no clean cut exists."""
    n = len(k1)
    if n == 0:
        return []
    plan = _shard_bounds(k1, len(devices), bias)
    if plan is None:
        return _pair_cluster_slices(k1, k2, aux, keys, read_count, bias,
                                    break_on_k2, device)
    bounds, shard_rows = plan
    # read identities ranked over the whole stream, before the cut
    _, rid = np.unique(np.asarray(keys), return_inverse=True)
    cols = [np.asarray(k1), np.asarray(k2), np.asarray(aux), rid]
    outs = sharded_pair_cluster(
        [tuple(_upload(c[lo:hi], shard_rows, dev) for c in cols) + (hi - lo,)
         for dev, lo, hi in zip(devices, bounds, bounds[1:])],
        bias, read_count, shard_rows, bool(break_on_k2))
    # shards are stream-order contiguous, so their cluster slices in
    # shard order are the global program's order
    slices = []
    for k, (nk, got) in enumerate(_fetch_shards(outs,
                                                ("cid", "stream_idx"))):
        if nk == 0:
            continue
        sidx = got["stream_idx"].astype(np.int64) + bounds[k]
        lo = 0
        for hi in list(np.flatnonzero(np.diff(got["cid"])) + 1) + [nk]:
            slices.append(sidx[lo:int(hi)])
            lo = int(hi)
    return slices


def resolve_pair_start(sigs: Sequence, is_inv: bool, read_count: int,
                       max_cluster_bias: int, device=None, n_shards: int = 1,
                       shard_devices=None):
    """Enqueue the DUP/INV pair-cluster program for one chromosome without
    fetching. Returns opaque state for :func:`resolve_pair_finish`. With
    ``n_shards`` > 1 and a shard device list (``parallel/mesh.py``) the
    sharded programs run to the end here and the state is ``"done"``."""
    device = resolve_device(device)
    devices = pmesh.shard_devices(n_shards, device, shard_devices)
    if is_inv:
        aux = np.fromiter((0 if r[0] == "++" else 1 for r in sigs),
                          np.int64, len(sigs))
        k1 = [r[1] for r in sigs]
        k2 = [r[2] for r in sigs]
        keys = [r[3] for r in sigs]
    else:
        aux = np.zeros(len(sigs), np.int64)
        k1 = [r[0] for r in sigs]
        k2 = [r[1] for r in sigs]
        keys = [r[2] for r in sigs]
    if devices is not None:
        return ("done", _pair_cluster_slices_sharded(
            k1, k2, aux, keys, read_count, max_cluster_bias, is_inv,
            devices, device))
    return ("pending", _pair_cluster_start(
        k1, k2, aux, keys, read_count, max_cluster_bias, is_inv, device))


def resolve_pair_compact(state):
    """Read n_kept and enqueue the output compaction of a pending pair
    state (run before prefetch_to_host so host copies move packed rows);
    a ``"done"`` state passes through."""
    kind, payload = state
    if kind != "pending":
        return state
    return ("pending", _pair_cluster_compact(payload))


def resolve_pair_finish(state, sigs: Sequence, is_inv: bool, chrom: str,
                        read_count: int, max_cluster_bias: int,
                        sv_size: int, max_size: int, action: bool,
                        names: Optional[Sequence[str]] = None,
                        clusters_out: Optional[list] = None):
    """Fetch a dispatched pair-cluster program and emit candidates;
    identical outputs to models.host.resolve_dup / resolve_inv. A
    ``clusters_out`` list receives the number of cluster slices walked."""
    kind, payload = state
    slices = payload if kind == "done" else _pair_cluster_finish(payload)
    if clusters_out is not None:
        clusters_out.append(len(slices))
    render = (lambda k: names[k]) if names is not None else (lambda k: k)
    candidates: List[list] = []
    gt_jobs: List[dict] = []
    emit = inv_cluster_emit if is_inv else dup_cluster_emit
    for sl in slices:
        cluster = [sigs[int(i)] for i in sl]
        emit(cluster, chrom, read_count, max_cluster_bias, sv_size,
             max_size, action, render, candidates, gt_jobs)
    return candidates, gt_jobs


def resolve_tra_start(sigs: Sequence, read_count: int,
                      max_cluster_bias: int, device=None, n_shards: int = 1,
                      shard_devices=None):
    """Enqueue the TRA/BND cluster program for one chromosome
    (resolution_TRA, cuteSV_resolveTRA.py:30-105, clustering half).

    TRA clustering is the pair-cluster program with k1=pos1, k2=pos2 and
    aux encoding (chr2, bnd_type): the reference breaks clusters on a
    chr2 change, a type change or a pos1 gap, gates on raw size AND
    distinct support, and walks each cluster p2-sorted, which is the
    program's contract. Returns opaque state for
    :func:`resolve_tra_finish` (``"done"`` when sharded, as
    :func:`resolve_pair_start`)."""
    n = len(sigs)
    if n == 0:
        return None
    device = resolve_device(device)
    devices = pmesh.shard_devices(n_shards, device, shard_devices)
    ty = np.fromiter((ord(r[0][0]) for r in sigs), np.int64, n)
    p1 = np.fromiter((r[1] for r in sigs), np.int64, n)
    p2 = np.fromiter((r[3] for r in sigs), np.int64, n)
    c2 = _equality_codes([r[2] for r in sigs])
    rid = _equality_codes([r[4] for r in sigs])
    aux = c2 * 4 + (ty - ord("A"))
    if devices is not None:
        return ("done", _pair_cluster_slices_sharded(
            p1, p2, aux, rid, read_count, max_cluster_bias, False, devices,
            device), (p1, p2, rid))
    return ("pending", _pair_cluster_start(
        p1, p2, aux, rid, read_count, max_cluster_bias, False, device),
        (p1, p2, rid))


def resolve_tra_compact(state):
    """Read n_kept and enqueue the output compaction of a pending TRA
    state (mirror of :func:`resolve_pair_compact`)."""
    if state is None:
        return None
    kind, payload, arrs = state
    if kind != "pending":
        return state
    return ("pending", _pair_cluster_compact(payload), arrs)


def resolve_tra_finish(state, sigs: Sequence, chr_1: str, read_count: int,
                       overlap_size: float, max_cluster_bias: int,
                       tables, chrom_lengths, action: bool, gt_round: int,
                       names: Optional[Sequence[str]] = None,
                       jobs_out: Optional[list] = None,
                       clusters_out: Optional[list] = None):
    """Fetch a dispatched TRA cluster program and emit candidates;
    identical outputs to models.host.resolve_tra (the emission half is
    the shared _tra_emit_clusters). With ``jobs_out`` the genotype is
    left to the caller's batched cover pass (pipeline._tra_cover_prepare)
    and the jobs are appended there. A ``clusters_out`` list receives
    the number of cluster slices walked."""
    if state is None:
        return []
    kind, payload, (p1, p2, rid) = state
    slices = payload if kind == "done" else _pair_cluster_finish(payload)
    if clusters_out is not None:
        clusters_out.append(len(slices))
    if not slices:
        return []
    order_rows = np.concatenate(slices)
    lens = np.fromiter((len(s) for s in slices), np.int64, len(slices))
    cids = np.repeat(np.arange(len(slices), dtype=np.int64), lens)
    return _tra_emit_clusters(
        sigs, order_rows, p1[order_rows], p2[order_rows], rid[order_rows],
        cids, lens, chr_1, read_count, overlap_size, max_cluster_bias,
        tables, chrom_lengths, action, gt_round, names, jobs_out=jobs_out)


def resolve_tra_device(sigs: Sequence, chr_1: str, read_count: int,
                       overlap_size: float, max_cluster_bias: int,
                       tables, chrom_lengths, action: bool, gt_round: int,
                       names: Optional[Sequence[str]] = None, device=None,
                       n_shards: int = 1, shard_devices=None):
    """Device counterpart of models.host.resolve_tra; identical outputs."""
    state = resolve_tra_start(sigs, read_count, max_cluster_bias, device,
                              n_shards, shard_devices)
    return resolve_tra_finish(state, sigs, chr_1, read_count, overlap_size,
                              max_cluster_bias, tables, chrom_lengths,
                              action, gt_round, names)


def resolve_dup_device(sigs: Sequence, chrom: str, read_count: int,
                       max_cluster_bias: int, sv_size: int, max_size: int,
                       action: bool, names: Optional[Sequence[str]] = None,
                       device=None, n_shards: int = 1, shard_devices=None):
    """Device counterpart of models.host.resolve_dup; identical outputs.
    Program rows arrive sorted by pos2 (stable), so the host emission's
    stable re-sort is a no-op."""
    state = resolve_pair_start(sigs, False, read_count, max_cluster_bias,
                               device, n_shards, shard_devices)
    return resolve_pair_finish(state, sigs, False, chrom, read_count,
                               max_cluster_bias, sv_size, max_size, action,
                               names)


def resolve_inv_device(sigs: Sequence, chrom: str, read_count: int,
                       max_cluster_bias: int, sv_size: int, max_size: int,
                       action: bool, names: Optional[Sequence[str]] = None,
                       device=None, n_shards: int = 1, shard_devices=None):
    """Device counterpart of models.host.resolve_inv; identical outputs."""
    state = resolve_pair_start(sigs, True, read_count, max_cluster_bias,
                               device, n_shards, shard_devices)
    return resolve_pair_finish(state, sigs, True, chrom, read_count,
                               max_cluster_bias, sv_size, max_size, action,
                               names)


# ---------------------------------------------------------------------------
# genome-batched DEL/INS resolution: one kernel dispatch covers many
# chromosomes. Positions are offset into disjoint ranges (separated by more
# than max_cluster_bias) so clusters can never span chromosomes; batches
# are capped so offset coordinates stay within int32.
# ---------------------------------------------------------------------------

_INT32_SAFE = 2_000_000_000


def _chrom_batches(streams, bias):
    """Group ordered (chrom, stream) pairs into int32-safe offset batches;
    yields lists of (chrom, stream, offset)."""
    batches = []
    cur = []
    cur_off = 0
    for chrom, stream in streams:
        span = (int(stream.pos[-1]) if len(stream) else 0) + bias + 2
        if cur and cur_off + span > _INT32_SAFE:
            batches.append(cur)
            cur = []
            cur_off = 0
        cur.append((chrom, stream, cur_off))
        cur_off += span
    if cur:
        batches.append(cur)
    return batches


class _Facade:
    """Concatenated view over per-chromosome streams for one genome batch:
    offset positions for the cluster kernel plus the (chrom, local-row)
    mapping the finish phase needs to route results back. Per-row
    sequence access stays on the member streams (emission reads them per
    chromosome)."""

    def __init__(self, members):
        self.pos = np.concatenate([s.pos + off for _, s, off in members])
        self.length = np.concatenate([s.length for _, s, _ in members])
        self.rid = np.concatenate([s.rid for _, s, _ in members])
        self._chrom = np.concatenate(
            [np.full(len(s), i, np.int64)
             for i, (_, s, _) in enumerate(members)])
        self._local = np.concatenate(
            [np.arange(len(s), dtype=np.int64) for _, s, _ in members])

    def __len__(self):
        return len(self.pos)


def resolve_indel_multi_start(streams, is_ins: bool, read_count: int,
                              max_cluster_bias: int, device=None,
                              early=None, n_shards: int = 1,
                              shard_devices=None):
    """Phase 1 of the genome-batched DEL/INS resolver: enqueue the cluster
    program for every int32-safe batch on ``device``. Returns opaque
    state for :func:`resolve_indel_multi_finish`. Enqueueing both SV
    types before reading either's ``n_kept`` overlaps device compute
    with host work. ``early``: {chrom: program handle} dispatched during
    the streaming decode (validated by build_store_native); those
    chromosomes become singleton jobs that reuse the handles (exact
    single-device results, whatever ``n_shards``). With ``n_shards`` > 1
    and a shard device list the other batches become ``"sharded"`` jobs,
    run at the finish (the cuts are computed on the host)."""
    device = resolve_device(device)
    devices = pmesh.shard_devices(n_shards, device, shard_devices)
    out = {}
    jobs = []
    streams = [(c, _as_stream(s, is_ins)) for c, s in streams]
    if early:
        rest = []
        for c, s in streams:
            h = early.get(c)
            if h is not None and len(s):
                members = [(c, s, 0)]
                jobs.append((members, _Facade(members), "kernel", h))
            else:
                rest.append((c, s))
        streams = rest
    for batch in _chrom_batches(streams, max_cluster_bias):
        members = [(c, s, off) for c, s, off in batch if len(s)]
        for c, s, off in batch:
            if not len(s):
                out[c] = ([], [])
        if not members:
            continue
        facade = _Facade(members)
        if devices is not None:
            jobs.append((members, facade, "sharded", None))
        else:
            jobs.append((members, facade, "kernel",
                         _cluster_stream_dispatch(facade, read_count,
                                                  max_cluster_bias, device)))
    return dict(out=out, jobs=jobs, is_ins=is_ins, read_count=read_count,
                max_cluster_bias=max_cluster_bias, device=device,
                devices=devices)


def resolve_indel_multi_compact(state) -> None:
    """Phase 1.5: read each program's n_kept and enqueue the on-device
    output compaction. Run for every state BEFORE prefetch_to_host so
    the host copies move compacted rows only."""
    state["jobs"] = [
        (members, facade, kind,
         _cluster_stream_compact(handle) if kind == "kernel" else handle)
        for members, facade, kind, handle in state["jobs"]]


def resolve_indel_multi_finish(state, threshold_gloab: float,
                               minimum_support_reads: int,
                               remain_reads_ratio: float, action: bool,
                               need_names: bool = True):
    """Phase 2: fetch program outputs and run the per-chromosome host
    emission; returns {chrom: (candidates, gt_jobs)}."""
    emit = _emit_ins if state["is_ins"] else _emit_del
    out = state["out"]
    max_cluster_bias = state["max_cluster_bias"]
    for members, facade, kind, handle in state["jobs"]:
        if kind == "sharded":
            res = _cluster_stream_sharded(facade, state["read_count"],
                                          max_cluster_bias, state["devices"],
                                          state["device"])
        else:
            res = _cluster_stream_fetch(handle)
        if res is None or len(res[0]) == 0:
            for c, _, _ in members:
                out.setdefault(c, ([], []))
            continue
        cid, pos, length, sidx = res
        row_chrom = facade._chrom[sidx]
        offs = np.array([off for _, _, off in members], np.int64)
        pos = pos - offs[row_chrom]
        # kept rows are sorted by cluster; clusters never span chromosomes,
        # so each chromosome owns a contiguous slice
        bounds = np.flatnonzero(np.diff(row_chrom)) + 1
        lo = 0
        for hi in list(bounds) + [len(row_chrom)]:
            hi = int(hi)
            ci = int(row_chrom[lo])
            chrom, stream, _ = members[ci]
            local_sidx = facade._local[sidx[lo:hi]]
            out[chrom] = emit(cid[lo:hi], pos[lo:hi], length[lo:hi],
                              local_sidx, stream, chrom, threshold_gloab,
                              max_cluster_bias, minimum_support_reads,
                              remain_reads_ratio, action,
                              need_names=need_names)
            lo = hi
        for c, _, _ in members:
            out.setdefault(c, ([], []))
    return out


def resolve_indel_device_multi(streams, is_ins: bool, read_count: int,
                               threshold_gloab: float,
                               max_cluster_bias: int,
                               minimum_support_reads: int,
                               remain_reads_ratio: float, action: bool,
                               n_shards: int = 1, device=None,
                               shard_devices=None):
    """Resolve DEL or INS across many chromosomes with one cluster-program
    dispatch per int32-safe batch (or per shard of it). ``streams``:
    ordered (chrom, stream) pairs; returns {chrom: (candidates,
    gt_jobs)}, byte-identical to the per-chromosome resolvers."""
    state = resolve_indel_multi_start(streams, is_ins, read_count,
                                      max_cluster_bias, device,
                                      n_shards=n_shards,
                                      shard_devices=shard_devices)
    resolve_indel_multi_compact(state)
    return resolve_indel_multi_finish(state, threshold_gloab,
                                      minimum_support_reads,
                                      remain_reads_ratio, action)


# ---------------------------------------------------------------------------
# multi-device clustering: cut the merged stream at inter-cluster gaps so
# every device runs the exact local program (no cluster spans a shard)
# ---------------------------------------------------------------------------

def _gap_cuts(pos: np.ndarray, n_shards: int, bias: int):
    """Shard boundaries at positions where pos[i]-pos[i-1] > bias, chosen
    nearest to equal splits. Returns cut indices (len n_shards-1) or None
    when no valid gap exists near some split (caller falls back)."""
    n = len(pos)
    gaps = np.flatnonzero(np.diff(pos) > bias) + 1  # valid cut indices
    if len(gaps) < n_shards - 1:
        return None
    cuts = []
    for k in range(1, n_shards):
        target = k * n // n_shards
        j = int(np.searchsorted(gaps, target))
        cand = []
        if j < len(gaps):
            cand.append(gaps[j])
        if j > 0:
            cand.append(gaps[j - 1])
        cut = min(cand, key=lambda c: abs(int(c) - target))
        if cuts and cut <= cuts[-1]:
            return None  # degenerate split; fall back
        cuts.append(int(cut))
    return cuts


def _cluster_stream_sharded(stream, read_count: int, bias: int, devices,
                            device):
    """Sharded :func:`_cluster_stream`: the program on each gap-aligned
    cut, shard k on ``devices[k]``, joined back in order with
    shard-unique cluster ids (``k * (shard_rows + 2)`` on) and global
    stream indices. The serial program runs on ``device`` where no clean
    cut exists."""
    n = len(stream)
    if n == 0:
        return None
    plan = _shard_bounds(stream.pos, len(devices), bias)
    if plan is None:
        return _cluster_stream(stream, read_count, bias, device)
    bounds, shard_rows = plan
    cols = (stream.pos, stream.length, stream.rid)
    outs = sharded_cluster_structure(
        [tuple(_upload(c[lo:hi], shard_rows, dev) for c in cols) + (hi - lo,)
         for dev, lo, hi in zip(devices, bounds, bounds[1:])],
        bias, read_count, shard_rows)
    cids, poss, lens, sidxs = [], [], [], []
    for k, (nk, got) in enumerate(_fetch_shards(
            outs, ("cid", "pos", "length", "stream_idx"))):
        if nk == 0:
            continue
        cids.append(got["cid"].astype(np.int64) + k * (shard_rows + 2))
        poss.append(got["pos"].astype(np.int64))
        lens.append(got["length"].astype(np.int64))
        sidxs.append(got["stream_idx"].astype(np.int64) + bounds[k])
    if not cids:
        return (np.empty(0, np.int64),) * 4
    return (np.concatenate(cids), np.concatenate(poss),
            np.concatenate(lens), np.concatenate(sidxs))
