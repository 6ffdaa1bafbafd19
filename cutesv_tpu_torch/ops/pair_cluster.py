"""DUP/INV/TRA cluster-structure program (PyTorch).

Device side of resolution for two-breakpoint signature streams
(cuteSV_resolveDUP.py:17-131, cuteSV_resolveINV.py:6-203,
cuteSV_resolveTRA.py:30-105): primary gap clustering over k1 (also
breaking on aux changes, and on k2 gaps for INV), the raw-size and
distinct-support gates, and the per-cluster re-sort by k2 that defines
sub-clusters. Sub-group segmentation and the small band/running means
stay on the host (models/device.py), where exact integer sums reproduce
the reference's Python arithmetic.

The same computation as ``cutesv_tpu/ops/pair_cluster.py``, output for
output, with the torch/JAX differences pinned as in
``ops/indel_cluster.py``: int32 cumsums, ``lexsort`` as chained stable
sorts, ``argmax`` of the int32 cast of an all-false mask is 0, invalid
rows carry ``cid = n + 1`` over ``n + 2`` segments, and the boundary
flag of the compacted output sits in the int32 sign bit.
"""
from __future__ import annotations

import torch

from cutesv_tpu_torch.ops import segments as seg
from cutesv_tpu_torch.ops.indel_cluster import INT32_MIN, lexsort

_I32 = torch.int32


def pair_cluster_structure(k1, k2, aux, rid, n_valid, bias, read_count,
                           num_rows: int, break_on_k2: bool):
    """All tensors are int32 of length ``num_rows`` (padded; the first
    ``n_valid`` rows are real — the mask is derived on the device).
    ``n_valid``, ``bias`` and ``read_count`` are ints; ``break_on_k2``
    is a Python bool (a static argument in JAX). Returns kept rows sorted
    by (cluster, k2, stream order) plus ``n_kept`` (a 0-d int32 tensor on
    the device)."""
    n = num_rows
    dev = k1.device
    idx = torch.arange(n, dtype=_I32, device=dev)
    valid = idx < n_valid
    big = n + 1

    prev_k1 = torch.cat([k1[:1], k1[:-1]])
    prev_k2 = torch.cat([k2[:1], k2[:-1]])
    prev_aux = torch.cat([aux[:1], aux[:-1]])
    new_cluster = ((k1 - prev_k1) > bias) | (aux != prev_aux)
    if break_on_k2:
        new_cluster = new_cluster | ((k2 - prev_k2) > bias)
    new_cluster = new_cluster & valid
    new_cluster[0] = False
    cid = torch.cumsum(new_cluster.to(_I32), 0, dtype=_I32)
    cid = cid.masked_fill(~valid, big)

    size = seg.seg_sum(valid.to(_I32), cid, n + 2)
    size_ok = size[cid.long()] >= read_count

    # distinct rids per cluster via a (cid, rid) sort
    order1 = lexsort((rid, cid))   # idx is the identity tiebreak
    s_cid = cid[order1]
    s_rid = rid[order1]
    s_valid = valid[order1]
    grp_first = seg.boundary_flags(s_cid, s_rid, valid=s_valid)
    first_valid = torch.argmax(s_valid.to(_I32))
    grp_first = grp_first | (torch.arange(n, device=dev) == first_valid)
    grp_first = grp_first & s_valid
    distinct = seg.seg_sum(grp_first.to(_I32), s_cid, n + 2)
    dist_ok = distinct >= read_count

    kept = valid & size_ok & dist_ok[cid.long()]
    sort_cid = cid.masked_fill(~kept, big)
    order2 = lexsort((k2, sort_cid))
    return dict(
        cid=sort_cid[order2],
        k1=k1[order2],
        k2=k2[order2],
        rid=rid[order2],
        stream_idx=idx[order2],
        n_kept=kept.to(_I32).sum(dtype=_I32),
    )


def compact_pair_outputs(cid, stream_idx, cap_out: int):
    """The leading ``cap_out`` rows (kept rows sort to the front) as one
    int32 per row: ``stream_idx`` with the new-cluster boundary flag in
    bit 31 (the sign bit). ``packed.view(uint32)`` on the host is the JAX
    package's uint32 layout."""
    boundary = torch.ones(cid.shape[0], dtype=torch.bool, device=cid.device)
    boundary[1:] = cid[1:] != cid[:-1]
    sidx = stream_idx.to(_I32)
    packed = torch.where(boundary, sidx | INT32_MIN, sidx)
    return packed[:cap_out]


def sharded_pair_cluster(shards, bias, read_count, shard_rows: int,
                         break_on_k2: bool):
    """The pair program on each shard of a stream cut at k1 gaps > bias
    (always a cluster boundary: the break conditions are OR-ed, so each
    shard's result equals the global computation's rows). ``shards``:
    one ``(k1, k2, aux, rid, n_valid)`` per shard, tensors of
    ``shard_rows`` rows on that shard's device. Every shard is enqueued
    before any is read; returns the per-shard output dicts, each on its
    shard's device. The counterpart of the JAX package's ``shard_map``
    wrapper."""
    return [pair_cluster_structure(k1, k2, aux, rid, n_valid, bias,
                                   read_count, shard_rows, break_on_k2)
            for k1, k2, aux, rid, n_valid in shards]
