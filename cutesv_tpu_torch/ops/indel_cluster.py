"""DEL/INS cluster-structure program (PyTorch).

Device side of the resolution algorithm (cuteSV_resolveINDEL.py): given the
merged, sorted signature stream of one chromosome batch as dense int32
tensors, compute

  1. gap clusters          (new cluster when pos gap > max_cluster_bias)
  2. cluster size gate     (raw size  >= read_count)
  3. per-read dedup        (keep max length; first occurrence wins ties and
                            keeps the read's first-occurrence stream order)
  4. distinct-support gate (distinct reads >= read_count)
  5. the allele stream     (kept rows re-sorted by (cluster, len,
                            first-occurrence order))

The same computation as ``cutesv_tpu/ops/indel_cluster.py``, output for
output. Everything here is integer sorting and segment reductions; the
float allele finalization stays on the host (models/device.py). Where
PyTorch and JAX differ, this module pins the JAX behavior:

  * every cumsum passes ``dtype=torch.int32`` (``torch.cumsum`` widens
    int32 to int64 otherwise);
  * ``jnp.lexsort`` is a stable multi-key sort; :func:`lexsort` chains
    ``torch.sort(stable=True)`` from the least to the most significant
    key, so ties keep their row order exactly as JAX does;
  * ``jnp.argmax`` of a bool vector is taken over its int32 cast (0 when
    no row is valid);
  * the new-cluster flag is packed into bit 31 of an int32 (the sign
    bit) instead of a uint32; the host reinterprets it as uint32.
"""
from __future__ import annotations

import torch

from cutesv_tpu_torch.ops import segments as seg

_I32 = torch.int32
INT32_MIN = -2**31


def lexsort(keys):
    """Indices sorting by ``keys`` (least significant first), stably —
    ``np.lexsort``/``jnp.lexsort`` semantics as a chain of stable sorts."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def indel_cluster_structure(pos, length, rid, n_valid, max_cluster_bias,
                            read_count, num_rows: int):
    """All tensors are int32 of length ``num_rows`` (padded; the first
    ``n_valid`` rows are real — the mask is derived on the device).
    ``n_valid``, ``max_cluster_bias`` and ``read_count`` are ints or 0-d
    int32 tensors on the device (every use is elementwise, so a captured
    CUDA graph reads them from its static input). Returns a dict of
    tensors in 'allele stream' order plus ``n_kept`` (a 0-d int32 tensor
    on the device)."""
    n = num_rows
    dev = pos.device
    idx = torch.arange(n, dtype=_I32, device=dev)
    valid = idx < n_valid
    big = n + 1

    # --- 1. gap clusters over the (already sorted) stream ---------------
    prev_pos = torch.cat([pos[:1], pos[:-1]])
    new_cluster = ((pos - prev_pos) > max_cluster_bias) & valid
    new_cluster[:1].fill_(False)   # a fill, not a host copy: capturable
    cid = torch.cumsum(new_cluster.to(_I32), 0, dtype=_I32)
    cid = cid.masked_fill(~valid, big)

    # --- 2. raw size gate ------------------------------------------------
    size = seg.seg_sum(valid.to(_I32), cid, n + 2)
    size_ok = size[cid.long()] >= read_count

    # --- 3. dedup sort: (cid, rid, -len, idx) ---------------------------
    order1 = lexsort((-length, rid, cid))   # idx is the identity tiebreak
    s_cid = cid[order1]
    s_rid = rid[order1]
    s_len = length[order1]
    s_pos = pos[order1]
    s_idx = idx[order1]
    s_valid = valid[order1]
    s_size_ok = size_ok[order1]

    grp_first = seg.boundary_flags(s_cid, s_rid, valid=s_valid)
    first_valid = torch.argmax(s_valid.to(_I32))
    grp_first = grp_first | (torch.arange(n, device=dev) == first_valid)
    grp_first = grp_first & s_valid
    # group ids over (cid, rid)
    gid = torch.cumsum(grp_first.to(_I32), 0, dtype=_I32)
    gid = gid.masked_fill(~s_valid, big)
    ins_key = seg.seg_min(s_idx.masked_fill(~s_valid, big), gid,
                          n + 2)[gid.long()]

    # --- 4. distinct support gate ---------------------------------------
    distinct = seg.seg_sum(grp_first.to(_I32), s_cid, n + 2)
    dist_ok = distinct[s_cid.long()] >= read_count

    kept = grp_first & s_size_ok & dist_ok

    # --- 5. allele stream sort: kept rows by (cid, len, ins_key) --------
    sort_cid = s_cid.masked_fill(~kept, big)
    order2 = lexsort((ins_key, s_len, sort_cid))
    return dict(
        cid=sort_cid[order2],
        pos=s_pos[order2],
        length=s_len[order2],
        stream_idx=s_idx[order2],
        n_kept=kept.to(_I32).sum(dtype=_I32),
    )


def pack_cluster_ids(cid, stream_idx):
    """``stream_idx`` with the new-cluster boundary flag packed into bit
    31 — int32 here, so the flag is the sign bit; ``packed.view(uint32)``
    on the host is the JAX package's uint32 layout. The host rebuilds
    dense cluster ids as cumsum(boundary) - 1, an order-preserving
    relabeling of ``cid``."""
    boundary = torch.ones(cid.shape[0], dtype=torch.bool, device=cid.device)
    boundary[1:] = cid[1:] != cid[:-1]
    sidx = stream_idx.to(_I32)
    return torch.where(boundary, sidx | INT32_MIN, sidx)


def compact_cluster_outputs(cid, pos, length, stream_idx, cap_out: int):
    """Shrink cluster outputs to the leading ``cap_out`` rows (kept rows
    sort to the front), ``stream_idx`` packed by
    :func:`pack_cluster_ids`."""
    packed = pack_cluster_ids(cid, stream_idx)
    return dict(pos=pos[:cap_out], length=length[:cap_out],
                packed=packed[:cap_out])


def sharded_cluster_structure(shards, max_cluster_bias, read_count,
                              shard_rows: int):
    """The program on each shard of a stream cut at inter-cluster gaps
    (pos gap > max_cluster_bias: no cluster spans two shards, so each
    shard's result equals the global computation's rows). ``shards``:
    one ``(pos, length, rid, n_valid)`` per shard, tensors of
    ``shard_rows`` rows on that shard's device. Every shard is enqueued
    before any is read; returns the per-shard output dicts (``cid``,
    ``pos``, ``length``, ``stream_idx``, ``n_kept``), each on its
    shard's device. The counterpart of the JAX package's ``shard_map``
    wrapper."""
    return [indel_cluster_structure(pos, length, rid, n_valid,
                                    max_cluster_bias, read_count, shard_rows)
            for pos, length, rid, n_valid in shards]
