"""Genome-axis sharding over a list of devices (the ``--n_shards`` path).

The counterpart of ``cutesv_tpu/parallel/mesh.py``. A torch process has
no ``shard_map``: a "mesh" here is a list of devices, one per shard,
which may repeat a device (``[cpu] * 8`` in the tests, ``[cuda:0] * 2``
on a one-card machine), and each sharded function loops over it,
enqueueing every shard before it reads any back, so that shards on
different cards overlap.

* :func:`sharded_cluster_sizes` keeps the JAX program's steps: each
  shard's last valid position gathered to the host (the ``all_gather``),
  the carry from earlier shards, the previous valid position past pad
  rows (a masked-index ``cummax`` in place of ``lax.scan``), the
  exclusive scan of boundary counts for global ids, and per-shard sizes
  summed over the shards (the ``psum``).
* :func:`sharded_cover_counts` splits the SV-window axis into one slice
  per device and gives every device all the reads: one launch of the
  CUDA cover kernel per slice on a card, the plain version on a CPU
  device.

The production ``--n_shards`` programs (DEL/INS and pair clusters over
gap-aligned stream cuts) are in ``models/device.py``; no cluster spans
two shards there, so they exchange nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.utils.torchsetup import resolve_device

READ_TILE = 4096
INT32_MIN = -2**31


def pick_devices(n_shards: int, device=None):
    """Devices of an ``n_shards`` run on ``device``'s kind, or None when
    there are too few (callers then run their serial program on
    ``device``). A CUDA run gets ``cuda:0 .. cuda:N-1`` when this process
    sees at least N cards (``torch.cuda.device_count()`` counts the cards
    ``CUDA_VISIBLE_DEVICES`` leaves it, so each process of a
    ``--distributed`` run counts only its own), never a CPU device; a CPU
    run gets ``[cpu] * N``, the counterpart of the JAX tests' virtual CPU
    mesh."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * n_shards
    if torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", k) for k in range(n_shards)]


def shard_devices(n_shards: int, device=None, devices=None):
    """The device list of an ``n_shards`` run on ``device``: None for a
    serial run (``n_shards <= 1``, or :func:`pick_devices` found too few
    cards); else ``devices[:n_shards]`` when the caller gave a list, or
    :func:`pick_devices`. A CUDA run takes no CPU device from a given
    list either."""
    if n_shards <= 1:
        return None
    if devices is None:
        return pick_devices(n_shards, device)
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_shards:
        raise ValueError("--n_shards %d needs %d devices; %d given"
                         % (n_shards, n_shards, len(devices)))
    if resolve_device(device).type == "cuda" and any(
            d.type != "cuda" for d in devices):
        raise ValueError("a CUDA run shards over CUDA devices only, not %s"
                         % [str(d) for d in devices])
    return devices[:n_shards]


def sharded_cluster_sizes(devices, max_cluster_bias: int):
    """The sharded gap-clustering step: sorted positions -> (cluster id
    per row, cluster sizes, number of clusters), as numpy arrays and an
    int (``jax.device_get`` of the JAX program's outputs).

    ``pos``/``valid`` split into ``len(devices)`` equal shards, shard k
    on ``devices[k]``; sizes come back summed over the shards. Pad
    anywhere with ``valid``=False rows (INT32_MIN is reserved as the
    no-previous sentinel): gaps are measured to the last VALID position,
    so per-shard tail padding and empty shards cluster like the unpadded
    serial stream."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def step(pos, valid):
        pos = torch.as_tensor(pos, dtype=torch.int32)
        valid = torch.as_tensor(valid, dtype=torch.bool)
        rows = pos.shape[0] // n
        total = rows * n  # upper bound on the cluster count
        shards = [(pos[k * rows:(k + 1) * rows].to(d),
                   valid[k * rows:(k + 1) * rows].to(d))
                  for k, d in enumerate(devices)]
        # the all_gather of each shard's last valid position (every
        # shard's reduction is enqueued before any is read)
        lasts = [torch.where(v, p, INT32_MIN).max() for p, v in shards]
        lasts = [int(t) for t in lasts]
        news = []
        for k, (p, v) in enumerate(shards):
            incoming = max([INT32_MIN] + lasts[:k])
            # per-row previous valid position: the last valid index
            # before each row (a cummax of masked indices), or the carry
            idx = torch.arange(rows, device=p.device)
            last = torch.where(v, idx, -1).cummax(0).values
            before = torch.cat([last.new_full((1,), -1), last[:-1]])
            prev = torch.where(before >= 0, p[before.clamp(min=0)],
                               incoming).long()
            news.append(v & (prev != INT32_MIN)
                        & (p.long() - prev > max_cluster_bias))
        # exclusive scan of per-shard boundary counts -> global ids
        counts = [int(t) for t in [nc.sum() for nc in news]]
        cids, sizes = [], np.zeros(total, np.int64)
        for k, ((p, v), nc) in enumerate(zip(shards, news)):
            cid = sum(counts[:k]) + torch.cumsum(nc.to(torch.int32), 0,
                                                 dtype=torch.int32)
            cid = torch.where(v, cid, -1)
            local = torch.zeros(total + 1, dtype=torch.int32,
                                device=p.device)
            local.scatter_add_(0, torch.where(v, cid, total).long(),
                               v.to(torch.int32))
            cids.append(cid.cpu().numpy())
            sizes += local[:total].cpu().numpy()  # the psum
        return (np.concatenate(cids), sizes.astype(np.int32),
                sum(counts) + 1)

    return step


def sharded_cover_counts(devices):
    """Genotype read-support counting with the SV axis sharded: returns
    ``count(sv_s, sv_e, starts, ends)`` over doubled int32 coordinates
    (numpy arrays or tensors) -> int32 numpy counts, #{reads: start <= s
    and end >= e} per window. Slice k of the windows (``ceil(S / n)`` each,
    the even split of a padded axis) goes to ``devices[k]`` with every
    read: one cover-kernel launch per slice on a card, the plain version
    on the CPU; a slice without windows launches nothing. The reads are
    copied once per distinct device."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def count(sv_s, sv_e, starts, ends):
        sv_s, sv_e, starts, ends = (torch.as_tensor(a, dtype=torch.int32)
                                    for a in (sv_s, sv_e, starts, ends))
        per = -(-sv_s.shape[0] // n)
        reads = {}
        outs = []
        for k, dev in enumerate(devices):
            if dev not in reads:
                reads[dev] = (starts.to(dev).contiguous(),
                              ends.to(dev).contiguous())
            window = slice(k * per, (k + 1) * per)
            outs.append(cover.cover_tensors(
                sv_s[window].to(dev).contiguous(),
                sv_e[window].to(dev).contiguous(), *reads[dev]))
        return np.concatenate([o.cpu().numpy() for o in outs])

    return count


def full_sharded_step(devices, max_cluster_bias: int = 200):
    """The combined per-bin step of the multi-device dry run: cluster
    segmentation + sizes + genotype cover counts."""
    cluster = sharded_cluster_sizes(devices, max_cluster_bias)
    count = sharded_cover_counts(devices)

    def step(pos, valid, sv_s, sv_e, read_starts, read_ends):
        cid, sizes, n_clusters = cluster(pos, valid)
        return cid, sizes, n_clusters, count(sv_s, sv_e, read_starts,
                                             read_ends)

    return step


def demo_inputs(n_devices: int, rows_per_shard: int = 64,
                svs_per_shard: int = 8, n_reads: int = 128, device=None):
    """Tiny, valid inputs for compile checks (the JAX package's, from the
    same seed, as tensors on ``device``): a sorted position stream with
    plausible cluster structure, SV windows and read intervals."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    total = n_devices * rows_per_shard
    gaps = rng.integers(0, 400, size=total)
    pos = np.cumsum(gaps).astype(np.int32)
    valid = np.ones(total, bool)
    valid[-rows_per_shard // 2:] = False  # padded tail
    sv_total = n_devices * svs_per_shard
    anchors = np.sort(rng.integers(0, pos.max() + 1, size=sv_total))
    sv_s = (anchors - 200).clip(0).astype(np.int32)
    sv_e = (anchors + 200).astype(np.int32)
    # reads padded to a READ_TILE multiple with never-covering sentinels
    rp = max(READ_TILE, -(-n_reads // READ_TILE) * READ_TILE)
    starts = np.full(rp, np.iinfo(np.int32).max, np.int32)
    ends = np.full(rp, np.iinfo(np.int32).min, np.int32)
    starts[:n_reads] = rng.integers(0, pos.max() + 1, size=n_reads)
    ends[:n_reads] = (starts[:n_reads]
                      + rng.integers(1000, 20000, size=n_reads))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (pos, valid, sv_s, sv_e, starts, ends))
