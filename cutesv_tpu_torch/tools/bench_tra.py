"""BND-storm benchmark of the port, three ways:

  1. the per-row loop oracle with full-table fetch scans
     (``models/host.resolve_tra_oracle`` with ``ReadTable._window`` off),
  2. the numpy host path (``models/host.resolve_tra``, inline
     ``count_coverage`` replay),
  3. the device path: the pair-cluster program
     (``resolve_tra_start``/``_compact``/``_finish``) and the batched
     cover-kernel genotype with exact early-exit replay
     (``pipeline._tra_cover_pass`` given the kernel's ``cover_fn``), the
     ``--engine device`` composition.

It synthesizes a breakend storm (many TRA clusters against several mate
chromosomes over a dense read census with rank-identity names, the
native store's shape), checks that the three arms give the same
candidates, and prints their wall times. The port's counterpart of the
repo's ``tools/bench_tra.py``, with the same storm from the same seed.

    python -m cutesv_tpu_torch.tools.bench_tra [n_sigs] [census_rows] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import functools
import random
import time


def build_storm(n_sigs: int, census_rows: int, seed: int = 1):
    """(sigs, read tables, chromosome lengths, names) of the storm: ~10
    signatures per breakend site on chr1, mates on six chromosomes, a
    ~30x census whose genome grows with it (up to 990 Mb, inside the
    cover kernel's int32 coordinate budget)."""
    from cutesv_tpu_torch.genotype import ReadTable

    rng = random.Random(seed)
    chrom_len = min(990_000_000,
                    max(200_000_000, census_rows * 22_500 // 30))
    mates = ["chr2", "chr3", "chr5", "chr11", "chr17", "chr22"]
    tables = {}
    chrom_lengths = {"chr1": chrom_len}
    names = []
    for c in mates:
        chrom_lengths[c] = chrom_len
    chr1_names = None
    for c in ["chr1"] + mates:
        n = census_rows if c == "chr1" else census_rows // 4
        starts = sorted(rng.randrange(0, chrom_len - 60_000)
                        for _ in range(n))
        ends = [s + rng.randrange(5_000, 40_000) for s in starts]
        prim = [1 if rng.random() < 0.8 else 0 for _ in range(n)]
        # rank-identity names, globally unique primaries (the native
        # store's invariant, which enables the batched TRA fast path)
        rids = []
        for _ in range(n):
            rids.append(len(names))
            names.append("q%07d" % len(names))
        tables[c] = ReadTable(starts, ends, prim, rids)
        if c == "chr1":
            chr1_names = rids
    sigs = []
    for _ in range(max(1, n_sigs // 10)):
        t = rng.choice("ABCD")
        c2 = rng.choice(mates)
        p1 = rng.randrange(10_000, chrom_len - 10_000)
        p2 = rng.randrange(10_000, chrom_len - 10_000)
        for _ in range(10):
            sigs.append((t, p1 + rng.randrange(0, 30),
                         c2, p2 + rng.randrange(0, 30),
                         rng.choice(chr1_names)))
    sigs.sort(key=lambda r: (r[2], r[0], r[1], r[3], r[4]))
    return sigs, tables, chrom_lengths, names


def run_device(sigs, tables, chrom_lengths, names, args, device):
    """The device composition on ``device``: the cluster program, then
    the batched cover genotype through the cover kernel's wrapper (the
    plain version on a CPU device)."""
    from cutesv_tpu_torch.config import Config
    from cutesv_tpu_torch.models import device as dm
    from cutesv_tpu_torch.ops.cover import cover_counts_cuda
    from cutesv_tpu_torch.pipeline import _tra_cover_pass
    from cutesv_tpu_torch.sigstore import SigStore

    chrom, min_sup, ratio, bias, _, _, action, gt_round = args
    state = dm.resolve_tra_start(sigs, min_sup, bias, device)
    dm.prefetch_counts(state)
    state = dm.resolve_tra_compact(state)
    dm.prefetch_to_host(state)
    jobs = []
    cands = dm.resolve_tra_finish(state, sigs, chrom, min_sup, ratio, bias,
                                  tables, chrom_lengths, action, gt_round,
                                  names=names, jobs_out=jobs)
    if action:
        store = SigStore(sigs={}, census={}, read_tables=tables,
                         chrom_lengths=chrom_lengths, names=names)
        cfg = Config(min_support=min_sup, max_cluster_bias_TRA=bias,
                     gt_round=gt_round, genotype=True, engine="device")
        _tra_cover_pass({chrom: (cands, jobs)}, store, cfg,
                        functools.partial(cover_counts_cuda, device=device))
    return cands


def run(n_sigs: int, census: int, device=None, reps: int = 3) -> dict:
    """The three arms on one storm: their candidates (which must be
    equal, or this raises) and wall seconds (min of ``reps`` interleaved
    runs for the device and host arms, after one warm device run; one
    run of the loop oracle)."""
    import torch

    from cutesv_tpu_torch.models.host import resolve_tra, resolve_tra_oracle
    from cutesv_tpu_torch.utils.torchsetup import resolve_device

    device = resolve_device(device)
    sigs, tables, chrom_lengths, names = build_storm(n_sigs, census)
    args = ("chr1", 3, 0.6, 50, tables, chrom_lengths, True, 500)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run_device(sigs, tables, chrom_lengths, names, args, device)  # warm
    sync()
    dev_runs, host_runs = [], []
    for _ in range(reps):
        t0 = time.time()
        dev = run_device(sigs, tables, chrom_lengths, names, args, device)
        sync()
        dev_runs.append(time.time() - t0)
        t0 = time.time()
        fast = resolve_tra(sigs, *args, names=names)
        host_runs.append(time.time() - t0)
    # the loop oracle: per-row loops and full-table fetch scans
    for t in tables.values():
        t._sorted = False
    t0 = time.time()
    slow = resolve_tra_oracle(sigs, *args, names=names)
    dt_slow = time.time() - t0
    for t in tables.values():
        t._sorted = None
    if fast != slow:
        raise AssertionError("numpy host diverges from the loop oracle")
    if dev != fast:
        raise AssertionError("device path diverges from the numpy host")
    return dict(n_sigs=len(sigs), census=census, device=str(device),
                candidates=dev, device_s=min(dev_runs),
                host_s=min(host_runs), oracle_s=dt_slow)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_sigs", type=int, nargs="?", default=50_000)
    p.add_argument("census", type=int, nargs="?", default=400_000)
    p.add_argument("--device", default="cuda",
                   help="device of the device arm (cuda, cuda:k or cpu)")
    a = p.parse_args(argv)
    res = run(a.n_sigs, a.census, a.device)
    print("BND storm: %d sigs, %d emitted candidates, census %d rows, "
          "device %s" % (res["n_sigs"], len(res["candidates"]),
                         res["census"], res["device"]))
    print("device (program + batched cover): %.3fs   numpy host: %.3fs   "
          "loop oracle: %.3fs" % (res["device_s"], res["host_s"],
                                  res["oracle_s"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
