"""Entry points of the port's flagship path and of its multi-device run.

The counterparts of ``__graft_entry__.py``'s two functions:

``entry()`` returns the forward step of the DEL/INS cluster program
(``ops/indel_cluster.indel_cluster_structure`` over 4,096 signature rows)
and its example arguments, seeded as the JAX package's, on CUDA unless
the caller asks for the CPU.

``dryrun_multichip(n, devices=None)`` runs the sharded step
(``parallel/mesh.full_sharded_step``: gap clustering with the carried
last position, summed cluster sizes, sharded cover counts) on the demo
inputs, the two per-shard cluster programs of ``--n_shards``, and a
miniature end-to-end run with ``--n_shards 1`` and ``n``, whose VCF
bodies must be equal; it prints one ``DRYRUN OK ...`` line (and raises
after printing ``DRYRUN FAILED ...`` when the bodies differ).

    python -c "from cutesv_tpu_torch.entry import dryrun_multichip; \
dryrun_multichip(2)"
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from cutesv_tpu_torch.utils.torchsetup import resolve_device

ENTRY_ROWS = 4096


def entry(device=None):
    """(fwd, example_args): ``fwd(pos, length, rid, n_valid, bias,
    read_count)`` is the cluster program at ``ENTRY_ROWS`` rows; the
    example stream (~100 SV loci of ~40 signatures each) lies on
    ``device``. Runs it once and checks that it keeps rows."""
    from cutesv_tpu_torch.ops.indel_cluster import indel_cluster_structure

    device = resolve_device(device)
    n = ENTRY_ROWS

    def fwd(pos, length, rid, n_valid, bias, read_count):
        return indel_cluster_structure(pos, length, rid, n_valid, bias,
                                       read_count, n)

    rng = np.random.default_rng(0)
    loci = np.sort(rng.integers(0, 5_000_000, size=n // 40))
    pos = np.sort(
        (loci[rng.integers(0, len(loci), size=n)]
         + rng.integers(-50, 50, size=n))).astype(np.int32)
    length = rng.integers(30, 5000, size=n).astype(np.int32)
    rid = rng.integers(0, n // 4, size=n).astype(np.int32)
    example_args = tuple(torch.from_numpy(a).to(device)
                         for a in (pos, length, rid)) + (n - 64, 200, 10)
    out = fwd(*example_args)
    if int(out["n_kept"]) <= 0:
        raise AssertionError("entry stream must do real work")
    return fwd, example_args


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The multi-device dry run over ``devices`` (default: ``n_devices``
    CUDA cards from ``parallel/mesh.pick_devices``, raising when there
    are fewer). A list may repeat a device: ``[cpu] * n`` runs it on the
    CPU, ``[cuda:0] * n`` on one card."""
    from cutesv_tpu_torch.ops.indel_cluster import sharded_cluster_structure
    from cutesv_tpu_torch.ops.pair_cluster import sharded_pair_cluster
    from cutesv_tpu_torch.parallel import mesh as pmesh

    if devices is None:
        devices = pmesh.pick_devices(n_devices, "cuda")
        if devices is None:
            raise RuntimeError("need %d CUDA devices, have %d"
                               % (n_devices, torch.cuda.device_count()))
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise RuntimeError("need %d devices, have %d"
                           % (n_devices, len(devices)))
    devices = devices[:n_devices]

    step = pmesh.full_sharded_step(devices, max_cluster_bias=200)
    args = pmesh.demo_inputs(n_devices, device=devices[0])
    cid, sizes, n_clusters, counts = step(*args)
    assert n_clusters >= 1
    assert counts.shape[0] == args[2].shape[0]

    # the per-shard programs of --n_shards (gap-aligned stream cuts):
    # DEL/INS cluster structure + DUP/INV pair clusters
    rows = 64
    rng = np.random.default_rng(1)
    pos = np.sort(rng.integers(0, 100_000, size=(n_devices, rows))
                  ).astype(np.int32)
    pos.sort(axis=1)
    length = rng.integers(30, 500, size=(n_devices, rows)).astype(np.int32)
    rid = rng.integers(0, 32, size=(n_devices, rows)).astype(np.int32)

    def on(a, k):
        return torch.from_numpy(np.ascontiguousarray(a[k])).to(devices[k])

    outs = sharded_cluster_structure(
        [(on(pos, k), on(length, k), on(rid, k), rows)
         for k in range(n_devices)], 200, 3, rows)
    assert sum(int(o["n_kept"]) for o in outs) > 0, \
        "sharded cluster programs must keep rows"
    # k1 64x denser than the DEL positions: at their ~1.5 kb spacing
    # every pair cluster is a singleton, and for fewer than 4 shards the
    # JAX package's dry run (k1 = pos) keeps no row and fails this check
    k1 = pos // 64
    outs2 = sharded_pair_cluster(
        [(on(k1, k), on(k1 + 500, k), on(np.zeros_like(k1), k),
          on(rid, k), rows) for k in range(n_devices)], 150, 3, rows, True)
    assert sum(int(o["n_kept"]) for o in outs2) > 0, \
        "sharded pair programs must keep rows"

    # a miniature end-to-end run (decode -> store -> sharded resolve over
    # these devices -> genotype -> VCF), compared with the unsharded run
    pipeline_calls, vcf_identical = _dryrun_pipeline(devices)
    print("DRYRUN %s: n_devices=%d n_clusters=%d cover_checksum=%d "
          "pipeline_calls=%d sharded==serial: yes vcf_identical: %s"
          % ("OK" if vcf_identical else "FAILED", n_devices,
             int(n_clusters), int(np.asarray(counts).sum()),
             pipeline_calls, "yes" if vcf_identical else "NO"),
          flush=True)
    if not vcf_identical:
        raise AssertionError(
            "sharded pipeline VCF diverged from the unsharded run")


def _dryrun_pipeline(devices):
    """The JAX package's miniature corpus (two 60 kb chromosomes with a
    CIGAR DEL and INS, split-read DUP and INV, and BND to the partner
    chromosome) through ``run_pipeline`` with ``--n_shards 1`` and
    ``len(devices)`` on ``devices``; returns (n_calls, bodies equal)."""
    from cutesv_tpu_torch.config import Config
    from cutesv_tpu_torch.io.bam import BamWriter
    from cutesv_tpu_torch.io.fasta import write_fasta
    from cutesv_tpu_torch.pipeline import run_pipeline

    n_devices = len(devices)
    tmp = tempfile.mkdtemp(prefix="cutesv_dryrun_")
    try:
        rng = np.random.default_rng(3)
        n = 60_000
        chroms = ["chrA", "chrB"]
        refs = {c: "".join("ACGT"[k] for k in rng.integers(0, 4, n))
                for c in chroms}
        bam = os.path.join(tmp, "mini.bam")
        sa = "%s,%d,%s,%s,60,0;"
        with BamWriter(bam, [(c, n) for c in chroms]) as w:
            for cid, cname in enumerate(chroms):
                ref = refs[cname]
                plans = []
                for i, start in enumerate(range(0, 57_000, 400)):
                    if 17_000 <= start <= 19_400 and i % 2 == 0:
                        # CIGAR DEL @20k len 120
                        left = 20_000 - start
                        plans.append((start, 0, [(0, left), (2, 120),
                                                 (0, 2000)],
                                      ref[start:20_000]
                                      + ref[20_120:22_120], {}))
                    elif 27_000 <= start <= 29_400 and i % 2 == 0:
                        # CIGAR INS @30k len 90
                        left = 30_000 - start
                        ins = "".join("ACGT"[k]
                                      for k in rng.integers(0, 4, 90))
                        plans.append((start, 0, [(0, left), (1, 90),
                                                 (0, 2000)],
                                      ref[start:30_000] + ins
                                      + ref[30_000:32_000], {}))
                    else:
                        plans.append((start, 0, [(0, 2500)],
                                      ref[start:start + 2500], {}))
                # split-read DUP @40k len 700 and INV @46k..48k; BND to
                # the partner chromosome @52k
                for i in range(4):
                    p = 40_000 + i * 5
                    plans.append((p + 700 - 500,
                                  0, [(0, 500), (4, 500)],
                                  ref[p + 200:p + 700] + ref[p:p + 500],
                                  {"SA": sa % (cname, p + 1, "+",
                                               "500S500M")}))
                    x = 46_000 + i * 5
                    plans.append((x - 500, 0, [(0, 500), (4, 500)],
                                  ref[x - 500:x]
                                  + ref[x + 1500:x + 2000][::-1],
                                  {"SA": sa % (cname, x + 1501, "-",
                                               "500M500S")}))
                    t = 52_000 + i * 3
                    other = chroms[(cid + 1) % 2]
                    plans.append((t - 500, 0, [(0, 500), (4, 500)],
                                  ref[t - 500:t]
                                  + refs[other][5_000:5_500],
                                  {"SA": sa % (other, 5_001, "+",
                                               "500S500M")}))
                for pos, flag, cig, seq, tags in sorted(plans):
                    w.write("q%s_%d" % (cname, pos), flag, cid, pos, 60,
                            cig, seq, tags)
        fa = os.path.join(tmp, "mini.fa")
        write_fasta(fa, refs)
        bodies = {}
        for shards in (1, n_devices):
            out = os.path.join(tmp, "o%d.vcf" % shards)
            cfg = Config(input=bam, reference=fa, output=out,
                         work_dir=os.path.join(tmp, "w%d" % shards),
                         genotype=True, min_support=2, engine="device",
                         n_shards=shards)
            stats = run_pipeline(cfg, ["dryrun"], device=devices[0],
                                 shard_devices=devices)
            assert stats["n_calls"] > 0, "dryrun pipeline made no calls"
            with open(out) as fh:
                bodies[shards] = [ln for ln in fh
                                  if not ln.startswith("##")]
        assert any("SVTYPE=" in ln for ln in bodies[1])
        # no assert on the bodies here: the caller prints the outcome in
        # the DRYRUN line first, then fails
        return stats["n_calls"], bodies[1] == bodies[n_devices]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
