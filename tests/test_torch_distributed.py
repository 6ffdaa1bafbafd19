"""The port's multi-host mode (--distributed) and --profile against the
JAX package, on the CPU.

* Byte-range decode: the cases of tests/test_sharded_decode.py through
  both packages. The port's shard plan, each partial decode and the
  merge equal the JAX package's field by field, and the merge equals the
  whole-file decode.
* Plans: chromosome buckets (hash, LPT, range-affine) equal the JAX
  package's on the cases of tests/test_parallel.py and on seeded stores.
* Pipeline pieces: the shard tail gate, ``range_refids``, the bucket
  filter, the result gather without a group, the host-only exchange and
  ``init_distributed`` (torch.distributed monkeypatched where a group
  would be made).
* Real 2-process runs of the port's CLI (``--device cpu``, gloo, a free
  port bound at run time): process 0's VCF body equals the JAX CLI's
  single-process body and process 1 writes no VCF, on a BAM with the
  host engine, a CRAM, and a BAM with the device engine and forced
  mid-decode tails; ``--num_processes 1`` equals the plain run; a decode
  failure inside one process's range ends both processes.
* ``--profile`` writes the whole call's ``torch_trace/run.json`` (the
  program's spans, from the decoder's walk to the cover launch) and
  leaves the body unchanged.
All comparisons are exact.
"""
import json
import os
import random
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cutesv_tpu import cli as jcli
from cutesv_tpu import pipeline as jpipe
from cutesv_tpu import sigstore as jsig
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.io import bgzf as jbgzf
from cutesv_tpu.io import native as jnative
from cutesv_tpu.parallel import distributed as jdist
from cutesv_tpu_torch import cli as tcli
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch import sigstore as tsig
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.io import bgzf as tbgzf
from cutesv_tpu_torch.io import native as tnative
from cutesv_tpu_torch.parallel import distributed as tdist
from tests import simdata
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_parallel import _distributed_fixture, _tails_fixture
from tests.test_sharded_decode import _bam_to_cram
from tests.test_torch_native import _assert_decode_equal, _assert_store_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = {"bam": (jdist.plan_shard_ranges, tdist.plan_shard_ranges),
         "cram": (jdist.plan_cram_shard_ranges, tdist.plan_cram_shard_ranges)}


def _input(tmp_path, fmt, max_slice=40):
    """The all-types fixture as BAM or CRAM: (path, fasta, reference
    argument of the decoders)."""
    bam, fa = build_alltypes(tmp_path)
    if fmt == "bam":
        return str(bam), str(fa), None
    cram = tmp_path / "in.cram"
    _bam_to_cram(bam, cram, max_slice=max_slice)
    return str(cram), str(fa), str(fa)


def _cfgs(path, fa, **kw):
    kw = dict(input=path, reference=fa, min_support=3, **kw)
    return JConfig(**kw), TConfig(**kw)


def _parts(path, fmt, n, fa, ref, **kw):
    """Both packages' plans and partial decodes of ``path`` over ``n``
    shards; the plans and every partial must be equal."""
    jcfg, tcfg = _cfgs(path, fa, **kw)
    jplan, tplan = PLANS[fmt]
    jr, tr = jplan(path, n), tplan(path, n)
    assert tr == jr
    jparts = [jnative.decode(path, jcfg, None, reference=ref,
                             byte_range=r[:2]) for r in jr]
    tparts = [tnative.decode(path, tcfg, None, reference=ref,
                             byte_range=r[:2]) for r in tr]
    for jp, tp in zip(jparts, tparts):
        _assert_decode_equal(jp, tp)
    return tr, jparts, tparts, tcfg


def _assert_merge(jparts, tparts, whole):
    """The port's merge equals the JAX package's field by field (its
    part maps too) and holds the whole-file decode's content."""
    tm = tdist.merge_partial_decodes(tparts)
    jm = jdist.merge_partial_decodes(jparts)
    _assert_decode_equal(jm, tm)
    for a, b in zip(jm.part_name_remaps, tm.part_name_remaps):
        assert np.array_equal(a, b)
    assert tm.part_blob_bases == jm.part_blob_bases
    assert tdist.part_census_counts(tparts) == \
        jdist.part_census_counts(jparts)
    assert tm.names == whole.names and tm.chroms == whole.chroms
    assert np.array_equal(tm.name_rank, whole.name_rank)
    assert tm.ins_seq_blob == whole.ins_seq_blob
    assert tm.n_records == whole.n_records
    assert sorted(tm.arrays) == sorted(whole.arrays)
    for key, a in whole.arrays.items():
        assert tm.arrays[key].dtype == a.dtype, key
        assert np.array_equal(tm.arrays[key], a), key
    return tm


# ---------------------------------------------------------------------------
# byte-range decode (the cases of tests/test_sharded_decode.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 7])
@pytest.mark.parametrize("fmt", ["bam", "cram"])
def test_sharded_decode_union_equals_jax(tmp_path, fmt, n):
    path, fa, ref = _input(tmp_path, fmt)
    ranges, jparts, tparts, tcfg = _parts(path, fmt, n, fa, ref)
    tdist.check_shard_boundaries(ranges,
                                 [(p.first_u, p.next_u) for p in tparts])
    whole = tnative.decode(path, tcfg, None, reference=ref)
    assert sum(p.n_records for p in tparts) == whole.n_records
    assert any(p.n_records for p in tparts[1:]), "split degenerated"
    _assert_merge(jparts, tparts, whole)


@pytest.mark.parametrize("fmt", ["bam", "cram"])
def test_decode_sharded_without_group_is_whole_decode(tmp_path, fmt):
    """Outside a process group the sharded decode is one shard: the
    whole file, with one part's census counts."""
    path, fa, ref = _input(tmp_path, fmt)
    jcfg, tcfg = _cfgs(path, fa)
    info = {}
    nd = tdist.decode_sharded(tcfg, None, is_cram=fmt == "cram", info=info)
    whole = tnative.decode(path, tcfg, None, reference=ref)
    merged = _assert_merge([jnative.decode(path, jcfg, None, reference=ref)],
                           [whole], whole)
    _assert_decode_equal(merged, nd)
    assert nd.shard_records == whole.n_records
    assert nd.part_census_counts == tdist.part_census_counts([whole])
    assert info["total_mb"] == info["local_mb"] > 0


def test_native_block_scan_equals_python(tmp_path, monkeypatch):
    """The C++ block-table scan equals the Python scanner and the JAX
    package's; malformed input goes to the Python scanner's designed
    error."""
    bam, _ = build_alltypes(tmp_path)
    nat = tnative.scan_bgzf_native(str(bam))
    assert nat is not None
    jnat = jnative.scan_bgzf_native(str(bam))
    got = tbgzf.scan_block_table(str(bam))
    monkeypatch.setattr(tnative, "scan_bgzf_native", lambda path: None)
    py = tbgzf.scan_block_table(str(bam))
    for a in (jnat, got, py):
        assert np.array_equal(a[0], nat[0]) and np.array_equal(a[1], nat[1])
    assert nat[0].dtype == nat[1].dtype == np.int64
    monkeypatch.undo()
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"\x1f\x8bgarbage-not-a-block-header" * 4)
    assert tnative.scan_bgzf_native(str(bad)) is None
    for scan in (tbgzf.scan_block_table, jbgzf.scan_block_table):
        with pytest.raises(ValueError, match="BGZF"):
            scan(str(bad))


def test_boundary_mismatch_is_fatal(tmp_path):
    path, fa, ref = _input(tmp_path, "bam")
    ranges, _, tparts, _ = _parts(path, "bam", 2, fa, ref)
    reports = [(p.first_u, p.next_u) for p in tparts]
    bad = [(reports[0][0], reports[0][1] + 8)] + reports[1:]
    for check in (tdist.check_shard_boundaries, jdist.check_shard_boundaries):
        with pytest.raises(RuntimeError, match="boundary mismatch"):
            check(ranges, bad)


def test_sharded_store_equals_jax(tmp_path):
    """The merged partials build the JAX package's store, and it
    resolves as the whole-file store does."""
    path, fa, ref = _input(tmp_path, "bam")
    _, jparts, tparts, _ = _parts(path, "bam", 4, fa, ref, genotype=True,
                                  engine="host")
    jcfg, tcfg = _cfgs(path, fa, genotype=True, engine="host")
    tstore = tsig.build_store_native(tdist.merge_partial_decodes(tparts))
    jstore = jsig.build_store_native(jdist.merge_partial_decodes(jparts),
                                     jcfg)
    _assert_store_equal(jstore, tstore)
    whole = tsig.build_store_native(tnative.decode(path, tcfg, None))
    got = tpipe.resolve_all(tstore, tcfg, device="cpu")
    assert got == tpipe.resolve_all(whole, tcfg, device="cpu")
    assert got == jpipe.resolve_all(jstore, jcfg) and got


def test_cram_more_shards_than_containers(tmp_path):
    path, fa, ref = _input(tmp_path, "cram", max_slice=100_000)
    ranges, jparts, tparts, tcfg = _parts(path, "cram", 4, fa, ref)
    assert sum(1 for _, clen, _ in ranges if clen == -1) >= 1
    tdist.check_shard_boundaries(ranges,
                                 [(p.first_u, p.next_u) for p in tparts])
    whole = tnative.decode(path, tcfg, None, reference=ref)
    assert sum(p.n_records for p in tparts) == whole.n_records
    _assert_merge(jparts, tparts, whole)


def test_more_shards_than_blocks(tmp_path):
    """A BAM of fewer BGZF blocks than shards: empty shards own nothing
    (ulen -1), and the union is the whole-file decode."""
    rng = random.Random(9)
    ref = simdata.make_reference(rng, {"chr1": 20_000})
    plans = [simdata.plain_read(ref["chr1"], 0, s, 2000, "t%03d" % i)
             for i, s in enumerate(range(0, 17_000, 600))]
    plans.append(simdata.read_with_del(ref["chr1"], 0, 8_000, 9_000, 120,
                                       2000, "d1"))
    bam = tmp_path / "tiny.bam"
    simdata.write_bam(str(bam), [("chr1", 20_000)], plans)
    ranges, jparts, tparts, tcfg = _parts(str(bam), "bam", 6, "", None,
                                          min_size=30)
    assert any(ulen == -1 for _, ulen, _ in ranges)
    tdist.check_shard_boundaries(ranges,
                                 [(p.first_u, p.next_u) for p in tparts])
    whole = tnative.decode(str(bam), tcfg, None)
    assert sum(p.n_records for p in tparts) == whole.n_records
    _assert_merge(jparts, tparts, whole)


# ---------------------------------------------------------------------------
# chromosome buckets
# ---------------------------------------------------------------------------

def test_chrom_bucket_equals_jax():
    chroms = ["chr%d" % i for i in range(1, 23)] + ["chrX", "chrY", "chrM"]
    for n in (1, 2, 4, 8):
        owners = {c: tdist.chrom_bucket(c, n) for c in chroms}
        assert owners == {c: jdist.chrom_bucket(c, n) for c in chroms}
        assert all(0 <= b < n for b in owners.values())
    assert all(tdist.chrom_bucket(c, 1) == 0 for c in chroms)


def test_lpt_assignment_balances_skewed_contigs():
    """Human-like contig skew (chr1 ~5x chr21): per-process loads within
    1.5x of each other, deterministic, and the JAX package's plan."""
    sizes = {"chr%d" % i: 250_000 - 10_000 * i for i in range(1, 23)}
    stores = []
    for mod in (tsig, jsig):
        store = mod.SigStore(chrom_lengths={c: 1 for c in sizes})
        for c, n in sizes.items():
            store.census[c] = {"start": np.zeros(n, np.int64)}
        stores.append(store)
    for n_hosts in (2, 4, 8):
        assign = tdist.assign_chroms_lpt(stores[0], n_hosts)
        assert assign == jdist.assign_chroms_lpt(stores[1], n_hosts)
        assert set(assign) == set(sizes)
        loads = [0] * n_hosts
        for c, b in assign.items():
            loads[b] += sizes[c]
        assert max(loads) <= 1.5 * min(loads), (n_hosts, loads)
        assert assign == tdist.assign_chroms_lpt(stores[0], n_hosts)


def test_assign_chroms_by_decode_range_equals_jax():
    """Range-affine: a chromosome resolves on the part that produced
    most of its census rows (ties to the lowest part), row-less
    chromosomes take the LPT plan."""
    store = tsig.SigStore(chrom_lengths={})
    for c, n in (("chr1", 100), ("chr2", 80), ("chr3", 60), ("chr4", 5)):
        store.census[c] = {"start": np.zeros(n, np.int64)}
    store.sigs = {"DEL": {"chrX": [1, 2, 3]}}  # sig-only chromosome
    part_counts = [{"chr1": 100, "chr2": 10},
                   {"chr2": 70, "chr3": 60, "chr4": 5}]
    assign = tdist.assign_chroms_by_decode_range(part_counts, store, 2)
    assert assign == jdist.assign_chroms_by_decode_range(part_counts,
                                                         store, 2)
    assert (assign["chr1"], assign["chr2"], assign["chr3"],
            assign["chr4"]) == (0, 1, 1, 1)
    assert assign["chrX"] == tdist.assign_chroms_lpt(store, 2)["chrX"]
    tie = tdist.assign_chroms_by_decode_range(
        [{"c": 5}, {"c": 5}], tsig.SigStore(chrom_lengths={}), 2)
    assert tie["c"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_plans_equal_jax_on_seeded_stores(seed):
    rng = np.random.default_rng(seed)
    chroms = ["c%d" % i for i in range(int(rng.integers(1, 30)))]
    stores = [mod.SigStore(chrom_lengths={}) for mod in (tsig, jsig)]
    for c in chroms:
        n = int(rng.integers(0, 50))
        for store in stores:
            store.census[c] = {"start": np.zeros(n, np.int64)}
    sigs = {t: {c: [0] * int(rng.integers(0, 20)) for c in chroms
                if rng.random() < 0.5} for t in ("DEL", "INS", "TRA")}
    for store in stores:
        store.sigs = sigs
    for n in (1, 2, 3, 4, 8):
        parts = [{c: int(rng.integers(0, 40)) for c in chroms
                  if rng.random() < 0.6} for _ in range(n)]
        assert tdist.assign_chroms_lpt(stores[0], n) == \
            jdist.assign_chroms_lpt(stores[1], n)
        assert tdist.assign_chroms_by_decode_range(parts, stores[0], n) == \
            jdist.assign_chroms_by_decode_range(parts, stores[1], n)
        assert [tdist.chrom_bucket(c, n) for c in chroms] == \
            [jdist.chrom_bucket(c, n) for c in chroms]


def test_bucket_plan_follows_the_process_count():
    """Part counts from the current process count give the range-affine
    plan; from another count (a --resume with another --num_processes)
    or none, the LPT plan."""
    store = tsig.SigStore(chrom_lengths={})
    for c, n in (("a", 10), ("b", 50), ("c", 30)):
        store.census[c] = {"start": np.zeros(n, np.int64)}
    store.part_census_counts = [{"a": 10, "b": 1}, {"b": 49, "c": 30}]
    assert tpipe._bucket_plan(store, 2) == \
        tdist.assign_chroms_by_decode_range(store.part_census_counts,
                                            store, 2)
    assert tpipe._bucket_plan(store, 2) == {"a": 0, "b": 1, "c": 1}
    for n in (1, 3):
        assert tpipe._bucket_plan(store, n) == \
            tdist.assign_chroms_lpt(store, n)
    del store.part_census_counts
    assert tpipe._bucket_plan(store, 2) == tdist.assign_chroms_lpt(store, 2)


# ---------------------------------------------------------------------------
# pipeline pieces
# ---------------------------------------------------------------------------

def test_shard_tail_gate_equals_jax():
    class FakeSd:
        def __init__(self, first, last):
            self._r = (first, last)

        def range_refids(self):
            return self._r

    for first, last, start in ((1, 3, 4096), (0, 3, 0), (2, 2, 10),
                               (0, 0, 0), (-1, -1, 77)):
        gate = tpipe._shard_tail_gate(FakeSd(first, last), start)
        jgate = jpipe._shard_tail_gate(FakeSd(first, last), start)
        assert [gate(c) for c in range(-1, 5)] == \
            [jgate(c) for c in range(-1, 5)]
    gate = tpipe._shard_tail_gate(FakeSd(1, 3), range_start=4096)
    assert not gate(1) and gate(2) and gate(3)
    assert tpipe._shard_tail_gate(FakeSd(0, 3), range_start=0)(0)


def test_range_refids_equals_jax(tmp_path):
    """StreamingDecode.range_refids names the first and last chromosome a
    ranged decode merged, as the JAX package's does."""
    base = _distributed_fixture(tmp_path)
    jcfg, tcfg = _cfgs(base[0], base[1])
    ranges = tdist.plan_shard_ranges(base[0], 2)
    got = {}
    for name, mod, cfg in (("port", tnative, tcfg), ("jax", jnative, jcfg)):
        for rng in (ranges[1][:2], None):
            sd = mod.StreamingDecode(base[0], cfg, byte_range=rng)
            try:
                nd = sd.join()
                got[name, rng] = (sd.range_refids(),
                                  np.asarray(nd.arrays["all_chr"]))
            finally:
                sd.free()
    for rng in (ranges[1][:2], None):
        (first, last), chrs = got["port", rng]
        assert (first, last) == got["jax", rng][0]
        assert (first, last) == (int(chrs[0]), int(chrs[-1]))
    assert got["port", None][0] == (0, 1)


def test_filter_store_and_gather_roundtrip():
    """_filter_store_chroms keeps the bucket's signature streams (census
    and read tables stay whole) and its early work; _gather_results
    without a group returns the rows merged, as the JAX package does."""
    kw = dict(sigs={"DEL": {"chr1": [1], "chr2": [2]}, "INS": {"chr1": [3]}},
              census={"chr1": {}, "chr2": {}},
              read_tables={"chr1": None, "chr2": None},
              chrom_lengths={"chr1": 10, "chr2": 20})
    store = tsig.SigStore(**kw)
    store.early_kernels = {("DEL", "chr1"): "h1", ("DEL", "chr2"): "h2"}
    store.early_results = {("INS", "chr1"): ([], [])}
    sub = tpipe._filter_store_chroms(store, lambda c: c == "chr2")
    jsub = jpipe._filter_store_chroms(jsig.SigStore(**kw),
                                      lambda c: c == "chr2")
    assert sub.sigs == jsub.sigs == {"DEL": {"chr2": [2]}, "INS": {}}
    assert set(sub.census) == set(sub.read_tables) == {"chr1", "chr2"}
    assert sub.early_kernels == {("DEL", "chr2"): "h2"}
    assert sub.early_results == {}
    results = {"chr1": [["a", 1], ["b", np.int64(2)]], "chr2": [["c"]]}
    info = {}
    assert tpipe._gather_results(dict(results), info) == \
        jpipe._gather_results(dict(results)) == results
    assert info["local_mb"] == info["total_mb"] > 0


def test_allgather_carries_host_values_only():
    """A torch tensor inside an exchanged object raises: on several hosts
    it would unpickle onto a card the peer does not have."""
    assert tdist.allgather_obj({"a": np.arange(3), "b": ["x", 1.5]})[0][
        "b"] == ["x", 1.5]
    with pytest.raises(TypeError, match="host values only"):
        tdist.allgather_obj({"rows": [[1, torch.zeros(2)]]})
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.is_emitter()


def test_stream_dispatch_gate_equals_jax(monkeypatch):
    """The dispatch gate with input kind and multi-process flag: equal to
    the JAX package's over the whole matrix."""
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "1")
    n = 0
    for engine in ("device", "auto", "host"):
        for distributed in (False, True):
            for ivcf in (None, "x.vcf"):
                kw = dict(engine=engine, distributed=distributed, Ivcf=ivcf)
                for is_cram in (False, True):
                    for for_dist in (False, True):
                        got = tpipe._stream_dispatch_ok(
                            TConfig(**kw), is_cram, for_distributed=for_dist)
                        assert got == jpipe._stream_dispatch_ok(
                            JConfig(**kw), is_cram,
                            for_distributed=for_dist), (kw, is_cram,
                                                        for_dist)
                        n += got
    assert n == 8


def test_init_distributed_single_process_makes_no_group():
    for n in (1, 0):
        assert tdist.init_distributed("localhost:1", n, 0) is False
    assert not torch.distributed.is_initialized()


def _fake_group(monkeypatch, world):
    calls = []
    dist = torch.distributed
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    return calls


def test_init_distributed_world_size_mismatch_raises(monkeypatch):
    """A group that reports another size than --num_processes must fail
    loudly: otherwise every process would run the whole file alone."""
    calls = _fake_group(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="reports 1 process"):
        tdist.init_distributed("localhost:1", 2, 0)
    assert calls == [(("gloo",), dict(init_method="tcp://localhost:1",
                                      world_size=2, rank=0))]


def test_init_distributed_reads_torchrun_env(monkeypatch):
    calls = _fake_group(monkeypatch, 3)
    for k, v in (("MASTER_ADDR", "h0"), ("MASTER_PORT", "29511"),
                 ("WORLD_SIZE", "3"), ("RANK", "2")):
        monkeypatch.setenv(k, v)
    assert tdist.init_distributed() is True
    assert calls[-1][1] == dict(init_method="tcp://h0:29511", world_size=3,
                                rank=2)
    # an explicit argument wins over the environment
    assert tdist.init_distributed("h1:7", None, 1) is True
    assert calls[-1][1] == dict(init_method="tcp://h1:7", world_size=3,
                                rank=1)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    with pytest.raises(ValueError, match="--coordinator"):
        tdist.init_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="--num_processes"):
        tdist.init_distributed("h:1", None, 0)


# ---------------------------------------------------------------------------
# real 2-process runs of the CLI
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _body(path) -> list:
    with open(path) as fh:
        return [l for l in fh if not l.startswith("##")]


def _two_processes(tmp_path, base, extra, tag, env=None, timeout=120):
    """One --distributed run of the port's CLI as two processes on the
    CPU; returns their exit codes and logs. Both are killed at the
    timeout (which then raises)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    procs = []
    for k in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cutesv_tpu_torch.cli"] + base
            + [str(tmp_path / ("%s%d.vcf" % (tag, k))),
               str(tmp_path / ("w%s%d" % (tag, k)))] + extra
            + ["--device", "cpu", "--distributed", "--coordinator",
               "localhost:%d" % port, "--num_processes", "2",
               "--process_id", str(k)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _jax_body(tmp_path, base, extra, tag):
    out = tmp_path / ("jax_%s.vcf" % tag)
    assert jcli.main(base + [str(out), str(tmp_path / ("wj_%s" % tag))]
                     + extra) == 0
    return _body(out)


def _check_pair(tmp_path, tag, rcs, outs, want):
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert not (tmp_path / ("%s1.vcf" % tag)).exists()  # only 0 emits
    assert _body(tmp_path / ("%s0.vcf" % tag)) == want
    assert all("sharded decode: shard %d/2" % k in o
               for k, o in enumerate(outs)), outs[0][-1500:]
    assert "Calls: 0 " in outs[1]


def test_two_process_bam_host_engine_equals_jax(tmp_path):
    base = _distributed_fixture(tmp_path)
    extra = ["--engine", "host", "--genotype", "-s", "3"]
    want = _jax_body(tmp_path, base, extra, "bam")
    assert sum(1 for l in want if not l.startswith("#")) >= 2
    rcs, outs = _two_processes(tmp_path, base, extra, "mp")
    _check_pair(tmp_path, "mp", rcs, outs, want)
    assert not any("(streaming)" in o for o in outs)


def test_two_process_cram_equals_jax(tmp_path):
    """CRAM: container-aligned ranges, the plain ranged decode (the
    ranged streaming decode plans BGZF blocks), the device engine."""
    base = _distributed_fixture(tmp_path)
    cram = tmp_path / "in.cram"
    _bam_to_cram(tmp_path / "in.bam", cram, max_slice=25)
    cbase = [str(cram), base[1]]
    extra = ["--genotype", "-s", "3"]
    want = _jax_body(tmp_path, cbase, extra, "cram")
    rcs, outs = _two_processes(tmp_path, cbase, extra, "mc")
    _check_pair(tmp_path, "mc", rcs, outs, want)
    assert not any("(streaming)" in o for o in outs)


def test_two_process_streaming_tails_equal_jax(tmp_path):
    """The device engine streams each process's byte range: with forced
    tails and a paced decode, chromosomes completing mid-range run their
    full tail on the process that decoded them, and at least one tail
    validates against the merged decode."""
    base = _tails_fixture(tmp_path)
    extra = ["--engine", "device", "--genotype", "-s", "3"]
    want = _jax_body(tmp_path, base, extra, "tails")
    assert sum(1 for l in want if not l.startswith("#")) >= 4
    tails = 0
    # a loaded host can starve the poll loop past every chunk: one retry
    # with a slower pace before calling it a failure
    for attempt, delay_ms in enumerate((80, 250)):
        tag = "st%d_" % attempt
        rcs, outs = _two_processes(
            tmp_path, base, extra, tag,
            env=dict(CUTESV_STREAM_TAIL="force",
                     CUTESV_DECODE_CHUNK_DELAY_MS=str(delay_ms)))
        _check_pair(tmp_path, tag, rcs, outs, want)
        assert all("(streaming)" in o for o in outs), outs[0][-1500:]
        tails = sum(int(m.group(1)) for o in outs for m in re.finditer(
            r"(\d+) full tails\s*validated", o))
        if tails:
            break
    assert tails >= 1, outs[0][-1500:]


def test_distributed_single_process_equals_plain(tmp_path):
    """--num_processes 1 makes no group: the plain run's body."""
    base = _distributed_fixture(tmp_path)
    extra = ["--genotype", "-s", "3"]
    want = _jax_body(tmp_path, base, extra, "one")
    out = tmp_path / "one.vcf"
    stats = tcli.run(base + [str(out), str(tmp_path / "wone")] + extra
                     + ["--device", "cpu", "--distributed",
                        "--num_processes", "1"])
    assert not torch.distributed.is_initialized()
    assert _body(out) == want
    assert "sharded" not in stats and stats["n_calls"] >= 2


def _corrupt_block(src, dst, frac):
    """``src`` with the deflate payload of the BGZF block at ``frac`` of
    the file garbled, its header left intact (the block scan and the
    shard plan still pass)."""
    offs, _ = tbgzf.scan_block_table(str(src))
    k = int(frac * len(offs))
    data = bytearray(src.read_bytes())
    for j in range(int(offs[k]) + 40, int(offs[k]) + 80):
        data[j] ^= 0xFF
    dst.write_bytes(bytes(data))
    return k, len(offs)


def test_failure_inside_a_range_ends_both_processes(tmp_path):
    """Process 1's ranged decode meets a corrupt block and raises before
    the exchange; its exit closes its gloo sockets, so process 0's
    allgather raises instead of waiting, and both exit non-zero."""
    rng = random.Random(13)
    clen = 2_400_000
    seqs = simdata.make_reference(rng, {"chr1": clen})
    plans = [simdata.plain_read(seqs["chr1"], 0, s, 30_000, "r%05d" % i)
             for i, s in enumerate(range(0, clen - 30_000, 500))]
    good = tmp_path / "big.bam"
    simdata.write_bam(str(good), [("chr1", clen)], plans)
    simdata.write_ref_fasta(str(tmp_path / "big.fa"), seqs)
    # the decoder inflates a file's first 1,024 blocks to read the header,
    # then (from byte 0) the next 1,024 as one chunk, then 128-block
    # chunks, one ahead of the record it parses: the corrupt block lies
    # past all that process 0 inflates, inside process 1's range
    k, n_blocks = _corrupt_block(good, tmp_path / "bad.bam", 0.75)
    assert k > max(2 * 1_024 + 128, n_blocks // 2 + 2 * 128), (k, n_blocks)
    rcs, outs = _two_processes(
        tmp_path, [str(tmp_path / "bad.bam"), str(tmp_path / "big.fa")],
        ["--engine", "host"], "bad", timeout=90)
    assert rcs[0] != 0 and rcs[1] != 0, outs
    assert "native BAM decode failed" in outs[1], outs[1][-1500:]
    # process 0 decoded its range and failed in the exchange
    assert "sharded decode: shard 0/2" in outs[0], outs[0][-1500:]
    assert "native BAM decode failed" not in outs[0], outs[0][-1500:]
    assert not (tmp_path / "bad0.vcf").exists()


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------

def test_profile_on_cpu_writes_trace_and_keeps_the_body(tmp_path):
    bam, fa = build_alltypes(tmp_path)
    base = [str(bam), str(fa)]
    extra = ["--genotype", "-s", "3"]
    want = _jax_body(tmp_path, base, extra, "prof")
    out = tmp_path / "prof.vcf"
    wd = tmp_path / "wprof"
    stats = tcli.run(base + [str(out), str(wd)] + extra
                     + ["--device", "cpu", "--profile"])
    assert _body(out) == want
    trace = wd / "torch_trace" / "run.json"
    assert stats["profile_trace"] == str(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "program_span"}
    assert {"call", "decode", "decode.walk", "genotype.flush",
            "cover.launch", "emit"} <= spans, sorted(spans)
