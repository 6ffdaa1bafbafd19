"""The port's streaming decode (decode -> early cluster dispatch, with the
mid-decode DEL/INS tail) against the JAX package's, on the CPU.

The cases of tests/test_streaming_decode.py run through both packages:
the JAX package's streaming and plain native runs and the port's
(``device="cpu"``) must write the same VCF (all but ##fileDate and
##CommandLine); snapshots, their prepared columns and the early store
must be equal. Then the all-types replay corpus: the port's ``replay``
writes the JAX package's bytes, and a few-Mb grid of DEL, INS, DUP, INV
and BND records calls identically through both packages, with the
recall ``chip_smoke.py`` holds the card's run to.
"""
import logging
import pickle

import numpy as np
import pytest

import chip_smoke
from cutesv_tpu import pipeline as jpipe
from cutesv_tpu import sigstore as jsig
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.io import native as jnative
from cutesv_tpu.tools.simulate import replay as jreplay
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch import sigstore as tsig
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.io import native as tnative
from cutesv_tpu_torch.models import device as tdev
from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.tools.simulate import replay as treplay
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile
from tests.test_streaming_decode import _two_chrom_fixture
from tests.test_torch_pipeline import build_engines_fixture

FIXTURES = {"two_chrom": _two_chrom_fixture, "engines": build_engines_fixture,
            "alltypes": build_alltypes}
BREAKDOWN = ("native_s", "store_s", "walk_s", "inflate_core_s",
             "records_core_s", "overlap_work_s", "done_tail_s")
# the port's streaming rule itself, before any test substitutes it
_RULE = tpipe.stream_rule


def _seam(dispatch, tail=None):
    """The port's streaming rule under a test's switches, which are the
    JAX package's environment: ``dispatch`` "0" a plain decode; ``tail``
    "0" no tail, "force" the tail for the DONE batch too (small fixtures
    decode in one poll); the rule itself otherwise."""
    def rule(*args, **kwargs):
        got = _RULE(*args, **kwargs)
        if dispatch == "0":
            return got._replace(stream=False, tail=False)
        return got._replace(tail=got.tail and tail != "0",
                            tail_done=tail == "force")
    return rule


def _run(pkg, bam, fa, tmp_path, tag, monkeypatch, dispatch, tail=None,
         genotype=True, engine="device"):
    """One native-decoder run of ``pkg`` ("jax" or "port", the port on
    the CPU) under the given streaming switches (the JAX package's
    environment; the port's :func:`_seam`); returns the VCF without its
    volatile header lines, and the run's stats."""
    if pkg == "jax":
        monkeypatch.setenv("CUTESV_STREAM_DISPATCH", dispatch)
        if tail is None:
            monkeypatch.delenv("CUTESV_STREAM_TAIL", raising=False)
        else:
            monkeypatch.setenv("CUTESV_STREAM_TAIL", tail)
    else:
        monkeypatch.setattr(tpipe, "stream_rule", _seam(dispatch, tail))
    out = tmp_path / ("%s_%s.vcf" % (pkg, tag))
    kw = dict(input=str(bam), reference=str(fa), output=str(out),
              work_dir=str(tmp_path / ("w_%s_%s" % (pkg, tag))),
              genotype=genotype, min_support=3, engine=engine,
              decoder="native")
    if pkg == "jax":
        stats = jpipe.run_pipeline(JConfig(**kw), ["x"])
    else:
        stats = tpipe.run_pipeline(TConfig(**kw), ["x"], device="cpu")
    return _strip_volatile(out.read_text()), stats


def _records(vcf: str) -> list:
    return [l for l in vcf.splitlines() if l and not l.startswith("#")]


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_streaming_vcf_equals_jax(tmp_path, monkeypatch, fixture):
    """Streaming with the full tail also in the DONE batch, streaming by
    the rule, and the plain decode: every port body equals the JAX
    package's plain and streaming bodies."""
    bam, fa = FIXTURES[fixture](tmp_path)
    want, _ = _run("jax", bam, fa, tmp_path, "plain", monkeypatch, "0")
    jstream, _ = _run("jax", bam, fa, tmp_path, "force", monkeypatch, "1",
                      "force")
    assert jstream == want
    for tag, dispatch, tail in (("force", "1", "force"),
                                ("stream", "1", None), ("plain", "0", None)):
        got, stats = _run("port", bam, fa, tmp_path, tag, monkeypatch,
                          dispatch, tail)
        assert got == want, tag
        assert stats["streaming"] == (dispatch == "1")
        if dispatch == "1":
            for k in BREAKDOWN:
                assert stats[k] >= 0.0, k
            assert stats["early_dispatched"] > 0
            assert stats["early_kernels"] + stats["early_tails"] == \
                stats["early_dispatched"]
        if tail == "force":
            assert stats["early_tails"] >= 1
    assert len(_records(want)) >= 2


def test_streaming_refuses_unsorted_bam_like_jax(tmp_path, monkeypatch):
    """A coordinate-UNSORTED BAM is refused on both the streaming and the
    plain path, with the JAX package's message."""
    import random

    from tests import simdata

    rng = random.Random(3)
    ref = simdata.make_reference(rng, {"chrA": 90_000, "chrB": 90_000})
    plans = []
    rid = 0
    for cid, cname in ((0, "chrA"), (1, "chrB")):
        chrom = ref[cname]
        for start in range(0, 87_000, 400):
            rid += 1
            q = "u%05d" % rid
            if 27_350 <= start <= 29_500:
                plans.append(simdata.read_with_del(
                    chrom, cid, start, 30_000, 150,
                    start + 3000 - 30_150, q))
            else:
                plans.append(simdata.plain_read(chrom, cid, start, 3000, q))
    rng.shuffle(plans)
    bam, fa = tmp_path / "un.bam", tmp_path / "un.fa"
    simdata.write_bam(str(bam), [("chrA", 90_000), ("chrB", 90_000)],
                      plans, sort=False)
    simdata.write_ref_fasta(str(fa), ref)
    for dispatch in ("1", "0"):
        msgs = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError, match="not coordinate-sorted") \
                    as err:
                _run(pkg, bam, fa, tmp_path, "u" + dispatch, monkeypatch,
                     dispatch)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def _snapshots(mod, bam, cfg, types):
    """Every chromosome's snapshot of ``types`` once the decode thread
    is done, and the joined NativeDecode."""
    sd = mod.StreamingDecode(bam, cfg)
    try:
        while sd.poll() != sd.DONE:
            pass
        snaps = {}
        for c in range(sd.n_refs()):
            for t in types:
                snap = sd.snapshot(t, c)
                if len(next(iter(snap.values()))):
                    snaps[(t, c)] = snap
        nd = sd.join()
    finally:
        sd.free()
    return snaps, nd


def _cfgs(bam, fa, tmp_path):
    kw = dict(input=str(bam), reference=str(fa), output="x.vcf",
              work_dir=str(tmp_path), genotype=True, min_support=3,
              engine="device", decoder="native")
    return JConfig(**kw), TConfig(**kw)


def _assert_cols_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_snapshot_prepare_validation_and_early_resolve(tmp_path):
    """DEL/INS snapshots and their prepared columns equal the JAX
    package's; they validate against the final store, the early programs
    resolve like a cold resolve and like the JAX package, and a stale
    (one row short) snapshot does not validate."""
    bam, fa = _two_chrom_fixture(tmp_path)
    jcfg, tcfg = _cfgs(bam, fa, tmp_path)
    jsnaps, jnd = _snapshots(jnative, bam, jcfg, ("DEL", "INS"))
    snaps, nd = _snapshots(tnative, bam, tcfg, ("DEL", "INS", "CEN"))
    assert {k: v for k, v in snaps.items() if k[0] != "CEN"}.keys() == \
        jsnaps.keys() and jsnaps
    for k in jsnaps:
        _assert_cols_equal(snaps[k], jsnaps[k])
    cen = snaps[("CEN", 0)]
    assert set(cen) == {"start", "end", "is_primary", "name"}
    assert len(cen["start"]) == int(np.sum(nd.arrays["cen_chr"] == 0))

    prepared = {k: tsig.prepare_snapshot(v, k[0] == "INS")
                for k, v in snaps.items() if k[0] != "CEN"}
    for k, (fp, disp) in prepared.items():
        jfp, jdisp = jsig.prepare_snapshot(jsnaps[k], k[0] == "INS")
        _assert_cols_equal(fp, jfp)
        _assert_cols_equal(disp, jdisp)
    early_fp = {(t, nd.chroms[c]): fp
                for (t, c), (fp, _) in prepared.items()}
    store = tsig.build_store_native(nd, early=early_fp)
    jstore = jsig.build_store_native(
        jnd, jcfg, early={(t, jnd.chroms[c]): jsig.prepare_snapshot(
            v, t == "INS")[0] for (t, c), v in jsnaps.items()})
    assert store.early_valid == set(early_fp) == jstore.early_valid

    bias = {"DEL": tcfg.max_cluster_bias_DEL,
            "INS": tcfg.max_cluster_bias_INS}
    cpu = tdev.resolve_device("cpu")
    store.early_kernels = {
        (t, nd.chroms[c]): tdev._cluster_stream_dispatch(
            tdev.IndelStream(disp["pos"], disp["length"], disp["rid"]),
            tcfg.min_support, bias[t], cpu)
        for (t, c), (_, disp) in prepared.items()}
    with_early = tpipe.resolve_all(store, tcfg, device="cpu")
    store.early_kernels = {}
    without = tpipe.resolve_all(store, tcfg, device="cpu")
    assert with_early == without == jpipe.resolve_all(jstore, jcfg)

    (t0, c0), snap0 = next(iter((k, v) for k, v in snaps.items()
                                if k[0] != "CEN"))
    stale = {k: v[:-1] for k, v in snap0.items()}
    fp_stale, _ = tsig.prepare_snapshot(stale, t0 == "INS")
    store2 = tsig.build_store_native(
        nd, early={(t0, nd.chroms[c0]): fp_stale})
    assert (t0, nd.chroms[c0]) not in store2.early_valid


def test_pair_snapshot_early_resolve_equals_jax(tmp_path):
    """DUP/INV snapshots prepare like the JAX package's, validate, and
    the early pair programs resolve like a cold resolve and like JAX."""
    bam, fa = build_alltypes(tmp_path)
    jcfg, tcfg = _cfgs(bam, fa, tmp_path)
    jsnaps, jnd = _snapshots(jnative, str(bam), jcfg, ("DUP", "INV"))
    snaps, nd = _snapshots(tnative, str(bam), tcfg, ("DUP", "INV"))
    assert snaps.keys() == jsnaps.keys()
    assert {t for t, _ in snaps} == {"DUP", "INV"}
    prepared = {k: tsig.prepare_snapshot_pair(k[0], v)
                for k, v in snaps.items()}
    for k, (fp, d) in prepared.items():
        jfp, jd = jsig.prepare_snapshot_pair(k[0], jsnaps[k])
        _assert_cols_equal(fp, jfp)
        _assert_cols_equal(d, jd)
    early_fp = {(t, nd.chroms[c]): fp
                for (t, c), (fp, _) in prepared.items()}
    store = tsig.build_store_native(nd, early=early_fp)
    assert set(early_fp) <= store.early_valid

    bias = {"DUP": tcfg.max_cluster_bias_DUP,
            "INV": tcfg.max_cluster_bias_INV}
    cpu = tdev.resolve_device("cpu")
    store.early_kernels = {
        (t, nd.chroms[c]): tdev._pair_cluster_compact(
            tdev._pair_cluster_start(d["k1"], d["k2"], d["aux"], d["keys"],
                                     tcfg.min_support, bias[t], t == "INV",
                                     cpu))
        for (t, c), (_, d) in prepared.items()}
    with_early = tpipe.resolve_all(store, tcfg, device="cpu")
    store.early_kernels = {}
    without = tpipe.resolve_all(store, tcfg, device="cpu")
    jstore = jsig.build_store_native(jnd, jcfg)
    assert with_early == without == jpipe.resolve_all(jstore, jcfg)
    assert any(with_early.values())


def test_streaming_full_tail_identical(tmp_path, monkeypatch, caplog):
    """The tail also in the DONE batch: both the DEL and the INS tail fire
    (the INS one renders ALT sequences through the native blob view) and the
    VCF equals the JAX package's tail and plain runs."""
    bam, fa = _two_chrom_fixture(tmp_path)
    want, _ = _run("jax", bam, fa, tmp_path, "plain", monkeypatch, "0")
    jtail, _ = _run("jax", bam, fa, tmp_path, "tail", monkeypatch, "1",
                    "force")
    with caplog.at_level(logging.INFO, logger="cutesv_tpu_torch"):
        caplog.clear()
        got, stats = _run("port", bam, fa, tmp_path, "tail", monkeypatch,
                          "1", "force")
    msg = next(m for m in caplog.messages if "full tails" in m)
    assert int(msg.split("+")[1].split()[0]) >= 2, msg
    assert stats["early_tails"] >= 2 and stats["tail_windows"] >= 2
    assert got == jtail == want
    assert any("cuteSV.INS." in line and len(line.split("\t")[4]) > 10
               for line in _records(got))


def test_invalidated_fingerprint_recomputes(tmp_path, monkeypatch):
    """A chromosome whose fingerprint fails validation (a late SA row)
    discards its early programs and tails and is resolved again after
    the join: output equal to the JAX package's plain run."""
    bam, fa = _two_chrom_fixture(tmp_path)
    want, _ = _run("jax", bam, fa, tmp_path, "plain", monkeypatch, "0")
    orig_indel, orig_pair = tsig.prepare_snapshot, tsig.prepare_snapshot_pair

    def corrupt(fn):
        def wrapped(*args):
            cols, disp = fn(*args)
            return dict(cols, n_raw=cols["n_raw"] + 1), disp
        return wrapped

    monkeypatch.setattr(tsig, "prepare_snapshot", corrupt(orig_indel))
    monkeypatch.setattr(tsig, "prepare_snapshot_pair", corrupt(orig_pair))
    for tail in ("force", None):
        got, stats = _run("port", bam, fa, tmp_path, "bad%s" % tail,
                          monkeypatch, "1", tail)
        assert got == want
        assert stats["early_dispatched"] > 0
        assert stats["early_kernels"] == stats["early_tails"] == 0


def test_streaming_no_genotype_equals_jax(tmp_path, monkeypatch):
    bam, fa = build_alltypes(tmp_path)
    want, _ = _run("jax", bam, fa, tmp_path, "plain", monkeypatch, "0",
                   genotype=False)
    got, _ = _run("port", bam, fa, tmp_path, "tail", monkeypatch, "1",
                  "force", genotype=False)
    assert got == want


def test_stream_tail_default_and_dispatch_gate_equal_jax(monkeypatch):
    """The port's one streaming rule on a whole-file decode, over engine
    x --distributed x -Ivcf x CRAM x --report_readid: it streams exactly
    when the JAX package's dispatch gate does with 2+ cores and its
    switch unset, and the full tail runs exactly when it streams without
    --report_readid (the JAX package's tail default at 4+ cores), for
    every chromosome but never in the DONE batch."""
    monkeypatch.delenv("CUTESV_STREAM_DISPATCH", raising=False)
    monkeypatch.setattr(jpipe, "_n_cores", lambda: 2)
    assert all(jpipe._stream_tail_default(4, refs) for refs in (1, 24))
    n = 0
    for engine in ("device", "auto", "host"):
        for distributed in (False, True):
            for ivcf in (None, "x.vcf"):
                for readid in (False, True):
                    kw = dict(engine=engine, distributed=distributed,
                              Ivcf=ivcf, report_readid=readid)
                    for is_cram in (False, True):
                        got = tpipe.stream_rule(TConfig(**kw), is_cram)
                        assert got.stream == jpipe._stream_dispatch_ok(
                            JConfig(**kw), is_cram), (kw, is_cram)
                        assert got.tail == (got.stream and not readid)
                        assert got.tail_first and not got.tail_done
                        n += got.stream
    assert n == 8


@pytest.mark.parametrize("where", ["dispatch", "tail"])
def test_streaming_failure_raises(tmp_path, monkeypatch, where):
    """No fallback: a failing early dispatch or mid-decode tail ends the
    run with its error, instead of decoding plainly."""
    bam, fa = _two_chrom_fixture(tmp_path)

    def boom(*args, **kwargs):
        raise RuntimeError("boom in %s" % where)

    if where == "dispatch":
        monkeypatch.setattr(tdev, "_cluster_stream_dispatch", boom)
    else:
        monkeypatch.setattr(tpipe, "_stream_tail_emit", boom)
    with pytest.raises(RuntimeError, match="boom in %s" % where):
        _run("port", bam, fa, tmp_path, where, monkeypatch, "1", "force")


def test_streaming_store_checkpoint_drops_handles(tmp_path, monkeypatch):
    """The streaming store pickles without its program handles and keeps
    them afterwards; the checkpoint resumes to the same VCF."""
    bam, fa = _two_chrom_fixture(tmp_path)
    monkeypatch.setattr(tpipe, "stream_rule", _seam("1", "0"))
    _, tcfg = _cfgs(bam, fa, tmp_path)
    store, _, _ = tpipe.decode_bam(tcfg, device="cpu")
    assert store.decode_breakdown["streaming"] and store.early_kernels
    path = tsig.save_store(store, str(tmp_path))
    assert store.early_kernels
    with open(path, "rb") as fh:
        back = pickle.load(fh)
    assert not hasattr(back, "early_kernels")
    assert back.early_valid == store.early_valid
    assert tpipe.resolve_all(back, tcfg, device="cpu") == \
        tpipe.resolve_all(store, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the all-types replay corpus
# ---------------------------------------------------------------------------

def _grid(tmp_path, window_bp, seed):
    bed = str(tmp_path / "grid.bed")
    n = chip_smoke.write_alltypes_bed(bed, "chr1", window_bp, seed=seed)
    return bed, n


def test_replay_writes_jax_bytes(tmp_path):
    bed, n = _grid(tmp_path, 600_000, 2)
    window = "chr1:0-600000"
    got = treplay(str(tmp_path / "t"), [bed], window, coverage=12, seed=4)
    want = jreplay(str(tmp_path / "j"), [bed], window, coverage=12, seed=4)
    assert got["n_sv"] == want["n_sv"] == n and got["n_dropped"] == 0
    for k in ("n_reads", "n_sv", "n_dropped"):
        assert got[k] == want[k], k
    for k in ("bam", "fa", "bed", "gt"):
        with open(got[k], "rb") as a, open(want[k], "rb") as b:
            assert a.read() == b.read(), k


def test_replay_guards_like_jax(tmp_path):
    bed = tmp_path / "t.bed"
    bed.write_text(
        "1\t100000\t101000\tinverted tandem duplication\t2\t0\n"
        "1\t200000\t200001\tinsertion\tACGTACGTACGTACGTACGT\t0\n"
        "1\t250000\t254000\treciprocal translocation\th1:1:5:forward:"
        "forward\t0\n")
    info = treplay(str(tmp_path / "rp"), [str(bed)], "1:0-400000",
                   coverage=8)
    assert info["n_sv"] == 1 and info["n_dropped"] == 2
    with pytest.raises(ValueError, match="64Mb"):
        treplay(str(tmp_path / "rp2"), [str(bed)], "1:0-100000000")


def test_alltypes_grid_equals_jax(tmp_path, monkeypatch):
    """A 3 Mb replayed grid (29 DEL, 29 INS, 29 DUP, 29 INV and 29
    reciprocal translocations, 20x) through the JAX package and the port
    (streaming with the full tail forced, streaming by default, plain,
    host engine): equal VCFs, and >= 99% of every planted type called
    with its type within 1 kb (BND per breakend pair), the bar of the
    card's all-types run. On a native store the TRA genotype windows ride
    the batched cover pass."""
    bed, n = _grid(tmp_path, 3_000_000, 5)
    info = treplay(str(tmp_path / "rp"), [bed], "chr1:0-3000000",
                   coverage=20, seed=1)
    assert info["n_sv"] == n and info["n_dropped"] == 0
    want, _ = _run("jax", info["bam"], info["fa"], tmp_path, "plain",
                   monkeypatch, "0")
    runs = {}
    for tag, dispatch, tail, engine in (
            ("force", "1", "force", "device"), ("stream", "1", None, "device"),
            ("plain", "0", None, "device"), ("host", "0", None, "host")):
        before = cover.LAUNCHES
        got, stats = _run("port", info["bam"], info["fa"], tmp_path, tag,
                          monkeypatch, dispatch, tail, engine=engine)
        assert cover.LAUNCHES == before   # the CPU never launches it
        assert got == want, tag
        runs[tag] = stats
    assert runs["force"]["early_tails"] >= 1
    out = tmp_path / "port_force.vcf"
    recall = chip_smoke.alltypes_recall(info["bed"], str(out))
    for svtype, (hit, total) in recall.items():
        assert total > 0 and hit >= 0.99 * total, (svtype, hit, total)
    kinds = {line.split("SVTYPE=")[1].split(";")[0]
             for line in _records(want)}
    assert kinds == {"DEL", "INS", "DUP", "INV", "BND"}


def test_tra_windows_ride_the_batched_pass(tmp_path, monkeypatch):
    """On a native store with the device engine the TRA genotype windows
    join the same cover pass as the other types (one cover call for the
    whole corpus) and genotype like the JAX package."""
    bam, fa = build_alltypes(tmp_path)
    calls, his = [], []
    orig = tpipe._batched_cover_multi

    def spy(specs, store, cover_fn=None, extra_blocks=()):
        calls.append(len(extra_blocks))

        def checked(w, s, e):
            his.append(max(max(b for _, b in w), int(e.max())))
            return cover_fn(w, s, e)
        return orig(specs, store, checked, extra_blocks)

    monkeypatch.setattr(tpipe, "_batched_cover_multi", spy)
    want, _ = _run("jax", bam, fa, tmp_path, "plain", monkeypatch, "0")
    got, _ = _run("port", bam, fa, tmp_path, "plain", monkeypatch, "0")
    assert got == want
    assert len(calls) == 1 and calls[0] >= 1
    # every launch's largest doubled coordinate (flush offsets included)
    # stays inside int32
    assert his and all(2 * hi < 2 ** 31 for hi in his)
    assert any("SVTYPE=BND" in l for l in _records(got))
