"""The port's native decoder, native store and batched cover pass against
the JAX package's, on the CPU.

* ``cutesv_tpu_torch.io.native.decode`` (the port's copy of the C++
  decoder, on zlib) gives the same ``NativeDecode`` field by field as
  ``cutesv_tpu.io.native.decode`` (libdeflate), on the fixtures of
  tests/test_native_decoder.py.
* ``sigstore.build_store_native`` gives equal stores: every column of
  every stream, census and read table.
* ``pipeline._batched_cover_multi`` gives equal counts, flush by flush.
* The VCF body of ``--decoder native`` equals the JAX package's (native
  decoder, device engine, no streaming dispatch) and the port's own
  ``--decoder python`` run.
All comparisons are exact.
"""
import functools
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from cutesv_tpu import pipeline as jpipe
from cutesv_tpu import sigstore as jsig
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.io import native as jnative
from cutesv_tpu.io.bam import BamWriter
from cutesv_tpu_torch import cli as tcli
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch import sigstore as tsig
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.io import native as tnative
from cutesv_tpu_torch.ops import build, cover
from cutesv_tpu_torch.ops.cover import cover_counts_cuda
from tests import simdata
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile
from tests.test_native_decoder import REFS, _make_random_bam, _qlen
from tests.test_torch_pipeline import build_engines_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# decoder-internal timings: measured, not decoded content
_TIMINGS = ("walk_s", "inflate_core_s", "records_core_s")


def _cfgs(bam, strict):
    kw = dict(input=str(bam), min_support=3)
    if strict:
        kw.update(min_size=50, min_mapq=10, max_split_parts=3,
                  min_read_len=800, min_siglength=25, merge_del_threshold=150,
                  merge_ins_threshold=20, max_size=5000)
    return JConfig(**kw), TConfig(**kw)


def _assert_decode_equal(jnd, tnd):
    for f in ("names", "chroms", "n_records", "ins_seq_blob", "first_u",
              "next_u"):
        assert getattr(tnd, f) == getattr(jnd, f), f
    for f in ("name_rank", "ref_lengths"):
        a, b = getattr(jnd, f), getattr(tnd, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert sorted(tnd.arrays) == sorted(jnd.arrays)
    for k, a in jnd.arrays.items():
        b = tnd.arrays[k]
        assert b.dtype == a.dtype and np.array_equal(b, a), k
    for f in _TIMINGS:
        assert getattr(tnd, f) >= 0.0


# ---------------------------------------------------------------------------
# NativeDecode, field by field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("strict", [False, True])
def test_native_decode_equals_jax(tmp_path, seed, strict):
    bam = tmp_path / ("fuzz%d.bam" % seed)
    _make_random_bam(str(bam), random.Random(seed))
    jcfg, tcfg = _cfgs(bam, strict)
    tnd = tnative.decode(str(bam), tcfg)
    _assert_decode_equal(jnative.decode(str(bam), jcfg), tnd)
    assert len(tnd.arrays["del_pos"]) + len(tnd.arrays["ins_len"]) > 0


def test_ultralong_records_cross_chunks_equal_jax(tmp_path):
    """Records larger than the decoder's 1 MB leftover gap straddle
    inflate chunks (the stitch-copy path)."""
    rng = random.Random(123)
    bam = tmp_path / "long.bam"
    pos = 1000
    with BamWriter(str(bam), REFS) as w:
        for i in range(30):
            read_len = 3_000_000 + rng.randrange(0, 1_500_000)
            d = rng.randrange(80, 400)
            m1 = read_len // 2
            cigar = [(0, m1), (2, d), (0, read_len - m1)]
            seq = "".join(rng.choice("ACGT") for _ in range(1000)) * (
                read_len // 1000) + "A" * (read_len % 1000)
            w.write("u%03d" % i, 0, 0, pos, 60, cigar, seq)
            pos += 500
    jcfg, tcfg = _cfgs(bam, False)
    tnd = tnative.decode(str(bam), tcfg)
    _assert_decode_equal(jnative.decode(str(bam), jcfg), tnd)
    assert len(tnd.arrays["del_pos"]) == 30


def test_single_thread_pools_equal_jax(tmp_path):
    """CUTESV_INFLATE_THREADS=1 / CUTESV_PARSE_WORKERS=1 take the
    pool-less paths (one zlib stream on the caller thread, one parse
    worker); the knobs are process-cached statics, so the port's decode
    runs in a subprocess and must equal the JAX package's pooled one."""
    bam = tmp_path / "st.bam"
    _make_random_bam(str(bam), random.Random(77), n_reads=400)
    jcfg, tcfg = _cfgs(bam, False)
    jnd = jnative.decode(str(bam), jcfg)
    tnative.get_lib()  # build here, not in the child
    script = (
        "import json, sys\n"
        "sys.path.insert(0, %r)\n"
        "from cutesv_tpu_torch.config import Config\n"
        "from cutesv_tpu_torch.io import native\n"
        "nd = native.decode(%r, Config(input=%r, min_support=3))\n"
        "print(json.dumps([{k: v.tolist() for k, v in nd.arrays.items()},\n"
        "                  nd.names, nd.n_records]))\n"
        % (REPO, str(bam), str(bam)))
    env = dict(os.environ, CUTESV_INFLATE_THREADS="1",
               CUTESV_PARSE_WORKERS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    arrays, names, n_records = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_records == jnd.n_records and names == jnd.names
    assert arrays == {k: v.tolist() for k, v in jnd.arrays.items()}


def test_name_ranks_lexicographic_equal_jax(tmp_path):
    bam = tmp_path / "r.bam"
    _make_random_bam(str(bam), random.Random(77), n_reads=100)
    jcfg, tcfg = _cfgs(bam, False)
    tnd = tnative.decode(str(bam), tcfg)
    _assert_decode_equal(jnative.decode(str(bam), jcfg), tnd)
    ranked = sorted(range(len(tnd.names)), key=lambda i: tnd.name_rank[i])
    assert [tnd.names[i] for i in ranked] == sorted(tnd.names)


def test_long_cigar_cg_tag_equal_jax(tmp_path):
    """A >65535-op CIGAR rides the CG:B,I tag (SAM spec 4.2.2)."""
    cigar = [(0, 120)]
    for _ in range(33_000):
        cigar += [(1, 12), (0, 5)]
    cigar += [(2, 60), (0, 120)]
    rng = random.Random(9)
    seq = "".join(rng.choice("ACGT") for _ in range(_qlen(cigar)))
    bam = tmp_path / "cg.bam"
    with BamWriter(str(bam), REFS) as w:
        w.write("cgread", 0, 0, 1000, 60, cigar, seq)
        w.write("plain", 0, 0, 2000, 60, [(0, 600), (2, 60), (0, 600)],
                "A" * 1200)
    kw = dict(input=str(bam), min_support=1)
    tnd = tnative.decode(str(bam), TConfig(**kw))
    _assert_decode_equal(jnative.decode(str(bam), JConfig(**kw)), tnd)
    assert 1000 + 120 + 33_000 * 5 in tnd.arrays["del_pos"].tolist()


def test_corrupt_input_raises_like_jax(tmp_path):
    bam = tmp_path / "cut.bam"
    _make_random_bam(str(bam), random.Random(3))
    data = bam.read_bytes()
    bam.write_bytes(data[:len(data) // 2])
    jcfg, tcfg = _cfgs(bam, False)
    with pytest.raises(IOError) as jerr:
        jnative.decode(str(bam), jcfg)
    with pytest.raises(IOError) as terr:
        tnative.decode(str(bam), tcfg)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# build_store_native
# ---------------------------------------------------------------------------

def _indel_cols(stream):
    cols = {k: getattr(stream, k) for k in ("pos", "length", "rid",
                                            "seq_len")}
    cols["seqs"] = ([stream.seq_of(k) for k in range(len(stream))]
                    if stream.seq_len is not None else None)
    cols["names"] = stream.names_of(np.arange(len(stream)))
    return cols


def _assert_store_equal(js, ts):
    assert ts.names == js.names
    assert ts.chrom_lengths == js.chrom_lengths
    for t in tsig.SVTYPES:
        assert list(ts.sigs[t]) == list(js.sigs[t]), t
        for chrom, jstream in js.sigs[t].items():
            tstream = ts.sigs[t][chrom]
            if t in ("DEL", "INS"):
                jc, tc = _indel_cols(jstream), _indel_cols(tstream)
                for k, a in jc.items():
                    b = tc[k]
                    if isinstance(a, np.ndarray):
                        assert b.dtype == a.dtype and np.array_equal(a, b), k
                    else:
                        assert b == a, k
            else:
                assert tstream == jstream, (t, chrom)
    assert list(ts.census) == list(js.census)
    for chrom, jc in js.census.items():
        tc = ts.census[chrom]
        assert sorted(tc) == sorted(jc)
        for k, a in jc.items():
            assert tc[k].dtype == a.dtype and np.array_equal(tc[k], a), k
    assert list(ts.read_tables) == list(js.read_tables)
    for chrom, jt in js.read_tables.items():
        tt = ts.read_tables[chrom]
        for k in ("start", "end", "prim", "names"):
            a, b = getattr(jt, k), getattr(tt, k)
            assert b.dtype == a.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("strict", [False, True])
def test_build_store_native_equals_jax(tmp_path, seed, strict):
    bam = tmp_path / ("s%d.bam" % seed)
    _make_random_bam(str(bam), random.Random(seed), n_reads=400)
    jcfg, tcfg = _cfgs(bam, strict)
    js = jsig.build_store_native(jnative.decode(str(bam), jcfg), jcfg)
    ts = tsig.build_store_native(tnative.decode(str(bam), tcfg))
    _assert_store_equal(js, ts)
    assert sum(len(v) for v in ts.sigs["DEL"].values()) > 0


def test_build_store_native_all_types_equal_jax(tmp_path):
    bam, _ = build_alltypes(tmp_path)
    jcfg, tcfg = _cfgs(bam, False)
    js = jsig.build_store_native(jnative.decode(str(bam), jcfg), jcfg)
    ts = tsig.build_store_native(tnative.decode(str(bam), tcfg))
    _assert_store_equal(js, ts)
    assert all(ts.sigs[t] for t in ("DEL", "DUP", "INV", "TRA"))


def test_decode_bam_with_bed_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "0")
    bam, fa = build_alltypes(tmp_path)
    bed = tmp_path / "r.bed"
    bed.write_text("chr1\t5000\t25000\nchrX\t1\t2\n")
    kw = dict(input=str(bam), reference=str(fa), min_support=3,
              include_bed=str(bed), decoder="native")
    js, _, jrefs, jn = jpipe.decode_bam(JConfig(engine="device", **kw))
    ts, _, trefs, tn = tpipe.decode_bam(TConfig(**kw))
    _assert_store_equal(js, ts)
    assert (trefs, tn) == (jrefs, jn)
    assert ts.decode_breakdown["decoder"] == "native"


@pytest.mark.parametrize("chr_ids,starts", [
    ([0, 0, 1, 1], [5, 3, 1, 2]),        # a start decreases
    ([0, 1, 0], [1, 2, 3]),              # a chromosome in two blocks
    ([0, 0, 1, 1], [1, 2, 1, 9]),        # sorted
    ([], []),
])
def test_check_coordinate_sorted_equals_jax(chr_ids, starts):
    names = ["c0", "c1"]
    args = (np.array(chr_ids, np.int32), np.array(starts, np.int64), names)
    try:
        jpipe._check_coordinate_sorted(*args)
        want = None
    except ValueError as exc:
        want = str(exc)
    if want is None:
        tpipe._check_coordinate_sorted(*args)
    else:
        with pytest.raises(ValueError) as err:
            tpipe._check_coordinate_sorted(*args)
        assert str(err.value) == want


# ---------------------------------------------------------------------------
# the batched cover pass
# ---------------------------------------------------------------------------

class _Store:
    def __init__(self, census):
        self.census = census


def _random_census(rng, span, n):
    start = np.sort(rng.integers(0, max(span - 30_000, 1), n))
    end = start + rng.integers(1_000, 30_000, n)
    return dict(start=start.astype(np.int64), end=end.astype(np.int64),
                is_primary=(rng.random(n) < 0.85).astype(np.int8),
                name=rng.integers(0, n, n).astype(np.int64))


def _random_specs(rng, spans, with_census):
    """Two specs over the chromosomes of ``spans``: a one-group pass and
    a three-group pass; jobs carry windows inside each span."""
    census = {}
    per1, per2 = {}, {}
    for c, span in spans.items():
        if c in with_census:
            census[c] = _random_census(rng, span, 300)
        s = rng.integers(0, span - 5_000, 20)
        w1 = [(int(a), int(a) + 400) for a in s]
        per1[c] = ([["c1", c, k] for k in range(20)],
                   [{"window": w} for w in w1])
        if c.endswith(("1", "3")):
            s2 = rng.integers(0, span - 5_000, 7)
            per2[c] = ([["c2", c, k] for k in range(7)],
                       [{"window1": (int(a), int(a) + 300),
                         "window2": (int(a) + 1_000, int(a) + 1_600)}
                        for a in s2])
    return census, per1, per2


def _run_multi(impl, census, per1, per2, blocks, cover_fn):
    got = {}

    def apply(tag):
        def fn(chrom, cands, jobs, cen, counts):
            got[(tag, chrom)] = [np.asarray(c, np.int64).tolist()
                                 for c in counts]
        return fn

    specs = [(per1, lambda jobs: [[j["window"] for j in jobs]], apply(1)),
             (per2, lambda jobs: [[j["window1"] for j in jobs],
                                  [j["window2"] for j in jobs]], apply(2))]
    sinks = []
    for i, blk in enumerate(blocks):
        blk = dict(blk)
        blk["sink"] = (lambda i: lambda c: got.__setitem__(
            ("extra", i), np.asarray(c, np.int64).tolist()))(i)
        sinks.append(blk)
    impl(specs, _Store(census), cover_fn, extra_blocks=sinks)
    dropped = {c: len(per1[c][0]) for c in per1}
    return got, dropped


def _extra_block(rng, n_wins, n_reads, span):
    st = np.sort(rng.integers(0, span - 30_000, n_reads)).astype(np.int64)
    wins = [(int(a), int(a) + 500)
            for a in rng.integers(0, span - 1_000, n_wins)]
    return dict(windows=wins, starts=st,
                ends=st + rng.integers(1_000, 30_000, n_reads))


@pytest.mark.parametrize("case", ["one_flush", "three_flushes",
                                  "beyond_budget", "extra_blocks"])
def test_batched_cover_multi_equals_jax(case):
    rng = np.random.default_rng(["one_flush", "three_flushes",
                                 "beyond_budget", "extra_blocks"].index(case))
    spans = {"chr1": 40_000_000, "chr2": 25_000_000, "chr3": 60_000}
    blocks = []
    if case == "three_flushes":
        # 450 Mb chromosomes: two fit one 1e9 flush, and the five with a
        # census (chr2 has none) need three
        spans = {"chr%d" % i: 450_000_000 for i in range(1, 7)}
    elif case == "beyond_budget":
        # one chromosome past the int32-safe budget counts on the host
        spans = {"chr1": 1_200_000_000, "chr2": 30_000_000,
                 "chr3": 300_000_000}
    elif case == "extra_blocks":
        blocks = [
            # few windows over a large private read set: host sweep
            _extra_block(rng, 3, 200, 5_000_000),
            # 10 * 32 >= 100: rides the kernel call
            _extra_block(rng, 10, 100, 5_000_000),
            # exactly on the gate (4 * 32 == 128): rides too
            _extra_block(rng, 4, 128, 800_000_000),
            dict(windows=[], starts=np.zeros(0, np.int64),
                 ends=np.zeros(0, np.int64)),
        ]
    with_census = set(spans) - {"chr2"}
    census, per1, per2 = _random_specs(rng, spans, with_census)
    calls = []

    def port_cover(w, s, e):
        calls.append((len(w), len(s), int(max(b for _, b in w))))
        return cover_counts_cuda(w, s, e, device="cpu")

    def copy(per):
        return {c: (list(cands), jobs) for c, (cands, jobs) in per.items()}

    jcfg = JConfig(engine="device")
    jgot, jdrop = _run_multi(
        lambda specs, store, _fn, extra_blocks: jpipe._batched_cover_multi(
            specs, store, jcfg, extra_blocks=extra_blocks),
        census, copy(per1), copy(per2), blocks, None)
    tgot, tdrop = _run_multi(tpipe._batched_cover_multi, census, per1, per2,
                             blocks, port_cover)
    assert tgot == jgot
    assert tdrop == jdrop and tdrop["chr2"] == 0  # no census: dropped
    for _, _, hi in calls:
        assert 2 * hi < 2 ** 31  # doubled coordinates fit int32
    want_calls = {"one_flush": 1, "three_flushes": 3, "beyond_budget": 1,
                  "extra_blocks": 1}[case]
    assert len(calls) == want_calls
    if case == "extra_blocks":
        # the host-swept block and the empty one never reach the kernel
        spec_windows = sum(len(per1[c][1]) + 2 * len(per2.get(c, (0, []))[1])
                           for c in with_census)
        riders = sum(len(b["windows"]) for b in blocks[1:3])
        assert calls[0][0] == spec_windows + riders
        assert len(tgot[("extra", 0)]) == 3 and tgot[("extra", 3)] == []


def test_batched_cover_pass_counts_like_host():
    rng = np.random.default_rng(9)
    census = {"chr1": _random_census(rng, 5_000_000, 500)}
    jobs = [{"window": (int(a), int(a) + 700)}
            for a in rng.integers(0, 4_000_000, 50)]
    got = {}
    tpipe._batched_cover_pass(
        {"chr1": ([None] * 50, jobs)}, _Store(census),
        functools.partial(cover_counts_cuda, device="cpu"),
        lambda js: [[j["window"] for j in js]],
        lambda chrom, cands, js, cen, counts: got.update(c=counts[0]))
    prim = census["chr1"]["is_primary"] == 1
    want = tpipe.cover_counts([j["window"] for j in jobs],
                              census["chr1"]["start"][prim],
                              census["chr1"]["end"][prim])
    assert np.array_equal(np.asarray(got["c"], np.int64), want)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

FIXTURES = {"engines": build_engines_fixture, "alltypes": build_alltypes}


def _vcf_jax_native(bam, fa, out, wd):
    cfg = JConfig(input=str(bam), reference=str(fa), output=str(out),
                  work_dir=str(wd), genotype=True, min_support=3,
                  engine="device", decoder="native")
    jpipe.run_pipeline(cfg, ["x"])
    return _strip_volatile(out.read_text())


def _vcf_port(bam, fa, out, wd, decoder, engine="device"):
    cfg = TConfig(input=str(bam), reference=str(fa), output=str(out),
                  work_dir=str(wd), genotype=True, min_support=3,
                  engine=engine, decoder=decoder)
    stats = tpipe.run_pipeline(cfg, ["x"], device="cpu")
    return _strip_volatile(out.read_text()), stats


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_native_vcf_equals_jax_and_python(tmp_path, monkeypatch, fixture):
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "0")
    bam, fa = FIXTURES[fixture](tmp_path)
    want = _vcf_jax_native(bam, fa, tmp_path / "j.vcf", tmp_path / "wj")
    before = cover.LAUNCHES
    got, stats = _vcf_port(bam, fa, tmp_path / "n.vcf", tmp_path / "wn",
                           "native")
    assert cover.LAUNCHES == before  # a CPU run never launches the kernel
    assert stats["decoder"] == "native"
    for k in _TIMINGS:
        assert stats[k] >= 0.0
    py, py_stats = _vcf_port(bam, fa, tmp_path / "p.vcf", tmp_path / "wp",
                             "python")
    assert py_stats["decoder"] == "python"
    assert got == want == py
    assert len([l for l in got.splitlines()
                if l and not l.startswith("#")]) >= 2


def test_native_host_engine_equals_device_engine(tmp_path):
    bam, fa = build_alltypes(tmp_path)
    host, _ = _vcf_port(bam, fa, tmp_path / "h.vcf", tmp_path / "wh",
                        "native", engine="host")
    dev, _ = _vcf_port(bam, fa, tmp_path / "d.vcf", tmp_path / "wd",
                       "native")
    assert host == dev


def test_cli_verify_recipe_native(tmp_path):
    """The verification recipe's fixture through the port's CLI with the
    default decoder on the CPU: one hom DEL (1/1), one het INS (0/1)."""
    rng = random.Random(5)
    ref = simdata.make_reference(rng, {"chr1": 80_000})
    c1 = ref["chr1"]
    plans = []
    ins_seq = simdata.random_seq(rng, 70)
    for i, start in enumerate(range(0, 77_000, 250)):
        q = "rd%05d" % i
        if 27_350 <= start <= 29_800:
            plans.append(simdata.read_with_del(c1, 0, start, 30_000, 150,
                                               start + 3000 - 30_150, q))
        elif 57_000 <= start <= 59_000 and i % 2 == 0:
            plans.append(simdata.read_with_ins(c1, 0, start, 60_000, ins_seq,
                                               start + 3000 - 60_000, q))
        else:
            plans.append(simdata.plain_read(c1, 0, start, 3000, q))
    simdata.write_bam(str(tmp_path / "sim.bam"), [("chr1", 80_000)], plans)
    simdata.write_ref_fasta(str(tmp_path / "ref.fa"), ref)
    out = tmp_path / "out.vcf"
    assert tcli.main([str(tmp_path / "sim.bam"), str(tmp_path / "ref.fa"),
                      str(out), str(tmp_path / "wd"), "--genotype", "-s",
                      "3", "--device", "cpu"]) == 0
    recs = [l.split("\t") for l in out.read_text().splitlines()
            if not l.startswith("#")]
    assert [(r[2], r[1], r[9].split(":")[0]) for r in recs] == [
        ("cuteSV.DEL.0", "30000", "1/1"), ("cuteSV.INS.0", "60000", "0/1")]


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """Point ops/build.py at an empty build folder with nothing loaded, and
    make the Python reader fail loudly if anything reaches it."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(tnative, "_lib", None)

    def no_python(cfg):
        raise AssertionError("decoded through the Python reader")
    monkeypatch.setattr(tpipe, "_decode_bam_python", no_python)
    return monkeypatch


@pytest.mark.parametrize("decoder", ["native", "auto"])
def test_missing_compiler_raises(tmp_path, fresh_build, decoder):
    fresh_build.setattr(build, "GXX", "no-such-compiler-g++")
    bam, fa = build_engines_fixture(tmp_path)
    cfg = TConfig(input=str(bam), reference=str(fa), decoder=decoder)
    with pytest.raises(RuntimeError, match="no-such-compiler-g\\+\\+ not "
                                           "found"):
        tpipe.decode_bam(cfg)
    assert not list((tmp_path / "build").rglob("*.so"))


def test_failed_compile_raises_with_compiler_output(tmp_path, fresh_build):
    src = tmp_path / "native"
    src.mkdir()
    (src / "bamdecode.cpp").write_text("int broken( {\n")
    fresh_build.setattr(build, "NATIVE", src)
    bam, fa = build_engines_fixture(tmp_path)
    cfg = TConfig(input=str(bam), reference=str(fa), decoder="native")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tpipe.decode_bam(cfg)
    assert not list((tmp_path / "build").rglob("libbamdecode*"))
