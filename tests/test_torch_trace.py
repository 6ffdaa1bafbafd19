"""The port's spans and counters (``cutesv_tpu_torch/utils/trace.py``)
on the CPU: a streaming run of the all-types fixture (the native decoder
on its own thread, the DONE batch's DEL/INS tails forced, the pair and
TRA programs and one cover flush) returns every stage as a span with the
right parent, stage times that are their spans' durations, the decoder's
records, and the JAX package's VCF body; a span with no recorder does
nothing; and spans share the profiler's clock."""
import time

import pytest
import torch

from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.pipeline import run_pipeline as jrun
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.pipeline import run_pipeline as trun
from cutesv_tpu_torch.utils import trace
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile

# every span of the call and the span it runs under
PARENT = {"call": None, "decode": "call", "decode.dispatch": "decode",
          "decode.tail": "decode", "decode.join": "decode",
          "decode.walk": "decode", "store": "decode", "resolve": "call",
          "resolve.programs": "resolve", "resolve.indel": "resolve",
          "resolve.pair": "resolve", "resolve.tra": "resolve",
          "genotype": "resolve", "genotype.flush": "genotype",
          "cover.launch": "genotype.flush", "emit": "call",
          "emit.format": "emit", "emit.write": "emit"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's stats, its VCF, the JAX package's VCF) of one
    streaming run of the all-types fixture."""
    tmp = tmp_path_factory.mktemp("trace")
    bam, fa = build_alltypes(tmp)
    kw = dict(input=str(bam), reference=str(fa), genotype=True,
              min_support=3, engine="device", decoder="native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUTESV_STREAM_DISPATCH", "1")
        mp.setenv("CUTESV_STREAM_TAIL", "force")
        stats = trun(TConfig(output=str(tmp / "port.vcf"),
                             work_dir=str(tmp / "wport"), **kw), ["x"],
                     device="cpu")
        jrun(JConfig(output=str(tmp / "jax.vcf"),
                     work_dir=str(tmp / "wjax"), **kw), ["x"])
    return (stats, (tmp / "port.vcf").read_text(),
            (tmp / "jax.vcf").read_text())


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_every_span_has_its_parent(runs):
    stats = runs[0]
    spans = stats["trace"]["spans"]
    by_id = {s["id"]: s for s in spans}
    assert set(_by_name(spans)) == set(PARENT)
    assert len(spans) <= 400
    for s in spans:
        parent = by_id.get(s["parent"])
        assert (parent and parent["name"]) == PARENT[s["name"]], s
        assert s["t0_ns"] <= s["t1_ns"]
        if parent:
            assert parent["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] \
                <= parent["t1_ns"], (s, parent)
    walk, = _by_name(spans)["decode.walk"]
    assert walk["thread"] == "decoder"
    assert stats["trace"]["id"]


def test_stage_stats_are_their_spans(runs):
    stats = runs[0]
    spans = stats["trace"]["spans"]
    by = _by_name(spans)

    def dur(name, **match):
        return sum(s["t1_ns"] - s["t0_ns"] for s in by[name]
                   if all(s["counters"][k] == v for k, v in match.items())
                   ) / 1e9

    for key, name in (("decode_s", "decode"), ("resolve_s", "resolve"),
                      ("emit_s", "emit"), ("total_s", "call")):
        assert stats[key] == pytest.approx(dur(name), abs=1e-3), key
    decode, = by["decode"]
    join, = by["decode.join"]
    assert stats["native_s"] == pytest.approx(
        (join["t1_ns"] - decode["t0_ns"]) / 1e9, abs=1e-3)
    assert stats["store_s"] == pytest.approx(
        (decode["t1_ns"] - join["t1_ns"]) / 1e9, abs=1e-3)
    assert stats["store_s"] >= dur("store")
    assert stats["decode_s"] == pytest.approx(
        stats["native_s"] + stats["store_s"], abs=1e-3)
    # the loop takes each chromosome as it completes: its spans before
    # the DONE batch are the work overlapped with the walk
    assert stats["overlap_work_s"] == pytest.approx(
        dur("decode.dispatch", done=0) + dur("decode.tail", done=0),
        abs=1e-3)
    assert stats["done_tail_s"] == pytest.approx(
        dur("decode.dispatch", done=1) + dur("decode.tail", done=1),
        abs=1e-3)
    assert stats["tail_windows"] == sum(s["counters"]["windows"]
                                        for s in by["decode.tail"])
    assert stats["tail_windows"] >= 1
    assert stats["walk_s"] == pytest.approx(dur("decode.walk"), abs=1e-6)


def test_counters_match_the_stats_and_the_vcf(runs):
    stats, body = runs[0], runs[1]
    spans = _by_name(stats["trace"]["spans"])
    walk, = spans["decode.walk"]
    assert walk["counters"]["records"] == stats["n_records"] > 0
    assert walk["counters"]["inflate_core_s"] == stats["inflate_core_s"]
    assert walk["counters"]["records_core_s"] == stats["records_core_s"]
    store, = spans["store"]
    assert store["counters"] == {"signatures." + t: n
                                 for t, n in stats["n_sigs"].items()}
    records = [l for l in body.splitlines() if l and not l.startswith("#")]
    assert stats["n_calls"] == len(records) > 0
    # each of the fixture's two chromosomes dispatched once (``chroms``),
    # the last one's in the DONE batch; each program's compaction, and the
    # DONE batch's prefetch of the counts where it dispatched a program,
    # carry ``done`` alone
    chroms = [s for s in spans["decode.dispatch"] if "chroms" in s["counters"]]
    assert [set(s["counters"]) for s in chroms] == [{"done", "chroms"}] * 2
    assert all(s["counters"]["chroms"] == 1 for s in chroms)
    assert chroms[-1]["counters"]["done"] == 1
    others = [s for s in spans["decode.dispatch"] if s not in chroms]
    assert all(set(s["counters"]) == {"done"} for s in others)
    assert stats["early_dispatched"] <= len(others) \
        <= stats["early_dispatched"] + 1
    assert all(set(s["counters"]) == {"done", "windows"}
               for s in spans["decode.tail"])
    flush, = spans["genotype.flush"]
    launch, = spans["cover.launch"]
    genotype, = spans["genotype"]
    assert launch["counters"] == dict(windows=flush["counters"]["windows"],
                                      reads=flush["counters"]["reads"])
    assert flush["counters"]["windows"] > 0
    assert genotype["counters"] == {}
    assert flush["counters"]["launches"] == 0   # the CPU's plain count


def test_body_equals_jax(runs):
    _, port, jax = runs
    assert _strip_volatile(port) == _strip_volatile(jax)


def test_span_without_a_recorder_does_nothing():
    assert trace._active is None
    with trace.span("x", n=1) as counters:
        counters["m"] = 2
    trace.add_span("y", 1, 2, "t")
    assert trace._active is None
    with trace.recording() as outer:
        with trace.recording() as inner:
            with trace.span("a", k=1) as counters:
                counters["k"] += 1
        with trace.span("b"):
            pass
    assert trace._active is None
    assert [s["name"] for s in inner.spans] == ["a"]
    assert inner.spans[0]["counters"] == {"k": 2}
    assert [s["name"] for s in outer.spans] == ["b"]
    assert outer.id != inner.id


def test_spans_share_the_profilers_clock():
    """A torch.profiler event opened inside a program span lies inside
    the span: both read the epoch clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            with trace.span("outer"):
                time.sleep(0.002)
                with record_function("inner"):
                    torch.ones(1000).sum()
                time.sleep(0.002)
    outer, = rec.spans
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert len(inner) == 1
    t0 = inner[0].start_ns()
    assert outer["t0_ns"] <= t0 <= t0 + inner[0].duration_ns() \
        <= outer["t1_ns"]
