"""The readers of the program's spans (stats["trace"]) give the numbers
computed by hand from a run built by hand, and nothing without the
spans (a program that records none) or without device operations."""
import pytest

from svbench import registry
from svbench.harness import Run
from svbench.roofline import cover_bound_ms

SPAN_METRICS = ("walk_reads_per_s", "stream_host_ms", "post_walk_ms",
                "inflate_core_s", "records_core_s", "cover_flush_roofline",
                "idle_outside_walk_share")


def _span(name, t0, t1, **counters):
    return dict(name=name, t0_ns=int(round(t0 * 1e9)),
                t1_ns=int(round(t1 * 1e9)), counters=counters)


def _call(t0, records, inflate, parse, tail_s):
    """One call of 2 s from ``t0``: a 1 s walk from t0 + 0.1, a dispatch
    of 0.1 s inside it, a tail of ``tail_s`` s ending 0.1 s after it, a
    DONE-batch dispatch, a 0.1 s store, one flush with one launch."""
    spans = [
        _span("call", t0, t0 + 1.9),
        _span("decode", t0, t0 + 1.5),
        _span("decode.dispatch", t0 + 0.5, t0 + 0.6, done=0),
        _span("decode.tail", t0 + 1.2 - tail_s, t0 + 1.2, done=0,
              windows=4, candidates=2),
        _span("decode.dispatch", t0 + 1.2, t0 + 1.3, done=1),
        _span("decode.join", t0 + 1.3, t0 + 1.35),
        _span("decode.walk", t0 + 0.1, t0 + 1.1, records=records,
              inflate_core_s=inflate, records_core_s=parse),
        _span("store", t0 + 1.35, t0 + 1.45),
        _span("resolve", t0 + 1.5, t0 + 1.8),
        _span("genotype.flush", t0 + 1.6, t0 + 1.7, windows=10, reads=100,
              launches=1),
        _span("cover.launch", t0 + 1.62, t0 + 1.63, windows=10, reads=100,
              kernel="cover_count_kernel"),
    ]
    return dict(t0=t0, t1=t0 + 2.0, error=None,
                stats=dict(trace=dict(id="1.0", spans=spans)))


def _run(with_device=True):
    run = Run(records_per_call=1000)
    run.calls = [_call(100.0, 1000, 2.0, 1.0, 0.2),
                 _call(102.0, 3000, 4.0, 0.5, 0.1)]
    if with_device:
        # one operation inside each call's walk (outside its flush), one
        # inside each flush
        run.device_ops = [("sort", 100.2, 100.25),
                          ("cover_count_kernel", 101.61, 101.64),
                          ("sort", 102.2, 102.25),
                          ("cover_count_kernel", 103.61, 103.63)]
    return run


def _read(name, run):
    return registry.reader(name)(run)


def test_walk_reads_per_s():
    # 4,000 records over two walks of 1 s
    assert _read("walk_reads_per_s", _run()) == pytest.approx(2000.0)


def test_stream_host_ms():
    # per call: the 0.1 s dispatch inside the walk, and the part of the
    # tail before the walk's end (0.1 s of 0.2 s; 0 s of 0.1 s); the
    # DONE-batch dispatch lies after the walk
    assert _read("stream_host_ms", _run()) == pytest.approx(
        (200.0 + 100.0) / 2)


def test_post_walk_ms():
    # decode ends 0.4 s after the walk, of which 0.1 s is the store
    assert _read("post_walk_ms", _run()) == pytest.approx(300.0)


@pytest.mark.parametrize("name,want", [("inflate_core_s", 3.0),
                                       ("records_core_s", 0.75)])
def test_decoder_core_seconds(name, want):
    assert _read(name, _run()) == pytest.approx(want)


def test_cover_flush_roofline():
    # the floor of the two launches over the device time started inside
    # the flushes (0.03 s and 0.02 s; the walk's sorts are left out)
    want = 100.0 * 2 * cover_bound_ms(10, 100) / 1e3 / 0.05
    assert _read("cover_flush_roofline", _run()) == pytest.approx(want)


def _flush_call(t0, f0, kernel, offset, after=None):
    """One call of ``_call``'s with a 1 ms flush at ``f0``: an upload,
    the launch of the kernel named ``kernel``, the kernel and the
    readback, with the profiler's device clock ``offset`` s off the
    host's; ``after``: an operation that many s after the flush's end.
    Returns the call and its device operations."""
    call = _call(t0, 1000, 2.0, 1.0, 0.2)
    call["stats"]["trace"]["spans"] = [
        s for s in call["stats"]["trace"]["spans"]
        if s["name"] not in ("genotype.flush", "cover.launch")] + [
        _span("genotype.flush", f0, f0 + 0.001, windows=10, reads=100,
              launches=1),
        _span("cover.launch", f0 + 0.0006, f0 + 0.0007, windows=10,
              reads=100, kernel=kernel)]
    device = [("sort", f0 - 0.4, 0.01), ("Memcpy HtoD", f0 + 0.0002, 5e-6),
              ("(anonymous namespace)::%s(Args)" % kernel, f0 + 0.0007, 25e-6),
              ("Memcpy DtoH", f0 + 0.00075, 2e-6)]
    if after is not None:
        device.append(("emit_copy", f0 + 0.001 + after, 1e-5))
    return call, [(name, a + offset, a + offset + dt)
                  for name, a, dt in device]


@pytest.mark.parametrize("kernel", ["cover_count_kernel", "count_v2"])
@pytest.mark.parametrize("offset", [0.0, -0.004, -0.0003, 0.003])
def test_cover_flush_roofline_under_a_device_clock_offset(offset, kernel):
    # the device clock ``offset`` s off the host's puts the flush's
    # operations outside its span (or its kernel before its launch), and
    # the kernel that the launch span names, whatever it is called,
    # against that span brings them back
    run = Run(records_per_call=1000)
    call, run.device_ops = _flush_call(100.0, 101.6, kernel, offset)
    run.calls = [call]
    want = 100.0 * cover_bound_ms(10, 100) / 1e3 / (5e-6 + 25e-6 + 2e-6)
    assert _read("cover_flush_roofline", run) == pytest.approx(want)


@pytest.mark.parametrize("offset,after", [(-0.004, 0.002), (0.003, -0.005),
                                          (0.0, 0.0002)])
def test_cover_flush_roofline_beside_other_operations(offset, after):
    # each of two calls has an operation ``after`` s beside its flush,
    # which a window shifted too far would hold; the flush's operations
    # are what is counted
    run = Run(records_per_call=1000)
    run.calls, run.device_ops = [], []
    for t0 in (100.0, 102.0):
        call, ops = _flush_call(t0, t0 + 1.6, "count_v2", offset, after)
        run.calls.append(call)
        run.device_ops += ops
    want = 100.0 * cover_bound_ms(10, 100) / 1e3 / (5e-6 + 25e-6 + 2e-6)
    assert _read("cover_flush_roofline", run) == pytest.approx(want)


def test_idle_outside_walk_share():
    # window 100-104 s: the walks cover 2 s, the sorts lie inside them,
    # the flushes' operations add 0.03 s and 0.02 s
    assert _read("idle_outside_walk_share", _run()) == pytest.approx(
        1.0 - 2.05 / 4.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_without_the_spans(name):
    run = _run()
    for c in run.calls:
        del c["stats"]["trace"]
    assert _read(name, run) is None
    failed = _run()
    for c in failed.calls:
        c["error"] = "Traceback"
    assert _read(name, failed) is None


@pytest.mark.parametrize("name", ("cover_flush_roofline",
                                  "idle_outside_walk_share"))
def test_nothing_without_device_operations(name):
    assert _read(name, _run(with_device=False)) is None


def test_every_span_metric_is_declared_for_both_cells():
    bench = registry.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["moves"] == "reads_per_s"
        assert entries[name]["workloads"] == ["hifi.germline",
                                              "ont.germline"]
