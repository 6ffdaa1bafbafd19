"""pair_ms and pair_records read the program's ``resolve.pair`` and
``resolve.tra`` spans (stats["trace"]): the numbers computed by hand from
calls built by hand, the mean per call, and None where a program records
neither the spans (pair_ms) nor their counters (pair_records), as a
program before the counters does."""
import pytest

from svbench import registry
from svbench.harness import Run


def _span(name, t0_ms, t1_ms, **counters):
    return dict(name=name, t0_ns=int(t0_ms * 1e6), t1_ns=int(t1_ms * 1e6),
                counters=counters)


def _call(k, dup, inv, tra, counted=True):
    """One call: a 4 ms ``resolve.pair``, a 2 ms ``resolve.tra`` and a
    1 ms ``resolve.tra`` (the finalize), among other spans; with or
    without the record counters."""
    pair = dict(sigs_DUP=10 * dup, clusters_DUP=dup, records_DUP=dup,
                sigs_INV=10 * inv, clusters_INV=inv, records_INV=inv)
    spans = [_span("resolve", 0, 20),
             _span("resolve.indel", 1, 3),
             _span("resolve.pair", 3, 7, **(pair if counted else {})),
             _span("resolve.tra", 7, 9, **(dict(sigs=10 * tra, clusters=tra,
                                                records=tra)
                                           if counted else {})),
             _span("genotype.flush", 9, 12, windows=5, reads=9,
                   windows_pair=3 * (dup + inv), windows_tra=0,
                   launches=1),
             _span("resolve.tra", 12, 13)]
    return dict(t0=float(k), t1=k + 1.0, error=None,
                stats=dict(trace=dict(id="1.%d" % k, spans=spans)))


def _run(*calls):
    run = Run(records_per_call=10)
    run.calls = list(calls)
    return run


def _read(name, run):
    return registry.reader(name)(run)


def test_pair_ms_sums_the_pair_and_tra_spans_of_a_call():
    run = _run(_call(0, 1, 1, 2), _call(1, 3, 0, 4, counted=False))
    assert _read("pair_ms", run) == pytest.approx(4 + 2 + 1)


def test_pair_records_is_the_mean_per_call():
    run = _run(_call(0, 40, 35, 75), _call(1, 38, 36, 70))
    assert _read("pair_records", run) == pytest.approx(
        ((40 + 35 + 75) + (38 + 36 + 70)) / 2)


def test_zero_records_read_zero():
    assert _read("pair_records", _run(_call(0, 0, 0, 0))) == 0


@pytest.mark.parametrize("run", [
    _run(_call(0, 4, 3, 2, counted=False)),  # spans without the counters
    _run(dict(t0=0.0, t1=1.0, error=None,
              stats=dict(trace=dict(id="1.0", spans=[])))),
    Run(records_per_call=10),                # no calls
], ids=["no_counters", "no_spans", "no_calls"])
def test_pair_records_without_the_counters_gives_none(run):
    assert _read("pair_records", run) is None


@pytest.mark.parametrize("run", [
    _run(dict(t0=0.0, t1=1.0, error=None,
              stats=dict(trace=dict(id="1.0", spans=[
                  _span("resolve", 0, 20)])))),
    Run(records_per_call=10),
], ids=["no_spans", "no_calls"])
def test_pair_ms_without_the_spans_gives_none(run):
    assert _read("pair_ms", run) is None


def test_failed_and_untraced_calls_are_left_out():
    run = _run(_call(0, 4, 3, 2), _call(1, 9, 9, 9))
    run.calls[1]["error"] = "boom"
    run.calls.append(dict(t0=9.0, t1=10.0, error=None, stats={}))
    assert _read("pair_records", run) == 9
    assert _read("pair_ms", run) == pytest.approx(7)
