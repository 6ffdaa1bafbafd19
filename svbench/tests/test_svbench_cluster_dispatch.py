"""cluster_dispatch_ms and cluster_graph_share read the program's
``cluster.dispatch`` spans: their summed time per call and the share of
them that replayed a graph (``graph`` = 1), each the mean over calls,
and None where a program records no such span, as a program before it
does."""
import pytest

from svbench import registry
from svbench.harness import Run


def _span(name, t0_ms, t1_ms, **counters):
    return dict(name=name, t0_ns=int(t0_ms * 1e6), t1_ns=int(t1_ms * 1e6),
                counters=counters)


def _call(k, dispatches, spanned=True):
    """One call whose chromosomes each dispatch one program inside a
    ``decode.dispatch`` span; ``dispatches``: (ms, graph) per program."""
    spans = [_span("decode", 0, 100), _span("decode.walk", 1, 60)]
    t = 2.0
    for ms, graph in dispatches:
        spans.append(_span("decode.dispatch", t, t + ms + 1, done=0,
                           chroms=1))
        if spanned:
            spans.append(_span("cluster.dispatch", t + 0.5, t + 0.5 + ms,
                               graph=graph, captured=0, rows=4096))
        t += ms + 2
    return dict(t0=float(k), t1=k + 1.0, error=None,
                stats=dict(trace=dict(id="1.%d" % k, spans=spans)))


def _run(*calls):
    run = Run(records_per_call=10)
    run.calls = list(calls)
    return run


def _read(name, run):
    return registry.reader(name)(run)


def test_dispatch_ms_sums_the_spans_mean_per_call():
    run = _run(_call(0, [(0.5, 1)] * 4), _call(1, [(3.0, 0), (1.0, 1)]))
    assert _read("cluster_dispatch_ms", run) == pytest.approx(3.0)


def test_graph_share_counts_replays_mean_per_call():
    run = _run(_call(0, [(0.5, 1)] * 4), _call(1, [(3.0, 0), (1.0, 1)]))
    assert _read("cluster_graph_share", run) == pytest.approx(0.75)
    assert _read("cluster_graph_share", _run(_call(0, [(3.0, 0)] * 3))) \
        == 0


def test_a_failed_call_is_left_out():
    failed = dict(_call(1, [(9.0, 0)]), error="Traceback")
    run = _run(_call(0, [(0.5, 1), (1.5, 1)]), failed)
    assert _read("cluster_dispatch_ms", run) == pytest.approx(2.0)
    assert _read("cluster_graph_share", run) == 1


@pytest.mark.parametrize("name", ["cluster_dispatch_ms",
                                  "cluster_graph_share"])
@pytest.mark.parametrize("run", [
    _run(_call(0, [(1.0, 1)] * 3, spanned=False)),   # a program before it
    _run(dict(t0=0.0, t1=1.0, error=None,
              stats=dict(trace=dict(id="1.0", spans=[])))),
    _run(dict(t0=0.0, t1=1.0, error=None, stats={})),   # untraced
    Run(records_per_call=10),                # no calls
], ids=["no_span", "no_spans", "no_trace", "no_calls"])
def test_without_the_span_gives_none(name, run):
    assert _read(name, run) is None
