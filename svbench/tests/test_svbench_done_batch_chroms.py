"""done_batch_chroms reads the ``chroms`` counter of the program's
per-chromosome ``decode.dispatch`` spans: the chromosomes of the DONE
batch (``done`` = 1) per call, the mean over calls, 0 where every
chromosome was dispatched during the walk, and None where a program's
dispatch spans carry no such counter, as a program before it does."""
import pytest

from svbench import registry
from svbench.harness import Run


def _span(name, t0_ms, t1_ms, **counters):
    return dict(name=name, t0_ns=int(t0_ms * 1e6), t1_ns=int(t1_ms * 1e6),
                counters=counters)


def _call(k, n_walk, n_done, counted=True):
    """One call of ``n_walk`` chromosomes dispatched during the walk and
    ``n_done`` in the DONE batch, each with one compaction span, the DONE
    batch with its prefetch span; with or without the ``chroms``
    counter."""
    spans = [_span("decode", 0, 100), _span("decode.walk", 1, 60)]
    t = 2.0
    for i in range(n_walk + n_done):
        done = int(i >= n_walk)
        extra = dict(chroms=1) if counted else {}
        spans.append(_span("decode.dispatch", t, t + 1, done=done, **extra))
        if done and i == n_walk + n_done - 1:
            spans.append(_span("decode.dispatch", t + 1, t + 1.2, done=1))
        spans.append(_span("decode.dispatch", t + 1.2, t + 1.5, done=done))
        spans.append(_span("decode.tail", t + 1.5, t + 2, done=done,
                           windows=3))
        t += 2
    return dict(t0=float(k), t1=k + 1.0, error=None,
                stats=dict(trace=dict(id="1.%d" % k, spans=spans)))


def _run(*calls):
    run = Run(records_per_call=10)
    run.calls = list(calls)
    return run


def _read(run):
    return registry.reader("done_batch_chroms")(run)


def test_counts_the_done_batchs_chromosomes_mean_per_call():
    assert _read(_run(_call(0, 20, 4), _call(1, 22, 2))) == \
        pytest.approx(3.0)


def test_every_chromosome_dispatched_in_the_walk_reads_zero():
    assert _read(_run(_call(0, 24, 0))) == 0


def test_a_failed_call_is_left_out():
    failed = dict(_call(1, 0, 24), error="Traceback")
    assert _read(_run(_call(0, 23, 1), failed)) == 1


@pytest.mark.parametrize("run", [
    _run(_call(0, 20, 4, counted=False)),    # a program before the counter
    _run(dict(t0=0.0, t1=1.0, error=None,
              stats=dict(trace=dict(id="1.0", spans=[])))),
    _run(dict(t0=0.0, t1=1.0, error=None, stats={})),   # untraced
    Run(records_per_call=10),                # no calls
], ids=["no_counter", "no_spans", "no_trace", "no_calls"])
def test_without_the_counter_gives_none(run):
    assert _read(run) is None
