"""inflate_card_share reads the share of BGZF blocks that the card
inflated from the ``decode.walk`` span's counters, the mean per call, and
nothing where the spans carry no such counters."""
import pytest

from svbench import registry
from svbench.harness import Run


def _walk(**counters):
    return dict(name="decode.walk", t0_ns=1, t1_ns=2,
                counters=dict(records=10, inflate_core_s=0.0,
                              records_core_s=0.0, **counters))


def _run(*walks):
    run = Run(records_per_call=10)
    run.calls = [dict(t0=float(i), t1=i + 1.0, error=None,
                      stats=dict(trace=dict(id="1.%d" % i, spans=[w])))
                 for i, w in enumerate(walks)]
    return run


def _read(run):
    return registry.reader("inflate_card_share")(run)


def test_share_is_the_mean_per_call():
    run = _run(_walk(blocks_card=90, blocks_host=10),
               _walk(blocks_card=40, blocks_host=0))
    assert _read(run) == pytest.approx((0.9 + 1.0) / 2)


def test_host_only_reads_zero():
    assert _read(_run(_walk(blocks_card=0, blocks_host=79))) == 0.0


@pytest.mark.parametrize("run", [
    _run(_walk()),                    # a program without the counters
    _run(_walk(blocks_card=0, blocks_host=0)),
    Run(records_per_call=10),         # no calls
], ids=["no_counters", "no_blocks", "no_calls"])
def test_nothing_to_read_gives_none(run):
    assert _read(run) is None


def test_failed_call_and_untraced_call_are_left_out():
    run = _run(_walk(blocks_card=5, blocks_host=5),
               _walk(blocks_card=10, blocks_host=0))
    run.calls[1]["error"] = "boom"
    run.calls.append(dict(t0=9.0, t1=10.0, error=None, stats={}))
    assert _read(run) == pytest.approx(0.5)
