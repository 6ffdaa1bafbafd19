"""The tumour sample of the benchmark's ``hifi.complex`` cell (the
``hifi_skbr3`` configuration under the ``complex`` traffic) through the
port's CLI on the CPU, at a small size.

The cell is shrunk as ``svbench/tests/helpers.tiny_cell`` shrinks every
cell (three contigs of 247-311 kb, divisor 800) at 20x, and its traffic
by eight along the contig: sites every 12.5 kb from a 6.25 kb margin,
DUP and INV up to that margin long, so that each contig plants its
traffic's whole 20-kind period (DEL and INS, a DUP, an INV and a BND)
at least once. Every split carrier then has exactly ``-s`` (10) reads.

For each seed the port's VCF body equals the frozen copy's
(``svbench/reference/``) byte for byte; its DEL and INS records hold to
the planted indel sites (``svbench/truth.py``) and its DUP, INV and BND
records to the planted pair sites (``tests/pairsites.py``), which hold to
the generator's plan; the ``resolve.pair``, ``resolve.tra`` and
``genotype.flush`` counters sum to those records and their windows; and
a body with half of its pair records dropped fails the pair sites."""
import copy

import numpy as np
import pytest

from cutesv_tpu_torch import cli, pipeline
from svbench import corpus, harness, registry, truth
from svbench.reference import caller
from cutesv_tpu_torch.utils import trace
from svbench.tests.helpers import tiny_cell
from tests import pairsites

SEEDS = (2**31 + 1717, 2**32 + 171, 17)
PAIR = ("DUP", "INV", "BND")


def small_cell():
    """(config, traffic) of the small tumour sample."""
    cell = tiny_cell("hifi.complex", coverage=20)
    traffic = copy.deepcopy(cell["traffic_data"])
    sv = traffic["sv"]
    sv["spacing"] //= 8
    sv["margin"] //= 8
    for kind in ("DUP", "INV"):
        sv["len"][kind][1] = sv["margin"]
    return cell["config_data"], traffic


@pytest.fixture(scope="module", params=SEEDS)
def called(request, tmp_path_factory):
    """One seed's sample through ``cli.run`` on the CPU, with the frozen
    copy's body and both planted-site models."""
    seed = request.param
    tmp = tmp_path_factory.mktemp("complex")
    config, traffic = small_cell()
    bam, fa, vcf = (str(tmp / n) for n in ("sample.bam", "ref.fa",
                                           "calls.vcf"))
    corpus.write_corpus(seed, config, traffic, bam, fa, 1)
    stats = cli.run([bam, fa, vcf, str(tmp / "wd"), *config["argv"],
                     "--device", "cpu"])
    ref, indel_sites = caller.reference(seed, config, traffic, 1)
    return dict(seed=seed, config=config, traffic=traffic, stats=stats,
                body=harness.body_lines(vcf), ref=ref,
                indel_sites=indel_sites,
                pair_sites=pairsites.sites(seed, config, traffic))


def _types(body):
    return [line.split("SVTYPE=")[1].split(";")[0] for line in body]


def test_body_equals_the_frozen_copy(called):
    body = called["body"]
    assert body == called["ref"]
    assert set(PAIR) <= set(_types(body))
    bias = truth.cluster_bias(caller.settings(
        called["config"]["argv"]).values)
    assert called["indel_sites"]
    assert truth.check(body, called["indel_sites"], bias) == dict.fromkeys(
        truth.NUMBERS, 0)
    assert pairsites.check(body, called["pair_sites"]) == dict.fromkeys(
        pairsites.NUMBERS, 0)


def test_pair_sites_follow_the_plan(called):
    """One site per planted DUP and INV and per breakend pair of a
    planted BND, each tied to its planted SV and carried by its 10
    reads."""
    want = pairsites.planted_calls(called["seed"], called["config"],
                                   called["traffic"])
    sites = called["pair_sites"]
    got = {t: sum(s["svtype"] == t for s in sites) for t in PAIR}
    assert got == want and min(want.values()) >= 1
    assert all(s["planted"] is not None and s["re"] == 10 for s in sites)
    planted = [id(s["planted"]) for s in sites if s["svtype"] != "BND"]
    assert len(planted) == len(set(planted))


def test_counters_sum_to_the_records(called):
    stats, types = called["stats"], _types(called["body"])
    spans = stats["trace"]["spans"]
    pair, = [s["counters"] for s in spans if s["name"] == "resolve.pair"]
    tra = [s["counters"] for s in spans if s["name"] == "resolve.tra"]
    assert len(tra) == 2 and tra[1] == {}
    for t in ("DUP", "INV"):
        assert pair["records_" + t] == types.count(t)
        assert 0 < pair["clusters_" + t] <= pair["sigs_" + t] \
            <= stats["n_sigs"][t]
    assert tra[0]["records"] == types.count("BND")
    assert 0 < tra[0]["clusters"] <= tra[0]["sigs"] <= stats["n_sigs"]["TRA"]
    flush, = [s["counters"] for s in spans if s["name"] == "genotype.flush"]
    # three windows a DUP or INV (two breakpoints and their hull), at
    # most two a BND (its TRA windows may be counted on the host)
    assert flush["windows_pair"] == 3 * (types.count("DUP")
                                         + types.count("INV"))
    assert flush["windows_tra"] <= 2 * types.count("BND")
    assert flush["windows_pair"] + flush["windows_tra"] <= flush["windows"]
    # the benchmark's reader of these counters
    run = harness.Run(records_per_call=0,
                      calls=[dict(error=None, stats=stats)])
    assert registry.reader("pair_records")(run) == sum(
        types.count(t) for t in PAIR)


def test_half_of_the_pair_records_dropped_fails(called):
    body, pair = [], 0
    for line, t in zip(called["body"], _types(called["body"])):
        if t in PAIR:
            pair += 1
            if pair % 2:
                continue
        body.append(line)
    got = pairsites.check(body, called["pair_sites"])
    assert got["pair_sites_missed"] == (pair + 1) // 2
    assert got["pair_records_extra"] == 0


def test_a_flush_counts_the_tra_windows_it_carries():
    """TRA windows ride a flush where their block's reads are few beside
    them (the small sample's are counted on the host)."""
    got = []
    block = dict(windows=[(10, 20), (30, 40), (5, 70)],
                 starts=np.array([0, 5, 25]), ends=np.array([50, 60, 45]),
                 sink=got.append)
    with trace.recording() as rec:
        pipeline._batched_cover_multi([], None, extra_blocks=[block])
    flush, = [s["counters"] for s in rec.spans
              if s["name"] == "genotype.flush"]
    assert flush["windows_tra"] == flush["windows"] == 3
    assert flush["windows_pair"] == 0
    assert [c.tolist() for c in got] == [[2, 3, 0]]
