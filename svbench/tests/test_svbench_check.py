"""The output check on the CPU, at a size a test run holds: a sound run
is correct; a run whose timed path is broken underneath is not (an
answer altered where it is produced; half of the sample's work left
out); and the control, the reference with its DR guarantee broken,
fails the check.
The harness's look for a card is skipped (the program runs with
``--device cpu``); everything else is a whole run."""
import pytest

from helpers import tiny_cell
from svbench import harness, registry, truth
from svbench.reference import caller

SEED = 2**31 + 4242


def _run(workload, trace=False):
    return harness.run_cell(tiny_cell(workload), SEED, 0.5, trace, "cpu",
                            log=lambda msg: None)


@pytest.mark.parametrize("workload", ["hifi.germline", "ont.germline"])
def test_a_sound_run_is_correct(workload):
    res = _run(workload, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["reference_records"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert {"decode_reads_per_s", "resolve_ms", "emit_ms"} <= set(
        res["metrics"])


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from cutesv_tpu_torch import vcf
    real = vcf.format_chrom_records

    def altered(*a, **k):
        out = real(*a, **k)
        if out:
            svtype, line = out[0]
            f = line.split("\t")
            f[9] = ("1/1" if f[9].startswith("0/1") else "0/1") + f[9][3:]
            out[0] = (svtype, "\t".join(f))
        return out

    monkeypatch.setattr(vcf, "format_chrom_records", altered)
    res = _run("hifi.germline")
    assert not res["correct"]
    assert res["checks"]["genotype_fields_differing"]["value"] > 0
    assert res["checks"]["truth_genotypes_off"]["value"] > 0


def test_half_of_the_work_left_out_fails(monkeypatch):
    from cutesv_tpu_torch import pipeline
    real = pipeline.resolve_all

    def half(*a, **k):
        return {c: rows[::2] for c, rows in real(*a, **k).items()}

    monkeypatch.setattr(pipeline, "resolve_all", half)
    res = _run("ont.germline")
    assert not res["correct"]
    assert res["checks"]["records_unmatched"]["value"] > 0
    assert res["checks"]["truth_sites_missed"]["value"] > 0


@pytest.mark.parametrize("workload", ["hifi.germline", "ont.germline"])
def test_the_control_fails_the_check(workload):
    cell = tiny_cell(workload)
    config = cell["config_data"]
    ref, sites = caller.reference(SEED, config, cell["traffic_data"], 2)
    broken = caller.reference_body(SEED, config, cell["traffic_data"], 2,
                                   control=True)
    d = harness.compare(broken, ref)
    assert d["body_differs"] and d["genotype_fields_differing"] > 0
    assert harness.compare(ref, ref) == dict(
        records_unmatched=0, genotype_fields_differing=0, body_differs=0)
    # the planted sites catch the fault even where both sides share it
    bias = truth.cluster_bias(caller.settings(config["argv"]).values)
    limits = dict.fromkeys(truth.NUMBERS, 0)
    limits.update(registry.limits(workload))
    sound = truth.check(ref, sites, bias)
    assert sites and all(v <= limits[k] for k, v in sound.items())
    off = truth.check(broken, sites, bias)
    # nearly every site's DR moves (the cell's limits are for its full size)
    for k in ("truth_counts_off", "truth_genotypes_off"):
        assert off[k] >= 0.9 * len(sites) and off[k] > sound[k]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_a_sound_run_on_the_card_is_correct(card):
    res = harness.run_cell(tiny_cell("ont.germline"), SEED, 1.0, True, card,
                           log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
