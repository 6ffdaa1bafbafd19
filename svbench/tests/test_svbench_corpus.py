"""The corpus generator: the same bytes for the same seed, whatever the
number of processes; other bytes for another seed; records equal to the
port's own BAM writer's."""
import io
import zlib

import numpy as np
import pytest

from helpers import load, tiny_cell
from svbench import corpus


def _write(tmp_path, cell, seed, workers, tag):
    bam, fa = tmp_path / ("%s.bam" % tag), tmp_path / ("%s.fa" % tag)
    info = corpus.write_corpus(seed, cell["config_data"],
                               cell["traffic_data"], str(bam), str(fa),
                               workers)
    return bam.read_bytes(), fa.read_bytes(), info


@pytest.mark.parametrize("workload", ["hifi.germline", "ont.germline"])
def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path, workload):
    cell = tiny_cell(workload, coverage=6)
    seed = 2**31 + 12345
    a = _write(tmp_path, cell, seed, 1, "a")
    b = _write(tmp_path, cell, seed, 2, "b")
    c = _write(tmp_path, cell, seed + 1, 1, "c")
    assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
    assert a[0] != c[0] and a[1] != c[1]
    assert a[0].endswith(corpus.BGZF_EOF)


def _inflate(blob: bytes) -> bytes:
    out, k = [], 0
    while k < len(blob):
        bsize = int.from_bytes(blob[k + 16:k + 18], "little") + 1
        out.append(zlib.decompress(blob[k + 18:k + bsize - 8], wbits=-15))
        k += bsize
    return b"".join(out)


# every kind the generator plants: DUP, INV and BND as split carriers
ALL_KINDS = {"name": "all_kinds", "sv": {
    "spacing": 20000, "margin": 50000,
    "kinds": ["DEL", "INS", "DUP", "INV", "BND"],
    "len": {"DEL": [100, 3000, "uniform"], "INS": [100, 1500, "uniform"],
            "DUP": [1000, 5000, "uniform"], "INV": [1000, 5000, "uniform"],
            "BND": [2000, 5000, "uniform"]},
    "hom_fraction": 0.0}}


def _traffic(name):
    return ALL_KINDS if name == "all_kinds" else load("traffic", name)


@pytest.mark.parametrize("config,traffic", [("hifi_hg002", "germline"),
                                            ("ont_hg002", "germline"),
                                            ("hifi_hg002", "all_kinds")])
def test_records_equal_the_port_writer(config, traffic):
    from cutesv_tpu_torch.io import bam as pbam
    cfg = load("configs", config)
    cfg["genome"].update(contigs=["chr1", "chr2", "chr3"],
                         source_mb=[249, 242, 198], divisor=800)
    cfg["reads"]["coverage"] = 6
    plan, ref, _ = corpus.contig_plan(77, 1, cfg, _traffic(traffic))
    assert bool(plan.sa) == (config == "ont_hg002" or traffic == "all_kinds")
    contigs = [("chr1", 10), ("chr2", len(ref)), ("chr3", 10)]
    mine = corpus.encode_records(plan, ref, 1, 0, len(plan))
    out = io.BytesIO()
    w = pbam.BamWriter(out, contigs)
    for r in range(len(plan)):
        seq = corpus.codes_to_bytes(plan.query(r, ref)).decode()
        w.write(plan.names[r], int(plan.flag[r]), 1, int(plan.pos[r]),
                int(plan.mapq[r]), plan.cigar(r), seq,
                {"SA": plan.sa[r]} if r in plan.sa else None)
    w.close()
    theirs = _inflate(out.getvalue())
    head = len(corpus.bam_header(contigs))
    assert theirs[head:] == mine
    assert _inflate(corpus.bgzf(mine)) == mine


def test_plan_is_sorted_and_consistent():
    cell = tiny_cell("ont.germline", coverage=6)
    plan, ref, svs = corpus.contig_plan(5, 0, cell["config_data"], ALL_KINDS)
    assert np.all(np.diff(plan.pos) >= 0)
    assert {sv["kind"] for sv in svs} == {"DEL", "INS", "DUP", "INV",
                                          "BND"}
    m = plan.ops == corpus.OP_M
    assert np.all(plan.lens[m] > 0)
    assert np.all(plan.src[m] + plan.lens[m] <= len(ref))
