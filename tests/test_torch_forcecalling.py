"""The port's force calling (-Ivcf) against the JAX package's, on the CPU.

* ``force_call`` on a store returns the JAX package's rows, each package
  on the store its own decoder built (native: read identities are rank
  ints; python: read names), on the fixture of tests/test_forcecalling.py
  and on the all-types fixture.
* ``parse_vcf_records``, ``find_in_list``, ``find_in_indel_list`` and the
  bimodal split equal the JAX package's on seeded random inputs.
* The CLI's ``-Ivcf`` VCF equals ``cutesv_tpu.cli.main``'s over a BAM and
  over a CRAM, and ``--device cuda`` without a card raises.
All comparisons are exact.
"""
import random

import numpy as np
import pytest
import torch

import chip_smoke
from cutesv_tpu import cli as jcli
from cutesv_tpu import forcecalling as jfc
from cutesv_tpu import pipeline as jpipe
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu_torch import cli as tcli
from cutesv_tpu_torch import forcecalling as tfc
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.ops import cover
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile
from tests.test_forcecalling import _fixture as build_fc

FIXTURES = {"fc": build_fc, "alltypes": build_alltypes}


def _discovery(tmp_path, fixture):
    """The fixture's BAM and FASTA and the JAX package's discovery VCF of
    it (the -Ivcf input)."""
    bam, fa = FIXTURES[fixture](tmp_path)
    disc = tmp_path / "disc.vcf"
    jpipe.run_pipeline(JConfig(input=str(bam), reference=str(fa),
                               output=str(disc),
                               work_dir=str(tmp_path / "wd_disc"),
                               genotype=True, min_support=3), ["d"])
    return bam, fa, disc


@pytest.mark.parametrize("decoder", ["native", "python"])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_force_call_on_store_equals_jax(tmp_path, fixture, decoder):
    bam, fa, disc = _discovery(tmp_path, fixture)
    kw = dict(input=str(bam), reference=str(fa), Ivcf=str(disc),
              genotype=True, decoder=decoder)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jstore = jpipe.decode_bam(jcfg)[0]
    tstore = tpipe.decode_bam(tcfg, device="cpu")[0]
    assert tstore.decode_breakdown["decoder"] == decoder
    want = jfc.force_call(jcfg, ["f"], store=jstore)
    got = tfc.force_call(tcfg, ["f"], store=tstore)
    assert got["result"] == want["result"]
    assert got["references"] == want["references"]
    assert got["decoder"] == "store"
    n_in = sum(1 for l in disc.read_text().splitlines() if l[:1] != "#")
    assert sum(len(v) for v in got["result"].values()) == n_in >= 2


# ---------------------------------------------------------------------------
# the host pieces on seeded random inputs
# ---------------------------------------------------------------------------

def _random_vcf(rng, path, n=60):
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for k in range(n):
        chrom = rng.choice(["chr1", "chr2", "chrX"])
        pos = rng.randrange(1, 10 ** 6)
        kind = rng.choice(["DEL", "INS", "DUP", "INV", "BND", "TRA", "CNV"])
        info = ["SVTYPE=%s" % kind]
        ref, alt = "N", "<%s>" % kind
        svlen = rng.randrange(30, 5000)
        if kind == "BND":
            mate = "%s:%d" % (rng.choice(["chr2", "chr3"]),
                              rng.randrange(1, 10 ** 6))
            alt = rng.choice(["N[%s[", "]%s]N", "A[%s[", "]%s]T"]) % mate
        elif kind == "INS" and rng.random() < 0.5:
            alt = "A" + "".join(rng.choice("ACGT") for _ in range(svlen % 40))
            if rng.random() < 0.5:
                info.append("SEQ=" + alt)
                alt = "<INS>"
        elif kind == "DEL" and rng.random() < 0.3:
            info.append("SEQ=" + "".join(rng.choice("ACGT")
                                         for _ in range(10)))
        if rng.random() < 0.7 and kind not in ("BND",):
            info.append("SVLEN=%d" % (-svlen if kind == "DEL" else svlen))
        if rng.random() < 0.5:
            info.append("END=%d" % (pos + svlen))
        if rng.random() < 0.3:
            info.append("CHR2=chr%d" % rng.randrange(1, 4))
        if rng.random() < 0.3:
            info.append(rng.choice(["STRAND", "STRANDS"]) + "="
                        + rng.choice(["++", "--", "+-,-+"]))
        if rng.random() < 0.2:
            info.append("PRECISE")
        lines.append("\t".join([chrom, str(pos), "id%d" % k, ref, alt, ".",
                                "PASS", ";".join(info), "GT", "./."]))
    path.write_text("\n".join(lines) + "\n\n")


@pytest.mark.parametrize("seed", range(4))
def test_parse_vcf_records_equals_jax(tmp_path, seed):
    vcf = tmp_path / "in.vcf"
    _random_vcf(random.Random(seed), vcf)
    got = list(tfc.parse_vcf_records(str(vcf)))
    assert got == list(jfc.parse_vcf_records(str(vcf)))
    assert len(got) == 60


def _var_list(rng, n, with_seq):
    """Sorted signature rows [chrom, pos, len_or_end, read id(, seq)]
    around a few sites, read ids repeating so same-read merges happen."""
    sites = sorted(rng.randrange(0, 20_000) for _ in range(rng.randrange(1, 5)))
    rows = []
    for _ in range(n):
        site = rng.choice(sites)
        allele = rng.choice([200, 200, 320, 900])
        row = ["c", site + rng.randrange(-150, 150),
               allele + rng.randrange(-25, 25), "r%d" % rng.randrange(30)]
        if with_seq:
            row.append("<INS>")
        rows.append(row)
    rows.sort(key=lambda r: r[1])
    return rows, sites


@pytest.mark.parametrize("seed", range(4))
def test_find_in_list_equals_jax(seed):
    rng = random.Random(100 + seed)
    for _ in range(150):
        rows, sites = _var_list(rng, rng.randrange(0, 60), False)
        sv_type = rng.choice(["DUP", "INV", "TRA"])
        bias = rng.choice([50, 200, 500.0])
        pos = rng.choice(sites) + rng.randrange(-300, 300)
        end = rng.randrange(150, 950)
        assert tfc.find_in_list(sv_type, rows, bias, pos, end) == \
            jfc.find_in_list(sv_type, rows, bias, pos, end)


@pytest.mark.parametrize("seed", range(4))
def test_find_in_indel_list_equals_jax(seed):
    rng = random.Random(200 + seed)
    for _ in range(40):
        sv_type = rng.choice(["DEL", "INS"])
        rows, sites = _var_list(rng, rng.randrange(0, 80), sv_type == "INS")
        args = (sv_type, rows, rng.choice([100, 200, 1000]),
                rng.choice(sites) + rng.randrange(-200, 200),
                rng.choice([200, 320, 900, 520]), rng.choice([0.3, 0.5, 0.9]),
                rng.random() < 0.7)
        got = tfc.find_in_indel_list(*args)
        want = jfc.find_in_indel_list(*args)
        assert (sorted(got[0]),) + got[1:] == (sorted(want[0]),) + want[1:]


@pytest.mark.parametrize("seed", range(4))
def test_kmeans_split_equals_jax(seed):
    """The bimodal split, written out in numpy, labels as the JAX
    package's scikit-learn KMeans does: sorted allele lengths of 2-200
    signatures, one or two modes, ties and runs of equal values."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(40):
        n = int(rng.integers(2, 200))
        modes = rng.choice([80, 100, 150, 300, 1000], size=2)
        spread = int(rng.choice([0, 2, 10, 60]))
        pick = rng.random(n) < rng.random()
        data = np.where(pick, modes[0], modes[1]) + rng.integers(
            -spread, spread + 1, n)
        data = sorted(int(v) for v in data)
        if data[0] == data[-1]:
            continue
        np.testing.assert_array_equal(tfc._kmeans_split(data),
                                      jfc._kmeans_split(data))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_cli_ivcf_equals_jax(tmp_path, fixture):
    bam, fa, disc = _discovery(tmp_path, fixture)
    cram = tmp_path / "in.cram"
    chip_smoke.write_cram(str(bam), str(fa), str(cram), (3, 0),
                          max_slice=200)
    bodies = {}
    for name, inp in (("bam", bam), ("cram", cram)):
        argv = [str(inp), str(fa), None, None, "-Ivcf", str(disc),
                "--genotype", "--report_readid"]
        for pkg in ("jax", "port"):
            out = tmp_path / ("%s_%s.vcf" % (pkg, name))
            argv[2:4] = [str(out), str(tmp_path / ("wd_%s_%s" % (pkg, name)))]
            if pkg == "jax":
                assert jcli.main(list(argv)) == 0
            else:
                before = cover.LAUNCHES
                stats = tcli.run(argv + ["--device", "cpu"])
                assert cover.LAUNCHES == before
                assert stats["decoder"] == "native"
                assert stats["sites"] >= 2
                for key in ("decode_s", "call_s", "emit_s"):
                    assert stats[key] >= 0
            bodies[pkg, name] = _strip_volatile(out.read_text())
        assert bodies["port", name] == bodies["jax", name]
    assert bodies["port", "cram"] == bodies["port", "bam"]
    assert "RNAMES=" in bodies["port", "bam"]


def test_ivcf_distributed_equals_jax(tmp_path):
    """-Ivcf --distributed: as in the JAX package, each process makes the
    plain whole-file force call (no process group is joined), so process
    1 of 2 run alone writes the JAX CLI's body."""
    bam, fa, disc = _discovery(tmp_path, "fc")
    bodies = {}
    for pkg in ("jax", "port"):
        out = tmp_path / ("%s_fc.vcf" % pkg)
        argv = [str(bam), str(fa), str(out), str(tmp_path / ("wd_" + pkg)),
                "-Ivcf", str(disc), "--genotype", "--distributed",
                "--num_processes", "2", "--process_id", "1"]
        if pkg == "jax":
            assert jcli.main(argv) == 0
        else:
            stats = tcli.run(argv + ["--device", "cpu"])
            assert stats["decoder"] == "native" and stats["sites"] >= 2
            assert not torch.distributed.is_initialized()
        bodies[pkg] = _strip_volatile(out.read_text())
    assert bodies["port"] == bodies["jax"]


def test_cli_ivcf_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: --device cuda is valid")
    bam, fa = build_fc(tmp_path)
    disc = tmp_path / "disc.vcf"
    disc.write_text("##fileformat=VCFv4.2\n")
    out = tmp_path / "fc.vcf"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.run([str(bam), str(fa), str(out), str(tmp_path / "wd"),
                  "-Ivcf", str(disc), "--device", "cuda"])
    assert not out.exists()
