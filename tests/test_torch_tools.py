"""The port's post-processing, evaluation and comparison tools, its
command runner and its replay driver against the JAX package's, on the
CPU: the same inputs (made from a seed inside each test) through both,
and equal outputs — files byte for byte, logged tables record for
record, ``replay_eval``'s ``summary.json`` and printed table."""
import json
import logging
import os
import re
import stat

import numpy as np
import pytest

import chip_smoke
from cutesv_tpu.tools import compare as jcompare
from cutesv_tpu.tools import diploid_calling as jdiploid
from cutesv_tpu.tools import eval_forcecalling as jfc
from cutesv_tpu.tools import eval_sim as jeval
from cutesv_tpu.tools import replay_eval as jreplay
from cutesv_tpu.tools import vcf2bedpe as jbedpe
from cutesv_tpu.tools import vcfio as jvcfio
from cutesv_tpu.utils import command as jcommand
from cutesv_tpu_torch.tools import compare as tcompare
from cutesv_tpu_torch.tools import diploid_calling as tdiploid
from cutesv_tpu_torch.tools import eval_forcecalling as tfc
from cutesv_tpu_torch.tools import eval_sim as teval
from cutesv_tpu_torch.tools import replay_eval as treplay
from cutesv_tpu_torch.tools import vcf2bedpe as tbedpe
from cutesv_tpu_torch.tools import vcfio as tvcfio
from cutesv_tpu_torch.utils import command as tcommand

HEADER = ("##fileformat=VCFv4.2\n"
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
GTS = ("0/1", "1/1", "1/0", "0/0", "./.")
KINDS = ("deletion", "insertion", "inversion", "tandem duplication",
         "reciprocal translocation")
TYPE_OF = {"deletion": "DEL", "insertion": "INS", "inversion": "INV",
           "tandem duplication": "DUP"}


def _bnd_alt(rng, chr2: str, pos2: int) -> str:
    return ("N[%s:%d[", "N]%s:%d]", "[%s:%d[N", "]%s:%d]N")[
        int(rng.integers(0, 4))] % (chr2, pos2)


def _record(rng, k: int, chrom: str, pos: int, svtype: str, svlen: int,
            chr2: str = "", pos2: int = 0) -> str:
    """One cuteSV-style VCF record with GT:DR:DV, haplotype-tagged read
    names, and (for some records) INFO fields left out."""
    gt = GTS[int(rng.integers(0, len(GTS)))]
    sample = "%s:%d:%d" % (gt, rng.integers(0, 12), rng.integers(0, 12))
    rnames = ",".join("cutesvh%d_r%d" % (rng.integers(1, 3), j)
                      for j in range(int(rng.integers(1, 4))))
    re_ = int(rng.integers(1, 30))
    if svtype in ("BND", "TRA"):
        alt = _bnd_alt(rng, chr2, pos2)
        info = "SVTYPE=%s;RE=%d;RNAMES=%s" % (svtype, re_, rnames)
        if rng.random() < 0.5:
            info = "SVTYPE=%s;CHR2=%s;END=%d;RE=%d;RNAMES=%s" % (
                svtype, chr2, pos2, re_, rnames)
    else:
        alt = "<%s>" % svtype
        sign = -1 if svtype == "DEL" else 1
        end = pos + (1 if svtype == "INS" else svlen)
        info = "SVTYPE=%s;SVLEN=%d;END=%d;RE=%d;RNAMES=%s" % (
            svtype, sign * svlen, end, re_, rnames)
        drop = rng.random()
        if drop < 0.08:
            info = info.replace(";END=%d" % end, "")
        elif drop < 0.16:
            info = info.replace("SVLEN=%d;" % (sign * svlen), "")
    filt = ("PASS", ".", "q5")[int(rng.integers(0, 3))]
    return "%s\t%d\tcuteSV.%s.%d\tN\t%s\t%.1f\t%s\t%s\tGT:DR:DV\t%s\n" % (
        chrom, pos, svtype, k, alt, rng.random() * 60, filt, info, sample)


def _truth(rng, n: int = 40):
    """VISOR HACk truth rows [(chrom, start, end, kind, info)] on
    chromosomes 1 and 2, every kind in turn."""
    rows = []
    for k in range(n):
        kind = KINDS[k % len(KINDS)]
        chrom = "12"[k % 2]
        start = 50_000 + 30_000 * k + int(rng.integers(0, 5_000))
        if kind == "insertion":
            ln = int(rng.integers(60, 900))
            rows.append((chrom, start, start + 1, kind,
                         "".join("ACGT"[i] for i in rng.integers(0, 4, ln))))
        elif kind == "reciprocal translocation":
            rows.append((chrom, start, start + int(rng.integers(2_000, 5_000)),
                         kind, "h1:%s:%d:%s:%s" % (
                             "21"[k % 2], int(rng.integers(10_000, 900_000)),
                             ("forward", "reverse")[int(rng.integers(0, 2))],
                             ("forward", "reverse")[int(rng.integers(0, 2))])))
        else:
            info = "2" if kind == "tandem duplication" else "None"
            rows.append((chrom, start, start + int(rng.integers(80, 6_000)),
                         kind, info))
    return rows


def _calls_near(rng, truth, k0: int = 0) -> list:
    """A callset made from the truth rows with jittered positions and
    sizes (some far off), plus a few unmatched calls."""
    out = []
    for k, (chrom, s, e, kind, info) in enumerate(truth):
        if rng.random() < 0.15:
            continue
        jit = int(rng.integers(-300, 300)) * (1 if rng.random() < 0.8
                                              else 10)
        if kind == "reciprocal translocation":
            _, chr2, s2, _, _ = info.split(":")
            out.append(_record(rng, k0 + k, chrom, s + jit, "BND", 0, chr2,
                               int(s2) + int(rng.integers(-400, 400))))
            continue
        size = len(info) if kind == "insertion" else e - s
        size = max(30, int(size * rng.uniform(0.6, 1.3)))
        out.append(_record(rng, k0 + k, chrom, s + jit, TYPE_OF[kind], size))
    for j in range(5):
        out.append(_record(rng, k0 + 900 + j, "12"[j % 2],
                           int(rng.integers(1, 2_000_000)),
                           ("DEL", "INS", "DUP", "INV", "TRA")[j], 120, "2",
                           5_000))
    return out


def _write_truth(tmp_path, seed: int):
    """(truth bed, zygosity bed, truth rows) from ``seed``."""
    rng = np.random.default_rng(seed)
    truth = _truth(rng)
    bed = tmp_path / ("truth%d.bed" % seed)
    bed.write_text("".join("%s\t%d\t%d\t%s\t%s\t0\n" % r for r in truth))
    gt = tmp_path / ("zyg%d.bed" % seed)
    gt.write_text("1\t0\t3000000\th1\t100.0\n2\t0\t3000000\th1\t55.0\n")
    return str(bed), str(gt), truth


def _write_vcf(path, rows) -> str:
    path.write_text(HEADER + "".join(rows))
    return str(path)


def _logged(caplog, fn, argv) -> list:
    """The messages ``fn(argv)`` logs at INFO and above, without the
    wall-time line."""
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert fn(argv) == 0
    return [r.getMessage() for r in caplog.records
            if not r.getMessage().startswith("Finished in")]


def _bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def test_vcfio_reads_like_jax(tmp_path):
    rng = np.random.default_rng(1)
    path = _write_vcf(tmp_path / "in.vcf",
                      _calls_near(rng, _truth(rng)) + ["\n"])
    got, want = list(tvcfio.read_vcf(path)), list(jvcfio.read_vcf(path))
    assert len(got) == len(want) > 30
    for a, b in zip(got, want):
        assert vars(a) == vars(b)
        assert a.info_int("SVLEN", -7) == b.info_int("SVLEN", -7)
    assert tvcfio.read_vcf_header(path) == jvcfio.read_vcf_header(path)


@pytest.mark.parametrize("tool", ["diploid_calling", "vcf2bedpe"])
@pytest.mark.parametrize("seed", [2, 3])
def test_converter_writes_jax_bytes(tmp_path, tool, seed):
    rng = np.random.default_rng(seed)
    path = _write_vcf(tmp_path / "in.vcf", _calls_near(rng, _truth(rng)))
    port, jax_ = {"diploid_calling": (tdiploid, jdiploid),
                  "vcf2bedpe": (tbedpe, jbedpe)}[tool]
    got, want = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert port.main([path, got]) == 0
    assert jax_.main([path, want]) == 0
    assert _bytes(got) == _bytes(want)
    assert len(_bytes(got).splitlines()) > 30


@pytest.mark.parametrize("mode", ["IID", "DUP", "BND"])
def test_eval_sim_logs_jax_records(tmp_path, caplog, mode):
    bed, gt, truth = _write_truth(tmp_path, 5)
    rng = np.random.default_rng(6)
    calls = [_write_vcf(tmp_path / ("c%d.vcf" % k),
                        _calls_near(rng, truth, 100 * k)) for k in range(2)]
    argv = [mode, bed, gt] + calls + ["-o", "800"]
    got = _logged(caplog, teval.main, argv)
    want = _logged(caplog, jeval.main, argv)
    assert got == want
    assert any(m.startswith("TP-2 of") for m in got)


def test_eval_sim_five_callsets_equal_jax(tmp_path, caplog):
    """More than 4 callsets: the match slots grow with the count, and the
    port's answer rows, scores and logged tables stay JAX's."""
    bed, gt, truth = _write_truth(tmp_path, 7)
    rng = np.random.default_rng(8)
    calls = [_write_vcf(tmp_path / ("c%d.vcf" % k),
                        _calls_near(rng, truth, 100 * k)) for k in range(5)]
    got = _logged(caplog, teval.main, ["IID", bed, gt] + calls)
    want = _logged(caplog, jeval.main, ["IID", bed, gt] + calls)
    assert got == want and len(got) > 5 * 6
    for n_slots in (4, 5):
        assert teval.load_ans(bed, n_slots) == jeval.load_ans(bed, n_slots)
    ta, ja = teval.load_ans(bed, 5), jeval.load_ans(bed, 5)
    genotype = teval.load_gt(gt)
    assert genotype == jeval.load_gt(gt)
    for opt, path in enumerate(calls, start=1):
        tc, tab = teval.load_callset(path, teval.MODES["IID"])
        jc, jab = jeval.load_callset(path, jeval.MODES["IID"])
        assert (tc, tab) == (jc, jab)
        teval.evaluate(tc, ta, 0.7, 1000, opt, genotype)
        jeval.evaluate(jc, ja, 0.7, 1000, opt, genotype)
        for res in (1, 2):
            assert (teval.statistics(tc, ta, opt, res)
                    == jeval.statistics(jc, ja, opt, res))
    assert ta == ja


def _pop_vcf(path, rng, n_samples: int) -> str:
    """A merged population VCF: AF/HWE/ExcHet in varying INFO order, bare
    '.' samples, short and missing GTs, small SVs and BNDs."""
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
            "\tINFO\tFORMAT\t" + "\t".join("S%d" % i
                                           for i in range(n_samples)) + "\n")
    rows = []
    for k in range(40):
        svtype = ("DEL", "INS", "DUP", "BND", "INV")[k % 5]
        svlen = int(rng.integers(20, 5_000)) * (-1 if svtype == "DEL" else 1)
        tail = ["AF=%.4f" % rng.random(), "HWE=%.3g" % rng.random() ** 8,
                "ExcHet=%.3g" % rng.random() ** 8]
        rng.shuffle(tail)
        info = ";".join(["SVTYPE=%s" % svtype, "SVLEN=%d" % svlen] + tail)
        if k % 3 == 0:
            info += ";AN=%d" % (2 * n_samples)
        samples = [("0/1", "1/1", "./.", ".", "0/0", "./1")[
            int(rng.integers(0, 6))] for _ in range(n_samples)]
        rows.append("%s\t%d\tv%d\tN\t<%s>\t.\tPASS\t%s\tGT\t%s\n" % (
            "12"[k % 2], 1_000 + 997 * k, k, svtype, info,
            "\t".join(samples)))
    path.write_text(head + "".join(rows))
    return str(path)


@pytest.mark.parametrize("handle", ["POP", "COMP", "CMRG"])
def test_eval_forcecalling_writes_jax_bytes(tmp_path, handle):
    rng = np.random.default_rng(9)
    if handle == "CMRG":
        vin = tmp_path / "cmrg.vcf"
        vin.write_text(HEADER + "".join(
            "1\t%d\t.\t%s\t%s\t.\tPASS\t.\tGT\t0/1\n" % (
                100 + 50 * k, "A" * int(rng.integers(1, 80)),
                "A" * int(rng.integers(1, 80))) for k in range(30)))
        extra = []
    else:
        vin = _pop_vcf(tmp_path / "pop.vcf", rng, 7)
        extra = ["--base_vcf", _pop_vcf(tmp_path / "base.vcf", rng, 3)]
    argv = [handle, "--input", str(vin)] + extra
    assert tfc.main(argv + ["--output", str(tmp_path / "port.tsv")]) == 0
    assert jfc.main(argv + ["--output", str(tmp_path / "jax.tsv")]) == 0
    got = _bytes(tmp_path / "port.tsv")
    assert got == _bytes(tmp_path / "jax.tsv") and got


def test_population_statistic_equals_jax(tmp_path):
    """The robust-input case (ExcHet mid-INFO, a bare '.', fewer samples
    than the default 100) and a sample cap below the sample count."""
    rng = np.random.default_rng(10)
    path = _pop_vcf(tmp_path / "pop.vcf", rng, 5)
    for n in (100, 3):
        tfc.population_statistic(path, str(tmp_path / "p.tsv"), n)
        jfc.population_statistic(path, str(tmp_path / "j.tsv"), n)
        assert _bytes(tmp_path / "p.tsv") == _bytes(tmp_path / "j.tsv")


def _compare_inputs(tmp_path, seed: int, n: int) -> list:
    bed, _, truth = _write_truth(tmp_path, seed)
    rng = np.random.default_rng(seed + 1)
    return [_write_vcf(tmp_path / ("v%d.vcf" % k),
                       _calls_near(rng, truth, 100 * k)) for k in range(n)]


@pytest.mark.parametrize("cli,n,flavors", [
    ("eval_bnd", 2, None),
    ("eval_trio", 3, None),
    ("concordance", 3, None),
    ("cmp_base", 3, None),
    ("cmp_na19240", 5, ["cutesv", "sniffles", "pbsv", "svim"]),
])
def test_compare_cli_logs_jax_records(tmp_path, caplog, cli, n, flavors):
    paths = _compare_inputs(tmp_path, 11, n)
    if flavors:
        paths = paths[:1] + ["%s:%s" % (f, p)
                             for f, p in zip(flavors, paths[1:])]
    got = _logged(caplog, getattr(tcompare, cli), paths + ["-o", "900"])
    want = _logged(caplog, getattr(jcompare, cli), paths + ["-o", "900"])
    assert got == want and got


def test_compare_load_and_match_equal_jax(tmp_path):
    a, b = _compare_inputs(tmp_path, 12, 2)
    for kw in ({}, {"bnd_numeric_swap": True}, {"min_bnd_dv": 4}):
        ta, tb = tcompare.load_callset(a, **kw), tcompare.load_callset(b, **kw)
        ja, jb = jcompare.load_callset(a, **kw), jcompare.load_callset(b, **kw)
        assert (ta, tb) == (ja, jb)
        tcompare.match(ta, tb, 0.7, 1000, "B", "A", gt_filter_b=["hom"])
        jcompare.match(ja, jb, 0.7, 1000, "B", "A", gt_filter_b=["hom"])
        assert (ta, tb) == (ja, jb)


# the cases of tests/test_command.py, each run through both modules; a
# case returns what it observed
def _exe_interleaved(m, tmp_path):
    return m.exe("echo to-stdout; echo to-stderr 1>&2")


def _exe_retcode(m, tmp_path):
    return m.exe("exit 3")[0]


def _exe_timeout(m, tmp_path):
    return m.exe("sleep 30", timeout=1 / 60.0)


def _partition(m, tmp_path):
    return [m.partition([1, 2, 3, 4, 5], 2), m.partition([1], 3),
            m.partition([], 2)]


def _runner_local(m, tmp_path):
    runner = m.CommandRunner()
    ret = runner(m.Command("echo hi", "j1", str(tmp_path / "o.txt"),
                           str(tmp_path / "e.txt")))
    return runner.run_type, ret, (tmp_path / "o.txt").read_text()


def _runner_list(m, tmp_path):
    rets = m.CommandRunner()([
        m.Command("echo %d" % i, "j%d" % i, str(tmp_path / ("o%d" % i)),
                  str(tmp_path / ("e%d" % i))) for i in range(3)])
    return rets, (tmp_path / "o2").read_text()


def _runner_chunks(m, tmp_path):
    marker = tmp_path / "ran.txt"
    runner = m.CommandRunner(njobs=2)
    runner.run_type = "Running"
    rets = runner([m.Command("echo c%d >> %s" % (i, marker), "j%d" % i, "",
                             "") for i in range(4)],
                  w_dir=str(tmp_path), id=str(tmp_path / "batch"))
    scripts = [(tmp_path / ("batch_chunk%d.sh" % c)).read_text()
               for c in (0, 1)]
    modes = [bool(os.stat(tmp_path / ("batch_chunk%d.sh" % c)).st_mode
                  & stat.S_IXUSR) for c in (0, 1)]
    return rets, [s.replace(str(tmp_path), "") for s in scripts], modes, \
        sorted(marker.read_text().split())


def _runner_template(m, tmp_path):
    log = tmp_path / "submits.txt"
    runner = m.CommandRunner("echo SUBMIT ${JOBNAME} ${CMD} >> %s" % log,
                             njobs=0)
    rets = runner([m.Command("work-a", "jobA", "oa", "ea"),
                   m.Command("work-b", "jobB", "ob", "eb")])
    return runner.run_type, rets, log.read_text()


def _check_template(m, tmp_path):
    return [m.CommandRunner("${CMD} > ${STDOUT}").check_template(),
            m.CommandRunner("${CMD} ${NOSUCHKEY}").check_template()]


@pytest.mark.parametrize("case", [
    _exe_interleaved, _exe_retcode, _exe_timeout, _partition, _runner_local,
    _runner_list, _runner_chunks, _runner_template, _check_template,
], ids=lambda f: f.__name__.lstrip("_"))
def test_command_case_equals_jax(tmp_path, case):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = case(tcommand, tmp_path / "t")
    want = case(jcommand, tmp_path / "j")
    assert got == want
    if case is _exe_timeout:
        assert got == (214, None, None)


def _replay(main, bed, out, extra, capsys) -> tuple:
    assert main(chip_smoke.replay_eval_argv(bed, out, "cpu")[:-2]
                + extra) == 0
    printed = re.sub(r"elapsed=[0-9.]+s", "elapsed=", capsys.readouterr().out)
    with open(os.path.join(out, "summary.json")) as fh:
        return json.load(fh), printed


def test_replay_eval_equals_jax(tmp_path, capsys):
    """The driver over chip_smoke.py's 12-row DEL/INS bed (the JAX
    package's driver smoke bed): the port on the CPU gives JAX's
    summary.json and printed table (wall time aside), every row found at
    presence and genotype level."""
    bed = str(tmp_path / "sim_mix.bed.gz")
    chip_smoke.write_replay_bed(bed)
    got = _replay(treplay.main, bed, str(tmp_path / "t"),
                  ["--device", "cpu"], capsys)
    want = _replay(jreplay.main, bed, str(tmp_path / "j"), [], capsys)
    assert got == want
    for ty in ("DEL", "INS"):
        assert got[0][ty] == dict(rows=6, presence=6, genotype=6)
    assert got[0]["_meta"]["windows"] == 1
    assert "force-calling GT concordance" in got[1]


def test_replay_eval_messy_equals_jax(tmp_path, capsys):
    """--messy: the stress corpus generated, called, scored and
    force-called by both drivers; the same table and the same VCF body."""
    argv = ["--messy", "1.0", "--seed", "2", "--force_call"]
    bodies, printed = [], []
    for main, out, extra in ((treplay.main, "t", ["--device", "cpu"]),
                             (jreplay.main, "j", [])):
        assert main(argv + ["--out", str(tmp_path / out)] + extra) == 0
        printed.append(capsys.readouterr().out)
        with open(tmp_path / out / "messy.vcf") as fh:
            bodies.append([l for l in fh.read().splitlines() if not
                           l.startswith(("##fileDate", "##CommandLine"))])
    assert printed[0] == printed[1]
    assert bodies[0] == bodies[1]
    assert "force-calling GT concordance" in printed[0]
    assert sum(1 for l in bodies[0] if not l.startswith("#")) > 10
