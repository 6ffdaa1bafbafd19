"""The port's pipeline end to end against the JAX package's, on the CPU.

The fixtures of tests/test_engine_equivalence.py::test_engines_identical
and tests/test_e2e_alltypes.py go through the JAX ``run_pipeline``
(engine=device, decoder=python) and the port's ``run_pipeline`` with
``device="cpu"``; the VCFs may differ only in ##fileDate/##CommandLine.
"""
import os
import random
import subprocess
import sys

import pytest
import torch

from cutesv_tpu import pipeline as jpipe
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu_torch import cli as tcli
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch import sigstore as tsig
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.ops import cover
from tests import simdata
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_engines_fixture(tmp_path):
    """The corpus of test_engines_identical: messy coverage plus a DEL, an
    INS and a two-allele DEL locus with noisy breakpoints."""
    rng = random.Random(7)
    ref = simdata.make_reference(rng, {"chrA": 120_000})
    chrom = ref["chrA"]
    plans = []
    rid = 0
    for start in range(0, 117_000, 200):
        rid += 1
        q = "m%05d" % rid
        r = rng.random()
        if 17_000 <= start <= 19_600 and r < 0.8:
            jitter = rng.randrange(-20, 20)
            dlen = 100 + rng.randrange(-15, 15)
            plans.append(simdata.read_with_del(
                chrom, 0, start, 20_000 + jitter, dlen,
                3000 - (20_000 + jitter - start), q))
        elif 47_000 <= start <= 49_600 and r < 0.5:
            ilen = 80 + rng.randrange(-10, 10)
            plans.append(simdata.read_with_ins(
                chrom, 0, start, 50_000, simdata.random_seq(rng, ilen),
                3000 - (50_000 - start), q))
        elif 77_000 <= start <= 79_600 and r < 0.6:
            dlen = 400 + rng.randrange(-20, 20)
            plans.append(simdata.read_with_del(
                chrom, 0, start, 80_000, dlen, 3000 - (80_000 - start), q))
        else:
            plans.append(simdata.plain_read(chrom, 0, start, 3000, q))
    bam, fa = tmp_path / "m.bam", tmp_path / "m.fa"
    simdata.write_bam(str(bam), [("chrA", 120_000)], plans)
    simdata.write_ref_fasta(str(fa), ref)
    return bam, fa


FIXTURES = {"engines": build_engines_fixture, "alltypes": build_alltypes}


def _run_jax(bam, fa, out, wd):
    cfg = JConfig(input=str(bam), reference=str(fa), output=str(out),
                  work_dir=str(wd), genotype=True, min_support=3,
                  engine="device", decoder="python")
    jpipe.run_pipeline(cfg, ["x"])
    return _strip_volatile(out.read_text())


def _run_port(bam, fa, out, wd, engine="device"):
    cfg = TConfig(input=str(bam), reference=str(fa), output=str(out),
                  work_dir=str(wd), genotype=True, min_support=3,
                  engine=engine, decoder="python")
    tpipe.run_pipeline(cfg, ["x"], device="cpu")
    return _strip_volatile(out.read_text())


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_vcf_equals_jax(tmp_path, fixture):
    bam, fa = FIXTURES[fixture](tmp_path)
    want = _run_jax(bam, fa, tmp_path / "j.vcf", tmp_path / "wj")
    got = _run_port(bam, fa, tmp_path / "t.vcf", tmp_path / "wt")
    assert got == want
    body = [l for l in got.splitlines() if l and not l.startswith("#")]
    assert len(body) >= 2
    if fixture == "alltypes":
        kinds = {dict(kv.split("=", 1) for kv in l.split("\t")[7].split(";")
                      if "=" in kv)["SVTYPE"] for l in body}
        assert kinds == {"DEL", "DUP", "INV", "BND"}


def test_port_host_engine_equals_device_engine(tmp_path):
    bam, fa = build_alltypes(tmp_path)
    assert _run_port(bam, fa, tmp_path / "h.vcf", tmp_path / "wh",
                     engine="host") == \
        _run_port(bam, fa, tmp_path / "d.vcf", tmp_path / "wd")


def _store_state(store) -> dict:
    """A JAX-package store as plain dicts of arrays and tuples."""
    return dict(
        sigs={t: {c: list(rows) for c, rows in per.items()}
              for t, per in store.sigs.items()},
        census={c: {k: cen[k] for k in ("start", "end", "is_primary",
                                        "name")}
                for c, cen in store.census.items()},
        read_tables={c: dict(start=t.start, end=t.end, primary=t.prim,
                             name=t.names)
                     for c, t in store.read_tables.items()},
        chrom_lengths=dict(store.chrom_lengths), names=store.names)


def test_store_from_state_resolves_like_jax(tmp_path):
    bam, fa = build_alltypes(tmp_path)
    cfg = JConfig(input=str(bam), reference=str(fa), output="",
                  work_dir="", genotype=True, min_support=3,
                  engine="device", decoder="python")
    jstore, _, _, _ = jpipe.decode_bam(cfg)
    tstore = tsig.store_from_state(_store_state(jstore))
    assert isinstance(tstore, tsig.SigStore)
    tcfg = TConfig(input=str(bam), reference=str(fa), genotype=True,
                   min_support=3, engine="device", decoder="python")
    got = tpipe.resolve_all(tstore, tcfg, device="cpu")
    want = jpipe.resolve_all(jstore, cfg)
    assert got == want
    assert sum(len(v) for v in got.values()) >= 4


def test_cli_verify_recipe(tmp_path):
    """The repo's verification recipe through the port's CLI: one hom
    DEL (1/1) and one het INS (0/1)."""
    rng = random.Random(5)
    ref = simdata.make_reference(rng, {"chr1": 80_000})
    c1 = ref["chr1"]
    plans = []
    ins_seq = simdata.random_seq(rng, 70)
    for i, start in enumerate(range(0, 77_000, 250)):
        q = "rd%05d" % i
        if 27_350 <= start <= 29_800:
            plans.append(simdata.read_with_del(c1, 0, start, 30_000, 150,
                                               start + 3000 - 30_150, q))
        elif 57_000 <= start <= 59_000 and i % 2 == 0:
            plans.append(simdata.read_with_ins(c1, 0, start, 60_000, ins_seq,
                                               start + 3000 - 60_000, q))
        else:
            plans.append(simdata.plain_read(c1, 0, start, 3000, q))
    simdata.write_bam(str(tmp_path / "sim.bam"), [("chr1", 80_000)], plans)
    simdata.write_ref_fasta(str(tmp_path / "ref.fa"), ref)
    out = tmp_path / "out.vcf"
    assert tcli.main([str(tmp_path / "sim.bam"), str(tmp_path / "ref.fa"),
                      str(out), str(tmp_path / "wd"), "--genotype", "-s",
                      "3", "--decoder", "python", "--device", "cpu"]) == 0
    recs = [l.split("\t") for l in out.read_text().splitlines()
            if not l.startswith("#")]
    got = [(r[2], r[1], r[9].split(":")[0]) for r in recs]
    assert got == [("cuteSV.DEL.0", "30000", "1/1"),
                   ("cuteSV.INS.0", "60000", "0/1")]


def test_cpu_run_never_launches_the_kernel(tmp_path):
    bam, fa = build_engines_fixture(tmp_path)
    before = cover.LAUNCHES
    _run_port(bam, fa, tmp_path / "t.vcf", tmp_path / "wt")
    assert cover.LAUNCHES == before


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    bam, fa = build_engines_fixture(tmp_path)
    cfg = TConfig(input=str(bam), reference=str(fa),
                  output=str(tmp_path / "o.vcf"), work_dir=str(tmp_path),
                  genotype=True, min_support=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run_pipeline(cfg, ["x"])
    assert not (tmp_path / "o.vcf").exists()


@pytest.mark.parametrize("option,value,item", [
    ("decoder", "native", "item 6"),
    ("Ivcf", "calls.vcf", "item 14"),
    ("n_shards", 2, "item 11"),
    ("distributed", True, "item 12"),
    ("profile", True, "item 13"),
])
def test_unported_options_raise(tmp_path, option, value, item):
    bam, fa = build_engines_fixture(tmp_path)
    cfg = TConfig(input=str(bam), reference=str(fa),
                  output=str(tmp_path / "o.vcf"), work_dir=str(tmp_path),
                  **{option: value})
    with pytest.raises(NotImplementedError, match=item):
        tpipe.run_pipeline(cfg, ["x"], device="cpu")


def test_cram_input_raises(tmp_path):
    cram = tmp_path / "in.cram"
    cram.write_bytes(b"CRAM\x03\x00" + b"\x00" * 32)
    fa = tmp_path / "r.fa"
    fa.write_text(">c\nACGT\n")
    cfg = TConfig(input=str(cram), reference=str(fa),
                  output=str(tmp_path / "o.vcf"), work_dir="")
    with pytest.raises(NotImplementedError, match="item 15"):
        tpipe.run_pipeline(cfg, ["x"], device="cpu")


def test_port_imports_no_jax():
    """Importing every module of cutesv_tpu_torch pulls in neither jax
    nor the JAX package."""
    code = r"""
import importlib, pkgutil, sys
import cutesv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cutesv_tpu_torch.__path__,
                                               "cutesv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jaxlib" or k.startswith("jaxlib.")
             or k == "cutesv_tpu" or k.startswith("cutesv_tpu."))
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_import_no_jax():
    """No source of the port (nor chip_smoke.py) imports jax or the JAX
    package."""
    import re
    pat = re.compile(r"^\s*(import\s+(jax|cutesv_tpu)\b|from\s+(jax|"
                     r"cutesv_tpu)(\.|\s))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "cutesv_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

