"""The port's pooled baseline (``cutesv_tpu_torch/tools/baseline_pool.py``)
against the JAX package's and against the port's own host engine, on the
CPU: the chromosome index, its cache, the pooled VCF body at 1-3 worker
processes (byte for byte apart from ``##fileDate``), the mid-block
virtual offset, and the refusal of a device engine on a CUDA device
before any worker forks."""
import re

import pytest

from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.tools import baseline_pool as jpool
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.pipeline import run_pipeline
from cutesv_tpu_torch.tools import baseline_pool as tpool
from tests.test_e2e_alltypes import _build


def _strip_file_date(text: str) -> str:
    return re.sub(r"^##fileDate[^\n]*\n", "", text, count=1,
                  flags=re.MULTILINE)


def _cfg(config, bam, fa, out, wd, engine="host"):
    return config(input=str(bam), reference=str(fa), output=str(out),
                  work_dir=str(wd), genotype=True, min_support=3,
                  engine=engine, decoder="python")


def _fields(rec) -> tuple:
    return (rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            rec.reference_end)


def test_chrom_index_equals_jax(tmp_path):
    bam, _ = _build(tmp_path)
    got = tpool.build_chrom_index(str(bam), cache=False)
    assert got == jpool.build_chrom_index(str(bam), cache=False)
    assert [c for c, _ in got["chroms"]] == ["chr1", "chr2"]
    assert set(got["voffs"]) == {"0", "1"}
    for cid_s, (coff, uoff) in got["voffs"].items():
        recs = list(tpool._iter_from(str(bam), coff, uoff))
        assert recs[0].ref_id == int(cid_s)
        assert recs[0].pos == min(r.pos for r in recs
                                  if r.ref_id == int(cid_s))


def test_index_cache_roundtrip(tmp_path):
    bam, _ = _build(tmp_path)
    fresh = tpool.build_chrom_index(str(bam))
    assert (tmp_path / "all.bam.pooledidx.json").exists()
    assert tpool.build_chrom_index(str(bam)) == fresh
    # the JAX package reads the port's cache file and the other way round
    assert jpool.build_chrom_index(str(bam)) == fresh


@pytest.mark.parametrize("n_procs", [1, 2, 3])
def test_pooled_body_equals_host_engine_and_jax(tmp_path, n_procs):
    bam, fa = _build(tmp_path)
    host = tmp_path / "host.vcf"
    run_pipeline(_cfg(TConfig, bam, fa, host, tmp_path / "wdh"), ["argv"],
                 device="cpu")
    want = _strip_file_date(host.read_text())
    assert "SVTYPE=" in want
    out, jout = tmp_path / "pool.vcf", tmp_path / "jpool.vcf"
    stats = tpool.run_pool_baseline(
        _cfg(TConfig, bam, fa, out, tmp_path / "wdp"), ["argv"],
        n_procs=n_procs, device="cpu")
    jstats = jpool.run_pool_baseline(
        _cfg(JConfig, bam, fa, jout, tmp_path / "wdj"), ["argv"],
        n_procs=n_procs)
    assert _strip_file_date(out.read_text()) == want
    assert _strip_file_date(jout.read_text()) == want
    for k in ("n_records", "n_calls", "n_sigs"):
        assert stats[k] == jstats[k]
    assert stats["n_calls"] > 0


def test_iter_from_mid_block_offset_equals_jax(tmp_path):
    """A virtual offset inside a block decodes from the record boundary,
    as a clean record chain to EOF, record for record JAX's."""
    bam, _ = _build(tmp_path)
    coff, uoff = tpool.build_chrom_index(str(bam), cache=False)["voffs"]["1"]
    got = [_fields(r) for r in tpool._iter_from(str(bam), coff, uoff)]
    want = [_fields(r) for r in jpool._iter_from(str(bam), coff, uoff)]
    assert got == want
    assert got and got[0][2] == 1


@pytest.mark.parametrize("engine", ["device", "auto"])
def test_device_engine_on_cuda_raises_before_any_fork(tmp_path, monkeypatch,
                                                      engine):
    """A forked worker cannot use CUDA: a non-host engine on a CUDA device
    is refused in the parent, before the index is built or a pool
    forks."""
    bam, fa = _build(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)

    def forbidden(*a, **k):
        raise AssertionError("reached past the device check")

    monkeypatch.setattr(tpool, "Pool", forbidden)
    monkeypatch.setattr(tpool, "build_chrom_index", forbidden)
    cfg = _cfg(TConfig, bam, fa, tmp_path / "o.vcf", tmp_path / "wd", engine)
    with pytest.raises(ValueError, match="forked child cannot use CUDA"):
        tpool.run_pool_baseline(cfg, ["argv"], device="cuda")
    with pytest.raises(ValueError, match="forked child cannot use CUDA"):
        tpool.run_pool_baseline(cfg, ["argv"])


def test_pool_input_checks(tmp_path, monkeypatch):
    """The default device is CUDA and raises without a card; an include
    bed is refused."""
    bam, fa = _build(tmp_path)
    cfg = _cfg(TConfig, bam, fa, tmp_path / "o.vcf", tmp_path / "wd")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tpool.run_pool_baseline(cfg, ["argv"])
    cfg.include_bed = str(tmp_path / "x.bed")
    with pytest.raises(ValueError, match="include_bed"):
        tpool.run_pool_baseline(cfg, ["argv"], device="cpu")
