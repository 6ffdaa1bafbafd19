"""The port's ``--n_shards`` path against the JAX package's, on the CPU.

JAX runs its sharded programs on the 8 virtual CPU devices that
tests/conftest.py makes; the port runs its own over ``[cpu] * 8``
(``parallel/mesh.py``: a device list, which may repeat a device). Every
output must be equal to JAX's: the arrays of ``sharded_cluster_sizes``,
the sharded cover, ``_gap_cuts`` and ``_cluster_stream_sharded``, the
candidate rows of the DEL/INS, DUP, INV and TRA resolvers, and the VCF
bodies of whole runs (device engine, streaming and plain decode, Python
decoder, ``--profile``, ``--engine host``, ``--distributed``).
"""
import random

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from cutesv_tpu import cli as jcli
from cutesv_tpu import pipeline as jpipe
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.models import device as jdev
from cutesv_tpu.models import host as jhost
from cutesv_tpu.parallel import mesh as jmesh
from cutesv_tpu.parallel.sharded_cover import make_sharded_cover as jcover
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.models import device as tdev
from cutesv_tpu_torch.parallel import mesh as tmesh
from cutesv_tpu_torch.parallel.sharded_cover import (
    make_sharded_cover as tcover)
from cutesv_tpu_torch.tools.simulate import replay as treplay
from tests import simdata
from tests.test_device_parity import (_random_del_stream, _random_dup_stream,
                                      _random_ins_stream, _random_inv_stream)
from tests.test_engine_equivalence import _strip_volatile
from tests.test_parallel import _distributed_fixture
from tests.test_torch_distributed import _body, _two_processes
from tests.test_torch_pair import _port_tables
from tests.test_torch_pipeline import build_engines_fixture
from tests.test_tra_device import _make_sigs, _make_tables

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "tests/conftest.py makes 8 CPU devices"
    return jmesh.make_mesh(8)


@pytest.fixture
def shard_calls(monkeypatch):
    """Counts the per-shard program loops the port runs (so a test sees
    that it took the sharded route, not the serial one)."""
    calls = []
    for name in ("sharded_cluster_structure", "sharded_pair_cluster"):
        orig = getattr(tdev, name)

        def spy(shards, *args, _orig=orig, _name=name):
            calls.append((_name, len(shards)))
            return _orig(shards, *args)
        monkeypatch.setattr(tdev, name, spy)
    return calls


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

def _sizes_demo():
    pos, valid = tmesh.demo_inputs(8, device="cpu")[:2]
    return pos.numpy(), valid.numpy()


def _sizes_padding(shift=False):
    """The per-shard padding case of tests/test_parallel.py: 12 of 16
    rows of each shard valid, shard 3 empty; ``shift`` opens a real gap
    across the empty shard."""
    n, rows = 8, 16
    pos = np.zeros(n * rows, np.int32)
    valid = np.zeros(n * rows, bool)
    p = 1000
    for k in range(n):
        if k == 3:
            continue
        for r in range(12):
            pos[k * rows + r] = p
            valid[k * rows + r] = True
            p += 10
    if shift:
        pos[4 * rows:] += 10_000
    return pos, valid


def _sizes_spanning():
    return np.arange(8 * 32, dtype=np.int32) * 10, np.ones(8 * 32, bool)


SIZE_CASES = {"demo": _sizes_demo, "padding": _sizes_padding,
              "padding_gap": lambda: _sizes_padding(True),
              "spanning": _sizes_spanning}


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_sharded_cluster_sizes_equal_jax(mesh8, case):
    pos, valid = SIZE_CASES[case]()
    want = jax.device_get(jmesh.sharded_cluster_sizes(mesh8, 200)(
        jax.numpy.asarray(pos), jax.numpy.asarray(valid)))
    cid, sizes, n_clusters = tmesh.sharded_cluster_sizes(CPU8, 200)(
        pos, valid)
    assert np.array_equal(cid, np.asarray(want[0]))
    assert sizes.dtype == np.int32
    assert np.array_equal(sizes, np.asarray(want[1]))
    assert n_clusters == int(want[2])


def test_sharded_cover_counts_equal_jax_and_plain(mesh8):
    args = tmesh.demo_inputs(8, device="cpu")
    sv_s, sv_e, st, en = (a.numpy() for a in args[2:])
    want = np.asarray(jax.device_get(jmesh.sharded_cover_counts(mesh8)(
        *(jax.numpy.asarray(a) for a in (sv_s, sv_e, st, en)))))
    got = tmesh.sharded_cover_counts(CPU8)(sv_s, sv_e, st, en)
    plain = [int(np.sum((st <= s) & (en >= e))) for s, e in zip(sv_s, sv_e)]
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist() == plain
    step = tmesh.full_sharded_step(CPU8)(*args)
    assert step[3].tolist() == plain and step[2] >= 1


@pytest.mark.parametrize("n_sv", [3, 61, 1000])
def test_make_sharded_cover_equals_jax(n_sv):
    """Window counts below, at and above the shard count (a slice without
    windows counts nothing), half-integral windows included."""
    rng = np.random.default_rng(n_sv)
    wins = chip_smoke.random_windows(rng, n_sv, 2_000_000, half=True)
    st, en = chip_smoke.random_reads(rng, 5_000, 2_000_000)
    want = jcover(8)(wins, st, en)
    got = tcover(8, CPU8)(wins, st, en)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert tcover(8, None) is None
    assert tcover(8, CPU8)([], st, en).tolist() == []


def test_pick_devices_never_gives_cuda_a_cpu(monkeypatch):
    assert tmesh.pick_devices(3, "cpu") == [CPU] * 3
    assert tmesh.shard_devices(1, "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.pick_devices(2, "cuda") is None
    assert tmesh.shard_devices(2, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = tmesh.pick_devices(4, "cuda")
    assert got == [torch.device("cuda", k) for k in range(4)]
    assert tmesh.pick_devices(2, "cuda:3") == got[:2]
    assert tmesh.pick_devices(8, "cuda") is None
    assert tmesh.shard_devices(2, "cuda", ["cuda:0"] * 3) == \
        [torch.device("cuda:0")] * 2
    with pytest.raises(ValueError, match="CUDA devices only"):
        tmesh.shard_devices(2, "cuda", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.shard_devices(4, "cpu", CPU8[:2])


# ---------------------------------------------------------------------------
# models/device.py
# ---------------------------------------------------------------------------

GAP_CASES = {  # (positions, n_shards, bias): the None cases included
    "random_2": (np.cumsum(np.random.default_rng(0).integers(0, 400, 500)),
                 2, 200),
    "random_8": (np.cumsum(np.random.default_rng(1).integers(0, 400, 500)),
                 8, 200),
    "sparse_gaps_4": (np.r_[np.arange(100), 10_000 + np.arange(100),
                            20_000 + np.arange(100),
                            30_000 + np.arange(100)], 4, 200),
    "no_gap": (np.arange(400) * 10, 2, 200),
    "too_few_gaps": (np.r_[np.arange(50), 1_000 + np.arange(50)], 4, 200),
    # two gaps, both nearest to both targets: the cuts would repeat
    "degenerate": (np.r_[np.arange(100), [10_000], 20_000 + np.arange(299)],
                   3, 200),
}


@pytest.mark.parametrize("case", sorted(GAP_CASES))
def test_gap_cuts_equal_jax(case):
    pos, n_shards, bias = GAP_CASES[case]
    want = jdev._gap_cuts(pos, n_shards, bias)
    assert tdev._gap_cuts(pos, n_shards, bias) == want
    assert (want is None) == (case in ("no_gap", "too_few_gaps",
                                       "degenerate"))


@pytest.mark.parametrize("seed", range(3))
def test_cluster_stream_sharded_arrays_equal_jax(seed, shard_calls):
    """Array for array: shard-offset cluster ids, positions, lengths and
    global stream indices."""
    rows = _random_del_stream(random.Random(500 + seed), n_sites=40)
    want = jdev._cluster_stream_sharded(
        jdev.IndelStream.from_tuples(rows, False), 3, 200, 8)
    got = tdev._cluster_stream_sharded(
        tdev.IndelStream.from_tuples(rows, False), 3, 200, CPU8, CPU)
    assert shard_calls == [("sharded_cluster_structure", 8)]
    assert len(got) == 4 and len(got[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_sharded_indel_multi_equals_jax(seed, shard_calls):
    """resolve_indel_device_multi with n_shards=8: the JAX package's rows
    and the host oracle's, for DEL and INS."""
    rng = random.Random(700 + seed)
    for is_ins, make, resolve in ((False, _random_del_stream,
                                   jhost.resolve_del),
                                  (True, _random_ins_stream,
                                   jhost.resolve_ins)):
        streams = [(c, make(rng, n_sites=14)) for c in ["chr1", "chr2",
                                                          "chr3"]]
        want = jdev.resolve_indel_device_multi(streams, is_ins, 3, 0.5, 200,
                                               3, 1.0, True, n_shards=8)
        got = tdev.resolve_indel_device_multi(streams, is_ins, 3, 0.5, 200,
                                              3, 1.0, True, n_shards=8,
                                              device="cpu")
        assert got == want
        for c, s in streams:
            assert got[c] == resolve(s, c, 3, 0.5, 200, 3, 1.0, True)
    assert shard_calls == [("sharded_cluster_structure", 8)] * 2


@pytest.mark.parametrize("action", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_sharded_dup_inv_equal_jax(seed, action, shard_calls):
    rng = random.Random(900 + seed)
    dup = _random_dup_stream(rng, n_sites=40)
    inv = _random_inv_stream(rng, n_sites=40)
    got = tdev.resolve_dup_device(dup, "chr1", 3, 150, 30, 100000, action,
                                  device="cpu", n_shards=8)
    assert got == jdev.resolve_dup_device(dup, "chr1", 3, 150, 30, 100000,
                                          action, n_shards=8)
    assert got == jhost.resolve_dup(dup, "chr1", 3, 150, 30, 100000, action)
    got = tdev.resolve_inv_device(inv, "chr1", 3, 150, 30, 100000, action,
                                  device="cpu", n_shards=8)
    assert got == jdev.resolve_inv_device(inv, "chr1", 3, 150, 30, 100000,
                                          action, n_shards=8)
    assert shard_calls == [("sharded_pair_cluster", 8)] * 2


@pytest.mark.parametrize("action", [False, True])
def test_sharded_tra_equals_jax(action, shard_calls):
    rng = np.random.default_rng(21)
    lengths = {"chr1": 2_000_000, "chr2": 1_500_000}
    tables, n_names = _make_tables(rng, lengths, 200)
    sigs = _make_sigs(rng, lengths, 40, 6, n_names)
    names = ["r%06d" % i for i in range(n_names)]
    want = jdev.resolve_tra_device(sigs, "chr1", 3, 0.6, 5_000, tables,
                                   lengths, action, 500, names=names,
                                   n_shards=8)
    got = tdev.resolve_tra_device(sigs, "chr1", 3, 0.6, 5_000,
                                  _port_tables(tables), lengths, action, 500,
                                  names=names, device="cpu", n_shards=8)
    assert got == want and len(got) > 0
    assert shard_calls == [("sharded_pair_cluster", 8)]
    state = tdev.resolve_tra_start(sigs, 3, 5_000, "cpu", 8)
    assert state[0] == "done"
    assert tdev.resolve_tra_compact(state) is state
    assert tdev._handles(state) == []


def test_serial_route_below_four_rows_per_shard(shard_calls):
    """Fewer than 4 rows per shard: the serial program, as in JAX."""
    rows = _random_del_stream(random.Random(3), n_sites=3, max_reads=4)
    assert len(rows) < 32
    got = tdev.resolve_del_device(rows, "c", 2, 0.5, 200, 2, 1.0, True,
                                  device="cpu")
    multi = tdev.resolve_indel_device_multi([("c", rows)], False, 2, 0.5,
                                            200, 2, 1.0, True, n_shards=8,
                                            device="cpu")
    assert multi["c"] == got
    assert shard_calls == []


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def _del_fixture(tmp_path):
    """The DEL corpus of tests/test_parallel.py::
    test_sharded_cover_in_pipeline."""
    rng = random.Random(6)
    ref = simdata.make_reference(rng, {"c": 30_000})
    plans = [simdata.read_with_del(ref["c"], 0, start, 15_000, 80,
                                   3000 - (15_080 - start), "s%d" % i)
             for i, start in enumerate(range(12_200, 14_700, 250))]
    bam, fa = tmp_path / "s.bam", tmp_path / "s.fa"
    simdata.write_bam(str(bam), [("c", 30_000)], plans)
    simdata.write_ref_fasta(str(fa), ref)
    return bam, fa


def _both(bam, fa, tmp_path, tag, **kw):
    """The JAX package's and the port's run (on [cpu] * 8 by default) of
    the same options; returns both bodies and the port's stats."""
    bodies, stats = [], None
    for pkg in ("jax", "port"):
        out = tmp_path / ("%s_%s.vcf" % (pkg, tag))
        wd = tmp_path / ("w%s_%s" % (pkg, tag))
        wd.mkdir()
        opts = dict(input=str(bam), reference=str(fa), output=str(out),
                    work_dir=str(wd), genotype=True, min_support=3, **kw)
        if pkg == "jax":
            jpipe.run_pipeline(JConfig(**opts), ["x"])
        else:
            stats = tpipe.run_pipeline(TConfig(**opts), ["x"], device="cpu")
        bodies.append(_strip_volatile(out.read_text()))
    return bodies[0], bodies[1], stats


def test_sharded_pipeline_profile_equals_jax(tmp_path):
    """--n_shards 8 (native decode, the default) with --profile: the JAX
    body, the trace written, and the shard devices in the stats."""
    bam, fa = _del_fixture(tmp_path)
    want, got, stats = _both(bam, fa, tmp_path, "prof", n_shards=8,
                             profile=True)
    assert got == want
    assert len([l for l in got.splitlines() if not l.startswith("#")]) == 1
    assert stats["shard_devices"] == ["cpu"] * 8
    assert (tmp_path / "wport_prof" / "torch_trace" / "run.json").exists()


def test_sharded_pipeline_python_decoder_equals_jax(tmp_path, monkeypatch):
    """The Python store: DEL/INS genotypes count per chromosome through
    the sharded cover."""
    counted = []

    def spy(n_shards, devices):
        cover = tcover(n_shards, devices)

        def counting(*args):
            counted.append((n_shards, len(args[0])))
            return cover(*args)
        return counting

    monkeypatch.setattr(tpipe, "make_sharded_cover", spy)
    bam, fa = build_engines_fixture(tmp_path)
    want, got, _ = _both(bam, fa, tmp_path, "py", n_shards=8,
                         engine="device", decoder="python")
    assert got == want
    assert counted and all(n == 8 for n, _ in counted)


@pytest.mark.parametrize("dispatch", ["1", "0"])
def test_sharded_alltypes_grid_equals_jax(tmp_path, monkeypatch, dispatch,
                                          shard_calls):
    """A 1.5 Mb replayed grid of every SV type, streaming (early programs
    reused as singleton jobs) and plain decode, --n_shards 8."""
    # the JAX package's switches; the port's rule, or a plain decode
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", dispatch)
    monkeypatch.delenv("CUTESV_STREAM_TAIL", raising=False)
    if dispatch == "0":
        monkeypatch.setattr(tpipe, "stream_rule",
                            lambda *a, **k: tpipe.StreamRule(False, False))
    bed = str(tmp_path / "grid.bed")
    n = chip_smoke.write_alltypes_bed(bed, "chr1", 1_500_000, seed=5)
    info = treplay(str(tmp_path / "rp"), [bed], "chr1:0-1500000",
                   coverage=20, seed=1)
    assert info["n_sv"] == n
    want, got, stats = _both(info["bam"], info["fa"], tmp_path, "grid",
                             n_shards=8, engine="device", decoder="native")
    assert got == want
    assert {l.split("SVTYPE=")[1].split(";")[0] for l in got.splitlines()
            if not l.startswith("#")} == {"DEL", "INS", "DUP", "INV", "BND"}
    assert stats["streaming"] == (dispatch == "1")
    assert stats["shard_devices"] == ["cpu"] * 8
    assert shard_calls


def test_host_engine_ignores_n_shards_like_jax(tmp_path, shard_calls):
    bam, fa = build_engines_fixture(tmp_path)
    want, got, stats = _both(bam, fa, tmp_path, "host", n_shards=2,
                             engine="host")
    assert got == want
    assert stats["shard_devices"] == [] and shard_calls == []


def test_shard_devices_argument_overrides_pick_devices(tmp_path, shard_calls):
    """run_pipeline's ``shard_devices``: a shorter list than [cpu] * 8
    shards over it; the body stays the JAX package's."""
    bam, fa = _del_fixture(tmp_path)
    want, _, _ = _both(bam, fa, tmp_path, "two", n_shards=2)
    out = tmp_path / "o.vcf"
    stats = tpipe.run_pipeline(
        TConfig(input=str(bam), reference=str(fa), output=str(out),
                work_dir=str(tmp_path / "wo"), genotype=True, min_support=3,
                n_shards=2), ["x"], device="cpu", shard_devices=[CPU] * 3)
    assert stats["shard_devices"] == ["cpu", "cpu"]
    assert _strip_volatile(out.read_text()) == want


def test_distributed_sharded_two_process_equals_jax(tmp_path):
    """--distributed --n_shards 4 as two processes on the CPU (each
    resolving its chromosome bucket over its own [cpu] * 4) against the
    JAX package's single-process sharded body."""
    base = _distributed_fixture(tmp_path)
    extra = ["--genotype", "-s", "3", "--engine", "device", "--n_shards",
             "4"]
    assert jcli.main(base + [str(tmp_path / "j.vcf"), str(tmp_path / "wj")]
                     + extra) == 0
    want = _body(tmp_path / "j.vcf")
    rcs, outs = _two_processes(tmp_path, base, extra, "mp")
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert not (tmp_path / "mp1.vcf").exists()
    assert _body(tmp_path / "mp0.vcf") == want
    assert all("--n_shards 4: sharded over cpu, cpu, cpu, cpu" in o
               for o in outs), outs[0][-1500:]
