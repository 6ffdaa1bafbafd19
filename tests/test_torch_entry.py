"""The port's entry points and tools against the JAX package's, on the CPU:
``cutesv_tpu_torch/entry.py`` (``entry``, ``dryrun_multichip``) against
``__graft_entry__.py``, the simulator's ``simulate_messy`` and CLI
``main`` against ``cutesv_tpu/tools/simulate.py``, and the port-owned
``tools/bench_tra.py`` and ``tools/scale_run.py`` against the repo's
``tools/`` counterparts."""
import json
import re

import numpy as np
import pytest

import __graft_entry__ as jentry
from cutesv_tpu.models import host as jhost
from cutesv_tpu.tools import simulate as jsim
from cutesv_tpu_torch import entry as tentry
from cutesv_tpu_torch.tools import bench_tra as tbench
from cutesv_tpu_torch.tools import scale_run as tscale
from cutesv_tpu_torch.tools import simulate as tsim
from tools import bench_tra as jbench
from tools import scale_run as jscale


def test_entry_equals_jax():
    jfwd, jargs = jentry.entry()
    want = jfwd(*jargs)
    fwd, args = tentry.entry("cpu")
    got = fwd(*args)
    assert int(got["n_kept"]) > 1000
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for a, b in zip(args, jargs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


_DRYRUN = re.compile(r"DRYRUN (\w+): n_devices=(\d+) n_clusters=(\d+) "
                     r"cover_checksum=(\d+) pipeline_calls=(\d+) "
                     r"sharded==serial: yes vcf_identical: (\w+)")


def _dryrun_line(out: str):
    lines = [m.groups() for m in map(_DRYRUN.search, out.splitlines()) if m]
    assert len(lines) == 1, out[-2000:]
    return lines[0]


def test_dryrun_multichip_equals_jax(capsys):
    jentry.dryrun_multichip(4)
    want = _dryrun_line(capsys.readouterr().out)
    tentry.dryrun_multichip(4, ["cpu"] * 4)
    got = _dryrun_line(capsys.readouterr().out)
    assert got == want
    assert got[0] == "OK" and got[1] == "4" and got[-1] == "yes"


def test_dryrun_multichip_two_devices(capsys):
    """Two shards: the JAX package's dry run fails its own pair-program
    check here (at its ~1.5 kb spacing every pair cluster is a
    singleton); the port's denser pair input keeps rows and the run ends
    in DRYRUN OK."""
    with pytest.raises(AssertionError, match="pair kernels must keep"):
        jentry.dryrun_multichip(2)
    capsys.readouterr()
    tentry.dryrun_multichip(2, ["cpu"] * 2)
    got = _dryrun_line(capsys.readouterr().out)
    assert got[0] == "OK" and got[1] == "2" and got[-1] == "yes"


def test_dryrun_multichip_needs_its_devices(monkeypatch):
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        tentry.dryrun_multichip(4, ["cpu"] * 2)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 1"):
        tentry.dryrun_multichip(2)


def _same_files(a: dict, b: dict, keys=("bam", "fa", "bed", "gt")):
    for k in keys:
        with open(a[k], "rb") as x, open(b[k], "rb") as y:
            assert x.read() == y.read(), k


def test_simulate_messy_writes_jax_bytes(tmp_path):
    """The fixture of tests/test_tools.py::
    test_messy_simulator_call_and_eval."""
    got = tsim.simulate_messy(str(tmp_path / "t"), genome_mb=2.0,
                              n_chroms=2, seed=3)
    want = jsim.simulate_messy(str(tmp_path / "j"), genome_mb=2.0,
                               n_chroms=2, seed=3)
    assert got["n_reads"] == want["n_reads"] > 1000
    _same_files(got, want)


@pytest.mark.parametrize("extra", [
    pytest.param([], id="grid"),
    pytest.param(["--messy"], id="messy"),
    pytest.param(["--human_layout", "--coverage", "4"], id="human_layout"),
])
def test_simulate_main_writes_jax_bytes(tmp_path, extra):
    argv = ["--genome_mb", "1.0", "--seed", "5"] + extra
    assert tsim.main([str(tmp_path / "t")] + argv) == 0
    assert jsim.main([str(tmp_path / "j")] + argv) == 0
    for suffix in (".bam", ".fa", ".truth.bed", ".zygosity.bed"):
        with open(str(tmp_path / "t") + suffix, "rb") as x, \
                open(str(tmp_path / "j") + suffix, "rb") as y:
            assert x.read() == y.read(), suffix


def test_bench_tra_arms_equal_the_root_tool():
    """The storm of the repo's tools/bench_tra.py from the same seed; the
    port's three arms (run raises unless they are equal) give the root
    tool's device and host arms' candidates."""
    res = tbench.run(2_000, 20_000, "cpu", reps=1)
    sigs, tables, lengths, names = jbench.build_storm(2_000, 20_000)
    assert tbench.build_storm(2_000, 20_000)[0] == sigs
    args = ("chr1", 3, 0.6, 50, tables, lengths, True, 500)
    want = jhost.resolve_tra(sigs, *args, names=names)
    assert jbench.run_device(sigs, tables, lengths, names, args) == want
    assert res["candidates"] == want and len(want) > 100
    assert res["device"] == "cpu"
    for k in ("device_s", "host_s", "oracle_s"):
        assert res[k] > 0.0


def test_scale_run_record_equals_the_root_tool(tmp_path, capsys):
    """One run of each tool on a tiny corpus: the same JSON keys, and the
    port's calls are the JAX body's record count."""
    prefix = str(tmp_path / "s")
    tsim.simulate(prefix, genome_mb=1.0, n_chroms=2, coverage=10,
                  read_len=8_000, sv_spacing=20_000, seed=2, zygosity="hom")
    assert tscale.main([prefix, "--runs", "1", "--min_support", "3",
                        "--device", "cpu"]) == 0
    got = [json.loads(line.split(" ", 1)[1])
           for line in capsys.readouterr().out.splitlines()
           if line.startswith("SCALE_RUN ")]
    jscale.run_child(prefix, 3)
    want = [json.loads(line.split(" ", 1)[1])
            for line in capsys.readouterr().out.splitlines()
            if line.startswith("SCALE_RUN ")]
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    with open(prefix + "_work/scale.vcf") as fh:
        n_records = sum(1 for line in fh if not line.startswith("#"))
    assert got[0]["n_calls"] == want[0]["n_calls"] == n_records > 10
    assert got[0]["n_records"] == want[0]["n_records"]
