"""The port's kernel benchmark (``cutesv_tpu_torch/tools/bench_kernels.py``)
against the repo's root ``tools/bench_kernels.py``, on the CPU: the same
synthetic stream bit for bit, one rep of each program equal to the JAX
program on that stream, the cover rep equal to the host count, the JSON
record's keys, and the default device's refusal without a card."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesv_tpu.genotype import cover_counts as jcover_counts
from cutesv_tpu.ops.indel_cluster import \
    indel_cluster_structure as jindel
from cutesv_tpu.ops.pair_cluster import pair_cluster_structure as jpair
from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.tools import bench_kernels as bk
from tools import bench_kernels as jbk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the root tool's JSON keys (tools/bench_kernels.py:278-304), and those of
# its program records (:175-176, :203-204, :300-303)
JAX_KEYS = {"backend", "device", "n_rows", "methodology", "rtt_s",
            "stream_roofline_bytes_per_s", "sort_roofline_rows_per_s",
            "indel_cluster", "pair_cluster", "cover", "total_s"}
PROGRAM_KEYS = {"rows", "s", "rows_per_s", "bytes_per_s", "vs_sort_roofline"}
# the cover's: the JAX tool's bare tile is its XLA scan, whose counterpart
# here is the count's byte floor; pairs are S * R answered, and the end to
# end call is split into its four parts
COVER_KEYS = {"n_sv", "n_reads", "s", "pairs_per_s", "bare_pairs_per_s",
              "scale_s", "upload_s", "kernel_s", "fetch_s",
              "candidate_pairs", "compared_pairs", "bound_ms",
              "dense_bound_ms", "efficiency_vs_bound"}


@pytest.mark.parametrize("n,seed", [(4096, 0), (4096, 1), (100_003, 0),
                                    (40, 7)])
def test_indel_stream_bit_equal_to_the_root_tool(n, seed):
    got, want = bk.make_indel_stream(n, seed), jbk.make_indel_stream(n, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rep", [0, 3])
def test_indel_rep_equals_jax(rep):
    n = 4096
    got = bk.indel_step(n, CPU)(rep)
    pos, length, rid = jbk.make_indel_stream(n)
    want = jindel(jnp.asarray(pos) + jnp.int32(rep), jnp.asarray(length),
                  jnp.asarray(rid), jnp.int32(n - 64), jnp.int32(200),
                  jnp.int32(10), n)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert int(got["n_kept"]) > n // 2


@pytest.mark.parametrize("rep", [0, 3])
def test_pair_rep_equals_jax(rep):
    n = 4096
    got = bk.pair_step(n, CPU)(rep)
    pos, length, rid = jbk.make_indel_stream(n, seed=1)
    k = jnp.int32(rep)
    want = jpair(jnp.asarray(pos) + k, jnp.asarray(pos + length) + k,
                 jnp.zeros(n, jnp.int32), jnp.asarray(rid), jnp.int32(n - 64),
                 jnp.int32(200), jnp.int32(10), n, False)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert int(got["n_kept"]) > n // 2


def test_cover_rep_equals_the_host_count():
    s, st, en = bk.cover_inputs(3_000, 50_000)
    wins = bk.cover_windows(s, 5)
    got = cover.cover_counts_cuda(wins, st, en, CPU)
    assert np.array_equal(got, jcover_counts(wins, st, en))
    assert got.sum() > 0


def test_k1_bound():
    """At the genome-scale shape (32,768 windows x 1.5 M reads) the
    all-pairs bound is the operations' 4.402 ms (a handful of windows over
    many reads: the bytes), and the count's floor is its bytes, 3.699 us,
    below it everywhere."""
    ms, by = bk.dense_bound_ms(32_768, 1_500_000)
    assert (round(ms, 3), by) == (4.402, "operations")
    assert bk.dense_bound_ms(1, 10_000_000)[1] == "bytes"
    floor, by = bk.cover_bound_ms(32_768, 1_500_000)
    assert (round(floor * 1e3, 3), by) == (3.699, "bytes")
    for shape in ((32_768, 1_500_000), (1, 10_000_000), (12, 327)):
        assert bk.cover_bound_ms(*shape)[0] <= bk.dense_bound_ms(*shape)[0]
    assert bk.cover_bound_ms(1, 10_000_000) == bk.dense_bound_ms(1,
                                                                 10_000_000)


def test_cover_record_pairs_and_parts():
    """The cover record: pairs answered are S * R over the call's seconds;
    the pruned ranges hold far fewer candidate pairs than S * R and the
    blocks compare at least those; no efficiency exceeds 1."""
    rec = bk.bench_cover(2_000, 40_000, CPU, 0.0, 1)
    pairs = 2_000 * 40_000
    assert rec["pairs_per_s"] == pytest.approx(pairs / rec["s"])
    assert 0 < rec["candidate_pairs"] <= rec["compared_pairs"] < pairs / 10
    for key in ("scale_s", "upload_s", "kernel_s", "fetch_s"):
        assert rec[key] > 0
    assert 0 < rec["efficiency_vs_bound"] <= 1
    assert 0 < rec["bare_efficiency_vs_bound"] <= 1


def test_run_on_cpu_names_the_cpu():
    rec = bk.run("cpu", reps=1, n_rows=2048, n_reads=5_000, n_sv=600)
    assert rec["backend"] == rec["device"] == rec["card"] == "cpu"
    assert rec["stream_vs_hbm_peak"] is None
    assert rec["cover"]["n_sv"] == 600
    for key in ("indel_cluster", "pair_cluster"):
        assert rec[key]["rows"] == 2048 and rec[key]["rows_per_s"] > 0


def test_json_line_carries_the_root_tool_keys():
    env = dict(os.environ, KBENCH_REPS="1", KBENCH_ROWS="4096",
               KBENCH_READS="20000", KBENCH_SV="1000")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "cutesv_tpu_torch.tools.bench_kernels",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert JAX_KEYS <= set(rec)
    assert PROGRAM_KEYS <= set(rec["indel_cluster"])
    assert PROGRAM_KEYS <= set(rec["pair_cluster"])
    assert COVER_KEYS <= set(rec["cover"])
    assert rec["n_rows"] == 4096 and rec["cover"]["n_reads"] == 20_000
    assert rec["backend"] == rec["device"] == rec["card"] == "cpu"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        bk.run()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        bk.main([])
