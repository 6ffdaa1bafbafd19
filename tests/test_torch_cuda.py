"""The port on a CUDA GPU: each kernel and device program against its
plain version, and a small discovery run on the card against the same
run on the CPU. Every test carries the ``cuda`` marker and skips without
a card. This file imports neither jax nor the JAX package, so on a GPU
machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""
import os

import numpy as np
import pytest
import torch

from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.genotype import cover_counts
from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.ops.indel_cluster import indel_cluster_structure
from cutesv_tpu_torch.ops.sweep import cover_counts_plain
from cutesv_tpu_torch.pipeline import run_pipeline
from cutesv_tpu_torch.tools.simulate import simulate

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a hand-written kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def test_cover_kernel_matches_plain(card):
    rng = np.random.default_rng(23)
    starts = rng.integers(0, 100_000, 20_000)
    ends = starts + rng.integers(1, 20_000, 20_000)
    s = rng.integers(0, 110_000, 3_500).astype(np.float64)
    half = rng.random(3_500) < 0.15        # half-integral DUP/INV windows
    w = np.where(half, 250.5, 500.0)
    svs = list(zip(np.maximum(s - w, 0).tolist(), (s + w).tolist()))
    before = cover.LAUNCHES
    got = cover.cover_counts_cuda(svs, starts, ends, card)
    assert cover.LAUNCHES == before + 1
    assert np.array_equal(got, cover_counts_plain(svs, starts, ends, card))
    assert np.array_equal(got, cover_counts(svs, starts, ends))


def test_cluster_program_matches_cpu(card):
    rng = np.random.default_rng(31)
    n, rows = 60_000, 65_536
    pos = np.zeros(rows, np.int32)
    pos[:n] = 1000 + np.cumsum(rng.choice([0, 3, 50, 200, 201, 800], n))
    length = np.zeros(rows, np.int32)
    length[:n] = rng.integers(40, 46, n)
    rid = np.zeros(rows, np.int32)
    rid[:n] = rng.integers(0, 25, n)
    outs = [indel_cluster_structure(
        *(torch.from_numpy(a).to(dev) for a in (pos, length, rid)),
        n, 200, 3, rows) for dev in ("cpu", card)]
    for k in ("cid", "pos", "length", "stream_idx", "n_kept"):
        assert torch.equal(outs[0][k], outs[1][k].cpu()), k


def test_cuda_run_equals_cpu_run(card, tmp_path):
    sim = simulate(str(tmp_path / "sim"), genome_mb=1.0, n_chroms=2,
                   coverage=20, read_len=20_000, seed=4)
    bodies = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / ("%s.vcf" % device)
        cfg = Config(input=sim["bam"], reference=sim["fa"], output=str(out),
                     work_dir=str(tmp_path / device), genotype=True,
                     min_support=5)
        before = cover.LAUNCHES
        stats = run_pipeline(cfg, ["x"], device=device)
        assert stats["decoder"] == "native"  # the default
        if device == "cuda":
            # one batched cover pass: 1 Mb fits one 1e9-bp flush
            assert cover.LAUNCHES == before + 1
        bodies[device] = [l for l in out.read_text().splitlines()
                          if not l.startswith(("##fileDate",
                                               "##CommandLine"))]
    assert bodies["cuda"] == bodies["cpu"]
    assert sum(1 for l in bodies["cuda"] if not l.startswith("#")) >= 10
    assert os.path.exists(sim["bed"])
