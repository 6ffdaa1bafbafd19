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

import chip_smoke
from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.genotype import cover_counts
from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.ops.indel_cluster import indel_cluster_structure
from cutesv_tpu_torch.ops.pair_cluster import pair_cluster_structure
from cutesv_tpu_torch.ops.sweep import cover_counts_plain, cover_plain
from cutesv_tpu_torch.pipeline import run_pipeline
from cutesv_tpu_torch.tools.simulate import replay, simulate

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


@pytest.mark.parametrize("name", chip_smoke.COVER_CASES)
@pytest.mark.parametrize("n_sv,n_reads", [(700, 5_000), (3_001, 60_000)])
def test_cover_kernel_adversarial_cases(card, name, n_sv, n_reads):
    """Each adversarial case (chip_smoke.cover_cases): the kernel equals
    the plain version, and one call adds exactly one launch."""
    arrays = chip_smoke.cover_cases(n_sv, n_reads, 10_000_000, 13)[name]
    tens = [torch.from_numpy(a).to(card) for a in arrays]
    before = cover.LAUNCHES
    got = cover.cover_tensors(*tens)
    torch.cuda.synchronize()
    assert cover.LAUNCHES == before + 1
    assert torch.equal(got, cover_plain(*tens)), name


def test_cover_launch_failure_raises(card):
    """A launch the kernel refuses (a scratch buffer too small for the
    sizes) raises; nothing falls back to the plain version."""
    tens = [torch.arange(100, dtype=torch.int32, device=card)] * 4
    out = torch.zeros(100, dtype=torch.int32, device=card)
    small = torch.empty(16, dtype=torch.uint8, device=card)
    before = cover.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        cover.launch(*tens, out, small)
    assert cover.LAUNCHES == before


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


def test_pair_program_matches_cpu(card):
    rng = np.random.default_rng(37)
    n, rows = 60_000, 65_536
    arrs = [np.zeros(rows, np.int32) for _ in range(4)]
    k1, k2, aux, rid = chip_smoke.synthetic_pair_rows(rng, n, True)
    for buf, a in zip(arrs, (k1, k2, aux, rid)):
        buf[:n] = a
    for break_on_k2 in (False, True):
        outs = [pair_cluster_structure(
            *(torch.from_numpy(a).to(dev) for a in arrs), n, 150, 3, rows,
            break_on_k2) for dev in ("cpu", card)]
        for k in ("cid", "k1", "k2", "rid", "stream_idx", "n_kept"):
            assert torch.equal(outs[0][k], outs[1][k].cpu()), k


def _three_runs(tmp_path, bam, fa, monkeypatch):
    """The default (streaming) run on the card, on the CPU, and the host
    engine on the card: VCF bodies and the card run's stats."""
    monkeypatch.delenv("CUTESV_STREAM_DISPATCH", raising=False)
    monkeypatch.delenv("CUTESV_STREAM_TAIL", raising=False)
    bodies, main = {}, None
    for tag, device, engine in (("cuda", "cuda", "device"),
                                ("cpu", "cpu", "device"),
                                ("host", "cuda", "host")):
        out = tmp_path / ("%s.vcf" % tag)
        cfg = Config(input=bam, reference=fa, output=str(out),
                     work_dir=str(tmp_path / ("w" + tag)), genotype=True,
                     min_support=5, engine=engine)
        before = cover.LAUNCHES
        stats = run_pipeline(cfg, ["x"], device=device)
        if tag == "cuda":
            main = dict(stats, launches=cover.LAUNCHES - before)
        bodies[tag] = [l for l in out.read_text().splitlines()
                       if not l.startswith(("##fileDate", "##CommandLine"))]
    assert bodies["cuda"] == bodies["cpu"] == bodies["host"]
    return bodies["cuda"], main


def test_streaming_run_equals_cpu_and_host(card, tmp_path, monkeypatch):
    sim = simulate(str(tmp_path / "sim"), genome_mb=2.0, n_chroms=4,
                   coverage=20, read_len=20_000, seed=6)
    body, main = _three_runs(tmp_path, sim["bam"], sim["fa"], monkeypatch)
    assert main["streaming"] and main["early_dispatched"] >= 1
    assert main["launches"] == 1   # the final batch rides one launch
    assert sum(1 for l in body if not l.startswith("#")) >= 20


def test_alltypes_run_equals_cpu_and_host(card, tmp_path, monkeypatch):
    bed = str(tmp_path / "grid.bed")
    n = chip_smoke.write_alltypes_bed(bed, "chr1", 3_000_000, seed=5)
    info = replay(str(tmp_path / "rp"), [bed], "chr1:0-3000000",
                  coverage=20, seed=1)
    assert info["n_sv"] == n
    _, main = _three_runs(tmp_path, info["bam"], info["fa"], monkeypatch)
    assert main["launches"] == 1   # DUP/INV (and TRA) windows: one flush
    recall = chip_smoke.alltypes_recall(info["bed"], str(tmp_path /
                                                         "cuda.vcf"))
    for svtype, (hit, total) in recall.items():
        assert total > 0 and hit >= 0.99 * total, (svtype, hit, total)


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


def test_alltypes_cram_on_cuda_equals_cpu(card, tmp_path, monkeypatch):
    """The all-types corpus as a reference-based CRAM: the default run on
    the card gives the body of the CPU run and of the BAM, through the
    native decoder and one cover launch."""
    monkeypatch.delenv("CUTESV_STREAM_DISPATCH", raising=False)
    bed = str(tmp_path / "grid.bed")
    chip_smoke.write_alltypes_bed(bed, "chr1", 3_000_000, seed=5)
    info = replay(str(tmp_path / "rp"), [bed], "chr1:0-3000000",
                  coverage=20, seed=1)
    cram = str(tmp_path / "rp.cram")
    chip_smoke.write_cram(info["bam"], info["fa"], cram, (3, 0))
    bodies = {}
    for tag, inp, device in (("cuda", cram, "cuda"), ("cpu", cram, "cpu"),
                             ("bam", info["bam"], "cpu")):
        out = tmp_path / ("%s.vcf" % tag)
        cfg = Config(input=inp, reference=info["fa"], output=str(out),
                     work_dir=str(tmp_path / ("w" + tag)), genotype=True,
                     min_support=5)
        before = cover.LAUNCHES
        stats = run_pipeline(cfg, ["x"], device=device)
        assert stats["decoder"] == "native"
        if tag == "cuda":
            assert stats["streaming"]
            assert cover.LAUNCHES == before + 1
        bodies[tag] = [l for l in out.read_text().splitlines()
                       if not l.startswith(("##fileDate", "##CommandLine"))]
    assert bodies["cuda"] == bodies["cpu"] == bodies["bam"]


def test_profile_on_cuda_traces_the_cover_kernel(card, tmp_path,
                                                 monkeypatch):
    """--profile on the card: the torch.profiler trace of the resolve
    stage holds the cover kernel's launch, and the body equals the CPU
    run's."""
    import json

    monkeypatch.delenv("CUTESV_STREAM_DISPATCH", raising=False)
    bed = str(tmp_path / "grid.bed")
    chip_smoke.write_alltypes_bed(bed, "chr1", 3_000_000, seed=5)
    info = replay(str(tmp_path / "rp"), [bed], "chr1:0-3000000",
                  coverage=20, seed=1)
    bodies, traces = {}, {}
    for device in ("cuda", "cpu"):
        out = tmp_path / ("%s.vcf" % device)
        cfg = Config(input=info["bam"], reference=info["fa"],
                     output=str(out), work_dir=str(tmp_path / device),
                     genotype=True, min_support=5, profile=device == "cuda")
        traces[device] = run_pipeline(cfg, ["x"],
                                      device=device).get("profile_trace")
        bodies[device] = [l for l in out.read_text().splitlines()
                          if not l.startswith(("##fileDate",
                                               "##CommandLine"))]
    assert traces["cpu"] is None
    with open(traces["cuda"]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("cover_count" in k for k in kernels), sorted(set(kernels))
    assert bodies["cuda"] == bodies["cpu"]


def test_sharded_run_on_one_card_equals_serial(card, tmp_path, monkeypatch):
    """--n_shards 2 over [cuda:0] * 2 (two sets of per-shard programs and
    one cover launch per window slice, on the one card) gives the serial
    run's body; the stats name the two devices."""
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "0")  # every batch shards
    bed = str(tmp_path / "grid.bed")
    chip_smoke.write_alltypes_bed(bed, "chr1", 3_000_000, seed=5)
    info = replay(str(tmp_path / "rp"), [bed], "chr1:0-3000000",
                  coverage=20, seed=1)
    bodies = {}
    for shards in (1, 2):
        out = tmp_path / ("s%d.vcf" % shards)
        cfg = Config(input=info["bam"], reference=info["fa"],
                     output=str(out),
                     work_dir=str(tmp_path / ("w%d" % shards)),
                     genotype=True, min_support=5, n_shards=shards)
        before = cover.LAUNCHES
        stats = run_pipeline(cfg, ["x"], device=card,
                             shard_devices=[torch.device("cuda", 0)] * 2)
        if shards == 2:
            assert stats["shard_devices"] == ["cuda:0", "cuda:0"]
            assert cover.LAUNCHES == before + 2   # one flush, two slices
        bodies[shards] = [l for l in out.read_text().splitlines()
                          if not l.startswith(("##fileDate", "##CommandLine"))]
    assert bodies[1] == bodies[2]
    assert sum(1 for l in bodies[1] if not l.startswith("#")) >= 100


def test_bench_kernels_on_cuda_equals_cpu(card):
    """bench_kernels at a small size on the card: its record names the
    card, and one rep of each program and of the cover equals the same
    call on the CPU."""
    from cutesv_tpu_torch.tools import bench_kernels as bk

    n, n_sv = 1 << 14, 2_048
    rec = bk.run(card, reps=1, n_rows=n, n_reads=n, n_sv=n_sv)
    assert rec["backend"] == "cuda" and rec["card"] != "cpu"
    assert rec["stream_vs_hbm_peak"] > 0 and rec["cover"]["bound_ms"] > 0
    for make in (bk.indel_step, bk.pair_step):
        got, want = make(n, card)(2), make(n, torch.device("cpu"))(2)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), k
    s, st, en = bk.cover_inputs(n_sv, n)
    wins = bk.cover_windows(s, 2)
    assert np.array_equal(cover.cover_counts_cuda(wins, st, en, card),
                          cover.cover_counts_cuda(wins, st, en, "cpu"))


def test_pool_baseline_after_cuda_gives_the_host_body(card, tmp_path):
    """The pooled baseline forks its workers after this process has used
    the card: with the host engine they never touch it, and the body is
    the host engine's."""
    from cutesv_tpu_torch.tools.baseline_pool import run_pool_baseline

    sim = simulate(str(tmp_path / "sim"), genome_mb=1.0, n_chroms=2,
                   coverage=10, read_len=8_000, seed=4)
    bodies = {}
    for tag in ("host", "pool"):
        out = tmp_path / ("%s.vcf" % tag)
        cfg = Config(input=sim["bam"], reference=sim["fa"], output=str(out),
                     work_dir=str(tmp_path / tag), genotype=True,
                     min_support=3, engine="host", decoder="python")
        if tag == "host":
            run_pipeline(cfg, ["x"], device=card)
            cover.cover_counts_cuda([(10.0, 20.0)], [0], [30], card)
        else:
            run_pool_baseline(cfg, ["x"], n_procs=2, device=card)
        bodies[tag] = [l for l in out.read_text().splitlines()
                       if not l.startswith(("##fileDate", "##CommandLine"))]
    assert bodies["host"] == bodies["pool"]
    assert sum(1 for l in bodies["host"] if not l.startswith("#")) >= 10
