"""The pruned cover count's arithmetic on the CPU.

The CUDA kernel (``cutesv_tpu_torch/csrc/cover_count.cu``) cannot run
here, so its pruning has a plain mirror, ``ops/sweep.py::
cover_pruned_plain``: the same bins, the same int64 ``[e - L, s]``
ranges, the same blocks and the same long-read arm. Each adversarial case
of ``chip_smoke.cover_cases`` (seeded numpy inputs of doubled int32
coordinates) goes through it, the port's plain version, the port's host
count and the JAX package's Pallas kernel in interpret mode; all must be
equal. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cutesv_tpu.ops.pallas_sweep import (READ_TILE, SV_TILE, _cover_pallas,
                                         cover_counts_pallas)
from cutesv_tpu_torch.genotype import cover_counts as host_cover_counts
from cutesv_tpu_torch.ops import sweep
from cutesv_tpu_torch.ops.sweep import (cover_plain, cover_pruned_plain,
                                        prune_plan, pruned_pairs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join(REPO, "cutesv_tpu_torch", "csrc", "cover_count.cu")
I32 = np.iinfo(np.int32)


def _tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in arrays]


def _pallas(sv_s, sv_e, st, en):
    """The JAX package's Pallas kernel (interpret mode) on doubled int32
    arrays, padded with scale_and_pad's sentinels to its tile multiples."""
    def pad(a, multiple, fill):
        out = np.full(-(-len(a) // multiple) * multiple, fill, np.int32)
        out[:len(a)] = a
        return out

    n_sv = len(sv_s)
    s = pad(sv_s, SV_TILE, I32.min)
    e = pad(sv_e, SV_TILE, I32.max)
    rs = pad(st, READ_TILE, I32.max).reshape(-1, READ_TILE)
    re_ = pad(en, READ_TILE, I32.min).reshape(-1, READ_TILE)
    out = _cover_pallas(jnp.asarray(s), jnp.asarray(e), jnp.asarray(rs),
                        jnp.asarray(re_), interpret=True)
    return np.asarray(out).reshape(-1)[:n_sv]


def _host(sv_s, sv_e, st, en):
    """The port's host count on the halved coordinates (exact in float64:
    2 * start <= s_doubled is start <= s_doubled / 2)."""
    wins = list(zip((sv_s / 2.0).tolist(), (sv_e / 2.0).tolist()))
    return host_cover_counts(wins, st / 2.0, en / 2.0)


@pytest.mark.parametrize("name", chip_smoke.COVER_CASES)
def test_pruned_equals_plain_host_and_pallas(name):
    cases = chip_smoke.cover_cases(700, 5_000, 3_000_000, seed=11)
    assert tuple(cases) == chip_smoke.COVER_CASES
    arrays = cases[name]
    got = cover_pruned_plain(*_tensors(arrays))
    want = cover_plain(*_tensors(arrays))
    assert got.dtype == torch.int32
    assert torch.equal(got, want), name
    assert np.array_equal(got.numpy(), _pallas(*arrays)), name
    assert np.array_equal(got.numpy().astype(np.int64), _host(*arrays))


@pytest.mark.parametrize("name", chip_smoke.COVER_CASES)
@pytest.mark.parametrize("seed", [3, 4])
def test_pruned_equals_plain_at_other_shapes(name, seed):
    """Fewer windows than a group, ragged groups, fewer reads than the
    dense arm needs (< 1024) and more bins than one."""
    n_sv, n_reads = (37, 900) if seed == 3 else (2_001, 20_000)
    arrays = chip_smoke.cover_cases(n_sv, n_reads, 10_000_000, seed)[name]
    tens = _tensors(arrays)
    assert torch.equal(cover_pruned_plain(*tens), cover_plain(*tens))


def test_pruned_equals_cover_counts_pallas():
    """The public JAX entry point (its own scaling and padding) on the
    random case's windows and reads."""
    sv_s, sv_e, st, en = chip_smoke.cover_cases(500, 3_000, 2_000_000,
                                                 seed=2)["random"]
    wins = list(zip((sv_s / 2.0).tolist(), (sv_e / 2.0).tolist()))
    want = cover_counts_pallas(wins, st // 2, en // 2, interpret=True)
    got = cover_pruned_plain(*_tensors((sv_s, sv_e, st, en)))
    assert list(got.numpy()) == list(want)


@pytest.mark.parametrize("n_sv,n_reads", [(0, 100), (100, 0), (0, 0)])
def test_pruned_empty_inputs(n_sv, n_reads):
    rng = np.random.default_rng(1)
    s = rng.integers(0, 1000, n_sv)
    st = rng.integers(0, 1000, n_reads)
    tens = _tensors((s, s + 10, st, st + 50))
    got = cover_pruned_plain(*tens)
    assert got.dtype == torch.int32 and got.shape == (n_sv,)
    assert not got.any()
    assert pruned_pairs(*tens) == (0, 0)


def test_constants_match_the_kernel():
    """The mirror's constants are the kernel's."""
    with open(KERNEL) as fh:
        src = fh.read()
    for name in ("WINDOWS_PER_GROUP", "MIN_BINS", "MAX_BINS",
                 "READS_PER_BIN", "LONG_SHIFT", "LEN_CLASSES"):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        assert m and int(m.group(1)) == getattr(sweep, "PRUNE_" + name), name


@pytest.mark.parametrize("n_reads,nb", [(1, 1024), (8_192, 1024),
                                        (8_193, 2048), (100_000, 16_384),
                                        (1_500_000, 32_768)])
def test_prune_bins(n_reads, nb):
    assert sweep.prune_bins(n_reads) == nb


def test_length_class_is_the_bit_length():
    vals = [-(2**32 - 1), -5, -1, 0, 1, 2, 3, 4, 1023, 1024, 80_000,
            2**31, 2**32 - 1]
    got = sweep.length_class(torch.tensor(vals, dtype=torch.int64))
    assert got.tolist() == [max(v, 0).bit_length() for v in vals]


def test_one_ultra_long_read_goes_to_the_dense_arm():
    """One 2 Mb read among 1-40 kb reads: it alone is long, and L stays
    that of the others."""
    arrays = chip_smoke.cover_cases(300, 20_000, 10_000_000,
                                    seed=8)["one 2 Mb read"]
    _, _, st, en = _tensors(arrays)
    plan = prune_plan(st, en)
    assert (~plan.short).nonzero().flatten().tolist() == [0]
    assert plan.length == int((en.long() - st.long())[1:].max())


@pytest.mark.parametrize("seed", range(3))
def test_dense_arm_is_bounded(seed):
    """Heavy-tailed lengths: at most n_reads >> 10 reads go dense, and L
    is under twice the longest read outside them."""
    rng = np.random.default_rng(seed)
    n = 50_000
    st = rng.integers(0, 10**8, n)
    length = np.minimum(rng.lognormal(9.5, 1.3, n), 5e8).astype(np.int64)
    plan = prune_plan(*_tensors((st, st + length)))
    n_long = int((~plan.short).sum())
    assert n_long <= n >> 10
    assert plan.length < 2 * int(length[plan.short.numpy()].max()) + 1
    # every long read is at least as long as every short one
    if n_long:
        assert length[~plan.short.numpy()].min() > plan.length


def test_pruning_prunes():
    """A genome-like input: the groups compare a small share of S * R,
    and at least the candidate pairs the windows' own ranges hold."""
    rng = np.random.default_rng(4)
    wins = chip_smoke.random_windows(rng, 2_000, 50_000_000)
    st, en = chip_smoke.random_reads(rng, 100_000, 50_000_000)
    tens = sweep.scaled_tensors(wins, st, en, torch.device("cpu"))
    candidate, compared = pruned_pairs(*tens)
    assert 0 < candidate <= compared < 2_000 * 100_000 // 20
    assert torch.equal(cover_pruned_plain(*tens), cover_plain(*tens))


def test_window_with_an_empty_range_counts_zero():
    """Windows whose [e - L, s] holds no read start: one left of every
    read, one whose e lies beyond every start plus L."""
    st = np.array([100, 200, 300], np.int32)
    en = st + 50
    sv_s = np.array([50, 250, 400, 260], np.int32)
    sv_e = np.array([60, 245, 1_000, 240], np.int32)
    tens = _tensors((sv_s, sv_e, st, en))
    assert cover_pruned_plain(*tens).tolist() == [0, 1, 0, 1]
    assert cover_plain(*tens).tolist() == [0, 1, 0, 1]


def test_cuda_path_raises_when_the_kernel_cannot_build(tmp_path,
                                                       monkeypatch):
    """The CUDA path sizes its scratch through the kernel library, so a
    failed build raises there; nothing falls back to the plain version."""
    from cutesv_tpu_torch.ops import build, cover

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build.shutil, "which", lambda tool: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cover.scratch(10, 10, torch.device("cpu"))
