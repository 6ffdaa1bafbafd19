"""PyTorch ops of the port against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
cutesv_tpu_torch counterpart with ``device="cpu"``; every output is an
integer array and must be exactly equal. The CUDA kernel itself is held
to its plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesv_tpu.genotype import cover_counts as jax_host_cover_counts
from cutesv_tpu.ops import indel_cluster as jic
from cutesv_tpu.ops import segments as jseg
from cutesv_tpu.ops.pallas_sweep import cover_counts_pallas
from cutesv_tpu.ops.sweep import cover_counts_device
from cutesv_tpu_torch.genotype import cover_counts as port_host_cover_counts
from cutesv_tpu_torch.ops import cover
from cutesv_tpu_torch.ops import indel_cluster as tic
from cutesv_tpu_torch.ops import segments as tseg
from cutesv_tpu_torch.ops.sweep import (cover_counts_plain, scale_and_pad,
                                        scaled_tensors)
from cutesv_tpu_torch.utils.torchsetup import resolve_device

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_segments_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    k1 = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    k2 = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = tseg.boundary_flags(_t(k1), _t(k2), valid=torch.from_numpy(valid))
    want = jseg.boundary_flags(jnp.asarray(k1), jnp.asarray(k2),
                               valid=jnp.asarray(valid))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))

    num = 16  # ids < 12: segments 12..15 stay empty
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    s = tseg.seg_sum(_t(vals), _t(k1), num)
    m = tseg.seg_min(_t(vals), _t(k1), num)
    assert s.dtype == torch.int32 and m.dtype == torch.int32
    assert np.array_equal(s.numpy(), np.asarray(
        jseg.seg_sum(jnp.asarray(vals), jnp.asarray(k1), num)))
    # empty segments hold INT32_MAX, the segment_min identity
    assert np.array_equal(m.numpy(), np.asarray(
        jseg.seg_min(jnp.asarray(vals), jnp.asarray(k1), num)))
    assert int(m[-1]) == np.iinfo(np.int32).max


def test_padded_size_matches_jax():
    for n in (0, 1, 256, 257, 1024, 1025, 70_000, 5_000_000):
        assert tseg.padded_size(n) == jseg.padded_size(n)


# ---------------------------------------------------------------------------
# DEL/INS cluster structure + compaction
# ---------------------------------------------------------------------------

def _random_stream(rng, n_valid, num_rows, n_reads=25, bias=200):
    """Sorted positions with gaps around ``bias``; read ids and lengths
    from small ranges so (cid, rid, len) ties are common."""
    steps = rng.choice([0, 3, 50, bias, bias + 1, 4 * bias], n_valid)
    pos = np.zeros(num_rows, np.int32)
    pos[:n_valid] = 1000 + np.cumsum(steps)
    length = np.zeros(num_rows, np.int32)
    length[:n_valid] = rng.integers(40, 46, n_valid)
    rid = np.zeros(num_rows, np.int32)
    rid[:n_valid] = rng.integers(0, n_reads, n_valid)
    return pos, length, rid


def _both_cluster(pos, length, rid, n_valid, bias, read_count, num_rows):
    want = jic.indel_cluster_structure(
        jnp.asarray(pos), jnp.asarray(length), jnp.asarray(rid),
        jnp.int32(n_valid), jnp.int32(bias), jnp.int32(read_count),
        num_rows)
    got = tic.indel_cluster_structure(_t(pos), _t(length), _t(rid), n_valid,
                                      bias, read_count, num_rows)
    return want, got


CLUSTER_CASES = [
    # (n_valid, num_rows, read_count)
    (0, 256, 3),        # nothing valid: argmax of an all-False mask
    (1, 256, 1),
    (256, 256, 3),      # every row valid, no padding
    (200, 256, 3),
    (1000, 1024, 2),
    (3000, 4096, 5),
]


# each case with its scalars as ints, and again as 0-d int32 tensors (the
# form a captured CUDA graph reads from its static input)
SCALAR_CASES = [pytest.param(*c, False, id="%d-%d-%d" % c)
                for c in CLUSTER_CASES] + \
    [pytest.param(*c, True, id="%d-%d-%d-tensors" % c)
     for c in CLUSTER_CASES]


@pytest.mark.parametrize("n_valid,num_rows,read_count,tensors",
                         SCALAR_CASES)
@pytest.mark.parametrize("seed", range(2))
def test_indel_cluster_structure_matches_jax(seed, n_valid, num_rows,
                                             read_count, tensors):
    rng = np.random.default_rng(100 * seed + n_valid)
    pos, length, rid = _random_stream(rng, n_valid, num_rows)
    want, got = _both_cluster(pos, length, rid, n_valid, 200, read_count,
                              num_rows)
    if tensors:
        as_ints = got
        got = tic.indel_cluster_structure(
            _t(pos), _t(length), _t(rid),
            *(torch.tensor(v, dtype=torch.int32)
              for v in (n_valid, 200, read_count)), num_rows)
        for k in as_ints:
            assert torch.equal(got[k], as_ints[k]), k
    for k in ("cid", "pos", "length", "stream_idx", "n_kept"):
        assert got[k].dtype == torch.int32, k  # no int64 widening
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    if n_valid == 0:
        assert int(got["n_kept"]) == 0


@pytest.mark.parametrize("n_valid,num_rows,read_count", CLUSTER_CASES[1:])
def test_compact_cluster_outputs_matches_jax(n_valid, num_rows, read_count):
    rng = np.random.default_rng(7 + n_valid)
    pos, length, rid = _random_stream(rng, n_valid, num_rows)
    want, got = _both_cluster(pos, length, rid, n_valid, 200, read_count,
                              num_rows)
    nk = int(got["n_kept"])
    cap = min(tseg.padded_size(max(nk, 1)), num_rows)
    wc = jic.compact_cluster_outputs(want["cid"], want["pos"],
                                     want["length"], want["stream_idx"], cap)
    gc = tic.compact_cluster_outputs(got["cid"], got["pos"], got["length"],
                                     got["stream_idx"], cap)
    assert gc["packed"].dtype == torch.int32
    # bit 31 is the sign bit of the int32; its uint32 view is the JAX layout
    assert np.array_equal(gc["packed"].numpy().view(np.uint32),
                          np.asarray(wc["packed"]))
    for k in ("pos", "length"):
        assert np.array_equal(gc[k].numpy(), np.asarray(wc[k]))


def test_lexsort_is_stable_like_numpy():
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 3, 500) for _ in range(3)]
    want = np.lexsort(keys)
    got = tic.lexsort([torch.from_numpy(k.astype(np.int32)) for k in keys])
    assert np.array_equal(got.numpy(), want)


def test_cumsum_dtype_trouble_spot():
    """torch.cumsum widens int32 unless told otherwise; the port pins it."""
    x = torch.ones(4, dtype=torch.int32)
    assert torch.cumsum(x, 0).dtype == torch.int64
    assert torch.cumsum(x, 0, dtype=torch.int32).dtype == torch.int32


# ---------------------------------------------------------------------------
# cover counts: plain version vs the three JAX-package references
# ---------------------------------------------------------------------------

def _cover_case(seed, n_reads, n_full, n_half):
    """The cases of tests/test_device_parity.py: integral windows plus
    half-integral ones (DUP/INV bias/2)."""
    rng = random.Random(seed)
    starts = np.array([rng.randrange(0, 100_000) for _ in range(n_reads)])
    ends = starts + np.array([rng.randrange(1, 20_000)
                              for _ in range(n_reads)])
    svs = []
    for _ in range(n_full):
        s = rng.randrange(0, 110_000)
        svs.append((max(s - 500, 0), s + 500))
    for _ in range(n_half):
        s = rng.randrange(0, 110_000)
        svs.append((max(s - 250.5, 0), s + 250.5))
    return svs, starts, ends


def test_cover_plain_matches_device_and_host():
    svs, starts, ends = _cover_case(9, 5000, 400, 100)
    got = cover_counts_plain(svs, starts, ends, "cpu")
    assert got.dtype == np.int64
    assert list(got) == list(cover_counts_device(svs, starts, ends))
    assert list(got) == list(jax_host_cover_counts(svs, starts, ends))
    assert list(got) == list(port_host_cover_counts(svs, starts, ends))
    assert list(cover.cover_counts_cuda(svs, starts, ends, "cpu")) == \
        list(got)


def test_cover_plain_matches_pallas_interpret():
    svs, starts, ends = _cover_case(17, 3000, 1500, 100)
    got = cover_counts_plain(svs, starts, ends, "cpu")
    want = cover_counts_pallas(svs, starts, ends, interpret=True)
    assert list(got) == list(want)


@pytest.mark.parametrize("case", ["no windows", "no reads", "both empty"])
def test_cover_empty_inputs(case):
    svs, starts, ends = _cover_case(5, 50, 10, 5)
    if case != "no reads":
        svs = []
    if case != "no windows":
        starts, ends = starts[:0], ends[:0]
    for fn in (cover_counts_plain, cover.cover_counts_cuda):
        got = fn(svs, starts, ends, "cpu")
        assert got.dtype == np.int64 and len(got) == len(svs)
        assert not got.any()
    assert list(cover_counts_device(svs, starts, ends)) == [0] * len(svs)


def test_cover_cpu_wrapper_never_counts_launches():
    svs, starts, ends = _cover_case(11, 200, 20, 5)
    before = cover.LAUNCHES
    cover.cover_tensors(*scaled_tensors(svs, starts, ends, CPU))
    assert cover.LAUNCHES == before


def test_scale_and_pad_half_integral_contract():
    sv_s, sv_e, st, en = scale_and_pad([(10.5, 20.5), (3, 4)], [1, 2],
                                       [30, 40], 4, 4)
    assert list(sv_s) == [21, 6] + [np.iinfo(np.int32).min] * 2
    assert list(sv_e) == [41, 8] + [np.iinfo(np.int32).max] * 2
    assert list(st[:2]) == [2, 4] and list(en[:2]) == [60, 80]


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == CPU
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            cover.cover_counts_cuda([(1, 2)], [0], [5])

