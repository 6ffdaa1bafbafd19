"""The port's DEL/INS device resolvers against the JAX package's, on the
CPU: the randomized signature streams of tests/test_device_parity.py go
through both engines, and candidate rows and genotype jobs must be
identical."""
import random

import numpy as np
import pytest

from cutesv_tpu.models import device as jdev
from cutesv_tpu_torch.models import device as tdev
from cutesv_tpu_torch.sigstore import drop_sentinel_rows
from tests.test_device_parity import _random_del_stream, _random_ins_stream


def _port_multi(streams, is_ins, read_count, ratio, bias, min_sup):
    """The three phases of the port's genome-batched resolver, as the
    pipeline runs them."""
    state = tdev.resolve_indel_multi_start(streams, is_ins, read_count, bias,
                                           "cpu")
    tdev.prefetch_counts(state)
    tdev.resolve_indel_multi_compact(state)
    tdev.prefetch_to_host(state)
    return tdev.resolve_indel_multi_finish(state, ratio, min_sup, 1.0, True)


def _same(a, b):
    (ca, ja), (cb, jb) = a, b
    assert ca == cb
    assert [j["window"] for j in ja] == [j["window"] for j in jb]
    assert [j["support"] for j in ja] == [j["support"] for j in jb]


@pytest.mark.parametrize("seed", range(6))
def test_del_matches_jax(seed):
    sigs = _random_del_stream(random.Random(seed))
    for action in (False, True):
        _same(jdev.resolve_del_device(sigs, "chr1", 4, 0.5, 200, 4, 1.0,
                                      action),
              tdev.resolve_del_device(sigs, "chr1", 4, 0.5, 200, 4, 1.0,
                                      action, device="cpu"))


@pytest.mark.parametrize("seed", range(6))
def test_ins_matches_jax(seed):
    sigs = _random_ins_stream(random.Random(100 + seed))
    for action in (False, True):
        _same(jdev.resolve_ins_device(sigs, "chr1", 4, 0.3, 100, 4, 1.0,
                                      action),
              tdev.resolve_ins_device(sigs, "chr1", 4, 0.3, 100, 4, 1.0,
                                      action, device="cpu"))


@pytest.mark.parametrize("seed", range(4))
def test_del_remain_ratio_matches_jax(seed):
    sigs = _random_del_stream(random.Random(200 + seed))
    _same(jdev.resolve_del_device(sigs, "chr1", 3, 0.5, 200, 3, 0.6, True),
          tdev.resolve_del_device(sigs, "chr1", 3, 0.5, 200, 3, 0.6, True,
                                  device="cpu"))


def test_empty_and_unsupported_streams():
    assert tdev.resolve_del_device([], "chr1", 3, 0.5, 200, 3, 1.0, True,
                                   device="cpu") == ([], [])
    # one read only: nothing passes a support gate of 3
    rows = [(1000, 50, "a"), (1010, 52, "a"), (1020, 49, "a")]
    _same(jdev.resolve_del_device(rows, "c", 3, 0.5, 200, 3, 1.0, True),
          tdev.resolve_del_device(rows, "c", 3, 0.5, 200, 3, 1.0, True,
                                  device="cpu"))


@pytest.mark.parametrize("seed", range(4))
def test_multi_chrom_del_matches_jax(seed):
    """Genome-batched DEL resolution over many chromosomes."""
    rng = random.Random(500 + seed)
    streams = [(c, _random_del_stream(rng, n_sites=10))
               for c in ["chr1", "chr2", "chr3", "chrX"]]
    want = jdev.resolve_indel_device_multi(streams, False, 3, 0.5, 200, 3,
                                           1.0, True)
    got = _port_multi(streams, False, 3, 0.5, 200, 3)
    assert set(got) == set(want)
    for c in want:
        _same(want[c], got[c])


def test_multi_chrom_ins_matches_jax():
    rng = random.Random(600)
    streams = [(c, _random_ins_stream(rng, n_sites=8))
               for c in ["a", "b", "c"]]
    want = jdev.resolve_indel_device_multi(streams, True, 3, 0.3, 100, 3,
                                           1.0, True)
    got = _port_multi(streams, True, 3, 0.3, 100, 3)
    assert set(got) == set(want)
    for c in want:
        _same(want[c], got[c])


def test_multi_chrom_with_empty_chromosome():
    rng = random.Random(601)
    streams = [("a", _random_del_stream(rng, n_sites=5)), ("b", []),
               ("c", _random_del_stream(rng, n_sites=5))]
    want = jdev.resolve_indel_device_multi(streams, False, 3, 0.5, 200, 3,
                                           1.0, True)
    got = _port_multi(streams, False, 3, 0.5, 200, 3)
    assert got["b"] == ([], [])
    for c in want:
        _same(want[c], got[c])


def test_fetch_from_raw_or_compacted_handle():
    """The finish phase accepts the raw program output or its compacted
    form; both give the JAX package's kept rows."""
    sigs = _random_del_stream(random.Random(7))
    stream = tdev.IndelStream.from_tuples(sigs, False)
    raw = tdev._cluster_stream_dispatch(stream, 4, 200, tdev.resolve_device(
        "cpu"))
    a = tdev._cluster_stream_fetch(raw)
    b = tdev._cluster_stream_fetch(tdev._cluster_stream_compact(
        tdev._cluster_stream_dispatch(stream, 4, 200,
                                      tdev.resolve_device("cpu"))))
    want = jdev._cluster_stream(jdev.IndelStream.from_tuples(sigs, False), 4,
                                200)
    for x, y, z in zip(a, b, want):
        assert x.dtype == np.int64
        assert np.array_equal(x, z) and np.array_equal(y, z)


def test_indel_stream_select_and_sentinel_filter():
    names = ["ra", "rb", "rc"]
    s = tdev.IndelStream.from_arrays([0, 50, 90], [0, 40, 41], [0, 1, 2],
                                     names)
    out = drop_sentinel_rows("DEL", s)
    assert list(out.pos) == [50, 90] and list(out.rid) == [1, 2]
    assert out.names_of(np.array([0, 1])) == ["rb", "rc"]
    rows = [(0, 0, "ra", ""), (70, 33, "rb", "A" * 33)]
    t = tdev.IndelStream.from_tuples(rows, is_ins=True)
    out2 = drop_sentinel_rows("INS", t)
    assert list(out2.pos) == [70] and out2.seq_of(0) == "A" * 33
    assert out2.tuples() == [rows[1]]
