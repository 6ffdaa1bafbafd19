"""The port's DUP/INV/TRA cluster program and resolvers against the JAX
package's, on the CPU.

* ``ops/pair_cluster.py``: random padded streams (no valid row, all rows
  valid, both ``break_on_k2``, TRA-style ``aux`` codes) through
  ``pair_cluster_structure`` and ``compact_pair_outputs`` of both
  packages; every output must be equal (the port's int32 sign-bit
  packing read as uint32 is the JAX layout).
* ``models/device.py``: the DUP/INV streams of
  tests/test_device_parity.py and the TRA cases of
  tests/test_tra_device.py through both packages' device resolvers and
  batched TRA genotype pass; candidate rows must be identical.
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.genotype import ReadTable as JReadTable
from cutesv_tpu.models import device as jdev
from cutesv_tpu.models import host as jhost
from cutesv_tpu.ops import pair_cluster as jpair
from cutesv_tpu.pipeline import _tra_cover_pass as j_tra_cover_pass
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.genotype import ReadTable as TReadTable
from cutesv_tpu_torch.models import device as tdev
from cutesv_tpu_torch.ops import pair_cluster as tpair
from cutesv_tpu_torch.ops.cover import cover_counts_cuda
from cutesv_tpu_torch.pipeline import _tra_cover_pass as t_tra_cover_pass
from tests.test_device_parity import _random_dup_stream, _random_inv_stream
from tests.test_tra_device import _make_sigs, _make_tables

# ---------------------------------------------------------------------------
# the cluster program
# ---------------------------------------------------------------------------


def _random_pair_rows(rng, n_valid, rows, tra_aux):
    """Sorted k1 with gaps around the bias, k2 jittered around per-site
    values, read ids from a small range (so distinct-support ties are
    common); aux either strand-like 0/1 runs or TRA codes chr2*4+type."""
    k1 = np.zeros(rows, np.int32)
    k2 = np.zeros(rows, np.int32)
    aux = np.zeros(rows, np.int32)
    rid = np.zeros(rows, np.int32)
    if n_valid:
        steps = rng.choice([0, 5, 60, 149, 150, 151, 900], n_valid)
        k1[:n_valid] = 1000 + np.cumsum(steps)
        k2[:n_valid] = k1[:n_valid] + rng.choice([300, 450, 2000],
                                                 n_valid) \
            + rng.integers(-200, 200, n_valid)
        if tra_aux:
            aux[:n_valid] = (rng.integers(0, 3, n_valid) * 4
                             + rng.integers(0, 4, n_valid))
        else:
            aux[:n_valid] = np.repeat(rng.integers(0, 2, n_valid // 7 + 1),
                                      7)[:n_valid]
        rid[:n_valid] = rng.integers(0, 12, n_valid)
    return k1, k2, aux, rid


CASES = [  # (seed, n_valid, rows, break_on_k2, tra_aux)
    (0, 0, 256, False, False),           # no valid row
    (1, 0, 256, True, False),
    (2, 256, 256, False, False),         # every row valid
    (3, 1024, 1024, True, False),
    (4, 700, 1024, False, False),
    (5, 700, 1024, True, False),
    (6, 3000, 4096, False, True),        # TRA aux codes
    (7, 4096, 4096, False, True),
    (8, 1, 256, True, False),            # a single row
]


@pytest.mark.parametrize("seed,n_valid,rows,break_on_k2,tra_aux", CASES)
def test_pair_cluster_structure_equals_jax(seed, n_valid, rows, break_on_k2,
                                           tra_aux):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    arrs = _random_pair_rows(rng, n_valid, rows, tra_aux)
    for bias, rc in ((150, 3), (500, 1)):
        want = jpair.pair_cluster_structure(
            *(jnp.asarray(a) for a in arrs), jnp.int32(n_valid),
            jnp.int32(bias), jnp.int32(rc), rows, break_on_k2)
        got = tpair.pair_cluster_structure(
            *(torch.from_numpy(a) for a in arrs), n_valid, bias, rc, rows,
            break_on_k2)
        for k in ("cid", "k1", "k2", "rid", "stream_idx", "n_kept"):
            assert got[k].dtype == torch.int32, k
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        nk = int(want["n_kept"])
        cap = max(nk, 1)
        jp = np.asarray(jpair.compact_pair_outputs(want["cid"],
                                                   want["stream_idx"], cap))
        tp = tpair.compact_pair_outputs(got["cid"], got["stream_idx"], cap)
        assert tp.dtype == torch.int32
        assert np.array_equal(tp.numpy().view(np.uint32), jp)


def test_pair_handles_fetch_like_jax():
    """The three phases of the port's pair resolver (dispatch, compact,
    fetch) give the JAX package's cluster slices, from the raw output or
    the compacted one."""
    sigs = _random_dup_stream(random.Random(11), n_sites=30)
    k1 = [r[0] for r in sigs]
    k2 = [r[1] for r in sigs]
    keys = [r[2] for r in sigs]
    aux = np.zeros(len(sigs), np.int64)
    want = jdev._pair_cluster_slices(k1, k2, aux, keys, 3, 150, False)
    cpu = torch.device("cpu")
    raw = tdev._pair_cluster_start(k1, k2, aux, keys, 3, 150, False, cpu)
    a = tdev._pair_cluster_finish(raw)
    state = ("pending", tdev._pair_cluster_start(k1, k2, aux, keys, 3, 150,
                                                 False, cpu))
    tdev.prefetch_counts(state)
    state = tdev.resolve_pair_compact(state)
    tdev.prefetch_to_host(state)
    b = tdev._pair_cluster_finish(state[1])
    assert len(want) == len(a) == len(b) > 0
    for x, y, z in zip(a, b, want):
        assert x.dtype == np.int64
        assert np.array_equal(x, z) and np.array_equal(y, z)
    assert tdev._pair_cluster_finish(None) == []


# ---------------------------------------------------------------------------
# DUP / INV resolvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_dup_matches_jax(seed):
    sigs = _random_dup_stream(random.Random(300 + seed))
    for action in (False, True):
        want = jdev.resolve_dup_device(sigs, "chr1", 3, 150, 30, 100000,
                                       action)
        got = tdev.resolve_dup_device(sigs, "chr1", 3, 150, 30, 100000,
                                      action, device="cpu")
        assert got == want
        assert got == jhost.resolve_dup(sigs, "chr1", 3, 150, 30, 100000,
                                        action)


@pytest.mark.parametrize("seed", range(5))
def test_inv_matches_jax(seed):
    sigs = _random_inv_stream(random.Random(400 + seed))
    for action in (False, True):
        want = jdev.resolve_inv_device(sigs, "chr1", 3, 150, 30, 100000,
                                       action)
        got = tdev.resolve_inv_device(sigs, "chr1", 3, 150, 30, 100000,
                                      action, device="cpu")
        assert got == want


def test_dup_inv_rank_keys_with_names():
    """Rank-keyed rows (a native store) render their names like JAX."""
    rng = random.Random(77)
    dup = [(a, b, int(n[1:])) for a, b, n in _random_dup_stream(rng)]
    inv = [(s, a, b, int(n[1:])) for s, a, b, n in _random_inv_stream(rng)]
    names = ["q%05d" % i for i in range(500)]
    assert tdev.resolve_dup_device(dup, "c", 3, 150, 30, 100000, True,
                                   names=names, device="cpu") == \
        jdev.resolve_dup_device(dup, "c", 3, 150, 30, 100000, True,
                                names=names)
    assert tdev.resolve_inv_device(inv, "c", 3, 150, 30, 100000, True,
                                   names=names, device="cpu") == \
        jdev.resolve_inv_device(inv, "c", 3, 150, 30, 100000, True,
                                names=names)


def test_empty_pair_streams():
    assert tdev.resolve_dup_device([], "c", 3, 150, 30, 100000, True,
                                   device="cpu") == ([], [])
    assert tdev.resolve_tra_start([], 3, 500, "cpu") is None
    assert tdev.resolve_tra_finish(None, [], "c", 3, 0.6, 500, {}, {}, True,
                                   500) == []


# ---------------------------------------------------------------------------
# TRA: the cluster program + the batched genotype pass
# ---------------------------------------------------------------------------

def _port_tables(tables):
    return {c: TReadTable(t.start, t.end, t.prim, t.names)
            for c, t in tables.items()}


def _both_tra(sigs, tables, lengths, names, rc, ratio, bias, gt_round):
    """The JAX package's device resolver + batched pass, and the port's
    (on the CPU, the batched pass counting through the kernel wrapper's
    plain path); returns both candidate lists and cover stats."""
    jstate = jdev.resolve_tra_start(sigs, rc, bias)
    jjobs = []
    jcands = jdev.resolve_tra_finish(jstate, sigs, "chr1", rc, ratio, bias,
                                     tables, lengths, True, gt_round,
                                     names=names, jobs_out=jjobs)
    jstore = SimpleNamespace(read_tables=tables, chrom_lengths=lengths,
                             names=names, census={})
    j_tra_cover_pass({"chr1": (jcands, jjobs)}, jstore,
                     JConfig(engine="host", gt_round=gt_round,
                             max_cluster_bias_TRA=bias, min_support=rc))

    ttables = _port_tables(tables)
    state = tdev.resolve_tra_start(sigs, rc, bias, "cpu")
    tdev.prefetch_counts(state)
    state = tdev.resolve_tra_compact(state)
    tdev.prefetch_to_host(state)
    tjobs = []
    tcands = tdev.resolve_tra_finish(state, sigs, "chr1", rc, ratio, bias,
                                     ttables, lengths, True, gt_round,
                                     names=names, jobs_out=tjobs)
    tstore = SimpleNamespace(read_tables=ttables, chrom_lengths=lengths,
                             names=names, census={})
    calls = []

    def cover(w, s, e):
        calls.append((len(w), len(s), int(max(b for _, b in w))))
        return cover_counts_cuda(w, s, e, device="cpu")

    t_tra_cover_pass({"chr1": (tcands, tjobs)}, tstore,
                     TConfig(gt_round=gt_round, max_cluster_bias_TRA=bias,
                             min_support=rc), cover)
    for _, _, hi in calls:
        assert 2 * hi < 2 ** 31   # doubled coordinates fit int32
    return jcands, tcands, jstore.tra_cover_stats, tstore.tra_cover_stats


@pytest.mark.parametrize("seed,gt_round,dup_name", [
    (1, 500, False),    # fast path everywhere
    (2, 3, False),      # tiny gt_round: the iteration cap fires -> replay
    (3, 500, True),     # ambiguous primary names -> full replay
    (4, 10, False),
    (5, 2, True),
])
def test_tra_batched_cover_equals_jax(seed, gt_round, dup_name):
    rng = np.random.default_rng(seed)
    lengths = {"chr1": 2_000_000, "chr2": 1_500_000}
    tables, n_names = _make_tables(rng, lengths, 400, dup_name=dup_name)
    sigs = _make_sigs(rng, lengths, 12, 6, n_names)
    names = ["r%06d" % i for i in range(n_names)]
    jc, tc, js, ts = _both_tra(sigs, tables, lengths, names, 3, 0.6, 5_000,
                               gt_round)
    assert tc == jc
    assert ts == js
    inline = jhost.resolve_tra(sigs, "chr1", 3, 0.6, 5_000, tables, lengths,
                               True, gt_round, names=names)
    assert tc == inline and len(tc) > 0


def test_tra_device_no_action_equals_jax():
    rng = np.random.default_rng(7)
    lengths = {"chr1": 2_000_000, "chr2": 1_500_000}
    tables, n_names = _make_tables(rng, lengths, 100)
    sigs = _make_sigs(rng, lengths, 8, 5, n_names)
    names = ["r%06d" % i for i in range(n_names)]
    want = jdev.resolve_tra_device(sigs, "chr1", 3, 0.6, 5_000, tables,
                                   lengths, False, 500, names=names)
    got = tdev.resolve_tra_device(sigs, "chr1", 3, 0.6, 5_000,
                                  _port_tables(tables), lengths, False, 500,
                                  names=names, device="cpu")
    assert got == want and len(got) > 0


def test_tra_secondary_pileup_replays_like_jax():
    """40 secondaries before the one primary of a window: the gt_round cap
    can fire, so both packages must replay, not fast-path."""
    lengths = {"chr1": 1_000_000, "chr2": 1_000_000}
    n_sec = 40
    t1 = JReadTable(np.array([49_000 + i for i in range(n_sec)] + [48_500]),
                   np.array([52_000 + i for i in range(n_sec)] + [56_000]),
                   np.array([0] * n_sec + [1], np.int8),
                   np.array(list(range(n_sec + 1)), np.int64))
    t2 = JReadTable(np.array([58_000, 59_000]), np.array([62_000, 63_000]),
                   np.array([1, 1], np.int8), np.array([100, 101], np.int64))
    sigs = sorted([("A", 50_000 + i, "chr2", 60_000 + i, 200 + i)
                   for i in range(5)],
                  key=lambda r: (r[2], r[0], r[1], r[3], r[4]))
    names = ["r%03d" % i for i in range(300)]
    jc, tc, js, ts = _both_tra(sigs, {"chr1": t1, "chr2": t2}, lengths,
                               names, 3, 0.6, 1_000, 5)
    assert tc == jc and len(tc) >= 1
    assert ts == js and ts["replay"] >= 1


def test_tra_missing_mate_chrom_equals_jax():
    """SA-tag contig absent from the header: call_gt_tra's degraded
    genotype, as in JAX."""
    rng = np.random.default_rng(11)
    lengths = {"chr1": 2_000_000}
    tables, n_names = _make_tables(rng, lengths, 100)
    names = ["r%06d" % i for i in range(n_names)]
    sigs = sorted([("A", 50_000 + i, "chrUn", 70_000 + i, i % n_names)
                   for i in range(8)],
                  key=lambda r: (r[2], r[0], r[1], r[3], r[4]))
    jc, tc, js, ts = _both_tra(sigs, tables, lengths, names, 3, 0.6, 5_000,
                               500)
    assert tc == jc and len(tc) >= 1
    assert tc[0][7] == "./." and ts == js
