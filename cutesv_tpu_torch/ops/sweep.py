"""Interval cover counting: the coordinate contract and the plain version.

The genotype read-support count (genotype.py contract)

    cover(sv) = #{primary reads: start <= s and end >= e}

is computed on the device as a dominance count. :func:`scale_and_pad`
is the shared coordinate contract of every implementation;
:func:`cover_counts_plain` is the plain PyTorch version of the CUDA
kernel in ``csrc/cover_count.cu`` (a tiled broadcast compare and sum):
the CPU path of ``ops/cover.py`` and the yardstick the kernel is held
to on the card. :func:`cover_pruned_plain` mirrors the kernel's pruning
(its bins, its int64 ``[e - L, s]`` ranges, its groups of windows and
its long-read arm) as whole-tensor ops, so that the CPU tests can hold that arithmetic
to the plain count; nothing on the main path calls it.
"""
from __future__ import annotations

import numpy as np
import torch

from typing import NamedTuple

from cutesv_tpu_torch.utils.torchsetup import resolve_device

# plain-version tile: at most 2**24 compared pairs (a 16 MB bool mask)
_SV_TILE = 1024
_READ_TILE = 16384

# the pruned kernel's constants (csrc/cover_count.cu, same names there
# without the PRUNE_ prefix)
PRUNE_WINDOWS_PER_GROUP = 64
PRUNE_MIN_BINS = 1024
PRUNE_MAX_BINS = 32768
PRUNE_READS_PER_BIN = 8
PRUNE_LONG_SHIFT = 10
PRUNE_LEN_CLASSES = 33


def scale_and_pad(sv_windows, read_starts, read_ends, sv_multiple,
                  read_multiple):
    """The shared cover-count coordinate contract: windows may be
    half-integral (bias/2), so everything is doubled to stay integral —
    start <= s  <=>  2*start <= floor(2s);  end >= e  <=>  2*end >= ceil(2e)
    — then padded to the given multiples with never-covering sentinels
    (INT32_MIN/MAX). Callers guarantee doubled coordinates fit int32
    (genotype._coord_safe_cover_fn keeps spans under 1e9)."""
    n_sv = len(sv_windows)
    n_reads = len(read_starts)
    s = np.asarray([w[0] for w in sv_windows], np.float64)
    e = np.asarray([w[1] for w in sv_windows], np.float64)
    sp = -(-n_sv // sv_multiple) * sv_multiple
    sv_s = np.full(sp, np.iinfo(np.int32).min, np.int64)
    sv_e = np.full(sp, np.iinfo(np.int32).max, np.int64)
    sv_s[:n_sv] = np.floor(s * 2).astype(np.int64)
    sv_e[:n_sv] = np.ceil(e * 2).astype(np.int64)
    rp = -(-n_reads // read_multiple) * read_multiple
    st = np.full(rp, np.iinfo(np.int32).max, np.int64)
    en = np.full(rp, np.iinfo(np.int32).min, np.int64)
    st[:n_reads] = 2 * np.asarray(read_starts, np.int64)
    en[:n_reads] = 2 * np.asarray(read_ends, np.int64)
    return sv_s, sv_e, st, en


def scaled_tensors(sv_windows, read_starts, read_ends, device):
    """:func:`scale_and_pad` (no padding) as int32 tensors on ``device``."""
    arrays = scale_and_pad(sv_windows, read_starts, read_ends, 1, 1)
    return [torch.from_numpy(a.astype(np.int32)).to(device) for a in arrays]


def cover_plain(sv_s, sv_e, st, en):
    """Plain PyTorch dominance count over doubled int32 coordinates:
    int32 counts per window, tiled so no mask exceeds 2**24 pairs."""
    out = torch.zeros(sv_s.shape[0], dtype=torch.int32, device=sv_s.device)
    for s0 in range(0, sv_s.shape[0], _SV_TILE):
        a = sv_s[s0:s0 + _SV_TILE, None]
        b = sv_e[s0:s0 + _SV_TILE, None]
        acc = out[s0:s0 + _SV_TILE]
        for r0 in range(0, st.shape[0], _READ_TILE):
            m = ((st[None, r0:r0 + _READ_TILE] <= a)
                 & (en[None, r0:r0 + _READ_TILE] >= b))
            acc += m.sum(dim=1, dtype=torch.int32)
    return out


def cover_counts_plain(sv_windows, read_starts, read_ends,
                       device=None) -> np.ndarray:
    """Plain version of the cover-count kernel on ``device``; the
    contract of genotype.cover_counts (int64 numpy counts)."""
    device = resolve_device(device)
    n_sv = len(sv_windows)
    if n_sv == 0 or len(read_starts) == 0:
        return np.zeros(n_sv, np.int64)
    counts = cover_plain(*scaled_tensors(sv_windows, read_starts, read_ends,
                                         device))
    return counts.cpu().numpy().astype(np.int64)


class PrunePlan(NamedTuple):
    """What the kernel derives from the reads before it counts."""
    nb: int              # bins
    lo: int              # least read start
    hi: int              # greatest read start
    shift: int           # bin(x) = (x - lo) >> shift, < nb on [lo, hi]
    short: torch.Tensor  # bool per read; the others form the dense arm
    length: int | None   # L: the largest short end - start (None: none)


def prune_bins(n_reads: int) -> int:
    """The kernel's bin count: a power of two in [PRUNE_MIN_BINS,
    PRUNE_MAX_BINS], about PRUNE_READS_PER_BIN reads a bin."""
    want = -(-n_reads // PRUNE_READS_PER_BIN)
    nb = PRUNE_MIN_BINS
    while nb < PRUNE_MAX_BINS and nb < want:
        nb *= 2
    return nb


def length_class(length: torch.Tensor) -> torch.Tensor:
    """Bit length of each int64 length, 0 where it is <= 0."""
    exponent = torch.frexp(length.double())[1].long()
    return torch.where(length > 0, exponent, torch.zeros_like(exponent))


def prune_plan(st: torch.Tensor, en: torch.Tensor) -> PrunePlan:
    """The kernel's plan for a non-empty set of reads: the dense arm takes
    the fewest top length classes that hold at most n_reads >>
    PRUNE_LONG_SHIFT reads, and L is taken over the rest."""
    n_reads = st.shape[0]
    length = en.long() - st.long()
    nb = prune_bins(n_reads)
    lo, hi = int(st.min()), int(st.max())
    shift = 0
    while (hi - lo) >> shift >= nb:
        shift += 1
    cls = length_class(length)
    counts = torch.bincount(cls, minlength=PRUNE_LEN_CLASSES).tolist()
    limit = n_reads >> PRUNE_LONG_SHIFT
    cut, above = PRUNE_LEN_CLASSES - 1, 0
    while cut > 0 and above + counts[cut] <= limit:
        above += counts[cut]
        cut -= 1
    short = cls <= cut
    longest = int(length[short].max()) if bool(short.any()) else None
    return PrunePlan(nb, lo, hi, shift, short, longest)


def _own_ranges(sv_s, sv_e, plan: PrunePlan):
    """Each window's range of short-read starts, [e - L, s] within
    [lo, hi], in int64, and whether it is empty."""
    if plan.length is None:
        empty = torch.ones(sv_s.shape[0], dtype=torch.bool)
        return sv_s.long(), sv_s.long(), empty
    a = (sv_e.long() - plan.length).clamp(min=plan.lo)
    b = sv_s.long().clamp(max=plan.hi)
    return a, b, a > b


def _pruned_groups(sv_s, sv_e, st, en):
    """The kernel's groups of windows: for each run of
    PRUNE_WINDOWS_PER_GROUP windows in bin order, (their indices, the
    reads the group compares: the short reads of the bins from its least
    range start to its greatest range end, in bin order, then every long
    read)."""
    plan = prune_plan(st, en)

    def bin_of(x):
        return ((x - plan.lo) >> plan.shift).clamp(0, plan.nb - 1)

    short = plan.short.nonzero().flatten()
    rbin = bin_of(st.long()[short])
    in_bins = short[torch.argsort(rbin, stable=True)]
    off = torch.zeros(plan.nb + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(torch.bincount(rbin, minlength=plan.nb), 0)
    dense = (~plan.short).nonzero().flatten()
    a, b, empty = _own_ranges(sv_s, sv_e, plan)
    order = torch.argsort(bin_of(sv_s.long()), stable=True)
    for k in range(0, sv_s.shape[0], PRUNE_WINDOWS_PER_GROUP):
        wins = order[k:k + PRUNE_WINDOWS_PER_GROUP]
        ranged = wins[~empty[wins]]
        reads = in_bins[:0]
        if ranged.numel():
            lo_bin = int(bin_of(a[ranged].min()))
            hi_bin = int(bin_of(b[ranged].max()))
            reads = in_bins[int(off[lo_bin]):int(off[hi_bin + 1])]
        yield wins, torch.cat([reads, dense])


def cover_pruned_plain(sv_s, sv_e, st, en):
    """The kernel's pruned count over doubled int32 coordinates on the
    CPU, as whole-tensor ops per group: int32 counts per window, equal to
    :func:`cover_plain` for any input. Used by tests only."""
    out = torch.zeros(sv_s.shape[0], dtype=torch.int32)
    if sv_s.shape[0] == 0 or st.shape[0] == 0:
        return out
    for wins, reads in _pruned_groups(sv_s, sv_e, st, en):
        m = ((st[None, reads] <= sv_s[wins, None])
             & (en[None, reads] >= sv_e[wins, None]))
        out[wins] = m.sum(dim=1, dtype=torch.int32)
    return out


def pruned_pairs(sv_s, sv_e, st, en) -> tuple:
    """(candidate, compared) pairs for these inputs (CPU tensors): the
    pairs the windows' own ranges hold (short reads whose start lies in
    [e - L, s], counted with numpy's searchsorted, plus every long read
    per window), and the pairs the kernel's groups compare (each group's
    windows times its reads)."""
    n_sv = sv_s.shape[0]
    if n_sv == 0 or st.shape[0] == 0:
        return 0, 0
    plan = prune_plan(st, en)
    n_long = int((~plan.short).sum())
    a, b, empty = (t.numpy() for t in _own_ranges(sv_s, sv_e, plan))
    starts = np.sort(st.numpy()[plan.short.numpy()].astype(np.int64))
    held = (np.searchsorted(starts, b, "right")
            - np.searchsorted(starts, a, "left"))
    candidate = int(held[~empty].sum()) + n_long * n_sv
    compared = sum(len(w) * len(r)
                   for w, r in _pruned_groups(sv_s, sv_e, st, en))
    return candidate, compared
