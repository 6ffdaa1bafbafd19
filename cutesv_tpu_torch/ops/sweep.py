"""Interval cover counting: the coordinate contract and the plain version.

The genotype read-support count (genotype.py contract)

    cover(sv) = #{primary reads: start <= s and end >= e}

is computed on the device as a dominance count. :func:`scale_and_pad`
is the shared coordinate contract of every implementation;
:func:`cover_counts_plain` is the plain PyTorch version of the CUDA
kernel in ``csrc/cover_count.cu`` (a tiled broadcast compare and sum):
the CPU path of ``ops/cover.py`` and the yardstick the kernel is held
to on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from cutesv_tpu_torch.utils.torchsetup import resolve_device

# plain-version tile: at most 2**24 compared pairs (a 16 MB bool mask)
_SV_TILE = 1024
_READ_TILE = 16384


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
