"""Segmented-array primitives shared by the cluster programs (tensors).

PyTorch counterparts of ``cutesv_tpu/ops/segments.py``, with the JAX
semantics kept exactly: the dtype of ``values`` is the dtype of the
result (no int64 widening), and an empty segment of ``seg_min`` holds
INT32_MAX, the identity ``jax.ops.segment_min`` gives it.
"""
from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def padded_size(n: int, minimum: int = 256, factor: int = 4) -> int:
    """Round up on a coarse geometric ladder so a run sees few distinct
    shapes (few allocator block sizes, and sizes shared with the JAX
    package so both pad alike)."""
    size = minimum
    while size < n:
        size *= factor
    return size


def boundary_flags(*keys, valid):
    """True where any key differs from the previous row (row 0 = False).

    Padded/invalid rows never open segments."""
    flags = torch.zeros_like(valid)
    for k in keys:
        prev = torch.cat([k[:1], k[:-1]])
        flags = flags | (k != prev)
    flags[:1].fill_(False)   # a fill, not a host copy: capturable
    return flags & valid


def seg_sum(values, ids, num):
    """``jax.ops.segment_sum`` over ``num`` segments, in ``values.dtype``."""
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.scatter_add_(0, ids.long(), values)


def seg_min(values, ids, num):
    """``jax.ops.segment_min`` for int32 values: empty segments hold
    INT32_MAX (the base the ``amin`` reduction starts from)."""
    out = torch.full((num,), INT32_MAX, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, ids.long(), values, "amin",
                               include_self=True)
