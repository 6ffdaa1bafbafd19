"""Multi-device genotype cover counting (the ``--n_shards`` path).

Splits the SV-window axis over the shard devices with every read on
every device (``cutesv_tpu/parallel/sharded_cover.py``'s layout): one
launch of the CUDA cover kernel per window slice, each on its own card.
"""
from __future__ import annotations

import numpy as np

from cutesv_tpu_torch.ops.sweep import scale_and_pad
from cutesv_tpu_torch.parallel import mesh as pmesh


def make_sharded_cover(n_shards: int, devices):
    """Sharded cover-count callable over ``devices[:n_shards]``, with the
    contract of ``ops/cover.py::cover_counts_cuda`` (windows, read starts,
    read ends -> int64 numpy counts); None when ``devices`` is None (the
    caller counts with the serial kernel)."""
    if devices is None:
        return None
    count = pmesh.sharded_cover_counts(devices[:n_shards])

    def cover(sv_windows, read_starts, read_ends) -> np.ndarray:
        if len(sv_windows) == 0 or len(read_starts) == 0:
            return np.zeros(len(sv_windows), np.int64)
        # unpadded: slice k holds the windows of the JAX program's shard
        # k, and a slice of padding alone would launch for nothing
        arrays = scale_and_pad(sv_windows, read_starts, read_ends, 1, 1)
        return count(*(a.astype(np.int32) for a in arrays)).astype(np.int64)

    return cover
