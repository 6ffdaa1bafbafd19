"""The yardstick's peaks and floors.

The H100's published HBM rate (NVIDIA's data sheet, SXM part, at the
full 700 W power limit) and the least time the card could take to
compute the genotype layer's cover count, whatever kernel computes it:
a copy of ``cutesv_tpu_torch/tools/bench_kernels.py::cover_bound_ms``.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def cover_bound_ms(n_sv: int, n_reads: int) -> float:
    """Each input read once (two int32 per window and per read) and each
    int32 count written once, over the HBM rate, in ms."""
    return 4 * (3 * n_sv + 2 * n_reads) / HBM_BYTES_PER_S * 1e3
