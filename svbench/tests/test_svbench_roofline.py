"""The benchmark's copy of the cover kernel's byte floor gives
tools/bench_kernels.py's numbers at the main path's launch shapes."""
import pytest

from svbench.roofline import cover_bound_ms


@pytest.mark.parametrize("n_sv,n_reads", [(496, 24_980), (5_804, 126_231),
                                          (7_082, 126_231), (12, 327),
                                          (32_768, 1_500_000)])
def test_cover_floor_equals_bench_kernels(n_sv, n_reads):
    from cutesv_tpu_torch.tools.bench_kernels import cover_bound_ms as theirs
    assert cover_bound_ms(n_sv, n_reads) == theirs(n_sv, n_reads)[0]
