"""Cover count on the GPU: wrapper of the CUDA kernel csrc/cover_count.cu.

Counts, per SV window [s, e), the reads with start <= s and end >= e —
the genotype read-support count (genotype.cover_counts contract), with
the contract of ``cutesv_tpu/ops/pallas_sweep.py::cover_counts_pallas``.
On a CUDA device the wrapper launches the hand-written kernel (one
cooperative launch that bins the reads and windows on the card and
compares each window only with the reads that can cover it, on a scratch
buffer from torch's allocator) or raises; only a CPU device takes the
plain PyTorch version (ops/sweep.py).
"""
from __future__ import annotations

import numpy as np
import torch

from cutesv_tpu_torch.ops import build
from cutesv_tpu_torch.ops.sweep import cover_plain, scaled_tensors
from cutesv_tpu_torch.utils.torchsetup import resolve_device

# kernel launches made by launch(), and the (windows, reads) shape of the
# last one (read by chip_smoke.py to show that the main path went through
# the kernel, and at which shape)
LAUNCHES = 0
LAST_SHAPE = (0, 0)
# the kernel's phases after its zeroing (csrc/cover_count.cu), in order
PHASES = ("stats", "hist", "scan", "scatter", "ranges", "count")


def cover_tensors(sv_s, sv_e, st, en):
    """int32 cover counts over doubled int32 coordinates (1-D contiguous
    tensors). CUDA tensors launch the kernel (one launch: its passes over
    all windows and reads, on a scratch buffer from torch's allocator);
    CPU tensors use the plain version."""
    if sv_s.device.type == "cpu":
        return cover_plain(sv_s, sv_e, st, en)
    for t in (sv_s, sv_e, st, en):
        if t.device != sv_s.device or t.dtype != torch.int32 \
                or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("cover kernel takes contiguous 1-D int32 "
                             "tensors on one device")
    if sv_e.shape != sv_s.shape or en.shape != st.shape:
        raise ValueError("window / read arrays differ in length")
    n_sv, n_reads = sv_s.shape[0], st.shape[0]
    if max(n_sv, n_reads) >= 2**30:
        raise ValueError("cover kernel counts fewer than 2**30 windows "
                         "and reads per call")
    out = torch.zeros(n_sv, dtype=torch.int32, device=sv_s.device)
    if n_sv == 0 or n_reads == 0:
        return out
    return launch(sv_s, sv_e, st, en, out, scratch(n_sv, n_reads,
                                                    sv_s.device))


def scratch(n_sv: int, n_reads: int, device) -> torch.Tensor:
    """The kernel's scratch buffer for these sizes (read bins, window bins,
    their offsets and the binned copies), from torch's allocator on the
    current stream of ``device``."""
    nbytes = build.library().cutesv_cover_scratch_bytes(n_sv, n_reads)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def phase_us(buf: torch.Tensor) -> dict:
    """Device microseconds of each phase of the last launch on ``buf``:
    the kernel writes the device clock (ns) after its zeroing and at the
    end of each phase into the scratch's first bytes. Read it once that
    launch has finished."""
    t = buf[:8 * (len(PHASES) + 1)].view(torch.int64).cpu().tolist()
    return {name: (t[k + 1] - t[k]) / 1e3 for k, name in enumerate(PHASES)}


def launch(sv_s, sv_e, st, en, out, buf):
    """One kernel launch on the current stream that ADDS the counts into
    ``out`` (zeroed by the caller), using ``buf`` from :func:`scratch`;
    the inputs are checked by :func:`cover_tensors`, which is what callers
    use."""
    global LAUNCHES, LAST_SHAPE
    lib = build.library()
    with torch.cuda.device(sv_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cutesv_cover_count(
            sv_s.data_ptr(), sv_e.data_ptr(), sv_s.shape[0], st.data_ptr(),
            en.data_ptr(), st.shape[0], buf.data_ptr(), buf.numel(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cover_count kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES += 1
    LAST_SHAPE = (sv_s.shape[0], st.shape[0])
    return out


def cover_counts_cuda(sv_windows, read_starts, read_ends,
                      device=None) -> np.ndarray:
    """Drop-in for genotype.cover_counts on ``device`` (int64 numpy
    counts): the kernel on a CUDA device, the plain version on the CPU.
    The host doubles the coordinates (scale_and_pad); callers keep
    doubled coordinates inside int32 (genotype._coord_safe_cover_fn)."""
    device = resolve_device(device)
    n_sv = len(sv_windows)
    if n_sv == 0 or len(read_starts) == 0:
        return np.zeros(n_sv, np.int64)
    counts = cover_tensors(*scaled_tensors(sv_windows, read_starts,
                                           read_ends, device))
    return counts.cpu().numpy().astype(np.int64)
