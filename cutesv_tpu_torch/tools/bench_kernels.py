"""Kernel benchmark of the port: the device programs, the cover kernel
and the BGZF inflate kernel against rooflines measured on the same card
in the same run.

The port's counterpart of the repo's root ``tools/bench_kernels.py``. It
measures the three device programs the pipeline dispatches, at realistic
volume (2**20 signature rows, 2**20 census rows and 2**15 genotype
windows by default):

  * the DEL/INS cluster program (``ops/indel_cluster.py``) and the
    DUP/INV pair program (``ops/pair_cluster.py``) on the root tool's
    synthetic stream (:func:`make_indel_stream`, bit-equal arrays), in
    rows/s and bytes/s, each stated against the sort roofline: both
    programs are a few stable sorts plus segment reductions;
  * the cover count (``csrc/cover_count.cu``): end to end through
    ``ops/cover.py::cover_counts_cuda``, and that call's four parts
    timed one by one (the host's scaling, the upload, the wrapper's
    kernel call, the fetch), and the bare kernel (``cover.launch`` on
    resident tensors and a preallocated scratch buffer); in (window,
    read) pairs answered per second (S * R / s, whatever the kernel
    compares), against the byte floor of the count (``cover_bound_ms``)
    and beside the all-pairs operations bound (``dense_bound_ms``), with
    the candidate pairs the pruned ranges hold and the pairs the
    kernel's groups of windows compare (``ops/sweep.py::pruned_pairs``).

  * the BGZF inflate (``csrc/bgzf_inflate.cu``): the bare kernel over one
    batch of the decoder's size (``N_BLOCKS`` blocks of a simulated HiFi
    BAM's records, cut and compressed as the benchmark's corpus is, or a
    given BAM's first blocks), against its byte floor, beside zlib's time
    on one host core for the same blocks and the batch's copies up and
    down through pinned memory (the decoder's floor on the card), and
    held to zlib's bytes. The simulated reads carry no base qualities
    (QUAL is 0xFF), which deflate codes as long matches; a second batch
    (``inflate_phred``) gives them Phred qualities (``PHRED``) and
    compresses at zlib's default level, as BAM writers do, cut where the
    decoder cuts a batch (``CARD_IN_CAP`` compressed bytes);

and two rooflines:

  * stream: ``STREAM_PASSES`` dependent elementwise passes over a 128 MB
    int32 matrix, each written into a preallocated contiguous buffer
    (eager PyTorch fuses nothing, so each pass reads and writes the whole
    matrix; the closing sum reads it once more), in bytes/s, also stated
    against the published 3.35 TB/s;
  * sort: ``SORT_PASSES`` dependent two-key stable sorts (``lexsort``:
    chained ``torch.sort(stable=True)``, least significant key first, as
    the programs sort), in rows/s per sort.

Timing: every rep gets a fresh input (one value varied), and each rep's
full output is reduced on the device to a sum that depends on it, read
back to the host inside the timed window (the proof that the rep ran).
A window of reps is timed between CUDA events (the host clock on the
CPU); the best of 3 windows counts. ``rtt_s``, the cost of that pattern
on a trivial computation (the event pair and one readback per rep), is
subtracted from the rooflines, the programs and the bare kernel. The
end-to-end cover is timed on the host clock (its counts come back to
the host).

    python -m cutesv_tpu_torch.tools.bench_kernels [--device cuda]

Sizes come from ``KBENCH_REPS``, ``KBENCH_ROWS``, ``KBENCH_READS``,
``KBENCH_SV`` and ``KBENCH_BLOCKS``. Prints one JSON line. It names the
device and the card (``nvidia-smi`` name and power limit); on a CPU
device (the tests) they say ``cpu``, and no number of such a run is a
device figure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import tempfile
import time
import zlib

import numpy as np
import torch

from cutesv_tpu_torch.ops import cover, inflate
from cutesv_tpu_torch.ops.indel_cluster import (indel_cluster_structure,
                                                lexsort)
from cutesv_tpu_torch.ops.pair_cluster import pair_cluster_structure
from cutesv_tpu_torch.ops.sweep import (cover_plain, pruned_pairs,
                                        scale_and_pad)
from cutesv_tpu_torch.utils.torchsetup import resolve_device

REPS = int(os.environ.get("KBENCH_REPS", "8"))
N_ROWS = int(os.environ.get("KBENCH_ROWS", str(1 << 20)))
N_READS = int(os.environ.get("KBENCH_READS", str(1 << 20)))
N_SV = int(os.environ.get("KBENCH_SV", str(1 << 15)))
# a batch of the decoder's card back end (csrc/bgzf_inflate.cu MAX_BLOCKS)
N_BLOCKS = int(os.environ.get("KBENCH_BLOCKS", "384"))
BGZF_BLOCK = 0xFF00  # the input bytes of a BGZF block (htslib's and the
                     # benchmark corpus's)
CARD_IN_CAP = 4 << 20  # compressed bytes a batch (csrc/bgzf_inflate.cu)
# the inflate's quality batch: Phred values drawn from a normal of this
# mean and deviation, rounded and clipped to [2, 60] (~5 bits a base; a
# stand-in with no sourced profile behind it), compressed at zlib level 6
PHRED = (30.0, 8.0)
PHRED_LEVEL = 6

STREAM_BYTES = 128 << 20
STREAM_PASSES = 16
SORT_PASSES = 4

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM; 67 TFLOP/s float32
# outside the tensor cores = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. An
# SM issues at most one 32-bit integer operation per lane and clock (64 on
# the ALU pipe, 64 more as IMAD on the FMA pipe): 132 x 128 x 1.98e9 =
# 33.5e12 int32 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# two compares and the add; the AND folds into the second compare's
# predicate input (ISETP ... P0), so it is not an operation of its own
OPS_PER_PAIR = 3


def cover_bound_ms(n_sv: int, n_reads: int) -> tuple:
    """The least time the card could take to count ``n_sv`` windows over
    ``n_reads`` reads, whatever computes the count, in ms, and what bounds
    it ("bytes"): each input read once (two int32 per window and per read)
    and each int32 count written once, over the HBM rate."""
    return 4 * (3 * n_sv + 2 * n_reads) / HBM_BYTES_PER_S * 1e3, "bytes"


def dense_bound_ms(n_sv: int, n_reads: int) -> tuple:
    """The bound of the all-pairs formulation (the kernel's earlier
    design), in ms, and what bounds it: every (window, read) pair's
    operations over the int32 rate, against the byte floor of
    :func:`cover_bound_ms`."""
    ops_s = OPS_PER_PAIR * n_sv * n_reads / INT32_OPS_PER_S
    bytes_ms = cover_bound_ms(n_sv, n_reads)[0]
    return (max(ops_s * 1e3, bytes_ms),
            "operations" if ops_s * 1e3 >= bytes_ms else "bytes")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def _timed(step, device: torch.device, reps: int) -> float:
    """Per-rep seconds of ``step(i)`` -> a 0-d tensor that depends on
    the rep's full output. Warm on i=0, then 3 windows of ``reps``
    distinct calls, each read back to the host inside the window; the
    best window."""
    step(0).item()
    best = float("inf")
    for w in range(3):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(reps):
                step(1 + w * reps + i).item()
            b.record()
            b.synchronize()
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for i in range(reps):
                step(1 + w * reps + i).item()
            dt = time.perf_counter() - t0
        best = min(best, dt / reps)
    return best


def _checksum(out: dict) -> torch.Tensor:
    """int64 sum over every tensor of a program's output dict."""
    return sum(v.sum(dtype=torch.int64) for v in out.values())


def bench_rtt(device: torch.device, reps: int) -> float:
    """The timing pattern's own cost per rep: a trivial computation on 8
    elements, read back."""
    x = torch.arange(8, dtype=torch.int32, device=device)
    return _timed(lambda i: (x + i).sum(), device, reps)


def bench_stream_roofline(nbytes: int, device: torch.device, rtt: float,
                          reps: int) -> float:
    """Bytes/s of ``STREAM_PASSES`` dependent passes over an int32 matrix
    of ``nbytes``, each a read and a write of the whole matrix, plus the
    closing sum's read."""
    side = int(np.sqrt(nbytes // 4))
    x = torch.arange(side * side, dtype=torch.int32,
                     device=device).reshape(side, side)
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def step(i):
        src = x
        for k in range(STREAM_PASSES):
            dst = bufs[k % 2]
            torch.add(src, i + k, out=dst)
            src = dst
        return src.sum(dtype=torch.int64)

    dt = max(_timed(step, device, reps) - rtt, 1e-9)
    return (2 * STREAM_PASSES + 1) * side * side * 4 / dt


def bench_sort_roofline(n: int, device: torch.device, rtt: float,
                        reps: int) -> float:
    """Rows/s of one two-key stable sort at ``n`` rows, from
    ``SORT_PASSES`` dependent sorts per rep (each pass keys on the last
    pass's order); the readback weights each row by its place."""
    rng = np.random.default_rng(0)
    k1 = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)
                          ).to(device)
    k2 = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)
                          ).to(device)
    place = torch.arange(n, dtype=torch.int64, device=device)

    def step(i):
        a, b = k1, k2
        for k in range(SORT_PASSES):
            perm = lexsort((b, a ^ (i + k)))
            a, b = a[perm], b[perm]
        return (a.to(torch.int64) * place).sum()

    dt = max(_timed(step, device, reps) - rtt, 1e-9) / SORT_PASSES
    return n / dt


def make_indel_stream(n, seed=0):
    rng = np.random.default_rng(seed)
    n_loci = max(1, n // 40)
    loci = np.sort(rng.integers(0, 200_000_000, size=n_loci))
    pos = np.sort(loci[rng.integers(0, n_loci, size=n)]
                  + rng.integers(-60, 60, size=n)).astype(np.int32)
    length = rng.integers(30, 5000, size=n).astype(np.int32)
    rid = rng.integers(0, n // 4, size=n).astype(np.int32)
    return pos, length, rid


def indel_step(n: int, device: torch.device):
    """One rep of the DEL/INS program on the root tool's stream: ``i`` ->
    the output dict of the call on positions shifted by ``i``."""
    pos, length, rid = (torch.from_numpy(a).to(device)
                        for a in make_indel_stream(n))
    return lambda i: indel_cluster_structure(pos + i, length, rid, n - 64,
                                             200, 10, n)


def pair_step(n: int, device: torch.device):
    """One rep of the pair program (DUP form) on the root tool's stream
    (seed 1): k1 = pos, k2 = pos + length, both shifted by ``i``."""
    pos, length, rid = make_indel_stream(n, seed=1)
    k1, k2, aux, rid = (torch.from_numpy(a).to(device) for a in (
        pos, pos + length, np.zeros(n, np.int32), rid))
    return lambda i: pair_cluster_structure(k1 + i, k2 + i, aux, rid, n - 64,
                                            200, 10, n, False)


def _program(step, n: int, row_bytes: int, device: torch.device,
             rtt: float, reps: int) -> dict:
    dt = max(_timed(lambda i: _checksum(step(i)), device, reps) - rtt, 1e-9)
    return {"rows": n, "s": dt, "rows_per_s": n / dt,
            "bytes_per_s": row_bytes * n / dt}


def cover_inputs(n_sv: int, n_reads: int):
    """The root tool's cover inputs: sorted window starts and read spans
    of 5-25 kb over 200 Mb."""
    rng = np.random.default_rng(2)
    starts = np.sort(rng.integers(0, 200_000_000, n_reads))
    ends = starts + rng.integers(5_000, 25_000, n_reads)
    s = np.sort(rng.integers(0, 200_000_000, n_sv))
    return s, starts, ends


def cover_windows(s: np.ndarray, i: int) -> list:
    """Rep ``i``'s windows: [s + i, s + i + 2000) for every start."""
    return list(zip((s + i).astype(float), (s + i + 2000).astype(float)))


def _host_best(fn, device: torch.device, n: int = 2):
    """Best host-clock seconds of ``n`` calls of ``fn()`` after a warm one,
    each ending in a synchronize on a card, and the last result."""
    out = fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_cover(n_sv: int, n_reads: int, device: torch.device, rtt: float,
                reps: int) -> dict:
    """The cover count end to end (best of 2 calls after a warm one, host
    clock), its parts one by one (host scaling, upload, the wrapper's
    kernel call, fetch; host clock, each synchronized), and the bare
    kernel on resident tensors (the plain version on a CPU device),
    against the byte floor and beside the all-pairs bound."""
    s, starts, ends = cover_inputs(n_sv, n_reads)
    pairs = float(n_sv) * n_reads

    def e2e(i):
        return cover.cover_counts_cuda(cover_windows(s, i), starts, ends,
                                       device)

    best, _ = _host_best(lambda: e2e(1), device)
    wins = cover_windows(s, 0)
    scale_s, arrays = _host_best(
        lambda: [a.astype(np.int32) for a in scale_and_pad(
            wins, starts, ends, 1, 1)], device)
    upload_s, tens = _host_best(
        lambda: [torch.from_numpy(a).to(device) for a in arrays], device)
    kernel_s, counts = _host_best(lambda: cover.cover_tensors(*tens),
                                  device)
    fetch_s, _ = _host_best(
        lambda: counts.cpu().numpy().astype(np.int64), device)
    sv_s, sv_e, st, en = tens
    out = torch.zeros(n_sv, dtype=torch.int32, device=device)
    buf = (cover.scratch(n_sv, n_reads, device) if device.type == "cuda"
           else None)

    def bare(i):
        if device.type == "cpu":
            return cover_plain(sv_s + i, sv_e + i, st, en).sum(
                dtype=torch.int64)
        out.zero_()
        return cover.launch(sv_s + i, sv_e + i, st, en, out, buf).sum(
            dtype=torch.int64)

    bare_s = max(_timed(bare, device, reps) - rtt, 1e-9)
    bound_ms, bound_by = cover_bound_ms(n_sv, n_reads)
    candidate, compared = pruned_pairs(*(t.cpu() for t in tens))
    return {"n_sv": n_sv, "n_reads": n_reads, "s": best,
            "pairs_per_s": pairs / best, "bare_s": bare_s,
            "bare_pairs_per_s": pairs / bare_s, "scale_s": scale_s,
            "upload_s": upload_s, "kernel_s": kernel_s, "fetch_s": fetch_s,
            "candidate_pairs": candidate, "compared_pairs": compared,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_bound_ms(n_sv, n_reads)[0],
            "efficiency_vs_bound": bound_ms / 1e3 / best,
            "bare_efficiency_vs_bound": bound_ms / 1e3 / bare_s}


def with_phred(raw: bytes, seed: int = 11) -> bytes:
    """``raw``, a BAM's inflated bytes from its start (the last record may
    be cut), with every record's QUAL drawn from ``PHRED``."""
    buf = bytearray(raw)
    rng = np.random.default_rng(seed)

    def i32(p):
        return int.from_bytes(buf[p:p + 4], "little")

    p = 8 + i32(4)                          # magic, l_text, text
    n_ref, p = i32(p), p + 4
    for _ in range(n_ref):                  # l_name, name, l_ref
        p += 8 + i32(p)
    while p + 36 <= len(buf):
        l_seq = i32(p + 20)
        q = (p + 36 + buf[p + 12] + 4 * int.from_bytes(buf[p + 16:p + 18],
                                                       "little")
             + (l_seq + 1) // 2)
        n = max(0, min(l_seq, len(buf) - q))
        buf[q:q + n] = np.clip(np.rint(rng.normal(*PHRED, n)), 2,
                               60).astype(np.uint8).tobytes()
        p += 4 + i32(p)
    return bytes(buf)


def inflate_inputs(n_blocks: int, path: str = None,
                   phred: bool = False) -> tuple:
    """A batch of ``n_blocks`` BGZF blocks: ``path``'s first blocks as
    they are, or a simulated HiFi BAM's records cut into 0xFF00-byte
    blocks at zlib level 1 (as the benchmark's corpus writes them); with
    ``phred`` the records get Phred qualities (:func:`with_phred`) and
    the blocks zlib level ``PHRED_LEVEL``, and the batch ends where its
    compressed bytes would pass ``CARD_IN_CAP``. Returns (src, meta,
    zlib's output) with the payloads packed at 4-byte boundaries."""
    from cutesv_tpu_torch.tools.simulate import simulate

    if path is None:
        with tempfile.TemporaryDirectory() as tmp:
            # ~1.5 bytes a base: enough records for the batch
            mb = max(1.0, n_blocks * BGZF_BLOCK / 1.5 / 5 / 1e6 * 1.2)
            sim = simulate(os.path.join(tmp, "k"), genome_mb=mb, n_chroms=1,
                           coverage=5, read_len=15_000, seed=11)
            raw, _ = inflate.inflate_plain(*inflate.bgzf_batch(sim["bam"]))
        raw = raw.tobytes()[:n_blocks * BGZF_BLOCK]
        if phred:
            raw = with_phred(raw)
        streams, n_in = [], 0
        for i in range(0, len(raw), BGZF_BLOCK):
            co = zlib.compressobj(PHRED_LEVEL if phred else 1,
                                  zlib.DEFLATED, -15)
            st = co.compress(raw[i:i + BGZF_BLOCK]) + co.flush()
            n_in += len(st)
            if phred and streams and n_in > CARD_IN_CAP:
                break
            streams.append(st)
    else:
        data, meta = inflate.bgzf_batch(path)
        streams = [data[s:s + c] for s, c, _, _ in meta[:n_blocks].tolist()]
    src, rows, out = bytearray(), [], 0
    want = []
    for st in streams:
        raw = zlib.decompress(st, wbits=-15)
        rows.append((len(src), len(st), out, len(raw)))
        src += st + bytes(-len(st) % 4)
        out += len(raw)
        want.append(raw)
    return bytes(src), np.asarray(rows, np.int32), b"".join(want)


def bench_inflate(device: torch.device, rtt: float, reps: int,
                  n_blocks: int = N_BLOCKS, path: str = None,
                  phred: bool = False) -> dict:
    """The BGZF inflate over one batch: zlib on one host core (best of
    3), the bare kernel on resident tensors (the plain version on a CPU
    device; CUDA events), the batch's compressed bytes up and inflated
    bytes down between pinned host memory and the card (CUDA events; the
    decoder's path moves exactly these), against the byte floor (the
    compressed bytes read once and the output written once at the HBM
    rate); ``equal`` holds the kernel's bytes to zlib's."""
    src, meta, want = inflate_inputs(n_blocks, path, phred)
    n_in, n_out = len(src), len(want)
    zlib_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for s, c, _, _ in meta.tolist():
            zlib.decompress(src[s:s + c], wbits=-15)
        zlib_s = min(zlib_s, time.perf_counter() - t0)
    rec = {"blocks": len(meta), "in_bytes": n_in, "out_bytes": n_out,
           "zlib_1core_s": zlib_s}
    if device.type == "cpu":
        out, status = inflate.inflate_plain(src, meta)

        def bare(i):
            return torch.from_numpy(inflate.inflate_plain(src, meta)[1]).sum()
        rec.update(h2d_s=None, d2h_s=None)
    else:
        srct = torch.frombuffer(bytearray(src), dtype=torch.uint8).to(device)
        metat = torch.from_numpy(meta).to(device)
        outt = torch.empty(n_out, dtype=torch.uint8, device=device)

        def bare(i):
            _, st = inflate.inflate_tensors(srct, metat, outt)
            return st.sum(dtype=torch.int64) + outt[i % n_out]
        out, status = inflate.inflate_tensors(srct, metat)
        out, status = out.cpu().numpy(), status.cpu().numpy()
        pin_in = torch.frombuffer(bytearray(src), dtype=torch.uint8) \
            .pin_memory()
        pin_out = torch.empty(n_out, dtype=torch.uint8).pin_memory()
        for key, dst, frm in (("h2d_s", srct, pin_in),
                              ("d2h_s", pin_out, outt)):
            best = float("inf")
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                dst.copy_(frm, non_blocking=True)
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 1e3)
            rec[key] = best
    bare_s = max(_timed(bare, device, reps) - rtt, 1e-9)
    bound_ms = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    rec.update(bare_s=bare_s, out_bytes_per_s=n_out / bare_s,
               bound_ms=bound_ms, bound_by="bytes",
               bare_efficiency_vs_bound=bound_ms / 1e3 / bare_s,
               zlib_out_bytes_per_s=n_out / zlib_s,
               equal=bool(not status.any() and out.tobytes() == want))
    return rec


def run(device=None, reps: int = REPS, n_rows: int = N_ROWS,
        n_reads: int = N_READS, n_sv: int = N_SV,
        n_blocks: int = N_BLOCKS) -> dict:
    """Every measurement on ``device`` (CUDA unless the caller asks for
    the CPU); the JSON record."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    out = {"backend": device.type,
           "device": torch.cuda.get_device_name(device) if on_card
           else "cpu",
           "card": card_line() if on_card else "cpu",
           "n_rows": n_rows,
           "methodology": "varied inputs + data-dependent readback per "
                          "rep inside the timed window (CUDA events on a "
                          "card, host clock on the CPU); rtt_s (the "
                          "pattern on a trivial computation) subtracted"}
    t0 = time.time()
    ctx = torch.cuda.device(device) if on_card else contextlib.nullcontext()
    with ctx:
        rtt = bench_rtt(device, reps)
        out["rtt_s"] = rtt
        out["stream_roofline_bytes_per_s"] = bench_stream_roofline(
            STREAM_BYTES, device, rtt, reps)
        out["stream_vs_hbm_peak"] = (
            out["stream_roofline_bytes_per_s"] / HBM_BYTES_PER_S
            if on_card else None)
        sort_rows_per_s = bench_sort_roofline(n_rows, device, rtt, reps)
        out["sort_roofline_rows_per_s"] = sort_rows_per_s
        for key, step, row_bytes in (
                ("indel_cluster", indel_step(n_rows, device), 3 * 4),
                ("pair_cluster", pair_step(n_rows, device), 4 * 4)):
            res = _program(step, n_rows, row_bytes, device, rtt, reps)
            res["vs_sort_roofline"] = res["rows_per_s"] / sort_rows_per_s
            out[key] = res
        out["cover"] = bench_cover(n_sv, n_reads, device, rtt, reps)
        out["inflate"] = bench_inflate(device, rtt, reps, n_blocks)
        out["inflate_phred"] = bench_inflate(device, rtt, reps, n_blocks,
                                             phred=True)
    out["total_s"] = time.time() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench_kernels",
        description="The port's device programs, cover kernel and BGZF "
                    "inflate kernel against same-card rooflines; prints one "
                    "JSON line.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:k pins card k) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
