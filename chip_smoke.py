#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cutesv_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, all of them, in order; any failure exits non-zero and prints no
result line:

  card   the card's name and power limit (nvidia-smi), the host's
         usable cores and compression libraries; no CUDA -> error
  build  builds both native libraries at once: nvcc for every kernel of
         cutesv_tpu_torch/csrc, g++ for the BAM decoder of native/
  k1     the cover-count kernel at genome scale (32,768 windows x
         1,500,000 reads: one int32 flush of a 30x human genome), plus a
         ragged, a half-integral and an empty case: the kernel must EQUAL
         its plain PyTorch version on the card; times of the bare launch
         (on a preallocated output), of the wrapper call and of the plain
         version
  cluster  the DEL/INS cluster program over 2**22 padded rows on the card
         must equal the same call on the CPU (sort stability, dtypes)
  e2e    simulates a 100 Mb, 4-chromosome, 20x, 20 kb-read corpus with
         planted DEL/INS every 50 kb and drives the CLI entry point
         (--genotype -s 5) three times: native decoder on cuda (the main
         path), native on cpu, python decoder on cuda. The main path must
         have used the native decoder and launched the cover kernel
         exactly once (100 Mb fits one 1e9-bp flush), the three VCF
         bodies must be equal byte for byte, and >= 99% of the planted
         sites must be called (type, <= 200 bp)
  k1 main-path shape  the kernel (bare launch, wrapper, plain version,
         equal) at the window and read counts of the main path's launch

Then one {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, "device": {...}} line. Everything is built and written
under build/ beside this script.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

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

K1_WINDOWS = 32_768
K1_READS = 1_500_000
CLUSTER_ROWS = 1 << 22
E2E_MB = 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def codec_line() -> str:
    """Which compression runtime libraries and headers this machine has
    (the decoder links the runtime sonames and needs no header)."""
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                          text=True, timeout=60).stdout
    have = ["%s %s" % (n, "yes" if n in libs else "no")
            for n in ("libz.so.1", "liblzma.so.5", "libbz2.so.1.0",
                      "libdeflate.so")]
    have += ["%s %s" % (h, "yes" if os.path.exists("/usr/include/" + h)
                        else "no")
             for h in ("zlib.h", "lzma.h", "bzlib.h", "libdeflate.h")]
    return ", ".join(have)


def time_cuda(fn, reps: int, setup=None) -> tuple:
    """Median ms of ``reps`` warm runs between CUDA events, and the last
    result; ``setup`` runs before each run, outside the timing. Each run's
    output is read back (a data-dependent sum) before the synchronize
    that ends the timing."""
    if setup:
        setup()
    fn()  # warm-up
    torch.cuda.synchronize()
    times, out, check = [], None, 0
    for _ in range(reps):
        if setup:
            setup()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        check += int(out.sum().item())
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out, check


def time_k1(tens, reps: int) -> tuple:
    """The bare kernel launch (``cover.launch`` into a preallocated
    output, zeroed outside the timing) and the wrapper call
    (``cover.cover_tensors``: allocation, checks, launch): median ms and
    output of each."""
    from cutesv_tpu_torch.ops import cover

    out = torch.zeros(tens[0].shape[0], dtype=torch.int32,
                      device=tens[0].device)
    k_ms, k_out, _ = time_cuda(lambda: cover.launch(*tens, out), reps,
                               setup=out.zero_)
    w_ms, w_out, _ = time_cuda(lambda: cover.cover_tensors(*tens), reps)
    return k_ms, k_out, w_ms, w_out


def k1_bound_ms(n_sv: int, n_reads: int) -> tuple:
    ops_s = OPS_PER_PAIR * n_sv * n_reads / INT32_OPS_PER_S
    bytes_s = 4 * (3 * n_sv + 2 * n_reads) / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def random_windows(rng, n, span, half=False):
    s = rng.integers(0, span, n).astype(np.float64)
    w = rng.choice([400.0, 2000.0, 1000.0], n)
    if half:
        w = w + 1.0 - 0.5 * rng.integers(0, 2, n)
        s = s - 0.5 * rng.integers(0, 2, n)
        s = np.maximum(s, 0.0)
    return list(zip(s.tolist(), (s + w).tolist()))


def random_reads(rng, n, span):
    st = rng.integers(0, span - 40_000, n)
    return st, st + rng.integers(1_000, 40_000, n)


def phase_k1(res: dict) -> None:
    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.ops.sweep import (cover_counts_plain, cover_plain,
                                            scaled_tensors)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    span = 1_000_000_000 // 2 - 1   # doubled coordinates stay in int32
    wins = random_windows(rng, K1_WINDOWS, span)
    st, en = random_reads(rng, K1_READS, span)
    tens = scaled_tensors(wins, st, en, dev)
    k_ms, k_out, w_ms, w_out = time_k1(tens, 20)
    p_ms, p_out, _ = time_cuda(lambda: cover_plain(*tens), 3)
    for out in (k_out, w_out):
        if not torch.equal(out, p_out):
            bad = int((out != p_out).sum())
            raise AssertionError("cover kernel != plain on %d of %d windows"
                                 % (bad, K1_WINDOWS))
    err = int((k_out.long() - p_out.long()).abs().max())
    # the numpy entry point (scaling on the host, int64 counts back)
    if not np.array_equal(cover.cover_counts_cuda(wins, st, en, dev),
                          p_out.cpu().numpy().astype(np.int64)):
        raise AssertionError("cover_counts_cuda != plain at genome scale")
    bound, by = k1_bound_ms(K1_WINDOWS, K1_READS)
    log("k1 genome scale: %d windows x %d reads: kernel %.3f ms, wrapper "
        "%.3f ms, plain %.3f ms, bound %.3f ms (%s), %.3e compares/s, "
        "mean count %.1f"
        % (K1_WINDOWS, K1_READS, k_ms, w_ms, p_ms, bound, by,
           K1_WINDOWS * K1_READS / (k_ms / 1e3),
           float(k_out.double().mean())))

    # ragged sizes, half-integral windows, empty inputs (wrapper contract)
    cases = {
        "ragged": (random_windows(rng, 5_003, 10_000_000),
                   *random_reads(rng, 100_003, 10_000_000)),
        "half-integral": (random_windows(rng, 3_001, 10_000_000, half=True),
                          *random_reads(rng, 70_001, 10_000_000)),
        "empty windows": ([], *random_reads(rng, 1_000, 10_000_000)),
        "empty reads": (random_windows(rng, 100, 10_000_000),
                        np.zeros(0, np.int64), np.zeros(0, np.int64)),
    }
    for name, (w, s, e) in cases.items():
        got = cover.cover_counts_cuda(w, s, e, dev)
        want = cover_counts_plain(w, s, e, dev)
        if got.dtype != np.int64 or not np.array_equal(got, want):
            raise AssertionError("cover kernel != plain (%s case)" % name)
        log("k1 %s case: %d windows x %d reads equal" % (name, len(w),
                                                        len(s)))
    res["k1"] = dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, max_abs_err=err)


def phase_k1_main(res: dict) -> None:
    """The kernel at the shape of the main path's launch (all windows and
    primary reads of one 1e9-bp flush of the e2e corpus), random inputs
    over the corpus's 100 Mb of offset coordinates."""
    from cutesv_tpu_torch.ops.sweep import cover_plain, scaled_tensors

    n_sv, n_reads = res["main_shape"]
    rng = np.random.default_rng(4)
    span = int(E2E_MB * 1e6)
    tens = scaled_tensors(random_windows(rng, n_sv, span),
                          *random_reads(rng, n_reads, span),
                          torch.device("cuda"))
    m_ms, m_out, mw_ms, mw_out = time_k1(tens, 50)
    mp_ms, mp_out, _ = time_cuda(lambda: cover_plain(*tens), 10)
    if not (torch.equal(m_out, mp_out) and torch.equal(mw_out, mp_out)):
        raise AssertionError("cover kernel != plain at the main-path shape")
    m_bound, m_by = k1_bound_ms(n_sv, n_reads)
    log("k1 main-path shape: %d windows x %d reads: kernel %.4f ms, "
        "wrapper %.4f ms, plain %.4f ms, bound %.5f ms (%s), equal"
        % (n_sv, n_reads, m_ms, mw_ms, mp_ms, m_bound, m_by))
    res["k1"].update(main_path_shape=[n_sv, n_reads], main_path_ms=m_ms,
                     main_path_wrapper_ms=mw_ms, main_path_plain_ms=mp_ms,
                     main_path_bound_ms=m_bound)


def synthetic_del_stream(rng, n: int):
    """Sorted DEL stream of ``n`` rows: a new site every ~20 rows a few kb
    on, jittered positions, and read ids and lengths from small ranges so
    (cluster, read, length) ties are common."""
    site = np.cumsum((rng.random(n) < 0.05) * rng.integers(300, 5_000, n))
    pos = np.sort(site + rng.integers(-40, 40, n) + 1_000)
    length = rng.integers(50, 60, n)
    rid = rng.integers(0, 40, n)
    return pos, length, rid


def phase_cluster(res: dict) -> None:
    from cutesv_tpu_torch.ops.indel_cluster import (compact_cluster_outputs,
                                                    indel_cluster_structure)

    rng = np.random.default_rng(2)
    n_valid = CLUSTER_ROWS - 12_345
    pos, length, rid = synthetic_del_stream(rng, n_valid)

    def run(device):
        def t(a):
            buf = np.zeros(CLUSTER_ROWS, np.int32)
            buf[:n_valid] = a
            return torch.from_numpy(buf).to(device)
        args = (t(pos), t(length), t(rid))

        def go():
            out = indel_cluster_structure(*args, n_valid, 200, 5,
                                          CLUSTER_ROWS)
            nk = int(out["n_kept"])
            comp = compact_cluster_outputs(out["cid"], out["pos"],
                                           out["length"], out["stream_idx"],
                                           max(nk, 1))
            return out, comp
        return go

    cpu_out, cpu_comp = run(torch.device("cpu"))()
    go = run(torch.device("cuda"))
    ms, _, _ = time_cuda(lambda: go()[0]["cid"], 5)
    gpu_out, gpu_comp = go()
    for k in ("cid", "pos", "length", "stream_idx", "n_kept"):
        if not torch.equal(gpu_out[k].cpu(), cpu_out[k]):
            raise AssertionError("cluster program differs on CUDA: %s" % k)
        if gpu_out[k].dtype != torch.int32:
            raise AssertionError("cluster output %s is %s, not int32"
                                 % (k, gpu_out[k].dtype))
    for k in ("pos", "length", "packed"):
        if not torch.equal(gpu_comp[k].cpu(), cpu_comp[k]):
            raise AssertionError("compacted output differs on CUDA: %s" % k)
    log("cluster program: %d rows (%d valid, %d kept): %.3f ms on the "
        "card, equal to the CPU" % (CLUSTER_ROWS, n_valid,
                                    int(cpu_out["n_kept"]), ms))
    res["cluster_ms"] = ms


def _body(path: str) -> list:
    with open(path) as fh:
        return [l for l in fh.read().splitlines()
                if not l.startswith(("##fileDate", "##CommandLine"))]


def _recall(truth_bed: str, vcf_path: str) -> tuple:
    calls = {}
    gts = {}
    for line in _body(vcf_path):
        if line.startswith("#"):
            continue
        f = line.split("\t")
        info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
        calls.setdefault((f[0], info["SVTYPE"]), []).append(int(f[1]))
        gt = f[9].split(":")[0]
        gts[gt] = gts.get(gt, 0) + 1
    n = hit = 0
    for line in open(truth_bed):
        chrom, start, _end, kind = line.split("\t")[:4]
        svtype = "DEL" if kind == "deletion" else "INS"
        n += 1
        pos = np.asarray(calls.get((chrom, svtype), []))
        if len(pos) and np.min(np.abs(pos - int(start))) <= 200:
            hit += 1
    return hit, n, gts


# (decoder, device) of each e2e run; the first is the main path
E2E_RUNS = (("native", "cuda"), ("native", "cpu"), ("python", "cuda"))


def phase_e2e(res: dict) -> None:
    from cutesv_tpu_torch import cli
    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.tools.simulate import simulate

    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    sim = simulate(os.path.join(WORK, "sim"), genome_mb=E2E_MB,
                   n_chroms=4, coverage=20, read_len=20_000,
                   sv_spacing=50_000, seed=3)
    log("e2e corpus: %.0f Mb, 4 chromosomes, %d reads, simulated in %.1f s"
        % (E2E_MB, sim["n_reads"], time.time() - t0))
    runs = {}
    for decoder, device in E2E_RUNS:
        tag = "%s_%s" % (decoder, device)
        out = os.path.join(WORK, "calls_%s.vcf" % tag)
        wd = os.path.join(WORK, "wd_%s" % tag)
        if os.path.exists(out):
            os.remove(out)
        os.makedirs(wd, exist_ok=True)
        for f in os.listdir(wd):
            os.remove(os.path.join(wd, f))
        argv = [sim["bam"], sim["fa"], out, wd, "--genotype", "-s", "5",
                "--decoder", decoder, "--device", device]
        cover.LAUNCHES = 0
        cover.LAST_SHAPE = (0, 0)
        t1 = time.time()
        stats = cli.run(argv)
        if device == "cuda":
            torch.cuda.synchronize()
        stats = dict(stats, launches=cover.LAUNCHES,
                     shape=list(cover.LAST_SHAPE), wall_s=time.time() - t1)
        if stats["decoder"] != decoder:
            raise AssertionError("e2e %s ran the %s decoder"
                                 % (tag, stats["decoder"]))
        core = ""
        if decoder == "native":
            core = (" (decoder walk %.3f s, inflate %.3f core-s, records "
                    "%.3f core-s)" % (stats["walk_s"], stats["inflate_core_s"],
                                      stats["records_core_s"]))
        log("e2e %s: %d calls; decode %.3f s%s, resolve %.4f s, emit %.4f "
            "s, total %.2f s; cover launches %d, last at %s"
            % (tag, stats["n_calls"], stats["decode_s"], core,
               stats["resolve_s"], stats["emit_s"], stats["wall_s"],
               stats["launches"], stats["shape"]))
        runs[tag] = (out, stats)
    main = runs["native_cuda"][1]
    res["launches"] = main["launches"]
    res["main_shape"] = main["shape"]
    if main["launches"] != 1:
        raise AssertionError("the main path launched the cover kernel %d "
                             "times, not once" % main["launches"])
    bodies = {tag: _body(out) for tag, (out, _) in runs.items()}
    for tag, body in bodies.items():
        if body != bodies["native_cuda"]:
            raise AssertionError("%s VCF body differs from native_cuda" % tag)
    hit, n, gts = _recall(sim["bed"], runs["native_cuda"][0])
    log("e2e recall: %d / %d planted DEL/INS called (%.4f); GT tally %s; "
        "VCF bodies of %s equal"
        % (hit, n, hit / n, json.dumps(gts, sort_keys=True),
           ", ".join(bodies)))
    if n == 0 or hit < 0.99 * n:
        raise AssertionError("recall %d/%d below 99%%" % (hit, n))
    keys = ("decode_s", "resolve_s", "emit_s", "n_calls", "launches",
            "walk_s", "inflate_core_s", "records_core_s")
    res["e2e"] = {tag: {k: st[k] for k in keys if k in st}
                  for tag, (_, st) in runs.items()}


def phase_build() -> None:
    """Both native libraries, built at the same time."""
    from cutesv_tpu_torch.io import native
    from cutesv_tpu_torch.ops import build

    errors = []

    def decoder():
        try:
            native.get_lib()
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    t0 = time.time()
    th = threading.Thread(target=decoder)
    th.start()
    try:
        build.library()
    finally:
        th.join()
    if errors:
        raise errors[0]
    k, d = build.build_info["kernels"], build.build_info["decoder"]
    log("build: %.1f s in all; kernels (nvcc) %.1f s, decoder (g++) %.1f s"
        % (time.time() - t0, k["seconds"], d["seconds"]))
    log("nvcc report:\n%s" % k["report"])
    if d["report"].strip():
        log("g++ report:\n%s" % d["report"])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA GPU only")
    sys.path.insert(0, REPO)

    card = card_line()
    log("card: %s" % card)
    log("host: %d usable cores (sched_getaffinity), %d in all"
        % (len(os.sched_getaffinity(0)), os.cpu_count()))
    log("codecs: %s" % codec_line())
    res: dict = {}
    phase_build()
    phase_k1(res)
    phase_cluster(res)
    phase_e2e(res)
    phase_k1_main(res)
    # every phase passed (each raises otherwise), so the kernel is equal
    log(json.dumps({"kernels": [dict(
        name="cover_count", route="cuda",
        source="cutesv_tpu_torch/csrc/cover_count.cu",
        replaces="cutesv_tpu/ops/pallas_sweep.py:28",
        launches=res["launches"], equal=True, library_ms=None,
        shape=[K1_WINDOWS, K1_READS], **res["k1"])],
        "cluster_ms": res["cluster_ms"], "e2e": res["e2e"]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
