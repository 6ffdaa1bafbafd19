#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cutesv_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, all of them, in order; any failure exits non-zero and prints no
result line:

  card   the card's name, power limit and compute mode (nvidia-smi), the
         host's usable cores and compression libraries; no CUDA -> error
  build  builds both native libraries at once: nvcc for every kernel of
         cutesv_tpu_torch/csrc, g++ for the BAM decoder of native/
  k1     the cover-count kernel at genome scale (32,768 windows x
         1,500,000 reads: one int32 flush of a 30x human genome), plus a
         ragged, a half-integral and an empty case, and at the genome
         shape the adversarial cases of cover_cases (reads sorted and
         reversed, one 2 Mb read, windows with e < s, reads with end <
         start, sentinel padding, all reads at one start, the int32
         extremes, duplicates): the kernel must EQUAL its plain PyTorch
         version on the card; times of the bare launch (on a preallocated
         output and scratch), of the wrapper call and of the plain
         version, the byte floor and the all-pairs bound, and the pairs
         the pruned ranges hold and the groups of windows compare
  cluster  the DEL/INS cluster program over 2**22 padded rows on the card
         must equal the same call on the CPU (sort stability, dtypes)
  pair   the DUP/INV/TRA pair-cluster program over 2**22 padded rows,
         DUP-style, INV-style (break on k2) and with TRA aux codes: the
         card must equal the CPU
  e2e    simulates a 100 Mb, 4-chromosome, 20x, 20 kb-read corpus with
         planted DEL/INS every 50 kb and drives the CLI entry point
         (--genotype -s 5) four times: native decoder on cuda (the main
         path: the streaming decode, on by default with 2+ usable
         cores), the same with CUTESV_STREAM_DISPATCH=0, native on cpu,
         python decoder on cuda. The main path must have streamed and
         launched the cover kernel at least once and at most once per
         1e9-bp flush, the VCF bodies must be equal byte for byte, and
         >= 99% of the planted sites must be called (type, <= 200 bp)
  alltypes  writes a VISOR HACk truth bed with a DEL, INS, tandem DUP,
         inversion or reciprocal translocation every 20 kb of a 64 Mb
         window, replays it into a 20x corpus (tools/simulate.py::replay)
         and calls it three times: native on cuda (the main path), native
         on cpu, and --engine host on cuda. Equal bodies, the main path's
         launches as above, and >= 99% of each planted type called with
         its type within 1 kb (BND per breakend pair)
  cram   encodes the all-types BAM as reference-based CRAM 3.0 and 3.1
         with the port's CramWriter and calls each once on the main path
         (native decoder, cuda): the native decoder ran, the decode
         streamed, the cover kernel launched 1 to `flushes` times, and
         the body equals the all-types BAM body
  forcecall  -Ivcf with the all-types discovery VCF over the all-types
         BAM and its CRAM 3.0, and with the 100 Mb discovery VCF over the
         100 Mb BAM, on cuda: every discovery record comes back (CHROM,
         POS, ID, SVTYPE), the BAM and CRAM bodies are equal, and the
         cover kernel launched 0 times (force calling counts reads on the
         host); the share of GTs equal to discovery's, per SV type
  distributed  the multi-host mode as two processes on the one card
         (spawned children, each calling the CLI entry point with
         --distributed --coordinator localhost:<free port>
         --num_processes 2 --process_id k --device cuda --genotype -s 5)
         over the 100 Mb BAM (the ranged streaming decode), the all-types
         BAM and its CRAM 3.0 (the container-aligned plain ranged
         decode): both exit 0 and report the sharded decode, process 1
         writes no VCF, process 0's body equals the main path's body of
         that corpus, and the two processes' cover launches sum to >= 1,
         each at most one per flush. Both are killed at a deadline, which
         fails the phase; a card in Exclusive_Process mode fails it too.
         Two processes share one card and eight cores: no multi-host
         speed-up is measured
  shards  --n_shards on the one card, over the device list [cuda:0] * 2
         (two shards' programs and two cover launches per flush, both on
         cuda:0): sharded_cluster_sizes against the same call on
         [cpu] * 2; the DEL/INS and pair programs (DUP, INV, TRA forms) on
         two gap-aligned shards of 2**22 rows against one serial call; the
         sharded cover at the genome-scale shape against one launch and
         the plain version (both times printed); run_pipeline with
         --n_shards 2 over both corpora (bodies equal to the main path's,
         the stats name both devices, 2 to 2 x flushes cover launches);
         the CLI with --n_shards 2 on the machine's own cards (one card:
         the serial programs run and the log says so; two or more: a real
         sharded run; the body equal either way); entry() on the card
         against the CPU; dryrun_multichip(2, [cuda:0] * 2) and its DRYRUN
         OK line; the BND-storm bench (cutesv_tpu_torch/tools/bench_tra.py,
         50,000 signatures over a 400,000-row census: three equal arms,
         three times); one scale_run of the 100 Mb corpus in a fresh
         process (its SCALE_RUN line; the main path's call count)
  tools  the port's tools on the card: bench_kernels at its defaults
         (2**20 program rows, 2**20 reads, 2**15 windows; its JSON line
         printed on a line of its own), then one rep of the DEL/INS and
         pair programs held to the same call on the CPU and one rep of
         the cover to the plain version on the card and to the host's
         genotype.cover_counts (the plain version on the CPU takes tens
         of seconds at that shape); replay_eval's driver over a 12-row
         DEL/INS bed (--window_mb 2 --coverage 10 --force_call --device
         cuda): 6/6 DEL and 6/6 INS at presence and genotype level and
         the cover kernel launched (once per window at most); the pooled
         baseline (tools/baseline_pool.py, host engine, Python reader,
         forked workers) over the all-types BAM after this process has
         used CUDA: its body equals the --engine host body
  profile  one --profile run of the all-types BAM on the main path: the
         body equals the main path's, the torch.profiler trace
         (work_dir/torch_trace/resolve.json) holds the cover kernel, and
         its five longest device operations and the device's busy share
         of the resolve stage are printed
  k1 main-path shapes  the kernel (bare launch, wrapper, plain version,
         equal) at the window and read counts of each main path's last
         launch, each process of the distributed runs and replay_eval's
         run included

Each main-path run sets the launch counts to 0 just before it and reads
them just after; the streaming runs print their early programs and
tails, the overlap seconds and where the genotype windows were counted.
Then one {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, "device": {...}} line. Everything is built and written
under build/ beside this script.
"""
from __future__ import annotations

import gzip
import json
import logging
import multiprocessing
import os
import queue
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

K1_WINDOWS = 32_768
K1_READS = 1_500_000
CLUSTER_ROWS = 1 << 22
E2E_MB = 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def compute_mode() -> str:
    """The card's compute mode (Default, Exclusive_Process, ...)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


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


def pycodec_line() -> str:
    """Whether this Python has the lzma and bz2 modules (the Python CRAM
    codecs import them; the C++ decoder does not need them)."""
    have = []
    for mod in ("lzma", "bz2"):
        try:
            __import__(mod)
            have.append("%s yes" % mod)
        except ImportError as exc:
            have.append("%s no (%s)" % (mod, exc))
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
    output, zeroed outside the timing, on a preallocated scratch buffer)
    and the wrapper call (``cover.cover_tensors``: allocation, checks,
    launch): median ms and output of each."""
    from cutesv_tpu_torch.ops import cover

    out = torch.zeros(tens[0].shape[0], dtype=torch.int32,
                      device=tens[0].device)
    buf = cover.scratch(tens[0].shape[0], tens[2].shape[0], tens[0].device)
    k_ms, k_out, _ = time_cuda(lambda: cover.launch(*tens, out, buf), reps,
                               setup=out.zero_)
    w_ms, w_out, _ = time_cuda(lambda: cover.cover_tensors(*tens), reps)
    return k_ms, k_out, w_ms, w_out


def k1_phases(tens) -> dict:
    """Device microseconds of each phase of the kernel (``cover.phase_us``)
    for one warm launch on these tensors."""
    from cutesv_tpu_torch.ops import cover

    out = torch.zeros(tens[0].shape[0], dtype=torch.int32,
                      device=tens[0].device)
    buf = cover.scratch(tens[0].shape[0], tens[2].shape[0], tens[0].device)
    for _ in range(2):
        cover.launch(*tens, out, buf)
    torch.cuda.synchronize()
    return cover.phase_us(buf)


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


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
COVER_CASES = ("random", "reads sorted", "reads reversed", "one 2 Mb read",
               "windows e < s", "reads end < start", "sentinel-padded",
               "all reads at one start", "int32 extremes", "duplicates")


def cover_cases(n_sv: int, n_reads: int, span: int, seed: int) -> dict:
    """The cover kernel's adversarial cases: name -> (sv_s, sv_e, st, en),
    int32 numpy arrays of doubled coordinates (as ``scale_and_pad`` gives
    them) for ``n_sv`` windows and ``n_reads`` reads over ``span`` bp,
    made from ``seed``. Every case must count as the plain version does.
    """
    from cutesv_tpu_torch.ops.sweep import scale_and_pad

    rng = np.random.default_rng(seed)
    wins = random_windows(rng, n_sv, span)
    st, en = random_reads(rng, n_reads, span)

    def doubled(w, s, e, sv_multiple=1, read_multiple=1):
        return tuple(a.astype(np.int32) for a in scale_and_pad(
            w, s, e, sv_multiple, read_multiple))

    base = doubled(wins, st, en)
    sv_s, sv_e, rs, re_ = base
    order = np.argsort(rs, kind="stable")
    every3 = np.arange(n_sv) % 3 == 0
    ws_swap = np.where(every3, sv_e, sv_s)
    we_swap = np.where(every3, sv_s, sv_e)
    # a few windows whose e lies far below s (a range over much of the span)
    far = rng.choice(n_sv, max(1, n_sv // 1000), replace=False)
    we_swap[far] = ws_swap[far] - span
    long_en = re_.copy()
    long_en[0] = rs[0] + 2 * 2_000_000   # one 2 Mb read
    rswap = np.arange(n_reads) % 3 == 1
    one = np.full(n_reads, rs[n_reads // 2], np.int32)
    ext_s, ext_e, ext_st, ext_en = (a.copy() for a in base)
    for arr, vals in ((ext_s, (INT32_MIN, INT32_MAX, INT32_MAX, INT32_MIN)),
                      (ext_e, (INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN)),
                      (ext_st, (INT32_MIN, INT32_MAX, INT32_MIN, INT32_MAX)),
                      (ext_en, (INT32_MAX, INT32_MIN, INT32_MIN, INT32_MAX))):
        where = rng.choice(len(arr), 8, replace=False)
        arr[where] = np.resize(np.array(vals, np.int32), 8)
    half_sv, half_r = max(1, n_sv // 2), max(1, n_reads // 2)
    return {
        "random": base,
        "reads sorted": (sv_s, sv_e, rs[order], re_[order]),
        "reads reversed": (sv_s, sv_e, rs[order[::-1]], re_[order[::-1]]),
        "one 2 Mb read": (sv_s, sv_e, rs, long_en),
        "windows e < s": (ws_swap, we_swap, rs, re_),
        "reads end < start": (sv_s, sv_e, np.where(rswap, re_, rs),
                              np.where(rswap, rs, re_)),
        "sentinel-padded": doubled(wins, st, en, 1000, 4096),
        "all reads at one start": (sv_s, sv_e, one,
                                   one + (re_ - rs)),
        "int32 extremes": (ext_s, ext_e, ext_st, ext_en),
        "duplicates": (np.concatenate([sv_s, sv_s[:half_sv]]),
                       np.concatenate([sv_e, sv_e[:half_sv]]),
                       np.concatenate([rs, rs[:half_r]]),
                       np.concatenate([re_, re_[:half_r]])),
    }


def phase_k1(res: dict) -> None:
    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.ops.sweep import (cover_counts_plain, cover_plain,
                                            pruned_pairs, scaled_tensors)
    from cutesv_tpu_torch.tools.bench_kernels import (cover_bound_ms,
                                                      dense_bound_ms)

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
    bound, by = cover_bound_ms(K1_WINDOWS, K1_READS)
    dense = dense_bound_ms(K1_WINDOWS, K1_READS)[0]
    candidate, compared = pruned_pairs(*(t.cpu() for t in tens))
    pairs_per_s = K1_WINDOWS * K1_READS / (k_ms / 1e3)
    phases = k1_phases(tens)
    log("k1 genome scale: %d windows x %d reads: kernel %.4f ms, wrapper "
        "%.4f ms, plain %.3f ms, bound %.5f ms (%s, %.4f of it), dense "
        "bound %.3f ms; %.4e pairs answered/s; %d candidate pairs in the "
        "pruned ranges, %d compared by the groups (of %d); mean count %.1f; "
        "phases (device us) %s"
        % (K1_WINDOWS, K1_READS, k_ms, w_ms, p_ms, bound, by, bound / k_ms,
           dense, pairs_per_s, candidate, compared, K1_WINDOWS * K1_READS,
           float(k_out.double().mean()), json.dumps(phases)))

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
    # the adversarial cases at the genome-scale shape, each held to the
    # plain version with max_abs_err 0 and timed
    cases = {}
    for name, arrays in cover_cases(K1_WINDOWS, K1_READS, span, 5).items():
        ctens = [torch.from_numpy(a).to(dev) for a in arrays]
        c_ms, c_out, cw_ms, cw_out = time_k1(ctens, 5)
        cp_ms, cp_out, _ = time_cuda(lambda: cover_plain(*ctens), 1)
        c_err = int((c_out.long() - cp_out.long()).abs().max())
        if c_err or not torch.equal(cw_out, cp_out):
            raise AssertionError("cover kernel != plain (%s case): max abs "
                                 "err %d" % (name, c_err))
        err = max(err, c_err)
        cand, comp = pruned_pairs(*(t.cpu() for t in ctens))
        log("k1 %s case: %d windows x %d reads: kernel %.4f ms, wrapper "
            "%.4f ms, plain %.3f ms; %d candidate / %d compared pairs; "
            "max_abs_err 0" % (name, len(arrays[0]), len(arrays[2]), c_ms,
                               cw_ms, cp_ms, cand, comp))
        cases[name] = dict(shape=[len(arrays[0]), len(arrays[2])], ms=c_ms,
                           wrapper_ms=cw_ms, plain_ms=cp_ms,
                           candidate_pairs=cand, compared_pairs=comp)
    res["k1"] = dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, dense_bound_ms=dense,
                     pairs_per_s=pairs_per_s, candidate_pairs=candidate,
                     compared_pairs=compared, phase_us=phases,
                     max_abs_err=err, cases=cases)


def phase_k1_main(res: dict) -> None:
    """The kernel at the shape of each main path's last launch (windows
    and primary reads of one 1e9-bp flush), random inputs over that
    corpus's span of offset coordinates."""
    from cutesv_tpu_torch.ops.sweep import cover_plain, scaled_tensors
    from cutesv_tpu_torch.tools.bench_kernels import (cover_bound_ms,
                                                      dense_bound_ms)

    spans = {"e2e_100mb": int(E2E_MB * 1e6),
             "alltypes": ALLTYPES_MB * 1_000_000}
    spans.update({"cram_%d.%d" % v: spans["alltypes"] for v in CRAM_VERSIONS})
    for tag, corpus, _ in DIST_RUNS:
        for k in range(2):
            spans["distributed_%s_%d" % (tag, k)] = spans[corpus]
    for tag, corpus in SHARD_RUNS:
        spans["shards_" + tag] = spans[corpus]
    spans["replay_eval"] = 2_000_000   # the driver's --window_mb 2
    res["k1"]["main_path"] = {}
    for path, (n_sv, n_reads) in res["main_shapes"].items():
        if n_sv == 0:
            continue  # a distributed process whose bucket launched nothing
        rng = np.random.default_rng(4)
        tens = scaled_tensors(random_windows(rng, n_sv, spans[path]),
                              *random_reads(rng, n_reads, spans[path]),
                              torch.device("cuda"))
        m_ms, m_out, mw_ms, mw_out = time_k1(tens, 50)
        mp_ms, mp_out, _ = time_cuda(lambda: cover_plain(*tens), 10)
        if not (torch.equal(m_out, mp_out) and torch.equal(mw_out, mp_out)):
            raise AssertionError("cover kernel != plain at the %s main-path "
                                 "shape" % path)
        m_bound, m_by = cover_bound_ms(n_sv, n_reads)
        m_dense = dense_bound_ms(n_sv, n_reads)[0]
        m_phases = k1_phases(tens)
        log("k1 %s main-path shape: %d windows x %d reads: kernel %.4f ms, "
            "wrapper %.4f ms, plain %.4f ms, bound %.5f ms (%s), dense bound "
            "%.5f ms, equal; phases (device us) %s"
            % (path, n_sv, n_reads, m_ms, mw_ms, mp_ms, m_bound, m_by,
               m_dense, json.dumps(m_phases)))
        res["k1"]["main_path"][path] = dict(
            shape=[n_sv, n_reads], ms=m_ms, wrapper_ms=mw_ms,
            plain_ms=mp_ms, bound_ms=m_bound, dense_bound_ms=m_dense,
            phase_us=m_phases)


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


def synthetic_pair_rows(rng, n: int, tra_aux: bool):
    """Sorted k1 (a new site every ~20 rows, 150-bp-scale jitter so gaps
    sit on both sides of the bias), k2 a few kb on, read ids from a small
    range; aux constant over sorted blocks of 4,096 rows, as the store's
    sort keys make it: INV strands 0/1, or TRA codes chr2*4 + type."""
    site = np.cumsum((rng.random(n) < 0.05) * rng.integers(300, 5_000, n))
    k1 = np.sort(site + rng.integers(-150, 150, n) + 1_000)
    k2 = k1 + rng.integers(500, 3_000, n)
    n_blocks = n // 4_096 + 1
    codes = (rng.integers(0, 3, n_blocks) * 4 + rng.integers(0, 4, n_blocks)
             if tra_aux else rng.integers(0, 2, n_blocks))
    aux = np.repeat(codes, 4_096)[:n]
    return k1, k2, aux, rng.integers(0, 40, n)


def phase_pair(res: dict) -> None:
    """The DUP/INV/TRA pair-cluster program over 2**22 padded rows on the
    card must equal the same call on the CPU: DUP-style (no k2 break),
    INV-style (break on k2 gaps, strand aux) and TRA-style aux codes."""
    from cutesv_tpu_torch.ops.pair_cluster import (compact_pair_outputs,
                                                   pair_cluster_structure)

    n_valid = CLUSTER_ROWS - 12_345
    res["pair_cluster_ms"] = {}
    for name, break_on_k2, tra_aux in (("dup", False, False),
                                       ("inv", True, False),
                                       ("tra", False, True)):
        rng = np.random.default_rng(6)
        rows = synthetic_pair_rows(rng, n_valid, tra_aux)

        def run(device):
            def t(a):
                buf = np.zeros(CLUSTER_ROWS, np.int32)
                buf[:n_valid] = a
                return torch.from_numpy(buf).to(device)
            args = [t(a) for a in rows]

            def go():
                out = pair_cluster_structure(*args, n_valid, 150, 5,
                                             CLUSTER_ROWS, break_on_k2)
                nk = int(out["n_kept"])
                return out, compact_pair_outputs(out["cid"],
                                                 out["stream_idx"],
                                                 max(nk, 1))
            return go

        cpu_out, cpu_comp = run(torch.device("cpu"))()
        go = run(torch.device("cuda"))
        ms, _, _ = time_cuda(lambda: go()[0]["cid"], 5)
        gpu_out, gpu_comp = go()
        for k in ("cid", "k1", "k2", "rid", "stream_idx", "n_kept"):
            if not torch.equal(gpu_out[k].cpu(), cpu_out[k]):
                raise AssertionError("pair program (%s) differs on CUDA: %s"
                                     % (name, k))
            if gpu_out[k].dtype != torch.int32:
                raise AssertionError("pair output %s is %s, not int32"
                                     % (k, gpu_out[k].dtype))
        if not torch.equal(gpu_comp.cpu(), cpu_comp):
            raise AssertionError("compacted pair output (%s) differs on "
                                 "CUDA" % name)
        log("pair program (%s, break_on_k2=%s): %d rows (%d valid, %d "
            "kept): %.3f ms on the card, equal to the CPU"
            % (name, break_on_k2, CLUSTER_ROWS, n_valid,
               int(cpu_out["n_kept"]), ms))
        res["pair_cluster_ms"][name] = ms


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


ALLTYPES_KINDS = ("deletion", "insertion", "tandem duplication", "inversion",
                  "reciprocal translocation")
_ORIENT = ("forward", "reverse")


def write_alltypes_bed(path: str, chrom: str, window_bp: int,
                       spacing: int = 20_000, seed: int = 0) -> int:
    """A VISOR HACk truth bed (the layout tools/eval_sim.py and
    tools/simulate.py::replay read) with one record every ``spacing`` bp
    of ``chrom`` from 50 kb to ``window_bp`` - 50 kb, the five kinds in
    turn: DEL 100-3,000 bp, INS 100-1,500 bp of random sequence, tandem
    DUP and INV 1-5 kb, and reciprocal translocations of 2-5 kb to one
    of two mate chromosomes, strands drawn at random. Returns the row
    count."""
    rng = np.random.default_rng(seed)
    rows = []
    for k, s in enumerate(range(50_000, window_bp - 50_000, spacing)):
        kind = ALLTYPES_KINDS[k % len(ALLTYPES_KINDS)]
        if kind == "deletion":
            e, info = s + int(rng.integers(100, 3_000)), "None"
        elif kind == "insertion":
            ln = int(rng.integers(100, 1_500))
            e = s + 1
            info = "".join("ACGT"[i] for i in rng.integers(0, 4, ln))
        elif kind == "tandem duplication":
            e, info = s + int(rng.integers(1_000, 5_000)), "2"
        elif kind == "inversion":
            e, info = s + int(rng.integers(1_000, 5_000)), "None"
        else:
            e = s + int(rng.integers(2_000, 5_000))
            info = "h1:chrT%d:%d:%s:%s" % (
                1 + k // len(ALLTYPES_KINDS) % 2,
                int(rng.integers(1_000_000, 50_000_000)),
                _ORIENT[int(rng.integers(0, 2))],
                _ORIENT[int(rng.integers(0, 2))])
        rows.append("%s\t%d\t%d\t%s\t%s\t0\n" % (chrom, s, e, kind, info))
    with open(path, "w") as fh:
        fh.writelines(rows)
    return len(rows)


_BND_MATE = re.compile(r"[\[\]]([^:\[\]]+):(\d+)[\[\]]")


def alltypes_recall(truth_bed: str, vcf_path: str, tol: int = 1_000):
    """{svtype: (called, planted)} over a replayed truth bed: a DEL, INS,
    DUP or INV record counts when a call of its type lies within ``tol``
    of its start; a reciprocal translocation counts once per breakend
    pair of its truth expansion (``_bnd_breakends``), when a BND call
    lies within ``tol`` of pos1 with its mate on chr2 within ``tol`` of
    pos2."""
    from cutesv_tpu_torch.tools.simulate import _bnd_breakends

    calls, bnds = {}, []
    for line in _body(vcf_path):
        if line.startswith("#"):
            continue
        f = line.split("\t")
        info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
        if info["SVTYPE"] == "BND":
            m = _BND_MATE.search(f[4])
            bnds.append((f[0], int(f[1]), m.group(1), int(m.group(2))))
        else:
            calls.setdefault((f[0], info["SVTYPE"]), []).append(int(f[1]))
    calls = {k: np.sort(v) for k, v in calls.items()}
    types = {"deletion": "DEL", "insertion": "INS",
             "tandem duplication": "DUP", "inversion": "INV"}
    out = {t: [0, 0] for t in ("DEL", "INS", "DUP", "INV", "BND")}
    for line in open(truth_bed):
        chrom, s, e, kind, info = line.rstrip("\n").split("\t")[:5]
        s, e = int(s), int(e)
        if kind in types:
            t = types[kind]
            pos = calls.get((chrom, t), np.zeros(0, np.int64))
            out[t][1] += 1
            out[t][0] += bool(len(pos)) and int(np.min(np.abs(pos - s))) \
                <= tol
            continue
        _, chr2, start2, s1, s2 = info.split(":")
        for p1, p2 in _bnd_breakends(s, e, int(start2), s1, s2):
            out["BND"][1] += 1
            out["BND"][0] += any(
                c == chrom and c2 == chr2 and abs(p - p1) <= tol
                and abs(q - p2) <= tol for c, p, c2, q in bnds)
    return {t: tuple(v) for t, v in out.items()}


# the e2e runs over the 100 Mb corpus: (tag, decoder, device, extra CLI
# arguments, environment); the first is the main path (streaming decode
# by default on a host with 2+ usable cores)
E2E_RUNS = (
    ("native_cuda", "native", "cuda", [], {}),
    ("native_cuda_plain", "native", "cuda", [],
     {"CUTESV_STREAM_DISPATCH": "0"}),
    ("native_cpu", "native", "cpu", [], {}),
    ("python_cuda", "python", "cuda", [], {}),
)
# the all-types runs: the main path, its plain version on the CPU, and
# the host engine (the oracle the JAX package documents as
# byte-identical)
ALLTYPES_RUNS = (
    ("native_cuda", "native", "cuda", [], {}),
    ("native_cpu", "native", "cpu", [], {}),
    ("host_engine_cuda", "native", "cuda", ["--engine", "host"], {}),
)
ALLTYPES_MB = 64          # tools/simulate.py::replay's window cap
ALLTYPES_SPACING = 20_000
# the all-types genome: the 64 Mb window plus its two mate chromosomes
# (under 500 kb each: tools/simulate.py::replay caps them at 400 kb)
ALLTYPES_GENOME_BP = ALLTYPES_MB * 1_000_000 + 2 * 500_000
FLUSH_BP = 1_000_000_000  # pipeline._FLUSH_BP: one cover launch at most


def _drive(tag: str, argv: list, device: str, env: dict,
           shard_devices=None) -> dict:
    """One CLI run with the launch counts set to 0 just before it and
    read just after; ``env`` is set for the run only. With
    ``shard_devices`` the parsed arguments go to ``run_pipeline`` with
    that shard device list (the CLI has no flag for it)."""
    from cutesv_tpu_torch import cli, pipeline
    from cutesv_tpu_torch.ops import cover

    argv = argv + ["--device", device]
    cfg = None
    if shard_devices is not None:
        parser = cli.build_parser()
        cfg = cli.args_to_config(parser.parse_args(argv),
                                 explicit=cli._explicit_dests(parser, argv))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cover.LAUNCHES = 0
        cover.LAST_SHAPE = (0, 0)
        t1 = time.time()
        if cfg is None:
            stats = cli.run(argv)
        else:
            stats = pipeline.run_pipeline(cfg, argv, device=device,
                                          shard_devices=shard_devices)
        if device == "cuda":
            torch.cuda.synchronize()
        stats = dict(stats, launches=cover.LAUNCHES,
                     shape=list(cover.LAST_SHAPE), wall_s=time.time() - t1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    core = ""
    if "walk_s" in stats:
        core = (" (decoder walk %.3f s, inflate %.3f core-s, records %.3f "
                "core-s)" % (stats["walk_s"], stats["inflate_core_s"],
                             stats["records_core_s"]))
    if "sites" in stats:  # force calling
        log("%s: %d sites, %s decoder; decode %.3f s, call %.4f s, emit "
            "%.4f s, total %.2f s; cover launches %d"
            % (tag, stats["sites"], stats["decoder"], stats["decode_s"],
               stats["call_s"], stats["emit_s"], stats["wall_s"],
               stats["launches"]))
        return stats
    log("%s: %d calls; decode %.3f s%s, resolve %.4f s, emit %.4f s, total "
        "%.2f s; cover launches %d, last at %s"
        % (tag, stats["n_calls"], stats["decode_s"], core,
           stats["resolve_s"], stats["emit_s"], stats["wall_s"],
           stats["launches"], stats["shape"]))
    if stats.get("streaming"):
        log("%s streaming: %d early programs + %d full tails validated of "
            "%d dispatched; native %.3f s, store %.3f s, overlap work "
            "%.3f s, done tail %.3f s; genotype windows: %d on the host "
            "(mid-decode tails), %d through the kernel (last launch)"
            % (tag, stats["early_kernels"], stats["early_tails"],
               stats["early_dispatched"], stats["native_s"],
               stats["store_s"], stats["overlap_work_s"],
               stats["done_tail_s"], stats["tail_windows"],
               stats["shape"][0]))
    return stats


def _fresh(prefix: str, tag: str) -> tuple:
    """A run's output VCF path (removed) and its emptied work dir."""
    out = os.path.join(WORK, "%s_%s.vcf" % (prefix, tag))
    wd = os.path.join(WORK, "wd_%s_%s" % (prefix, tag))
    if os.path.exists(out):
        os.remove(out)
    os.makedirs(wd, exist_ok=True)
    for f in os.listdir(wd):
        os.remove(os.path.join(wd, f))
    return out, wd


def _runs(prefix: str, bam: str, fa: str, table, min_support: int) -> dict:
    """Every run of ``table`` over one corpus: {tag: (vcf path, stats)}."""
    runs = {}
    for tag, decoder, device, extra, env in table:
        out, wd = _fresh(prefix, tag)
        stats = _drive("%s %s" % (prefix, tag),
                       [bam, fa, out, wd, "--genotype", "-s",
                        str(min_support), "--decoder", decoder] + extra,
                       device, env)
        if stats["decoder"] != decoder:
            raise AssertionError("%s %s ran the %s decoder"
                                 % (prefix, tag, stats["decoder"]))
        runs[tag] = (out, stats)
    bodies = {tag: _body(out) for tag, (out, _) in runs.items()}
    first = table[0][0]
    for tag, body in bodies.items():
        if body != bodies[first]:
            raise AssertionError("%s %s VCF body differs from %s"
                                 % (prefix, tag, first))
    return runs


def _check_main(prefix: str, stats: dict, genome_bp: int) -> None:
    """The main path went through the cover kernel: at least once, and at
    most once per 1e9-bp flush."""
    flushes = -(-genome_bp // FLUSH_BP)
    if not 1 <= stats["launches"] <= flushes:
        raise AssertionError(
            "%s main path launched the cover kernel %d times (allowed 1 to "
            "%d, one per flush)" % (prefix, stats["launches"], flushes))


STAT_KEYS = ("decode_s", "resolve_s", "emit_s", "n_calls", "launches",
             "shape", "walk_s", "inflate_core_s", "records_core_s",
             "native_s", "store_s", "overlap_work_s", "done_tail_s",
             "tail_windows", "early_dispatched", "early_kernels",
             "early_tails")


def phase_e2e(res: dict) -> None:
    from cutesv_tpu_torch.tools.simulate import simulate

    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    sim = simulate(os.path.join(WORK, "sim"), genome_mb=E2E_MB,
                   n_chroms=4, coverage=20, read_len=20_000,
                   sv_spacing=50_000, seed=3)
    log("e2e corpus: %.0f Mb, 4 chromosomes, %d reads, simulated in %.1f s"
        % (E2E_MB, sim["n_reads"], time.time() - t0))
    runs = _runs("e2e", sim["bam"], sim["fa"], E2E_RUNS, 5)
    main = runs["native_cuda"][1]
    if not main.get("streaming") or runs["native_cuda_plain"][1].get(
            "streaming"):
        raise AssertionError("the default run did not stream, or the "
                             "CUTESV_STREAM_DISPATCH=0 run did")
    _check_main("e2e", main, int(E2E_MB * 1e6))
    res["launches_by_path"] = {"e2e_100mb": main["launches"]}
    res["corpora"] = {"e2e_100mb": dict(bam=sim["bam"], fa=sim["fa"],
                                        vcf=runs["native_cuda"][0])}
    res["main_shapes"] = {"e2e_100mb": main["shape"]}
    hit, n, gts = _recall(sim["bed"], runs["native_cuda"][0])
    log("e2e recall: %d / %d planted DEL/INS called (%.4f); GT tally %s; "
        "VCF bodies of %s equal"
        % (hit, n, hit / n, json.dumps(gts, sort_keys=True),
           ", ".join(runs)))
    if n == 0 or hit < 0.99 * n:
        raise AssertionError("recall %d/%d below 99%%" % (hit, n))
    res["e2e"] = {tag: {k: st[k] for k in STAT_KEYS if k in st}
                  for tag, (_, st) in runs.items()}


def phase_alltypes(res: dict) -> None:
    """The all-types corpus: a grid of DEL, INS, DUP, INV and reciprocal
    translocations replayed over one 64 Mb window at 20x, called on the
    main path, on the CPU and with the host engine."""
    from cutesv_tpu_torch.tools.simulate import replay

    os.makedirs(WORK, exist_ok=True)
    window_bp = ALLTYPES_MB * 1_000_000
    bed = os.path.join(WORK, "alltypes_grid.bed")
    t0 = time.time()
    n = write_alltypes_bed(bed, "chr1", window_bp, ALLTYPES_SPACING, seed=5)
    info = replay(os.path.join(WORK, "alltypes"), [bed],
                  "chr1:0-%d" % window_bp, coverage=20, seed=1)
    if info["n_sv"] != n or info["n_dropped"]:
        raise AssertionError("replay kept %d of %d planted records"
                             % (info["n_sv"], n))
    log("alltypes corpus: %d Mb window, %d records (%s every %d bp), %d "
        "reads, %.1f MB BAM, replayed in %.1f s"
        % (ALLTYPES_MB, n, "/".join(ALLTYPES_KINDS), ALLTYPES_SPACING,
           info["n_reads"], os.path.getsize(info["bam"]) / 1e6,
           time.time() - t0))
    runs = _runs("alltypes", info["bam"], info["fa"], ALLTYPES_RUNS, 5)
    main = runs["native_cuda"][1]
    _check_main("alltypes", main, ALLTYPES_GENOME_BP)
    res["corpora"]["alltypes"] = dict(bam=info["bam"], fa=info["fa"],
                                      vcf=runs["native_cuda"][0],
                                      host_vcf=runs["host_engine_cuda"][0])
    res["launches_by_path"]["alltypes"] = main["launches"]
    res["main_shapes"]["alltypes"] = main["shape"]
    recall = alltypes_recall(info["bed"], runs["native_cuda"][0])
    log("alltypes recall (called / planted, type and <= 1 kb; BND per "
        "breakend pair): %s; VCF bodies of %s equal"
        % (json.dumps(recall), ", ".join(runs)))
    for svtype, (hit, total) in recall.items():
        if total == 0 or hit < 0.99 * total:
            raise AssertionError("alltypes recall of %s %d/%d below 99%%"
                                 % (svtype, hit, total))
    res["alltypes"] = {tag: {k: st[k] for k in STAT_KEYS if k in st}
                       for tag, (_, st) in runs.items()}
    res["alltypes_recall"] = recall


CRAM_VERSIONS = ((3, 0), (3, 1))
CRAM_MAX_SLICE = 10_000


def write_cram(bam: str, fa: str, cram: str, version,
               max_slice: int = CRAM_MAX_SLICE) -> int:
    """``bam`` re-encoded as a reference-based CRAM by the port's
    CramWriter, with the sequence of every header reference (the mate
    chromosomes included) from ``fa``; returns the record count."""
    from cutesv_tpu_torch.io.bam import BamReader
    from cutesv_tpu_torch.io.cram import CramWriter
    from cutesv_tpu_torch.io.fasta import FastaFile

    fasta = FastaFile(fa)
    n = 0
    with BamReader(bam) as r:
        seqs = {name: fasta.fetch(name) for name, _ in r.references}
        with CramWriter(cram, r.references, max_slice=max_slice,
                        ref_seqs=seqs, version=version) as w:
            for rec in r:
                w.write(rec)
                n += 1
    return n


def _timed(seconds: float) -> str:
    """A decoder timer; the CRAM front end leaves the record-walk and
    inflate timers of the BAM path at 0."""
    return "%.3f" % seconds if seconds else "not timed"


def phase_cram(res: dict) -> None:
    """The all-types corpus as CRAM 3.0 and 3.1, each called once on the
    main path; each body must equal the all-types BAM body."""
    corpus = res["corpora"]["alltypes"]
    bam_body = _body(corpus["vcf"])
    bam = res["alltypes"]["native_cuda"]
    res["cram"] = {}
    for version in CRAM_VERSIONS:
        tag = "%d.%d" % version
        cram = os.path.join(WORK, "alltypes_%s.cram" % tag)
        t0 = time.time()
        n = write_cram(corpus["bam"], corpus["fa"], cram, version)
        enc_s = time.time() - t0
        log("cram %s: %d records encoded in %.1f s (max_slice %d), %.1f MB "
            "against the BAM's %.1f MB"
            % (tag, n, enc_s, CRAM_MAX_SLICE, os.path.getsize(cram) / 1e6,
               os.path.getsize(corpus["bam"]) / 1e6))
        out, wd = _fresh("cram", tag)
        stats = _drive("cram %s native_cuda" % tag,
                       [cram, corpus["fa"], out, wd, "--genotype", "-s", "5",
                        "--decoder", "native"], "cuda", {})
        if stats["decoder"] != "native":
            raise AssertionError("cram %s ran the %s decoder"
                                 % (tag, stats["decoder"]))
        if not stats.get("streaming"):
            raise AssertionError("cram %s main path did not stream" % tag)
        _check_main("cram %s" % tag, stats, ALLTYPES_GENOME_BP)
        if _body(out) != bam_body:
            raise AssertionError("cram %s VCF body differs from the "
                                 "all-types BAM body" % tag)
        log("cram %s against the BAM (same call): decode %.3f / %.3f s, "
            "walk %s / %.3f s, inflate %s / %.3f core-s, records %.3f / "
            "%.3f core-s; VCF body equal"
            % (tag, stats["decode_s"], bam["decode_s"],
               _timed(stats["walk_s"]), bam["walk_s"],
               _timed(stats["inflate_core_s"]), bam["inflate_core_s"],
               stats["records_core_s"], bam["records_core_s"]))
        res["launches_by_path"]["cram_" + tag] = stats["launches"]
        res["main_shapes"]["cram_" + tag] = stats["shape"]
        res["cram"][tag] = dict(
            {k: stats[k] for k in STAT_KEYS if k in stats}, encode_s=enc_s,
            records=n, mb=os.path.getsize(cram) / 1e6)
        corpus["cram_" + tag] = cram


def _sites(path: str) -> list:
    """[((CHROM, POS, ID, SVTYPE), GT)] of a VCF's records."""
    rows = []
    for line in _body(path):
        if line.startswith("#"):
            continue
        f = line.split("\t")
        info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
        rows.append(((f[0], int(f[1]), f[2], info["SVTYPE"]),
                     f[9].split(":")[0]))
    return rows


# the force-calling runs: (tag, corpus, input); each regenotypes the
# corpus's main-path discovery VCF
FORCECALL_RUNS = (("alltypes_bam", "alltypes", "bam"),
                  ("alltypes_cram_3.0", "alltypes", "cram_3.0"),
                  ("e2e_100mb_bam", "e2e_100mb", "bam"))


def phase_forcecall(res: dict) -> None:
    """-Ivcf on the card: every discovery record comes back, the BAM and
    CRAM bodies are equal, and no cover launch (force calling counts its
    reads on the host, as the JAX package does)."""
    res["forcecall"] = {}
    bodies = {}
    for tag, name, kind in FORCECALL_RUNS:
        corpus = res["corpora"][name]
        out, wd = _fresh("forcecall", tag)
        stats = _drive("forcecall %s" % tag,
                       [corpus[kind], corpus["fa"], out, wd, "-Ivcf",
                        corpus["vcf"], "--genotype"], "cuda", {})
        if stats["decoder"] != "native":
            raise AssertionError("forcecall %s ran the %s decoder"
                                 % (tag, stats["decoder"]))
        if stats["launches"] != 0:
            raise AssertionError("forcecall %s launched the cover kernel %d "
                                 "times" % (tag, stats["launches"]))
        disc, got = _sites(corpus["vcf"]), _sites(out)
        if sorted(k for k, _ in got) != sorted(k for k, _ in disc):
            raise AssertionError(
                "forcecall %s: %d records for %d discovery records, or not "
                "the same CHROM/POS/ID/SVTYPE" % (tag, len(got), len(disc)))
        disc_gt = dict(disc)
        same = {}
        for key, gt in got:
            hit_n = same.setdefault(key[3], [0, 0])
            hit_n[0] += gt == disc_gt[key]
            hit_n[1] += 1
        share = {t: round(h / n, 4) for t, (h, n) in sorted(same.items())}
        log("forcecall %s: all %d discovery records back; GT equal to "
            "discovery's (share per type) %s"
            % (tag, len(disc), json.dumps(share)))
        bodies[tag] = _body(out)
        res["launches_by_path"]["forcecall_" + tag] = stats["launches"]
        res["forcecall"][tag] = dict(
            {k: stats[k] for k in ("sites", "decode_s", "call_s", "emit_s",
                                   "wall_s")}, gt_equal=share)
    if bodies["alltypes_bam"] != bodies["alltypes_cram_3.0"]:
        raise AssertionError("forcecall bodies of the all-types BAM and "
                             "CRAM differ")
    log("forcecall: the all-types BAM and CRAM 3.0 bodies are equal")


# the 2-process runs: (tag, corpus, input); the BAMs take the ranged
# streaming decode, the CRAM the container-aligned plain ranged decode
DIST_RUNS = (("e2e_100mb_bam", "e2e_100mb", "bam"),
             ("alltypes_bam", "alltypes", "bam"),
             ("alltypes_cram_3.0", "alltypes", "cram_3.0"))
GENOME_BP = {"e2e_100mb": int(E2E_MB * 1e6), "alltypes": ALLTYPES_GENOME_BP}
DIST_DEADLINE_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_child(rank: int, argv: list, results) -> None:
    """One process of a --distributed run, in a spawned child: the launch
    count is set to 0 just before the CLI entry point and sent back with
    the run's stats (or the traceback, before the child exits non-zero)."""
    from cutesv_tpu_torch import cli
    from cutesv_tpu_torch.ops import cover

    try:
        cover.LAUNCHES = 0
        cover.LAST_SHAPE = (0, 0)
        t0 = time.time()
        stats = cli.run(argv)
        torch.cuda.synchronize()
        results.put((rank, "ok", dict(stats, launches=cover.LAUNCHES,
                                      shape=list(cover.LAST_SHAPE),
                                      wall_s=time.time() - t0)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _two_processes(tag: str, argvs: list) -> list:
    """Runs argvs[k] + the distributed flags as process k of 2, each a
    spawned child (the parent holds a CUDA context, so no fork); returns
    both stats. Fails if a child reports an error, exits non-zero or
    without a result, or misses the deadline (both are then killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    flags = ["--distributed", "--coordinator", "localhost:%d" % _free_port(),
             "--num_processes", "2"]
    procs = [ctx.Process(target=_dist_child,
                         args=(k, argvs[k] + flags + ["--process_id", str(k)],
                               results))
             for k in range(2)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.time() + DIST_DEADLINE_S
    try:
        while len(got) < 2:
            try:
                rank, status, payload = results.get(timeout=5)
                got[rank] = (status, payload)
                continue
            except queue.Empty:
                pass
            silent = [k for k, p in enumerate(procs)
                      if k not in got and p.exitcode is not None]
            if silent:
                raise AssertionError(
                    "distributed %s: process(es) %s exited (codes %s) "
                    "without a result" % (tag, silent,
                                          [procs[k].exitcode for k in silent]))
            if time.time() > deadline:
                raise AssertionError(
                    "distributed %s: no result from process(es) %s within "
                    "%d s" % (tag, [k for k in range(2) if k not in got],
                              DIST_DEADLINE_S))
        for p in procs:
            p.join(timeout=max(5.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = ["process %d:\n%s" % (k, got[k][1]) for k in sorted(got)
              if got[k][0] != "ok"]
    if errors:
        raise AssertionError("distributed %s failed:\n%s"
                             % (tag, "\n".join(errors)))
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError("distributed %s: exit codes %s" % (tag, codes))
    return [got[0][1], got[1][1]]


def phase_distributed(res: dict, mode: str) -> None:
    """--distributed as two processes on the one card, over three inputs;
    each process's body, decode and launches are held to the main path's
    (see the module docstring)."""
    if "exclusive" in mode.lower():
        raise AssertionError(
            "compute mode %s: a second process cannot open the card, so "
            "the two-process run cannot run here" % mode)
    res["distributed"] = {}
    for tag, name, kind in DIST_RUNS:
        corpus = res["corpora"][name]
        paths = [_fresh("distributed_%s" % tag, "rank%d" % k)
                 for k in range(2)]
        t0 = time.time()
        stats = _two_processes(tag, [
            [corpus[kind], corpus["fa"], out, wd, "--genotype", "-s", "5",
             "--device", "cuda"] for out, wd in paths])
        wall = time.time() - t0
        streaming = kind == "bam"
        for k, st in enumerate(stats):
            if not st.get("sharded") or st.get("streaming") != streaming:
                raise AssertionError(
                    "distributed %s process %d: sharded=%s streaming=%s "
                    "(expected the %s ranged decode)"
                    % (tag, k, st.get("sharded"), st.get("streaming"),
                       "streaming" if streaming else "plain"))
        if os.path.exists(paths[1][0]):
            raise AssertionError("distributed %s: process 1 wrote a VCF"
                                 % tag)
        if _body(paths[0][0]) != _body(corpus["vcf"]):
            raise AssertionError("distributed %s: process 0's VCF body "
                                 "differs from the main path's" % tag)
        flushes = -(-GENOME_BP[name] // FLUSH_BP)
        launches = [st["launches"] for st in stats]
        if sum(launches) < 1 or max(launches) > flushes:
            raise AssertionError(
                "distributed %s: cover launches %s (the sum must be >= 1, "
                "each <= %d)" % (tag, launches, flushes))
        for k, st in enumerate(stats):
            early = ""
            if streaming:
                early = ("; %d early programs + %d full tails validated of "
                         "%d dispatched, overlap work %.3f s"
                         % (st["early_kernels"], st["early_tails"],
                            st["early_dispatched"], st["overlap_work_s"]))
            log("distributed %s process %d: shard of %d records (walk %.3f "
                "s, inflate %.3f core-s); decode %.3f s, resolve %.4f s, "
                "emit %.4f s, wall %.2f s; decode allgather %.2f MB local / "
                "%.2f MB total in %.3f s, results allgather %.4f MB / %.4f "
                "MB in %.3f s%s; resolved %s; cover launches %d, last at %s; "
                "%d calls"
                % (tag, k, st["shard_records"], st["walk_s"],
                   st["inflate_core_s"], st["decode_s"], st["resolve_s"],
                   st["emit_s"], st["wall_s"], st["allgather_mb"],
                   st["allgather_total_mb"], st["allgather_s"],
                   st["gather_mb"], st["gather_total_mb"], st["gather_s"],
                   early, ",".join(st["chroms_resolved"]), st["launches"],
                   st["shape"], st["n_calls"]))
            res["main_shapes"]["distributed_%s_%d" % (tag, k)] = st["shape"]
        log("distributed %s: both processes exit 0, process 1 wrote no VCF, "
            "process 0's body equals the main path's; launches %s; %.1f s "
            "with the two processes' start" % (tag, launches, wall))
        res["launches_by_path"]["distributed_" + tag] = sum(launches)
        res["distributed"][tag] = [
            {k: st[k] for k in STAT_KEYS + DIST_KEYS if k in st}
            for st in stats]


# the --n_shards runs over [cuda:0] * 2: (tag, corpus); the 100 Mb BAM
# streams (early programs stay single-device, the rest shards), the
# all-types BAM too
SHARD_RUNS = (("e2e_100mb", "e2e_100mb"), ("alltypes", "alltypes"))
BENCH_TRA_SIZE = (50_000, 400_000)   # the root tool's default storm


def _wall(fn, reps: int) -> tuple:
    """Median host-clock ms of ``reps`` runs of ``fn`` (each ends in a
    synchronize or a host copy), after one warm-up; and the last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _shard_programs(res: dict, two: list) -> None:
    """sharded_cluster_sizes on [cuda:0] * 2 against [cpu] * 2; the DEL/INS
    and pair programs on two gap-aligned shards of 2**22 rows against one
    serial call on the card."""
    from cutesv_tpu_torch.models import device as dm
    from cutesv_tpu_torch.parallel import mesh as pmesh

    cuda = torch.device("cuda")
    out = res["shards"]
    rows = CLUSTER_ROWS // 2
    pos, valid = (t.numpy() for t in pmesh.demo_inputs(
        2, rows_per_shard=rows, device="cpu")[:2])
    want = pmesh.sharded_cluster_sizes([torch.device("cpu")] * 2, 200)(
        pos, valid)
    ms, got = _wall(lambda: pmesh.sharded_cluster_sizes(two, 200)(
        pos, valid), 3)
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and got[2] == want[2]):
        raise AssertionError("sharded_cluster_sizes on [cuda:0] * 2 != "
                             "[cpu] * 2")
    log("shards cluster sizes: %d rows in 2 shards, %d clusters: %.3f ms on "
        "[cuda:0] * 2 (host clock, with the copies), equal to [cpu] * 2"
        % (2 * rows, got[2], ms))
    out["cluster_sizes_ms"] = ms

    n_valid = CLUSTER_ROWS - 12_345
    rng = np.random.default_rng(2)
    stream = dm.IndelStream.from_arrays(*synthetic_del_stream(rng, n_valid),
                                        names_table=None)
    if dm._gap_cuts(stream.pos, 2, 200) is None:
        raise AssertionError("the synthetic DEL stream has no gap cut")
    s_ms, serial = _wall(lambda: dm._cluster_stream(stream, 5, 200, cuda), 3)
    h_ms, sharded = _wall(lambda: dm._cluster_stream_sharded(
        stream, 5, 200, two, cuda), 3)
    dense = np.cumsum(np.diff(sharded[0], prepend=sharded[0][0]) != 0)
    if not (np.array_equal(dense, serial[0]) and all(
            np.array_equal(a, b) for a, b in zip(sharded[1:], serial[1:]))):
        raise AssertionError("sharded DEL/INS program != the serial one")
    log("shards cluster program: %d rows (%d kept), 2 shards on [cuda:0] * "
        "2 %.3f ms, one serial call %.3f ms (host clock, rows fetched), "
        "equal" % (n_valid, len(serial[0]), h_ms, s_ms))
    out["cluster_ms"] = dict(sharded=h_ms, serial=s_ms)
    out["pair_ms"] = {}
    for name, break_on_k2, tra_aux in (("dup", False, False),
                                       ("inv", True, False),
                                       ("tra", False, True)):
        rows_ = synthetic_pair_rows(np.random.default_rng(6), n_valid,
                                    tra_aux)
        s_ms, serial = _wall(lambda: dm._pair_cluster_slices(
            *rows_, 5, 150, break_on_k2, cuda), 1)
        h_ms, sharded = _wall(lambda: dm._pair_cluster_slices_sharded(
            *rows_, 5, 150, break_on_k2, two, cuda), 1)
        if len(sharded) != len(serial) or not all(
                np.array_equal(a, b) for a, b in zip(sharded, serial)):
            raise AssertionError("sharded pair program (%s) != the serial "
                                 "one" % name)
        log("shards pair program (%s): %d rows, %d clusters kept, 2 shards "
            "on [cuda:0] * 2 %.3f ms, one serial call %.3f ms (host clock, "
            "slices fetched), equal" % (name, n_valid, len(serial), h_ms,
                                        s_ms))
        out["pair_ms"][name] = dict(sharded=h_ms, serial=s_ms)


def _shard_cover(res: dict, two: list) -> None:
    """The sharded cover at the genome-scale shape: two window slices, one
    launch each, against one launch and the plain version."""
    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.ops.sweep import cover_plain, scaled_tensors
    from cutesv_tpu_torch.parallel import mesh as pmesh
    from cutesv_tpu_torch.parallel.sharded_cover import make_sharded_cover

    rng = np.random.default_rng(1)
    span = 1_000_000_000 // 2 - 1
    wins = random_windows(rng, K1_WINDOWS, span)
    st, en = random_reads(rng, K1_READS, span)
    tens = scaled_tensors(wins, st, en, torch.device("cuda"))
    count = pmesh.sharded_cover_counts(two)
    before = cover.LAUNCHES
    sh_ms, got = _wall(lambda: count(*tens), 5)
    per_call = (cover.LAUNCHES - before) // 6
    one_ms, one = _wall(lambda: cover.cover_tensors(*tens).cpu().numpy(), 5)
    plain = cover_plain(*tens).cpu().numpy()
    if per_call != 2 or not (np.array_equal(got, plain)
                             and np.array_equal(one, plain)):
        raise AssertionError("sharded cover: %d launches per call, or != "
                             "one launch / plain" % per_call)
    wrapped = make_sharded_cover(2, two)(wins, st, en)
    if not np.array_equal(wrapped, plain.astype(np.int64)):
        raise AssertionError("make_sharded_cover != plain")
    log("shards cover: %d windows x %d reads, 2 slices on [cuda:0] * 2 "
        "(%d launches) %.3f ms, one launch %.3f ms (host clock, counts "
        "copied back), equal to the plain version"
        % (K1_WINDOWS, K1_READS, per_call, sh_ms, one_ms))
    res["shards"]["cover_ms"] = dict(sharded=sh_ms, one_launch=one_ms)


def _shard_main_paths(res: dict, two: list) -> None:
    """The main paths of both corpora with --n_shards 2 over [cuda:0] * 2:
    each body equals the corpus's main-path body, the stats name both
    devices, and the cover kernel launched once per slice and flush."""
    for tag, name in SHARD_RUNS:
        corpus = res["corpora"][name]
        out, wd = _fresh("shards", tag)
        stats = _drive("shards %s n_shards=2" % tag,
                       [corpus["bam"], corpus["fa"], out, wd, "--genotype",
                        "-s", "5", "--n_shards", "2"], "cuda", {},
                       shard_devices=two)
        if _body(out) != _body(corpus["vcf"]):
            raise AssertionError("shards %s: the --n_shards 2 body differs "
                                 "from the main path's" % tag)
        if stats["shard_devices"] != ["cuda:0", "cuda:0"]:
            raise AssertionError("shards %s ran on %s" % (
                tag, stats["shard_devices"]))
        flushes = -(-GENOME_BP[name] // FLUSH_BP)
        if not 2 <= stats["launches"] <= 2 * flushes:
            raise AssertionError(
                "shards %s launched the cover kernel %d times (allowed 2 to "
                "%d: one per slice and flush)" % (tag, stats["launches"],
                                                  2 * flushes))
        log("shards %s: body equals the main path's; shard devices %s"
            % (tag, stats["shard_devices"]))
        res["launches_by_path"]["shards_" + tag] = stats["launches"]
        res["main_shapes"]["shards_" + tag] = stats["shape"]
        res["shards"][tag] = {k: stats[k] for k in STAT_KEYS if k in stats}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _shard_cli(res: dict) -> None:
    """--n_shards 2 through the CLI on this machine's own cards: one card
    runs the serial programs and the log says so; two or more shard."""
    corpus = res["corpora"]["alltypes"]
    out, wd = _fresh("shards", "cli")
    records = _Records()
    logger = logging.getLogger("cutesv_tpu_torch")
    logger.addHandler(records)
    try:
        stats = _drive("shards cli n_shards=2", [
            corpus["bam"], corpus["fa"], out, wd, "--genotype", "-s", "5",
            "--n_shards", "2"], "cuda", {})
    finally:
        logger.removeHandler(records)
    if _body(out) != _body(corpus["vcf"]):
        raise AssertionError("shards cli: the body differs from the main "
                             "path's")
    cards = torch.cuda.device_count()
    if cards < 2:
        said = [m for m in records.messages if "serial programs run" in m]
        if stats["shard_devices"] != [] or not said:
            raise AssertionError("shards cli on one card: shard devices %s, "
                                 "log %s" % (stats["shard_devices"], said))
    else:
        said = [m for m in records.messages if "sharded over" in m]
        if stats["shard_devices"] != ["cuda:0", "cuda:1"]:
            raise AssertionError("shards cli on %d cards ran on %s"
                                 % (cards, stats["shard_devices"]))
    log("shards cli on %d card(s): shard devices %s; log: %s; body equal"
        % (cards, stats["shard_devices"], said[0] if said else "-"))
    res["shards"]["cli"] = dict(cards=cards,
                                shard_devices=stats["shard_devices"],
                                launches=stats["launches"])


def _shard_entry(res: dict, two: list) -> None:
    """entry() on the card equals the CPU's; dryrun_multichip(2) over
    [cuda:0] * 2 prints its DRYRUN OK line."""
    import contextlib
    import io

    from cutesv_tpu_torch.entry import dryrun_multichip, entry

    outs = {}
    for device in ("cuda", "cpu"):
        fwd, args = entry(device)
        outs[device] = {k: v.cpu() for k, v in fwd(*args).items()}
    for k, v in outs["cpu"].items():
        if not torch.equal(outs["cuda"][k], v):
            raise AssertionError("entry() on the card != the CPU: %s" % k)
    log("shards entry(): %d of %d rows kept, equal on the card and the CPU"
        % (int(outs["cuda"]["n_kept"]), outs["cuda"]["cid"].shape[0]))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(2, two)
    finally:
        lines = [l for l in buf.getvalue().splitlines()
                 if l.startswith("DRYRUN")]
        for line in lines:
            log("shards dryrun_multichip(2, [cuda:0] * 2): %s" % line)
    if not (lines and lines[-1].startswith("DRYRUN OK")):
        raise AssertionError("dryrun_multichip printed no DRYRUN OK line")
    res["shards"]["dryrun"] = lines[-1]


def _shard_tools(res: dict) -> None:
    """The BND-storm bench on the card (its three arms must be equal) and
    one scale_run of the 100 Mb corpus in a fresh process."""
    from cutesv_tpu_torch.tools import bench_tra, scale_run

    t0 = time.time()
    b = bench_tra.run(*BENCH_TRA_SIZE, device="cuda")
    log("shards bench_tra: %d sigs, census %d rows, %d candidates, equal in "
        "the three arms: device (program + batched cover on the card) %.3f "
        "s, numpy host %.3f s, loop oracle %.3f s; %.1f s with the storm"
        % (b["n_sigs"], b["census"], len(b["candidates"]), b["device_s"],
           b["host_s"], b["oracle_s"], time.time() - t0))
    res["shards"]["bench_tra"] = {k: b[k] for k in (
        "n_sigs", "census", "device_s", "host_s", "oracle_s")}
    corpus = res["corpora"]["e2e_100mb"]
    prefix = corpus["bam"][:-len(".bam")]
    t0 = time.time()
    rec, = scale_run.scale_runs(prefix, runs=1, min_support=5,
                                device="cuda")
    want = res["e2e"]["native_cuda"]["n_calls"]
    if rec["n_calls"] != want:
        raise AssertionError("scale_run: %d calls, the main path %d"
                             % (rec["n_calls"], want))
    log("shards scale_run: the record above; %d calls as the main path; "
        "%.1f s with the child's start" % (rec["n_calls"], time.time() - t0))
    res["shards"]["scale_run"] = rec


def phase_shards(res: dict) -> None:
    """--n_shards on the card (see the module docstring)."""
    two = [torch.device("cuda", 0)] * 2
    res["shards"] = {}
    _shard_programs(res, two)
    _shard_cover(res, two)
    _shard_main_paths(res, two)
    _shard_cli(res)
    _shard_entry(res, two)
    _shard_tools(res)


REPLAY_ROWS = 12


def write_replay_bed(path: str, seed: int = 3) -> None:
    """A gzipped VISOR HACk truth bed of ``REPLAY_ROWS`` rows on
    chromosome 1 from 100 kb, 20-40 kb apart, DEL and INS in turn, each
    80-400 bp (the INS with random sequence): the replay driver's smoke
    bed of the JAX package's tests, from the same seed."""
    rng = random.Random(seed)
    rows = []
    pos = 100_000
    for k in range(REPLAY_ROWS):
        ty = ("deletion", "insertion")[k % 2]
        ln = rng.randrange(80, 400)
        if ty == "insertion":
            seq = "".join(rng.choice("ACGT") for _ in range(ln))
            rows.append("1\t%d\t%d\tinsertion\t%s\t0\n"
                        % (pos, pos + 1, seq))
        else:
            rows.append("1\t%d\t%d\tdeletion\tNone\t0\n"
                        % (pos, pos + ln))
        pos += rng.randrange(20_000, 40_000)
    with gzip.open(path, "wt") as fh:
        fh.writelines(rows)


def replay_eval_argv(bed: str, out: str, device: str) -> list:
    """The replay driver's arguments over ``bed``: one 2 Mb window of
    chromosome 1 at 10x, force calling on."""
    return ["--beds", bed, "--out", out, "--chroms", "1", "--window_mb",
            "2", "--coverage", "10", "--force_call", "--device", device]


def _tools_bench(res: dict) -> None:
    """bench_kernels at its defaults on the card (its JSON line on a line
    of its own), then one rep of each program held to the same call on
    the CPU, and one rep of the cover to the plain version on the card
    and to the host's count on the CPU."""
    from cutesv_tpu_torch.genotype import cover_counts
    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.ops.sweep import cover_plain, scaled_tensors
    from cutesv_tpu_torch.tools import bench_kernels as bk

    rec = bk.run("cuda")
    log(json.dumps(rec))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rep = 1
    for name, make in (("indel_cluster", bk.indel_step),
                       ("pair_cluster", bk.pair_step)):
        got = make(bk.N_ROWS, cuda)(rep)
        want = make(bk.N_ROWS, cpu)(rep)
        for k, v in want.items():
            if not torch.equal(got[k].cpu(), v):
                raise AssertionError("bench_kernels %s rep on the card != "
                                     "the CPU: %s" % (name, k))
    s, st, en = bk.cover_inputs(bk.N_SV, bk.N_READS)
    wins = bk.cover_windows(s, rep)
    got = cover.cover_counts_cuda(wins, st, en, cuda)
    plain = cover_plain(*scaled_tensors(wins, st, en, cuda)).cpu().numpy()
    if not (np.array_equal(got, plain) and np.array_equal(
            got, cover_counts(wins, st, en))):
        raise AssertionError("bench_kernels cover rep != the plain version "
                             "or the host count")
    cv = rec["cover"]
    log("tools bench_kernels: stream %.4e B/s (%.3f of 3.35 TB/s), sort "
        "%.4e rows/s; DEL/INS program %.4e rows/s (%.3f of the sort), pair "
        "program %.4e rows/s (%.3f); cover %d x %d: end to end %.6f s "
        "(%.4e pairs/s; scaling %.6f s, upload %.6f s, kernel call %.6f s, "
        "fetch %.6f s), bare %.6f s (%.4e pairs/s), bound %.5f ms (%s): "
        "%.4f / %.4f of it; dense bound %.4f ms; %d candidate / %d "
        "compared pairs; rtt %.3e s; one rep of each equal to the CPU, the "
        "cover to the plain version and the host count"
        % (rec["stream_roofline_bytes_per_s"], rec["stream_vs_hbm_peak"],
           rec["sort_roofline_rows_per_s"],
           rec["indel_cluster"]["rows_per_s"],
           rec["indel_cluster"]["vs_sort_roofline"],
           rec["pair_cluster"]["rows_per_s"],
           rec["pair_cluster"]["vs_sort_roofline"], cv["n_sv"],
           cv["n_reads"], cv["s"], cv["pairs_per_s"], cv["scale_s"],
           cv["upload_s"], cv["kernel_s"], cv["fetch_s"], cv["bare_s"],
           cv["bare_pairs_per_s"], cv["bound_ms"], cv["bound_by"],
           cv["efficiency_vs_bound"], cv["bare_efficiency_vs_bound"],
           cv["dense_bound_ms"], cv["candidate_pairs"],
           cv["compared_pairs"], rec["rtt_s"]))
    res["tools"]["bench_kernels"] = rec


def _tools_replay(res: dict) -> None:
    """replay_eval's driver over the 12-row bed on the card: every row
    found at presence and genotype level, the cover kernel launched
    (counts set to 0 just before, read just after)."""
    import contextlib
    import io

    from cutesv_tpu_torch.ops import cover
    from cutesv_tpu_torch.tools import replay_eval

    bed = os.path.join(WORK, "replay_mix.bed.gz")
    write_replay_bed(bed)
    out = os.path.join(WORK, "replay_eval")
    shutil.rmtree(out, ignore_errors=True)
    buf = io.StringIO()
    cover.LAUNCHES = 0
    cover.LAST_SHAPE = (0, 0)
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = replay_eval.main(replay_eval_argv(bed, out, "cuda"))
    torch.cuda.synchronize()
    launches, shape = cover.LAUNCHES, list(cover.LAST_SHAPE)
    wall = time.time() - t0
    for line in buf.getvalue().splitlines():
        log("tools replay_eval | %s" % line)
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    windows = summary["_meta"]["windows"]
    for ty in ("DEL", "INS"):
        got = summary.get(ty, {})
        if rc != 0 or any(got.get(k) != REPLAY_ROWS // 2
                          for k in ("rows", "presence", "genotype")):
            raise AssertionError("replay_eval %s: %s (rc %d), not %d of %d "
                                 "at presence and genotype level"
                                 % (ty, got, rc, REPLAY_ROWS // 2,
                                    REPLAY_ROWS // 2))
    if not 1 <= launches <= windows:
        raise AssertionError("replay_eval launched the cover kernel %d times "
                             "over %d windows" % (launches, windows))
    log("tools replay_eval: 6/6 DEL and 6/6 INS at genotype level, force "
        "calling %s; %d window(s), cover launches %d, last at %s; %.1f s"
        % (json.dumps(summary.get("_force_call")), windows, launches, shape,
           wall))
    res["launches_by_path"]["replay_eval"] = launches
    res["main_shapes"]["replay_eval"] = shape
    res["tools"]["replay_eval"] = dict(summary=summary, launches=launches,
                                       wall_s=wall)


def _tools_pool(res: dict) -> None:
    """run_pool_baseline (host engine, Python reader, forked workers) on
    the all-types BAM after this process has used CUDA: its body equals
    the port's --engine host body of the same BAM."""
    from cutesv_tpu_torch import cli
    from cutesv_tpu_torch.tools.baseline_pool import run_pool_baseline

    corpus = res["corpora"]["alltypes"]
    out, wd = _fresh("tools", "baseline_pool")
    argv = [corpus["bam"], corpus["fa"], out, wd, "--genotype", "-s", "5",
            "--decoder", "python", "--engine", "host"]
    parser = cli.build_parser()
    cfg = cli.args_to_config(parser.parse_args(argv),
                             explicit=cli._explicit_dests(parser, argv))
    t0 = time.time()
    stats = run_pool_baseline(cfg, argv, device="cuda")
    wall = time.time() - t0
    if _body(out) != _body(corpus["host_vcf"]):
        raise AssertionError("baseline_pool: the pooled body differs from "
                             "the --engine host body")
    log("tools baseline_pool: %d records, %d calls; decode %.3f s, resolve "
        "%.3f s, emit %.3f s, total %.2f s (index build included, %.2f s "
        "wall); body equal to the --engine host body"
        % (stats["n_records"], stats["n_calls"], stats["decode_s"],
           stats["resolve_s"], stats["emit_s"], stats["total_s"], wall))
    res["tools"]["baseline_pool"] = dict(stats, wall_s=wall)


def phase_tools(res: dict) -> None:
    """The port's tools on the card (see the module docstring)."""
    t0 = time.time()
    res["tools"] = {}
    _tools_bench(res)
    _tools_replay(res)
    _tools_pool(res)
    res["tools"]["seconds"] = time.time() - t0
    log("tools: %.1f s" % res["tools"]["seconds"])


DIST_KEYS = ("shard_records", "allgather_mb", "allgather_total_mb",
             "allgather_s", "gather_mb", "gather_total_mb", "gather_s",
             "chroms_resolved", "wall_s")
# the device operations of a chrome trace, by event category
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_ms(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals (the
    trace's microseconds), in ms."""
    busy, end = 0.0, None
    for ts, dur in sorted((float(e["ts"]), float(e["dur"])) for e in events):
        if end is None or ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy / 1e3


def phase_profile(res: dict) -> None:
    """--profile on the all-types main path: the body is the main path's
    and the trace holds the cover kernel; prints its five longest device
    operations and the device's busy share of the resolve stage."""
    corpus = res["corpora"]["alltypes"]
    out, wd = _fresh("profile", "alltypes")
    stats = _drive("profile alltypes native_cuda",
                   [corpus["bam"], corpus["fa"], out, wd, "--genotype", "-s",
                    "5", "--decoder", "native", "--profile"], "cuda", {})
    if _body(out) != _body(corpus["vcf"]):
        raise AssertionError("profile: the VCF body differs from the main "
                             "path's")
    _check_main("profile alltypes", stats, ALLTYPES_GENOME_BP)
    trace = stats["profile_trace"]
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    cover_events = [e for e in device if e["cat"] == "kernel"
                    and "cover_count" in e.get("name", "")]
    if not cover_events:
        raise AssertionError(
            "profile: no cover kernel in %s (device operations: %s)"
            % (trace, sorted({e.get("name") for e in device})))
    by_name: dict = {}
    for e in device:
        tot = by_name.setdefault(e["name"], [0, 0.0])
        tot[0] += 1
        tot[1] += float(e["dur"]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    busy = _busy_ms(device)
    resolve_ms = stats["resolve_s"] * 1e3
    log("profile alltypes: trace %s, %d events, %d device operations (%d "
        "of the cover kernel); device busy %.3f ms of the resolve stage's "
        "%.3f ms (%.2f%%)" % (os.path.relpath(trace, REPO), len(events),
                              len(device), len(cover_events), busy,
                              resolve_ms, 100 * busy / resolve_ms))
    for name, (count, ms) in top:
        log("profile top device operation: %.4f ms in %d call(s): %s"
            % (ms, count, name[:140]))
    res["launches_by_path"]["profile_alltypes"] = stats["launches"]
    res["profile"] = dict(
        resolve_s=stats["resolve_s"], device_busy_ms=busy,
        device_ops=len(device), cover_kernel_events=len(cover_events),
        top=[dict(name=n[:140], count=c, ms=ms) for n, (c, ms) in top])


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
    from cutesv_tpu_torch.tools.bench_kernels import card_line

    card = card_line()
    log("card: %s" % card)
    mode = compute_mode()
    log("compute mode: %s" % mode)
    log("host: %d usable cores (sched_getaffinity), %d in all"
        % (len(os.sched_getaffinity(0)), os.cpu_count()))
    log("codecs: %s" % codec_line())
    log("python codec modules: %s" % pycodec_line())
    res: dict = {}
    phase_build()
    phase_k1(res)
    phase_cluster(res)
    phase_pair(res)
    phase_e2e(res)
    phase_alltypes(res)
    phase_cram(res)
    phase_forcecall(res)
    phase_distributed(res, mode)
    phase_shards(res)
    phase_tools(res)
    phase_profile(res)
    phase_k1_main(res)
    # every phase passed (each raises otherwise), so the kernel is equal;
    # ``launches`` is the all-types main path's count (this port's default
    # discovery path over every SV type), launches_by_path each main
    # path's
    log(json.dumps({"kernels": [dict(
        name="cover_count", route="cuda",
        source="cutesv_tpu_torch/csrc/cover_count.cu",
        replaces="cutesv_tpu/ops/pallas_sweep.py:28",
        launches=res["launches_by_path"]["alltypes"],
        launches_by_path=res["launches_by_path"], equal=True,
        library_ms=None, shape=[K1_WINDOWS, K1_READS], **res["k1"])],
        "cluster_ms": res["cluster_ms"],
        "pair_cluster_ms": res["pair_cluster_ms"], "e2e": res["e2e"],
        "alltypes": res["alltypes"],
        "alltypes_recall": res["alltypes_recall"], "cram": res["cram"],
        "forcecall": res["forcecall"], "distributed": res["distributed"],
        "shards": res["shards"], "tools": res["tools"],
        "profile": res["profile"]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
