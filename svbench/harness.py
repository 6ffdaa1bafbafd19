"""One run of one cell: make the sample from the seed, warm up with one
whole call, call ``cutesv_tpu_torch.cli.run`` back to back for the
window, then hold every call's VCF body to the frozen copy's
(``reference/``) and to the planted sites (``truth.py``).

The run's measurements go into a :class:`Run`, which the metric readers
(``metrics/<name>.py``) read; the harness itself names no metric.
"""
from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from svbench import corpus, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "cutesv_tpu")
# the program's layer entries that a traced run times, by span name
SPAN_ENTRIES = (("decode", "pipeline", "decode_bam"),
                ("store", "sigstore", "build_store_native"),
                ("resolve", "pipeline", "resolve_all"),
                ("genotype", "pipeline", "_batched_cover_multi"),
                ("emit", "vcf", "format_chrom_records"),
                ("emit", "vcf", "write_vcf"))


def forbidden_modules(names=None) -> List[str]:
    """Top-level names (the part before the first dot, compared whole)
    of loaded modules that a run must not load."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None
                                      else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def process_start() -> float:
    """The epoch second at which this process started."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def cpu_times() -> List[int]:
    """The machine's CPU times (``/proc/stat``: user, nice, system, idle,
    iowait, irq, softirq, steal) in clock ticks."""
    with open("/proc/stat") as fh:
        return [int(x) for x in fh.readline().split()[1:9]]


def n_workers() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


class RssSampler(threading.Thread):
    """High-water mark of this process's anonymous resident memory,
    sampled every 10 ms while running: resident less file-backed and
    shared pages (``/proc/self/statm``), which is ``RssAnon``."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak_kb = 0
        self._halt = threading.Event()

    PAGE_KB = os.sysconf("SC_PAGE_SIZE") // 1024

    @classmethod
    def read_kb(cls) -> int:
        with open("/proc/self/statm") as fh:
            _, resident, shared = fh.read().split()[:3]
        return (int(resident) - int(shared)) * cls.PAGE_KB

    def run(self):
        while not self._halt.is_set():
            self.peak_kb = max(self.peak_kb, self.read_kb())
            self._halt.wait(0.01)

    def stop(self) -> int:
        self._halt.set()
        self.join()
        self.peak_kb = max(self.peak_kb, self.read_kb())
        return self.peak_kb


@dataclass
class Run:
    """What one run measured; the metric readers' input."""
    records_per_call: int
    setup_s: float = 0.0
    calls: List[dict] = field(default_factory=list)
    peak_anon_kb: int = 0
    # traced runs: (name, call index, t0, t1) host spans around the
    # program's layer entries, and (name, t0, t1) device operations, all
    # in epoch seconds
    spans: List[tuple] = field(default_factory=list)
    device_ops: List[tuple] = field(default_factory=list)

    @property
    def window(self) -> tuple:
        return self.calls[0]["t0"], self.calls[-1]["t1"]

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return t1 - t0

    def busy_intervals(self) -> List[tuple]:
        """The union of the device operations' intervals in the window."""
        t0, t1 = self.window
        out: List[list] = []
        for a, b in sorted((max(a, t0), min(b, t1))
                           for _, a, b in self.device_ops):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def label_at(self, t: float) -> str:
        """The innermost host span at epoch second ``t``."""
        best = None
        for name, k, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = ("call%d.%s" % (k, name), a, b)
        return best[0] if best else "between_calls"


class Spans:
    """Host spans around the program's layer entries: each entry of
    :data:`SPAN_ENTRIES` is wrapped for the traced window and restored
    after it."""

    def __init__(self, run: Run):
        self.run = run
        self.call = -1
        self._saved = []

    def __enter__(self):
        import importlib
        for name, mod_name, attr in SPAN_ENTRIES:
            mod = importlib.import_module("cutesv_tpu_torch." + mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name: str, fn: Callable):
        spans = self.run.spans

        def timed(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                spans.append((name, self.call, t0, time.time()))
        return timed

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)


def _device_ops(prof) -> List[tuple]:
    """(name, t0, t1) of every device operation in a torch.profiler
    trace (kineto's clock is the epoch's)."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            t0 = ev.start_ns() / 1e9
            out.append((ev.name(), t0, t0 + ev.duration_ns() / 1e9))
    return out


def body_lines(path: str) -> List[str]:
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def _split(line: str):
    """(call key, genotype part) of a record line: the genotype part is
    QUAL, FILTER, the sample column and INFO's AF; the rest is the call."""
    f = line.rstrip("\n").split("\t")
    info = [kv for kv in f[7].split(";") if not kv.startswith("AF=")]
    af = [kv for kv in f[7].split(";") if kv.startswith("AF=")]
    return (tuple(f[:5] + [";".join(info)]),
            tuple([f[5], f[6]] + af + f[8:]))


def compare(body: List[str], ref: List[str]) -> Dict[str, int]:
    """How one call's VCF body departs from the reference's: records
    whose call (position, type, alleles, INFO) has no counterpart, and
    matched records whose genotype fields differ."""
    from collections import Counter
    mine = [_split(x) for x in body]
    theirs = [_split(x) for x in ref]
    a, b = Counter(k for k, _ in mine), Counter(k for k, _ in theirs)
    unmatched = sum(((a - b) + (b - a)).values())
    gt_of = {}
    for k, g in theirs:
        gt_of.setdefault(k, []).append(g)
    gt_diff = 0
    for k, g in mine:
        cands = gt_of.get(k)
        if cands:
            if g in cands:
                cands.remove(g)
            else:
                gt_diff += 1
                cands.pop(0)
    return dict(records_unmatched=unmatched,
                genotype_fields_differing=gt_diff,
                body_differs=int(body != ref))


def card_info(device: str) -> dict:
    import torch
    if not device.startswith("cuda"):
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        info["power_limit_w"] = float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log=None) -> dict:
    """One run; returns the result object (without the forbidden-module
    check, which the caller makes last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = process_start() if t_start is None else t_start
    config, traffic = cell["config_data"], cell["traffic_data"]
    work = tempfile.mkdtemp(prefix="svbench-")
    try:
        return _run(cell, config, traffic, seed, seconds, trace, device,
                    t_start, work, log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, config, traffic, seed, seconds, trace, device, t_start,
         work, log) -> dict:
    import torch
    from cutesv_tpu_torch import cli
    from cutesv_tpu_torch.ops import cover

    if device.startswith("cuda"):
        torch.zeros(1, device=device)
    bam, fasta = os.path.join(work, "sample.bam"), os.path.join(work,
                                                                "ref.fa")
    t = time.time()
    made = corpus.write_corpus(seed, config, traffic, bam, fasta,
                               n_workers())
    log("corpus: %d records, %d bases, %.2f s"
        % (made["records"], made["bases"], time.time() - t))
    run = Run(records_per_call=made["records"])

    def call(k: int) -> dict:
        vcf = os.path.join(work, "call%03d.vcf" % k)
        argv = [bam, fasta, vcf, os.path.join(work, "wd%03d" % k),
                *config["argv"], "--device", device]
        cover.LAUNCHES = 0
        cover.LAST_SHAPE = (0, 0)
        t0 = time.time()
        rec = dict(t0=t0, vcf=vcf, error=None)
        try:
            rec["stats"] = cli.run(argv)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
        except Exception:
            rec["error"] = traceback.format_exc()
            log(rec["error"])
        rec.update(t1=time.time(), launches=cover.LAUNCHES,
                   shape=tuple(cover.LAST_SHAPE))
        return rec

    warm = call(-1)
    log("warm-up call: %.2f s%s" % (warm["t1"] - warm["t0"],
                                    " (failed)" if warm["error"] else ""))
    gc.collect()
    prof = spans = None
    if trace:
        if device.startswith("cuda"):
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        spans = Spans(run).__enter__()
    sampler = RssSampler()
    sampler.start()
    run.setup_s = time.time() - t_start
    cpu0 = cpu_times()
    w0 = time.time()
    while not run.calls or run.calls[-1]["t1"] - w0 < seconds:
        if spans is not None:
            spans.call = len(run.calls)
        run.calls.append(call(len(run.calls)))
    run.peak_anon_kb = sampler.stop()
    ticks = [b - a for a, b in zip(cpu0, cpu_times())]
    log("machine over the window: %.1f%% busy, %.2f%% stolen; "
        "call seconds %s" % (100 - 100 * ticks[3] / max(1, sum(ticks)),
                             100 * ticks[7] / max(1, sum(ticks)),
                             " ".join("%.2f" % (c["t1"] - c["t0"])
                                      for c in run.calls)))
    if trace:
        spans.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
        run.device_ops = _device_ops(prof)
        del prof
    dev = card_info(device)
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return finish(run, cell, config, traffic, seed, trace, dev, log)


def finish(run: Run, cell, config, traffic, seed, trace, dev, log) -> dict:
    """Metrics, the output check, and the result."""
    from svbench import truth
    from svbench.reference import caller

    failed = sum(1 for c in run.calls if c["error"])
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for name in names:
        value = registry.reader(name)(run)
        if value is not None:
            metrics[name] = dict(value=value, unit=cell["units"][name])
    log("window: %d calls in %.3f s, reads_per_s %.1f%s"
        % (len(run.calls), run.window_s,
           len(run.calls) * run.records_per_call / run.window_s,
           " (traced)" if trace else ""))
    t = time.time()
    ref, sites = caller.reference(seed, config, traffic, n_workers())
    bias = truth.cluster_bias(caller.settings(config["argv"]).values)
    checks = dict(calls_failed=failed, records_unmatched=0,
                  genotype_fields_differing=0, calls_differing=0,
                  **dict.fromkeys(truth.NUMBERS, 0))
    for c in run.calls:
        if c["error"]:
            continue
        body = body_lines(c["vcf"])
        d = compare(body, ref)
        d.update(truth.check(body, sites, bias))
        checks["calls_differing"] += d.pop("body_differs")
        for k, v in d.items():
            checks[k] = max(checks[k], v)
    log("reference: %d records, %d planted sites called, %.2f s"
        % (len(ref), len(sites), time.time() - t))
    limits = dict.fromkeys(checks, 0)
    limits.update(registry.limits(cell["name"]))
    result = dict(correct=(all(v <= limits[k] for k, v in checks.items())
                           and bool(ref) and bool(sites)),
                  attempted=len(run.calls), failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        result["device"].update(busy_s=run.busy_s(), window_s=run.window_s)
        result["breakdown"] = breakdown(run)
    result["checks"] = {k: dict(value=v, limit=limits[k])
                        for k, v in checks.items()}
    result["checks"]["reference_records"] = dict(value=len(ref),
                                                 limit="> 0")
    result["checks"]["truth_sites"] = dict(value=len(sites), limit="> 0")
    return result


def breakdown(run: Run) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps labelled by the host span they fell in."""
    per: Dict[str, float] = {}
    t0, t1 = run.window
    for name, a, b in run.device_ops:
        if b > t0 and a < t1:
            # a kernel's name without its template and parameter lists
            short = name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0].replace("void ", "")
            short = short.strip() or name
            per[short] = per.get(short, 0.0) + (min(b, t1) - max(a, t0))
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    edges = [t0] + [x for iv in run.busy_intervals() for x in iv] + [t1]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k])
                   for k in range(0, len(edges) - 1, 2)), reverse=True)[:10]
    return dict(device_ops=[[n, s] for n, s in ops],
                idle_gaps=[[run.label_at(a + g / 2), g] for g, a in gaps])
