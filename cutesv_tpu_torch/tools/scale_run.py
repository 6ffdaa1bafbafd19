"""Genome-scale run of the port: wall, stage split, calls and peak RSS.

Runs the full native-decoder, device-engine discovery pipeline on a
corpus written by ``cutesv_tpu_torch.tools.simulate`` (e.g. a
``--human_layout`` human-scale one), each run in a fresh process (a
clean ``VmHWM``), and prints one ``SCALE_RUN {json}`` line per run with
the keys of the repo's ``tools/scale_run.py``: wall, per-stage seconds,
records, calls, ``vm_hwm_gb`` and ``rss_anon_end_gb`` of the run's
process (where /proc/self/status lacks VmHWM the peak comes from
``getrusage``, and lacking RssAnon the end size is null), the input
sizes, and ``anon_est_gb`` (``VmHWM`` less the mapped BAM and FASTA,
whose touched pages are clean and reclaimable).

    python -m cutesv_tpu_torch.tools.scale_run PREFIX [--runs 2] \
        [--min_support 10] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _proc_status() -> dict:
    """This process's peak and resident sizes in bytes, from
    /proc/self/status; where it has no VmHWM (not every kernel writes
    it), the peak is ``getrusage``'s ``ru_maxrss``."""
    import resource

    out = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(("VmHWM", "VmRSS", "RssAnon", "RssFile")):
                k, v = line.split(":", 1)
                out[k] = int(v.strip().split()[0]) * 1024  # kB -> bytes
    if "VmHWM" not in out:
        out["VmHWM"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024  # kB on Linux
    return out


def run_child(prefix: str, min_support: int, device: str) -> dict:
    """One run in this process; prints and returns its record."""
    from cutesv_tpu_torch.config import Config
    from cutesv_tpu_torch.pipeline import run_pipeline

    bam = prefix + ".bam"
    fa = prefix + ".fa"
    outdir = prefix + "_work"
    if os.path.isdir(outdir):
        shutil.rmtree(outdir)
    os.makedirs(outdir)
    cfg = Config(input=bam, reference=fa,
                 output=os.path.join(outdir, "scale.vcf"), work_dir=outdir,
                 genotype=True, min_support=min_support, engine="device",
                 decoder="native")
    t0 = time.time()
    stats = run_pipeline(cfg, ["scale_run"], device=device)
    wall = time.time() - t0
    st = _proc_status()
    rec = {
        "wall_s": round(wall, 2),
        "decode_s": round(stats.get("decode_s", 0.0), 2),
        "native_s": round(stats.get("native_s", 0.0), 2),
        "walk_s": round(stats.get("walk_s", 0.0), 2),
        "store_s": round(stats.get("store_s", 0.0), 2),
        "resolve_s": round(stats.get("resolve_s", 0.0), 2),
        "emit_s": round(stats.get("emit_s", 0.0), 2),
        "n_records": stats.get("n_records"),
        "n_calls": stats.get("n_calls"),
        "vm_hwm_gb": round(st["VmHWM"] / 1e9, 2),
        # null where /proc/self/status has no RssAnon
        "rss_anon_end_gb": (round(st["RssAnon"] / 1e9, 2)
                            if "RssAnon" in st else None),
        "bam_gb": round(os.path.getsize(bam) / 1e9, 2),
        "fa_gb": round(os.path.getsize(fa) / 1e9, 2),
    }
    rec["anon_est_gb"] = round(
        max(0.0, rec["vm_hwm_gb"] - rec["bam_gb"] - rec["fa_gb"]), 2)
    print("SCALE_RUN " + json.dumps(rec), flush=True)
    return rec


def scale_runs(prefix: str, runs: int = 2, min_support: int = 10,
               device: str = "cuda") -> list:
    """``runs`` runs, each in a fresh process (run 1 is cold in the page
    cache, the last warm); echoes each child's output and returns the
    records. A failed child raises."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    records = []
    for i in range(runs):
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "cutesv_tpu_torch.tools.scale_run",
             prefix, "--child", "--min_support", str(min_support),
             "--device", device], env=env, stdout=subprocess.PIPE,
            text=True)
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
        if res.returncode != 0:
            raise RuntimeError("scale_run: child failed rc=%d"
                               % res.returncode)
        records += [json.loads(line.split(" ", 1)[1])
                    for line in res.stdout.splitlines()
                    if line.startswith("SCALE_RUN ")]
        print("run %d/%d done (%.1fs with the interpreter's start)"
              % (i + 1, runs, time.time() - t0), file=sys.stderr)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("prefix", help="simulate output prefix (PREFIX.bam/.fa)")
    p.add_argument("--runs", type=int, default=2,
                   help="run count; run 1 is cold (page cache), last is warm")
    p.add_argument("--min_support", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="device of the run (cuda, cuda:k or cpu)")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        run_child(args.prefix, args.min_support, args.device)
        return 0
    scale_runs(args.prefix, args.runs, args.min_support, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
