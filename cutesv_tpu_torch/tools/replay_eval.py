"""Whole-genome replay evaluation driver.

Loops every chromosome of a VISOR HACk truth-bed set (e.g. the
reference's simulation/sim_*.bed.gz) through the replay simulator
(tools/simulate.py::replay), calls SVs on each window, scores each
window with the reference's matching rules (tools/eval_sim.py,
reference src/benchmarks/eval_sim.py:97-173), and prints ONE aggregate
presence/genotype recall table over the full truth set. Calls run on
``--device`` (``cuda`` unless ``--device cpu`` is given), as the port's
CLI does.

DEL/INS/INV recall comes from IID mode, DUP from DUP mode, BND from BND
mode — mirroring how the reference's evaluation counts DUP as INS in
DUP mode (reference eval_sim.py:44-45).

Example (the reference's full truth set, every chromosome):

    python -m cutesv_tpu_torch.tools.replay_eval \
        --beds $SIM/sim_del.bed.gz,$SIM/sim_ins.bed.gz,$SIM/sim_dup.bed.gz,$SIM/sim_inv.bed.gz,$SIM/sim_tra.bed.gz \
        --out /tmp/replay_full
"""
from __future__ import annotations

import argparse
import gzip
import logging
import os
import shutil
import sys
import time
from typing import Dict, List

log = logging.getLogger("cutesv_tpu_torch")

# which aggregate SV types are taken from which eval mode
MODE_TYPES = {"IID": ("DEL", "INS", "INV"), "DUP": ("DUP",),
              "BND": ("BND",)}


def bed_extents(paths: List[str]) -> Dict[str, int]:
    """chrom -> max end coordinate over all truth rows (mate anchors of
    translocations are remapped by the replayer, so only col 1-2 count)."""
    ext: Dict[str, int] = {}
    for path in paths:
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) < 5:
                    continue
                ext[f[0]] = max(ext.get(f[0], 0), int(f[2]))
    return ext


def _chrom_sort_key(c: str):
    return (0, int(c)) if c.isdigit() else (1, c)


def eval_window(vcf_path: str, truth_bed: str, zygosity_bed: str,
                bias: float, offset: int) -> Dict[str, list]:
    """Score one window's VCF; returns {svtype: [matched1, matched2,
    total]} on the TRUTH side (recall numerators/denominator)."""
    from cutesv_tpu_torch.tools.eval_sim import (MODES, evaluate,
                                                 load_ans, load_callset,
                                                 load_gt)
    out: Dict[str, list] = {}
    for mode, take in MODE_TYPES.items():
        ans = load_ans(truth_bed)
        genotype = load_gt(zygosity_bed)
        call, _ = load_callset(vcf_path, MODES[mode])
        evaluate(call, ans, bias, offset, 1, genotype)
        for svtype in take:
            rows = ans.get(svtype, [])
            slot = {"INS": 2, "BND": 4}.get(svtype, 3) + 1
            out[svtype] = [sum(1 for r in rows if r[slot] >= 1),
                           sum(1 for r in rows if r[slot] >= 2),
                           len(rows)]
    return out


def _gt_map(path: str) -> Dict[tuple, tuple]:
    """(chrom, id) -> (svtype, GT) for every record of a VCF."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            svtype = f[2].split(".")[1] if "." in f[2] else "?"
            out[(f[0], f[2])] = (svtype, f[9].split(":")[0])
    return out


def force_call_window(prefix: str, wd: str, disc_cfg,
                      agg: Dict[str, list], device=None) -> None:
    """Regenotype the window's discovery VCF (-Ivcf round trip) with the
    discovery run's exact settings; accumulate per-type GT concordance
    into ``agg``."""
    import dataclasses

    from cutesv_tpu_torch.forcecalling import run_force_calling

    fc_wd = wd + "_fc"
    os.makedirs(fc_wd, exist_ok=True)
    cfg = dataclasses.replace(disc_cfg, output=prefix + ".fc.vcf",
                              work_dir=fc_wd, Ivcf=prefix + ".vcf")
    run_force_calling(cfg, ["replay_eval", "fc"], device=device)
    disc = _gt_map(prefix + ".vcf")
    regt = _gt_map(prefix + ".fc.vcf")
    for key, (svtype, gt) in disc.items():
        a = agg.setdefault(svtype, [0, 0])
        a[1] += 1
        if key in regt and regt[key][1] == gt:
            a[0] += 1
    shutil.rmtree(fc_wd, ignore_errors=True)


def messy_eval(out_dir: str, genome_mb: float, seed: int,
               min_support: int, bias: float, offset: int,
               engine: str, decoder: str, force_call: bool,
               device=None) -> None:
    """Generate the messy stress corpus (tools/simulate.py --messy), run
    one full discovery pass, score presence/genotype against its truth
    set, and optionally round-trip force calling. The heterogeneity
    (coverage waves down to ~5x, ONT noise density, chimeras) is the
    point: deltas vs the clean-corpus table are expected and documented
    in docs/EVAL.md."""
    from cutesv_tpu_torch.config import Config
    from cutesv_tpu_torch.pipeline import run_pipeline
    from cutesv_tpu_torch.tools.simulate import simulate_messy

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "messy")
    t0 = time.time()
    info = simulate_messy(prefix, genome_mb=genome_mb, seed=seed)
    log.info("messy corpus: %d reads (%.1fs)", info["n_reads"],
             time.time() - t0)
    wd = prefix + "_wd"
    if os.path.isdir(wd):
        shutil.rmtree(wd)
    os.makedirs(wd)
    cfg = Config(input=prefix + ".bam", reference=prefix + ".fa",
                 output=prefix + ".vcf", work_dir=wd, genotype=True,
                 min_support=min_support, engine=engine, decoder=decoder)
    run_pipeline(cfg, ["replay_eval", "messy"], device=device)
    res = eval_window(prefix + ".vcf", prefix + ".truth.bed",
                      prefix + ".zygosity.bed", bias, offset)
    print("type\ttruth_rows\tpresence\tgenotype")
    for svtype in ("DEL", "INS", "DUP", "INV", "BND"):
        if svtype not in res:
            continue
        m1, m2, tot = res[svtype]
        print("%s\t%d\t%d (%.1f%%)\t%d (%.1f%%)"
              % (svtype, tot, m1, 100.0 * m1 / max(tot, 1),
                 m2, 100.0 * m2 / max(tot, 1)))
    if force_call:
        fc_agg: Dict[str, list] = {}
        force_call_window(prefix, wd, cfg, fc_agg, device)
        print("force-calling GT concordance (regenotyped vs discovery):")
        for svtype in sorted(fc_agg):
            m, tot = fc_agg[svtype]
            print("%s\t%d/%d (%.1f%%)"
                  % (svtype, m, tot, 100.0 * m / max(tot, 1)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="replay_eval",
        description="Replay VISOR truth beds genome-wide and report "
                    "aggregate presence/genotype recall.")
    p.add_argument("--beds", required=False, default=None,
                   help="Comma-separated VISOR HACk truth beds (.bed/.gz).")
    p.add_argument("--out", required=True, help="Scratch/output directory.")
    p.add_argument("--chroms", default=None,
                   help="Comma-separated chromosome subset "
                        "(default: every chromosome in the beds).")
    p.add_argument("--window_mb", default=60, type=int,
                   help="Replay window span in Mb (allocation cap 64).")
    p.add_argument("--coverage", default=12, type=int)
    p.add_argument("--min_support", default=3, type=int)
    p.add_argument("--max_size", default=100000, type=int,
                   help="Caller max SV size (-1 = unlimited; the default "
                        "mirrors the reference and drops >100kb DUPs).")
    p.add_argument("--bias", default=0.7, type=float)
    p.add_argument("--offset", default=1000, type=int)
    p.add_argument("--engine", default="auto")
    p.add_argument("--decoder", default="auto")
    p.add_argument("--device", default="cuda",
                   help="Device of the calls: cuda (default; cuda:k pins "
                        "card k) or cpu.")
    p.add_argument("--keep", action="store_true",
                   help="Keep per-window bam/fa/vcf artifacts.")
    p.add_argument("--force_call", action="store_true",
                   help="Also regenotype each window's discovery VCF "
                        "(-Ivcf round trip) and report GT concordance.")
    p.add_argument("--messy", type=float, default=None, metavar="MB",
                   help="Instead of replaying beds, generate the messy "
                        "stress corpus of MB megabases and evaluate it.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")

    if args.messy is not None:
        messy_eval(args.out, args.messy, args.seed, args.min_support,
                   args.bias, args.offset, args.engine, args.decoder,
                   args.force_call, args.device)
        return 0
    if not args.beds:
        p.error("--beds is required unless --messy is given")

    from cutesv_tpu_torch.config import Config
    from cutesv_tpu_torch.pipeline import run_pipeline
    from cutesv_tpu_torch.tools.simulate import replay

    beds = args.beds.split(",")
    extents = bed_extents(beds)
    chroms = (args.chroms.split(",") if args.chroms
              else sorted(extents, key=_chrom_sort_key))
    w = args.window_mb * 1_000_000
    os.makedirs(args.out, exist_ok=True)
    agg: Dict[str, list] = {}
    fc_agg: Dict[str, list] = {}
    n_windows = 0
    dropped_total = 0
    t0 = time.time()
    for chrom in chroms:
        extent = extents.get(chrom, 0) + 10_000
        for lo in range(0, extent, w):
            hi = min(lo + w, extent)
            tag = "%s_%d_%d" % (chrom, lo // 1_000_000, hi // 1_000_000)
            prefix = os.path.join(args.out, tag)
            counts = replay(prefix, beds, "%s:%d-%d" % (chrom, lo, hi),
                            coverage=args.coverage)
            dropped_total += counts["n_dropped"]
            if counts["n_sv"] == 0:
                if not args.keep:
                    for suffix in (".bam", ".fa", ".truth.bed",
                                   ".zygosity.bed"):
                        try:
                            os.remove(prefix + suffix)
                        except OSError:
                            pass
                continue
            n_windows += 1
            wd = prefix + "_wd"
            if os.path.isdir(wd):
                shutil.rmtree(wd)
            os.makedirs(wd)
            cfg = Config(input=prefix + ".bam", reference=prefix + ".fa",
                         output=prefix + ".vcf", work_dir=wd,
                         genotype=True, min_support=args.min_support,
                         max_size=args.max_size, engine=args.engine,
                         decoder=args.decoder)
            run_pipeline(cfg, ["replay_eval", tag], device=args.device)
            if args.force_call:
                force_call_window(prefix, wd, cfg, fc_agg, args.device)
            res = eval_window(prefix + ".vcf", prefix + ".truth.bed",
                              prefix + ".zygosity.bed", args.bias,
                              args.offset)
            for svtype, (m1, m2, tot) in res.items():
                a = agg.setdefault(svtype, [0, 0, 0])
                a[0] += m1
                a[1] += m2
                a[2] += tot
            log.info("window %s: %s", tag,
                     " ".join("%s=%d/%d/%d" % (s, v[0], v[1], v[2])
                              for s, v in sorted(res.items())))
            if not args.keep:
                shutil.rmtree(wd, ignore_errors=True)
                for suffix in (".bam", ".fa", ".fa.fai", ".vcf", ".fc.vcf",
                               ".truth.bed", ".zygosity.bed"):
                    try:
                        os.remove(prefix + suffix)
                    except OSError:
                        pass
    print("type\ttruth_rows\tpresence\tgenotype")
    for svtype in ("DEL", "INS", "DUP", "INV", "BND"):
        if svtype not in agg:
            continue
        m1, m2, tot = agg[svtype]
        print("%s\t%d\t%d (%.1f%%)\t%d (%.1f%%)"
              % (svtype, tot, m1, 100.0 * m1 / max(tot, 1),
                 m2, 100.0 * m2 / max(tot, 1)))
    if args.force_call and fc_agg:
        print("force-calling GT concordance (regenotyped vs discovery):")
        for svtype in sorted(fc_agg):
            m, tot = fc_agg[svtype]
            print("%s\t%d/%d (%.1f%%)"
                  % (svtype, m, tot, 100.0 * m / max(tot, 1)))
    print("windows=%d replayer_dropped=%d elapsed=%.1fs"
          % (n_windows, dropped_total, time.time() - t0))
    # machine-readable artifact alongside the printed table
    import json
    summary = {s: dict(rows=v[2], presence=v[0], genotype=v[1])
               for s, v in agg.items()}
    summary["_meta"] = dict(windows=n_windows, dropped=dropped_total)
    if args.force_call and fc_agg:
        summary["_force_call"] = {s: dict(match=m, rows=t)
                                  for s, (m, t) in fc_agg.items()}
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
