"""Command-line interface of the PyTorch/CUDA port.

Flag surface mirrors the reference (parseArgs, cuteSV_Description.py:53-263)
and the cutesv_tpu CLI, plus:
  --preset {clr,ccs,hifi,ont}  expands the documented per-platform values
  --engine {auto,device,host}  select the GPU or oracle clustering engine
  --device {cuda,cuda:k,cpu}   where the device engine runs (default cuda)

Run as ``python -m cutesv_tpu_torch.cli in.bam ref.fa out.vcf work_dir``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time

from cutesv_tpu_torch import __version__
from cutesv_tpu_torch.config import Config, apply_preset

USAGE = """\
cutesv-tpu-torch %s — GPU (PyTorch/CUDA) long-read structural-variant caller
(capability-compatible with cuteSV 2.1.4)

Suggested per-platform settings (or use --preset):
  PacBio CLR:  --max_cluster_bias_INS 100  --diff_ratio_merging_INS 0.3
               --max_cluster_bias_DEL 200  --diff_ratio_merging_DEL 0.5
  PacBio CCS:  --max_cluster_bias_INS 1000 --diff_ratio_merging_INS 0.9
               --max_cluster_bias_DEL 1000 --diff_ratio_merging_DEL 0.5
  ONT:         --max_cluster_bias_INS 100  --diff_ratio_merging_INS 0.3
               --max_cluster_bias_DEL 100  --diff_ratio_merging_DEL 0.3
""" % __version__


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        prog="cutesv-tpu-torch", description=USAGE,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--version", "-v", action="version",
                   version="%(prog)s " + __version__)
    p.add_argument("input", metavar="[BAM]", type=str,
                   help="Sorted .bam or .cram file from NGMLR or Minimap2 "
                        "(a CRAM is decoded against the reference).")
    p.add_argument("reference", type=str,
                   help="The reference genome in fasta format.")
    p.add_argument("output", type=str, help="Output VCF format file.")
    p.add_argument("work_dir", type=str,
                   help="Work-directory for checkpoints/signatures")

    p.add_argument("-t", "--threads", type=int, default=d.threads,
                   help="Number of host threads to use.[%(default)s]")
    p.add_argument("-b", "--batches", type=int, default=d.batches,
                   help="Batch of genome segmentation interval (accepted for "
                        "cuteSV compatibility; streaming decode makes it "
                        "a no-op).[%(default)s]")
    p.add_argument("-S", "--sample", type=str, default=d.sample,
                   help="Sample name/id")
    p.add_argument("--retain_work_dir", action="store_true",
                   help="Enable to retain temporary folder and files.")
    p.add_argument("--write_old_sigs", action="store_true",
                   help="Write legacy .sigs text files in the work dir.")
    p.add_argument("--report_readid", action="store_true",
                   help="Enable to report supporting read ids for each SV.")
    p.add_argument("--ignore_sequence", action="store_true",
                   help="Do not output sequences for SVs.")

    g = p.add_argument_group("Collection of SV signatures")
    g.add_argument("-p", "--max_split_parts", type=int,
                   default=d.max_split_parts,
                   help="Maximum number of split segments a read may be "
                        "aligned before it is ignored (-1 = all).[%(default)s]")
    g.add_argument("-q", "--min_mapq", type=int, default=d.min_mapq,
                   help="Minimum mapping quality of alignments.[%(default)s]")
    g.add_argument("-r", "--min_read_len", type=int, default=d.min_read_len,
                   help="Ignore reads shorter than this.[%(default)s]")
    g.add_argument("-md", "--merge_del_threshold", type=int,
                   default=d.merge_del_threshold,
                   help="Max distance of DEL signals to merge.[%(default)s]")
    g.add_argument("-mi", "--merge_ins_threshold", type=int,
                   default=d.merge_ins_threshold,
                   help="Max distance of INS signals to merge.[%(default)s]")
    g.add_argument("-include_bed", dest="include_bed", type=str, default=None,
                   help="Only detect SVs in regions in the BED file. [NULL]")

    g = p.add_argument_group("Generation of SV clusters")
    g.add_argument("-s", "--min_support", type=int, default=d.min_support,
                   help="Minimum supporting reads per SV.[%(default)s]")
    g.add_argument("-l", "--min_size", type=int, default=d.min_size,
                   help="Minimum SV size to report.[%(default)s]")
    g.add_argument("-L", "--max_size", type=int, default=d.max_size,
                   help="Maximum SV size to report (-1 = all).[%(default)s]")
    g.add_argument("-sl", "--min_siglength", type=int,
                   default=d.min_siglength,
                   help="Minimum SV signal length to extract.[%(default)s]")

    g = p.add_argument_group("Computing genotypes")
    g.add_argument("--genotype", action="store_true",
                   help="Enable to generate genotypes.")
    g.add_argument("--gt_round", type=int, default=d.gt_round,
                   help="Max iterations of read scanning per site.[%(default)s]")
    g.add_argument("--read_range", type=int, default=d.read_range,
                   help="Interval range for counting read distribution.[%(default)s]")

    g = p.add_argument_group("Force calling")
    g.add_argument("-Ivcf", dest="Ivcf", type=str, default=None,
                   help="Force calling/regenotyping: re-genotype every site "
                        "of the given VCF against this BAM's signatures "
                        "(enabled here; the reference CLI disables it).")

    g = p.add_argument_group("Advanced")
    g.add_argument("--max_cluster_bias_INS", type=int,
                   default=d.max_cluster_bias_INS)
    g.add_argument("--diff_ratio_merging_INS", type=float,
                   default=d.diff_ratio_merging_INS)
    g.add_argument("--max_cluster_bias_DEL", type=int,
                   default=d.max_cluster_bias_DEL)
    g.add_argument("--diff_ratio_merging_DEL", type=float,
                   default=d.diff_ratio_merging_DEL)
    g.add_argument("--max_cluster_bias_INV", type=int,
                   default=d.max_cluster_bias_INV)
    g.add_argument("--max_cluster_bias_DUP", type=int,
                   default=d.max_cluster_bias_DUP)
    g.add_argument("--max_cluster_bias_TRA", type=int,
                   default=d.max_cluster_bias_TRA)
    g.add_argument("--diff_ratio_filtering_TRA", type=float,
                   default=d.diff_ratio_filtering_TRA)
    g.add_argument("--remain_reads_ratio", type=float,
                   default=d.remain_reads_ratio)

    g = p.add_argument_group("Engine (cutesv-tpu-torch specific)")
    g.add_argument("--preset", type=str, default=None,
                   choices=["clr", "ccs", "hifi", "ont"],
                   help="Per-platform parameter preset.")
    g.add_argument("--engine", type=str, default=d.engine,
                   choices=["auto", "device", "host"],
                   help="Clustering engine: GPU device or host oracle.")
    g.add_argument("--decoder", type=str, default=d.decoder,
                   choices=["auto", "native", "python"],
                   help="BAM decoder implementation.")
    g.add_argument("--n_shards", type=int, default=d.n_shards,
                   help="Shards of the genome axis, one per card (the "
                        "serial programs run with fewer cards).")
    g.add_argument("--resume", action="store_true",
                   help="Resume from a signature checkpoint in work_dir "
                        "(skips BAM decode).")
    g.add_argument("--profile", action="store_true",
                   help="Trace the whole call into "
                        "work_dir/torch_trace/run.json: the device's "
                        "operations (torch.profiler, CUDA activity) and "
                        "the program's stage spans.")
    g.add_argument("--distributed", action="store_true",
                   help="Multi-host run over torch.distributed (gloo): "
                        "sharded decode, per-process chromosome buckets, "
                        "process 0 writes the VCF.")
    g.add_argument("--coordinator", type=str, default=d.coordinator,
                   help="Rendezvous address host:port of a distributed "
                        "run (the process group's tcp://host:port); "
                        "default: MASTER_ADDR and MASTER_PORT (env://).")
    g.add_argument("--num_processes", type=int, default=d.num_processes,
                   help="Number of processes in the distributed run "
                        "(default: WORLD_SIZE).")
    g.add_argument("--process_id", type=int, default=d.process_id,
                   help="This process's rank in the distributed run "
                        "(default: RANK).")
    g.add_argument("--device", type=str, default="cuda",
                   help="Device of the device engine: cuda, cuda:k (pins "
                        "card k) or cpu; cuda raises when no GPU is "
                        "available.[%(default)s]")
    return p


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dest names of options literally present on the command line (exact
    option string, ``--opt=value`` form, or an unambiguous long-option
    abbreviation — argparse accepts those, so the preset override must
    recognize them too)."""
    long_opts = [opt for action in parser._actions
                 for opt in action.option_strings if opt.startswith("--")]
    dest_of = {opt: action.dest for action in parser._actions
               for opt in action.option_strings}
    provided = set()
    for tok in argv:
        name = tok.split("=", 1)[0]
        if name in dest_of:
            provided.add(dest_of[name])
        elif name.startswith("--") and len(name) > 2:
            matches = [o for o in long_opts if o.startswith(name)]
            if len(matches) == 1:  # unambiguous abbreviation
                provided.add(dest_of[matches[0]])
    return provided


def args_to_config(args: argparse.Namespace, explicit=()) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in fields})
    if getattr(args, "preset", None):
        # a preset fills in per-type clustering values, but an explicitly
        # passed flag always wins over the preset
        cfg = apply_preset(cfg, args.preset, skip=explicit)
    return cfg


def run(argv=None) -> dict:
    """Parse ``argv`` and run the discovery pipeline, or force calling
    when ``-Ivcf`` is given; returns the run's stats. The device is
    resolved first, so ``--device cuda`` without a card raises in both
    modes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = args_to_config(args, explicit=_explicit_dests(parser, argv))
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    logging.info("Running %s" % " ".join(sys.argv))
    from cutesv_tpu_torch.utils.torchsetup import resolve_device
    device = resolve_device(args.device)
    t0 = time.time()
    if cfg.Ivcf is not None:
        from cutesv_tpu_torch.forcecalling import run_force_calling
        stats = run_force_calling(cfg, argv, device=device)
        logging.info("Sites: %d  (decode %.2fs, call %.2fs, emit %.2fs)"
                     % (stats["sites"], stats["decode_s"], stats["call_s"],
                        stats["emit_s"]))
    else:
        from cutesv_tpu_torch.pipeline import run_pipeline
        stats = run_pipeline(cfg, argv, device=device)
        logging.info("Calls: %d  (decode %.2fs, resolve %.2fs, emit %.2fs)"
                     % (stats["n_calls"], stats["decode_s"],
                        stats["resolve_s"], stats["emit_s"]))
    logging.info("Finished in %0.2f seconds." % (time.time() - t0))
    return stats


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
