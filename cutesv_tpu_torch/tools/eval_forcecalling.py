"""Force-calling / population evaluation utilities
(src/benchmarks/eval_forcecalling.py equivalent).

Modes:
  POP   per-site missing-rate / AF / HWE / ExcHet table from a merged
        population VCF
  COMP  AF concordance between a population callset and a base callset
  CMRG  prepare the CMRG truth VCF (annotate SVTYPE/SVLEN from REF/ALT)
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def _info_field(info: str, key: str):
    try:
        return info.split(";%s=" % key)[1].split(";")[0]
    except IndexError:
        if info.startswith("%s=" % key):
            return info.split("%s=" % key)[1].split(";")[0]
        raise


def population_statistic(pop_merged_vcf: str, output_file: str,
                         n_samples: int = 100):
    with open(output_file, "w") as out, open(pop_merged_vcf) as fh:
        idx = 0
        for line in fh:
            if line[0] == "#":
                continue
            seq = line.strip().split("\t")
            info = seq[7]
            svlen = abs(int(_info_field(info, "SVLEN")))
            svtype = _info_field(info, "SVTYPE")
            if svtype not in ("TRA", "BND") and svlen < 50:
                continue
            idx += 1
            af = float(_info_field(info, "AF"))
            hwe = float(_info_field(info, "HWE"))
            # the reference takes split(';ExcHet=')[1] verbatim
            # (eval_forcecalling.py:21), assuming ExcHet is the last INFO
            # field; truncate at the next ';' so it needn't be
            exchet = float(_info_field(info, "ExcHet"))
            missing = 0
            n_here = min(n_samples, len(seq) - 9)
            for i in range(9, 9 + n_here):
                # a bare '.' sample (fully absent call) counts as both
                # alleles missing; the reference indexes [2] and would
                # crash on it
                if seq[i][0] == ".":
                    missing += 1
                if len(seq[i]) < 3 or seq[i][2] == ".":
                    missing += 1
            out.write("%d\t%f\t%f\t%f\t%f\n"
                      % (idx, missing / (2 * max(n_here, 1)), af, hwe,
                         exchet))


def _parse_pop(path: str, filtered: bool):
    svs = {}
    with open(path) as fh:
        for line in fh:
            if line[0] == "#":
                continue
            seq = line.strip().split("\t")
            chrom, pos = seq[0], int(seq[1])
            info = seq[7]
            svtype = info.split("SVTYPE=")[1].split(";")[0]
            if svtype not in ("DEL", "INS"):
                continue
            svlen = abs(int(info.split("SVLEN=")[1].split(";")[0]))
            af = float(_info_field(info, "AF"))
            if filtered:
                if svtype not in ("TRA", "BND") and svlen < 50:
                    continue
                hwe = float(_info_field(info, "HWE"))
                exchet = float(_info_field(info, "ExcHet"))
                missing = sum((gt[0] == ".")
                              + (len(gt) < 3 or gt[2] == ".")
                              for gt in seq[9:])
                if missing > 10 or hwe < 1e-6 or exchet < 1e-6:
                    continue
            svs.setdefault(chrom, []).append([pos, svtype, svlen, af])
    return svs


def compare_callsets(pop_vcf: str, base_vcf: str, output_file: str):
    base = _parse_pop(base_vcf, filtered=False)
    comp = _parse_pop(pop_vcf, filtered=True)
    with open(output_file, "w") as out:
        for chrom in base:
            for b in base[chrom]:
                for c in comp.get(chrom, []):
                    if (b[1] == c[1] and abs(b[0] - c[0]) <= 1000
                            and min(b[2], c[2]) / max(b[2], c[2]) > 0.7):
                        out.write("%s\t%f\t%f\t%f\n"
                                  % (b[1], b[3], c[3], b[3] - c[3]))
                        break


def pre_cmrg(input_vcf: str, output_vcf: str):
    with open(output_vcf, "w") as out, open(input_vcf) as fh:
        for line in fh:
            if line[0] == "#":
                if line[1] != "#":
                    out.write('##INFO=<ID=SVTYPE,Number=1,Type=String,'
                              'Description="Type of structural variant">\n')
                    out.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,'
                              'Description="Difference in length between '
                              'REF and ALT alleles">\n')
                out.write(line)
            else:
                seq = line.strip().split("\t")
                ref, alt = seq[3], seq[4]
                svtype = "DEL" if len(ref) > len(alt) else "INS"
                out.write("\t".join(seq[:7]))
                out.write("\tSVTYPE=%s;SVLEN=%d" % (svtype,
                                                    len(alt) - len(ref)))
                out.write("\t%s\t%s\n" % (seq[8], seq[9]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eval_forcecalling")
    p.add_argument("handle", choices=["POP", "COMP", "CMRG"])
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--base_vcf", type=str)
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    t0 = time.time()
    if args.handle == "POP":
        population_statistic(args.input, args.output)
    elif args.handle == "COMP":
        compare_callsets(args.input, args.base_vcf, args.output)
    else:
        pre_cmrg(args.input, args.output)
    logging.info("Finished in %0.2f seconds." % (time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
