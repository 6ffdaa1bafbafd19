"""Diploid-assembly post-processor (diploid_calling.py:7-80 equivalent).

Rewrites each record's GT from the haplotype prefixes (``cutesvh1`` /
``cutesvh2``) present in its supporting read names (RNAMES), for callsets
produced from diploid assembly alignments.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

from cutesv_tpu_torch.tools.vcfio import read_vcf, read_vcf_header


def call_gt(tag) -> str:
    if sum(tag) == 2:
        return "1/1"
    if tag[0] == 1:
        return "1/0"
    if tag[1] == 1:
        return "0/1"
    return "./."


def convert(invcf: str, outvcf: str):
    with open(outvcf, "w") as out:
        out.write(read_vcf_header(invcf))
        for rec in read_vcf(invcf):
            filt = rec.filter if rec.filter not in ("", ".") else "PASS"
            rnames = rec.info.get("RNAMES", "").split(",")
            tag = [0, 0]
            for name in rnames:
                if "cutesvh1" in name:
                    tag[0] = 1
                if "cutesvh2" in name:
                    tag[1] = 1
            svtype = rec.info.get("SVTYPE", "")
            try:
                info = "SVTYPE=%s;SVLEN=%d;END=%d;RE=%d;RNAMES=%s" % (
                    svtype, rec.info_int("SVLEN"), int(rec.info["END"]),
                    rec.info_int("RE"), ",".join(rnames))
            except (KeyError, ValueError):
                if "TRA" in svtype or "BND" in svtype:
                    info = "SVTYPE=%s;RE=%d;RNAMES=%s" % (
                        svtype, rec.info_int("RE"), ",".join(rnames))
                else:
                    continue
            out.write("%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\tGT\t%s\n" % (
                rec.chrom, rec.pos, rec.id, rec.ref, rec.alt, rec.qual,
                filt, info, call_gt(tag)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="diploid_calling",
        description="Convert cuteSV-style callsets to diploid callsets "
                    "using haplotype-tagged read names.")
    p.add_argument("invcf", type=str)
    p.add_argument("outvcf", type=str)
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    t0 = time.time()
    convert(args.invcf, args.outvcf)
    logging.info("Finished in %0.2f seconds." % (time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
