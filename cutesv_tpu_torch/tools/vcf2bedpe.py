"""VCF -> BEDPE conversion (src/benchmarks/vcf2bedpe.py equivalent)."""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Tuple

from cutesv_tpu_torch.tools.vcfio import read_vcf

HEADER = ("#chrom1\tstart1\tend1\tchrom2\tstart2\tend2\tname\tscore\t"
          "starnd1\tstrand2\tsvtype\tnumber_of_support_read\n")


def phase_bnd(alt: str) -> Tuple[str, int]:
    """Mate coordinates from a BND ALT string (vcf2bedpe.py:7-15)."""
    if alt[0] in ("]", "["):
        return alt.split(":")[0][1:], int(alt.split(":")[1][:-2])
    return alt.split(":")[0][2:], int(alt.split(":")[1][:-1])


def convert(invcf: str, outbedpe: str):
    with open(outbedpe, "w") as out:
        out.write(HEADER)
        for rec in read_vcf(invcf):
            svtype = rec.info.get("SVTYPE", "")
            if svtype in ("DEL", "INS", "INV", "DUP"):
                chr2 = rec.chrom
                pos2 = rec.info_int("END")
            else:
                chr2, pos2 = phase_bnd(rec.alt)
            out.write("%s\t%d\t%d\t%s\t%d\t%d\t%s\t%s\t+\t-\t%s\t%s\n" % (
                rec.chrom, rec.pos + 1, rec.pos + 1, chr2, pos2 + 1,
                pos2 + 1, rec.id, rec.qual, svtype,
                rec.info.get("RE", ".")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vcf2bedpe", description="Convert an SV VCF to BEDPE.")
    p.add_argument("vcf", type=str)
    p.add_argument("bedpe", type=str)
    args = p.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    t0 = time.time()
    convert(args.vcf, args.bedpe)
    logging.info("Finished in %0.2f seconds." % (time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
