"""Minimal text-VCF reader shared by the post-processing tools
(replaces the pyvcf3 dependency of diploid_calling.py / vcf2bedpe.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List


@dataclass
class VcfRecord:
    chrom: str
    pos: int
    id: str
    ref: str
    alt: str
    qual: str
    filter: str
    info: Dict[str, str]
    fmt: str = ""
    samples: List[str] = None

    def info_int(self, key: str, default: int = 0) -> int:
        try:
            return int(float(self.info[key]))
        except (KeyError, ValueError):
            return default


def read_vcf(path: str) -> Iterator[VcfRecord]:
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            info = {}
            for kv in f[7].split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    info[k] = v
                else:
                    info[kv] = ""
            yield VcfRecord(chrom=f[0], pos=int(f[1]), id=f[2], ref=f[3],
                            alt=f[4], qual=f[5], filter=f[6], info=info,
                            fmt=f[8] if len(f) > 8 else "",
                            samples=f[9:] if len(f) > 9 else [])


def read_vcf_header(path: str) -> str:
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                out.append(line)
            else:
                break
    return "".join(out)
