"""Small cells for the CPU tests: the real configurations and traffic
with three contigs of ~250-310 kb (divisor 800) in place of 24."""
import copy
import json
import os

from svbench import registry

ROOT = registry.ROOT


def tiny_cell(workload: str, coverage: int = 30) -> dict:
    cell = registry.cell(registry.load_benchmark(ROOT), workload)
    cfg = copy.deepcopy(cell["config_data"])
    cfg["genome"].update(contigs=["chr1", "chr2", "chr3"],
                         source_mb=[249, 242, 198], divisor=800)
    cfg["reads"]["coverage"] = coverage
    cell["config_data"] = cfg
    return cell


def load(kind: str, name: str) -> dict:
    with open(os.path.join(registry.HERE, kind, name + ".json")) as fh:
        return json.load(fh)
