"""The output check's control: the plain reference put in the program's
place with one guarantee that the configurations state broken (DR, the
reference reads of a site, counts the supporting reads that cover its
window too), compared with the reference and with the planted sites exactly as a run
compares the program's calls.

    python3 svbench/control.py --workload hifi.germline --seeds 1 2 3

prints one JSON line per seed with the numbers the check compares; each
has to be above its limit (0) in at least one number for the control to
fail, as it must. The benchmark's runs do not run it.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(cell: dict, seed: int, workers: int) -> dict:
    from svbench import harness, truth
    from svbench.reference import caller
    config, traffic = cell["config_data"], cell["traffic_data"]
    ref, sites = caller.reference(seed, config, traffic, workers)
    broken = caller.reference_body(seed, config, traffic, workers,
                                   control=True)
    bias = truth.cluster_bias(caller.settings(config["argv"]).values)
    return dict(seed=seed, records=len(ref), sites=len(sites),
                **harness.compare(broken, ref),
                **truth.check(broken, sites, bias))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="svbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from svbench import harness, registry
    cell = registry.cell(registry.load_benchmark(ROOT), args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, seed, harness.n_workers())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
