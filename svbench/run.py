"""Run one cell of the benchmark of ``cutesv_tpu_torch`` on this machine.

    python3 svbench/run.py --workload hifi.germline --seed 1 --seconds 40 \\
        --trace 0

(or ``python -m svbench ...`` from the repo root). Prints the result as
one JSON object on the last line of standard output, and the numbers the
output check compared, each beside its limit, as the last lines of
standard error. Exits non-zero, printing no result, without the CUDA
cards the cell asks for, or if JAX or the JAX package was loaded.
"""
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="svbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # every cache of the run lives at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    from svbench import harness, registry

    cell = registry.cell(registry.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print("svbench: the cell needs %d CUDA card(s); this machine has "
              "%d" % (cell["chips"], torch.cuda.device_count()
                      if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    t_start = min(T0, harness.process_start())
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    return emit(result)


def emit(result: dict) -> int:
    """The forbidden-module check, then the compared numbers on standard
    error and the result on standard output."""
    import json

    from svbench import harness
    bad = harness.forbidden_modules()
    if bad:
        print("svbench: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check %s = %s (limit %s)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
