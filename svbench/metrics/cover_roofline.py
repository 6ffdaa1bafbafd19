"""cover_roofline: the genotype layer's share of its byte floor, in %.

For each call with a launch: the least time the card could take to count
its launch shape (ops.cover.LAST_SHAPE: windows x reads; one launch per
call below 1e9 bp), over the device time of every operation that started
inside the call's genotype span (pipeline._batched_cover_multi: uploads,
zeroing, the kernel, the readback), whatever their names. Nothing to
read without a trace, a launch or device operations."""
from svbench.roofline import cover_bound_ms


def read(run):
    floor = busy = 0.0
    for k, c in enumerate(run.calls):
        if c["error"] or not c["launches"]:
            continue
        spans = [(a, b) for name, j, a, b in run.spans
                 if j == k and name == "genotype"]
        t = sum(b - a for _, a, b in run.device_ops
                if any(s0 <= a <= s1 for s0, s1 in spans))
        if t > 0:
            floor += cover_bound_ms(*c["shape"]) / 1e3
            busy += t
    return 100.0 * floor / busy if busy > 0 else None
