"""cover_flush_roofline: the genotype layer's share of its byte floor,
in %, from the program's own spans: the least time the card could take
for every cover launch of the call (the windows x reads of each
``cover.launch`` span, by svbench/roofline.py's cover_bound_ms), over
the device time of the operations that started inside the call's
``genotype.flush`` spans (uploads, zeroing, the kernel, the readback),
whatever their names. Unlike cover_roofline it counts every launch of a
call and only the flushes' device time.

The profiler's device clock can sit a few ms off the host's for a whole
profiling session (the cover kernel started 56-150 us after its launch
span opened in 38 of 40 sessions on the H100 machine, and 1.86 ms and
4.16 ms before it in the other 2), which moves a flush's operations out
of its span. Each launch span names the kernel it enqueued (counter
``kernel``; the program keeps that name beside the kernel), so a flush
whose first launch's kernel (the one nearest the launch span, within
OFFSET_NS) starts before that span opens or after the flush ends is
shifted by the kernel's start less the span's start. Timing alone cannot
place the flush: the cluster programs before it are dense runs of
operations, alike in every call.
Nothing to read without the spans or device operations."""
import bisect

from svbench.roofline import cover_bound_ms

# how far from its launch span a kernel is looked for (ns): twice the
# largest offset seen (4.16 ms in 40 sessions)
OFFSET_NS = 10_000_000


def _shift(f0, f1, launches, ops):
    """The shift of the flush [f0, f1] (ns): 0 when the kernel its first
    launch span names starts after that span opens and inside the flush,
    or none is near; else that kernel's start less the span's start."""
    mine = [(t, k) for t, k in launches if f0 <= t <= f1]
    if not mine:
        return 0
    t, kernel = mine[0]
    lo = bisect.bisect_left(ops, (t - OFFSET_NS,))
    hi = bisect.bisect_right(ops, (t + OFFSET_NS,))
    near = [a for a, _, name in ops[lo:hi] if kernel and kernel in name]
    if not near:
        return 0
    a = min(near, key=lambda a: abs(a - t))
    return 0 if t <= a <= f1 else a - t


def read(run):
    calls = [c["stats"]["trace"]["spans"] for c in run.calls
             if not c["error"] and "trace" in c["stats"]]
    if not run.device_ops or not any(s["name"] == "genotype.flush"
                                     for spans in calls for s in spans):
        return None
    # (start ns, seconds, name) of each operation, by start; starts are
    # compared in ns with the spans
    ops = sorted((round(a * 1e9), b - a, name)
                 for name, a, b in run.device_ops)
    floor = busy = 0.0
    for spans in calls:
        launches = [(s["t0_ns"], s["counters"].get("kernel", ""))
                    for s in spans if s["name"] == "cover.launch"]
        windows = []
        for s in spans:
            if s["name"] == "genotype.flush":
                f0, f1 = s["t0_ns"], s["t1_ns"]
                d = _shift(f0, f1, launches, ops)
                windows.append((f0 + d, f1 + d))
        t = sum(dt for a, dt, _ in ops
                if any(w0 <= a <= w1 for w0, w1 in windows))
        if t > 0:
            floor += sum(cover_bound_ms(s["counters"]["windows"],
                                        s["counters"]["reads"])
                         for s in spans if s["name"] == "cover.launch") / 1e3
            busy += t
    return 100.0 * floor / busy if busy > 0 else None
