"""idle_outside_walk_share: the share of the traced window in which the
card is idle and no ``decode.walk`` span of the program runs: 1 - (the
union of the device operations' intervals and the calls' walk spans
within the window) / the window. It is the idle time on the host's
serial path (dispatch after the walk, the join, the store, resolve,
emit, between calls), apart from the idle that only a faster decoder
can cut. Nothing to read without device operations or spans."""


def read(run):
    if not run.device_ops:
        return None
    walks = [(s["t0_ns"] / 1e9, s["t1_ns"] / 1e9)
             for c in run.calls if not c["error"] and "trace" in c["stats"]
             for s in c["stats"]["trace"]["spans"]
             if s["name"] == "decode.walk"]
    if not walks:
        return None
    t0, t1 = run.window
    covered, end = 0.0, t0
    for a, b in sorted(run.busy_intervals() + walks):
        a, b = max(a, end), min(b, t1)
        if b > a:
            covered += b - a
            end = b
    return 1.0 - covered / (t1 - t0)
