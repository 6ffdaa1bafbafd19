"""cluster_dispatch_ms: the main thread's time to dispatch the DEL/INS
cluster programs, the mean per call of the summed ``cluster.dispatch``
spans (stats["trace"]) in ms: staging the stream, then a graph replay or
the eager program's launches. Nothing to read without the span."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        ns = [s["t1_ns"] - s["t0_ns"] for s in c["stats"]["trace"]["spans"]
              if s["name"] == "cluster.dispatch" and s["t1_ns"] is not None]
        if ns:
            per_call.append(sum(ns) / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
