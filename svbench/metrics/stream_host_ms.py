"""stream_host_ms: the mean per call of the main thread's streamed host
work while the decoder walks: the time of the program's
``decode.dispatch`` (snapshot, prepare, program dispatch, compaction)
and ``decode.tail`` (mid-decode DEL/INS emission and genotype) spans
that falls inside the call's ``decode.walk`` span, in ms. This work
takes cores from the decoder's inflate and parse pools. Nothing to
read without the spans."""

HOST = ("decode.dispatch", "decode.tail")


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        spans = c["stats"]["trace"]["spans"]
        walks = [(s["t0_ns"], s["t1_ns"]) for s in spans
                 if s["name"] == "decode.walk"]
        if not walks:
            continue
        ns = sum(max(0, min(s["t1_ns"], w1) - max(s["t0_ns"], w0))
                 for s in spans if s["name"] in HOST for w0, w1 in walks)
        per_call.append(ns / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
