"""post_walk_ms: the mean per call of the serial finish of decode, in
ms: from the end of the program's ``decode.walk`` span to the end of its
``decode`` span, less the ``store`` spans (the DONE batch's dispatch,
the join that waits for the decoder's rank sorts, the sortedness check,
attaching the early work). Nothing to read without the spans."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        spans = c["stats"]["trace"]["spans"]
        walk_end = [s["t1_ns"] for s in spans if s["name"] == "decode.walk"]
        decode_end = [s["t1_ns"] for s in spans if s["name"] == "decode"]
        if not walk_end or not decode_end:
            continue
        store = sum(s["t1_ns"] - s["t0_ns"] for s in spans
                    if s["name"] == "store")
        per_call.append((decode_end[0] - max(walk_end) - store) / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
