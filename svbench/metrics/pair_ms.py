"""pair_ms: the DUP/INV and TRA resolution of a call, in ms, the mean per
call: the summed time of the program's ``resolve.pair`` span (the pair
programs' fetch and the host finish over their cluster slices) and its
``resolve.tra`` spans (the TRA finish and genotype prepare; the TRA
genotypes' finalize after the cover pass), from stats["trace"]. Nothing
to read without those spans."""

NAMES = ("resolve.pair", "resolve.tra")


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        spans = [s for s in c["stats"]["trace"]["spans"]
                 if s["name"] in NAMES and s["t1_ns"] is not None]
        if spans:
            per_call.append(sum(s["t1_ns"] - s["t0_ns"] for s in spans)
                            / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
