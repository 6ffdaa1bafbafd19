"""pair_records: the DUP, INV and TRA records a call emits, the mean per
call: the ``records_DUP`` and ``records_INV`` counters of the program's
``resolve.pair`` span and the ``records`` counter of its ``resolve.tra``
spans (stats["trace"]). The witness that the pair and translocation path
ran; nothing to read without those counters."""

KEYS = {"resolve.pair": ("records_DUP", "records_INV"),
        "resolve.tra": ("records",)}


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        found = [s["counters"][k] for s in c["stats"]["trace"]["spans"]
                 for k in KEYS.get(s["name"], ()) if k in s["counters"]]
        if found:
            per_call.append(sum(found))
    return sum(per_call) / len(per_call) if per_call else None
