"""done_batch_chroms: the chromosomes the streaming decode dispatched
after the decoder reported DONE, the mean per call: the ``chroms``
counter of the program's per-chromosome ``decode.dispatch`` spans that
carry ``done`` = 1 (stats["trace"]). Each is a chromosome the main thread
had not reached by the walk's end, so its dispatch and compaction fall in
the serial finish and its emission and genotypes in resolve. Nothing to
read without the counter."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        chroms = [s["counters"] for s in c["stats"]["trace"]["spans"]
                  if s["name"] == "decode.dispatch"
                  and "chroms" in s["counters"]]
        if chroms:
            per_call.append(sum(k["chroms"] for k in chroms
                                if k.get("done") == 1))
    return sum(per_call) / len(per_call) if per_call else None
