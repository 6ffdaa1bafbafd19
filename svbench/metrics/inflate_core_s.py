"""inflate_core_s: the mean per call of the native decoder's busy
inflate core-seconds (thread CPU time inside zlib's inflate, summed over
every participating thread): the ``inflate_core_s`` counter of the
program's ``decode.walk`` span (stats["trace"]). Nothing to read
without the spans."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        walks = [s for s in c["stats"]["trace"]["spans"]
                 if s["name"] == "decode.walk"]
        if walks:
            per_call.append(sum(s["counters"]["inflate_core_s"]
                                for s in walks))
    return sum(per_call) / len(per_call) if per_call else None
