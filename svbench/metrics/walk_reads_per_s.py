"""walk_reads_per_s: the records the native decoder's record walk read
over the seconds it walked, summed over the calls: the program's
``decode.walk`` spans (stats["trace"]; the C++ record loop's own start
and end, and its ``records`` counter). Unlike decode_reads_per_s it
leaves out the streamed cluster work, the serial finish after the walk
and the store. Nothing to read without the spans."""


def read(run):
    records = ns = 0
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        for s in c["stats"]["trace"]["spans"]:
            if s["name"] == "decode.walk":
                records += s["counters"]["records"]
                ns += s["t1_ns"] - s["t0_ns"]
    return records / (ns / 1e9) if ns > 0 else None
