"""store_ms: the mean of the calls' stats["store_s"], in ms."""


def read(run):
    secs = [c["stats"]["store_s"] for c in run.calls
            if not c["error"] and "store_s" in c["stats"]]
    return 1e3 * sum(secs) / len(secs) if secs else None
