"""resolve_ms: the mean of the calls' stats["resolve_s"], in ms."""


def read(run):
    secs = [c["stats"]["resolve_s"] for c in run.calls
            if not c["error"] and "resolve_s" in c["stats"]]
    return 1e3 * sum(secs) / len(secs) if secs else None
