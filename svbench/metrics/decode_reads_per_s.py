"""decode_reads_per_s: BAM records over the sum of the calls' decode
stage seconds (the program's stats["decode_s"], which with streaming also
hold the cluster work overlapped with the decode)."""


def read(run):
    secs = [c["stats"]["decode_s"] for c in run.calls if not c["error"]]
    if not secs or sum(secs) <= 0:
        return None
    return len(secs) * run.records_per_call / sum(secs)
