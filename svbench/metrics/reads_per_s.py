"""reads_per_s: the BAM records of every call completed in the window
over the seconds from the first call's start to the last call's end."""


def read(run):
    done = [c for c in run.calls if not c["error"]]
    if not done:
        return None
    return len(done) * run.records_per_call / run.window_s
