"""peak_anon_rss_mb: the high-water mark of the process's anonymous
resident memory (RssAnon) over the window, in MB of 10**6 bytes."""


def read(run):
    return run.peak_anon_kb * 1024 / 1e6 if run.peak_anon_kb else None
