"""device_idle_share: 1 - (the union of the device operations' intervals
over the traced window's wall time); nothing without device operations."""


def read(run):
    if not run.device_ops:
        return None
    return 1.0 - run.busy_s() / run.window_s
