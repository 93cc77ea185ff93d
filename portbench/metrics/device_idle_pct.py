"""device_idle_pct: the share of the traced window in which nothing ran
on the device (the profiler's kernels, copies and sets, merged)."""


def read(run):
    r = run.readings
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)
