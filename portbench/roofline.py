"""A kernel's share of its roofline in the traced window: the least time
its launches could take (rooflines/<kernel>.py's counts against
rooflines/peaks.py) over the time the device trace gives them."""

from __future__ import annotations

from .rooflines import peaks


def share(run, kernel: str):
    """Percent, or None where the kernel did not run in the window."""
    r = run.readings
    if r is None:
        return None
    mod = run.rooflines[kernel]
    t0, t1 = r.window_ns
    launches = [a for t, a in r.launches.get(kernel, []) if t0 <= t < t1]
    events = r.kernels(mod.KERNEL)
    if not launches or not events:
        return None
    least = sum(peaks.bound_s(*mod.counts(*a), run.props["sms"],
                              run.props["clock_hz"])[0]
                for a in launches) / len(launches)
    took = sum(e - s for s, e, _, _ in events) / len(events) / 1e9
    return 100.0 * least / took
