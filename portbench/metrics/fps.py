"""fps: the frames whose access units were returned inside the window,
over the time from the window's start to the last of those returns.  A
call still in flight when the window closes is neither counted nor
timed."""


def read(run):
    inside = [c for c in run.calls if c[3]]
    frames = sum(c[2] for c in inside)
    ends = [c[1] for c in inside if c[2] > 0]
    if not frames:
        return None
    return frames / (max(ends) - run.t0)
