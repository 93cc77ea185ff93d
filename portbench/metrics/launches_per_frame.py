"""launches_per_frame: CUDA kernels in the traced window's device trace
over the frames counted in it."""


def read(run):
    r = run.readings
    if r is None or not run.frames:
        return None
    return len(r.kernels()) / run.frames
