"""cabac_ms_per_frame: the host CABAC transcode
(bitstream/cabac_transcode.transcode_slice) summed over the calls that
began in the traced window, over the frames counted in it."""


def read(run):
    r = run.readings
    if r is None or not run.frames:
        return None
    t0, t1 = r.window_ns
    ns = [b - a for name, a, b in r.spans
          if name == "cabac_transcode" and t0 <= a < t1]
    return sum(ns) / 1e6 / run.frames if ns else None
