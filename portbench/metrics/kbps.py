"""kbps: the bitrate of the traffic's "kbps_frames" (display indices
[a, b), the first frames of the window), at the stream's own frame rate:
the same frames in every run of a seed.  Nothing where the run did not
return them all."""


def read(run):
    a, b = run.traffic["kbps_frames"]
    sizes = [run.verdict.bytes.get(d) for d in range(a, b)]
    if None in sizes:
        return None
    return sum(sizes) * 8 / ((b - a) / run.stream_fps) / 1e3
