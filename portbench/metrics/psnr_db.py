"""psnr_db: the mean luma PSNR of the traffic's "psnr_frames" (display
indices [a, b)), decoded by the reference from the returned stream and
held against the generated source frames.  The reference decodes only
the chain from the IDR, so these are frames of the warm-up: the IDR's
neighbours, not the window's steady state."""


def read(run):
    a, b = run.traffic["psnr_frames"]
    vals = [run.verdict.psnr.get(d) for d in range(a, b)]
    if None in vals:
        return None
    return sum(vals) / len(vals)
