"""The SAD minima kernel (csrc/sad.cu, sad_minima_kernel): one full
search of a frame over (2R+1)^2 offsets.

Frozen from chip_smoke.py at commit cc6a3ed (sad_bound_ms's bytes,
sad_int_bound_ms's operations; unchanged at 4a379f6).  Bytes: the source
plane and the padded reference read once, the 18 minima per MB written
once.  Operations: one VABSDIFF4 on the int32 pipes per four byte
differences, K*K*H*W/4 for K = 2R+1.
"""

KERNEL = "sad_minima_kernel"
#: the port's names for the wrapper that launches it, where the benchmark
#: records each launch's shapes (traced runs only)
PATCH = (("x264vfw_tpu_torch.ops.kernels.sad", "sad_partition_minima"),
         ("x264vfw_tpu_torch.encode.inter_partition", "sad_partition_minima"))


def args(src_y, ref_pad, R, *rest, **kw):
    """(H, W, R) of one launch."""
    return (int(src_y.shape[0]), int(src_y.shape[1]), int(R))


def counts(H: int, W: int, R: int):
    """(bytes, int32 operations) of one launch."""
    K = 2 * R + 1
    n = (H // 16) * (W // 16)
    nbytes = H * W + (H + 2 * R) * (W + 2 * R) + 18 * n * 4
    return nbytes, K * K * H * W / 4
