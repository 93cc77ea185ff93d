"""The loop filter kernel (csrc/deblock.cu, deblock_rows_kernel): one
persistent launch per frame.

Frozen from chip_smoke.py at commit cc6a3ed (deblock_bound_ms; unchanged
at 4a379f6).  Bytes: the int32 planes read and written once, the four
edge maps read once.  Operations: about 40 per edge line of the 4 + 4
luma and 2 x (2 + 2) chroma edges of every MB, on the int32 pipes.
"""

KERNEL = "deblock_rows_kernel"
PATCH = (("x264vfw_tpu_torch.ops.kernels.deblock", "deblock_apply"),)


def args(y, *rest, **kw):
    """(H, W) of the luma plane one launch filters."""
    return (int(y.shape[0]), int(y.shape[1]))


def counts(H: int, W: int):
    """(bytes, int32 operations) of one launch."""
    mbh, mbw = H // 16, W // 16
    planes = (H * W + H * W // 2) * 4
    maps = (H * 4 * mbw + 4 * mbh * W + H // 2 * 2 * mbw
            + 2 * mbh * W // 2) * 4
    lines = mbh * mbw * (8 * 16 + 8 * 8)
    return 2 * planes + maps, 40.0 * lines
