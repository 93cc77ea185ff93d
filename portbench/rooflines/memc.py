"""The partition refinement and motion compensation kernel (csrc/memc.cu,
partition_refine_mc_kernel): each 8x8 block's sub-pel candidates around
its integer vector, and the luma prediction.

Frozen from chip_smoke.py at commit cc6a3ed (memc_bound_ms) and
x264vfw_tpu_torch/ops/kernels/memc.py's refine_deltas (the candidate
count per sub_lv; both unchanged at 4a379f6).  Bytes: src, the padded
reference, the integer vectors and the partition map read once, the
vectors and the int32 prediction written once.  Operations: the three
6-tap half-pel filters per pixel (about 36) and a rounded mean and an
absolute difference per candidate (6), on the int32 pipes.
"""

KERNEL = "partition_refine_mc_kernel"
PATCH = (("x264vfw_tpu_torch.encode.inter_partition", "partition_refine_mc"),)


def args(src, ref_pad, mv8i, part, R, sub_lv=2, *rest, **kw):
    """(H, W, R, sub_lv) of one launch."""
    return (int(src.shape[0]), int(src.shape[1]), int(R), int(sub_lv))


def candidates(sub_lv: int) -> int:
    """Candidates per block: 25 at quarter pel, 9 at half, 1 at integer."""
    return 25 if sub_lv >= 2 else (9 if sub_lv == 1 else 1)


def counts(H: int, W: int, R: int, sub_lv: int):
    """(bytes, int32 operations) of one launch."""
    P = R + 8
    nblk = (H // 8) * (W // 8)
    nbytes = (H * W + (H + 2 * P) * (W + 2 * P) + nblk * 8
              + (H // 16) * (W // 16) * 4 + nblk * 8 + H * W * 4)
    return nbytes, H * W * (36.0 + 6.0 * candidates(sub_lv))
