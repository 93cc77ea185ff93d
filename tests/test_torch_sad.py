"""Full-search SAD: the port's plain version vs the Pallas kernel.

x264vfw_tpu_torch.ops.kernels.sad.sad_partition_minima_plain against
x264vfw_tpu.ops.pallas.sad.sad_partition_minima run in interpret mode (as
tests/test_pallas_sad.py runs it on the CPU), on all eight outputs.
Tolerance: none.  The CUDA kernel itself is held against the plain
version on the card (the `cuda` test below and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from x264vfw_tpu.ops.pallas import sad as jsad
from x264vfw_tpu_torch.ops.kernels import sad as tsad


def _planes(H, W, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, W), dtype=np.uint8),
            rng.integers(0, 256, (H + 2 * R, W + 2 * R), dtype=np.uint8))


@pytest.mark.parametrize("H,W,R", [(64, 80, 8), (48, 128, 4), (48, 320, 4)])
def test_plain_matches_pallas_interpret(H, W, R):
    src, refp = _planes(H, W, R, seed=H + W + R)
    want = jsad.sad_partition_minima(jnp.asarray(src, jnp.int32),
                                     jnp.asarray(refp, jnp.int32), R,
                                     interpret=True)
    got = tsad.sad_partition_minima(torch.from_numpy(src),
                                    torch.from_numpy(refp), R)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_sad16_argmin_matches_xla_argmin():
    """The scales=(1,0,0,0) view == argmin(4*SAD16 + |dy|+|dx|) with the
    JAX package's tie order (the XLA branch of device.py)."""
    H, W, R = 48, 64, 6
    src, refp = _planes(H, W, R, seed=5)
    src[:16, :16] = 7                      # flat MBs: many tied offsets
    refp[:] = np.where(refp < 40, 7, refp)
    K = 2 * R + 1
    d = np.stack([np.abs(src.astype(np.int64)
                         - refp[oy:oy + H, ox:ox + W].astype(np.int64))
                  .reshape(H // 16, 16, W // 16, 16).sum(axis=(1, 3))
                  for oy in range(K) for ox in range(K)])
    pen = np.abs(np.arange(K * K) // K - R) + np.abs(np.arange(K * K) % K - R)
    want = np.argmin(d * 4 + pen[:, None, None], axis=0)
    got = tsad.sad16_argmin(torch.from_numpy(src), torch.from_numpy(refp), R)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "radius", "scales",
                                 "scale_too_large", "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    src, refp = _planes(32, 48, 4, seed=1)
    s, r, R, sc = torch.from_numpy(src), torch.from_numpy(refp), 4, (4, 2, 2, 1)
    if bad == "dtype":
        s = s.to(torch.int16)
    elif bad == "shape":
        r = r[:-1]
    elif bad == "radius":
        R = 40
    elif bad == "scales":
        sc = (4, 2, -1, 1)
    elif bad == "scale_too_large":
        sc = (tsad.MAX_SCALE + 1, 2, 2, 1)
    else:
        s = s.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        tsad.sad_partition_minima(s, r, R, sc)


def test_cpu_tensor_takes_plain_version():
    src, refp = _planes(32, 32, 3, seed=2)
    before = tsad.LAUNCHES
    got = tsad.sad_partition_minima(torch.from_numpy(src),
                                    torch.from_numpy(refp), 3)
    assert tsad.LAUNCHES == before
    want = tsad.sad_partition_minima_plain(torch.from_numpy(src),
                                           torch.from_numpy(refp), 3)
    for k in tsad.NAMES:
        assert torch.equal(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,R", [(1088, 1920, 16), (48, 320, 4),
                                   (64, 80, 8), (32, 272, 16), (32, 48, 1),
                                   (64, 64, 32)])
def test_kernel_matches_plain_on_card(H, W, R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    src, refp = _planes(H, W, R, seed=R)
    s = torch.from_numpy(src).cuda()
    r = torch.from_numpy(refp).cuda()
    for scales in ((4, 2, 2, 1), (1, 0, 0, 0)):
        before = tsad.LAUNCHES
        got = tsad.sad_partition_minima(s, r, R, scales)
        assert tsad.LAUNCHES == before + 1
        want = tsad.sad_partition_minima_plain(s, r, R, scales)
        torch.cuda.synchronize()
        for k in tsad.NAMES:
            assert torch.equal(got[k], want[k]), k
    got = tsad.sad_search_quad(s, r, R)
    want = tsad.sad_search_quad_plain(s, r, R)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

