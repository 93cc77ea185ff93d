"""Trellis quantisation (--trellis, x264's --preset medium and slower), the
port against the JAX package: encode/device._trellis_adjust on seeded
coefficients at every QP 0..51, with one QP for all blocks and with
per-MB QPs (n, 1) as AQ gives them, intra and inter rounding; its float32
thresholds as a table equal, bit for bit, to the JAX package's lam = (512
* 0.9) * exp2((qp - 12) / 3), lam * 4 and lam * 1.5; and the residual
pipeline with trellis on, with and without the 8x8 candidate and
decimation.  The JAX side comes from tests/jax_refs/multiref.npz
(tools/make_torch_jax_refs.py multiref, hash-guarded by
test_torch_session.py::test_jax_references_are_current).  Inputs come
from numpy seeds; no tolerance.
"""

import numpy as np
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.ops import transform as tj

N_SCALAR = 8             # MBs of the one-QP cases (the first of the 52)
PIPE_CASES = ((False, False), (True, False), (True, True))   # (t8, decimate)


def trellis_blocks(seed=30):
    """(52, 16, 4, 4) int32 residual blocks, one MB per QP of the per-MB
    case: mostly small residuals, some large, some flat blocks, so that
    every QP sees lone +-1 levels, larger levels and zeros."""
    rng = np.random.default_rng(seed)
    small = rng.integers(-12, 13, (52, 16, 4, 4))
    large = rng.integers(-255, 256, (52, 16, 4, 4))
    pick = rng.random((52, 16, 1, 1))
    blocks = np.where(pick < 0.6, small, np.where(pick < 0.9, large, 0))
    return blocks.astype(np.int32)


def pipeline_case(seed=31):
    """(src MBs, pred MBs, per-MB QPs (n, 1)) for the residual pipeline:
    12 MBs of textured source against a prediction off by small noise."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (12, 16, 16))
    pred = np.clip(src + rng.integers(-9, 10, (12, 16, 16)), 0, 255)
    qp = rng.integers(18, 40, (12, 1))
    return src.astype(np.int32), pred.astype(np.int32), qp.astype(np.int32)


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("multiref")


def _q(coef, qp, intra):
    return tj.quant4x4(coef, qp, intra=intra)


def test_lambda_table_equals_jax_bit_for_bit(refs):
    """The thresholds' float32 bit patterns, QP 0..51."""
    for name, table in (("lam", tdev.TRELLIS_LAM),
                        ("lam4", tdev.TRELLIS_DROP),
                        ("lam15", tdev.TRELLIS_STEP)):
        want = refs[f"tr_{name}"]
        assert table.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(table.view(np.int32),
                                      want.view(np.int32), err_msg=name)


@pytest.mark.parametrize("intra", [False, True])
def test_trellis_adjust_one_qp_equals_jax(refs, intra):
    """_trellis_adjust with an int QP, every QP 0..51."""
    coef = tj.fdct4x4(torch.from_numpy(trellis_blocks()[:N_SCALAR]))
    want = refs[f"tr_scalar_{int(intra)}"]
    changed = 0
    for qp in range(52):
        q = _q(coef, qp, intra)
        got = tdev._trellis_adjust(coef, q, qp, intra)
        np.testing.assert_array_equal(got.numpy(), want[qp],
                                      err_msg=f"qp {qp}")
        changed += int((got != q).sum())
    assert changed > 0


@pytest.mark.parametrize("intra", [False, True])
def test_trellis_adjust_per_mb_qp_equals_jax(refs, intra):
    """_trellis_adjust with (n, 1) per-MB QPs, MB i at QP i.  It drops
    lone +-1 levels; with intra rounding it also steps larger levels
    down (inter rounding leaves |e| too small for the 1.5 lambda
    threshold)."""
    coef = tj.fdct4x4(torch.from_numpy(trellis_blocks()))
    qp = torch.arange(52, dtype=torch.int32)[:, None]
    q = _q(coef, qp, intra)
    got = tdev._trellis_adjust(coef, q, qp, intra)
    np.testing.assert_array_equal(got.numpy(), refs[f"tr_mb_{int(intra)}"])
    assert int(((q.abs() == 1) & (got == 0)).sum()) > 0
    steps = int(((q.abs() >= 2) & (got.abs() == q.abs() - 1)).sum())
    assert (steps > 0) == intra


@pytest.mark.parametrize("t8,decimate", PIPE_CASES)
def test_residual_pipeline_with_trellis_equals_jax(refs, t8, decimate):
    """_luma_residual_pipeline(trellis=True) with per-MB QPs: the levels,
    the recon residual and the 8x8 flags."""
    src, pred, qp = (torch.from_numpy(a) for a in pipeline_case())
    levels, res, flag = tdev._luma_residual_pipeline(
        src, pred, qp, intra=False, decimate=decimate, trellis=True, t8=t8)
    key = f"tr_pipe_{int(t8)}{int(decimate)}"
    np.testing.assert_array_equal(levels.numpy(), refs[f"{key}_levels"])
    np.testing.assert_array_equal(res.numpy(), refs[f"{key}_res"])
    if t8:
        np.testing.assert_array_equal(flag.numpy(), refs[f"{key}_t8"])
    plain, _, _ = tdev._luma_residual_pipeline(
        src, pred, qp, intra=False, decimate=decimate, t8=t8)
    assert not torch.equal(plain, levels)
