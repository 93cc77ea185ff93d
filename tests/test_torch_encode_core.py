"""Device encode cores of the port vs the JAX package: the I16x16
wavefront (encode_i_frame_core) and the P16x16 core with the exhaustive
integer-pel search (encode_p_frame_core, which reaches the SAD kernel's
plain version on the CPU), compared tensor by tensor.  The JAX package's
outputs for these inputs (its cores, its finalisation's bytes and its
motion compensation) are committed in tests/jax_refs/core.npz
(tools/make_torch_jax_refs.py, hash-guarded).  Tolerance: none.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode.intra_wavefront import satd_lambda

H, W, R = 48, 64, 16
QP, QPC = 26, 26


def _planes(seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 256, (H + 1, W + 1)).astype(np.int32)
    y = (n[:-1, :-1] + n[1:, :-1] + n[:-1, 1:] + n[1:, 1:]) // 4
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    return y, u, v


def frame_planes():
    """(current planes, reference planes): the reference is the current
    frame moved by whole pels."""
    cur = _planes(1)
    ref = (np.roll(cur[0], (2, -3), (0, 1)), np.roll(cur[1], (1, -1), (0, 1)),
           np.roll(cur[2], (1, -2), (0, 1)))
    return cur, ref


@pytest.fixture(scope="module")
def frames():
    return frame_planes()


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("core")


def _prefixed(refs, prefix):
    return {k[len(prefix):]: v for k, v in refs.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_i(refs):
    """The JAX package's encode_i_frame on frames()[0] (committed)."""
    return _prefixed(refs, "ei_")


@pytest.fixture(scope="module")
def jax_p(refs):
    """The JAX package's encode_p_frame (exhaustive XLA search) on
    frames() (committed)."""
    return _prefixed(refs, "ep_")


def finalize_case():
    """The slice-header slots the finalisation test puts in front."""
    rng = np.random.default_rng(4)
    return rng.integers(0, 2, 37).astype(np.int64), np.ones(37, np.int32)


def _compare(got: dict, want: dict) -> None:
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_i_frame_core(frames, jax_i):
    got = tdev.encode_i_frame_core(
        *(torch.from_numpy(p) for p in frames[0]), QP, QPC)
    assert set(got) == set(jax_i)
    _compare(got, jax_i)


def test_p_frame_core(frames, jax_p):
    cur, ref = frames
    got = tdev.encode_p_frame_core(
        *(torch.from_numpy(p) for p in cur + ref), QP, QPC, rng=R, subpel=0)
    assert set(got) == {k for k in jax_p}
    _compare(got, jax_p)


@pytest.mark.parametrize("ftype", ["I", "P"])
def test_finalize_bytes(frames, refs, ftype):
    """Syntax tensors -> CAVLC slots -> packed slice bytes, both packages,
    each from its own core's output (the JAX package's committed)."""
    from x264vfw_tpu_torch.encode import device_finalize as tfin
    hv, hl = finalize_case()
    cur, ref = frames
    if ftype == "I":
        out = tdev.encode_i_frame_core(
            *(torch.from_numpy(p) for p in cur), QP, QPC)
        got, bits = tfin.finalize_i(out, torch.from_numpy(hv),
                                    torch.from_numpy(hl), H // 16, W // 16)
    else:
        out = tdev.encode_p_frame_core(
            *(torch.from_numpy(p) for p in cur + ref), QP, QPC, rng=R)
        got, bits = tfin.finalize_p(out, torch.from_numpy(hv),
                                    torch.from_numpy(hl), H // 16, W // 16)
    want, wbits = refs[f"fin_{ftype}_bytes"], int(refs[f"fin_{ftype}_bits"])
    assert bits == wbits and bits % 8 == 0
    np.testing.assert_array_equal(got.numpy()[:bits // 8], want[:bits // 8])


def test_p_frame_motion_compensation(frames, refs):
    """Luma prediction at the found vectors equals the reference sample at
    (y + dy, x + dx), edge-clamped; chroma at eighth-pel bilinear."""
    cur, ref = frames
    planes = [torch.from_numpy(p) for p in cur + ref]
    got = tdev._motion_search_and_mc(*planes, R)
    for name, a in zip(("mv_q", "pred_y", "pred_u", "pred_v"), got):
        np.testing.assert_array_equal(a.numpy(), refs[f"mc_{name}"])


@pytest.mark.parametrize("what", ["hier", "subpel"])
def test_out_of_slice_search_raises(frames, what):
    """The searches this slice refused, the hierarchical one and the 16x16
    quarter-pel refinement, now run: on the frames' whole-pel motion
    (dx, dy) = (-3, 2) both give the exhaustive search's vectors and
    prediction away from the frame's edge (tests/test_torch_hier.py holds
    them to the JAX package)."""
    planes = [torch.from_numpy(p) for p in frames[0] + frames[1]]
    kw = ({"me_backend": "auto:hier"} if what == "hier" else {"subpel": 2})
    mv_q, pred_y, _, _ = tdev._motion_search_and_mc(*planes, R, **kw)
    want_mv, want_y, _, _ = tdev._motion_search_and_mc(*planes, R)
    inner = (slice(1, -1), slice(1, -1))
    assert (mv_q[inner] == torch.tensor([-12, 8])).all()
    np.testing.assert_array_equal(mv_q[inner].numpy(), want_mv[inner].numpy())
    np.testing.assert_array_equal(pred_y[16:-16, 16:-16].numpy(),
                                  want_y[16:-16, 16:-16].numpy())


def test_satd_lambda_all_qps():
    for qp in range(52):
        want = int(jnp.maximum(1, jnp.round(0.85 * jnp.exp2(
            (jnp.asarray(qp, jnp.float32) - 12.0) / 3.0))).astype(jnp.int32))
        assert satd_lambda(qp) == want, qp
