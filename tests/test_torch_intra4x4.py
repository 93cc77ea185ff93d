"""I4x4 (--partitions i4x4): the port's encode/intra4x4.encode_i4x4_batch,
the slope-2 I-frame wavefront and the I_NxN finalisation slots against
the JAX package's.

* encode_i4x4_batch at a small batch, on random sources and neighbours
  with every availability pattern, against the JAX function run by jit;
* the I frame with the I_NxN candidate (encode_i_frame_core(i4x4=True))
  at 64x48 and 128x96, every output tensor, against the JAX outputs
  committed in tests/jax_refs/live.npz (tools/make_torch_jax_refs.py);
* the slot rows of the mixed I16x16 / I_NxN slice (_finalize_i_core,
  with and without the PPS's 8x8 mode) against the committed JAX slot
  rows: every value and length, the zero-length slots' too.
Inputs come from numpy seeds; no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.encode import intra4x4 as ji4
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode import device_finalize as tfin
from x264vfw_tpu_torch.encode import intra4x4 as ti4
from x264vfw_tpu_torch.encode.intra_wavefront import satd_lambda

I_GEOMS = ((64, 48), (128, 96))
# slice-header slots the finalisation puts in front (any codes will do)
HDR_VALS = np.array([5, 3, 1], np.uint32)
HDR_LENS = np.array([4, 3, 1], np.int32)


def _texture(rng, h, w):
    n = rng.integers(0, 256, (h + 2, w + 2))
    return (sum(n[a:a + h, b:b + w] for a in range(3) for b in range(3))
            // 9).astype(np.int32)


def i_frame_case(w, h):
    """(y, u, v, qp, qpc) of the I frame: texture, with a flat band and a
    ramp so that both MB types win somewhere."""
    rng = np.random.default_rng(w + h)
    y = _texture(rng, h, w)
    y[:16, :] = 100
    y[16:32, :32] = np.arange(32)[None] * 4
    return y, _texture(rng, h // 2, w // 2), _texture(rng, h // 2, w // 2), \
        23, 23


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("live")


def test_tables_match_jax():
    np.testing.assert_array_equal(ti4._IDX, ji4._IDX)
    assert ti4._DIR_MODES == ji4._DIR_MODES
    assert ti4._TRCODE == ji4._TRCODE.tolist()


@pytest.mark.parametrize("qp", [12, 30, 44])
def test_encode_i4x4_batch_matches_jax(qp):
    n = 12
    rng = np.random.default_rng(qp)
    src = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    src[:4] = src[:4, :1, :1]                       # flat MBs
    top = rng.integers(0, 256, (n, 16)).astype(np.int32)
    tr4 = rng.integers(0, 256, (n, 4)).astype(np.int32)
    left = rng.integers(0, 256, (n, 16)).astype(np.int32)
    tl = rng.integers(0, 256, (n,)).astype(np.int32)
    tmodes = rng.integers(0, 9, (n, 4)).astype(np.int32)
    lmodes = rng.integers(0, 9, (n, 4)).astype(np.int32)
    # every availability pattern of (top, left, top-right)
    pat = np.arange(n) % 8
    avail = [(pat & b) != 0 for b in (1, 2, 4)]
    avail[2] &= avail[0]
    lam = satd_lambda(qp)
    args = (src, top, tr4, left, tl, tmodes, lmodes, *avail)
    want = jax.jit(ji4.encode_i4x4_batch)(*(jnp.asarray(a) for a in args),
                                         qp, jnp.int32(lam))
    got = ti4.encode_i4x4_batch(*(torch.from_numpy(np.asarray(a))
                                  for a in args), qp, lam)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("w,h", I_GEOMS)
def test_i_frame_matches_jax(refs, w, h):
    y, u, v, qp, qpc = i_frame_case(w, h)
    got = tdev.encode_i_frame_core(*(torch.from_numpy(p) for p in (y, u, v)),
                                   qp, qpc, i4x4=True)
    keys = {k[len(f"i{w}x{h}_"):] for k in refs
            if k.startswith(f"i{w}x{h}_") and "_t8" not in k}
    assert keys == set(got)
    for k in keys:
        want = refs[f"i{w}x{h}_{k}"]
        np.testing.assert_array_equal(got[k].numpy().astype(want.dtype),
                                      want, err_msg=k)
    use = got["use_i4"].numpy()
    assert 0 < use.sum() < use.size      # both MB types occur


@pytest.mark.parametrize("t8_mode", [False, True])
@pytest.mark.parametrize("w,h", I_GEOMS)
def test_i_nxn_slots_match_jax(refs, w, h, t8_mode):
    y, u, v, qp, qpc = i_frame_case(w, h)
    out = tdev.encode_i_frame_core(*(torch.from_numpy(p) for p in (y, u, v)),
                                   qp, qpc, i4x4=True)
    vals, lens = tfin._finalize_i_core(
        out, torch.from_numpy(HDR_VALS.astype(np.int64)),
        torch.from_numpy(HDR_LENS), h // 16, w // 16, t8_mode=t8_mode)
    key = f"i{w}x{h}_t8{int(t8_mode)}"
    np.testing.assert_array_equal(lens.numpy(), refs[f"{key}_lens"])
    np.testing.assert_array_equal(vals.numpy(),
                                  refs[f"{key}_vals"].astype(np.int64))
