"""The B-frame modules of the port against the JAX package, exact:
_direct_flip_mask, the mode decision's mv_bits, b_mv_pred (its C -> D
fallback and only-A rule at 1-MB-wide and 1-MB-tall frames),
encode_b_frame_core, _finalize_b_core's slot rows and packed bytes, and
the P core's MB-tree QP offsets (qp_off, with and without AQ), at 64x48,
16x64 and 64x16.  The JAX cores' outputs are committed in
tests/jax_refs/batched.npz (tools/make_torch_jax_refs.py, hash-guarded);
the small JAX functions run live, jitted.  Inputs come from numpy seeds;
no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu.encode import device as jdev
from x264vfw_tpu.encode import device_finalize as jfin
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode import device_finalize as tfin
from x264vfw_tpu_torch.encode.device_pack import pack_slots

GEOMS = ((64, 48), (16, 64), (64, 16))
# (me_backend, subpel, dct8x8) of the B core cases: veryfast's search,
# and the exhaustive integer search without the 8x8 transform
B_MODES = (("auto:hier", 1, True), ("auto", 0, False))
B_RNG = 16
B_QP, B_QPC = 28, 28
HDR_VALS = np.zeros(64, np.int64)
HDR_LENS = np.zeros(64, np.int32)
HDR_VALS[:3] = (1, 5, 3)
HDR_LENS[:3] = (1, 3, 2)
# (aq_strength, partitions) of the P core cases with MB-tree offsets
QP_OFF_CASES = ((0.0, False), (1.0, True))


def b_case(w, h):
    """(src, ref0, ref1 planes, mvcol (n, 2)): three frames of a texture
    moving by (3, -2) per frame whose left half stands still (where
    spatial direct pays), with independent luma noise of +-8 per frame
    (where bi-prediction pays), the B frame the middle one; mvcol zero on
    the still half, the shift elsewhere, and random small vectors on a
    few MBs (colZero's |mv| <= 1 edge)."""
    frames = moving_clip(w, h, 3, seed=w * h, shift=(3, -2))
    still = moving_clip(w, h, 1, seed=w + h)[0]
    noise = np.random.default_rng(w * 5 + h)
    planes = []
    for y, u, v in frames:
        y, u, v = y.copy(), u.copy(), v.copy()
        y[:, :w // 2] = still[0][:, :w // 2]
        # independent noise per frame, which bi-prediction averages out
        y = (y + noise.integers(-8, 9, y.shape)).clip(0, 255)
        u[:, :w // 4] = still[1][:, :w // 4]
        v[:, :w // 4] = still[2][:, :w // 4]
        planes.append(tuple(p.astype(np.int32) for p in (y, u, v)))
    mbh, mbw = h // 16, w // 16
    rng = np.random.default_rng(w + 7 * h)
    mvcol = np.zeros((mbh, mbw, 2), np.int32)
    mvcol[:, mbw // 2:] = (-12, 8)
    pick = rng.random((mbh, mbw)) < 0.3
    mvcol[pick] = rng.integers(-2, 3, (int(pick.sum()), 2))
    return planes[1], planes[0], planes[2], mvcol.reshape(-1, 2)


def b_key(w, h, mode):
    me, sub, t8 = mode
    return f"b{w}x{h}_{'hier' if 'hier' in me else 'esa'}{sub}{int(t8)}"


def pq_case():
    """(src, ref planes) of the P core cases with MB-tree offsets, and
    offsets in -6..0 per MB."""
    cur, ref = moving_clip(64, 48, 2, seed=17, shift=(2, -1))[::-1]
    offs = np.random.default_rng(19).integers(-6, 1, (3, 4)).astype(np.int32)
    return ([p.astype(np.int32) for p in cur],
            [p.astype(np.int32) for p in ref], offs)


def pq_key(aq, parts):
    return f"pq_aq{int(aq > 0)}_p{int(parts)}"


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("batched")


def _mode_maps(w, h, seed):
    rng = np.random.default_rng(seed)
    mbh, mbw = h // 16, w // 16
    cases = []
    for k in range(24):
        # a third of the maps with no L1 at all and a third with no L0:
        # the uni-direct flips
        modes = rng.integers(1, 4, (mbh, mbw)).astype(np.int32)
        if k % 3:
            modes = np.full_like(modes, k % 3)
        cases.append((modes, rng.random((mbh, mbw)) < 0.6))
    return cases


@pytest.mark.parametrize("w,h", GEOMS)
def test_direct_flip_mask_equals_jax(w, h):
    jfn = jax.jit(jdev._direct_flip_mask)
    seen = np.zeros(3, int)
    for modes, colzero in _mode_maps(w, h, seed=w * 3 + h):
        want = jfn(jnp.asarray(modes), jnp.asarray(colzero))
        got = tdev._direct_flip_mask(_t(modes), _t(colzero))
        for k, (g, wnt) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
            seen[k] += int(g.sum())
    assert (seen > 0).all(), seen


def test_mv_bits_equals_jax_float():
    """The exact bit length equals the JAX package's float32 ceil(log2(a
    + 2)) for every |x| + |y| below 2^16, jitted and eager."""
    a = np.arange(1 << 16, dtype=np.int32)
    mv = np.stack([a // 2, -(a - a // 2)], axis=-1)

    def jax_bits(m):
        s = jnp.abs(m).sum(axis=-1)
        return 2 * jnp.ceil(jnp.log2(s.astype(jnp.float32) + 2.0)) \
            .astype(jnp.int32) + 2

    got = tdev.mv_bits(_t(mv)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_bits)(mv)))
    np.testing.assert_array_equal(got, np.asarray(jax_bits(jnp.asarray(mv))))


@pytest.mark.parametrize("w,h", GEOMS + ((16, 16), (32, 16), (16, 32)))
def test_b_mv_pred_equals_jax(w, h):
    """Random per-list vectors and usage, at frames 1 MB wide or tall too
    (C unavailable everywhere, the top row's only-A rule)."""
    jfn = jax.jit(jfin.b_mv_pred)
    rng = np.random.default_rng(w * h + 1)
    mbh, mbw = h // 16, w // 16
    for k in range(8):
        uses = rng.random((mbh, mbw)) < (0.2, 0.5, 0.9, 1.0)[k % 4]
        mv = rng.integers(-64, 65, (mbh, mbw, 2)).astype(np.int32)
        mv = np.where(uses[..., None], mv, 0).astype(np.int32)
        want = np.asarray(jfn(jnp.asarray(mv), jnp.asarray(uses)))
        np.testing.assert_array_equal(
            tfin.b_mv_pred(_t(mv), _t(uses)).numpy(), want)


@pytest.mark.parametrize("mode", B_MODES, ids=lambda m: b_key(0, 0, m))
@pytest.mark.parametrize("w,h", GEOMS)
def test_b_core_equals_jax(refs, w, h, mode):
    me, sub, t8 = mode
    src, r0, r1, mvcol = b_case(w, h)
    out = tdev.encode_b_frame_core(*map(_t, src + r0 + r1), _t(mvcol),
                                   B_QP, B_QPC, B_RNG, sub, me, dct8x8=t8)
    key = b_key(w, h, mode)
    want_keys = sorted(k[len(key) + 1:] for k in refs
                       if k.startswith(key + "_") and "slot" not in k
                       and "pack" not in k)
    assert sorted(out) == want_keys
    for k in want_keys:
        np.testing.assert_array_equal(out[k].numpy(), refs[f"{key}_{k}"],
                                      err_msg=f"{key} {k}")
    if w == 64 and h == 48:
        m = out["mode"].numpy()
        assert (m == 0).any() and (m == 3).any(), m


@pytest.mark.parametrize("t8_mode", (False, True))
@pytest.mark.parametrize("mode", B_MODES, ids=lambda m: b_key(0, 0, m))
@pytest.mark.parametrize("w,h", GEOMS)
def test_finalize_b_equals_jax(refs, w, h, mode, t8_mode):
    """_finalize_b_core on the JAX core's own outputs: the slot rows
    (values and lengths) and the packed bytes equal the JAX code's."""
    key = b_key(w, h, mode)
    out = {k[len(key) + 1:]: _t(refs[k]) for k in refs
           if k.startswith(key + "_") and "slot" not in k
           and "pack" not in k}
    vals, lens = tfin._finalize_b_core(out, _t(HDR_VALS), _t(HDR_LENS),
                                       h // 16, w // 16, t8_mode=t8_mode)
    sk = f"{key}_slot{int(t8_mode)}"
    np.testing.assert_array_equal(vals.numpy(), refs[f"{sk}_vals"])
    np.testing.assert_array_equal(lens.numpy(), refs[f"{sk}_lens"])
    data, bits = pack_slots(vals, lens)
    assert bits == int(refs[f"{sk}_bits"])
    np.testing.assert_array_equal(data[:(bits + 7) // 8].numpy(),
                                  refs[f"{sk}_bytes"])


@pytest.mark.parametrize("aq,parts", QP_OFF_CASES)
def test_p_core_qp_offsets_equal_jax(refs, aq, parts):
    """MB-tree's offsets in the P core: per-MB QPs (clipped to 1..51)
    with and without AQ, and the mb_qp_delta chain, equal JAX's."""
    cur, ref, offs = pq_case()
    out = tdev.encode_p_frame_core(*map(_t, cur + ref), 26, 26, 16, 1,
                                   "auto:hier", partitions=parts,
                                   aq_strength=aq, dct8x8=True,
                                   qp_off=_t(offs))
    key = pq_key(aq, parts)
    want_keys = sorted(k[len(key) + 1:] for k in refs
                       if k.startswith(key + "_"))
    assert sorted(out) == want_keys
    for k in want_keys:
        np.testing.assert_array_equal(out[k].numpy(), refs[f"{key}_{k}"],
                                      err_msg=f"{key} {k}")
    assert (out["qp_delta"] != 0).any()
