"""AQ, the 8x8 transform and weighted prediction on the P path: the port's
functions against the JAX package's, exactly.

* the per-MB-QP forms of the 4x4 quant/dequant and the chroma and luma DC
  functions, and the 8x8 family (fdct8x8, quant8x8, dequant8x8,
  idct8x8_core, the 8x8 zigzag) at every QP, per call and per MB;
* aq_qp_map on a dense random sweep of frames of every kind (noise, MBs
  of graded activity, nearly flat, ramps) at four settings (one MB of
  the sweep is pinned: there the JAX package's own float32 result
  depends on its evaluation order), and realized_qp_chain;
* the t8 decision's two tables: the leading-zero count over |level| 1 to
  2^16 (equal wherever a level can reach: the JAX package's count is off
  by one at 2^13 and 2^15, beyond the quantisers' clamp, pinned here) and
  lambda over QP 0..51;
* the t8 branch of _luma_residual_pipeline with and without decimation,
  at one QP and per MB;
* build_maps with the 8x8-transform map and a per-MB QP map;
* encode_p_frame_core with AQ, weighted prediction and the 8x8 transform,
  with and without P partitions, and the loop filter over its outputs
  (the JAX package's outputs committed in tests/jax_refs/live.npz).
Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.encode import device as jdev
from x264vfw_tpu.ops import transform as jt
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.ops import deblock as tdb
from x264vfw_tpu_torch.ops import transform as tt

N = 24


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


@pytest.mark.parametrize("intra", [False, True])
def test_per_mb_qp_transforms_match_jax(intra):
    rng = np.random.default_rng(1 + intra)
    qp = np.arange(N * 3, dtype=np.int32) % 52          # every QP
    res = rng.integers(-255, 256, (N * 3, 16, 4, 4))
    dc = rng.integers(-2040, 2041, (N * 3, 2, 2))
    ldc = rng.integers(-4080, 4081, (N * 3, 4, 4))

    @jax.jit
    def jax_side(w, qp, dc, ldc):
        q = jt.quant4x4(w, qp[:, None], intra)
        cq = jt.chroma_dc_fwd_quant(dc, qp, intra)
        lq = jt.luma_dc_fwd_quant(ldc, qp, intra)
        return (q, jt.dequant4x4(q, qp[:, None]), cq,
                jt.chroma_dc_dequant(cq, qp), lq, jt.luma_dc_dequant(lq, qp),
                jt.chroma_qp(qp, -3))

    w = jt.fdct4x4(res)
    q, dq, cq, cdq, lq, ldq, cqp = jax_side(w, jnp.asarray(qp),
                                            jnp.asarray(dc), jnp.asarray(ldc))
    qpt = _t(qp)
    _eq(tt.quant4x4(_t(w), qpt[:, None], intra), q, "quant4x4")
    _eq(tt.dequant4x4(_t(q), qpt[:, None]), dq, "dequant4x4")
    _eq(tt.chroma_dc_fwd_quant(_t(dc), qpt, intra), cq, "chroma dc")
    _eq(tt.chroma_dc_dequant(_t(cq), qpt), cdq, "chroma dc dequant")
    _eq(tt.luma_dc_fwd_quant(_t(ldc), qpt, intra), lq, "luma dc")
    _eq(tt.luma_dc_dequant(_t(lq), qpt), ldq, "luma dc dequant")
    _eq(tt.chroma_qp(qpt, -3), cqp, "chroma_qp")


@pytest.mark.parametrize("intra", [False, True])
def test_8x8_family_matches_jax(intra):
    rng = np.random.default_rng(3 + intra)
    res = rng.integers(-255, 256, (N, 4, 8, 8))
    res[0] = 255                                        # the largest W8
    w8 = jt.fdct8x8(res)
    _eq(tt.fdct8x8(_t(res)), w8, "fdct8x8")

    @jax.jit
    def chain(w, qp):       # one QP for the call, as an int does
        q = jt.quant8x8(w, qp, intra)
        d = jt.dequant8x8(q, qp)
        return q, d, jt.idct8x8_core(d)

    for qp in range(52):
        q8, d, r = chain(w8, jnp.int32(qp))
        _eq(tt.quant8x8(_t(w8), qp, intra), q8, f"quant8x8 qp {qp}")
        _eq(tt.dequant8x8(_t(q8), qp), d, f"dequant8x8 qp {qp}")
        _eq(tt.idct8x8_core(_t(d)), r, f"idct8x8 qp {qp}")
    qp = (np.arange(N, dtype=np.int32) * 7) % 52
    qpj, qpt = jnp.asarray(qp)[:, None], _t(qp)[:, None]
    q8 = jt.quant8x8(w8, qpj, intra)
    _eq(tt.quant8x8(_t(w8), qpt, intra), q8, "quant8x8 per MB")
    _eq(tt.dequant8x8(_t(q8), qpt), jt.dequant8x8(q8, qpj),
        "dequant8x8 per MB")
    z = jt.zigzag8x8_scan(q8)
    _eq(tt.zigzag8x8_scan(_t(q8)), z, "zigzag8x8_scan")
    _eq(tt.zigzag8x8_unscan(_t(z)), jt.zigzag8x8_unscan(z), "unscan")


def _sweep_frames():
    """Frames of every kind the AQ map sees: noise, MBs of graded
    activity, nearly flat (ties of the energy), ramps with noise."""
    rng = np.random.default_rng(5)
    H, W = 64, 96
    for it in range(160):
        kind = it % 4
        if kind == 0:
            y = rng.integers(0, 256, (H, W))
        elif kind == 1:
            amp = np.kron(rng.integers(0, 64, (H // 16, W // 16)),
                          np.ones((16, 16), np.int64))
            y = 128 + (rng.standard_normal((H, W)) * amp).round()
        elif kind == 2:
            y = rng.integers(100, 100 + rng.integers(1, 4), (H, W))
        else:
            y = (np.add.outer(np.arange(H), np.arange(W))
                 * rng.integers(1, 5)) % 256 + rng.integers(0, 3, (H, W))
        yield np.clip(y, 0, 255).astype(np.int32)


# (sweep frame, qp, strength) -> the MB where the JAX package's float32
# result depends on its evaluation order (ROADMAP.md section C): the exact
# adj is -1.4999987, XLA's jit rounds it to -2, its eager run and the
# port's exact arithmetic to -1
ORDER_DEPENDENT = {(67, 26, 1.0): 8}


def test_aq_qp_map_matches_jax_on_a_dense_sweep():
    fn = jax.jit(jdev.aq_qp_map, static_argnums=(2,))
    mbs = 0
    for i, y in enumerate(_sweep_frames()):
        for qp, strength in ((26, 1.0), (40, 0.7), (10, 1.5), (1, 1.0)):
            got = tdev.aq_qp_map(_t(y), qp, strength).numpy()
            want = np.asarray(fn(jnp.asarray(y), qp, strength))
            mbs += got.size
            k = ORDER_DEPENDENT.get((i, qp, strength))
            if k is None:
                np.testing.assert_array_equal(got, want, f"frame {i} qp {qp}")
                continue
            # the pinned MB: JAX's jit and eager runs disagree there, and
            # the port gives what the exact arithmetic gives
            assert np.flatnonzero(got != want).tolist() == [k]
            eager = np.asarray(jdev.aq_qp_map(jnp.asarray(y), qp, strength))
            assert eager[k] != want[k] and got[k] == eager[k] == 25
    assert mbs == 160 * 24 * 4


def test_realized_qp_chain_matches_jax():
    rng = np.random.default_rng(6)
    for slice_qp in (20, 33):
        qp = rng.integers(1, 52, 200).astype(np.int32)
        coded = rng.random(200) < 0.4
        coded[:5] = False                    # no coded MB before the 6th
        got = tdev.realized_qp_chain(_t(qp), _t(coded), slice_qp)
        want = jdev.realized_qp_chain(jnp.asarray(qp), jnp.asarray(coded),
                                      slice_qp)
        for g, w in zip(got, want):
            _eq(g, w)


# the only |level| in 1..2^16 where the JAX package's _clz32 (31 minus a
# float32 log2 under XLA) is off by one: XLA's log2 of 2^13 and 2^15 lies
# just below the integer.  No level reaches them: the quantisers clamp
# |level| to 8191 (ROADMAP.md section C).
CLZ32_JAX_OFF_BY_ONE = (8192, 32768)
LEVEL_MAX = 8191


def test_clz32_and_lambda_tables_match_jax():
    a = np.arange(1, (1 << 16) + 1, dtype=np.int32)
    got = tdev._clz32(_t(a)).numpy()
    want = np.asarray(jax.jit(jdev._clz32)(jnp.asarray(a)))
    assert a[got != want].tolist() == list(CLZ32_JAX_OFF_BY_ONE)
    assert (got == 32 - np.floor(np.log2(a.astype(np.float64))) - 1).all()
    # the largest |level| the 4x4 and 8x8 quantisers give, at every QP
    w4 = jt.fdct4x4(np.full((1, 4, 4), 255) * np.array([[1, -1, 1, -1]]))
    w8 = jt.fdct8x8(np.full((2, 8, 8), 255) * np.array([[1, -1] * 4]))
    top = max(max(int(jnp.abs(jt.quant4x4(w4 * 8, qp, True)).max()),
                  int(jnp.abs(jt.quant8x8(w8 * 8, qp, True)).max()))
              for qp in range(52))
    assert top == LEVEL_MAX < min(CLZ32_JAX_OFF_BY_ONE)

    @jax.jit
    def lam2(qv):        # the expression of _luma_residual_pipeline's t8
        return jnp.maximum(1, jnp.round(
            0.9 * jnp.exp2((qv.astype(jnp.float32) - 12.0) / 3.0))
        ).astype(jnp.int32)

    np.testing.assert_array_equal(tdev.LAM2, np.asarray(lam2(
        jnp.arange(52, dtype=jnp.int32))))


def _mbs(rng, n, spread):
    src = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    pred = np.clip(src + rng.integers(-spread, spread + 1, src.shape), 0,
                   255).astype(np.int32)
    pred[: n // 4] = src[: n // 4] // 2              # large residuals
    return src, pred


@pytest.mark.parametrize("per_mb", [False, True])
@pytest.mark.parametrize("decimate", [False, True])
def test_luma_residual_pipeline_t8_matches_jax(per_mb, decimate):
    rng = np.random.default_rng(7 + 2 * per_mb + decimate)
    n = 48
    src, pred = _mbs(rng, n, 12)
    fn = jax.jit(jdev._luma_residual_pipeline,
                 static_argnames=("intra", "decimate", "trellis", "t8"))
    if per_mb:
        qp = rng.integers(10, 52, n).astype(np.int32)
        cases = [(jnp.asarray(qp)[:, None], _t(qp)[:, None])]
    else:
        cases = [(q, q) for q in (14, 26, 38, 50)]
    for qj, qt in cases:
        want = fn(jnp.asarray(src), jnp.asarray(pred), qj, intra=False,
                  decimate=decimate, t8=True)
        got = tdev._luma_residual_pipeline(_t(src), _t(pred), qt,
                                           intra=False, decimate=decimate,
                                           t8=True)
        for name, g, w in zip(("levels", "res", "t8"), got, want):
            _eq(g, w, name)
        assert 0 < int(got[2].sum()) < n      # both transforms win


MAPS_OFFSETS = ((0, 0, 0), (4, -6, 2))     # (offA, offB, chroma offset)


def maps_case():
    """(metadata of build_maps, t8_4) at 5x7 MBs: intra MBs, coded
    blocks, vectors, per-MB QPs 10..51, half the MBs 8x8-transformed."""
    rng = np.random.default_rng(8)
    mbh, mbw = 5, 7
    meta = (rng.random((mbh, mbw)) < 0.2,
            ((rng.random((4 * mbh, 4 * mbw)) < 0.4)
             * rng.integers(1, 9, (4 * mbh, 4 * mbw))).astype(np.int32),
            rng.integers(-8, 9, (4 * mbh, 4 * mbw, 2)).astype(np.int32),
            np.zeros((4 * mbh, 4 * mbw), np.int32),
            rng.integers(10, 52, (mbh, mbw)).astype(np.int32))
    t8 = np.kron(rng.random((mbh, mbw)) < 0.5,
                 np.ones((4, 4), bool)).astype(bool)
    return meta, t8


def test_build_maps_with_t8_and_per_mb_qp_match_jax():
    """Against the JAX build_maps on these inputs, committed in
    tests/jax_refs/calls.npz (maps_<offA>_<offB>_<cqo>_<i>)."""
    meta, t8 = maps_case()
    refs = torch_jax_refs.load("calls")
    for offA, offB, cqo in MAPS_OFFSETS:
        got = tdb.build_maps(*(_t(a) for a in meta), offA, offB, cqo,
                             t8_4=_t(t8))
        for i, g in enumerate(got):
            _eq(g, refs[f"maps_{offA}_{offB}_{cqo}_{i}"])


def p_case(seed=9):
    """(src planes, ref planes) int32 at 64x48: a texture moved by (2, 1),
    luma at 0.8x plus noise (weighted prediction's case), one flat MB."""
    rng = np.random.default_rng(seed)
    H, W = 48, 64

    def tex(h, w):
        n = rng.integers(0, 256, (h + 2, w + 2))
        return (sum(n[a:a + h, b:b + w] for a in range(3) for b in range(3))
                // 9).astype(np.int32)

    ref = [tex(H, W), tex(H // 2, W // 2), tex(H // 2, W // 2)]
    src = [np.clip((np.roll(r, (1, 2), (0, 1)) * 0.8).astype(np.int32)
                   + rng.integers(-3, 4, r.shape), 0, 255).astype(np.int32)
           for r in ref]
    src[0][:16, :16] = 90                                # a flat MB
    return src, ref


# (partitions, qp, (w, o) or None) of the P-core cases; the search is the
# hierarchical one, at half pel, with AQ and the 8x8 transform
P_CORE_CASES = ((True, 23, (51, 3)), (True, 35, None),
                (False, 23, (51, 3)), (False, 35, None))
P_CORE_KW = dict(rng=16, subpel=1, me_backend="auto:hier", aq_strength=1.0,
                 qpc_offset=0, dct8x8=True)


def p_core_key(partitions, qp):
    return f"pcore_{int(partitions)}_{qp}"


@pytest.mark.parametrize("partitions", [True, False])
def test_p_frame_core_with_aq_wp_t8_matches_jax(partitions):
    """encode_p_frame_core and the loop filter over its outputs, against
    the JAX package's on p_case() (committed in tests/jax_refs/live.npz,
    tools/make_torch_jax_refs.py)."""
    refs = torch_jax_refs.load("live")
    src, ref = p_case()
    for parts, qp, wp in P_CORE_CASES:
        if parts != partitions:
            continue
        key = p_core_key(parts, qp)
        got = tdev.encode_p_frame_core(*(_t(a) for a in src + ref), qp, qp,
                                       partitions=parts, wp=wp, **P_CORE_KW)
        want = {k[len(key) + 1:]: v for k, v in refs.items()
                if k.startswith(key + "_") and "_lf_" not in k}
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k], k)
        assert int(got["t8"].sum()) > 0
        assert len(set(got["qp_real"].tolist())) > 1
        for g, p in zip(tdev.apply_loop_filter(got, qp, 3, 4, False), "yuv"):
            _eq(g, refs[f"{key}_lf_{p}"], "loop filter")
