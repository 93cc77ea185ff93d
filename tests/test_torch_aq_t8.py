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
  with and without P partitions, and the loop filter over its outputs.
The JAX package's outputs are committed: the cores' in
tests/jax_refs/live.npz, build_maps' in calls.npz and the rest in
units.npz (large ones as digests; tools/make_torch_jax_refs.py,
hash-guarded).  Inputs come from numpy seeds.
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


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("units")


def _per_mb_case(intra):
    rng = np.random.default_rng(1 + intra)
    qp = np.arange(N * 3, dtype=np.int32) % 52          # every QP
    res = rng.integers(-255, 256, (N * 3, 16, 4, 4))
    dc = rng.integers(-2040, 2041, (N * 3, 2, 2))
    ldc = rng.integers(-4080, 4081, (N * 3, 4, 4))
    return qp, res, dc, ldc


PER_MB_OUT = ("w", "q", "dq", "cq", "cdq", "lq", "ldq", "cqp")


def _jax_per_mb(intra) -> dict:
    qp, res, dc, ldc = (jnp.asarray(a) for a in _per_mb_case(intra))

    @jax.jit
    def jax_side(w, qp, dc, ldc):
        q = jt.quant4x4(w, qp[:, None], intra)
        cq = jt.chroma_dc_fwd_quant(dc, qp, intra)
        lq = jt.luma_dc_fwd_quant(ldc, qp, intra)
        return (q, jt.dequant4x4(q, qp[:, None]), cq,
                jt.chroma_dc_dequant(cq, qp), lq, jt.luma_dc_dequant(lq, qp),
                jt.chroma_qp(qp, -3))

    w = jt.fdct4x4(res)
    return dict(zip(PER_MB_OUT, (w, *jax_side(w, qp, dc, ldc))))


@pytest.mark.parametrize("intra", [False, True])
def test_per_mb_qp_transforms_match_jax(refs, intra):
    qp, res, dc, ldc = _per_mb_case(intra)
    want = {k: refs[f"aq_pmq{int(intra)}_{k}"] for k in PER_MB_OUT}
    qpt = _t(qp)
    _eq(tt.fdct4x4(_t(res)), want["w"], "fdct4x4")
    w, q, cq, lq = (want[k] for k in ("w", "q", "cq", "lq"))
    _eq(tt.quant4x4(_t(w), qpt[:, None], intra), q, "quant4x4")
    _eq(tt.dequant4x4(_t(q), qpt[:, None]), want["dq"], "dequant4x4")
    _eq(tt.chroma_dc_fwd_quant(_t(dc), qpt, intra), cq, "chroma dc")
    _eq(tt.chroma_dc_dequant(_t(cq), qpt), want["cdq"], "chroma dc dequant")
    _eq(tt.luma_dc_fwd_quant(_t(ldc), qpt, intra), lq, "luma dc")
    _eq(tt.luma_dc_dequant(_t(lq), qpt), want["ldq"], "luma dc dequant")
    _eq(tt.chroma_qp(qpt, -3), want["cqp"], "chroma_qp")


def _f8_case(intra):
    rng = np.random.default_rng(3 + intra)
    res = rng.integers(-255, 256, (N, 4, 8, 8))
    res[0] = 255                                        # the largest W8
    return res, (np.arange(N, dtype=np.int32) * 7) % 52


def _jax_8x8_family(intra) -> dict:
    """The 8x8 family on _f8_case: digests of each QP's quant8x8,
    dequant8x8 and idct8x8_core outputs, and per MB."""
    res, qp = _f8_case(intra)
    w8 = jt.fdct8x8(res)

    @jax.jit
    def chain(w, qp):       # one QP for the call, as an int does
        q = jt.quant8x8(w, qp, intra)
        d = jt.dequant8x8(q, qp)
        return q, d, jt.idct8x8_core(d)

    dig = torch_jax_refs.digest
    out = {"w8": dig(w8)}
    for qp_ in range(52):
        for name, a in zip(("q", "d", "r"), chain(w8, jnp.int32(qp_))):
            out[f"{name}{qp_}"] = dig(a)
    qpj = jnp.asarray(qp)[:, None]
    q8 = jt.quant8x8(w8, qpj, intra)
    z = jt.zigzag8x8_scan(q8)
    out.update(q_mb=dig(q8), d_mb=dig(jt.dequant8x8(q8, qpj)), z=dig(z),
               unz=dig(jt.zigzag8x8_unscan(z)))
    return out


@pytest.mark.parametrize("intra", [False, True])
def test_8x8_family_matches_jax(refs, intra):
    """fdct8x8, then quant8x8 -> dequant8x8 -> idct8x8_core at every QP,
    per MB and the 8x8 zigzag, each against the digest of the JAX
    package's output on the same inputs (each step fed the port's own
    previous output, equal to the JAX package's when the digests are)."""
    res, qp = _f8_case(intra)
    want = {k[len(f"aq_f8{int(intra)}_"):]: str(v) for k, v in refs.items()
            if k.startswith(f"aq_f8{int(intra)}_")}
    dig = torch_jax_refs.digest
    w8 = tt.fdct8x8(_t(res))
    assert dig(w8) == want["w8"], "fdct8x8"
    for qp_ in range(52):
        q8 = tt.quant8x8(w8, qp_, intra)
        d = tt.dequant8x8(q8, qp_)
        for name, a in (("q", q8), ("d", d), ("r", tt.idct8x8_core(d))):
            assert dig(a) == want[f"{name}{qp_}"], f"{name} qp {qp_}"
    qpt = _t(qp)[:, None]
    q8 = tt.quant8x8(w8, qpt, intra)
    z = tt.zigzag8x8_scan(q8)
    for name, a in (("q_mb", q8), ("d_mb", tt.dequant8x8(q8, qpt)),
                    ("z", z), ("unz", tt.zigzag8x8_unscan(z))):
        assert dig(a) == want[name], name


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


AQ_SETTINGS = ((26, 1.0), (40, 0.7), (10, 1.5), (1, 1.0))


def _jax_aq_sweep() -> dict:
    """The jitted aq_qp_map over the sweep at each setting, (160, 4, 24),
    and the eager run of each ORDER_DEPENDENT case."""
    fn = jax.jit(jdev.aq_qp_map, static_argnums=(2,))
    frames = list(_sweep_frames())
    out = {"aq_sweep": np.stack([
        np.stack([np.asarray(fn(jnp.asarray(y), qp, s))
                  for qp, s in AQ_SETTINGS]) for y in frames])}
    for (i, qp, s) in ORDER_DEPENDENT:
        out[f"aq_sweep_eager_{i}_{qp}"] = np.asarray(
            jdev.aq_qp_map(jnp.asarray(frames[i]), qp, s))
    return out


def test_aq_qp_map_matches_jax_on_a_dense_sweep(refs):
    want_all = refs["aq_sweep"]
    mbs = 0
    for i, y in enumerate(_sweep_frames()):
        for j, (qp, strength) in enumerate(AQ_SETTINGS):
            got = tdev.aq_qp_map(_t(y), qp, strength).numpy()
            want = want_all[i, j]
            mbs += got.size
            k = ORDER_DEPENDENT.get((i, qp, strength))
            if k is None:
                np.testing.assert_array_equal(got, want, f"frame {i} qp {qp}")
                continue
            # the pinned MB: JAX's jit and eager runs disagree there, and
            # the port gives what the exact arithmetic gives
            assert np.flatnonzero(got != want).tolist() == [k]
            eager = refs[f"aq_sweep_eager_{i}_{qp}"]
            assert eager[k] != want[k] and got[k] == eager[k] == 25
    assert mbs == 160 * 24 * 4


def _chain_cases():
    rng = np.random.default_rng(6)
    for slice_qp in (20, 33):
        qp = rng.integers(1, 52, 200).astype(np.int32)
        coded = rng.random(200) < 0.4
        coded[:5] = False                    # no coded MB before the 6th
        yield slice_qp, qp, coded


def _jax_chain() -> dict:
    out = {}
    for slice_qp, qp, coded in _chain_cases():
        for i, a in enumerate(jdev.realized_qp_chain(
                jnp.asarray(qp), jnp.asarray(coded), slice_qp)):
            out[f"aq_chain_{slice_qp}_{i}"] = np.asarray(a)
    return out


def test_realized_qp_chain_matches_jax(refs):
    for slice_qp, qp, coded in _chain_cases():
        got = tdev.realized_qp_chain(_t(qp), _t(coded), slice_qp)
        for i, g in enumerate(got):
            _eq(g, refs[f"aq_chain_{slice_qp}_{i}"])


# the only |level| in 1..2^16 where the JAX package's _clz32 (31 minus a
# float32 log2 under XLA) is off by one: XLA's log2 of 2^13 and 2^15 lies
# just below the integer.  No level reaches them: the quantisers clamp
# |level| to 8191 (ROADMAP.md section C).
CLZ32_JAX_OFF_BY_ONE = (8192, 32768)
LEVEL_MAX = 8191


def _jax_clz32_and_lambda() -> dict:
    """The JAX package's _clz32 over |level| 1..2^16, the largest |level|
    its 4x4 and 8x8 quantisers give at any QP, and the t8 decision's
    lambda over QP 0..51."""
    a = np.arange(1, (1 << 16) + 1, dtype=np.int32)
    w4 = jt.fdct4x4(np.full((1, 4, 4), 255) * np.array([[1, -1, 1, -1]]))
    w8 = jt.fdct8x8(np.full((2, 8, 8), 255) * np.array([[1, -1] * 4]))
    top = max(max(int(jnp.abs(jt.quant4x4(w4 * 8, qp, True)).max()),
                  int(jnp.abs(jt.quant8x8(w8 * 8, qp, True)).max()))
              for qp in range(52))

    @jax.jit
    def lam2(qv):        # the expression of _luma_residual_pipeline's t8
        return jnp.maximum(1, jnp.round(
            0.9 * jnp.exp2((qv.astype(jnp.float32) - 12.0) / 3.0))
        ).astype(jnp.int32)

    return {"aq_clz32": np.asarray(jax.jit(jdev._clz32)(jnp.asarray(a))),
            "aq_level_max": top,
            "aq_lam2": np.asarray(lam2(jnp.arange(52, dtype=jnp.int32)))}


def test_clz32_and_lambda_tables_match_jax(refs):
    a = np.arange(1, (1 << 16) + 1, dtype=np.int32)
    got = tdev._clz32(_t(a)).numpy()
    want = refs["aq_clz32"]
    assert a[got != want].tolist() == list(CLZ32_JAX_OFF_BY_ONE)
    assert (got == 32 - np.floor(np.log2(a.astype(np.float64))) - 1).all()
    # the largest |level| the 4x4 and 8x8 quantisers give, at every QP
    assert int(refs["aq_level_max"]) == LEVEL_MAX < min(CLZ32_JAX_OFF_BY_ONE)
    np.testing.assert_array_equal(tdev.LAM2, refs["aq_lam2"])


def _mbs(rng, n, spread):
    src = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    pred = np.clip(src + rng.integers(-spread, spread + 1, src.shape), 0,
                   255).astype(np.int32)
    pred[: n // 4] = src[: n // 4] // 2              # large residuals
    return src, pred


def _t8_cases(per_mb, decimate):
    """(src, pred, [QP cases]) of the t8 pipeline test: per_mb, one (n, 1)
    QP array; else four QPs."""
    rng = np.random.default_rng(7 + 2 * per_mb + decimate)
    n = 48
    src, pred = _mbs(rng, n, 12)
    if per_mb:
        return src, pred, [rng.integers(10, 52, n).astype(np.int32)[:, None]]
    return src, pred, [14, 26, 38, 50]


def _jax_t8_pipeline() -> dict:
    fn = jax.jit(jdev._luma_residual_pipeline,
                 static_argnames=("intra", "decimate", "trellis", "t8"))
    out = {}
    for per_mb in (False, True):
        for decimate in (False, True):
            src, pred, qps = _t8_cases(per_mb, decimate)
            for c, qp in enumerate(qps):
                want = fn(jnp.asarray(src), jnp.asarray(pred),
                          jnp.asarray(qp) if per_mb else qp, intra=False,
                          decimate=decimate, t8=True)
                for name, w in zip(("levels", "res", "t8"), want):
                    out[f"aq_t8p_{int(per_mb)}{int(decimate)}_{c}_{name}"] \
                        = torch_jax_refs.digest(w)
    return out


@pytest.mark.parametrize("per_mb", [False, True])
@pytest.mark.parametrize("decimate", [False, True])
def test_luma_residual_pipeline_t8_matches_jax(refs, per_mb, decimate):
    src, pred, qps = _t8_cases(per_mb, decimate)
    n = src.shape[0]
    for c, qp in enumerate(qps):
        got = tdev._luma_residual_pipeline(
            _t(src), _t(pred), _t(qp) if per_mb else qp, intra=False,
            decimate=decimate, t8=True)
        for name, g in zip(("levels", "res", "t8"), got):
            key = f"aq_t8p_{int(per_mb)}{int(decimate)}_{c}_{name}"
            assert torch_jax_refs.digest(g) == str(refs[key]), (name, qp)
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


def jax_units() -> dict:
    """The JAX package's side of this file's tests, committed in
    tests/jax_refs/units.npz (tools/make_torch_jax_refs.py units)."""
    out = {}
    for intra in (False, True):
        for k, a in _jax_per_mb(intra).items():
            out[f"aq_pmq{int(intra)}_{k}"] = np.asarray(a)
        for k, v in _jax_8x8_family(intra).items():
            out[f"aq_f8{int(intra)}_{k}"] = v
    for make in (_jax_aq_sweep, _jax_chain, _jax_clz32_and_lambda,
                 _jax_t8_pipeline):
        out.update(make())
    return out


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
