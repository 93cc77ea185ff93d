"""In-loop deblocking: the port's maps, filter and loop-filter step vs the
JAX package.

x264vfw_tpu_torch.ops.deblock.build_maps against x264vfw_tpu.ops.deblock.
build_maps; x264vfw_tpu_torch.ops.kernels.deblock.deblock_apply_plain
against the numpy spec-order golden model apply_maps_np and against the
JAX hot path's deblock_apply_wavefront, on cases where every bS value
0..4 occurs; encode.device.apply_loop_filter against the JAX one for an
intra frame and a partitioned inter frame (the JAX wavefront's and
apply_loop_filter's outputs committed in tests/jax_refs/core.npz, the
maps and the golden model's planes in tests/jax_refs/units.npz,
tools/make_torch_jax_refs.py, hash-guarded).  Inputs come from numpy
seeds.  Tolerance: none.  The CUDA kernel is held against the plain version on
the card (the `cuda` test below and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.ops import deblock as jdb
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.ops import deblock as tdb
from x264vfw_tpu_torch.ops.kernels import deblock as tkd


def _metadata(mbh, mbw, seed, intra_share=0.3):
    """Random coding metadata: intra and inter MBs, coded blocks, vectors
    that differ by >= 4 quarter pels and by less, refs, QPs 16..51."""
    rng = np.random.default_rng(seed)
    intra = rng.random((mbh, mbw)) < intra_share
    tc4 = ((rng.random((4 * mbh, 4 * mbw)) < 0.3)
           * rng.integers(1, 5, (4 * mbh, 4 * mbw))).astype(np.int32)
    mv4 = rng.integers(-6, 7, (4 * mbh, 4 * mbw, 2)).astype(np.int32)
    ref4 = (rng.random((4 * mbh, 4 * mbw)) < 0.1).astype(np.int32)
    qp = rng.integers(16, 52, (mbh, mbw)).astype(np.int32)
    return intra, tc4, mv4, ref4, qp


def _planes(mbh, mbw, seed):
    """Blocky planes with small steps, so that the filters act."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mbh, 16 * mbw
    base = rng.integers(60, 200, (H // 4, W // 4))
    y = (np.kron(base, np.ones((4, 4), np.int64))
         + rng.integers(-3, 4, (H, W))).clip(0, 255).astype(np.int32)
    u = (y[::2, ::2] + rng.integers(-2, 3, (H // 2, W // 2))).clip(0, 255)
    return y, u.astype(np.int32), (255 - u).astype(np.int32)


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("core")


@pytest.fixture(scope="module")
def units():
    return torch_jax_refs.load("units")


def _kind_meta(kind):
    """build_maps' metadata at 4x5 MBs, all intra or all inter."""
    intra, tc4, mv4, ref4, qp = _metadata(4, 5, seed=1)
    if kind == "intra":
        intra[:] = True
        tc4[:] = 0
        mv4[:] = 0
    else:
        intra[:] = False
    return intra, tc4, mv4, ref4, qp


KIND_OFFSETS = (-12, 6, 2)                  # offA, offB, chroma offset
WAVEFRONT_CASES = [(3, 4, -12, 12), (4, 5, 12, -12)]


def jax_units() -> dict:
    """The JAX package's build_maps on this file's cases and its numpy
    golden model apply_maps_np on the wavefront cases, committed in
    tests/jax_refs/units.npz (tools/make_torch_jax_refs.py units)."""
    maps = jax.jit(jdb.build_maps, static_argnums=(5, 6, 7))
    out = {}
    for kind in ("intra", "inter"):
        for i, m in enumerate(maps(*(jnp.asarray(a) for a in _kind_meta(
                kind)), *KIND_OFFSETS)):
            out[f"db_maps_{kind}_{i}"] = np.asarray(m)
    for mbh, mbw, offA, offB in WAVEFRONT_CASES:
        ms = [np.asarray(m) for m in maps(*(jnp.asarray(a) for a in _metadata(
            mbh, mbw, seed=mbh * mbw)), offA, offB, 0)]
        gold = [p.copy() for p in _planes(mbh, mbw, seed=mbw)]
        jdb.apply_maps_np(*gold, *ms)
        for i, m in enumerate(ms):
            out[f"db_maps_{mbh}x{mbw}_{i}"] = m
        for p, g in zip("yuv", gold):
            out[f"db_gold_{mbh}x{mbw}_{p}"] = g
    return out


@pytest.mark.parametrize("kind", ["intra", "inter"])
def test_build_maps_matches_jax(units, kind):
    got = tdb.build_maps(*(torch.from_numpy(a) for a in _kind_meta(kind)),
                         *KIND_OFFSETS)
    for i, g in enumerate(got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), units[f"db_maps_{kind}_{i}"])


@pytest.mark.parametrize("mbh,mbw,offA,offB", WAVEFRONT_CASES)
def test_deblock_plain_matches_golden_and_wavefront(refs, units, mbh, mbw,
                                                    offA, offB):
    meta = _metadata(mbh, mbw, seed=mbh * mbw)
    tmaps = tdb.build_maps(*(torch.from_numpy(a) for a in meta), offA, offB,
                           0)
    maps = [units[f"db_maps_{mbh}x{mbw}_{i}"] for i in range(4)]
    for t, m in zip(tmaps, maps):
        np.testing.assert_array_equal(t.numpy(), m)
    assert (np.bincount((maps[0] & 7).ravel(), minlength=5) > 0).all()
    assert (np.bincount((maps[1] & 7).ravel(), minlength=5) > 0).all()
    y, u, v = _planes(mbh, mbw, seed=mbw)
    # the numpy golden model apply_maps_np and deblock_apply_wavefront on
    # these planes and maps (committed)
    gold = [units[f"db_gold_{mbh}x{mbw}_{p}"] for p in "yuv"]
    wave = [refs[f"dbw_{mbh}x{mbw}_{p}"] for p in "yuv"]
    got = tkd.deblock_apply(*(torch.from_numpy(a) for a in (y, u, v)),
                            *tmaps)
    for g, want, w in zip(got, gold, wave):
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != y).sum() > 100      # the filter acted


def _p_out(mbh, mbw, seed):
    """Syntax tensors + recon of a partitioned P frame, as numpy."""
    rng = np.random.default_rng(seed)
    n = mbh * mbw
    y, u, v = _planes(mbh, mbw, seed)
    levels = (rng.random((n, 16, 16)) < 0.05) * rng.integers(-2, 3,
                                                               (n, 16, 16))
    return {"recon_y": y, "recon_u": u, "recon_v": v,
            "levels": levels.astype(np.int32),
            "cbp_luma": rng.integers(0, 16, n).astype(np.int32),
            "mv": rng.integers(-8, 9, (n, 2)).astype(np.int32),
            "mv8": rng.integers(-8, 9, (2 * mbh, 2 * mbw, 2))
            .astype(np.int32)}


# the QP and offsets of the apply_loop_filter case
LF_QP, LF_OFFSETS = 30, dict(offA=4, offB=-2, qpc_offset=1)


@pytest.mark.parametrize("intra", [True, False])
def test_apply_loop_filter_matches_jax(refs, intra):
    mbh, mbw = 3, 4
    out = _p_out(mbh, mbw, seed=5)
    # the JAX package's apply_loop_filter on the same case (committed)
    want = [refs[f"alf_{int(intra)}_{p}"] for p in "yuv"]
    got = tdev.apply_loop_filter({k: torch.from_numpy(a)
                                  for k, a in out.items()},
                                 LF_QP, mbh, mbw, intra, **LF_OFFSETS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != out["recon_y"]).any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "geometry"])
def test_wrapper_rejects_bad_inputs(bad):
    y, u, v = (torch.from_numpy(a) for a in _planes(2, 3, seed=1))
    maps = list(tdb.build_maps(*(torch.from_numpy(a)
                                 for a in _metadata(2, 3, seed=1)), 0, 0, 0))
    if bad == "dtype":
        u = u.to(torch.int16)
    elif bad == "shape":
        maps[1] = maps[1][:-1]
    elif bad == "contiguous":
        maps[0] = maps[0].t().contiguous().t()
    else:
        y, u, v = y[:-8], u[:-4], v[:-4]
    with pytest.raises((TypeError, ValueError)):
        tkd.deblock_apply(y, u, v, *maps)


def test_cpu_tensor_takes_plain_version():
    planes = [torch.from_numpy(a) for a in _planes(2, 3, seed=2)]
    maps = tdb.build_maps(*(torch.from_numpy(a)
                            for a in _metadata(2, 3, seed=2)), 0, 0, 0)
    before = tkd.LAUNCHES
    got = tkd.deblock_apply(*planes, *maps)
    assert tkd.LAUNCHES == before
    want = tkd.deblock_apply_plain(*planes, *maps)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tkd.diagonals(2, 3) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("mbh,mbw", [(68, 120), (3, 4), (5, 7), (2, 20),
                                     (1, 7), (9, 1)])
def test_kernel_matches_plain_on_card(mbh, mbw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    planes = [torch.from_numpy(a).cuda() for a in _planes(mbh, mbw, seed=3)]
    maps = tdb.build_maps(*(torch.from_numpy(a).cuda()
                            for a in _metadata(mbh, mbw, seed=3)), 6, -6, 0)
    before = tkd.LAUNCHES
    got = tkd.deblock_apply(*planes, *maps)
    assert tkd.LAUNCHES == before + 1
    want = tkd.deblock_apply_plain(*planes, *maps)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_repeats_identically_on_card():
    """50 calls on the same 1080p inputs give 50 identical outputs: a fault
    in the rows' memory ordering would show as a rare mismatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    planes = [torch.from_numpy(a).cuda() for a in _planes(68, 120, seed=4)]
    maps = tdb.build_maps(*(torch.from_numpy(a).cuda()
                            for a in _metadata(68, 120, seed=4)), 6, -6, 0)
    first = tkd.deblock_apply(*planes, *maps)
    for _ in range(50):
        got = tkd.deblock_apply(*planes, *maps)
        assert all(torch.equal(g, w) for g, w in zip(got, first))
