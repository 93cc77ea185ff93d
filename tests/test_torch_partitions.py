"""P partitions with quarter-pel refinement and the loop filter: the port vs
the JAX package, piece by piece and as a whole.

Pieces of x264vfw_tpu_torch.encode.inter_partition against
x264vfw_tpu.encode.inter_partition (on the CPU the JAX package resolves
its backend to the XLA branch, which tests/test_pallas_sad.py and
tests/test_pallas_memc.py hold bit-equal to the Pallas kernels), the
quad-mode SAD's plain version against _quad_sads(..., "xla"), and the
slice as a whole: the CompressSession bytes for
--preset ultrafast --tune zerolatency --me esa --qp 26 --deblock 0:0
--partitions p8x8 --subme 7 and one partitioned P frame encoded from the
same reference through convert.state_from_numpy; and the same session
without --me esa, whose ':hier' suffix the partition search ignores, so
that it gives slice 2's bytes.  The JAX package's outputs for these are
committed in tests/jax_refs/slice2.npz, those of the pieces in
calls.npz and units.npz (tools/make_torch_jax_refs.py; its hash guard
is in test_torch_session.py).  Inputs come from numpy seeds.  Tolerance: none.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu.encode import inter_partition as jip
from x264vfw_tpu.encode.ref_encoder import EncoderConfig as JaxConfig
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream.nal import split_annexb
from x264vfw_tpu_torch.convert import config_from_jax_fields, state_from_numpy
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode import inter_partition as tip
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
from x264vfw_tpu_torch.ops.kernels import sad as tsad

CMDLINE = ("--preset ultrafast --tune zerolatency --me esa --qp 26 "
           "--deblock 0:0 --partitions p8x8 --subme 7")
CMDLINE_HIER = CMDLINE.replace(" --me esa", "")


def _frames(H, W, R, seed):
    """A source whose MBs each move by a random partition layout's
    vectors (within +-(R-1)) against a smooth reference, with noise."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 256, (H + 2 * R + 2, W + 2 * R + 2)).astype(np.int32)
    big = ((n[:-2, :-2] + n[2:, 2:] + 2 * n[1:-1, 1:-1]) // 4)
    ref = big[R:R + H, R:R + W].astype(np.int32)
    src = np.empty((H, W), np.int32)
    for my in range(H // 16):
        for mx in range(W // 16):
            layout = rng.integers(0, 4)
            vec = rng.integers(1 - R, R, (4, 2))
            for q in range(4):
                g = (0, q >> 1, q & 1, q)[layout]   # the quadrant's partition
                dx, dy = vec[g]
                y0, x0 = 16 * my + 8 * (q >> 1), 16 * mx + 8 * (q & 1)
                src[y0:y0 + 8, x0:x0 + 8] = big[R + y0 + dy:R + y0 + dy + 8,
                                                R + x0 + dx:R + x0 + dx + 8]
    src = (src + rng.integers(-3, 4, (H, W))).clip(0, 255).astype(np.int32)
    refc = [rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
            for _ in range(2)]
    srcc = [np.roll(c, (1, -1), (0, 1)) for c in refc]
    return src, ref, srcc, refc


@jax.jit
def _jax_mvds(mv8, part):
    return jip.partition_mvds(mv8, part)


def _jax_minima(src, ref, R):
    refp = np.pad(ref, R + 8, mode="edge").astype(np.int16)
    q = jip._quad_sads(jnp.asarray(src, jnp.int16), jnp.asarray(refp), R,
                       "xla")
    return jip._minima_from_q(q, R)


DECIDE_QPS = (12, 30)
DECIDE_HWR = (48, 64, 4)


def jax_decide(qp):
    """The JAX minima and decision on the case's frames (what
    tools/make_torch_jax_refs.py commits as decide_<qp>_*)."""
    H, W, R = DECIDE_HWR
    src, ref, _, _ = _frames(H, W, R, seed=qp)
    jm = _jax_minima(src, ref, R)
    return jm, jip.partition_decide_from_minima(jm, R, qp)


@pytest.mark.parametrize("qp", DECIDE_QPS)
def test_decide_from_minima_matches_jax(qp):
    """Against the JAX outputs committed in tests/jax_refs/calls.npz."""
    H, W, R = DECIDE_HWR
    src, ref, _, _ = _frames(H, W, R, seed=qp)
    refs = torch_jax_refs.load("calls")
    jm = {k: refs[f"decide_{qp}_min_{k}"] for k in tsad.NAMES}
    want_part, want_mv8 = refs[f"decide_{qp}_part"], refs[f"decide_{qp}_mv8"]
    tm = tsad.sad_partition_minima(
        torch.from_numpy(src.astype(np.uint8)),
        torch.from_numpy(np.pad(ref, R, mode="edge").astype(np.uint8)), R)
    for k in tsad.NAMES:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    part, mv8 = tip.partition_decide_from_minima(tm, R, qp)
    np.testing.assert_array_equal(part.numpy(), np.asarray(want_part))
    np.testing.assert_array_equal(mv8.numpy(), np.asarray(want_mv8))
    assert len(np.unique(part.numpy())) > 1


def _chroma_case():
    H, W, R = 48, 64, 8
    rng = np.random.default_rng(4)
    lim = 4 * R + 2
    mv8 = rng.integers(-lim, lim + 1, (H // 8, W // 8, 2)).astype(np.int32)
    ru, rv = (rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
              for _ in range(2))
    return (H, W, R), mv8, ru, rv


def test_chroma_mc_8x8_matches_jax(units):
    _, mv8, ru, rv = _chroma_case()
    got = tdev._chroma_mc(*(torch.from_numpy(a) for a in (mv8, ru, rv)), 4)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), units[f"pt_chroma_{i}"])


def _mvds_case(seed):
    rng = np.random.default_rng(seed)
    mbh, mbw = 4, 5
    mv8 = rng.integers(-9, 10, (2 * mbh, 2 * mbw, 2)).astype(np.int32)
    mv8[rng.random((2 * mbh, 2 * mbw)) < 0.3] = 0      # zero vectors: P_Skip
    part = rng.integers(0, 4, (mbh, mbw)).astype(np.int32)
    return mv8, part


@pytest.mark.parametrize("seed", [0, 1])
def test_partition_mvds_matches_jax(units, seed):
    mv8, part = _mvds_case(seed)
    got = tip.partition_mvds(torch.from_numpy(mv8), torch.from_numpy(part))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), units[f"pt_mvds{seed}_{i}"])


SEARCH_MC = (48, 64, 4, 20, 2)          # H, W, R, qp, subpel
SEARCH_MC_OUT = ("part", "mv8", "pred_y", "pred_u", "pred_v")


def _quad_case():
    H, W, R = 48, 64, 4
    rng = np.random.default_rng(9)
    src = rng.integers(0, 256, (H, W)).astype(np.uint8)
    refp = np.pad(rng.integers(0, 256, (H, W)), R + 8,
                  mode="edge").astype(np.uint8)
    return (H, W, R), src, refp


def jax_units() -> dict:
    """The JAX package's side of the chroma MC, mvds, search-and-MC and
    quad-SAD tests, committed in tests/jax_refs/units.npz
    (tools/make_torch_jax_refs.py units)."""
    out = {}
    (H, W, R), mv8, ru, rv = _chroma_case()
    for i, a in enumerate(jip._chroma_mc_8x8(
            jnp.asarray(mv8), jnp.asarray(ru), jnp.asarray(rv), R, H, W)):
        out[f"pt_chroma_{i}"] = np.asarray(a)
    for seed in (0, 1):
        for i, a in enumerate(_jax_mvds(*(jnp.asarray(a)
                                          for a in _mvds_case(seed)))):
            out[f"pt_mvds{seed}_{i}"] = np.asarray(a)
    H, W, R, qp, subpel = SEARCH_MC
    src, ref, srcc, refc = _frames(H, W, R, seed=subpel)
    for name, a in zip(SEARCH_MC_OUT, jax.jit(
            jip.partition_search_and_mc, static_argnums=(6, 8))(
            *(jnp.asarray(a) for a in (src, *srcc, ref, *refc)), R, qp,
            subpel)):
        out[f"pt_smc_{name}"] = np.asarray(a)
    (H, W, R), src, refp = _quad_case()
    out["pt_quad"] = np.asarray(jip._quad_sads(
        jnp.asarray(src, jnp.int16), jnp.asarray(refp, jnp.int16), R, "xla"))
    return out


@pytest.fixture(scope="module")
def units():
    return torch_jax_refs.load("units")


def test_partition_search_and_mc_matches_jax(units):
    """Quarter pel (half pel: test_torch_memc.py and the decode test)."""
    H, W, R, qp, subpel = SEARCH_MC
    src, ref, srcc, refc = _frames(H, W, R, seed=subpel)
    planes = (src, *srcc, ref, *refc)
    got = tip.partition_search_and_mc(*(torch.from_numpy(a) for a in planes),
                                      R, qp, subpel=subpel)
    for name, g in zip(SEARCH_MC_OUT, got):
        np.testing.assert_array_equal(g.numpy(), units[f"pt_smc_{name}"],
                                      err_msg=name)


def test_quad_plain_matches_xla(units):
    (H, W, R), src, refp = _quad_case()
    want = units["pt_quad"]
    s = torch.from_numpy(src)
    r = torch.from_numpy(refp[8:-8, 8:-8].copy())
    got = tsad.sad_search_quad(s, r, R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = got.numpy().reshape(-1, H // 16, 2, W // 16, 2).sum((2, 4))
    np.testing.assert_array_equal(tsad.sad_search(s, r, R).numpy(), q)


@pytest.mark.parametrize("extra", ["--partitions p8x8",
                                   "--partitions p8x8 --subme 2",
                                   "--deblock 1:-1 --partitions p8x8 "
                                   "--subme 7"])
def test_stream_decodes_to_reconstruction(extra):
    """Stock FFmpeg decodes the port's stream to the port's own (deblocked)
    reconstruction, frame by frame, at integer, half and quarter pel.  At
    --subme 0 the JAX package's stream does not (ROADMAP.md section C)."""
    s = CompressSession(extra_cmdline=CMDLINE.split(" --deblock")[0] + " "
                        + extra, device="cpu")
    s.begin(64, 48)
    stream, recon = b"", []
    for f in moving_clip(64, 48, 3, seed=5):
        stream += s.compress(f)
        recon.append(s.encoder.last_recon[0])
    decoded = oracle.decode_h264(stream)
    assert decoded is not None and len(decoded) == 3
    for d, r in zip(decoded, recon):
        np.testing.assert_array_equal(d[:64 * 48].reshape(48, 64), r)


def converted_state_case():
    """(JAX EncoderConfig, reference planes, current frame) of the
    partitioned P frame encoded from a loaded reference picture."""
    w, h = 64, 48
    jcfg = JaxConfig(width=w, height=h, qp=26, keyint=250, search_range=16,
                     subpel=2, partitions=True, deblock=True)
    src, ref, srcc, refc = _frames(h, w, 16, seed=11)
    cur = [src.astype(np.uint8), *(c.astype(np.uint8) for c in srcc)]
    return jcfg, [ref, *refc], cur


@pytest.fixture(scope="module")
def jax_refs():
    return torch_jax_refs.load("slice2")


def test_session_bytes_equal_jax(jax_refs):
    s = CompressSession(extra_cmdline=CMDLINE, device="cpu")
    s.begin(64, 48)
    enc = s.encoder
    assert (enc.cfg.deblock, enc.cfg.partitions, enc.cfg.subpel) == \
        (True, True, 2)
    aus = [s.compress(f) for f in moving_clip(64, 48, 3, seed=64)]
    assert s.end()["frames"] == 3
    types = [u.nal_unit_type for u in split_annexb(b"".join(aus))]
    assert types.count(5) == 1 and types.count(1) == 2, types
    want = torch_jax_refs.aus(jax_refs, "session")
    assert len(want) == 3
    for i, (got, w_) in enumerate(zip(aus, want)):
        assert got == w_, f"AU {i} differs"
    assert enc.last_mv8.shape == (6, 8, 2)


def test_session_without_me_esa_gives_slice2_bytes(jax_refs):
    """--me left at ultrafast's dia: the P16x16 search would be the
    hierarchical one, but partitions search exhaustively, in the JAX
    package (inter_partition.py:152-153) and in the port alike."""
    s = CompressSession(extra_cmdline=CMDLINE_HIER, device="cpu")
    s.begin(64, 48)
    assert s.encoder.cfg.me_backend == "auto:hier"
    aus = [s.compress(f) for f in moving_clip(64, 48, 3, seed=64)]
    s.end()
    want = torch_jax_refs.aus(jax_refs, "session_hier")
    assert want == torch_jax_refs.aus(jax_refs, "session") and len(want) == 3
    for i, (got, w_) in enumerate(zip(aus, want)):
        assert got == w_, f"AU {i} differs"


def test_partitioned_p_frame_from_converted_state(jax_refs):
    """Same reference picture -> same P-frame bytes and same deblocked
    reconstruction."""
    jcfg, ref_planes, cur = converted_state_case()
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    enc = TorchEncoder(cfg, device="cpu")
    enc.load_state(state_from_numpy(*ref_planes, frame_idx=1, idr_id=1,
                                    device="cpu"))
    got = enc.encode_frame(*cur, qp=26, force_idr=False)
    assert got == jax_refs["p_au"].tobytes()
    for a, k in zip(enc.ref, "yuv"):
        np.testing.assert_array_equal(a.numpy(), jax_refs[f"p_ref_{k}"])
