"""Multiple references (--ref), with trellis, the port against the JAX
package: CompressSession() with no options (x264's --preset medium: ref
3, trellis, 3 B frames, MB-tree, weightp 2, the 8x8 transform, CABAC, AQ,
--me hex, quarter pel; batched), --preset faster (ref 2: the one-bit
te(v) ref_idx), --preset slow (ref 5, clamped to 4: ref_idx up to 3, --me
umh), --preset medium --tune zerolatency (per frame, the weight table
repeated per active reference), --preset medium --threads 1 (the
per-frame B scheduler, its anchors over the DPB) and --preset medium
--tune zerolatency --me esa (the exhaustive search once per reference).
All but the first add --min-keyint 2, so that the clip's scene cut
(batched_clip's, frame CUT_AT) becomes an IDR, which empties the DPB.

At 64x48 over 30 frames: every compress() return, end()["tail"] and
frames_info().delay equal the JAX session's, from tests/jax_refs/
multiref.npz (tools/make_torch_jax_refs.py multiref, hash-guarded by
test_torch_session.py::test_jax_references_are_current), but for the
departure test_torch_batched_live.py pins (ROADMAP.md, section C): a
JAX batched P header carries the weight table of the last P frame
encoded per frame, here repeated once per active reference; the port's
carries none.  The clip's third MB row flickers between two textures,
every frame on its left half and every fourth frame on its right half,
so that on the per-frame lines and at the B-frame lines' anchors a
reference older than the newest is the better one.  Stock FFmpeg
decodes the default session's and --preset faster's streams to the
port's own reconstruction.  A JAX encoder with a full DPB of 3,
converted mid-stream, goes on byte-identical in the port.

Module by module: _multi_ref_search_and_mc (R = 2, 3, 4, the
hierarchical and the exhaustive search, and two identical references,
where the newest wins every tie), p16_mv_pred with reference maps, the
P core over a stacked DPB (with trellis, AQ, the 8x8 transform and
weights), its ref_idx slots at nref 2 and 3, colocated_mv's mask of
MBs predicted from ref_idx > 0 and the loop filter's maps with ref_idx
(bS 1 across an edge between references).  Inputs come from numpy
seeds; no tolerance.
"""

import numpy as np
import pytest
import torch

import oracle
import torch_jax_refs
from test_torch_batched_live import (CUT_AT, batched_clip, departures,
                                     spied_session, with_departures)
from x264vfw_tpu_torch.bitstream.slice import SliceHeader
from x264vfw_tpu_torch.convert import config_from_jax_fields, state_from_numpy
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode import device_finalize as tfin
from x264vfw_tpu_torch.encode import torch_encoder as tenc
from x264vfw_tpu_torch.encode.device_pack import pack_slots
from x264vfw_tpu_torch.utils.bitstream import BitReader

W, H, NFR = 64, 48, 30
LINES = {"medium": "",
         "faster": "--preset faster --min-keyint 2",
         "slow": "--preset slow --min-keyint 2",
         "medium_zl": "--preset medium --tune zerolatency --min-keyint 2",
         "medium_t1": "--preset medium --threads 1 --min-keyint 2",
         "medium_zl_esa": "--preset medium --tune zerolatency --me esa "
                          "--min-keyint 2"}
BATCHED = ("medium", "faster", "slow")
DECODE = ("medium", "faster")
# the converted-state case: the per-frame medium line after CONVERT_AT
# frames (an IDR and 5 P frames: a full DPB of 3), then CONVERT_N frames
CONVERT_LINE = "medium_zl"
CONVERT_AT, CONVERT_N, CONVERT_QP = 6, 4, 27
# _multi_ref_search_and_mc: (R, me_backend, subpel, identical references)
SEARCH_CASES = ((2, "auto:hier", 2, False), (3, "auto:hier", 2, False),
                (4, "auto:hier", 2, False), (2, "auto", 0, False),
                (3, "auto", 2, False), (4, "auto", 0, False),
                (2, "auto:hier", 2, True))
SEARCH_RNG = 16
# the P core over a stacked DPB: (R, weights)
CORE_CASES = ((2, None), (3, (51, 3)))
CORE_QP = 26
CORE_KW = dict(rng=16, subpel=2, me_backend="auto:hier", aq_strength=1.0,
               qpc_offset=0, trellis=True, dct8x8=True)
HDR_VALS = np.zeros(64, np.int64)
HDR_LENS = np.zeros(64, np.int32)
HDR_VALS[:3] = (1, 5, 3)
HDR_LENS[:3] = (1, 3, 2)
MVP_SHAPES = ((3, 4), (1, 5), (5, 1), (4, 6))


def multiref_clip(frames=NFR):
    """batched_clip() (a moving texture, a low-contrast MB row, a scene cut
    at CUT_AT and a fade from FADE_FROM on) with its third MB row
    flickering between two static textures: on the left half every frame,
    on the right half every fourth frame, in both scenes (before the
    fade, so it fades too).  The second texture is the first with each
    8x8 block turned by 180 degrees, so neither the scene-cut detector
    nor the weight analysis (both on 8x8-pooled luma) sees the flicker."""
    n = np.random.default_rng(44).integers(0, 256, (17, W + 1))
    one = ((n[:-1, :-1] + n[1:, :-1] + n[:-1, 1:] + n[1:, 1:]) // 4) \
        .astype(np.uint8)
    two = one.reshape(2, 8, W // 8, 8)[:, ::-1, :, ::-1].reshape(16, W)
    tex = (one, np.ascontiguousarray(two))
    out = []
    for i, (y, u, v) in enumerate(batched_clip(frames)):
        y = y.copy()
        y[32:48, :32] = tex[i % 2][:, :32]
        y[32:48, 32:] = tex[(i // 4) % 2][:, 32:]
        out.append((y, u, v))
    return out


def search_case(R, tie=False, seed=20):
    """(src planes, R reference planes) int32 at 64x48: the references
    are the source texture moved by (r + 1, -r) pixels with noise, but
    reference c holds the source itself in MB column c, so that each of
    the first R columns has its own best reference; with tie, reference
    1 is a copy of reference 0."""
    rng = np.random.default_rng(seed + R)
    m = 24
    n = rng.integers(0, 256, (H + 2 * m + 1, W + 2 * m + 1)).astype(np.int32)
    big = (n[:-1, :-1] + n[1:, :-1] + n[:-1, 1:] + n[1:, 1:]) // 4

    def planes(a):
        return [a, a[::2, ::2], 255 - a[::2, ::2]]

    src = planes(big[m:m + H, m:m + W])
    refs = []
    for r in range(R):
        moved = big[m - r:m - r + H, m + r + 1:m + r + 1 + W]
        ref = [np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
               for p in planes(moved)]
        ref[0][:, 16 * r:16 * r + 16] = src[0][:, 16 * r:16 * r + 16]
        for c in (1, 2):
            ref[c][:, 8 * r:8 * r + 8] = src[c][:, 8 * r:8 * r + 8]
        refs.append([p.astype(np.int32) for p in ref])
    if tie:
        refs[1] = [p.copy() for p in refs[0]]
    return [p.astype(np.int32) for p in src], refs


def search_key(R, me, subpel, tie):
    return f"ms_{R}_{me.replace(':', '_')}_{subpel}_{int(tie)}"


def mvp_case(mbh, mbw, seed=50):
    """A seeded (mbh, mbw, 2) field with many zero vectors and a ref_idx
    map in [0, 3)."""
    rng = np.random.default_rng(seed + 7 * mbh + mbw)
    mv = rng.integers(-9, 10, (mbh, mbw, 2)) * (rng.random((mbh, mbw, 1))
                                                 < 0.6)
    return mv.astype(np.int32), rng.integers(0, 3, (mbh, mbw)).astype(
        np.int32)


def core_key(R):
    return f"core_{R}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(refs):
    return [_t(np.stack([r[p] for r in refs])) for p in range(3)]


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("multiref")


@pytest.fixture(scope="module")
def port_runs():
    """Each line's port session over multiref_clip() (test_torch_batched_
    live.spied_session)."""
    clip = multiref_clip()
    return {name: spied_session(cmd, clip) for name, cmd in LINES.items()}


@pytest.fixture(scope="module")
def port_cores():
    """The port's P core over each CORE_CASES DPB."""
    out = {}
    for R, wp in CORE_CASES:
        src, rf = search_case(R, seed=60)
        out[R] = tdev.encode_p_frame_core(*(_t(p) for p in src), *_stack(rf),
                                          CORE_QP, CORE_QP, wp=wp, **CORE_KW)
    return out


# ---------------------------------------------------------------- sessions

@pytest.mark.parametrize("name", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, name):
    """Bit for bit the JAX session's, but for the stale weight tables
    (test_stale_weight_tables_pinned_with_multi_ref)."""
    run = port_runs[name]
    want = with_departures(torch_jax_refs.aus(refs, f"{name}_out")
                           + [refs[f"{name}_tail"].tobytes()], run)
    assert len(want) - 1 == len(run["outs"]) == NFR
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{name}: compress() {i} differs"
    assert run["tail"] == want[-1]
    assert run["delay"] == int(refs[f"{name}_delay"])


def test_sessions_take_their_paths(port_runs):
    """The references (clamped to 4), trellis on, P partitions off with
    several references, the search, batched or per frame; the IDRs (the
    scene cut one on every line with --min-keyint 2) and the DPB's depth
    at each P frame: ref_idx reaches the older references, never beyond
    the frames coded since the last IDR."""
    want = {"medium": (3, True, "auto:hier", 2),
            "faster": (2, True, "auto:hier", 2),
            "slow": (4, True, "auto:hier", 2),
            "medium_zl": (3, False, "auto:hier", 2),
            "medium_t1": (3, False, "auto:hier", 2),
            "medium_zl_esa": (3, False, "auto", 2)}
    for name, run in port_runs.items():
        cfg, enc = run["cfg"], run["enc"]
        nref, batched, me, subpel = want[name]
        assert (enc.nref, run["batched"], cfg.me_backend, cfg.subpel) == \
            (nref, batched, me, subpel), name
        assert cfg.trellis and cfg.partitions and not enc.partitions, name
        assert enc.pps.num_ref_idx_l0_default_active_minus1 == nref - 1
        order = run["order"]
        idrs = [d for d, t in order if t == "I"]
        assert idrs == ([0] if name == "medium" else [0, CUT_AT]), name
        anchors = [d for d, t in order if t != "B"]
        depth, seen = [], 0
        for d in anchors:
            seen = 0 if d in idrs else seen + 1
            if d not in idrs:
                depth.append(min(seen, nref))
        assert len(depth) == len(run["ref_idx"]), name
        for k, (dep, ri) in enumerate(zip(depth, run["ref_idx"])):
            if dep == 1:
                assert ri is None, (name, k)
            else:
                assert int(ri.max()) < dep, (name, k)
        assert max(int(ri.max()) for ri in run["ref_idx"]
                   if ri is not None) == nref - 1, name


def test_stale_weight_tables_pinned_with_multi_ref(port_runs):
    """The JAX package's stale batched weight tables, with several
    references (ROADMAP.md, section C): where the last P frame encoded
    per frame (the anchors that filled the DPB, or a tail P) had weights,
    the JAX header of each batched P frame after it repeats them once per
    active reference; the port's header signals none.  The per-frame
    lines write no batched header."""
    seen = 0
    for name in BATCHED:
        run = port_runs[name]
        enc = run["enc"]
        for d, (jax_h, port_h) in departures(run).items():
            nref = run["batch_nref"][d]
            tables = []
            for hb in (jax_h, port_h):
                h = SliceHeader.parse(BitReader(np.frombuffer(hb, np.uint8)),
                                      enc.sps, enc.pps, 1, 3)
                assert h.num_ref_idx_l0_active_minus1 == nref - 1
                tables.append(h.luma_weights_l0)
            assert tables[1] == [None] * nref, (name, d)
            assert len(tables[0]) == nref and tables[0][0] is not None
            assert tables[0] == [tables[0][0]] * nref, (name, d)
            seen += nref > 1
    assert seen > 0
    for name in set(LINES) - set(BATCHED):
        assert port_runs[name]["batch_hdr"] == {}


@pytest.mark.parametrize("name", DECODE)
def test_stream_decodes_to_reconstruction(port_runs, name):
    """Stock FFmpeg decodes the whole stream: the I and P frames to the
    reference planes the encoder kept, the B frames above 30 dB."""
    run = port_runs[name]
    clip = multiref_clip()
    decoded = oracle.decode_h264(b"".join(run["outs"]) + run["tail"])
    assert decoded is not None and len(decoded) == NFR
    order = run["order"]
    anchors = [d for d, t in order if t != "B"]
    recon = dict(zip(anchors, run["recon"]))
    for d, t in order:
        y = decoded[d][:W * H].reshape(H, W)
        if t != "B":
            np.testing.assert_array_equal(y, recon[d],
                                          err_msg=f"{name} frame {d} ({t})")
        else:
            assert oracle.psnr(y, clip[d][0]) > 30.0, (name, d)


def test_converted_dpb_carries_on(refs):
    """A JAX per-frame encoder with a full DPB of 3, converted after
    CONVERT_AT frames (its last reference, DPB, counters, weight-analysis
    and scene-cut state), and the port go on with the same bytes and
    reconstructions."""
    cfg = config_from_jax_fields({k[len("cs_cfg_"):]: refs[k].item()
                                  for k in refs if k.startswith("cs_cfg_")})
    assert cfg.num_ref_frames == 3 and cfg.trellis
    enc = tenc.TorchEncoder(cfg, device="cpu")
    dpb = [tuple(refs[f"cs_dpb{i}_{k}"] for k in "yuv") for i in range(3)]
    st = {k: int(refs[f"cs_{k}"]) for k in ("frame_idx", "frame_num",
                                            "idr_id", "poc", "last_idr")}
    enc.load_state(state_from_numpy(
        *dpb[0], **st, wp_prev=refs["cs_wp_prev"],
        scenecut_prev=refs["cs_scenecut_prev"],
        scenecut_ema=float(refs["cs_scenecut_ema"]), dpb=dpb, device="cpu"))
    assert len(enc.dpb) == 3
    clip = multiref_clip()
    for i, f in enumerate(clip[CONVERT_AT:CONVERT_AT + CONVERT_N]):
        (au, _, ftype), = enc.push_frame(*f, qp_i=CONVERT_QP,
                                         qp_p=CONVERT_QP)
        assert ftype == "P"
        assert au == refs[f"cs_au_{i}"].tobytes(), f"frame {i} differs"
        for k, p in zip("yuv", enc.ref):
            np.testing.assert_array_equal(p.numpy().astype(np.uint8),
                                          refs[f"cs_rec{i}_{k}"])
        assert enc._cur_nref == 3


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("R,me,subpel,tie", SEARCH_CASES)
def test_multi_ref_search_equals_jax(refs, R, me, subpel, tie):
    """(mv_q, ref_idx, pred_y, pred_u, pred_v) of _multi_ref_search_and_mc;
    each of the first R MB columns goes to its own reference, and with
    two identical references every MB to the newest."""
    src, rf = search_case(R, tie)
    got = tdev._multi_ref_search_and_mc(
        *(_t(p) for p in src), [tuple(_t(p) for p in r) for r in rf],
        SEARCH_RNG, subpel=subpel, me_backend=me)
    key = search_key(R, me, subpel, tie)
    for name, g in zip(("mv_q", "ref_idx", "pred_y", "pred_u", "pred_v"),
                       got):
        np.testing.assert_array_equal(g.numpy(), refs[f"{key}_{name}"],
                                      err_msg=name)
    sel = got[1].numpy()
    if tie:
        assert (sel == 0).all()
    else:
        for c in range(R):
            assert (sel[:, c] == c).all(), (c, sel)


def test_ref_bits():
    """te(v): one bit at R = 2; ue(v) lengths above."""
    assert [tdev._ref_bits(r, 2) for r in range(2)] == [1, 1]
    assert [tdev._ref_bits(r, 4) for r in range(4)] == [1, 3, 3, 5]


@pytest.mark.parametrize("mbh,mbw", MVP_SHAPES)
def test_p16_mv_pred_with_refs_equals_jax(refs, mbh, mbw):
    """p16_mv_pred(mv, ref): the predictor and the P_Skip zero condition;
    without ref it is p16_mv_pred(mv, zeros)."""
    mv, ref = mvp_case(mbh, mbw)
    pmv, skip0 = tfin.p16_mv_pred(_t(mv), _t(ref))
    key = f"mvp_{mbh}x{mbw}"
    np.testing.assert_array_equal(pmv.numpy(), refs[f"{key}_pmv"])
    np.testing.assert_array_equal(skip0.numpy(), refs[f"{key}_skip"])
    a = tfin.p16_mv_pred(_t(mv))
    b = tfin.p16_mv_pred(_t(mv), torch.zeros(mbh, mbw, dtype=torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("R", [R for R, _ in CORE_CASES])
def test_p_core_over_dpb_equals_jax(refs, port_cores, R):
    """encode_p_frame_core over a stacked DPB with trellis, AQ, the 8x8
    transform (and weights at R = 3): every output, 'ref_idx' among
    them, which uses each reference."""
    got = port_cores[R]
    key = core_key(R)
    want = {k[len(key) + 5:]: v for k, v in refs.items()
            if k.startswith(key + "_out_")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(got["ref_idx"].tolist()) == set(range(R))


def _coded(vals, lens):
    """The (value, length) of every slot that codes bits, in order."""
    v, ln = np.asarray(vals).reshape(-1), np.asarray(lens).reshape(-1)
    keep = ln > 0
    return list(zip((v[keep] & ((1 << ln[keep].astype(np.int64)) - 1))
                    .tolist(), ln[keep].tolist()))


@pytest.mark.parametrize("R", [R for R, _ in CORE_CASES])
def test_ref_idx_slots_equal_jax(refs, port_cores, R):
    """_finalize_p_core at nref R: every coded slot (one bit !ref_idx at
    nref 2, ue(v) at 3) in the JAX package's order, and the packed
    bytes."""
    vals, lens = tfin._finalize_p_core(port_cores[R], _t(HDR_VALS),
                                       _t(HDR_LENS), H // 16, W // 16,
                                       t8_mode=True, nref=R)
    key = core_key(R)
    assert _coded(vals, lens) == _coded(refs[f"{key}_fin_vals"],
                                        refs[f"{key}_fin_lens"])
    data, bits = pack_slots(vals, lens)
    assert bits == int(refs[f"{key}_fin_bits"])
    np.testing.assert_array_equal(data[:(bits + 7) // 8].numpy(),
                                  refs[f"{key}_fin_bytes"])


@pytest.mark.parametrize("R", [R for R, _ in CORE_CASES])
def test_colocated_mv_masks_older_refs(refs, port_cores, R):
    """colocated_mv: MBs predicted from ref_idx > 0 report (4096, 4096),
    never colZero."""
    got = tfin.colocated_mv(port_cores[R], (H // 16) * (W // 16))
    np.testing.assert_array_equal(got.numpy(), refs[f"{core_key(R)}_col"])
    older = port_cores[R]["ref_idx"] != 0
    assert bool(older.any()) and bool((got[older] == 4096).all())


@pytest.mark.parametrize("R", [R for R, _ in CORE_CASES])
def test_loop_filter_maps_with_ref_idx_equal_jax(refs, port_cores, R):
    """loop_filter_maps with the core's ref_idx (the maps the JAX
    package's apply_loop_filter builds) and the filtered planes; with the
    residual taken away, ref_idx alone moves bS (1 across an edge between
    the MB columns' own references, all at mv 0)."""
    out = port_cores[R]
    key = core_key(R)
    maps = tdev.loop_filter_maps(out, CORE_QP, H // 16, W // 16, False)
    for i, m in enumerate(maps):
        np.testing.assert_array_equal(m.numpy(), refs[f"{key}_map_{i}"],
                                      err_msg=f"map {i}")
    for p, g in zip("yuv", tdev.apply_loop_filter(out, CORE_QP, H // 16,
                                                  W // 16, False)):
        np.testing.assert_array_equal(g.numpy(), refs[f"{key}_lf_{p}"])
    bare = dict(out, cbp_luma=torch.zeros_like(out["cbp_luma"]))
    one_ref = dict(bare, ref_idx=torch.zeros_like(out["ref_idx"]))
    assert not torch.equal(
        tdev.loop_filter_maps(bare, CORE_QP, H // 16, W // 16, False)[0],
        tdev.loop_filter_maps(one_ref, CORE_QP, H // 16, W // 16, False)[0])
