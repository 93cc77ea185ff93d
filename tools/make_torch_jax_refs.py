"""Write the JAX package's outputs that the port's session tests compare
against (tests/jax_refs/{slice1,slice2,live,l3,l4,core,batched}.npz).

    JAX_PLATFORMS=cpu python tools/make_torch_jax_refs.py [NAME ...]

With NAMEs (e.g. batched), only those files are written.  Run it from the
repository root after any change to x264vfw_tpu/ or to those tests'
inputs; test_torch_session.py::
test_jax_references_are_current names this script when the recorded
source hash no longer matches.  Each file holds:

  * source_sha256: tests/torch_jax_refs.source_hash() of x264vfw_tpu/;
  * the access units of the JAX CompressSession on the tests' clips, as
    uint8 arrays <geometry or "session">_<index> (slice 2 also under
    "session_hier": its line without --me esa, which selects the
    hierarchical search for P16x16 and which the partition search
    ignores);
  * for the test that loads a reference picture into both encoders
    (convert.state_from_numpy), the JAX P frame's access unit (p_au) and
    its reconstruction (p_ref_y, p_ref_u, p_ref_v);
  * live.npz (test_torch_live_presets.py, test_torch_intra4x4.py): the
    access units and tail of the veryfast, superfast and scene-cut
    sessions (<line>_<index>, <line>_tail); the slope-2 I frame with
    I4x4 at 64x48 and 128x96 (i<w>x<h>_<output key>) and its slot rows
    (i<w>x<h>_t8<0|1>_vals/_lens); and the converted-state case (cs_*:
    the JAX encoder's config fields, DPB, counters, weight-analysis and
    scene-cut state after CONVERT_AT frames, then its next frames' access
    units and reconstructions);
  * l3.npz (test_torch_pipeline.py): per rate setting every compress()
    return, the tail and frames_info().delay of the batched session;
  * l4.npz (test_torch_hier.py): the access units of the L4 session;
  * core.npz (test_torch_{encode_core,deblock,cavlc_pack}.py): the I and
    P cores' outputs (ei_*, ep_*), their finalisation's bytes and bit
    counts (fin_I_*, fin_P_*), the exhaustive search's MC (mc_*), the
    deblock wavefront (dbw_<mbh>x<mbw>_<plane>), apply_loop_filter
    (alf_<intra>_<plane>) and pack_slots (pack_<i>_bytes, _bits) on
    those tests' inputs.
  live.npz also holds the P cores of test_torch_aq_t8.py
  (pcore_<partitions>_<qp>_<output key>, and _lf_<plane> for the loop
  filter over them);
  * batched.npz (test_torch_batched_live.py, test_torch_bframes.py): per
    line of the B-frame sessions every compress() return, the tail and
    frames_info().delay (<line>_out_<i>, <line>_tail, <line>_delay); the
    converted-state case of a per-frame B encoder (cs_*: config fields,
    DPB, counters, POC base, display index, the pending frames' display
    indices, last_mv, weight-analysis and scene-cut state, then the
    (display index, is_idr) and access units of the frames after it);
    the B cores (b<w>x<h>_<search>_<output key>), their slot rows, bit
    counts and packed bytes (..._slot<t8_mode>_{vals,lens,bits,bytes});
    and the P cores with MB-tree offsets (pq_aq<0|1>_p<0|1>_<key>);
  * calls.npz (the single JAX calls of the older test files, so that
    they do not compile on every run): the Pallas SAD kernel in interpret
    mode (sad_<H>x<W>_<R>_<output>, test_torch_sad.py), the hierarchical
    search (hier_<rng>_<subpel>_<output>, test_torch_hier.py), the
    partition minima and decision (decide_<qp>_*,
    test_torch_partitions.py), cavlc_jax.encode_blocks
    (blocks_<maxc>_{vals,lens}, test_torch_cavlc_pack.py) and build_maps
    with t8 and per-MB QPs (maps_<offA>_<offB>_<cqo>_<i>,
    test_torch_aq_t8.py);
  * units.npz (the unit tests of test_torch_{aq_t8,transform,deblock,
    partitions,memc}.py, so that they call no JAX): each file's
    jax_units(), prefixed aq_, tf_, db_, pt_ and mc_; large outputs as
    torch_jax_refs.digest() strings;
  * multiref.npz (test_torch_multiref.py, test_torch_trellis.py): per
    line of the multi-reference sessions every compress() return, the
    tail and frames_info().delay (<line>_out_<i>, <line>_tail,
    <line>_delay); the converted-state case of a per-frame encoder with a
    full DPB (cs_*: config fields, DPB, counters, weight-analysis and
    scene-cut state, then the access units and reconstructions of the
    frames after it); _multi_ref_search_and_mc (ms_<R>_<search>_<subpel>
    _<tie>_<output>); p16_mv_pred with reference maps (mvp_<mbh>x<mbw>_
    {pmv,skip}); the P core over a stacked DPB (core_<R>_out_<key>), its
    slot rows, bit count and packed bytes at nref R (core_<R>_fin_*),
    colocated_mv (core_<R>_col), the maps apply_loop_filter builds
    (core_<R>_map_<i>) and its planes (core_<R>_lf_<plane>); and the
    trellis cases: _trellis_adjust at one QP (tr_scalar_<intra>, one row
    per QP 0..51) and per MB (tr_mb_<intra>), the thresholds (tr_lam,
    tr_lam4, tr_lam15) and the residual pipeline with trellis
    (tr_pipe_<t8><decimate>_*);
  * surface.npz (test_torch_telemetry.py, test_torch_muxers.py,
    test_torch_cli.py): per line of the --psnr/--ssim sessions every
    compress() return, the tail, end()'s kb/s, frame count, PSNR (y, u,
    v, Avg, Global) and SSIM where measured, and the whole log
    (<line>_out_<i>, <line>_tail, <line>_kbps, _frames, _psnr, _ssim,
    _log); the B-frame line's access units as the session emitted them,
    with their pts and keyframe flags (mux_au_<i>, mux_pts, mux_key); and
    the files a CompressSession writes with each CLI case's options from
    its frames (cli_<container>);
  * decode.npz (test_torch_decode_{host,device,session}.py): the bytes of
    every stream of tests/torch_decode_streams.py (stream_<name>); per
    device-route stream, decode_frame_core's planes per picture with
    batching off (core_<name>_<i>_<plane>) and its MC route
    (core_<name>_mck), and the default decoder's frames, which batches
    them (batch_<name>_<field>, batch_<name>_gops); which slices of the
    CAVLC --8x8dct stream the device route takes (t8_taken); per
    host-route stream its planes' digests, POCs and frame_num
    (host_<name>_<field>); and DecompressSession's returns in every
    output format and scaled (sess_<case>_<call>_<array>) and on a
    B-frame stream (reorder_<call>_<array>);
  * parallel.npz (test_torch_{gop,transcode,host_entropy}.py), written
    on the JAX package's 8-device host mesh (this script sets
    --xla_force_host_platform_device_count=8 before JAX is imported when
    it writes this file): encode_clip_gop_parallel's stream (gop_stream);
    the --threads 8 sessions, sharded over the mesh, with and without
    CABAC (threads<--cabac|--no-cabac>_out_<i>, _tail) and the
    downgrade warnings of a sharded default session (downgrade_log); the
    transcode's source stream (tc_src), its output with the test's params
    and with the default ones (tc_out, tc_default_out), the MP4 it
    writes (tc_mp4), transcode_frames' output (tf_out) and the frames
    the JAX scaler hands to the encoder in each (tc_<i>_<plane>,
    tf_<i>_<plane>); and the host-entropy encoder's stream (he_stream).

  * presets.npz (test_torch_presets.py): per line of x264's last four
    presets (fast, slower, veryslow, placebo) every compress() return,
    the tail and frames_info().delay over the line's clip
    (<line>_out_<i>, <line>_tail, <line>_delay);
  * host_cabac.npz (test_torch_host_cabac.py): per configuration of
    tests/test_cabac_transcode.py the stream of the JAX encoder's
    syntax-tensor CABAC route (_transcode_ok returning False:
    <config>_stream), and the route's stream with the 8x8 transform,
    frame by frame (t8_stream), with each frame's luma reconstruction
    (t8_recon_<i>).
    JAX_PLATFORMS=cpu python tools/make_torch_jax_refs.py multiref

takes about half an hour (XLA:CPU compiles every program of the six
sessions); tools/make_torch_jax_refs.py multiref:<part> writes only the
part (units, converted or one line's session) into the file, keeping
the rest; presets:<line> likewise one preset's session (placebo's takes
the longest).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
if not sys.argv[1:] or "parallel" in sys.argv[1:]:
    # the GOP-parallel cases run on an 8-device host mesh, as the JAX
    # package's tests do (tests/conftest.py)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8"
                               ).strip()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dataclasses  # noqa: E402

import jax  # noqa: E402

import test_torch_aq_t8 as tq  # noqa: E402
import test_torch_batched_live as tbl  # noqa: E402
import test_torch_bframes as tbf  # noqa: E402
import test_torch_cavlc_pack as tcp  # noqa: E402
import test_torch_cli as tcli  # noqa: E402
import test_torch_deblock as tdb  # noqa: E402
import test_torch_encode_core as tec  # noqa: E402
import test_torch_hier as th  # noqa: E402
import test_torch_sad as tsd  # noqa: E402
import test_torch_intra4x4 as ti  # noqa: E402
import test_torch_live_presets as tl  # noqa: E402
import test_torch_memc as tmc  # noqa: E402
import test_torch_multiref as tmr  # noqa: E402
import test_torch_partitions as tp  # noqa: E402
import test_torch_gop as tg  # noqa: E402
import test_torch_host_cabac as thc  # noqa: E402
import test_torch_host_entropy as the  # noqa: E402
import test_torch_pipeline as tpl  # noqa: E402
import test_torch_presets as tpr  # noqa: E402
import test_torch_session as ts  # noqa: E402
import test_torch_telemetry as ttm  # noqa: E402
import test_torch_transform as ttf  # noqa: E402
import test_torch_transcode as ttc  # noqa: E402
import test_torch_trellis as ttr  # noqa: E402
import torch_decode_streams as tds  # noqa: E402
import torch_jax_refs as refs  # noqa: E402
from x264vfw_tpu.api import CompressSession  # noqa: E402
from x264vfw_tpu.bitstream import cavlc_jax  # noqa: E402
from x264vfw_tpu.config.options import parse_cmdline  # noqa: E402
from x264vfw_tpu.encode import device as jdev  # noqa: E402
from x264vfw_tpu.encode import device_finalize as jfin  # noqa: E402
from x264vfw_tpu.encode.device_pack import pack_slots as jpack  # noqa: E402
from x264vfw_tpu.ops import deblock as jdb  # noqa: E402
from x264vfw_tpu.ops import transform as jtj  # noqa: E402
from x264vfw_tpu.encode.tpu_encoder import TpuEncoder  # noqa: E402


def session_aus(cmdline: str, w: int, h: int, clip) -> list:
    s = CompressSession(extra_cmdline=cmdline)
    s.begin(w, h)
    out = [s.compress(f) for f in clip]
    s.end()
    return out


def p_frame(cfg, ref_planes, cur) -> dict:
    """One P frame from a loaded reference picture, as the converted-state
    tests set the JAX encoder up."""
    enc = TpuEncoder(cfg)
    enc.ref = tuple(jnp.asarray(p) for p in ref_planes)
    enc.frame_idx = enc.frame_num = enc.display_idx = 1
    enc.idr_id = 1
    au = enc.encode_frame(*cur, qp=26, force_idr=False)
    return {"p_au": np.frombuffer(au, np.uint8),
            **{f"p_ref_{k}": np.asarray(p).astype(np.uint8)
               for k, p in zip("yuv", enc.ref)}}


def put_aus(out: dict, prefix: str, aus: list) -> None:
    for i, au in enumerate(aus):
        out[f"{prefix}_{i}"] = np.frombuffer(au, np.uint8)


def live_refs(digest) -> dict:
    out = {"source_sha256": digest}
    for name, cmd in tl.LINES.items():
        s = CompressSession(extra_cmdline=cmd)
        s.begin(tl.W, tl.H)
        put_aus(out, name, [s.compress(f) for f in tl.line_clip(name)])
        out[f"{name}_tail"] = np.frombuffer(s.end()["tail"], np.uint8)

    core = jax.jit(jdev.encode_i_frame_core, static_argnames=("i4x4",))
    fin = jax.jit(jfin._finalize_i_core, static_argnums=(3, 4, 5))
    for w, h in ti.I_GEOMS:
        y, u, v, qp, qpc = ti.i_frame_case(w, h)
        res = core(*(jnp.asarray(p) for p in (y, u, v)), qp, qpc, i4x4=True)
        for k, a in res.items():
            out[f"i{w}x{h}_{k}"] = np.asarray(a)
        for t8 in (False, True):
            vals, lens = fin(res, jnp.asarray(ti.HDR_VALS, jnp.uint32),
                             jnp.asarray(ti.HDR_LENS, jnp.int32),
                             h // 16, w // 16, t8)
            out[f"i{w}x{h}_t8{int(t8)}_vals"] = np.asarray(vals)
            out[f"i{w}x{h}_t8{int(t8)}_lens"] = np.asarray(lens)

    pcore = jax.jit(jdev.encode_p_frame_core, static_argnames=(
        "rng", "subpel", "me_backend", "aq_strength", "qpc_offset",
        "decimate", "trellis", "partitions", "dct8x8"))
    lf = jax.jit(jdev.apply_loop_filter, static_argnums=(1, 2, 3, 4))
    src, ref = tq.p_case()
    for parts, qp, wp in tq.P_CORE_CASES:
        key = tq.p_core_key(parts, qp)
        res = pcore(*(jnp.asarray(a) for a in src + ref), qp, qp,
                    wp=None if wp is None else tuple(jnp.int32(x)
                                                     for x in wp),
                    partitions=parts, **tq.P_CORE_KW)
        for k, a in res.items():
            out[f"{key}_{k}"] = np.asarray(a)
        for p, a in zip("yuv", lf(res, qp, 3, 4, False)):
            out[f"{key}_lf_{p}"] = np.asarray(a)

    # converted state: the JAX session's encoder after CONVERT_AT frames
    s = CompressSession(extra_cmdline=tl.VERYFAST)
    s.begin(tl.W, tl.H)
    clip = tl.converted_state_clip()
    for f in clip[:tl.CONVERT_AT]:
        s.compress(f)
    enc = s.encoder
    assert enc._scenecut._ema is not None and enc._wp_prev is not None
    for k, val in dataclasses.asdict(enc.cfg).items():
        out[f"cs_cfg_{k}"] = np.asarray(val)
    for k, p in zip("yuv", enc.ref):
        out[f"cs_ref_{k}"] = np.asarray(p).astype(np.uint8)
    out.update(cs_frame_idx=enc.frame_idx, cs_frame_num=enc.frame_num,
               cs_idr_id=enc.idr_id, cs_poc=enc.poc,
               cs_last_idr=enc._last_idr_d, cs_wp_prev=enc._wp_prev,
               cs_scenecut_prev=enc._scenecut.prev,
               cs_scenecut_ema=enc._scenecut._ema, cs_qp=tl.CONVERT_QP)
    for i, f in enumerate(clip[tl.CONVERT_AT:]):
        (au, _, key), = enc.push_frame(*f, qp_i=tl.CONVERT_QP,
                                        qp_p=tl.CONVERT_QP)
        assert not key
        out[f"cs_au_{i}"] = np.frombuffer(au, np.uint8)
        for k, p in zip("yuv", enc.ref):
            out[f"cs_rec{i}_{k}"] = np.asarray(p).astype(np.uint8)
    return out


def l3_refs(digest) -> dict:
    """As test_torch_pipeline.py's sessions: the second session is handed
    the first one's I-frame program, so that XLA compiles it once."""
    out, i_full = {"source_sha256": digest}, None
    for rate in tpl.RATES:
        s = CompressSession(extra_cmdline=f"{tpl.L3} {rate}")
        s.begin(tpl.W, tpl.H)
        s.encoder._i_full = i_full
        key = tpl.rate_key(rate)
        put_aus(out, f"{key}_out", [s.compress(f) for f in tpl.clip()])
        out[f"{key}_tail"] = np.frombuffer(s.end()["tail"], np.uint8)
        out[f"{key}_delay"] = s.frames_info().delay
        i_full = s.encoder._i_full
    return out


def l4_refs(digest) -> dict:
    out = {"source_sha256": digest}
    put_aus(out, "session", session_aus(th.L4, th.SW, th.SH,
                                        th.session_clip()))
    return out


def core_refs(digest) -> dict:
    out = {"source_sha256": digest}
    cur, ref = tec.frame_planes()
    ji = jdev.encode_i_frame(*(jnp.asarray(p) for p in cur), tec.QP,
                             tec.QPC)
    jp = jdev.encode_p_frame(*(jnp.asarray(p) for p in cur + ref), tec.QP,
                             tec.QPC, rng=tec.R, subpel=0, me_backend="xla")
    for prefix, res in (("ei", ji), ("ep", jp)):
        for k, a in res.items():
            out[f"{prefix}_{k}"] = np.asarray(a)
    hv, hl = tec.finalize_case()
    mbh, mbw = tec.H // 16, tec.W // 16
    for ftype, fin, res in (("I", jfin.finalize_i, ji),
                            ("P", jfin.finalize_p, jp)):
        data, bits = fin(res, jnp.asarray(hv, jnp.uint32), jnp.asarray(hl),
                         mbh, mbw, 1 << 12)
        out[f"fin_{ftype}_bytes"] = np.asarray(data)[:(int(bits) + 7) // 8]
        out[f"fin_{ftype}_bits"] = int(bits)
    mc = jdev._motion_search_and_mc(*(jnp.asarray(p) for p in cur + ref),
                                    tec.R, subpel=0, me_backend="xla")
    for name, a in zip(("mv_q", "pred_y", "pred_u", "pred_v"), mc):
        out[f"mc_{name}"] = np.asarray(a)

    for mbh, mbw, offA, offB in tdb.WAVEFRONT_CASES:
        maps = jdb.build_maps(*(jnp.asarray(a) for a in tdb._metadata(
            mbh, mbw, seed=mbh * mbw)), offA, offB, 0)
        wave = jax.jit(jdb.deblock_apply_wavefront)(
            *(jnp.asarray(a) for a in tdb._planes(mbh, mbw, seed=mbw)),
            *maps)
        for p, a in zip("yuv", wave):
            out[f"dbw_{mbh}x{mbw}_{p}"] = np.asarray(a)
    lf_out = tdb._p_out(3, 4, seed=5)
    for intra in (True, False):
        res = jdev.apply_loop_filter(
            {k: jnp.asarray(a) for k, a in lf_out.items()}, tdb.LF_QP, 3, 4,
            intra, **tdb.LF_OFFSETS)
        for p, a in zip("yuv", res):
            out[f"alf_{int(intra)}_{p}"] = np.asarray(a)

    for i, shape in enumerate(tcp.PACK_SHAPES):
        vals, lens = tcp.pack_case(shape)
        data, bits = jpack(jnp.asarray(vals.astype(np.uint32)),
                           jnp.asarray(lens.astype(np.int32)),
                           (int(lens.sum()) + 31) // 32 + 4)
        out[f"pack_{i}_bytes"] = np.asarray(data)[:(int(bits) + 7) // 8]
        out[f"pack_{i}_bits"] = int(bits)
    return out


def batched_refs(digest) -> dict:
    out = {"source_sha256": digest}
    for name, cmd in tbl.LINES.items():
        s = CompressSession(extra_cmdline=cmd)
        s.begin(tbl.W, tbl.H)
        put_aus(out, f"{name}_out", [s.compress(f)
                                     for f in tbl.batched_clip()])
        out[f"{name}_tail"] = np.frombuffer(s.end()["tail"], np.uint8)
        out[f"{name}_delay"] = s.frames_info().delay

    # converted state: a per-frame B encoder after CONVERT_AT frames
    clip = tbl.batched_clip()
    s = CompressSession(extra_cmdline=tbl.CONVERT_LINE)
    s.begin(tbl.W, tbl.H)
    for f in clip[:tbl.CONVERT_AT]:
        s.compress(f)
    enc = s.encoder
    assert s.mbtree is None and enc.pending and enc.last_mv is not None
    for k, val in dataclasses.asdict(enc.cfg).items():
        out[f"cs_cfg_{k}"] = np.asarray(val)
    for k, p in zip("yuv", enc.ref):
        out[f"cs_ref_{k}"] = np.asarray(p).astype(np.uint8)
    out.update(cs_frame_idx=enc.frame_idx, cs_frame_num=enc.frame_num,
               cs_idr_id=enc.idr_id, cs_poc=enc.poc,
               cs_last_idr=enc._last_idr_d, cs_poc_base=enc.poc_base,
               cs_display_idx=enc.display_idx,
               cs_pending=np.asarray([p[3] for p in enc.pending]),
               cs_last_mv=np.asarray(enc.last_mv), cs_wp_prev=enc._wp_prev,
               cs_scenecut_prev=enc._scenecut.prev,
               cs_scenecut_ema=enc._scenecut._ema)
    qi, qp, qb = tbl.CONVERT_QPS
    got = []
    for f in clip[tbl.CONVERT_AT:tbl.CONVERT_AT + 6]:
        got += enc.push_frame(*f, qp_i=qi, qp_p=qp, qp_b=qb)
    got += enc.flush(qp_p=qp, qp_b=qb)
    put_aus(out, "cs_au", [au for au, _, _ in got])
    out["cs_order"] = np.asarray([(d, int(k)) for _, d, k in got])

    bcore = jax.jit(jdev.encode_b_frame_core, static_argnames=(
        "rng", "subpel", "me_backend", "decimate", "trellis", "want_recon",
        "dct8x8"))
    bfin = jax.jit(jfin._finalize_b_core, static_argnums=(3, 4, 5))
    for w, h in tbf.GEOMS:
        src, r0, r1, mvcol = tbf.b_case(w, h)
        for mode in tbf.B_MODES:
            me, sub, t8 = mode
            key = tbf.b_key(w, h, mode)
            res = bcore(*(jnp.asarray(p) for p in src + r0 + r1),
                        jnp.asarray(mvcol), tbf.B_QP, tbf.B_QPC,
                        rng=tbf.B_RNG, subpel=sub, me_backend=me,
                        dct8x8=t8)
            for k, a in res.items():
                out[f"{key}_{k}"] = np.asarray(a)
            for t8_mode in (False, True):
                vals, lens = bfin(res, jnp.asarray(tbf.HDR_VALS, jnp.uint32),
                                  jnp.asarray(tbf.HDR_LENS, jnp.int32),
                                  h // 16, w // 16, t8_mode)
                sk = f"{key}_slot{int(t8_mode)}"
                out[f"{sk}_vals"] = np.asarray(vals).astype(np.int64)
                out[f"{sk}_lens"] = np.asarray(lens)
                data, bits = jpack(vals, lens,
                                   (int(np.asarray(lens).sum()) + 31) // 32
                                   + 4)
                out[f"{sk}_bits"] = int(bits)
                out[f"{sk}_bytes"] = np.asarray(data)[:(int(bits) + 7) // 8]

    pcore = jax.jit(jdev.encode_p_frame_core, static_argnames=(
        "rng", "subpel", "me_backend", "aq_strength", "qpc_offset",
        "decimate", "trellis", "partitions", "dct8x8"))
    cur, ref, offs = tbf.pq_case()
    for aq, parts in tbf.QP_OFF_CASES:
        res = pcore(*(jnp.asarray(a) for a in cur + ref), 26, 26, rng=16,
                    subpel=1, me_backend="auto:hier", aq_strength=aq,
                    qp_off=jnp.asarray(offs), partitions=parts, dct8x8=True)
        for k, a in res.items():
            out[f"{tbf.pq_key(aq, parts)}_{k}"] = np.asarray(a)
    return out


def calls_refs(digest) -> dict:
    out = {"source_sha256": digest}
    for H, W, R in tsd.INTERPRET_CASES:
        for k, a in tsd.pallas_interpret(H, W, R).items():
            out[tsd.interpret_key(H, W, R) + k] = np.asarray(a)
    for rng_, subpel in th.SEARCH_CASES:
        for name, a in zip(th.SEARCH_OUT, th.jax_search(rng_, subpel)):
            out[f"hier_{rng_}_{subpel}_{name}"] = np.asarray(a)
    for qp in tp.DECIDE_QPS:
        jm, (part, mv8) = tp.jax_decide(qp)
        for k, a in jm.items():
            out[f"decide_{qp}_min_{k}"] = np.asarray(a)
        out[f"decide_{qp}_part"] = np.asarray(part)
        out[f"decide_{qp}_mv8"] = np.asarray(mv8)
    enc = jax.jit(cavlc_jax.encode_blocks, static_argnums=(2,))
    for maxc, ncs in tcp.BLOCK_CASES:
        lv, nc = tcp.blocks_case(maxc, ncs)
        vals, lens = enc(jnp.asarray(lv), jnp.asarray(nc), maxc)
        out[f"blocks_{maxc}_vals"] = np.asarray(vals).astype(np.int64)
        out[f"blocks_{maxc}_lens"] = np.asarray(lens)
    meta, t8 = tq.maps_case()
    maps = jax.jit(jdb.build_maps, static_argnums=(5, 6, 7))
    for offA, offB, cqo in tq.MAPS_OFFSETS:
        res = maps(*(jnp.asarray(a) for a in meta), offA, offB, cqo,
                   t8_4=jnp.asarray(t8))
        for i, a in enumerate(res):
            out[f"maps_{offA}_{offB}_{cqo}_{i}"] = np.asarray(a)
    return out


def multiref_session(name: str) -> dict:
    """One line of test_torch_multiref.LINES over its clip."""
    out = {}
    s = CompressSession(extra_cmdline=tmr.LINES[name])
    s.begin(tmr.W, tmr.H)
    put_aus(out, f"{name}_out", [s.compress(f) for f in tmr.multiref_clip()])
    out[f"{name}_tail"] = np.frombuffer(s.end()["tail"], np.uint8)
    out[f"{name}_delay"] = s.frames_info().delay
    return out


def multiref_converted() -> dict:
    """The per-frame encoder of tmr.CONVERT_LINE after CONVERT_AT frames,
    with a full DPB, then the frames after it at CONVERT_QP."""
    out = {}
    s = CompressSession(extra_cmdline=tmr.LINES[tmr.CONVERT_LINE])
    s.begin(tmr.W, tmr.H)
    clip = tmr.multiref_clip()
    for f in clip[:tmr.CONVERT_AT]:
        s.compress(f)
    enc = s.encoder
    assert len(enc.dpb) == 3 and enc._wp_prev is not None
    for k, val in dataclasses.asdict(enc.cfg).items():
        out[f"cs_cfg_{k}"] = np.asarray(val)
    for i, r in enumerate(enc.dpb):
        for k, p in zip("yuv", r):
            out[f"cs_dpb{i}_{k}"] = np.asarray(p).astype(np.uint8)
    assert all((np.asarray(a) == np.asarray(b)).all()
               for a, b in zip(enc.dpb[0], enc.ref))
    out.update(cs_frame_idx=enc.frame_idx, cs_frame_num=enc.frame_num,
               cs_idr_id=enc.idr_id, cs_poc=enc.poc,
               cs_last_idr=enc._last_idr_d, cs_wp_prev=enc._wp_prev,
               cs_scenecut_prev=enc._scenecut.prev,
               cs_scenecut_ema=enc._scenecut._ema)
    qp = tmr.CONVERT_QP
    for i, f in enumerate(clip[tmr.CONVERT_AT:tmr.CONVERT_AT
                               + tmr.CONVERT_N]):
        (au, _, key), = enc.push_frame(*f, qp_i=qp, qp_p=qp)
        assert not key
        out[f"cs_au_{i}"] = np.frombuffer(au, np.uint8)
        for k, p in zip("yuv", enc.ref):
            out[f"cs_rec{i}_{k}"] = np.asarray(p).astype(np.uint8)
    return out


def multiref_units() -> dict:
    """The module-level cases of test_torch_multiref.py and
    test_torch_trellis.py."""
    out = {}
    search = jax.jit(jdev._multi_ref_search_and_mc,
                     static_argnames=("rng", "subpel", "me_backend"))
    for R, me, subpel, tie in tmr.SEARCH_CASES:
        src, rf = tmr.search_case(R, tie)
        res = search(*(jnp.asarray(p) for p in src),
                     tuple(tuple(jnp.asarray(p) for p in r) for r in rf),
                     rng=tmr.SEARCH_RNG, subpel=subpel, me_backend=me)
        key = tmr.search_key(R, me, subpel, tie)
        for name, a in zip(("mv_q", "ref_idx", "pred_y", "pred_u", "pred_v"),
                           res):
            out[f"{key}_{name}"] = np.asarray(a)
    for mbh, mbw in tmr.MVP_SHAPES:
        mv, ref = tmr.mvp_case(mbh, mbw)
        pmv, skip = jfin.p16_mv_pred(jnp.asarray(mv), jnp.asarray(ref))
        out[f"mvp_{mbh}x{mbw}_pmv"] = np.asarray(pmv)
        out[f"mvp_{mbh}x{mbw}_skip"] = np.asarray(skip)

    pcore = jax.jit(jdev.encode_p_frame_core, static_argnames=(
        "rng", "subpel", "me_backend", "aq_strength", "qpc_offset",
        "decimate", "trellis", "partitions", "dct8x8"))
    maps_seen = []
    keep_maps = jdb.build_maps

    def spy_maps(*a, **k):
        res = keep_maps(*a, **k)
        maps_seen.append(res)
        return res

    n = (tmr.H // 16) * (tmr.W // 16)
    for R, wp in tmr.CORE_CASES:
        src, rf = tmr.search_case(R, seed=60)
        stack = [jnp.asarray(np.stack([r[p] for r in rf])) for p in range(3)]
        res = pcore(*(jnp.asarray(p) for p in src), *stack, tmr.CORE_QP,
                    tmr.CORE_QP,
                    wp=None if wp is None else tuple(jnp.int32(x)
                                                     for x in wp),
                    **tmr.CORE_KW)
        key = tmr.core_key(R)
        for k, a in res.items():
            out[f"{key}_out_{k}"] = np.asarray(a)
        vals, lens = jfin._finalize_p_core(
            res, jnp.asarray(tmr.HDR_VALS, jnp.uint32),
            jnp.asarray(tmr.HDR_LENS, jnp.int32), tmr.H // 16, tmr.W // 16,
            nref=R, t8_mode=True)
        out[f"{key}_fin_vals"] = np.asarray(vals).astype(np.int64)
        out[f"{key}_fin_lens"] = np.asarray(lens)
        data, bits = jpack(vals, lens,
                           (int(np.asarray(lens).sum()) + 31) // 32 + 4)
        out[f"{key}_fin_bits"] = int(bits)
        out[f"{key}_fin_bytes"] = np.asarray(data)[:(int(bits) + 7) // 8]
        out[f"{key}_col"] = np.asarray(jfin.colocated_mv(res, n))
        jdb.build_maps, maps_seen[:] = spy_maps, []
        try:
            planes = jdev.apply_loop_filter(res, tmr.CORE_QP, tmr.H // 16,
                                            tmr.W // 16, False)
        finally:
            jdb.build_maps = keep_maps
        assert len(maps_seen) == 1
        for i, m in enumerate(maps_seen[0]):
            out[f"{key}_map_{i}"] = np.asarray(m)
        for p, a in zip("yuv", planes):
            out[f"{key}_lf_{p}"] = np.asarray(a)

    # trellis: the thresholds, one QP per call and per MB
    q = jnp.arange(52, dtype=jnp.int32)
    lam = (512.0 * 0.9) * jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0)
    for i in range(52):
        one = (512.0 * 0.9) * jnp.exp2(
            (jnp.asarray(i, jnp.int32).astype(jnp.float32) - 12.0) / 3.0)
        assert np.asarray(one).view(np.int32) == np.asarray(lam)[i].view(
            np.int32), i
    out["tr_lam"] = np.asarray(lam)
    out["tr_lam4"] = np.asarray(lam * 4.0)
    out["tr_lam15"] = np.asarray(lam * 1.5)
    blocks = jnp.asarray(ttr.trellis_blocks())
    coef = jtj.fdct4x4(blocks)
    for intra in (False, True):
        rows = []
        for qp in range(52):
            c = coef[:ttr.N_SCALAR]
            rows.append(np.asarray(jdev._trellis_adjust(
                c, jtj.quant4x4(c, qp, intra=intra), qp, intra)))
        out[f"tr_scalar_{int(intra)}"] = np.stack(rows)
        qpm = q[:, None]
        out[f"tr_mb_{int(intra)}"] = np.asarray(jdev._trellis_adjust(
            coef, jtj.quant4x4(coef, qpm, intra=intra), qpm, intra))
    src, pred, qpp = (jnp.asarray(a) for a in ttr.pipeline_case())
    for t8, decimate in ttr.PIPE_CASES:
        levels, res_, flag = jdev._luma_residual_pipeline(
            src, pred, qpp, intra=False, decimate=decimate, trellis=True,
            t8=t8)
        key = f"tr_pipe_{int(t8)}{int(decimate)}"
        out[f"{key}_levels"] = np.asarray(levels)
        out[f"{key}_res"] = np.asarray(res_)
        if t8:
            out[f"{key}_t8"] = np.asarray(flag)
    return out


def units_refs(digest) -> dict:
    """The JAX side of the unit tests of test_torch_{aq_t8,transform,
    deblock,partitions,memc}.py (each file's jax_units())."""
    out = {"source_sha256": digest}
    for mod in (tq, ttf, tdb, tp, tmc):
        out.update(mod.jax_units())
    return out


def surface_refs(digest) -> dict:
    """The --psnr/--ssim sessions of test_torch_telemetry.LINES, the
    B-frame line's access units for test_torch_muxers.py, and the files
    of test_torch_cli.CLI_CASES."""
    import tempfile
    out = {"source_sha256": digest}
    for name, (cmd, _, _) in ttm.LINES.items():
        s = CompressSession(extra_cmdline=cmd)
        items = []
        emit = s._emit

        def keep(outs, *a, _emit=emit, **k):
            outs = list(outs)
            items.extend(outs)
            return _emit(outs, *a, **k)

        s._emit = keep
        outs, stats = ttm.run(s, ttm.clip(name))
        put_aus(out, f"{name}_out", outs)
        out[f"{name}_tail"] = np.frombuffer(stats["tail"], np.uint8)
        for k, v in ttm.stats_arrays(stats).items():
            out[f"{name}_{k}"] = v
        out[f"{name}_log"] = np.array([m for _, m in s.log.history])
        if name == "b":
            put_aus(out, "mux_au", [it[0] for it in items])
            out["mux_pts"] = np.array([it[1] for it in items], np.int64)
            out["mux_key"] = np.array([it[2] for it in items], bool)
    with tempfile.TemporaryDirectory() as tmp:
        for name in tcli.CLI_CASES:
            out[f"cli_{name}"] = np.frombuffer(tcli.session_file(
                CompressSession, parse_cmdline, name,
                os.path.join(tmp, f"out.{name}")), np.uint8)
    return out


def decode_refs(digest) -> dict:
    """The decoder's cases (tests/torch_decode_streams.py): every stream's
    bytes, and the JAX package's outputs on them."""
    from x264vfw_tpu.api import DecompressSession
    from x264vfw_tpu.decode import decoder as jdec
    from x264vfw_tpu.decode import device_decode as jdd
    out = {"source_sha256": digest}
    streams = tds.make_streams()
    for name, bs in streams.items():
        out[f"stream_{name}"] = np.frombuffer(bs, np.uint8)
    core, gop, syntax = (jdd.decode_frame_core, jdd.decode_gop_device,
                         jdd.parse_slice_syntax)
    try:
        for name in tds.DEVICE_STREAMS:
            # per picture (batching off): decode_frame_core's planes and
            # its MC route (mck 0: gathers, else the static-shift bucket)
            calls = []

            def rec_core(*a, **k):
                res = core(*a, **k)
                calls.append((k.get("mck", 0),
                              [np.asarray(p, np.uint8) for p in res]))
                return res

            jdd.decode_frame_core = rec_core
            dec = jdec.H264Decoder(use_device=True)
            dec._BATCH_MAX_MBS = 0
            dec.decode(streams[name])
            jdd.decode_frame_core = core
            out[f"core_{name}_mck"] = np.array([c[0] for c in calls])
            for i, (_, planes) in enumerate(calls):
                for p, a in zip("yuv", planes):
                    out[f"core_{name}_{i}_{p}"] = a
            # the default decoder: pictures batched into decode_gop_core
            sizes = []

            def rec_gop(top, parsed, *a, **k):
                sizes.append(len(parsed))
                return gop(top, parsed, *a, **k)

            jdd.decode_gop_device = rec_gop
            for k, v in tds.decode_record(jdec.H264Decoder(use_device=True),
                                          streams[name]).items():
                out[f"batch_{name}_{k}"] = v
            jdd.decode_gop_device = gop
            out[f"batch_{name}_gops"] = np.array(sizes)
        # the device route's per-slice choice on a CAVLC --8x8dct stream
        taken = []

        def rec_syntax(*a, **k):
            res = syntax(*a, **k)
            taken.append(res is not None)
            return res

        jdd.parse_slice_syntax = rec_syntax
        dec = jdec.H264Decoder(use_device=True)
        dec._BATCH_MAX_MBS = 0
        dec.decode(streams["x264_8x8"])
        out["t8_taken"] = np.array(taken)
    finally:
        jdd.decode_frame_core, jdd.decode_gop_device = core, gop
        jdd.parse_slice_syntax = syntax
    for name in tds.HOST_STREAMS:
        for k, v in tds.decode_record(jdec.H264Decoder(), streams[name],
                                      meta=False).items():
            out[f"host_{name}_{k}"] = (np.asarray(refs.digest(v))
                                       if k in "yuv" else v)
    # DecompressSession: every output format, the scaler, display order
    aus = tds.split_aus(streams[tds.SESSION_STREAM])
    cases = {fmt: {"fmt": fmt} for fmt in DecompressSession.OUTPUT_FORMATS}
    cases.update({f"scale{w}x{h}": {"out_width": w, "out_height": h}
                  for w, h in tds.SCALES})
    for case, kw in cases.items():
        for i, o in enumerate(tds.run_session(DecompressSession(), aus,
                                              **kw)):
            for j, a in enumerate(o):
                out[f"sess_{case}_{i}_{j}"] = np.asarray(a, np.uint8)
    aus = tds.split_aus(streams[tds.REORDER_STREAM])
    for i, o in enumerate(tds.run_session(DecompressSession(), aus)):
        for j, a in enumerate(o):
            out[f"reorder_{i}_{j}"] = np.asarray(a, np.uint8)
    return out


def parallel_refs(digest) -> dict:
    """The GOP-parallel encode and session, the transcode and the
    host-entropy encoder on their tests' inputs (parallel.npz)."""
    import tempfile
    from x264vfw_tpu.config.params import EncoderParams as JParams
    from x264vfw_tpu.decode.decoder import H264Decoder as JDecoder
    from x264vfw_tpu.encode.ref_encoder import EncoderConfig as JConfig
    from x264vfw_tpu.ops.scale import scale_i420 as jscale
    from x264vfw_tpu.parallel import gop as jgop
    from x264vfw_tpu.parallel import transcode as jtc
    assert jax.device_count() == tg.MESH, jax.devices()

    def arr(b: bytes):
        return np.frombuffer(b, np.uint8)

    out = {"source_sha256": digest}
    out["gop_stream"] = arr(jgop.encode_clip_gop_parallel(
        tg.gop_frames(), JConfig(**tg.GOP_CFG)))
    for cabac in tg.CABAC:
        s = CompressSession(JParams(), extra_cmdline=f"{tg.THREADS_CMD} "
                                                      f"--threads 8 {cabac}")
        outs, tail = tg.run_session(s)
        assert s._shard
        put_aus(out, f"threads{cabac}_out", outs)
        out[f"threads{cabac}_tail"] = arr(tail)
    s = CompressSession(JParams(), extra_cmdline=tg.DOWNGRADE_CMD)
    msgs = []
    s.log.sink = lambda lvl, m: msgs.append(m)
    s.begin(tg.W, tg.H)
    out["downgrade_log"] = np.array(msgs)
    # the transcode: its source, its outputs, the scaled frames
    s = CompressSession(ttc.src_params())
    s.begin(ttc.W, ttc.H)
    src = b"".join(s.compress(f) for f in ttc.clip_frames()) + \
        s.end()["tail"]
    out["tc_src"] = arr(src)
    with tempfile.TemporaryDirectory() as tmp:
        mp4 = os.path.join(tmp, "out.mp4")
        out["tc_out"] = arr(jtc.transcode(src, *ttc.DST, ttc.out_params(),
                                          output=mp4))
        with open(mp4, "rb") as fh:
            out["tc_mp4"] = arr(fh.read())
    out["tc_default_out"] = arr(jtc.transcode(src, *ttc.DST))
    out["tf_out"] = arr(jtc.transcode_frames(ttc.clip_frames(), *ttc.DST,
                                             ttc.out_params()))
    dec = JDecoder()
    dec.decode(src)
    for prefix, frames in (("tc", [(f.y, f.u, f.v)
                                   for f in dec.display_order()]),
                           ("tf", ttc.clip_frames())):
        for i, planes in enumerate(frames):
            for p, a in zip("yuv", jscale(*planes, *ttc.DST)):
                out[f"{prefix}_{i}_{p}"] = np.asarray(a, np.uint8)
    enc = TpuEncoder(JConfig(**the.HE_CFG))
    enc.host_entropy = True
    out["he_stream"] = arr(b"".join(enc.encode_frame(*f)
                                    for f in the.he_frames()))
    return out


def preset_session(name: str) -> dict:
    """One line of test_torch_presets.LINES over its clip."""
    out = {}
    s = CompressSession(extra_cmdline=tpr.LINES[name])
    s.begin(tpr.W, tpr.H)
    put_aus(out, f"{name}_out", [s.compress(f) for f in tpr.clip(name)])
    out[f"{name}_tail"] = np.frombuffer(s.end()["tail"], np.uint8)
    out[f"{name}_delay"] = s.frames_info().delay
    return out


def host_cabac_refs(digest) -> dict:
    """The JAX encoder's syntax-tensor CABAC route on test_torch_host_
    cabac.py's configurations (test_cabac_transcode.py's old path)."""
    from x264vfw_tpu.encode.ref_encoder import EncoderConfig as JConfig
    out = {"source_sha256": digest}
    for name, kw in thc.CONFIGS.items():
        enc = TpuEncoder(JConfig(width=thc.SIZE, height=thc.SIZE, cabac=True,
                                 **kw))
        enc._transcode_ok = lambda: False
        out[f"{name}_stream"] = np.frombuffer(thc.encode_stream(enc),
                                              np.uint8)
    # the route with the 8x8 transform, frame by frame, and each frame's
    # luma reconstruction
    enc = TpuEncoder(JConfig(width=thc.SIZE, height=thc.SIZE, cabac=True,
                             **thc.T8_CFG))
    enc._transcode_ok = lambda: False
    bs = enc.headers()
    for i, f in enumerate(thc.clip()):
        bs += enc.encode_frame(*f)
        out[f"t8_recon_{i}"] = np.asarray(enc.last_recon[0], np.uint8)
    out["t8_stream"] = np.frombuffer(bs, np.uint8)
    return out


PRESET_PARTS = {name: (lambda name=name: preset_session(name))
                for name in tpr.LINES}


def presets_refs(digest) -> dict:
    out = {"source_sha256": digest}
    for make in PRESET_PARTS.values():
        out.update(make())
    return out


MULTIREF_PARTS = {"units": multiref_units, "converted": multiref_converted,
                  **{name: (lambda name=name: multiref_session(name))
                     for name in tmr.LINES}}


def multiref_refs(digest) -> dict:
    out = {"source_sha256": digest}
    for make in MULTIREF_PARTS.values():
        out.update(make())
    return out


MAKERS = {"live": live_refs, "l3": l3_refs, "l4": l4_refs,
          "core": core_refs, "batched": batched_refs, "calls": calls_refs,
          "multiref": multiref_refs, "units": units_refs,
          "surface": surface_refs, "decode": decode_refs,
          "parallel": parallel_refs, "presets": presets_refs,
          "host_cabac": host_cabac_refs}
PARTS = {"multiref": MULTIREF_PARTS, "presets": PRESET_PARTS}


def main() -> int:
    digest = np.asarray(refs.source_hash())
    os.makedirs(refs.REF_DIR, exist_ok=True)
    only = sys.argv[1:]
    parts = [a.split(":", 1) for a in only if ":" in a]
    if parts:
        names = {name for name, _ in parts}
        unknown = {f"{n}:{p}" for n, p in parts
                   if p not in PARTS.get(n, {})}
        if unknown or len(names) != 1 or len(parts) != len(only):
            raise SystemExit(f"unknown parts, or parts of several files: "
                             f"{sorted(unknown or only)}")
        name, = names
        path = refs.path(name)
        out = refs.load(name) if os.path.exists(path) else {}
        out["source_sha256"] = digest
        for _, part in parts:
            out.update(PARTS[name][part]())
        np.savez_compressed(path, **out)
        print(path, os.path.getsize(path), "bytes")
        return 0
    unknown = set(only) - set(MAKERS)
    if unknown:
        raise SystemExit(f"unknown reference files: {sorted(unknown)}")
    if only:
        for name in only:
            np.savez_compressed(refs.path(name), **MAKERS[name](digest))
            print(refs.path(name), os.path.getsize(refs.path(name)), "bytes")
        return 0

    s1 = {"source_sha256": digest}
    for w, h in ts.GEOMS:
        put_aus(s1, f"{w}x{h}", session_aus(
            ts.CMDLINE, w, h, ts.moving_clip(w, h, 3, seed=w)))
    s1.update(p_frame(*ts.converted_state_case()))
    np.savez_compressed(refs.path("slice1"), **s1)

    s2 = {"source_sha256": digest}
    for key, cmd in (("session", tp.CMDLINE),
                     ("session_hier", tp.CMDLINE_HIER)):
        put_aus(s2, key, session_aus(cmd, 64, 48,
                                     ts.moving_clip(64, 48, 3, seed=64)))
    s2.update(p_frame(*tp.converted_state_case()))
    np.savez_compressed(refs.path("slice2"), **s2)
    for name, make in MAKERS.items():
        np.savez_compressed(refs.path(name), **make(digest))
    for name in refs.NAMES:
        print(refs.path(name), os.path.getsize(refs.path(name)), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
