"""x264's file/VOD lines with B frames, the port against the JAX package:
--preset veryfast --crf 23 (B frames, MB-tree, CABAC, I4x4, the 8x8
transform, AQ, weighted P, scene cuts, P partitions at half pel, the loop
filter) and --preset superfast --crf 23 (the same without MB-tree and P
partitions), both on the batched session (default --threads), and the
veryfast line with --threads 1 on the per-frame B scheduler.  Each line
adds --min-keyint 2 so that the clip's scene cut (frame CUT_AT, inside
the second window) becomes an IDR, which drains the B candidates pending
before it as a tail (a P anchor and a B frame).  The clip fades from
FADE_FROM on (weighted P on the per-frame path), and 30 frames at 64x48
give mini-GOPs that cross the first window's end and a flush whose tail
ends with a promoted P and a B frame.

Every compress() return, end()["tail"] and frames_info().delay equal the
JAX session's, from tests/jax_refs/batched.npz (tools/
make_torch_jax_refs.py, hash-guarded by test_torch_session.py::
test_jax_references_are_current), with one departure from a fault of the
JAX package (ROADMAP.md, section C), which this file pins to the bit: a
JAX batched P frame's slice header carries the weight table of the last
frame encoded per frame (here the tail P before the scene cut), while
the batched program predicts it without weights, so its stream does not
decode to its own reconstruction.  The port's batched P headers carry no
table; every other bit is the JAX package's.  Stock FFmpeg decodes each
whole port stream: I and P frames to the port's own reconstruction, B
frames on the batched lines above 30 dB against the source.  MB-tree's
offsets equal the JAX package's MBTree (numpy, run live), and the port's
B transcodes equal the JAX transcoder's on the same CAVLC slices.  A JAX
per-frame B encoder converted mid-stream, with frames pending, goes on
byte-identical in the port.  Inputs come from numpy seeds; no tolerance.
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu.bitstream import cabac_transcode as jct
from x264vfw_tpu.encode.lookahead import MBTree as JaxMBTree
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream import cabac_transcode as tct
from x264vfw_tpu_torch.bitstream.nal import split_annexb, wrap_nal
from x264vfw_tpu_torch.convert import config_from_jax_fields, state_from_numpy
from x264vfw_tpu_torch.bitstream.mb_syntax import SLICE_P
from x264vfw_tpu_torch.bitstream.slice import SliceHeader
from x264vfw_tpu_torch.encode import device_finalize as dfin
from x264vfw_tpu_torch.encode import lookahead
from x264vfw_tpu_torch.encode import pipeline as tpipe
from x264vfw_tpu_torch.encode import torch_encoder as tenc
from x264vfw_tpu_torch.utils.bitstream import BitReader

W, H, NFR = 64, 48, 30
CUT_AT = 19              # the first frame of scene two
FADE_FROM, FADE = 24, 0.03   # luma gain 1 - FADE * (i - FADE_FROM + 1)
LINES = {"veryfast": "--preset veryfast --crf 23 --min-keyint 2",
         "superfast": "--preset superfast --crf 23 --min-keyint 2",
         "veryfast_t1": "--preset veryfast --crf 23 --min-keyint 2 "
                        "--threads 1"}
# the converted-state case: a per-frame B encoder (bframes 3, no MB-tree)
# converted after CONVERT_AT frames, when frames CONVERT_AT - 2 and - 1
# wait for their anchor
CONVERT_LINE = "--preset veryfast --crf 23 --threads 1 --no-mbtree"
CONVERT_AT = 7
CONVERT_QPS = (24, 26, 28)     # qp_i, qp_p, qp_b of the frames after it


def batched_clip(frames=NFR):
    """Textured I420 frames moving by (3, -2) pixels per frame, the
    texture at 1/8 contrast in the second MB row (AQ's case); from CUT_AT
    on another texture at half contrast, brighter and moving by (-2, 1)
    (a scene cut); from FADE_FROM on a luma fade of FADE per frame (which
    the scene-cut detector does not take for a cut)."""
    one = moving_clip(W, H, frames, seed=41, shift=(3, -2))
    two = [(y // 2 + 100, u, v)
           for y, u, v in moving_clip(W, H, frames, seed=42, shift=(-2, 1))]
    out = []
    for i, (y, u, v) in enumerate(one[:CUT_AT] + two[CUT_AT:]):
        y = y.copy()
        y[16:32] = 128 + (y[16:32].astype(np.int32) - 128) // 8
        if i >= FADE_FROM:
            y = (y.astype(np.float32) * (1.0 - FADE * (i - FADE_FROM + 1))) \
                .astype(np.uint8)
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("batched")


def spied_session(cmd: str, clip: list, w: int = W, h: int = H) -> dict:
    """A port session on the CPU over clip, with: the compress() returns,
    tail, end()'s kb/s, the rate controller and its (type, QP, bits)
    per frame, and delay; every (display index, frame type) in decode order;
    the I and P frames' reference planes in decode order, and each P
    frame's ref_idx field (None with one reference); the CAVLC B slices
    handed to the transcoder and what it returned; the weights of each P
    frame encoded per frame ({display index: (w, o) or None}); and for
    each P slice header written in a batch, the one the JAX package
    writes there (with the weights of the last P frame encoded per frame)
    beside the port's ({display index: (JAX, port)}, each as the
    transcoder's aligned header bytes), and the batch's active reference
    count ({display index: _cur_nref})."""
    keep_ref, keep_tc = dfin._maybe_deblock, tct.transcode_slice
    keep_emit = CompressSession._emit
    keep_enc = tenc.TorchEncoder.encode_frame
    keep_hdr = tenc.TorchEncoder._slice_header_codes
    keep_pb = tpipe.BatchPipeline._p_batch
    rec = {"recon": [], "ref_idx": [], "order": [], "b_slices": [],
           "wps": {}, "last_wp": None, "batch_hdr": {}, "batch_nref": {},
           "in_batch": False, "in_frame": False}

    def spy_ref(out, *a, **k):
        planes = keep_ref(out, *a, **k)
        rec["recon"].append(planes[0][:h, :w].numpy().copy())
        if "levels" in out:
            rec["ref_idx"].append(out.get("ref_idx"))
        return planes

    def spy_tc(payload, hdr_bits, slice_type, *a, **k):
        body = keep_tc(payload, hdr_bits, slice_type, *a, **k)
        if slice_type == "B":
            rec["b_slices"].append((np.array(payload), hdr_bits, a, k, body))
        return body

    def spy_emit(self, outs, *a, **k):
        rec["order"] += [(it[1], it[3]) for it in outs]
        return keep_emit(self, outs, *a, **k)

    def spy_enc(self, *a, **k):
        rec["in_frame"] = True
        try:
            au = keep_enc(self, *a, **k)
        finally:
            rec["in_frame"] = False
        if not k.get("force_idr"):
            rec["wps"][self.poc // 2 + self.poc_base] = self._wp
            rec["last_wp"] = self._wp
        return au

    def spy_hdr(self, slice_type, *a, **k):
        if rec["in_batch"] and not rec["in_frame"] and slice_type == SLICE_P:
            port, stale = self._wp, rec["last_wp"]
            self._wp = stale
            want = keep_hdr(self, slice_type, *a, **k)
            self._wp = port
            d = self.poc // 2 + self.poc_base
            rec["batch_hdr"][d] = tuple(
                tct._header_bytes(hw.to_rbsp(), hw.bit_position)
                for hw in (want, keep_hdr(self, slice_type, *a, **k)))
            rec["batch_nref"][d] = self._cur_nref
        return keep_hdr(self, slice_type, *a, **k)

    def spy_pb(self, *a, **k):
        rec["in_batch"] = True
        try:
            return keep_pb(self, *a, **k)
        finally:
            rec["in_batch"] = False

    dfin._maybe_deblock, tct.transcode_slice = spy_ref, spy_tc
    CompressSession._emit = spy_emit
    tenc.TorchEncoder.encode_frame = spy_enc
    tenc.TorchEncoder._slice_header_codes = spy_hdr
    tpipe.BatchPipeline._p_batch = spy_pb
    try:
        s = CompressSession(extra_cmdline=cmd, device="cpu")
        s.begin(w, h)
        outs = [s.compress(f) for f in clip]
        end = s.end()
        rec.update(outs=outs, tail=end["tail"], kbps=end["kbps"],
                   rc=s.rc, rc_stats=[(st.frame_type, st.qp, st.bits)
                                      for st in s.rc.stats],
                   delay=s.frames_info().delay, cfg=s.encoder.cfg,
                   enc=s.encoder, batched=s._pipe is not None)
    finally:
        dfin._maybe_deblock, tct.transcode_slice = keep_ref, keep_tc
        CompressSession._emit = keep_emit
        tenc.TorchEncoder.encode_frame = keep_enc
        tenc.TorchEncoder._slice_header_codes = keep_hdr
        tpipe.BatchPipeline._p_batch = keep_pb
    return rec


@pytest.fixture(scope="module")
def port_runs():
    """Each line's spied_session over batched_clip()."""
    return {name: spied_session(cmd, batched_clip())
            for name, cmd in LINES.items()}


def departures(run) -> dict:
    """{display index: (the JAX header, the port's)} of the batched P
    slices whose JAX header carries a (stale) weight table."""
    return {d: h for d, h in run["batch_hdr"].items() if h[0] != h[1]}


def with_departures(chunks: list, run) -> list:
    """The JAX session's byte chunks with the departure applied: in the
    slice of each frame of departures(run), the JAX header must lead the
    RBSP, and the port's header takes its place; every other byte stays
    the JAX package's."""
    order, dep = run["order"], departures(run)
    out, k = [], 0
    for c in chunks:
        for u in split_annexb(c):
            if u.nal_unit_type not in (1, 5):
                continue
            d = order[k][0]
            k += 1
            if d in dep:
                jax_h, port_h = dep[d]
                rbsp = u.rbsp.tobytes()
                assert rbsp.startswith(jax_h), d
                old = wrap_nal(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
                new = wrap_nal(u.nal_ref_idc, u.nal_unit_type, np.frombuffer(
                    port_h + rbsp[len(jax_h):], np.uint8))
                assert c.count(old) == 1, d
                c = c.replace(old, new)
        out.append(c)
    assert k == len(order)
    return out


@pytest.mark.parametrize("name", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, name):
    """Bit for bit the JAX session's, but for the departure that
    test_stale_weight_tables_pinned pins."""
    run = port_runs[name]
    want = with_departures(torch_jax_refs.aus(refs, f"{name}_out")
                           + [refs[f"{name}_tail"].tobytes()], run)
    assert len(want) - 1 == len(run["outs"]) == NFR
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{name}: compress() {i} differs"
    assert run["tail"] == want[-1]
    assert run["delay"] == int(refs[f"{name}_delay"])


def test_sessions_take_their_paths(port_runs):
    """Batched by default, per frame with --threads 1; the delay is the B
    frames + MB-tree's lookahead + the two windows."""
    want = {"veryfast": (True, 3 + 10 + 23, 10),
            "superfast": (True, 3 + 23, 0),
            "veryfast_t1": (False, 3 + 10, 10)}
    for name, run in port_runs.items():
        cfg = run["cfg"]
        assert (run["batched"], run["delay"]) == want[name][:2], name
        assert (cfg.bframes, cfg.cabac, cfg.i4x4, cfg.dct8x8,
                cfg.aq_strength > 0, cfg.weightp, cfg.scenecut) == \
            (3, True, True, True, True, 1, 40), name
        assert cfg.partitions == (name != "superfast")
        assert cfg.subpel == 1 and cfg.me_backend == "auto:hier"


@pytest.mark.parametrize("name", list(LINES))
def test_stream_decodes(port_runs, name):
    """Stock FFmpeg decodes the whole stream (display order): the I and P
    frames to the reference planes the encoder kept, and on the batched
    lines the B frames above 30 dB.  (The per-frame line's anchors carry
    the weights of the JAX package's analysis against the anchor before,
    which on this moving texture cost quality: its B frames are decoded
    but held to no PSNR bar.)"""
    run = port_runs[name]
    clip = batched_clip()
    decoded = oracle.decode_h264(b"".join(run["outs"]) + run["tail"])
    assert decoded is not None and len(decoded) == NFR
    order = run["order"]
    assert sorted(d for d, _ in order) == list(range(NFR))
    anchors = [d for d, t in order if t != "B"]
    assert len(anchors) == len(run["recon"])
    recon = dict(zip(anchors, run["recon"]))
    for d, t in order:
        y = decoded[d][:W * H].reshape(H, W)
        if t != "B":
            np.testing.assert_array_equal(y, recon[d],
                                          err_msg=f"{name} frame {d} ({t})")
        elif run["batched"]:
            assert oracle.psnr(y, clip[d][0]) > 30.0, (name, d)


def p_weight_tables(stream: bytes, run) -> dict:
    """{display index: the luma weight table its P slice header signals}
    of a session's stream."""
    enc = run["enc"]
    order = [d for d, _ in run["order"]]
    vcl = [u for u in split_annexb(stream) if u.nal_unit_type in (1, 5)]
    assert len(vcl) == len(order)
    out = {}
    for d, u in zip(order, vcl):
        h = SliceHeader.parse(BitReader(u.rbsp), enc.sps, enc.pps,
                              u.nal_unit_type, u.nal_ref_idc)
        if h.is_p():
            out[d] = h.luma_weights_l0
    return out


def test_stale_weight_tables_pinned(refs, port_runs):
    """The JAX package's fault the port departs from, read from both
    streams' slice headers: on the batched lines the tail P before the
    scene cut (frame CUT_AT - 1, encoded per frame) gets weights from its
    analysis against the window's post-cut frame, and the JAX package
    writes that table into the headers of the batched P frames after the
    cut (23 and 27), which are predicted without weights.  The port's
    headers signal each P frame's own weights, none on a batched one;
    with_departures checks that nothing else differs.  The per-frame
    line writes no batched header."""
    for name in ("veryfast", "superfast"):
        run = port_runs[name]
        tail_wp = run["wps"][CUT_AT - 1]
        assert tail_wp is not None
        assert sorted(departures(run)) == [23, 27], name
        port = p_weight_tables(b"".join(run["outs"]) + run["tail"], run)
        jax_ = p_weight_tables(
            b"".join(torch_jax_refs.aus(refs, f"{name}_out"))
            + refs[f"{name}_tail"].tobytes(), run)
        assert port == {d: [run["wps"].get(d)] for d in port}, name
        assert jax_ == {d: [tail_wp] if d in (23, 27) else w
                        for d, w in port.items()}, name
    assert port_runs["veryfast_t1"]["batch_hdr"] == {}


def test_clips_reach_every_feature(port_runs):
    """Decode order as the scheduler makes it: the scene cut an IDR after
    the drained tail (P CUT_AT - 1, then B CUT_AT - 2), the flush a
    promoted P and a B frame, mini-GOPs of three B frames; B slices went
    through the CABAC transcoder; weighted P frames on the per-frame
    path."""
    for name, run in port_runs.items():
        order = run["order"]
        types = "".join(t for _, t in order)
        assert types.count("I") == 2 and types.count("B") >= 18, (name, types)
        cut = order.index((CUT_AT, "I"))
        assert order[cut - 2:cut] == [(CUT_AT - 1, "P"), (CUT_AT - 2, "B")]
        assert order[-2:] == [(NFR - 1, "P"), (NFR - 2, "B")], (name, order)
        assert "PBBB" in types
        assert len(run["b_slices"]) == types.count("B")
        vcl = [u.nal_unit_type for u in split_annexb(
            b"".join(run["outs"]) + run["tail"]) if u.nal_unit_type in (1, 5)]
        assert vcl.count(5) == 2
    assert any(w is not None
               for w in port_runs["veryfast_t1"]["wps"].values())


def test_b_transcode_equals_jax(port_runs):
    """The JAX transcoder re-codes the port's CAVLC B slices to the same
    CABAC bytes as the port's transcoder."""
    n = 0
    for name, run in port_runs.items():
        for payload, hdr_bits, a, k, body in run["b_slices"]:
            assert jct.transcode_slice(payload, hdr_bits, "B", *a, **k) \
                == body, name
            n += 1
    assert n >= 50


def test_mbtree_offsets_equal_jax():
    """The port's MBTree (a copy) gives the JAX MBTree's offsets, frame for
    frame, on this clip and on a 1-MB-wide crop of it; the clip's
    offsets are not all zero."""
    for w in (W, 16):
        clip = [(y[:, :w], u[:, :w // 2], v[:, :w // 2])
                for y, u, v in batched_clip()]
        port = lookahead.MBTree((w + 15) // 16, (H + 15) // 16,
                                lookahead=10, qcomp=0.6)
        jax_ = JaxMBTree((w + 15) // 16, (H + 15) // 16, lookahead=10,
                         qcomp=0.6)
        got, want = [], []
        for f in clip:
            got += [o for _, o in port.push(f, f[0])]
            want += [o for _, o in jax_.push(f, f[0])]
        got += [o for _, o in port.flush()]
        want += [o for _, o in jax_.flush()]
        assert len(got) == len(want) == NFR
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype
            np.testing.assert_array_equal(g, wnt)
        assert min(int(o.min()) for o in got) < 0


def test_b_frames_from_converted_state(refs):
    """A JAX per-frame B encoder converted after CONVERT_AT frames, with
    two frames pending (DPB, counters, POC base, last anchor's colocated
    field, weight-analysis and scene-cut state), and the port go on with
    the same bytes, flush included."""
    cfg = config_from_jax_fields({k[len("cs_cfg_"):]: refs[k].item()
                                  for k in refs if k.startswith("cs_cfg_")})
    assert cfg.bframes == 3
    enc = tenc.TorchEncoder(cfg, device="cpu")
    clip = batched_clip()
    pend = [int(d) for d in refs["cs_pending"]]
    assert pend == [CONVERT_AT - 2, CONVERT_AT - 1]
    st = {k: int(refs[f"cs_{k}"]) for k in ("frame_idx", "frame_num",
                                            "idr_id", "poc", "last_idr",
                                            "poc_base", "display_idx")}
    enc.load_state(state_from_numpy(
        *(refs[f"cs_ref_{k}"] for k in "yuv"), **st,
        wp_prev=refs["cs_wp_prev"],
        scenecut_prev=refs["cs_scenecut_prev"],
        scenecut_ema=float(refs["cs_scenecut_ema"]),
        pending=[(*clip[d], d) for d in pend], last_mv=refs["cs_last_mv"],
        device="cpu"))
    qi, qp, qb = CONVERT_QPS
    got = []
    for frame in clip[CONVERT_AT:CONVERT_AT + 6]:
        got += enc.push_frame(*frame, qp_i=qi, qp_p=qp, qp_b=qb)
    got += enc.flush(qp_p=qp, qp_b=qb)
    want = torch_jax_refs.aus(refs, "cs_au")
    assert [(d, int(t == "I")) for _, d, t in got] == \
        [tuple(x) for x in refs["cs_order"].tolist()]
    assert len(got) == len(want) == 6 + len(pend)
    for i, ((au, d, _), w) in enumerate(zip(got, want)):
        assert au == w, f"AU {i} (display {d}) differs"
