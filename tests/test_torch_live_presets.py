"""x264's live-streaming lines on the per-frame path, the port against the
JAX package: --preset veryfast --tune zerolatency --crf 23 (CABAC, I4x4,
the 8x8 transform, AQ, weighted P prediction, scene cuts, P partitions
with half-pel refinement, the loop filter), --preset superfast --tune
zerolatency --crf 23 (the same without P partitions, with the
hierarchical 16x16 search) and the veryfast line with --min-keyint 2 on a
clip with a scene cut.  At 64x48: every compress() return and end()'s
tail equal the JAX session's bytes, from the committed outputs in
tests/jax_refs/live.npz (tools/make_torch_jax_refs.py, hash-guarded by
test_torch_session.py::test_jax_references_are_current).  Stock FFmpeg
decodes the port's High/CABAC streams to the port's own reconstruction;
the clips reach I_NxN, the 8x8 transform, per-MB QP deltas, weighted P
frames and the scene-cut IDR, and the host CABAC transcode never rejects
a slice.  A JAX encoder converted mid-stream (DPB, counters,
weight-analysis and scene-cut state) goes on byte-identical in the port.
Inputs come from numpy seeds; no tolerance.
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream.nal import split_annexb
from x264vfw_tpu_torch.convert import config_from_jax_fields, state_from_numpy
from x264vfw_tpu_torch.encode import device_finalize as dfin
from x264vfw_tpu_torch.encode import torch_encoder as tenc

W, H, NFR = 64, 48, 8
VERYFAST = "--preset veryfast --tune zerolatency --crf 23"
LINES = {"veryfast": VERYFAST,
         "superfast": "--preset superfast --tune zerolatency --crf 23",
         "scenecut": VERYFAST + " --min-keyint 2"}
CUT_AT = 4               # the scene-cut clip's first frame of scene two
CONVERT_AT = 5           # frames the JAX encoder codes before conversion
CONVERT_QP = 26          # the QP of the frames coded after it


def live_clip(w, h, frames, seed, cut_at=None, fade_from=4):
    """Textured I420 frames moving by (3, -2) pixels per frame, the
    texture at 1/8 contrast in the second MB row (MBs of low activity,
    AQ's case); from cut_at on, another texture at half contrast and a
    brighter mean (a scene cut); from
    fade_from on, the luma fades by 10% of full scale per frame (weighted
    prediction's case)."""
    clip = moving_clip(w, h, frames, seed=seed, shift=(3, -2))
    if cut_at is not None:
        other = [(y // 2 + 110, u, v) for y, u, v in
                 moving_clip(w, h, frames, seed=seed + 100, shift=(-2, 1))]
        clip = clip[:cut_at] + other[cut_at:]
    out = []
    for i, (y, u, v) in enumerate(clip):
        y = y.copy()
        y[16:32] = 128 + (y[16:32].astype(np.int32) - 128) // 8
        if fade_from is not None and i >= fade_from:
            y = (y.astype(np.float32) * (1.0 - 0.1 * (i - fade_from + 1))) \
                .astype(np.uint8)
        out.append((y, u, v))
    return out


def line_clip(name):
    """The fade clip, or for the scene-cut line the clip with a cut (and
    no fade, whose steps the detector would also cut on)."""
    if name == "scenecut":
        return live_clip(W, H, NFR, seed=21, cut_at=CUT_AT, fade_from=None)
    return live_clip(W, H, NFR, seed=21)


def converted_state_clip():
    return live_clip(W, H, CONVERT_AT + 2, seed=23)


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("live")


@pytest.fixture(scope="module")
def port_runs():
    """Each line's port session on the CPU: the compress() returns, the
    tail, and per frame the reference planes kept, the syntax tensors of P
    frames, the weights used and the transcodes made."""
    runs = {}
    keep_ref, keep_p = dfin._maybe_deblock, dfin.encode_p_slots
    transcode = tenc.TorchEncoder._transcode
    for name, cmd in LINES.items():
        rec = {"recon": [], "p_out": [], "i4": [], "transcodes": 0}

        def spy_ref(out, *a, **k):
            planes = keep_ref(out, *a, **k)
            rec["recon"].append(planes[0].numpy().copy())
            if "use_i4" in out:
                rec["i4"].append(int(out["use_i4"].sum()))
            return planes

        def spy_p(*a, **k):
            res = keep_p(*a, **k)
            rec["p_out"].append(res[-1])
            return res

        def spy_tc(self, *a, **k):
            rec["transcodes"] += 1
            return transcode(self, *a, **k)

        dfin._maybe_deblock, dfin.encode_p_slots = spy_ref, spy_p
        tenc.TorchEncoder._transcode = spy_tc
        try:
            s = CompressSession(extra_cmdline=cmd, device="cpu")
            s.begin(W, H)
            wps = []
            outs = []
            for f in line_clip(name):
                outs.append(s.compress(f))
                wps.append(s.encoder._wp)
            rec.update(outs=outs, tail=s.end()["tail"], wps=wps,
                       cfg=s.encoder.cfg, sps=s.encoder.sps,
                       pps=s.encoder.pps)
        finally:
            dfin._maybe_deblock, dfin.encode_p_slots = keep_ref, keep_p
            tenc.TorchEncoder._transcode = transcode
        runs[name] = rec
    return runs


@pytest.mark.parametrize("name", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, name):
    run = port_runs[name]
    want = torch_jax_refs.aus(refs, name)
    assert len(want) == len(run["outs"]) == NFR
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{name}: compress() {i} differs"
    assert run["tail"] == refs[f"{name}_tail"].tobytes() == b""


@pytest.mark.parametrize("name", list(LINES))
def test_stream_decodes_to_reconstruction(port_runs, name):
    """Stock FFmpeg decodes the port's stream to the reference planes the
    encoder kept, frame by frame."""
    run = port_runs[name]
    decoded = oracle.decode_h264(b"".join(run["outs"]))
    assert decoded is not None and len(decoded) == NFR == len(run["recon"])
    for i, (d, r) in enumerate(zip(decoded, run["recon"])):
        np.testing.assert_array_equal(d[:W * H].reshape(H, W), r,
                                      err_msg=f"{name} frame {i}")


def test_options_reach_the_encoder(port_runs):
    for name, run in port_runs.items():
        cfg = run["cfg"]
        assert (cfg.cabac, cfg.i4x4, cfg.dct8x8, cfg.aq_strength,
                cfg.weightp, cfg.scenecut, cfg.deblock) == \
            (True, True, True, 1.0, 1, 40, True), name
        assert cfg.partitions == (name != "superfast")
        assert cfg.subpel == 1 and cfg.trellis is False
        assert (run["sps"].profile_idc, run["sps"].constraint_set0) == \
            (100, 0)
        assert (run["pps"].entropy_coding_mode_flag,
                run["pps"].weighted_pred_flag,
                run["pps"].transform_8x8_mode_flag) == (1, 1, 1)


def test_clips_reach_every_feature(port_runs):
    """The transcoder took every slice (the encoder raises on a
    rejection), and the clips hold I_NxN MBs, 8x8-transformed MBs,
    per-MB QP deltas, weighted P frames (with the fade) and the
    scene-cut IDR."""
    for name, run in port_runs.items():
        assert run["transcodes"] == NFR, name
        assert run["i4"][0] > 0, (name, run["i4"])
        assert sum(int(o["t8"].sum()) for o in run["p_out"]) > 0, name
        assert any(bool((o["qp_delta"] != 0).any()) for o in run["p_out"])
        if name != "scenecut":
            assert run["wps"][-1] is not None, (name, run["wps"])
        vcl = [u.nal_unit_type for u in split_annexb(b"".join(run["outs"]))
               if u.nal_unit_type in (1, 5)]
        idr = [i for i, t in enumerate(vcl) if t == 5]
        assert idr == ([0, CUT_AT] if name == "scenecut" else [0]), \
            (name, vcl)


def test_p_frames_from_converted_state(refs):
    """A JAX encoder converted after CONVERT_AT frames (DPB, counters,
    _wp_prev, the scene-cut detector's prev and _ema) and the port go on
    with the same bytes and reconstruction."""
    cfg = config_from_jax_fields({k[len("cs_cfg_"):]: refs[k].item()
                                  for k in refs if k.startswith("cs_cfg_")})
    enc = tenc.TorchEncoder(cfg, device="cpu")
    st = {k: int(refs[f"cs_{k}"]) for k in ("frame_idx", "frame_num",
                                            "idr_id", "poc", "last_idr")}
    enc.load_state(state_from_numpy(
        *(refs[f"cs_ref_{k}"] for k in "yuv"), **st,
        wp_prev=refs["cs_wp_prev"],
        scenecut_prev=refs["cs_scenecut_prev"],
        scenecut_ema=float(refs["cs_scenecut_ema"]), device="cpu"))
    clip = converted_state_clip()
    qp = int(refs["cs_qp"])
    assert qp == CONVERT_QP
    for k, frame in enumerate(clip[CONVERT_AT:]):
        (au, _, ftype), = enc.push_frame(*frame, qp_i=qp, qp_p=qp)
        assert ftype == "P"
        assert au == refs[f"cs_au_{k}"].tobytes(), f"frame {k} differs"
        for a, p in zip(enc.ref, "yuv"):
            np.testing.assert_array_equal(a.numpy(), refs[f"cs_rec{k}_{p}"])
