"""The signalling options and the chroma QP offset, the port against the
JAX package, at 64x48:

  * cqo_frame: --preset ultrafast --tune zerolatency --me esa --deblock
    0:0 --partitions p8x8 --subme 7 --chroma-qp-offset -2 per frame: the
    offset through the SAD, memc and deblock paths (the PPS's
    chroma_qp_index_offset, the chroma QP of the residual and of the
    loop filter's maps);
  * cqo_batched: the default session with --chroma-qp-offset 3 over
    test_torch_ratecontrol.medium_clip() (16 frames): trellis, AQ, the 8x8
    transform, B frames, CABAC;
  * vui: slice 1's line (--preset ultrafast --tune zerolatency --me esa
    --qp 26) with --sar 16:11 --range pc --colorprim bt709 --transfer
    bt709 --colormatrix bt709 --fps 30000/1001 --level 4.1, written to MP4
    and to Matroska (the sample aspect ratio and the frame rate reach the
    muxers); fullrange: slice 1's line with --fullrange on;
  * hrd_vbr, hrd_cbr: slice 1's line with --keyint 3 --nal-hrd vbr (cbr)
    --vbv-maxrate 300 --vbv-bufsize 150 --aud over 5 frames (IDRs at 0
    and 3).

Every compress() return and end()'s tail equal the JAX session's, the
MP4 and Matroska files are the JAX package's byte for byte, and
DecompressSession's rgb24 frames of the vui and fullrange streams (whose
conversion reads the matrix and range from the VUI) equal the JAX
DecompressSession's; all from tests/jax_refs/signalling.npz (tools/
make_torch_jax_refs.py signalling, hash-guarded by test_torch_session.py
::test_jax_references_are_current).  The HRD streams carry a
buffering-period SEI at each IDR and an access-unit delimiter as each
AU's first NAL, and stock FFmpeg decodes them to the encoder's
reconstruction; --nal-hrd cbr without VBV warns as the JAX package does
and signals no HRD.  Inputs come from numpy seeds; no tolerance.
"""

import os

import numpy as np
import pytest

import oracle
import torch_decode_streams as tds
import torch_jax_refs
from test_torch_batched_live import departures, spied_session
from test_torch_ratecontrol import medium_clip
from test_torch_session import moving_clip
from x264vfw_tpu_torch.api import CompressSession, DecompressSession
from x264vfw_tpu_torch.bitstream.nal import NAL_SEI, split_annexb
from x264vfw_tpu_torch.bitstream.params import SPS
from x264vfw_tpu_torch.bitstream.sei import (SEI_BUFFERING_PERIOD,
                                             parse_sei_messages)

W, H = 64, 48
PARTS = ("--preset ultrafast --tune zerolatency --me esa --deblock 0:0 "
         "--partitions p8x8 --subme 7")
SLICE1 = "--preset ultrafast --tune zerolatency --me esa --qp 26"
VUI = ("--sar 16:11 --range pc --colorprim bt709 --transfer bt709 "
       "--colormatrix bt709 --fps 30000/1001 --level 4.1")
HRD = "--keyint 3 --nal-hrd {m} --vbv-maxrate 300 --vbv-bufsize 150 --aud"
LINES = {"cqo_frame": PARTS + " --chroma-qp-offset -2",
         "cqo_batched": "--chroma-qp-offset 3",
         "vui": f"{SLICE1} {VUI}",
         "fullrange": SLICE1 + " --fullrange on",
         "hrd_vbr": f"{SLICE1} {HRD.format(m='vbr')}",
         "hrd_cbr": f"{SLICE1} {HRD.format(m='cbr')}"}
FRAMES = {"cqo_frame": 4, "vui": 3, "fullrange": 3, "hrd_vbr": 5,
          "hrd_cbr": 5}
CONTAINERS = ("mp4", "mkv")          # the vui line's files
DECODED = ("vui", "fullrange")       # DecompressSession rgb24
NO_VBV = SLICE1 + " --nal-hrd cbr"


def clip(line: str) -> list:
    if line == "cqo_batched":
        return medium_clip()
    return moving_clip(W, H, FRAMES[line], seed=51, shift=(3, -2))


def decode(sess, stream: bytes, fmt: str, w: int = W, h: int = H) -> list:
    """Every decompress() return (as a tuple of arrays) over the stream's
    access units, then two drain calls."""
    sess.begin(w, h, fmt)
    outs = [sess.decompress(au) for au in tds.split_aus(stream)]
    outs += [sess.decompress(b"") for _ in range(2)]
    sess.end()
    return [o if isinstance(o, tuple) else (o,) for o in outs]


def decoded_key(line: str, fmt: str, call: int, k: int) -> str:
    return f"{line}_{fmt}_{call}_{k}"


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("signalling")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("signalling")
    runs = {}
    for name, cmd in LINES.items():
        if name == "cqo_batched":
            runs[name] = spied_session(cmd, clip(name))
            continue
        s = CompressSession(extra_cmdline=cmd, device="cpu")
        # the vui line's AUs as it writes its MP4
        mp4 = os.path.join(tmp, "vui.mp4") if name == "vui" else None
        s.begin(W, H, output=mp4)
        outs, recon = [], []
        for f in clip(name):
            outs.append(s.compress(f))
            recon.append(s.encoder.last_recon)
        runs[name] = {"outs": outs, "tail": s.end()["tail"], "recon": recon,
                      "session": s}
    path = os.path.join(tmp, "vui.mkv")
    s = CompressSession(extra_cmdline=LINES["vui"], device="cpu")
    s.begin(W, H, output=path)
    for f in clip("vui"):
        s.compress(f)
    s.end()
    for ext in CONTAINERS:
        with open(os.path.join(tmp, f"vui.{ext}"), "rb") as fh:
            runs[ext] = fh.read()
    return runs


def stream(run) -> bytes:
    return b"".join(run["outs"]) + run["tail"]


@pytest.mark.parametrize("line", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, line):
    run = port_runs[line]
    want = torch_jax_refs.aus(refs, f"{line}_out")
    assert len(want) == len(run["outs"]) == len(clip(line))
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{line}: compress() {i} differs"
    assert run["tail"] == refs[f"{line}_tail"].tobytes()


def test_chroma_qp_offset_reaches_the_encoder(port_runs):
    """The PPS carries the offset; the per-frame line is not batched and
    the batched one departs from the JAX bytes nowhere."""
    for name, off in (("cqo_frame", -2), ("cqo_batched", 3)):
        run = port_runs[name]
        enc = run["enc"] if "enc" in run else run["session"].encoder
        assert enc.pps.chroma_qp_index_offset == off
        assert enc.cfg.chroma_qp_offset == off
    assert port_runs["cqo_batched"]["batched"]
    assert departures(port_runs["cqo_batched"]) == {}
    enc = port_runs["cqo_frame"]["session"].encoder
    assert enc.cfg.deblock and enc.partitions and enc.cfg.subpel == 2


def test_vui_sps(refs, port_runs):
    """The SPS is the JAX package's: SAR 16:11, full range, BT.709
    colour, 30000/1001 timing."""
    nals = split_annexb(port_runs["vui"]["outs"][0])
    sps_nal = next(u for u in nals if u.nal_unit_type == 7)
    jax_sps = next(u for u in split_annexb(refs["vui_out_0"].tobytes())
                   if u.nal_unit_type == 7)
    assert sps_nal.rbsp.tobytes() == jax_sps.rbsp.tobytes()
    sps = SPS.from_rbsp(sps_nal.rbsp)
    assert (sps.sar_width, sps.sar_height) == (16, 11)
    assert sps.video_full_range_flag == 1
    assert (sps.colour_primaries, sps.transfer_characteristics,
            sps.matrix_coefficients) == (1, 1, 1)
    assert (sps.num_units_in_tick, sps.time_scale) == (1001, 60000)
    full = next(u for u in split_annexb(port_runs["fullrange"]["outs"][0])
                if u.nal_unit_type == 7)
    assert SPS.from_rbsp(full.rbsp).video_full_range_flag == 1


@pytest.mark.parametrize("ext", CONTAINERS)
def test_container_files_equal_jax(refs, port_runs, ext):
    assert port_runs[ext] == refs[f"vui_{ext}"].tobytes()


@pytest.mark.parametrize("line", DECODED)
def test_rgb24_decode_equals_jax(refs, port_runs, line):
    got = decode(DecompressSession(device="cpu"), stream(port_runs[line]),
                 "rgb24")
    assert int(refs[f"{line}_rgb24_calls"]) == len(got)
    for i, arrays in enumerate(got):
        for k, a in enumerate(arrays):
            np.testing.assert_array_equal(
                a, refs[decoded_key(line, "rgb24", i, k)],
                err_msg=f"{line} decompress() {i}")


@pytest.mark.parametrize("line", ("hrd_vbr", "hrd_cbr"))
def test_hrd_stream(port_runs, line):
    """HRD in the SPS (cbr_flag as asked), a buffering-period SEI before
    the version SEI at each IDR, an AUD first in every AU, and FFmpeg
    decodes the stream to the encoder's reconstruction."""
    run = port_runs[line]
    enc = run["session"].encoder
    assert enc.sps.nal_hrd_present == 1
    assert enc.sps.hrd_cbr == int(line == "hrd_cbr")
    for i, au in enumerate(run["outs"]):
        nals = split_annexb(au)
        assert nals[0].nal_unit_type == 9, i
        idr = any(u.nal_unit_type == 5 for u in nals)
        assert idr == (i % 3 == 0)
        seis = [p for u in nals if u.nal_unit_type == NAL_SEI
                for p, _ in parse_sei_messages(u.rbsp)]
        if idr:
            assert seis[0] == SEI_BUFFERING_PERIOD and len(seis) == 2, seis
        else:
            assert seis == []
    dec = oracle.decode_h264(stream(run))
    assert dec is not None and len(dec) == len(run["outs"])
    for i, (y, u, v) in enumerate(run["recon"]):
        np.testing.assert_array_equal(
            dec[i], np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
            err_msg=f"{line} frame {i}")


def test_nal_hrd_without_vbv_warns_as_jax(refs):
    msgs = []
    s = CompressSession(extra_cmdline=NO_VBV, device="cpu")
    s.log.sink = lambda lvl, m: msgs.append(m)
    s.begin(W, H)
    assert s.encoder.sps.nal_hrd_present == 0
    assert msgs == refs["no_vbv_log"].tolist()
    assert any("--nal-hrd requires" in m for m in msgs)
