"""Cropped frames, the port against the JAX package, at 72x40: 5 x 3 MBs
coded, the SPS cropping 8 columns and 8 rows.

  * frame: --preset ultrafast --tune zerolatency --me esa --deblock 0:0
    --partitions p8x8 --subme 7 per frame (4 frames): the exhaustive
    search, partitions, quarter pel and the loop filter over the
    edge-padded right and bottom MBs;
  * measured: the same with --psnr --ssim, whose telemetry pulls the
    encoder's reconstruction cropped to 72x40 (TorchEncoder.pop_recon);
  * batched: the default session (x264's --preset medium) over 30 frames:
    B frames, MB-tree, CABAC, the loop filter and the hierarchical search
    at the right and bottom edges.

Every compress() return and end()'s tail equal the JAX session's, but
for the departure that test_torch_batched_live.py pins (ROADMAP.md,
section C): at this size the weight analysis picks weights for some
anchors the batched line encodes per frame, and the JAX package's
batched P headers after them carry that stale table where the port's
carry none.  The measured line's cropped planes, each frame's PSNR and
SSIM and end()'s means equal the JAX package's; DecompressSession
returns the JAX package's planes for the JAX package's frame and batched
streams, in i420 and nv12 (the decoder crops by the SPS).  All from
tests/jax_refs/crop.npz (tools/make_torch_jax_refs.py crop, hash-guarded
by test_torch_session.py::test_jax_references_are_current).  Inputs come
from numpy seeds; no tolerance.
"""

import numpy as np
import pytest

import torch_jax_refs
from test_torch_batched_live import (departures, spied_session,
                                     with_departures)
from test_torch_ratecontrol import medium_clip
from test_torch_signalling import PARTS, decode, decoded_key
from test_torch_session import moving_clip
from x264vfw_tpu_torch.api import CompressSession, DecompressSession
from x264vfw_tpu_torch.encode import torch_encoder as tenc

W, H = 72, 40
LINES = {"frame": PARTS, "measured": PARTS + " --psnr --ssim",
         "batched": ""}
FRAMES = 4                       # the per-frame lines
DECODED = ("frame", "batched")
FORMATS = ("i420", "nv12")


def clip(line: str) -> list:
    if line == "batched":
        return medium_clip(W, H, 30)
    return moving_clip(W, H, FRAMES, seed=61, shift=(3, -2))


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("crop")


@pytest.fixture(scope="module")
def port_runs():
    runs = {"batched": spied_session(LINES["batched"], clip("batched"),
                                     W, H)}
    keep = tenc.TorchEncoder.pop_recon
    popped = []

    def spy(self, d):
        planes = keep(self, d)
        popped.append(planes)
        return planes

    tenc.TorchEncoder.pop_recon = spy
    try:
        for name in ("frame", "measured"):
            s = CompressSession(extra_cmdline=LINES[name], device="cpu")
            log = []
            s.log.sink = lambda lvl, m, log=log: log.append(m)
            s.begin(W, H)
            outs = [s.compress(f) for f in clip(name)]
            end = s.end()
            runs[name] = {"outs": outs, "tail": end["tail"], "end": end,
                          "session": s, "log": log}
    finally:
        tenc.TorchEncoder.pop_recon = keep
    runs["measured"]["recon"] = popped
    return runs


def jax_chunks(refs, line: str) -> list:
    """The JAX session's compress() returns, then its tail."""
    return torch_jax_refs.aus(refs, f"{line}_out") + [
        refs[f"{line}_tail"].tobytes()]


@pytest.mark.parametrize("line", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, line):
    run = port_runs[line]
    want = jax_chunks(refs, line)
    if "batch_hdr" in run:
        want = with_departures(want, run)
    assert len(want) - 1 == len(run["outs"]) == len(clip(line))
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{line}: compress() {i} differs"
    assert run["tail"] == want[-1]


def test_sessions_crop(port_runs):
    """Both encoders code 5 x 3 MBs and crop 4 + 4 (in chroma units of 2
    samples: 8 columns, 8 rows); the batched line departs where a batch
    follows an anchor encoded per frame with weights."""
    for name in LINES:
        run = port_runs[name]
        enc = run["enc"] if "enc" in run else run["session"].encoder
        assert (enc.mbw, enc.mbh) == (5, 3)
        sps = enc.sps
        assert (sps.frame_cropping_flag, sps.frame_crop_right_offset,
                sps.frame_crop_bottom_offset) == (1, 4, 4)
    assert port_runs["batched"]["batched"]
    run = port_runs["batched"]
    assert departures(run)
    assert any(wp is not None for wp in run["wps"].values())
    assert port_runs["frame"]["session"]._pipe is None


def test_measured_recon_and_metrics_equal_jax(refs, port_runs):
    run = port_runs["measured"]
    assert len(run["recon"]) == FRAMES
    for i, planes in enumerate(run["recon"]):
        for p, a in zip("yuv", planes):
            assert a.shape == ((H, W) if p == "y" else (H // 2, W // 2))
            np.testing.assert_array_equal(a, refs[f"measured_recon_{i}_{p}"])
    end = run["end"]
    want_psnr = refs["measured_psnr"].tolist()
    assert [end["psnr"][k] for k in ("y", "u", "v", "global",
                                     "global_all")] == want_psnr
    assert end["ssim"] == float(refs["measured_ssim"])
    # the per-frame lines (type, QP, bits, PSNR, SSIM) and the summary
    assert run["log"] == refs["measured_log"].tolist()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("line", DECODED)
def test_decode_equals_jax(refs, line, fmt):
    got = decode(DecompressSession(device="cpu"),
                 b"".join(jax_chunks(refs, line)), fmt, W, H)
    assert int(refs[f"{line}_{fmt}_calls"]) == len(got)
    for i, arrays in enumerate(got):
        for k, a in enumerate(arrays):
            np.testing.assert_array_equal(
                a, refs[decoded_key(line, fmt, i, k)],
                err_msg=f"{line} {fmt} decompress() {i}")
