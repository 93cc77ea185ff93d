"""The reference decoder: its diagonal loop filter equals the frozen
MB-by-MB one, and the whole decoder equals the port's host decoder, on
streams of every kind the cells make (P, B over three references,
all-intra, filter offsets, the 8x8 transform), at 128x96."""

import json
import os

import numpy as np
import pytest

from portbench import generate
from portbench.reference.h264 import deblock_fast, deblock_np
from portbench.reference.h264 import decoder as ref

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = ["--preset veryfast --tune zerolatency --crf 23",
         "--crf 23",
         "--preset veryfast --tune zerolatency --crf 23 --keyint 1",
         "--crf 30 --deblock 2:-1",
         "--preset slow --crf 18"]


def _stream(cmdline, frames=14):
    from x264vfw_tpu_torch.api import CompressSession
    with open(os.path.join(BENCH, "traffic", "live_inter.json")) as f:
        spec = dict(json.load(f)["frames"], dy=1)
    ring = generate.make_ring(spec, 128, 96, 2**31 + 5)
    s = CompressSession(extra_cmdline=cmdline, device="cpu")
    s.begin(128, 96)
    return (b"".join(s.compress(ring[i % len(ring)], "i420")
                     for i in range(frames)) + s.end()["tail"])


def _planes(frames):
    return [np.stack([f.y.ravel(), *(np.pad(p.ravel(), (0, f.y.size
                                                        - p.size))
                                     for p in (f.u, f.v))])
            for f in frames]


@pytest.mark.parametrize("cmdline", LINES)
def test_diagonal_filter_equals_the_frozen_one(cmdline, monkeypatch):
    au = _stream(cmdline)
    got = ref.H264Decoder()
    got.decode(au)
    monkeypatch.setattr(ref, "deblock_frame", deblock_np.deblock_frame)
    want = ref.H264Decoder()
    want.decode(au)
    assert len(got.frames) == len(want.frames) == 14
    for a, b in zip(_planes(got.frames), _planes(want.frames)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cmdline", LINES)
def test_reference_decoder_equals_the_ports(cmdline):
    from x264vfw_tpu_torch.decode.decoder import H264Decoder
    au = _stream(cmdline)
    got = ref.H264Decoder()
    got.decode(au)
    want = H264Decoder(use_device=False)
    want.decode(au)
    assert len(got.frames) == len(want.frames)
    for a, b in zip(_planes(got.frames), _planes(want.frames)):
        np.testing.assert_array_equal(a, b)


def test_diagonal_filter_is_the_one_the_decoder_uses():
    assert ref.deblock_frame is deblock_fast.deblock_frame
