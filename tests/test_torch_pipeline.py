"""The batched session (encode/pipeline.BatchPipeline, P only) against the
JAX package's, on x264's own ultrafast line: --preset ultrafast with
--crf 23 and with --qp 26 (hierarchical search, no sub-pel step, CAVLC),
plus --keyint 6 so that IDRs fall inside the windows of 12.  30 frames
at 64x48 give two full windows and a flush of 6: compress() returns b""
until the second window fills, the 24th call returns the first window's
12 AUs, and end()["tail"] carries the rest.  Every P run, the flush's
too, is 5 frames long, so JAX compiles one batched P program.  Each
return, the tail and frames_info().delay are compared exactly.  Then
stock FFmpeg decodes the --crf 23 stream to the port's own
reconstruction.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest

import oracle
from test_torch_session import moving_clip
from x264vfw_tpu.api import CompressSession as JaxSession
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream.nal import split_annexb
from x264vfw_tpu_torch.encode import device_finalize as dfin

L3 = "--preset ultrafast --keyint 6"
RATES = ("--crf 23", "--qp 26")
W, H, NFR = 64, 48, 30
SHIFT = (7, -5)          # beyond the +-2 rescue: the coarse stage finds it


def clip():
    return moving_clip(W, H, NFR, seed=8, shift=SHIFT)


def run(session):
    session.begin(W, H)
    outs = [session.compress(f) for f in clip()]
    return outs, session.end()["tail"], session.frames_info().delay


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX package's compress() returns, tail and delay per rate
    setting.  The second session is handed the first one's I-frame
    program (the same function of the geometry), so that XLA compiles it
    once; the P programs are shared by jit's own cache."""
    out, i_full = {}, None
    for rate in RATES:
        s = JaxSession(extra_cmdline=f"{L3} {rate}")
        s.begin(W, H)
        s.encoder._i_full = i_full
        outs = [s.compress(f) for f in clip()]
        out[rate] = (outs, s.end()["tail"], s.frames_info().delay)
        i_full = s.encoder._i_full
    return out


@pytest.mark.parametrize("rate", RATES)
def test_session_equals_jax(jax_sessions, rate):
    s = CompressSession(extra_cmdline=f"{L3} {rate}", device="cpu")
    outs, tail, delay = run(s)
    assert s.encoder.cfg.me_backend == "auto:hier"
    want_outs, want_tail, want_delay = jax_sessions[rate]
    assert delay == want_delay == 23
    assert [i for i, o in enumerate(outs) if o] == [23]
    for i, (got, want) in enumerate(zip(outs, want_outs)):
        assert got == want, f"compress() {i} differs"
    assert tail == want_tail
    types = [u.nal_unit_type for u in split_annexb(b"".join(outs) + tail)]
    assert types.count(5) == 5 and types.count(1) == NFR - 5, types


def test_stream_decodes_to_reconstruction(monkeypatch):
    """Stock FFmpeg decodes the --crf 23 stream to the reference planes
    the encoder kept, frame by frame (collected where device_finalize
    hands them back, in decode order)."""
    recon = []
    keep = dfin._maybe_deblock

    def spy(*a, **k):
        planes = keep(*a, **k)
        recon.append(planes[0].numpy().copy())
        return planes

    monkeypatch.setattr(dfin, "_maybe_deblock", spy)
    outs, tail, _ = run(CompressSession(extra_cmdline=f"{L3} {RATES[0]}",
                                        device="cpu"))
    decoded = oracle.decode_h264(b"".join(outs) + tail)
    assert decoded is not None and len(decoded) == NFR == len(recon)
    for d, r in zip(decoded, recon):
        np.testing.assert_array_equal(d[:W * H].reshape(H, W), r)
