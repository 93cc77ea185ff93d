"""The batch transcode (x264vfw_tpu_torch/parallel/transcode.py): decode
-> scale -> re-encode, held to the JAX package's committed outputs on
its own test case (tests/test_transcode_multichip.py::
test_transcode_pipeline: 96x80 -> 48x40), in tests/jax_refs/parallel.npz.

The scaler's float32 products may sum in another order than XLA's, so a
sample can round the other way (within 1, ROADMAP C).  Where no scaled
sample differs, the bytes must equal JAX's; where some do, the re-encode
of JAX's own scaled frames must, and the count is reported.
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.config.params import EncoderParams
from x264vfw_tpu_torch.parallel import transcode as tc

W, H, N = 96, 80, 4
DST = (48, 40)


def clip_frames() -> list:
    clip = oracle.make_test_clip(W, H, N, seed=8)
    fsz, csz = W * H, W * H // 4
    return [(clip[i, :fsz].reshape(H, W),
             clip[i, fsz:fsz + csz].reshape(H // 2, W // 2),
             clip[i, fsz + csz:].reshape(H // 2, W // 2)) for i in range(N)]


def src_params() -> EncoderParams:
    return EncoderParams(rc_mode="cqp", qp=22, merange=4, log_level=-1)


def out_params() -> EncoderParams:
    return EncoderParams(rc_mode="cqp", qp=24, merange=4, log_level=-1)


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("parallel")


def _scaled_record(monkeypatch) -> list:
    """Every frame the transcode scales, as compress() receives it."""
    got = []
    plain = tc._scaled

    def keep(*a, **k):
        got.append(plain(*a, **k))
        return got[-1]

    monkeypatch.setattr(tc, "_scaled", keep)
    return got


def _reencode_of_jax_frames(refs, prefix: str, params) -> bytes:
    s = CompressSession(params, device="cpu")
    s.begin(*DST)
    out = b"".join(s.compress(tuple(refs[f"{prefix}_{i}_{p}"] for p in "yuv"))
                   for i in range(N))
    return out + s.end()["tail"]


def _check(refs, prefix: str, want_key: str, got: bytes, scaled: list,
           params) -> bool:
    """JAX's bytes (refs[want_key]), by the scaler rule of the module doc;
    prefix names JAX's scaled frames.  True when no scaled sample
    differed."""
    assert len(scaled) == N
    diffs = [np.abs(g.astype(np.int32) - refs[f"{prefix}_{i}_{p}"])
             for i, fr in enumerate(scaled) for p, g in zip("yuv", fr)]
    assert max(int(d.max()) for d in diffs) <= 1
    n_diff = sum(int((d != 0).sum()) for d in diffs)
    want = refs[want_key].tobytes()
    if n_diff == 0:
        assert got == want
    else:
        print(f"{prefix}: {n_diff} scaled samples differ from JAX's by 1")
        assert _reencode_of_jax_frames(refs, prefix, params) == want
    return n_diff == 0


def test_source_equals_jax(refs):
    s = CompressSession(src_params(), device="cpu")
    s.begin(W, H)
    src = b"".join(s.compress(f) for f in clip_frames()) + s.end()["tail"]
    assert src == refs["tc_src"].tobytes()


def test_transcode_equals_jax(refs, monkeypatch, tmp_path):
    scaled = _scaled_record(monkeypatch)
    mp4 = tmp_path / "out.mp4"
    out = tc.transcode(refs["tc_src"].tobytes(), *DST, out_params(),
                       output=str(mp4), device="cpu")
    if _check(refs, "tc", "tc_out", out, scaled, out_params()):
        assert mp4.read_bytes() == refs["tc_mp4"].tobytes()
    dec = oracle.decode_h264_planes(out)
    assert dec is not None and dec[0].shape == (N, DST[1], DST[0])


def test_transcode_frames_equals_jax(refs, monkeypatch):
    scaled = _scaled_record(monkeypatch)
    out = tc.transcode_frames(clip_frames(), *DST, out_params(),
                              device="cpu")
    _check(refs, "tf", "tf_out", out, scaled, out_params())


def test_transcode_takes_the_host_route_on_the_cpu(refs, monkeypatch):
    """On the CPU the decode is the host route, as in the JAX package (the
    device route needs a card); JAX's default params, cqp 26."""
    scaled = _scaled_record(monkeypatch)
    made = []
    plain = tc.H264Decoder

    def spy(*a, **k):
        made.append(k)
        return plain(*a, **k)

    monkeypatch.setattr(tc, "H264Decoder", spy)
    out = tc.transcode(refs["tc_src"].tobytes(), *DST, device="cpu")
    assert [m["use_device"] for m in made] == [False]
    _check(refs, "tc", "tc_default_out", out, scaled,
           EncoderParams(rc_mode="cqp", qp=26))


def test_no_frames_raises():
    with pytest.raises(ValueError, match="no frames"):
        tc.transcode(b"", *DST, device="cpu")
