"""The port's DecompressSession on the CPU, held against the JAX package's.

* Every OUTPUT_FORMATS entry, on a CAVLC I/P stream that the device route
  decodes (--preset faster --tune zerolatency --no-cabac, 64x48), equals
  the JAX package's DecompressSession, black frames and drain included.
* On the batched veryfast line (B frames, CABAC: the host route) the
  black frame before the first output, the reorder delay and the drain
  equal the JAX package's.
* The scaler (64x48 to 32x24 and to 96x72): max |diff| <= 1 against the
  JAX package's scale_i420, and exact elsewhere.  The two may order their
  float32 sums differently, so a sample within a rounding step of .5 can
  round the other way: at most 1% of the samples may differ.  When this
  test was written none did (0 of 6,912 and 0 of 62,208 samples).
* avcC extradata with length-prefixed AUs, and the samples of an MP4 file
  written by the port's muxer, decode as the Annex-B stream does.
The JAX outputs are committed (tests/jax_refs/decode.npz).
"""

import numpy as np
import pytest

import torch_decode_streams as tds
import torch_jax_refs
from x264vfw_tpu_torch.api import DecompressSession, _strip_parameter_sets
from x264vfw_tpu_torch.bitstream.avcc import build_avcc
from x264vfw_tpu_torch.bitstream.nal import iter_annexb_raw
from x264vfw_tpu_torch.output.base import MuxParams
from x264vfw_tpu_torch.output.mp4 import Mp4Muxer

MAX_SHARE = 0.01     # of the samples the scaler may round the other way


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("decode")


def aus(refs, name: str) -> list:
    return tds.split_aus(refs[f"stream_{name}"].tobytes())


def run(aus_, **begin) -> list:
    return tds.run_session(DecompressSession(device="cpu"), aus_, **begin)


def want(refs, prefix: str, n_calls: int) -> list:
    out = []
    for i in range(n_calls):
        arrays, j = [], 0
        while f"{prefix}_{i}_{j}" in refs:
            arrays.append(refs[f"{prefix}_{i}_{j}"])
            j += 1
        out.append(arrays)
    return out


@pytest.mark.parametrize("fmt", DecompressSession.OUTPUT_FORMATS)
def test_output_formats_equal_jax(refs, fmt):
    got = run(aus(refs, tds.SESSION_STREAM), fmt=fmt)
    exp = want(refs, f"sess_{fmt}", len(got))
    for i, (g, w) in enumerate(zip(got, exp)):
        assert len(g) == len(w), (fmt, i)
        for a, b in zip(g, w):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f"{fmt} call {i}")


def test_display_order_black_frame_and_drain_equal_jax(refs):
    a = aus(refs, tds.REORDER_STREAM)
    got = run(a)
    exp = want(refs, "reorder", len(got))
    assert len(got) == len(a) + tds.DRAINS
    # the first call returns a black frame (the one-frame reorder delay)
    assert (got[0][0] == 16).all() and (got[0][1] == 128).all()
    for i, (g, w) in enumerate(zip(got, exp)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y, err_msg=f"call {i}")


@pytest.mark.parametrize("size", tds.SCALES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scaler_within_one_of_jax(refs, size):
    w, h = size
    got = run(aus(refs, tds.SESSION_STREAM), out_width=w, out_height=h)
    exp = want(refs, f"sess_scale{w}x{h}", len(got))
    diff, n = 0, 0
    for g, e in zip(got, exp):
        assert [a.shape for a in g] == [(h, w), (h // 2, w // 2),
                                        (h // 2, w // 2)]
        for a, b in zip(g, e):
            d = np.abs(a.astype(np.int32) - b)
            assert d.max() <= 1
            diff += int((d != 0).sum())
            n += d.size
    assert diff <= MAX_SHARE * n, f"{diff} of {n} samples differ"


def _lp(au: bytes) -> bytes:
    """An Annex-B AU as length-prefixed sample data, parameter sets out."""
    return b"".join(len(n).to_bytes(4, "big") + n for n in iter_annexb_raw(au)
                    if n[0] & 0x1F not in (7, 8))


def _param_sets(stream: bytes):
    nals = {n[0] & 0x1F: n for n in iter_annexb_raw(stream)}
    return nals[7], nals[8]


@pytest.mark.parametrize("name", [tds.SESSION_STREAM, tds.REORDER_STREAM])
def test_length_prefixed_avcc_equals_annexb(refs, name):
    a = aus(refs, name)
    avcc = build_avcc(*_param_sets(b"".join(a)))
    got = run([_lp(x) for x in a], extradata=avcc)
    for g, w in zip(got, run(a)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_mp4_samples_equal_annexb(refs, tmp_path):
    """The port's MP4 muxer writes the AUs; its avcC and samples, read back
    from the file, decode as the Annex-B stream does."""
    a = aus(refs, tds.SESSION_STREAM)
    path = str(tmp_path / "out.mp4")
    mux = Mp4Muxer()
    mux.open_file(path)
    mux.set_param(MuxParams(width=tds.W, height=tds.H))
    mux.write_headers(*_param_sets(b"".join(a)))
    for i, au in enumerate(a):
        payload, key = _strip_parameter_sets(au)
        mux.write_frame(payload, pts=i, dts=i, keyframe=key)
    mux.close_file(len(a) - 1, len(a) - 2)
    with open(path, "rb") as f:
        avcc, samples = tds.mp4_samples(f.read())
    assert samples == [_lp(x) for x in a]
    got = run(samples, extradata=avcc)
    for g, w in zip(got, run(a)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_length_prefixed_sample_starting_like_a_start_code(refs):
    """A sample whose first NAL is 256 to 511 bytes long begins 00 00 01
    (its 4-byte length).  The port reads it as length-prefixed, since its
    lengths tile it; the JAX package's _to_annexb passes it on as Annex-B
    (ROADMAP C: a reference fault the port does not copy)."""
    from x264vfw_tpu.api import DecompressSession as JaxSession
    a = aus(refs, tds.SESSION_STREAM)
    filler = bytes([12]) + b"\xff" * 298 + b"\x80"    # filler data NAL
    lp = [len(filler).to_bytes(4, "big") + filler + _lp(x) for x in a]
    assert lp[0][:3] == b"\x00\x00\x01"
    avcc = build_avcc(*_param_sets(b"".join(a)))
    jax_sess = JaxSession(use_device=False)
    jax_sess.begin(tds.W, tds.H, extradata=avcc)
    assert jax_sess._to_annexb(lp[0]) == lp[0]
    got = run(lp, extradata=avcc)
    for g, w in zip(got, run(a)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
