"""Input colourspace conversion (x264vfw_tpu_torch/ops/csp.py) against the
JAX package's x264vfw_tpu/ops/csp.py, exactly.

Every format of SUPPORTED_INPUT_FORMATS under the three matrices, TV and
full range, flipped and not; i420_to_rgb (the decoder's output side, no
caller in the port yet) and the helpers (yuyv_to_i422, i420_to_nv12,
subsample_i420_from_i422, vflip).  Then the session: compress(frame, fmt)
takes each format on the per-frame and the batched path and writes the
bytes of a session fed the same frames as I420, converted by the JAX
package's own _to_i420.  JAX's conversions are eager jnp on the CPU
(nothing to compile).  Inputs from numpy seeds; tolerance: none.
"""

import numpy as np
import pytest
import torch

from x264vfw_tpu import api as jax_api
from x264vfw_tpu.ops import csp as jcsp
from x264vfw_tpu_torch import api
from x264vfw_tpu_torch.api import SUPPORTED_INPUT_FORMATS, CompressSession
from x264vfw_tpu_torch.ops import csp

MATRICES = ("bt601", "bt709", "bt2020")


def frame_in(fmt, w, h, rng):
    """A random frame in fmt's layout (what compress() takes)."""
    def b(*shape):
        return rng.integers(0, 256, shape, np.uint8)
    if fmt in ("i420", "yv12"):
        return b(h, w), b(h // 2, w // 2), b(h // 2, w // 2)
    if fmt in ("nv12", "nv21"):
        return b(h, w), b(h // 2, w)
    if fmt in ("yuyv", "uyvy"):
        return b(h, 2 * w)
    return b(h, w, 4 if fmt in ("bgra", "rgba") else 3)


def same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and got.shape == want.shape \
        and np.array_equal(got, want)


def test_supported_formats_are_jax():
    assert SUPPORTED_INPUT_FORMATS == jax_api.SUPPORTED_INPUT_FORMATS


@pytest.mark.parametrize("fmt", SUPPORTED_INPUT_FORMATS)
def test_convert_to_i420_equals_jax(fmt):
    rng = np.random.default_rng(len(fmt) * 7 + ord(fmt[0]))
    data = frame_in(fmt, 20, 14, rng)
    for matrix in MATRICES:
        for full in (False, True):
            for flip in (False, True):
                got = csp.convert_to_i420(fmt, data, matrix=matrix,
                                          fullrange=full, flip=flip)
                want = jcsp.convert_to_i420(fmt, data, matrix=matrix,
                                            fullrange=full, flip=flip)
                assert all(same(g, w) for g, w in zip(got, want)), \
                    (matrix, full, flip)


def test_rgb_extremes_and_i420_to_rgb_equal_jax():
    """Saturated and grey RGB (the clamps), and I420 -> RGB for every
    matrix and range."""
    rng = np.random.default_rng(5)
    rgb = rng.choice(np.array([0, 1, 127, 128, 254, 255], np.uint8),
                     (8, 12, 3))
    y, u, v = (rng.integers(0, 256, s, np.uint8)
               for s in ((8, 12), (4, 6), (4, 6)))
    for matrix in MATRICES:
        for full in (False, True):
            for bgr in (False, True):
                got = csp.rgb_to_i420(torch.from_numpy(rgb), matrix, full,
                                      bgr)
                want = jcsp.rgb_to_i420(rgb, matrix, full, bgr)
                assert all(same(g, w) for g, w in zip(got, want))
            got = csp.i420_to_rgb(*map(torch.from_numpy, (y, u, v)),
                                  matrix=matrix, fullrange=full)
            assert same(got, jcsp.i420_to_rgb(y, u, v, matrix=matrix,
                                              fullrange=full))


def test_helpers_equal_jax():
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, (6, 16), np.uint8)
    got = csp.yuyv_to_i422(torch.from_numpy(packed))
    want = jcsp.yuyv_to_i422(packed)
    assert all(same(g, w) for g, w in zip(got, want))
    got = csp.subsample_i420_from_i422(*got)
    want = jcsp.subsample_i420_from_i422(*want)
    assert all(same(g, w) for g, w in zip(got, want))
    y, u, v = (rng.integers(0, 256, s, np.uint8)
               for s in ((6, 8), (3, 4), (3, 4)))
    got = csp.i420_to_nv12(*map(torch.from_numpy, (y, u, v)))
    assert all(same(g, w) for g, w in zip(got, jcsp.i420_to_nv12(y, u, v)))
    got = csp.vflip(*map(torch.from_numpy, (y, u)))
    assert all(same(g, w) for g, w in zip(got, jcsp.vflip(y, u)))
    with pytest.raises(ValueError):
        csp.convert_to_i420("p010", (y, u, v))


@pytest.mark.parametrize("cmd,batched", [
    ("--preset ultrafast --tune zerolatency --me esa --qp 26", False),
    ("--preset ultrafast --keyint 6 --crf 23", True)])
def test_session_takes_every_format(cmd, batched):
    """Frame k of a 10-frame session comes in format k; the AUs equal a
    session fed the JAX package's I420 conversion of the same frames."""
    w, h = 32, 32
    rng = np.random.default_rng(3)
    frames = [(fmt, frame_in(fmt, w, h, rng))
              for fmt in SUPPORTED_INPUT_FORMATS]
    outs = {}
    for tag in ("fmt", "i420"):
        s = CompressSession(extra_cmdline=cmd, device="cpu")
        s.begin(w, h)
        assert (s._pipe is not None) == batched
        outs[tag] = [s.compress(*((f, fmt) if tag == "fmt" else
                                  (jax_api._to_i420(f, fmt),)))
                     for fmt, f in frames]
        outs[tag].append(s.end()["tail"])
    assert outs["fmt"] == outs["i420"] and b"".join(outs["fmt"])
    for fmt, f in frames:
        got = api._to_i420(f, fmt, "cpu")
        want = jax_api._to_i420(f, fmt)
        assert all(np.asarray(g).dtype == np.uint8
                   and np.array_equal(g, w_) for g, w_ in zip(got, want))
