"""The decoder's host route (decode/decoder.py, numpy) on the CPU, held
exactly against the JAX package's (x264vfw_tpu/decode/decoder.py, which
tests/test_decoder_vs_ffmpeg.py pins to stock FFmpeg).

The streams (tests/torch_decode_streams.py) are the port's own lines at
64x48, whose bytes equal the JAX package's (CAVLC with P8x8 and the loop
filter; veryfast: CABAC, I4x4, the 8x8 transform and weighted P; the
batched veryfast line's B frames; the default session's three
references, B frames and trellis), and libx264 streams: CABAC with B
frames, temporal direct, three slices per picture, I_PCM and CAVLC with
the 8x8 transform.  Planes (as digests), POC, frame_num and reference
marking of every frame, in decode order, equal the JAX decoder's
(committed in tests/jax_refs/decode.npz).
"""

import numpy as np
import pytest

import torch_decode_streams as tds
import torch_jax_refs
from x264vfw_tpu_torch.decode.decoder import H264Decoder


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("decode")


@pytest.mark.parametrize("name", tds.HOST_STREAMS)
def test_host_decode_equals_jax(refs, name):
    got = tds.decode_record(H264Decoder(), refs[f"stream_{name}"].tobytes(),
                            meta=False)
    assert len(got["poc"]) > 1
    for k, v in got.items():
        want = refs[f"host_{name}_{k}"]
        if k in "yuv":
            assert torch_jax_refs.digest(v) == str(want), f"{name} {k}"
        else:
            np.testing.assert_array_equal(v, want, err_msg=f"{name} {k}")
