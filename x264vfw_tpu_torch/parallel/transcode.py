"""Batch transcode: decode -> scale -> re-encode (BASELINE config 5).

Port of x264vfw_tpu/parallel/transcode.py.  The stages mirror the
reference's decompress + swscale + compress composition as a pipeline
over the decoder (decode/decoder.py), the scaler (ops/scale.py, float32
matrix products on the device) and the encoder session (api.py).  The
entry points run on the CUDA device unless the caller names the CPU.  On
a CUDA device the decode takes the decoder's device route (CAVLC I/P
slices reconstructed on the card, every other slice on the host route);
on the CPU it takes the host route, as the JAX package's transcode always
does.  Both routes give the same planes (tests/test_torch_decode_*.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import CompressSession
from ..config.params import EncoderParams
from ..decode.decoder import H264Decoder
from ..ops.scale import scale_i420
from ..utils.device import resolve_device


def _scaled(planes, dst_w: int, dst_h: int, method: str, dev) -> tuple:
    """I420 host planes scaled on dev, back as uint8 host planes (what
    compress() takes)."""
    out = scale_i420(*(torch.as_tensor(np.asarray(p), device=dev)
                       for p in planes), dst_w, dst_h, method)
    return tuple(p.to(torch.uint8).cpu().numpy() for p in out)


def _session(params: EncoderParams | None, dev) -> CompressSession:
    p = params.copy() if params else EncoderParams(rc_mode="cqp", qp=26)
    return CompressSession(p, device=dev)


def transcode(bitstream: bytes, dst_w: int, dst_h: int,
              params: EncoderParams | None = None, output=None,
              method: str = "bicubic", device=None) -> bytes:
    """H.264 Annex-B in -> decoded -> scaled -> re-encoded Annex-B out
    (and written to `output` by the muxer its extension selects).
    params default to the JAX package's EncoderParams(rc_mode="cqp",
    qp=26)."""
    dev = resolve_device(device)
    dec = H264Decoder(use_device=dev.type == "cuda", device=dev)
    dec.decode(bitstream)
    frames = dec.display_order()
    if not frames:
        raise ValueError("no frames decoded from input")
    sess = _session(params, dev)
    sess.begin(dst_w, dst_h, output=output)
    out = b""
    for f in frames:
        out += sess.compress(_scaled((f.y, f.u, f.v), dst_w, dst_h, method,
                                     dev))
    return out + sess.end()["tail"]


def transcode_frames(frames_yuv, dst_w: int, dst_h: int,
                     params: EncoderParams | None = None,
                     device=None) -> bytes:
    """Raw-frame variant (already-decoded (y, u, v) input), bicubic."""
    dev = resolve_device(device)
    sess = _session(params, dev)
    sess.begin(dst_w, dst_h)
    out = b""
    for planes in frames_yuv:
        out += sess.compress(_scaled(planes, dst_w, dst_h, "bicubic", dev))
    return out + sess.end()["tail"]
