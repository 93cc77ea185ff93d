"""TorchEncoder's batched and pipelined entry points, the port against the
JAX package: encode_gop_batch (the stream's first frame and each keyint
boundary per frame, the P frames between them as one batch each, one QP,
one reference, no weights) and encode_frame_pipelined with
flush_pipeline (one frame of output delay), in three configurations:

  * parts96: tests/test_partitions.py::test_partition_batch_matches_per_
    frame's, 96x64, 4 frames, qp 27, keyint 50, search range 8, the XLA
    search, partitions, deblock;
  * idr64: 64x48, keyint 5, 9 frames, so that a batch meets an IDR
    (frames 0 and 5 per frame, 1-4 and 6-8 batched);
  * capacity: bench.py's device-capacity configuration (qp 26, search
    range 8, deblock, AQ 1.0, trellis, partitions) at 64x48, 5 frames.

In each, encode_gop_batch's AUs equal the port's encode_frame AUs and the
JAX package's encode_gop_batch and encode_frame AUs; the pipelined route
over the same frames returns None first, then each previous AU, the last
from flush_pipeline, the same AUs as the JAX package's pipelined route
(tests/jax_refs/encoder_batch.npz, tools/make_torch_jax_refs.py
encoder_batch, hash-guarded by test_torch_session.py::
test_jax_references_are_current).

The JAX package writes these routes' CAVLC slices under a PPS that
declares CABAC when the config asks for it, and its stream does not
decode (ROADMAP.md, section C): the port refuses --cabac on all three
methods.  Inputs come from numpy seeds; no tolerance.
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu_torch.bitstream.nal import split_annexb
from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder

CASES = {
    "parts96": (96, 64, 4, dict(qp=27, keyint=50, search_range=8,
                                me_backend="xla", partitions=True,
                                deblock=True)),
    "idr64": (64, 48, 9, dict(qp=26, keyint=5, search_range=8)),
    "capacity": (64, 48, 5, dict(qp=26, keyint=250, search_range=8,
                                 deblock=True, aq_strength=1.0,
                                 trellis=True, partitions=True)),
}
ROUTES = ("frame", "batch", "pipe")


def mixed_motion_clip(w, h, n, seed=3):
    """tests/test_partitions.py's clip: the left half moving by (2, 1)
    pixels per frame, the right by (-1, -1), low-contrast chroma noise."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h, w)).astype(np.uint8)
    frames = []
    for f in range(n):
        y = np.roll(base, (f, 2 * f), axis=(0, 1)).copy()
        y[:, (w // 2 - 8):] = np.roll(base, (-f, -f),
                                      axis=(0, 1))[:, (w // 2 - 8):]
        u = np.clip(128 + r.integers(-9, 10, (h // 2, w // 2)), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + r.integers(-9, 10, (h // 2, w // 2)), 0,
                    255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def clip(case: str) -> list:
    w, h, n, _ = CASES[case]
    if case == "parts96":
        return mixed_motion_clip(w, h, n, seed=7)
    return moving_clip(w, h, n, seed=71, shift=(3, -2))


def config(case: str, cls=EncoderConfig, **over):
    w, h, _, kw = CASES[case]
    return cls(width=w, height=h, **{**kw, **over})


def run_routes(make_encoder, frames) -> dict:
    """{route: AUs}: encode_frame per frame, encode_gop_batch, and the
    pipelined returns (None first) with flush_pipeline's last."""
    enc = make_encoder()
    out = {"frame": [enc.encode_frame(*f) for f in frames]}
    out["batch"] = make_encoder().encode_gop_batch(frames)
    enc = make_encoder()
    out["pipe"] = [enc.encode_frame_pipelined(*f) for f in frames] + [
        enc.flush_pipeline()]
    return out


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("encoder_batch")


@pytest.fixture(scope="module")
def port_runs():
    return {case: run_routes(
        lambda case=case: TorchEncoder(config(case), device="cpu"),
        clip(case)) for case in CASES}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(CASES))
def test_route_equals_jax(refs, port_runs, case, route):
    got = port_runs[case][route]
    want = torch_jax_refs.aus(refs, f"{case}_{route}")
    if route == "pipe":
        assert got[0] is None and bool(refs[f"{case}_pipe_first_none"])
        got = got[1:]
    assert len(got) == len(want) == len(clip(case))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{case} {route}: AU {i} differs"


@pytest.mark.parametrize("case", list(CASES))
def test_batch_and_pipeline_equal_per_frame(port_runs, case):
    run = port_runs[case]
    assert run["batch"] == run["frame"] == run["pipe"][1:]
    assert run["pipe"][0] is None


def test_idr_inside_the_batch(port_runs):
    """idr64: IDRs at 0 and 5, P frames between; the stream decodes in
    stock FFmpeg to as many frames."""
    aus = port_runs["idr64"]["batch"]
    idr = [any(u.nal_unit_type == 5 for u in split_annexb(au)) for au in aus]
    assert [i for i, k in enumerate(idr) if k] == [0, 5]
    dec = oracle.decode_h264(b"".join(aus))
    assert dec is not None and len(dec) == len(aus)


def test_batch_calls_the_batched_program(monkeypatch):
    """encode_gop_batch sends the P frames between IDRs through one
    encode_pgop_slots call each, over one QP (the qp argument)."""
    from x264vfw_tpu_torch.encode import device_finalize as dfin
    calls = []
    keep = dfin.encode_pgop_slots

    def spy(rows, *a, **k):
        calls.append((rows.shape[0], list(a[3])))
        return keep(rows, *a, **k)

    monkeypatch.setattr(dfin, "encode_pgop_slots", spy)
    enc = TorchEncoder(config("idr64"), device="cpu")
    enc.encode_gop_batch(clip("idr64"), qp=30)
    assert calls == [(4, [30] * 4), (3, [30] * 3)]
    assert enc.qp == 30


@pytest.mark.parametrize("method", ("encode_gop_batch",
                                    "encode_frame_pipelined",
                                    "flush_pipeline"))
def test_cabac_refused(method):
    enc = TorchEncoder(config("idr64", cabac=True), device="cpu")
    frames = clip("idr64")
    args = {"encode_gop_batch": (frames,),
            "encode_frame_pipelined": frames[0],
            "flush_pipeline": ()}[method]
    with pytest.raises(ValueError, match="cabac"):
        getattr(enc, method)(*args)


def test_weights_left_out_after_weighted_frames():
    """A P frame encoded per frame with weights, then a batch: the batch
    predicts without weights and its headers say so (the JAX package's
    carry the per-frame frame's table, ROADMAP.md section C); FFmpeg
    decodes the stream to the encoder's reconstruction."""
    frames = clip("idr64")[:4]
    fade = [(np.clip(y.astype(np.int32) * (10 - i) // 10, 0, 255)
             .astype(np.uint8), u, v) for i, (y, u, v) in enumerate(frames)]
    enc = TorchEncoder(config("idr64", weightp=1), device="cpu")
    aus = [enc.encode_frame(*f) for f in fade[:2]]
    assert enc._wp is not None
    aus += enc.encode_gop_batch(fade[2:])
    assert enc._wp is None
    dec = oracle.decode_h264(b"".join(aus))
    y, u, v = enc.last_recon
    np.testing.assert_array_equal(
        dec[-1], np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
