"""The decoder's device route (decode/device_decode.py) on the CPU, held
exactly against the JAX package's (x264vfw_tpu/decode/device_decode.py).

The streams (tests/torch_decode_streams.py) are CAVLC I/P streams at
64x48: three libx264 streams whose P frames hold I16 and I4x4 MBs among
inter ones (one reference, where the JAX package takes its static-shift
MC; three references, where it gathers; two references with the loop
filter off) and two of the port's own lines (--preset faster --tune
zerolatency --no-cabac: I4x4 in the I frame, two references; and slice
1's line, I16 only, no loop filter).  The JAX package's outputs are
committed (tests/jax_refs/decode.npz), so no test compiles its device
decoder.

* Per picture, decode_frame_core's planes equal the JAX package's
  decode_frame_core's (its batching off).
* The whole decode equals the default JAX decoder's, which batches the
  pictures into decode_gop_core: planes, POC, frame_num, reference
  marking and each Frame's metadata (mb_types, qps, mvs, refs, refid0).
* The wavefront of stage C gives the JAX package's raster order on an
  all-intra picture and on a P picture with scattered intra MBs.
* The device route refuses a CAVLC slice with 8x8-transformed MBs
  exactly where the JAX package's does: the parser called as the
  decoder calls it returns None for such a slice.
"""

import numpy as np
import pytest
import torch

import torch_decode_streams as tds
import torch_jax_refs
from x264vfw_tpu_torch.bitstream import native_parse
from x264vfw_tpu_torch.decode import device_decode as dd
from x264vfw_tpu_torch.decode.decoder import H264Decoder


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("decode")


def stream(refs, name: str) -> bytes:
    return refs[f"stream_{name}"].tobytes()


def core_calls(refs, name: str, monkeypatch) -> list:
    """(kinds, has references, (y, u, v)) of every decode_frame_core call
    of the port's device route on the stream."""
    calls = []
    core = dd.decode_frame_core

    def rec(syn, kinds, luma, *a, **k):
        res = core(syn, kinds, luma, *a, **k)
        calls.append((kinds.copy(), luma is not None,
                      [p.to(torch.uint8).numpy() for p in res]))
        return res

    monkeypatch.setattr(dd, "decode_frame_core", rec)
    H264Decoder(use_device=True, device="cpu").decode(stream(refs, name))
    return calls


def test_streams_cover_both_mc_routes_and_intra_in_p(refs, monkeypatch):
    """The JAX package took its static-shift MC on some P pictures and its
    gathers on others (mck 0: three references, or motion beyond its
    buckets; the first picture of each stream is the I picture); the P
    pictures hold both intra kinds."""
    mck = np.concatenate([refs[f"core_{n}_mck"][1:]
                          for n in tds.DEVICE_STREAMS])
    assert (mck == 0).any() and (mck > 0).any()
    p_kinds = np.concatenate([k for k, has_ref, _ in core_calls(
        refs, "x264_ref1", monkeypatch) if has_ref])
    assert {5, 6} <= set(p_kinds.tolist())


@pytest.mark.parametrize("name", tds.DEVICE_STREAMS)
def test_core_equals_jax(refs, name, monkeypatch):
    calls = core_calls(refs, name, monkeypatch)
    assert len(calls) == len(refs[f"core_{name}_mck"])
    for i, (_, _, planes) in enumerate(calls):
        for p, got in zip("yuv", planes):
            np.testing.assert_array_equal(
                got, refs[f"core_{name}_{i}_{p}"],
                err_msg=f"{name} picture {i} plane {p}")


@pytest.mark.parametrize("name", tds.DEVICE_STREAMS)
def test_decode_equals_jax_batched(refs, name, monkeypatch):
    """Every picture through decode_frame_core gives the planes and
    metadata of the JAX decoder that batched them."""
    taken = []
    core = dd.decode_frame_core
    monkeypatch.setattr(dd, "decode_frame_core",
                        lambda *a, **k: taken.append(1) or core(*a, **k))
    got = tds.decode_record(H264Decoder(use_device=True, device="cpu"),
                            stream(refs, name))
    assert len(taken) == len(got["poc"])       # every picture on the route
    assert refs[f"batch_{name}_gops"].max() >= 2
    for k, v in got.items():
        np.testing.assert_array_equal(v, refs[f"batch_{name}_{k}"],
                                      err_msg=f"{name} {k}")


@pytest.mark.parametrize("case", ["all_intra", "scattered_intra"])
def test_wavefront_equals_raster_order(refs, case, monkeypatch):
    """Stage C's anti-diagonal steps give the JAX package's raster loop:
    the I picture of x264_ref3 (all MBs intra, I16 and I4x4) and its last
    P picture, whose intra MBs of both kinds lie apart between inter
    ones."""
    calls = core_calls(refs, "x264_ref3", monkeypatch)
    i = 0 if case == "all_intra" else len(calls) - 1
    kinds, has_ref, planes = calls[i]
    intra = kinds >= 5
    if case == "all_intra":
        assert not has_ref and intra.all()
    else:
        assert has_ref and 0 < intra.sum() < intra.size
        assert {5, 6} <= set(kinds[intra].tolist())
        rows = np.flatnonzero(intra) // (tds.W // 16)
        assert len(set(rows.tolist())) > 1    # not one wavefront step
    for p, got in zip("yuv", planes):
        np.testing.assert_array_equal(got, refs[f"core_x264_ref3_{i}_{p}"])


def test_8x8_slices_refused_where_jax_refuses(refs, monkeypatch):
    """On a CAVLC --8x8dct stream the port's device route takes the same
    slices as the JAX package's; the P slices with 8x8-transformed MBs
    that it refuses parse when the raw outputs are asked for (the CABAC
    transcode's call), which is the fault a decoder calling parse_slice
    with its default would meet; the decode equals the host route's."""
    taken, raw_ok = [], []
    syntax, parse = dd.parse_slice_syntax, native_parse.parse_slice

    def rec(*a, **k):
        res = syntax(*a, **k)
        taken.append(res is not None)
        return res

    def both(rbsp, bitpos, slice_type, *a, **k):
        assert k == {"want_raw": False}
        res = parse(rbsp, bitpos, slice_type, *a, **k)
        if res is None and slice_type == 0:
            raw = parse(rbsp, bitpos, slice_type, *a)
            raw_ok.append(raw is not None and bool(raw["t8"].any()))
        return res

    monkeypatch.setattr(dd, "parse_slice_syntax", rec)
    monkeypatch.setattr(native_parse, "parse_slice", both)
    bs = stream(refs, "x264_8x8")
    dev = H264Decoder(use_device=True, device="cpu").decode(bs)
    assert taken == refs["t8_taken"].tolist()
    # four P slices, each with 8x8-transformed MBs
    assert not any(taken) and raw_ok == [True] * 4
    host = H264Decoder().decode(bs)
    for a, b in zip(dev, host):
        for p in "yuv":
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
