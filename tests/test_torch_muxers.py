"""The port's muxers (output/{raw,mkv,mp4,flv,avi}.py) and avcC record
(bitstream/avcc.py) against the JAX package's, byte for byte.

One fixed list of access units goes through each of the port's and the
JAX package's five muxers as the session drives them (parameter sets
stripped, dts one frame behind with B frames): the B-frame line of
test_torch_telemetry.py (64x48, I P B B P B B, so pts != dts), its AUs as
the JAX session emitted them (committed in tests/jax_refs/surface.npz).
The files must be equal, and stock FFmpeg must demux each into the
frames it decodes from the raw stream.  Also the Matroska cluster split
(a timecode step beyond the int16 range) and fragmented MP4 on a target
that cannot seek, as tests/test_muxers.py checks the JAX side.  Only
host code runs: nothing is compiled.
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from x264vfw_tpu.bitstream import avcc as jax_avcc
from x264vfw_tpu.bitstream.nal import annexb_to_avcc as jax_annexb_to_avcc
from x264vfw_tpu.output import base as jax_base
from x264vfw_tpu.output.mp4 import Mp4Muxer as JaxMp4Muxer
from x264vfw_tpu_torch.api import _strip_parameter_sets
from x264vfw_tpu_torch.bitstream import avcc
from x264vfw_tpu_torch.bitstream.nal import annexb_to_avcc, iter_annexb_raw
from x264vfw_tpu_torch.output import base
from x264vfw_tpu_torch.output.mp4 import Mp4Muxer

W, H = 64, 48
EXTS = ("264", "mkv", "mp4", "flv", "avi")


@pytest.fixture(scope="module")
def aus():
    """[(access unit, pts, keyframe)] in decode order, the parameter sets
    (sps, pps) and the raw stream's decoded planes."""
    refs = torch_jax_refs.load("surface")
    items = list(zip(torch_jax_refs.aus(refs, "mux_au"),
                     refs["mux_pts"].tolist(), refs["mux_key"].tolist()))
    nals = list(iter_annexb_raw(items[0][0]))
    sps = next(n for n in nals if n[0] & 0x1F == 7)
    pps = next(n for n in nals if n[0] & 0x1F == 8)
    dec = oracle.decode_h264_planes(b"".join(au for au, _, _ in items))
    assert dec is not None and dec[0].shape[0] == len(items)
    assert [p for _, p, _ in items] != sorted(p for _, p, _ in items)
    return items, sps, pps, dec


class PipeLike:
    """A file object that refuses to seek, like a pipe or a socket."""

    def __init__(self, f):
        self._f = f

    def write(self, b):
        return self._f.write(b)

    def seekable(self):
        return False

    def seek(self, *a):
        raise OSError("not seekable")


def mux(pkg, target, aus, ext=None, fps=(25, 1), step=1, cls=None):
    """Write aus through pkg's muxer for target's extension (or cls) the
    way CompressSession does: parameter sets stripped, dts one frame
    behind (B frames), timestamps step ticks apart."""
    items, sps, pps, _ = aus
    m = cls() if cls else pkg.select_muxer(target if isinstance(target, str)
                                           else "", ext)
    m.open_file(target)
    m.set_param(pkg.MuxParams(width=W, height=H, fps_num=fps[0],
                              fps_den=fps[1], timebase_num=fps[1],
                              timebase_den=fps[0]))
    m.write_headers(sps, pps)
    largest = second = 0
    for i, (au, pts, _) in enumerate(items):
        payload, key = _strip_parameter_sets(au)
        m.write_frame(payload, pts=pts * step, dts=max(0, i - 1) * step,
                      keyframe=key)
        if pts > largest:
            largest, second = pts, largest
        elif pts > second:
            second = pts
    m.close_file(largest * step, second * step)
    return m


def assert_decodes(path, aus):
    out = oracle.decode_container(path)
    assert out is not None, f"FFmpeg could not read {path}"
    for got, want in zip(out[:3], aus[3]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("ext", EXTS)
def test_container_bytes_equal_jax(aus, tmp_path, ext):
    paths = {}
    for tag, pkg in (("port", base), ("jax", jax_base)):
        paths[tag] = str(tmp_path / f"{tag}.{ext}")
        m = mux(pkg, paths[tag], aus)
        assert m.name == {"264": "raw"}.get(ext, ext)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and len(got) > 0
    assert_decodes(paths["port"], aus)


def test_mkv_cluster_split_equals_jax(aus, tmp_path):
    """Timestamps 20 s apart at 1 fps: relative timecodes beyond int16
    close a cluster every two frames."""
    files = {}
    for tag, pkg in (("port", base), ("jax", jax_base)):
        path = str(tmp_path / f"{tag}.mkv")
        mux(pkg, path, aus, fps=(1, 1), step=20)
        with open(path, "rb") as f:
            files[tag] = f.read()
    assert files["port"] == files["jax"]
    assert files["port"].count(b"\x1f\x43\xb6\x75") > 2    # clusters
    assert_decodes(str(tmp_path / "port.mkv"), aus)


def test_fragmented_mp4_equals_jax(aus, tmp_path):
    """A target that cannot seek gets moof/mdat fragments."""
    files = {}
    for tag, cls in (("port", Mp4Muxer), ("jax", JaxMp4Muxer)):
        path = str(tmp_path / f"{tag}.mp4")
        with open(path, "wb") as raw:
            m = mux(base if tag == "port" else jax_base, PipeLike(raw), aus,
                    cls=cls)
        assert m.fragmented
        with open(path, "rb") as f:
            files[tag] = f.read()
    assert files["port"] == files["jax"] and b"moof" in files["port"]
    assert_decodes(str(tmp_path / "port.mp4"), aus)


def test_avcc_round_trip_equals_jax(aus):
    items, sps, pps, _ = aus
    for nls in (1, 2, 4):
        rec = avcc.build_avcc(sps, pps, nls)
        assert rec == jax_avcc.build_avcc(sps, pps, nls)
        assert avcc.parse_avcc(rec) == jax_avcc.parse_avcc(rec) \
            == ([sps], [pps], nls)
    with pytest.raises(ValueError):
        avcc.parse_avcc(b"\x00" * 8)
    for au, _, _ in items:
        assert annexb_to_avcc(au) == jax_annexb_to_avcc(au)


@pytest.mark.parametrize("path,want", [("out.264", "RawMuxer"),
                                       ("out.h264", "RawMuxer"),
                                       ("out.MKV", "MkvMuxer"),
                                       ("out.unknown", "RawMuxer")])
def test_select_muxer_by_extension(path, want):
    assert type(base.select_muxer(path)).__name__ == want
    assert type(jax_base.select_muxer(path)).__name__ == want
