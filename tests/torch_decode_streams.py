"""The streams of the decoder tests (test_torch_decode_*.py) and the helpers
that read them.

make_streams() writes them (tools/make_torch_jax_refs.py decode puts them
into tests/jax_refs/decode.npz with the JAX package's outputs): libx264
streams from tests/oracle.py and the JAX package's CompressSession, whose
bytes the port's sessions equal (test_torch_session.py and the other
session tests), and access units committed for those tests.  The tests
read the committed bytes and import neither libx264 nor an encoder.
"""

from __future__ import annotations

import struct

import numpy as np

W, H = 64, 48

# CAVLC I/P streams of the device route: (x264 options, seed); the clip
# pastes new texture into scattered MBs from frame 2, so that P frames
# hold I16 and I4x4 MBs between inter ones
X264_DEVICE = {
    # one reference, small motion: the JAX package's static-shift MC
    "x264_ref1": ("no-cabac=1:bframes=0:ref=1:weightp=0:8x8dct=0:"
                  "threads=1", 4),
    # three references: its gather MC
    "x264_ref3": ("no-cabac=1:bframes=0:ref=3:weightp=0:8x8dct=0:"
                  "threads=1", 5),
    # two references, loop filter off
    "x264_nodb": ("no-cabac=1:bframes=0:ref=2:weightp=0:8x8dct=0:"
                  "threads=1:no-deblock=1", 6),
}
# the port's own CAVLC line with I4x4 and two references (chip_smoke.py's
# third decode stream)
FASTER_ZL = ("--preset faster --tune zerolatency --no-cabac --no-8x8dct "
             "--weightp 0 --qp 26")
DEVICE_STREAMS = tuple(X264_DEVICE) + ("faster_zl", "slice1")

_B_BASE = ("bframes=2:b-adapt=0:b-pyramid=none:cabac=0:ref=1:weightp=0:"
           "weightb=0:8x8dct=0:partitions=none:keyint=30:scenecut=0:"
           "threads=1:direct=spatial:no-mbtree=1:rc-lookahead=0:subme=2")
# libx264 streams of the host route: (x264 options, frames, qp)
X264_HOST = {
    "x264_cabac_b": (_B_BASE.replace("cabac=0", "cabac=1"), 8, 26),
    "x264_temporal": (_B_BASE.replace("direct=spatial", "direct=temporal"),
                      8, 26),
    "x264_slices": ("slices=3:bframes=0:8x8dct=0:partitions=none:"
                    "keyint=30:scenecut=0:no-mbtree=1:rc-lookahead=0:"
                    "subme=2:threads=1", 4, 26),
    "x264_ipcm": ("no-cabac=1:bframes=0:8x8dct=0:partitions=i4x4:keyint=1:"
                  "no-mbtree=1:rc-lookahead=0:threads=1", 2, 0),
    # CAVLC with the 8x8 transform: the device route refuses every slice
    # (I8x8 MBs in the I slice, 8x8-transformed inter MBs in the P slices)
    "x264_8x8": ("no-cabac=1:bframes=0:weightp=0:8x8dct=1:ref=1:"
                 "partitions=p8x8,i4x4:threads=1", 5, 28),
}
# the port's own lines, as committed for the session tests:
# (file, access-unit prefix, tail key or None)
COMMITTED = {
    "slice1": ("slice1", "64x48", None),        # CAVLC, no loop filter
    "slice2": ("slice2", "session", None),      # CAVLC, P8x8, deblock
    "veryfast": ("live", "veryfast", None),     # CABAC, I4x4, 8x8, weightp
    "vf_batched": ("batched", "veryfast_out", "veryfast_tail"),  # B frames
    "medium": ("multiref", "medium_out", "medium_tail"),  # ref 3, B, trellis
}
HOST_STREAMS = ("slice2", "veryfast", "vf_batched", "medium") \
    + tuple(X264_HOST)
# DecompressSession: output formats on a device-route stream, display
# order on a stream with B frames, and the scaler's sizes
SESSION_STREAM = "faster_zl"
REORDER_STREAM = "vf_batched"
SCALES = ((32, 24), (96, 72))
DRAINS = 2


def patched_clip(w: int, h: int, n: int, seed: int) -> np.ndarray:
    """oracle.make_test_clip with new texture (noise or a ramp) pasted into
    a quarter of the MBs of every frame from frame 2: (n, w*h*3//2)."""
    import oracle
    clip = oracle.make_test_clip(w, h, n, seed=seed).copy()
    rng = np.random.default_rng(seed + 100)
    mbw, mbh = w // 16, h // 16
    for f in range(2, n):
        y = clip[f, :w * h].reshape(h, w)
        for k in rng.choice(mbw * mbh, size=max(2, mbw * mbh // 4),
                            replace=False):
            my, mx = divmod(int(k), mbw)
            if rng.random() < 0.5:
                patch = rng.integers(0, 256, (16, 16))
            else:
                patch = np.clip(np.add.outer(np.arange(16) * 8,
                                             np.arange(16) * 3)
                                + rng.integers(0, 200), 0, 255)
            y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = patch
    return clip


def make_streams() -> dict:
    """{name: Annex-B bytes} of every stream (libx264 and the JAX
    package's CompressSession; for the maker script only)."""
    import oracle
    import torch_jax_refs as refs
    import test_torch_session as ts
    from x264vfw_tpu.api import CompressSession
    out = {}
    for name, (opts, seed) in X264_DEVICE.items():
        out[name] = oracle.encode_x264(patched_clip(W, H, 5, seed), 5, W, H,
                                       qp=30, preset="medium", x264opts=opts)
    for i, (name, (opts, n, qp)) in enumerate(X264_HOST.items()):
        if name == "x264_ipcm":
            clip = np.random.default_rng(17).integers(
                0, 256, (n, W * H * 3 // 2)).astype(np.uint8)
        else:
            clip = oracle.make_test_clip(W, H, n, seed=30 + i)
        out[name] = oracle.encode_x264(clip, n, W, H, qp=qp, preset="medium",
                                       x264opts=opts)
    s = CompressSession(extra_cmdline=FASTER_ZL)
    s.begin(W, H)
    aus = [s.compress(f) for f in ts.moving_clip(W, H, 4, seed=64)]
    out["faster_zl"] = b"".join(aus) + s.end()["tail"]
    for name, (file, prefix, tail) in COMMITTED.items():
        r = refs.load(file)
        out[name] = b"".join(refs.aus(r, prefix)) + (
            r[tail].tobytes() if tail else b"")
    return out


def split_aus(stream: bytes) -> list:
    """Annex-B access units of a stream of single-slice pictures: each
    slice NAL with the NALs before it."""
    from x264vfw_tpu_torch.bitstream.nal import START_CODE_LONG, \
        iter_annexb_raw
    aus, cur = [], b""
    for nal in iter_annexb_raw(stream):
        cur += START_CODE_LONG + nal
        if nal[0] & 0x1F in (1, 5):
            aus.append(cur)
            cur = b""
    return aus


def decode_record(dec, stream: bytes, meta: bool = True) -> dict:
    """Decode `stream` with an H264Decoder (the port's or the JAX
    package's) and return its frames as arrays: planes, POC and frame_num
    in decode order and, with meta, each Frame's metadata, refid0 as the
    decode index of the referenced picture (-1 for none)."""
    ids, kept = {}, []
    emit = dec._emit_frame

    def keep(frame, *a):
        ids[id(frame) % (1 << 62)] = len(kept)
        kept.append(frame)          # keeps every id unique
        return emit(frame, *a)

    dec._emit_frame = keep
    frames = dec.decode(stream)
    out = {p: np.stack([np.asarray(getattr(f, p), np.uint8) for f in frames])
           for p in "yuv"}
    for k in ("poc", "frame_num", "is_ref"):
        out[k] = np.array([int(getattr(f, k)) for f in frames])
    if not meta:
        return out
    for k in ("is_idr", "idr_epoch"):
        out[k] = np.array([int(getattr(f, k)) for f in frames])
    for k in ("mb_types", "qps", "mvs", "refs"):
        out[k] = np.stack([np.asarray(getattr(f, k), np.int64)
                           for f in frames])
    r0 = np.stack([np.asarray(f.refid0, np.int64) for f in frames])
    out["refid0"] = np.vectorize(lambda x: ids.get(int(x), -2) if x >= 0
                                 else -1, otypes=[np.int64])(r0)
    return out


def run_session(sess, aus: list, **begin) -> list:
    """Every decompress() return for `aus`, then DRAINS calls with b""."""
    sess.begin(W, H, **begin)
    outs = [sess.decompress(au) for au in aus]
    outs += [sess.decompress(b"") for _ in range(DRAINS)]
    sess.end()
    return [o if isinstance(o, tuple) else (o,) for o in outs]


def mp4_samples(data: bytes):
    """(avcC record, [sample bytes]) of a non-fragmented MP4 with one
    track whose samples follow the mdat header in decode order (as
    output/mp4.py writes them)."""
    def payload(tag: bytes) -> bytes:
        at = data.index(tag)
        size = struct.unpack(">I", data[at - 4:at])[0]
        return data[at + 4:at - 4 + size]

    avcc = payload(b"avcC")
    stsz = payload(b"stsz")
    count = struct.unpack(">I", stsz[8:12])[0]
    sizes = struct.unpack(f">{count}I", stsz[12:12 + 4 * count])
    pos = data.index(b"mdat") + 4
    samples = []
    for n in sizes:
        samples.append(data[pos:pos + n])
        pos += n
    return avcc, samples
