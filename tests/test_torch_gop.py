"""GOP-parallel encoding (x264vfw_tpu_torch/parallel/gop.py) and the
session's shard route for --threads N > 1 over several devices, held to
the JAX package's committed outputs (tests/jax_refs/parallel.npz,
written by tools/make_torch_jax_refs.py parallel on the JAX package's
8-device host mesh).

The port stands in for the mesh with a device list that names the CPU
several times, and with "cpu" and "cpu:0", two distinct devices, for the
round robin over distinct devices.
"""

import numpy as np
import pytest
import torch

import oracle
import torch_jax_refs
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.config.params import EncoderParams
from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
from x264vfw_tpu_torch.parallel import gop

# encode_clip_gop_parallel: JAX's test_gop_sharding_on_mesh
GOP_CFG = dict(width=48, height=48, qp=26, keyint=3, search_range=4,
               deblock=True)
GOP_N = 4                   # GOPs of keyint frames
# the session: JAX's test_threads_session.py
W, H, N, GOP = 96, 64, 8, 4
THREADS_CMD = (f"--qp 26 --bframes 0 --ref 1 --no-mbtree --weightp 0 "
               f"--scenecut 0 --keyint {GOP} --merange 4")
CABAC = ("--no-cabac", "--cabac")
DOWNGRADE_CMD = "--threads 8 --bframes 3 --qp 26"
MESH = 8                    # the JAX mesh's devices


def gop_frames() -> list:
    n = GOP_N * GOP_CFG["keyint"]
    w, h = GOP_CFG["width"], GOP_CFG["height"]
    clip = oracle.make_test_clip(w, h, n, seed=3)
    fsz, csz = w * h, w * h // 4
    return [(clip[i, :fsz].reshape(h, w),
             clip[i, fsz:fsz + csz].reshape(h // 2, w // 2),
             clip[i, fsz + csz:].reshape(h // 2, w // 2)) for i in range(n)]


def threads_clip() -> list:
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 64 + 64 * np.sin(xx / 9.0) + 48 * np.cos(yy / 7.0)
    tex = rng.integers(-18, 19, (H, W))
    out = []
    for k in range(N):
        y = np.clip(base + np.roll(tex, 2 * k, axis=1), 0, 255) \
            .astype(np.uint8)
        out.append((y, np.full((H // 2, W // 2), 120, np.uint8),
                    np.full((H // 2, W // 2), 136, np.uint8)))
    return out


def run_session(sess) -> tuple:
    """Every compress() return and end()'s tail."""
    sess.begin(W, H)
    outs = [sess.compress(f, "i420") for f in threads_clip()]
    return outs, sess.end()["tail"]


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("parallel")


def test_clip_equals_jax_and_the_per_frame_encoder(refs):
    frames = gop_frames()
    cfg = EncoderConfig(**GOP_CFG)
    stream = gop.encode_clip_gop_parallel(frames, cfg, devices=["cpu"] * MESH)
    assert stream == refs["gop_stream"].tobytes()
    enc = TorchEncoder(cfg, device="cpu")
    assert stream == b"".join(enc.encode_frame(*f) for f in frames)
    # two distinct devices ("cpu" and "cpu:0") in turns
    assert gop.encode_clip_gop_parallel(frames, cfg,
                                        devices=["cpu", "cpu:0"]) == stream
    dec = oracle.decode_h264_planes(stream)
    assert dec is not None and dec[0].shape[0] == len(frames)
    ps = oracle.psnr(dec[0][0].astype(float), frames[0][0].astype(float))
    assert ps > 28, f"IDR PSNR {ps}"


@pytest.mark.parametrize("cabac", CABAC)
def test_sharded_session_equals_jax_and_threads_1(refs, cabac):
    sess = CompressSession(EncoderParams(), device="cpu",
                           devices=["cpu"] * MESH,
                           extra_cmdline=f"{THREADS_CMD} --threads 8 {cabac}")
    outs, tail = run_session(sess)
    assert sess._shard and isinstance(sess._pipe, gop.GopShardPipeline)
    # one batch of MESH GOPs: every AU comes out of end()
    assert sess.frames_info().delay == MESH * GOP - 1
    want = torch_jax_refs.aus(refs, f"threads{cabac}_out")
    assert len(want) == N and outs == want
    assert tail == refs[f"threads{cabac}_tail"].tobytes()
    single = CompressSession(EncoderParams(), device="cpu",
                             extra_cmdline=f"{THREADS_CMD} --threads 1 "
                                           f"{cabac}")
    s_outs, s_tail = run_session(single)
    assert b"".join(s_outs) + s_tail == b"".join(outs) + tail


def test_downgrade_messages_equal_jax(refs):
    sess = CompressSession(EncoderParams(), extra_cmdline=DOWNGRADE_CMD,
                           device="cpu", devices=["cpu"] * MESH)
    msgs = []
    sess.log.sink = lambda lvl, m: msgs.append(m)
    sess.begin(W, H)
    assert msgs == list(refs["downgrade_log"])
    p, cfg = sess.params, sess.encoder.cfg
    assert (p.ref, p.weightp, p.mbtree, p.scenecut) == (1, 0, False, 0)
    assert (cfg.bframes, cfg.num_ref_frames, cfg.weightp, cfg.scenecut,
            sess.mbtree) == (0, 1, 0, 0, None)
    assert sess._pipe.G == min(p.keyint, 32)


@pytest.mark.parametrize("cmd,devices", [
    ("--threads 8", ["cpu"]),          # one device in the list
    ("--threads 8", None),             # a CPU session's default: [cpu]
    ("--threads 8 --psnr", ["cpu"] * MESH),   # a measuring session
])
def test_no_shard(cmd, devices):
    sess = CompressSession(EncoderParams(), device="cpu", devices=devices,
                           extra_cmdline=f"{THREADS_CMD} {cmd}")
    sess.begin(W, H)
    assert not sess._shard
    assert not isinstance(sess._pipe, gop.GopShardPipeline)


def test_cuda_device_list_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompressSession(device="cpu", devices=["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gop.encode_clip_gop_parallel(gop_frames()[:1],
                                     EncoderConfig(**GOP_CFG))


@pytest.mark.parametrize("field,value", [("num_ref_frames", 2),
                                         ("weightp", 1), ("bframes", 1)])
def test_unsupported_features_raise(field, value):
    cfg = EncoderConfig(**{**GOP_CFG, field: value})
    with pytest.raises(NotImplementedError, match="GOP-parallel"):
        gop.encode_clip_gop_parallel(gop_frames()[:1], cfg, devices=["cpu"])
