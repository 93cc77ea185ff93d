"""--psnr/--ssim telemetry of the port's CompressSession against the JAX
package's, exactly.

A measuring session (the flags at log level 2 or more) runs per frame,
keeps each source frame until its AU comes out and measures it against
the encoder's own reconstruction (TorchEncoder.pop_recon; B frames'
recons from encode_b_slots(want_recon=True), not deblocked, as in the
JAX package).  Three lines at 64x48: I and P frames with --psnr --ssim,
B frames through the per-frame B scheduler with --psnr, and the default
session (x264's --preset medium) with --psnr, which measuring sends per
frame.  Every compress() return, the tail, end()'s stats (PSNR per plane,
Avg, Global, SSIM, kb/s) and the whole log, the per-frame "frame=" lines
included, equal the JAX package's with ==.  The JAX sessions' outputs
are committed in tests/jax_refs/surface.npz (tools/make_torch_jax_refs.py
surface, hash-guarded).  Below log level 2 the flags are ignored, as in
the JAX package.  Tolerance: none (the FFmpeg cross-check of the B line
compares float means to 1e-9).
"""

import numpy as np
import pytest
import torch

import oracle
import torch_jax_refs
from test_torch_session import moving_clip
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream.mb_syntax import SLICE_B
from x264vfw_tpu_torch.bitstream.nal import NAL_SLICE
from x264vfw_tpu_torch.encode import device_finalize as dfin
from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
from x264vfw_tpu_torch.utils.metrics import frame_psnr_yuv

W, H = 64, 48
# name -> (command line, frames, clip seed)
LINES = {
    "ip": ("--qp 28 --bframes 0 --no-mbtree --no-cabac --merange 4 "
           "--psnr --ssim", 5, 3),
    "b": ("--qp 30 --bframes 2 --no-mbtree --no-cabac --no-deblock "
          "--merange 4 --psnr", 7, 5),
    "medium": ("--psnr", 6, 9),
}


def clip(name):
    _, n, seed = LINES[name]
    return moving_clip(W, H, n, seed=seed)


def run(session, frames):
    """(compress() returns, end() stats) of a session over frames."""
    session.begin(W, H)
    outs = [session.compress(f) for f in frames]
    return outs, session.end()


def stats_arrays(stats):
    """end()'s numbers as the arrays surface.npz keeps: frames and kb/s,
    PSNR y, u, v, Avg, Global where measured, SSIM where measured."""
    out = {"kbps": np.float64(stats["kbps"]),
           "frames": np.int64(stats["frames"])}
    if "psnr" in stats:
        out["psnr"] = np.array([stats["psnr"][k] for k in
                                ("y", "u", "v", "global", "global_all")],
                               np.float64)
    if "ssim" in stats:
        out["ssim"] = np.float64(stats["ssim"])
    return out


@pytest.fixture(scope="module")
def jax_refs():
    return torch_jax_refs.load("surface")


@pytest.fixture(scope="module")
def port_runs():
    """The port's session per line: (session, compress() returns, stats)."""
    runs = {}
    for name, (cmd, _, _) in LINES.items():
        s = CompressSession(extra_cmdline=cmd, device="cpu")
        runs[name] = (s, *run(s, clip(name)))
    return runs


@pytest.mark.parametrize("name", list(LINES))
def test_session_equals_jax(jax_refs, port_runs, name):
    s, outs, stats = port_runs[name]
    assert s._pipe is None and s.encoder.measure
    assert outs == torch_jax_refs.aus(jax_refs, f"{name}_out")
    assert stats["tail"] == jax_refs[f"{name}_tail"].tobytes()
    got = stats_arrays(stats)
    for k in ("kbps", "frames", "psnr", "ssim"):
        assert (k in got) == (f"{name}_{k}" in jax_refs), k
        assert k not in got or np.array_equal(got[k],
                                              jax_refs[f"{name}_{k}"]), k
    assert s.encoder._recon_q == {} and s._src_q == {}


@pytest.mark.parametrize("name", list(LINES))
def test_log_lines_equal_jax(jax_refs, port_runs, name):
    """Every log message, the per-frame "frame=" lines and the end-of-
    encode PSNR/SSIM lines among them, in order."""
    s, _, _ = port_runs[name]
    msgs = [m for _, m in s.log.history]
    assert msgs == [str(m) for m in jax_refs[f"{name}_log"]]
    frames = [m for m in msgs if m.startswith("frame=")]
    assert len(frames) == LINES[name][1]
    assert any("type=B" in m for m in frames) == (name != "ip")
    assert all(("ssim_y=" in m) == (name == "ip") for m in frames)


def test_b_frame_psnr_is_the_decoded_streams(port_runs):
    """With the loop filter off every recon, the B frames' too, is what
    stock FFmpeg decodes from the stream: the session's mean PSNR is the
    mean of PSNR(source, decoded frame)."""
    frames = clip("b")
    _, outs, stats = port_runs["b"]
    dec = oracle.decode_h264_planes(b"".join(outs) + stats["tail"])
    assert dec is not None and dec[0].shape[0] == len(frames)
    want = [frame_psnr_yuv(frames[i], (dec[0][i], dec[1][i], dec[2][i]))
            for i in range(len(frames))]
    for k in ("y", "u", "v", "global"):
        assert abs(stats["psnr"][k] - np.mean([w[k] for w in want])) < 1e-9


def test_flags_ignored_below_log_level_2():
    """At log level 1 (warning) --psnr --ssim are ignored, as in the JAX
    package: nothing is measured, the session batches as it would without
    them, and the bytes are those of the session without them."""
    frames = clip("ip")[:2]
    base = LINES["ip"][0].replace(" --psnr --ssim", "")
    quiet = CompressSession(extra_cmdline=base + " --psnr --ssim "
                            "--log-level warning", device="cpu")
    outs, stats = run(quiet, frames)
    assert quiet._pipe is not None and not quiet.encoder.measure
    assert "psnr" not in stats and "ssim" not in stats
    assert not any(m.startswith("frame=") for _, m in quiet.log.history)
    plain = CompressSession(extra_cmdline=base, device="cpu")
    outs2, stats2 = run(plain, frames)
    assert (outs, stats["tail"]) == (outs2, stats2["tail"])


def test_encode_b_slots_without_recon_unchanged():
    """encode_b_slots(want_recon=False), the default, returns the slot rows
    alone, as before B recons were ported; want_recon=True returns the
    same rows and the recon planes."""
    enc = TorchEncoder(EncoderConfig(width=W, height=H, search_range=4,
                                     bframes=2), device="cpu")
    f0, f1, f2 = clip("b")[:3]
    refs = [tuple(torch.as_tensor(np.asarray(p, np.int32)) for p in f)
            for f in (f0, f2)]
    src = torch.from_numpy(enc.pack_batch_rows([f1])[0])
    hv, hl = enc._header_slots(SLICE_B, NAL_SLICE, nal_ref_idc=0)
    mvcol = torch.zeros(enc.mbh * enc.mbw, 2, dtype=torch.int32)
    args = (src, *refs[0], *refs[1], mvcol, 30, 30, hv, hl, 4, 2)
    plain = dfin.encode_b_slots(*args)
    both = dfin.encode_b_slots(*args, want_recon=True)
    assert len(plain) == 2 and len(both) == 5
    assert all(torch.equal(a, b) for a, b in zip(plain, both[:2]))
    assert [tuple(p.shape) for p in both[2:]] == [(H, W), (H // 2, W // 2),
                                                  (H // 2, W // 2)]
