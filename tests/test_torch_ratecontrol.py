"""Rate control, the port against the JAX package: ABR (--bitrate), two
passes (--pass 1 writes --stats, --pass 2 reads it), VBV and the QP
limits, on the per-frame path, the batched session and the GOP-parallel
route, at 64x48:

  * abr_frame: --preset veryfast --tune zerolatency --bitrate 300 over
    live_clip() (6 frames moving by (3, -2), a luma fade from frame 4),
    per frame: the session's _emit feeds each AU's size to rc.update;
  * vbv: the same with --vbv-maxrate 300 --vbv-bufsize 30.  The buffer
    is 2.5 frames at the rate: a buffer of 150 kbit holds a dozen of
    these frames at the QPs ABR picks here, and the clamp would never
    act; at 30 kbit it raises the QP of every P frame;
  * abr_batched: --preset veryfast --bitrate 300 over batched_clip() (30
    frames, B frames and MB-tree, two windows, a scene cut at 19, a
    flush): BatchPipeline._finalize feeds rc.update, a window after the
    QPs of the next were chosen;
  * pass1, pass2: the default session (x264's --preset medium, BASELINE
    config 3) with --bitrate 300 --pass 1 --stats <file>, then --pass 2
    with the same options over the same 16 frames of a moving texture
    (MB-tree's lookahead of 40 holds them all for the flush: I, anchors
    4 and 8 per frame while the DPB fills, 12 batched over three
    references, the tail anchor 15, 11 B frames).
    The options apply in order, as in the JAX package: --pass 1 --bitrate
    300 ends in ABR (--bitrate sets the mode after --pass did), writes no
    stats, and its --pass 2 does not read them (ROADMAP.md, section C,
    the reference's known state; test_pass_and_bitrate_parse_as_jax);
  * qplimits: the default session with --crf 23 --qpmin 20 --qpmax 34
    --qpstep 2 --ipratio 1.6 --pbratio 1.2 --qcomp 0.7 over those frames;
  * gop: --threads 4 --keyint 4 --bitrate 300 (the default session,
    downgraded) over the devices ["cpu", "cpu"]: 24 frames in three
    batches of two GOPs, one QP per frame type per batch, rc.update in
    GopShardPipeline._run.  The JAX side ran on a mesh of two devices.

Every compress() return, end()'s tail and kb/s and the (type, QP, bits)
rate control saw for each frame equal the JAX session's, from
tests/jax_refs/ratecontrol.npz (tools/make_torch_jax_refs.py
ratecontrol, hash-guarded by test_torch_session.py::
test_jax_references_are_current).  No batched P header of these lines
meets the stale weight table that test_torch_batched_live.py pins
(ROADMAP.md, section C): the JAX bytes hold whole.  Pass 1's stats file is
the JAX package's byte for byte, and pass 2 reads the port's.  Held are
the bytes, not the target: the JAX package's ABR misses it too
(tests/test_ratecontrol.py::test_abr_tracks_target fails there).
--pass 2 without its stats file raises what the JAX package raises.
Inputs come from numpy seeds; no tolerance.
"""

import numpy as np
import pytest

import torch_jax_refs
from test_torch_batched_live import batched_clip, departures, spied_session
from test_torch_live_presets import live_clip
from test_torch_session import moving_clip
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.config.options import parse_cmdline
from x264vfw_tpu_torch.parallel import gop

W, H = 64, 48
ABR_FRAME = "--preset veryfast --tune zerolatency --bitrate 300"
PER_FRAME = {"abr_frame": ABR_FRAME,
             "vbv": ABR_FRAME + " --vbv-maxrate 300 --vbv-bufsize 30"}
BATCHED = {"abr_batched": "--preset veryfast --bitrate 300",
           "qplimits": "--crf 23 --qpmin 20 --qpmax 34 --qpstep 2 "
                       "--ipratio 1.6 --pbratio 1.2 --qcomp 0.7"}
PASS = "--bitrate 300 --pass {n} --stats {stats}"
GOP_LINE = "--threads 4 --keyint 4 --bitrate 300"
GOP_DEVICES = 2
GOP_FRAMES = 24
MEDIUM_FRAMES = 16
LINES = (*PER_FRAME, *BATCHED, "pass1", "pass2", "gop")


def frame_clip() -> list:
    return live_clip(W, H, 6, seed=31)


def medium_clip(w: int = W, h: int = H, frames: int = MEDIUM_FRAMES) -> list:
    """The default session's frames: a texture moving by (3, -2) pixels
    per frame, no fade (no weights, so no stale weight table)."""
    return moving_clip(w, h, frames, seed=43, shift=(3, -2))


def gop_clip() -> list:
    return moving_clip(W, H, GOP_FRAMES, seed=44, shift=(2, 1))


def clip(line: str) -> list:
    if line in PER_FRAME:
        return frame_clip()
    if line == "abr_batched":
        return batched_clip()
    if line == "gop":
        return gop_clip()
    return medium_clip()


def rc_stats(session) -> list:
    return [(st.frame_type, st.qp, st.bits) for st in session.rc.stats]


def run_session(cmd: str, frames: list, **kw) -> dict:
    """A port session on the CPU: the compress() returns, end()'s tail and
    kb/s, rate control's (type, QP, bits) per frame."""
    s = CompressSession(extra_cmdline=cmd, device="cpu", **kw)
    s.begin(W, H)
    outs = [s.compress(f) for f in frames]
    end = s.end()
    return {"outs": outs, "tail": end["tail"], "kbps": end["kbps"],
            "rc_stats": rc_stats(s), "session": s}


def jax_rc_stats(refs, line: str) -> list:
    return list(zip(refs[f"{line}_rc_type"].tolist(),
                    refs[f"{line}_rc_qp"].tolist(),
                    refs[f"{line}_rc_bits"].tolist()))


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("ratecontrol")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    stats = str(tmp_path_factory.mktemp("rc") / "x264vfw.stats")
    runs = {name: run_session(cmd, clip(name))
            for name, cmd in PER_FRAME.items()}
    for name, cmd in BATCHED.items():
        runs[name] = spied_session(cmd, clip(name))
    for n in (1, 2):
        runs[f"pass{n}"] = spied_session(PASS.format(n=n, stats=stats),
                                         medium_clip())
        if n == 1:
            with open(stats, "rb") as fh:
                runs["pass1"]["stats_file"] = fh.read()
    runs["gop"] = run_session(GOP_LINE, gop_clip(),
                              devices=["cpu"] * GOP_DEVICES)
    return runs


@pytest.mark.parametrize("line", LINES)
def test_session_bytes_equal_jax(refs, port_runs, line):
    run = port_runs[line]
    want = torch_jax_refs.aus(refs, f"{line}_out") + [
        refs[f"{line}_tail"].tobytes()]
    assert len(want) - 1 == len(run["outs"]) == len(clip(line))
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{line}: compress() {i} differs"
    assert run["tail"] == want[-1]


@pytest.mark.parametrize("line", LINES)
def test_rate_control_saw_what_jax_saw(refs, port_runs, line):
    """Per frame in the order rc.update took them: the type, the QP and
    the bits; and end()'s kb/s."""
    run = port_runs[line]
    assert run["rc_stats"] == jax_rc_stats(refs, line)
    assert run["kbps"] == float(refs[f"{line}_kbps"])


def test_paths(port_runs):
    """Per frame, batched and sharded as the lines say, no batched header
    departing from the JAX package's; the QP moves frame to frame under
    ABR."""
    for name in PER_FRAME:
        assert port_runs[name]["session"]._pipe is None
    for name in (*BATCHED, "pass1", "pass2"):
        assert port_runs[name]["batched"], name
        assert departures(port_runs[name]) == {}, name
    s = port_runs["gop"]["session"]
    assert s._shard and isinstance(s._pipe, gop.GopShardPipeline)
    assert s._pipe.n_dev == GOP_DEVICES
    qps = [qp for _, qp, _ in port_runs["abr_frame"]["rc_stats"]]
    assert len(set(qps)) > 2, qps


def test_vbv_clamp_acts(port_runs):
    """The same frames without VBV: the I frame alike, and the buffer
    raises the QP of at least one P frame."""
    abr = port_runs["abr_frame"]["rc_stats"]
    vbv = port_runs["vbv"]["rc_stats"]
    assert abr[0] == vbv[0]
    raised = [i for i, (a, v) in enumerate(zip(abr, vbv)) if v[1] > a[1]]
    assert raised, (abr, vbv)


def test_two_pass_stats_file(refs, port_runs):
    """Pass 1's file is the JAX package's, one line per frame at pass 1's
    constant QP; pass 2's QPs come from it (not all pass 1's)."""
    data = port_runs["pass1"]["stats_file"]
    assert data == refs["pass1_stats"].tobytes()
    lines = data.decode().splitlines()
    assert len(lines) == MEDIUM_FRAMES
    p1 = [qp for _, qp, _ in port_runs["pass1"]["rc_stats"]]
    p2 = [qp for _, qp, _ in port_runs["pass2"]["rc_stats"]]
    assert p1 != p2
    assert len(port_runs["pass2"]["rc"]._stats_in) == MEDIUM_FRAMES
    assert port_runs["pass1"]["rc"].mode == "pass1"
    assert port_runs["pass2"]["rc"].mode == "pass2"


def test_qp_limits(port_runs):
    """--qpmin 20 --qpmax 34 bound every frame's QP."""
    qps = [qp for _, qp, _ in port_runs["qplimits"]["rc_stats"]]
    assert min(qps) >= 20 and max(qps) <= 34, qps


def test_pass_2_without_stats_raises_as_jax(tmp_path, monkeypatch):
    from x264vfw_tpu.api import CompressSession as JaxSession
    monkeypatch.chdir(tmp_path)
    errs = []
    for make in (lambda c: JaxSession(extra_cmdline=c),
                 lambda c: CompressSession(extra_cmdline=c, device="cpu")):
        for cmd in ("--bitrate 300 --pass 2",
                    "--bitrate 300 --pass 2 --stats missing.stats"):
            s = make(cmd)
            with pytest.raises(FileNotFoundError) as e:
                s.begin(W, H)
            errs.append(str(e.value))
    assert errs[:2] == errs[2:]
    assert "x264.stats" in errs[0] and "missing.stats" in errs[1]


@pytest.mark.parametrize("cmd,mode", [
    ("--pass 1 --bitrate 300", "abr"), ("--bitrate 300 --pass 1", "pass1"),
    ("--pass 2 --bitrate 300", "abr"), ("--bitrate 300 --pass 2", "pass2")])
def test_pass_and_bitrate_parse_as_jax(cmd, mode):
    """The last of --pass and --bitrate sets the mode, in both packages."""
    from x264vfw_tpu.config.options import parse_cmdline as jax_parse
    (jp, jw), (tp, tw) = jax_parse(cmd), parse_cmdline(cmd)
    assert tp.rc_mode == jp.rc_mode == mode
    assert (tp.pass_num, tp.bitrate, tw) == (jp.pass_num, jp.bitrate, jw)
