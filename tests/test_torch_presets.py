"""x264's last four presets, the port against the JAX package, each with
--min-keyint 2 on the batched session: --preset fast (ref 2, rc-lookahead
30), slower (ref 8, clamped to 4; umh; rc-lookahead 60), veryslow (ref
16, clamped to 4; 8 B frames; merange 24, clamped to 16) and placebo
(the same with 16 B frames and --me tesa: the exhaustive search, whose
SAD kernel runs once per reference on each P anchor and on each B frame
for L0 and for L1).  All four search P16x16 only (several references),
and take trellis, MB-tree, AQ, weightp, the 8x8 transform and CABAC;
fast also I4x4 (the other three's --partitions all selects neither P
partitions nor I4x4 in the JAX package's option mapping, and so in the
port's).

fast, slower and veryslow run over test_torch_multiref.multiref_clip(36)
(a scene cut at 19, an IDR with --min-keyint 2; a fade from 24 on);
placebo over PLACEBO_FRAMES frames of a moving texture: with MB-tree's
lookahead of 60 the batched session's first window of 12 is dispatched
only after 72 frames, so 74 frames give one window (the IDR and B
candidates 1-11, which wait in the pipeline's _pending_b), then the
flush's run: the anchors 17, 34 and 51 encoded per frame while the DPB
fills, 68 batched over a DPB of 4, and a part-filled B run closed by
the tail anchor 73 (_drain_pending).

Every compress() return, end()["tail"] and frames_info().delay equal the
JAX session's, from tests/jax_refs/presets.npz (tools/
make_torch_jax_refs.py presets, hash-guarded by test_torch_session.py::
test_jax_references_are_current), but for the departure
test_torch_batched_live.py pins (ROADMAP.md, section C): a JAX batched P
header carries the weight table of the last P frame encoded per frame,
once per active reference; the port's carries none.  Here that table is
shown to be the whole difference of fast and slower, and veryslow and
placebo have none.  Stock FFmpeg decodes veryslow's and placebo's
streams: the I and P frames to the port's own reconstruction, the B
frames above 30 dB.  Inputs come from numpy seeds; no tolerance.
"""

import dataclasses

import numpy as np
import pytest

import oracle
import torch_jax_refs
from test_torch_batched_live import departures, spied_session, with_departures
from test_torch_multiref import multiref_clip
from test_torch_session import moving_clip
from x264vfw_tpu_torch.bitstream.slice import SliceHeader
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode import pipeline as tpipe
from x264vfw_tpu_torch.utils.bitstream import BitReader

W, H = 64, 48
LINES = {"fast": "--preset fast --min-keyint 2",
         "slower": "--preset slower --min-keyint 2",
         "veryslow": "--preset veryslow --min-keyint 2",
         "placebo": "--preset placebo --min-keyint 2"}
MULTIREF_FRAMES = 36
PLACEBO_FRAMES = 74
WINDOW = 12
DEPARTING = ("fast", "slower")
DECODE = ("veryslow", "placebo")
# (references, B frames, the search, I4x4) after the clamps
PATHS = {"fast": (2, 3, "auto:hier", True),
         "slower": (4, 3, "auto:hier", False),
         "veryslow": (4, 8, "auto:hier", False),
         "placebo": (4, 16, "auto", False)}


def clip(name: str) -> list:
    if name == "placebo":
        return moving_clip(W, H, PLACEBO_FRAMES, seed=41, shift=(3, -2))
    return multiref_clip(MULTIREF_FRAMES)


def spied_preset(cmd: str, frames: list) -> dict:
    """spied_session, and: the sad16_argmin calls made inside B cores and
    outside them (the P anchors'), and for each _run of the batched
    pipeline the display indices it took in and those it put out."""
    keep_sad, keep_b = tdev.sad16_argmin, tdev.encode_b_frame_core
    keep_run = tpipe.BatchPipeline._run
    calls = {"b": 0, "p": 0}
    runs = []
    in_b = [False]

    def spy_sad(*a, **k):
        calls["b" if in_b[0] else "p"] += 1
        return keep_sad(*a, **k)

    def spy_b(*a, **k):
        in_b[0] = True
        try:
            return keep_b(*a, **k)
        finally:
            in_b[0] = False

    def spy_run(self, final):
        first = self.enc.display_idx
        out = keep_run(self, final)
        runs.append((range(first, self.enc.display_idx),
                     [it[1] for it in out]))
        return out

    tdev.sad16_argmin, tdev.encode_b_frame_core = spy_sad, spy_b
    tpipe.BatchPipeline._run = spy_run
    try:
        rec = spied_session(cmd, frames)
    finally:
        tdev.sad16_argmin, tdev.encode_b_frame_core = keep_sad, keep_b
        tpipe.BatchPipeline._run = keep_run
    rec.update(sad_calls=calls, runs=runs)
    return rec


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("presets")


@pytest.fixture(scope="module")
def port_runs():
    return {name: spied_preset(cmd, clip(name))
            for name, cmd in LINES.items()}


@pytest.mark.parametrize("name", list(LINES))
def test_session_bytes_equal_jax(refs, port_runs, name):
    """Bit for bit the JAX session's, once the stale weight tables are
    put in place of the port's headers (test_departure_is_the_weight_
    table_alone)."""
    run = port_runs[name]
    want = with_departures(torch_jax_refs.aus(refs, f"{name}_out")
                           + [refs[f"{name}_tail"].tobytes()], run)
    assert len(want) - 1 == len(run["outs"]) == len(clip(name))
    for i, (got, w) in enumerate(zip(run["outs"], want)):
        assert got == w, f"{name}: compress() {i} differs"
    assert run["tail"] == want[-1]
    assert run["delay"] == int(refs[f"{name}_delay"])


@pytest.mark.parametrize("name", list(LINES))
def test_departure_is_the_weight_table_alone(port_runs, name):
    """fast and slower: each departing batched P header is the JAX one
    with every field equal but the weight table, which JAX repeats once
    per active reference and the port leaves out.  veryslow and placebo
    depart nowhere: their bytes are the JAX package's."""
    run = port_runs[name]
    dep = departures(run)
    if name not in DEPARTING:
        assert dep == {}
        return
    assert dep
    enc = run["enc"]
    for d, (jax_h, port_h) in dep.items():
        jh, ph = (SliceHeader.parse(BitReader(np.frombuffer(b, np.uint8)),
                                    enc.sps, enc.pps, 1, 3)
                  for b in (jax_h, port_h))
        nref = run["batch_nref"][d]
        assert ph.luma_weights_l0 == [None] * nref, (name, d)
        assert jh.luma_weights_l0 == [jh.luma_weights_l0[0]] * nref
        assert jh.luma_weights_l0[0] is not None
        assert dataclasses.replace(jh, luma_weights_l0=ph.luma_weights_l0) \
            == ph, (name, d)


def test_sessions_take_their_paths(port_runs):
    """The clamped references, the B frames and the search per line; the
    IDRs (placebo's clip has no cut); every frame out once."""
    for name, run in port_runs.items():
        cfg, enc = run["cfg"], run["enc"]
        assert (enc.nref, cfg.bframes, cfg.me_backend, cfg.i4x4) == \
            PATHS[name], name
        assert cfg.subpel == 2 and cfg.search_range == 16 and run["batched"]
        assert cfg.trellis and cfg.dct8x8 and cfg.cabac and cfg.deblock
        assert not enc.partitions, name
        order = run["order"]
        assert sorted(d for d, _ in order) == list(range(len(clip(name))))
        idrs = [d for d, t in order if t == "I"]
        assert idrs == ([0] if name == "placebo" else [0, 19]), name


def test_placebo_searches_b_frames_exhaustively(port_runs):
    """placebo's B frames reach sad16_argmin twice each (L0, L1); each P
    anchor once per reference it searches (1, 2, 3 while the DPB fills,
    then 4); its first B run waits across the first window into the
    flush's run, which ends with a part-filled run (a tail P and 4 B)."""
    run = port_runs["placebo"]
    types = dict(run["order"])
    nb = sum(t == "B" for t in types.values())
    anchors = sorted(d for d, t in types.items() if t == "P")
    assert anchors == [17, 34, 51, 68, 73] and nb == PLACEBO_FRAMES - 6
    assert run["sad_calls"] == {"b": 2 * nb, "p": 1 + 2 + 3 + 4 + 4}
    (in0, out0), (in1, out1) = run["runs"]
    assert list(in0) == list(range(WINDOW)) and out0 == [0]
    assert set(range(1, WINDOW)) <= set(out1)     # B 1-11: from window 0
    assert out1[-5:] == [73, 69, 70, 71, 72]


@pytest.mark.parametrize("name", DECODE)
def test_stream_decodes_to_reconstruction(port_runs, name):
    """Stock FFmpeg decodes the whole stream: the I and P frames to the
    reference planes the encoder kept, the B frames above 30 dB."""
    run = port_runs[name]
    frames = clip(name)
    decoded = oracle.decode_h264(b"".join(run["outs"]) + run["tail"])
    assert decoded is not None and len(decoded) == len(frames)
    order = run["order"]
    anchors = [d for d, t in order if t != "B"]
    recon = dict(zip(anchors, run["recon"]))
    assert len(recon) == len(run["recon"])
    for d, t in order:
        y = decoded[d][:W * H].reshape(H, W)
        if t != "B":
            np.testing.assert_array_equal(y, recon[d],
                                          err_msg=f"{name} frame {d} ({t})")
        else:
            assert oracle.psnr(y, frames[d][0]) > 30.0, (name, d)
