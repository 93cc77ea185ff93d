"""chip_smoke.py's own logic, rehearsed on the CPU.

The script runs on a CUDA card; here its phases run at a small size with
the CUDA calls stubbed and the plain versions of the SAD, memc and
deblock kernels counted as the kernels, so a later change that breaks a
phase or a check shows without a card: the two slice sessions, the
batched --preset ultrafast --crf 23 session (26 frames, two windows and a
flush), the hierarchical quarter-pel session with the loop filter, the
veryfast session (CABAC, I4x4, the 8x8 transform, AQ, weighted P) with
its kernels held against their plain versions, the batched veryfast
session with B frames and MB-tree (1 I, 7 P, 19 B) with its kernels held
against their plain versions on a P anchor's inputs, the default
session (x264's --preset medium: three references, trellis; 1 I, 4 P,
12 B) with the SAD and deblock kernels held against their plain versions
on its last anchor's DPB and maps, the measured default session (--psnr
--ssim, BGRA in, Matroska out; 1 I, 2 P, 6 B) with its SimpleBlocks read
back and deblock held against its plain version, card against CPU for
all fifteen command lines and the four lines of conversion, containers
and telemetry, and for the GOP-parallel route, the sharded session and
the transcode, the decoder (slice 2's, L4's and a --preset faster
--no-cabac stream read back on the device route, frames equal to the
encoder's reconstructions; card against CPU in every output format, on
a CABAC + B stream and on MP4 samples, and the scaler), the transcode
from the session size to half of it (the script's 4K to 1080p), the
GOP-parallel encode and the --threads 4 session on one device named
twice, x264's --preset placebo (20 frames: 1 I, 2 P, 17 B; the SAD
kernel held against its plain version on a B frame's L0 and L1 inputs
and on an anchor's deepest reference), the syntax-tensor CABAC route
against the transcode route (and on the card-vs-CPU clip in all four of
tests/test_cabac_transcode.py's configurations, beside the four presets'
sessions), and the command line.
Also: without a card the script exits non-zero and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_cuda_or_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.time()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    return cs


def test_rehearsal_on_cpu(monkeypatch, capsys):
    cs = _chip_smoke()
    from x264vfw_tpu_torch.encode import inter_partition as tip
    from x264vfw_tpu_torch.ops.kernels import build
    from x264vfw_tpu_torch.ops.kernels import deblock as dbk
    from x264vfw_tpu_torch.ops.kernels import memc as memck
    from x264vfw_tpu_torch.ops.kernels import sad as sadk

    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cs, "SESSION_SIZE", (128, 96))
    monkeypatch.setattr(cs, "SMALL_SIZE", (64, 48))
    monkeypatch.setattr(cs, "SAD_SHAPES", ((48, 64, 4), (32, 48, 6)))
    monkeypatch.setattr(cs, "MEMC_SHAPES", ((48, 64, 4), (32, 48, 6)))
    monkeypatch.setattr(cs, "SAD_FLAT", (32, 48, 3))
    monkeypatch.setattr(cs, "MEMC_EXTRA", (32, 64, 4))
    monkeypatch.setattr(cs, "DEBLOCK_MBS", ((3, 4), (2, 5)))
    # the B-frame lines' card-vs-CPU clip: a scene cut at frame 9, two
    # mini-GOPs before it, and four frames after it (the script's 30
    # frames with the cut at 19 on the card)
    monkeypatch.setattr(cs, "B_FRAMES", 14)
    monkeypatch.setattr(cs, "B_CUT", 9)
    # --preset placebo over 20 frames (the script's 74): the anchor 17
    # after 16 B frames, then the tail anchor 19 and one B frame
    monkeypatch.setattr(cs, "PLACEBO_FRAMES", 20)
    # the transcode from the session size (the script's 4K) to half of it
    monkeypatch.setattr(cs, "TC_SRC_SIZE", (128, 96))
    monkeypatch.setattr(cs, "TC_DST_SIZE", (64, 48))
    monkeypatch.setattr(cs, "card_line", lambda: "cpu, 0 W")
    monkeypatch.setattr(cs, "sm_clock_hz", lambda: 1.98e9)
    monkeypatch.setattr(cs, "sad_sass_per_sad4", lambda: None)
    # one timed run per call instead of the card's 20: the rehearsal
    # checks the script's logic, not the CPU's times
    cuda_ms = cs.cuda_ms
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: cuda_ms(fn, 1))
    # no CUDA graphs without a card: the calls back to back in a loop
    monkeypatch.setattr(cs, "cuda_ms_b2b", lambda fn, n=20, reps=5:
                        cs.cuda_ms(lambda: [fn() for _ in range(2)], 1) / 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(build, "build",
                        lambda names: {n: 0.0 for n in names})
    monkeypatch.setattr(build, "load", lambda name: None)

    def counted(mod, fn, step=lambda *a: 1):
        def run(*a, **k):
            mod.LAUNCHES += step(*a)
            return fn(*a, **k)
        return run

    # the plain versions stand in for the kernels, counted as launches
    sad = counted(sadk, sadk.sad_partition_minima)
    memc = counted(memck, memck.partition_refine_mc)
    monkeypatch.setattr(sadk, "sad_partition_minima", sad)
    monkeypatch.setattr(sadk, "sad_search_quad",
                        counted(sadk, sadk.sad_search_quad))
    monkeypatch.setattr(tip, "sad_partition_minima", sad)
    monkeypatch.setattr(memck, "partition_refine_mc", memc)
    monkeypatch.setattr(tip, "partition_refine_mc", memc)
    monkeypatch.setattr(dbk, "deblock_apply",
                        counted(dbk, dbk.deblock_apply))
    # the transcode decodes on the device route, as on the card (on the
    # CPU the port's transcode takes the host route)
    from x264vfw_tpu_torch.parallel import transcode as tcm

    class DeviceRoute(tcm.H264Decoder):
        def __init__(self, use_device=False, device=None):
            super().__init__(use_device=True, device=device)

    monkeypatch.setattr(tcm, "H264Decoder", DeviceRoute)
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "cpu", "count": 1}}
    kern = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kern] == ["sad_partition_minima",
                                         "partition_refine_mc",
                                         "deblock_apply"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "ms_b2b", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in kern)
    assert {"quad_ms", "quad_ms_b2b", "quad_bound_ms"} <= set(kern[0])
    # the batched veryfast phase: one SAD and memc per P anchor, one
    # deblock per I and P frame, none on its 19 B frames
    assert [k["launches"] for k in kern] == [7, 7, 8]
    # the per-frame veryfast phase: one SAD and memc per P frame, one
    # deblock per frame
    assert [k["veryfast_launches"] for k in kern] == [4, 4, 5]
    assert [k["slice2_launches"] for k in kern] == [5, 5, 6]
    # L3 runs none of the kernels, L4 the loop filter once per frame
    assert [k["l3_launches"] for k in kern] == [0, 0, 0]
    assert [k["l4_launches"] for k in kern] == [0, 0, 4]
    # --preset medium: the hierarchical search, one deblock per I and P
    # frame; with --me esa the SAD kernel once per reference of each P
    # frame (1, 2, 3, 3, then 1, 2 after the cut)
    assert [k["medium_launches"] for k in kern] == [0, 0, 5]
    assert [k["medium_esa_launches"] for k in kern] == [12, 0, 8]
    # the measured default session: one deblock per I and P frame
    assert [k["measured_launches"] for k in kern] == [0, 0, 3]
    # the decoder: one deblock per picture of slice 2's, L4's and the
    # decode line's streams (every picture on the device route)
    assert kern[2]["decode_launches"] == {"slice2": 6, "l4": 4,
                                          "faster_zl": 3}
    # the transcode: its source (1 IDR + 3 P, slice 2's options), then one
    # deblock per decoded picture (4) and per re-encoded I and P frame
    # (the default session's 4 frames: I, P, B, B)
    assert [k["transcode_4k_source_launches"] for k in kern] == [3, 3, 4]
    assert [k["transcode_4k_launches"] for k in kern] == [0, 0, 6]
    # the GOP-parallel route, two GOPs of 3 frames: one SAD and memc per P
    # frame, one deblock per frame; the session with --threads 4 --keyint
    # 4 (8 frames, 2 IDRs), the same
    assert [k["gop_1080p_launches"] for k in kern] == [4, 4, 6]
    assert [k["threads_launches"] for k in kern] == [6, 6, 8]
    # --preset placebo: the SAD kernel once per reference of each anchor
    # (1, then 2) and twice per B frame (17), one deblock per I and P frame
    assert [k["placebo_launches"] for k in kern] == [1 + 2 + 2 * 17, 0, 3]
    # the syntax-tensor CABAC route: full-feature (I + 4 P: SAD and memc
    # per P frame) and bframes (I, 2 P, 3 B: SAD once per P, twice per B)
    assert [k["host_cabac_launches"] for k in kern] == [4 + 8, 4, 5 + 3]
    phases = {ln.split("] ")[1].split(":")[0] for ln in lines
              if ln.startswith("[")}
    assert {"session_1080p_ultrafast_crf23", "session_1080p_hier_qpel_deblock",
            "session_1080p_veryfast", "session_1080p_veryfast_batched",
            "session_1080p_medium", "session_1080p_measured", "card_vs_cpu",
            "decode_1080p", "transcode_4k", "gop_1080p",
            "session_1080p_threads", "placebo_1080p", "host_cabac_1080p",
            "cli"} <= phases
    assert kern[2]["launches_per_frame"] == 1
    assert kern[0]["slice1_launches"] == 3
    H, W, R = kern[0]["shape"]     # one VABSDIFF4 per 4 byte differences
    assert kern[0]["int_bound_ms"] == pytest.approx(
        (2 * R + 1) ** 2 * H * W / 4 / (132 * 64 * 1.98e9) * 1e3)
    assert all(k["max_abs_err"] == 0 for k in kern)
    assert lines[-3] == "cpu, 0 W"


def test_sass_count_per_sad4():
    """The SASS reader behind the sad record's sass_per_sad4: mnemonics in
    program order from cuobjdump's listing, and instructions per 4-pixel
    SAD over the span from the first VABSDIFF4 to the last."""
    cs = _chip_smoke()
    text = """
        Function : _Z3sadv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   VABSDIFF4.U8.ACC R3, R2, R4, R3 ;
        /*0020*/              @!P0 PRMT R5, R2, 0x4321, R4 ;
        /*0030*/                   VABSDIFF4.U8.ACC R3, R5, R4, R3 ;
        /*0040*/                   EXIT ;
"""
    listing = cs.parse_sass(text)
    assert listing == {"_Z3sadv": ["LDC", "VABSDIFF4", "PRMT", "VABSDIFF4",
                                   "EXIT"]}
    assert cs.per_sad4(listing["_Z3sadv"]) == 1.5
    assert cs.per_sad4(["LDC", "EXIT"]) is None
