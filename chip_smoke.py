"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port's main paths from csrc/ with nvcc (one
nvcc per source, in parallel) and holds each kernel against its plain
PyTorch version on the card: the full-search SAD (minima and quad mode),
partition_refine_mc and deblock_apply (and deblock_apply's repeated calls
against each other).  Then drives eight 1080p
CompressSessions on seeded clips of textured content:

  * slice 1, --preset ultrafast --tune zerolatency --me esa --qp 26
    (1 IDR + 3 P), which runs the SAD kernel once per P frame;
  * slice 2, the same plus --deblock 0:0 --partitions p8x8 --subme 7
    (1 IDR + 5 P), which runs the SAD and partition_refine_mc kernels once
    per P frame and deblock_apply once on every frame;
  * L3, x264's --preset ultrafast --crf 23 (26 frames: two windows of the
    batched session and a flush), whose hierarchical search is plain
    PyTorch and runs none of the kernels;
  * L4, --preset ultrafast --tune zerolatency --qp 26 --subme 7
    --deblock 0:0 (1 IDR + 3 P): the hierarchical search, 16x16
    quarter-pel refinement and deblock_apply once on every frame;
  * veryfast, x264's --preset veryfast --tune zerolatency --crf 23
    (1 IDR + 4 P, the last a luma fade): CABAC (a host transcode), I4x4
    on the slope-2 I wavefront, the 8x8 transform, AQ, weighted P
    prediction, P partitions at half pel and the loop filter: the SAD and
    partition_refine_mc kernels once per P frame, deblock_apply once on
    every frame;
  * veryfast batched, x264's --preset veryfast --crf 23 on the batched
    session (27 frames: 1 IDR, two windows of 12 whose mini-GOPs of 3 B
    frames cross the window boundary, and a flush whose tail is a
    promoted P and one B: 1 I, 7 P, 19 B): B frames, MB-tree and
    everything of the veryfast line: SAD and partition_refine_mc once
    per P anchor, deblock_apply once per I and P frame, none on B frames;
  * medium, CompressSession() with no options, x264's --preset medium
    (17 frames of a static texture that turns every fourth frame, so
    that each P anchor matches the one two anchors back: 1 IDR, anchors
    4 and 8 encoded per frame while the DPB fills, 12 and 16 batched
    over a DPB of 3, 12 B frames): three references, trellis and
    everything of the batched veryfast line but P partitions; the
    hierarchical search once per reference of each P anchor,
    deblock_apply once per I and P frame, the SAD and memc kernels never;
  * measured, the default session with --psnr --ssim fed BGRA frames (the
    RGB32 a VfW host hands over) and writing Matroska (9 frames: 1 IDR,
    2 P, 6 B, per frame since it measures): the conversion on the card
    (equal to the CPU's), end()'s PSNR and SSIM and one "frame=" log line
    per frame, the file's SimpleBlocks read back against the AUs,
    deblock_apply once per I and P frame;

and checks each stream, its motion vectors and its reconstruction, and
holds the SAD (both modes) and partition_refine_mc kernels against their
plain versions once more on slice 2's last P frame's own inputs, all of
them (deblock_apply on maps with 8x8-transformed MBs and per-MB QPs) on
the veryfast phase's last P frame's, and all of them again on a batched
P anchor's own inputs (per-MB QPs from MB-tree and AQ), where they are
also timed, and the SAD kernel (once per reference) and deblock_apply
(on maps with ref_idx) on the medium session's last anchor's DPB.  Then
it encodes a small clip with each command line on the card and on the
CPU and requires identical bytes (for the veryfast and superfast lines
with --min-keyint 2, on a clip with a fade and a scene cut; the B-frame
lines on 30 frames with the cut inside a window, which drains pending B
frames as a tail, and veryfast also with --threads 1; the default
session, --preset faster and slow, --preset fast, slower and veryslow,
and --preset medium --threads 1 on that clip too, --preset placebo on
PLACEBO_FRAMES frames of one scene, and --preset medium --tune
zerolatency, also with --me esa, whose SAD launches are counted, on 8
frames with a cut at 5; and the syntax-tensor CABAC route in
tests/test_cabac_transcode.py's four configurations, also equal to the
card's transcode route), and
four lines that go through input conversion, a container and the
telemetry (BGRA to Matroska with --psnr --ssim, NV12 to MP4, YUYV to FLV
with --threads 4, RGB24 to AVI), whose files and end() stats must be
equal.  Then the decoder (phase decode_1080p): DecompressSession on the
card reads back, access unit by access unit, slice 2's and L4's 1080p
streams and a third one, x264's --preset faster --tune zerolatency
--no-cabac --no-8x8dct --weightp 0 --qp 26 (1 IDR with I4x4 + 2 P, the
last over two references); every picture takes the device route (the
deblock kernel launches once per picture), every frame equals the
encoder's reconstruction, and deblock_apply equals its plain version on
the last picture's maps; then, at the small size, a card and a CPU
DecompressSession give equal outputs on a CAVLC stream with I4x4 and
three references in every output format, on the default session's
CABAC + B stream (the host route) and on the NV12 line's MP4 samples
with its avcC, and the scaler (to half the size) is within 1 of the
CPU's.  Then the batch transcode (phase transcode_4k, BASELINE config
5): a 3840x2160 stream with slice 2's options (1 IDR + 3 P) is decoded on
the device route (every picture equal to the 4K encoder's
reconstruction), scaled to 1080p and re-encoded by the default session
at CQP 26 into an MP4 whose samples equal the returned AUs, with the
SAD, memc and deblock kernels held against their plain versions on the
4K source's last P frame and the 4K decode's last maps; the GOP-parallel
route over one card named twice (gop_1080p: encode_clip_gop_parallel,
equal to the per-frame encoder; session_1080p_threads: the default
session with --threads 4 --keyint 4, its five downgrade warnings, 2
IDRs); and card against CPU at the small size for
encode_clip_gop_parallel, the sharded session (also equal to --threads
1 with the downgraded options) and the transcode.  Then x264's --preset
placebo at 1080p (placebo_1080p: 74 frames of one moving texture, 1
IDR, 5 P anchors over 1, 2, 3, 4 and 4 references, 68 B frames, the
first B run waiting across the first window; the SAD kernel once per
reference of each anchor and twice per B frame, and held against its
plain version on a B frame's L0 and L1 inputs and on the fourth
reference of anchor 68), and the syntax-tensor CABAC route at 1080p
(host_cabac_1080p: TorchEncoder.host_entropy with --cabac, whose access
units must equal the transcode route's, in the full-feature and the
B-frame configuration of tests/test_cabac_transcode.py, the C coder's
ms per slice printed).  Last, the command
line (x264vfw_tpu_torch/cli.py) encodes a Y4M file to MP4 on the card,
equal to a CompressSession's file.
Each kernel's launch count is set to 0 just before a session and read
just after it.  Prints one line per phase
with its elapsed seconds; the last three lines are the card's name and
power limit, the kernels' JSON record and {"ok": true, "device": ...}.
Any failed check raises, and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# dense int8 operations/s, used for the bound of a kernel on 8-bit pixels
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12
# Hopper SM: 4 partitions x 16 int32 lanes per clock; that VABSDIFF4
# (what __vsadu4 compiles to on sm_90a) issues at this rate is assumed
INT32_LANES_PER_SM = 64

CMDLINE = "--preset ultrafast --tune zerolatency --me esa --qp 26"
CMDLINE_PARTS = CMDLINE + " --deblock 0:0 --partitions p8x8 --subme 7"
CMDLINE_L3 = "--preset ultrafast --crf 23"
CMDLINE_L4 = ("--preset ultrafast --tune zerolatency --qp 26 --subme 7 "
              "--deblock 0:0")
CMDLINE_VF = "--preset veryfast --tune zerolatency --crf 23"
CMDLINE_SF = "--preset superfast --tune zerolatency --crf 23"
CMDLINE_VFB = "--preset veryfast --crf 23"       # batched, B frames, MB-tree
CMDLINE_SFB = "--preset superfast --crf 23"      # batched, B frames
# CompressSession() with no options: x264's --preset medium (ref 3,
# trellis, B frames, MB-tree, weightp 2, CABAC, AQ, 8x8, --me hex, qpel)
CMDLINE_MED = ""
CMDLINE_FASTER = "--preset faster"
CMDLINE_SLOW = "--preset slow"
CMDLINE_MZL = "--preset medium --tune zerolatency"
L3_FRAMES = 26           # two windows of 12 and a flush of 2
VF_FRAMES = 5            # 1 IDR + 4 P, the last a fade
VFB_FRAMES = 27          # 1 IDR, two windows of 12, a flush of 2
VFB_TYPES = {"I": 1, "P": 7, "B": 19}
B_FRAMES = 30            # the card-vs-CPU clip of the B-frame lines
B_CUT = 19               # its scene cut, inside the second window
FADE = 0.8               # the fade frame's luma gain
MED_FRAMES = 17          # 1 IDR; anchors 4 and 8 per frame while the DPB
#                          fills, 12 and 16 batched over a DPB of 3
MED_TYPES = {"I": 1, "P": 4, "B": 12}
MED_DPB = [1, 2, 3, 3]   # references of the P anchors 4, 8, 12 and 16
MED_FLICKER = 4          # frames between the texture's turns
MEAS_FRAMES = 9          # the measured default session: 1 I, 2 P, 6 B
MEAS_TYPES = {"I": 1, "P": 2, "B": 6}
# the decoder: x264's --preset faster --tune zerolatency on CAVLC (I4x4,
# two references) at 1080p (1 IDR + 2 P); on the card-vs-CPU clip the
# same with three references
CMDLINE_DEC = ("--preset faster --tune zerolatency --no-cabac --no-8x8dct "
               "--weightp 0 --qp 26")
DEC_FRAMES = 3
DEC_SMALL_FRAMES = 8
DEC_DRAINS = 2            # decompress(b"") calls after the last AU
SCALE_MAX_SHARE = 0.01    # samples the scaler may round the other way
M_FRAMES, M_CUT = 8, 5   # the card-vs-CPU clip of the per-frame medium
#                          lines: a full DPB of 3 at frames 3 and 4
# (command line, input format, container) of the card-vs-CPU lines that
# hold conversion, muxers and telemetry
SURFACE_LINES = (("--psnr --ssim", "bgra", "mkv"),
                 (CMDLINE_VF + " --psnr", "nv12", "mp4"),
                 ("--preset ultrafast --crf 23 --threads 4", "yuyv", "flv"),
                 ("--preset superfast --crf 23", "rgb24", "avi"))
# the transcode (BASELINE config 5): a 4K CAVLC source with slice 2's
# options (1 IDR + 3 P), decoded on the device route, scaled to 1080p and
# re-encoded with the JAX package's default transcode params
TC_SRC_SIZE = (3840, 2160)
TC_DST_SIZE = (1920, 1080)
TC_FRAMES = 4
# the GOP-parallel route on one card named twice: encode_clip_gop_parallel
# (GOP_COUNT GOPs of GOP_LEN frames), and the default session with
# --threads 4 --keyint 4 (THREADS_FRAMES frames, one batch of two GOPs)
SHARD_DEVICES = 2
GOP_LEN, GOP_COUNT = 3, 2
CMDLINE_THREADS = "--threads 4 --keyint 4"
THREADS_FRAMES = 8
SHARD_WARNED = ["bframes", "ref", "weightp", "mbtree", "scenecut"]
# the same session at one QP, and --threads 1 with the options the shard
# route downgrades to: equal bytes (the JAX package's
# test_threads8_bit_identical_to_single_chip)
CMDLINE_THREADS_CQP = CMDLINE_THREADS + " --qp 26"
CMDLINE_THREADS_1 = ("--threads 1 --keyint 4 --qp 26 --bframes 0 --ref 1 "
                     "--weightp 0 --no-mbtree --scenecut 0")
# x264's last four presets.  placebo at 1080p over PLACEBO_FRAMES frames
# of one scene: with MB-tree's lookahead of 60 the batched session's
# first window of 12 goes out after 72 frames, so B candidates 1-11 wait
# across it; an anchor after every 16 B candidates (17, 34, 51 encoded
# per frame while the DPB fills, 68 batched over 4 references) and a
# tail anchor (73) after a part-filled B run.  On the card-vs-CPU clip
# the other three with --min-keyint 2, and placebo over the same count
CMDLINE_PLACEBO = "--preset placebo"
PRESET_LINES = ("--preset fast", "--preset slower", "--preset veryslow")
PLACEBO_FRAMES = 74
# the syntax-tensor CABAC route (TorchEncoder.host_entropy with --cabac)
# on tests/test_cabac_transcode.py's configurations: the four on the
# card-vs-CPU clip (HOST_CABAC_FRAMES frames), and at 1080p the
# full-feature one (the exhaustive search, P partitions, I4x4, AQ,
# trellis) and the B-frame one, each over (frames, launches)
HOST_CABAC = {
    "basic": dict(qp=28, keyint=4, deblock=True),
    "full-feature": dict(qp=30, keyint=8, deblock=True, aq_strength=1.0,
                         trellis=True, i4x4=True, partitions=True),
    "multiref": dict(qp=30, keyint=8, deblock=True, num_ref_frames=3),
    "bframes": dict(qp=30, keyint=8, deblock=True, bframes=2)}
HOST_CABAC_FRAMES = 6
# full-feature: I + 4 P, SAD and memc once per P frame; bframes: I, P, B,
# B, then the flush's tail P and B: SAD once per P and twice per B
HOST_CABAC_1080P = {
    "full-feature": (5, {"sad": 4, "memc": 4, "deblock": 5}),
    "bframes": (6, {"sad": 8, "memc": 0, "deblock": 3})}
DEV = "cuda"
KERNELS = ("sad", "memc", "deblock")
SESSION_SIZE = (1920, 1080)            # the main paths' geometry
SMALL_SIZE = (128, 96)                 # the card-vs-CPU clip
SAD_SHAPES = ((1088, 1920, 16), (48, 320, 4), (64, 80, 8), (32, 272, 16),
              (32, 48, 1), (64, 64, 32), (16, 16, 4))
MEMC_SHAPES = ((1088, 1920, 16), (48, 320, 4), (64, 80, 8), (32, 272, 16),
               (16, 16, 4))
# (H, W, R) of the extra cases: flat planes (every candidate's SAD ties)
# and, for memc, a frame with every partition code 0-3 in turn
SAD_FLAT = (48, 320, 4)
MEMC_EXTRA = (64, 80, 8)
DEBLOCK_MBS = ((68, 120), (3, 4), (5, 7), (2, 20), (1, 7), (9, 1))
DEBLOCK_REPEATS = 50     # identical outputs in a row at DEBLOCK_MBS[0]
SHIFT = (3, -2)          # (dx, dy) content motion per frame, full pels
HIER_SHIFT = (9, -6)     # beyond the hierarchical search's +-2 rescue
T0 = time.time()


def phase(name: str, t_start: float, **info) -> None:
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{time.time() - T0:8.2f}s] {name}: "
          f"{time.time() - t_start:.2f}s {extra}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, after one warm-up,
    each timed with CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_b2b(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of fn() over n calls back to back between one
    pair of CUDA events, the median of reps runs.  The n calls are
    captured once in a CUDA graph (after one warm-up call) and replayed,
    so the host's own work per call is not in the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return float(np.median(times))


def max_diff(got, want) -> int:
    """Largest absolute difference over matching tensors (dicts, tuples or
    one tensor)."""
    if isinstance(got, dict):
        return max(max_diff(got[k], want[k]) for k in want)
    if isinstance(got, (tuple, list)):
        return max(max_diff(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """Band-limited random texture (3x3 box-blurred noise), uint8."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 256, (h + 2, w + 2)).astype(np.int32)
    s = sum(n[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return (s // 9).astype(np.uint8)


def structured(h: int, w: int, seed: int) -> np.ndarray:
    """textured() at 40% contrast over a smooth large-scale pattern, uint8:
    the 8x-pooled frames the weight analysis reads keep their variance,
    so a fade is measured as one."""
    yy, xx = np.mgrid[0:h, 0:w]
    big = 128 + 80 * np.sin(xx / 41.0 + 1.3) * np.cos(yy / 33.0 + 0.4)
    fine = textured(h, w, seed).astype(np.float64) - 128
    return np.clip(0.4 * fine + big, 0, 255).astype(np.uint8)


def moving_clip(w: int, h: int, frames: int, seed: int, shift=None,
                texture=textured):
    """I420 frames of a texture moving by shift (default SHIFT) per frame
    (no wrap inside the frame: the canvas has a margin wider than the
    total motion)."""
    dx, dy = shift or SHIFT
    m = max(64, frames * max(abs(dx), abs(dy)) + 8)
    base = texture(h + 2 * m, w + 2 * m, seed)
    out = []
    for f in range(frames):
        y = np.ascontiguousarray(
            np.roll(base, (f * dy, f * dx), (0, 1))[m:m + h, m:m + w])
        u = np.ascontiguousarray(y[::2, ::2])
        out.append((y, u, 255 - u))
    return out


def live_clip(w: int, h: int, frames: int, seed: int, cut_at: int,
              fade_from: int):
    """moving_clip with another moving texture from cut_at on (a scene
    cut) and a luma fade of 4% of full scale per frame from fade_from
    on."""
    one = moving_clip(w, h, frames, seed, texture=structured)
    two = moving_clip(w, h, frames, seed + 1, shift=(-SHIFT[1], SHIFT[0]))
    out = []
    for i, (y, u, v) in enumerate(one[:cut_at] + two[cut_at:]):
        if i >= fade_from:
            y = (y * (1.0 - 0.04 * (i - fade_from + 1))).astype(np.uint8)
        out.append((y, u, v))
    return out


def to_bgra(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """I420 planes -> (H, W, 4) uint8 BGRA, alpha 255 (BT.601, TV range,
    float numpy): the RGB32 frames a VfW host hands over."""
    yy = 1.164 * (y.astype(np.float64) - 16)
    cu = np.repeat(np.repeat(u.astype(np.float64) - 128, 2, 0), 2, 1)
    cv = np.repeat(np.repeat(v.astype(np.float64) - 128, 2, 0), 2, 1)
    r, g, b = (yy + 1.596 * cv, yy - 0.392 * cu - 0.813 * cv,
               yy + 2.017 * cu)
    out = np.full(y.shape + (4,), 255, np.uint8)
    for i, c in enumerate((b, g, r)):
        out[..., i] = np.clip(np.rint(c), 0, 255)
    return out


def as_format(fmt: str, frame):
    """An I420 frame in another input layout of compress(): 'bgra',
    'rgb24', 'nv12' (y, interleaved uv) or 'yuyv' (packed 4:2:2, chroma
    rows doubled)."""
    y, u, v = frame
    if fmt == "bgra":
        return to_bgra(y, u, v)
    if fmt == "rgb24":
        return np.ascontiguousarray(to_bgra(y, u, v)[..., 2::-1])
    if fmt == "nv12":
        return y, np.stack([u, v], -1).reshape(u.shape[0], -1)
    if fmt == "yuyv":
        packed = np.empty((y.shape[0], 2 * y.shape[1]), np.uint8)
        packed[:, 0::4], packed[:, 2::4] = y[:, 0::2], y[:, 1::2]
        packed[:, 1::4] = np.repeat(u, 2, 0)
        packed[:, 3::4] = np.repeat(v, 2, 0)
        return packed
    raise ValueError(fmt)


def ebml_children(buf: bytes, pos: int, end: int):
    """(element ID bytes, data start, data end) of each EBML element in
    buf[pos:end]; an element of unknown size runs to end."""
    while pos < end:
        n = 1
        while not buf[pos] & (0x80 >> (n - 1)):
            n += 1
        eid, pos = buf[pos:pos + n], pos + n
        m = 1
        while not buf[pos] & (0x80 >> (m - 1)):
            m += 1
        size = int.from_bytes(buf[pos:pos + m], "big") & ((1 << 7 * m) - 1)
        pos += m
        if size == (1 << 7 * m) - 1:
            size = end - pos
        yield eid, pos, pos + size
        pos += size


def mkv_blocks(data: bytes) -> list:
    """(keyframe, payload) of every SimpleBlock of a Matroska file's
    clusters, in file order."""
    out = []
    for eid, a, b in ebml_children(data, 0, len(data)):
        if eid != b"\x18\x53\x80\x67":                      # Segment
            continue
        for cid, ca, cb in ebml_children(data, a, b):
            if cid != b"\x1f\x43\xb6\x75":                  # Cluster
                continue
            for bid, ba, bb in ebml_children(data, ca, cb):
                if bid == b"\xa3":                          # SimpleBlock
                    out.append((bool(data[ba + 3] & 0x80), data[ba + 4:bb]))
    return out


def flicker_clip(w: int, h: int, frames: int, seed: int):
    """Static I420 frames: a smooth large-scale pattern under a fine
    texture that turns every MED_FLICKER frames between two states, the
    second the first with each 8x8 block rotated by 180 degrees.  So each
    P anchor of --bframes 3 (every fourth frame) looks like the anchor two
    before it and unlike the one before, which no vector can fix, while
    the 8x8-pooled frames the scene-cut detector and the weight analysis
    read stay the same."""
    yy, xx = np.mgrid[0:h, 0:w]
    big = 128 + 70 * np.sin(xx / 53.0 + 0.7) * np.cos(yy / 37.0 + 1.1)
    fine = textured(h, w, seed).astype(np.float64) - 128
    one = np.clip(0.5 * fine + big, 0, 255).astype(np.uint8)
    two = one[:h - h % 8, :w - w % 8].reshape(
        h // 8, 8, w // 8, 8)[:, ::-1, :, ::-1].reshape(h - h % 8,
                                                        w - w % 8)
    two = np.ascontiguousarray(np.pad(two, ((0, h % 8), (0, w % 8)),
                                      mode="edge"))
    out = []
    for f in range(frames):
        y = two if (f // MED_FLICKER) % 2 else one
        u = np.ascontiguousarray(y[::2, ::2])
        out.append((y, u, 255 - u))
    return out


class CudaOps(TorchDispatchMode):
    """Counts the ATen operations that touch a CUDA tensor, views left
    out: about one kernel launch each (torch.profiler, in
    tools/torch_profile_frames.py, counts the launches themselves)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and any(
                isinstance(t, torch.Tensor) and t.is_cuda
                for t in (*args, *(kwargs or {}).values(),
                          *(out if isinstance(out, (tuple, list))
                            else (out,)))):
            self.n += 1
        return out


def interior_match(mv: torch.Tensor, mbh: int, mbw: int, want) -> float:
    """Share of the MBs off the frame's edge whose vector is `want`."""
    inner = mv.reshape(mbh, mbw, 2)[1:-1, 1:-1].reshape(-1, 2).cpu().numpy()
    return float((inner == np.asarray(want)).all(-1).mean())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms: bytes moved (inputs read once, outputs written
    once) over HBM bandwidth vs operations over the int8 peak; the larger
    one, and which it is."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=10, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sad_int_bound_ms(H: int, W: int, R: int) -> float:
    """Least time of the SAD minima on the int32 pipes: one VABSDIFF4 per
    4 byte differences, over every SM's int32 lanes at the highest SM
    clock."""
    K = 2 * R + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes_per_s = sms * INT32_LANES_PER_SM * sm_clock_hz()
    return K * K * H * W / 4 / lanes_per_s * 1e3


_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*)")


def parse_sass(text: str) -> dict:
    """{kernel function: its SASS mnemonics in program order (modifiers
    dropped)} from a cuobjdump -sass listing."""
    listing: dict = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = listing.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _SASS_LINE.search(line)
            if m:
                cur.append(m.group(1))
    return listing


def per_sad4(mnemonics: list):
    """SASS instructions per 4-pixel SAD in a SAD kernel's inner loop: the
    instructions from its first VABSDIFF4 to its last, over the VABSDIFF4
    among them (None without VABSDIFF4)."""
    idx = [i for i, m in enumerate(mnemonics) if m == "VABSDIFF4"]
    return (idx[-1] - idx[0] + 1) / len(idx) if idx else None


def sad_sass_per_sad4():
    """A diagnostic of the built SAD minima kernel (sad_minima_kernel):
    per_sad4 of its SASS, read with the toolkit's cuobjdump; None when the
    listing or that kernel is not found."""
    from x264vfw_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    try:
        text = subprocess.run([tool, "-sass", build.library_path("sad")],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    fns = [seq for f, seq in parse_sass(text).items()
           if "sad_minima_kernel" in f]
    return per_sad4(fns[0]) if len(fns) == 1 else None


def ptxas_report(name: str):
    """The lines of nvcc's -Xptxas -v report on csrc/<name>.cu (per kernel:
    registers, shared memory, stack and spills); None when the library
    was built without it."""
    from x264vfw_tpu_torch.ops.kernels import build
    path = build.report_path(name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [ln.split(" : ", 1)[-1].strip() for ln in f
                if "entry function" in ln or "Used" in ln or "spill" in ln]


def sad_bound_ms(H: int, W: int, R: int, quad: bool = False):
    """One full search: the planes in, the minima (or every offset's four
    quadrant SADs) out; one absolute difference + one add per pixel and
    offset."""
    K = 2 * R + 1
    n = (H // 16) * (W // 16)
    out = K * K * 4 * n * 4 if quad else 18 * n * 4
    return bound(H * W + (H + 2 * R) * (W + 2 * R) + out, 2.0 * K * K * H * W)


def memc_bound_ms(H: int, W: int, R: int, ncand: int):
    """src, ref_pad, mv8i and part in; mv8 and the int32 prediction out;
    per pixel the three 6-tap half-pel filters (~36 operations) and per
    candidate a rounded mean and an absolute difference (6 operations)."""
    P = R + 8
    nblk = (H // 8) * (W // 8)
    nbytes = (H * W + (H + 2 * P) * (W + 2 * P) + nblk * 8
              + (H // 16) * (W // 16) * 4 + nblk * 8 + H * W * 4)
    return bound(nbytes, H * W * (36.0 + 6.0 * ncand))


def deblock_bound_ms(H: int, W: int):
    """The int32 planes read and written once, the four maps read once;
    about 40 operations per edge line of the 4 + 4 luma and 2 x (2 + 2)
    chroma edges of every MB."""
    mbh, mbw = H // 16, W // 16
    planes = (H * W + H * W // 2) * 4
    maps = (H * 4 * mbw + 4 * mbh * W + H // 2 * 2 * mbw
            + 2 * mbh * W // 2) * 4
    lines = mbh * mbw * (8 * 16 + 8 * 8)
    return bound(2 * planes + maps, 40.0 * lines)


def deblock_case(mbh: int, mbw: int, seed: int, dev):
    """Blocky planes and maps from build_maps over random metadata: intra
    and inter MBs, coded blocks, vectors, refs, QPs 16..51, offsets of
    +-6 (offA/offB +-12)."""
    from x264vfw_tpu_torch.ops.deblock import build_maps
    rng = np.random.default_rng(seed)
    H, W = 16 * mbh, 16 * mbw
    base = rng.integers(60, 200, (H // 4, W // 4))
    y = (np.kron(base, np.ones((4, 4), np.int64))
         + rng.integers(-3, 4, (H, W))).clip(0, 255)
    u = (y[::2, ::2] + rng.integers(-2, 3, (H // 2, W // 2))).clip(0, 255)
    planes = [torch.as_tensor(p.astype(np.int32), device=dev)
              for p in (y, u, 255 - u)]
    meta = (rng.random((mbh, mbw)) < 0.3,
            ((rng.random((4 * mbh, 4 * mbw)) < 0.3)
             * rng.integers(1, 5, (4 * mbh, 4 * mbw))).astype(np.int32),
            rng.integers(-6, 7, (4 * mbh, 4 * mbw, 2)).astype(np.int32),
            (rng.random((4 * mbh, 4 * mbw)) < 0.1).astype(np.int32),
            rng.integers(16, 52, (mbh, mbw)).astype(np.int32))
    offA, offB = (12, -12) if seed % 2 else (-12, 12)
    maps = build_maps(*(torch.as_tensor(a, device=dev) for a in meta),
                      offA, offB, 0)
    return planes, [m.contiguous() for m in maps]


def placebo_schedule(n: int):
    """(P anchors, references each one searches, B frames) of --preset
    placebo over n frames of one scene: an anchor after every 16 B
    candidates, the last frame a tail anchor over the pending rest, the
    DPB filling by one per anchor up to 4 references."""
    anchors = list(range(17, n, 17))
    if (n - 1) % 17:
        anchors.append(n - 1)
    refs = [min(i + 1, 4) for i in range(len(anchors))]
    return anchors, refs, n - 1 - len(anchors)


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


def mp4_samples(data: bytes):
    """(avcC record, [sample bytes]) of a non-fragmented MP4 with one
    track whose samples follow the mdat header in decode order (as the
    port's MP4 muxer writes them)."""
    def payload(tag: bytes) -> bytes:
        at = data.index(tag)
        size = int.from_bytes(data[at - 4:at], "big")
        return data[at + 4:at - 4 + size]

    stsz = payload(b"stsz")
    count = int.from_bytes(stsz[8:12], "big")
    pos = data.index(b"mdat") + 4
    samples = []
    for i in range(count):
        n = int.from_bytes(stsz[12 + 4 * i:16 + 4 * i], "big")
        samples.append(data[pos:pos + n])
        pos += n
    return payload(b"avcC"), samples


def run_decoder(sess, aus: list, size, **begin) -> list:
    """Every decompress() return for `aus`, then DEC_DRAINS calls with
    b"", each as a tuple of arrays."""
    sess.begin(*size, **begin)
    outs = [sess.decompress(au) for au in aus]
    outs += [sess.decompress(b"") for _ in range(DEC_DRAINS)]
    sess.end()
    return [o if isinstance(o, tuple) else (o,) for o in outs]


def same_outputs(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
        for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from x264vfw_tpu_torch import api as api_mod
    from x264vfw_tpu_torch import cli
    from x264vfw_tpu_torch.api import CompressSession
    from x264vfw_tpu_torch.bitstream import native_parse
    from x264vfw_tpu_torch.bitstream.nal import iter_annexb_raw, split_annexb
    from x264vfw_tpu_torch.encode import device as dv
    from x264vfw_tpu_torch.encode import device_finalize as dfin
    from x264vfw_tpu_torch.encode.inter_partition import \
        partition_decide_from_minima
    from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder, _pad
    from x264vfw_tpu_torch.ops.kernels import build
    from x264vfw_tpu_torch.ops.kernels import deblock as dbk
    from x264vfw_tpu_torch.ops.kernels import memc as memck
    from x264vfw_tpu_torch.ops import csp
    from x264vfw_tpu_torch.ops.kernels import sad as sadk

    dev = torch.device(DEV)
    mods = {"sad": sadk, "memc": memck, "deblock": dbk}
    # per decode stream: its access units and the encoder's reconstruction
    # of each frame (filled by the slice-2 and L4 phases)
    dec_streams = {"slice2": ([], []), "l4": ([], [])}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- 1. device -------------------------------------------------
        t = time.time()
        card = card_line()
        phase("device", t, torch=torch.__version__, cuda=torch.version.cuda,
              card_name=repr(torch.cuda.get_device_name(0)), smi=repr(card))

        # ---- 2. build: one nvcc per source, all at once ----------------
        t = time.time()
        build_s = build.build(KERNELS)
        for name in KERNELS:
            build.load(name)
        # the host CABAC passes (gcc), and the CAVLC parser's tables
        host_s = {}
        for name in build.HOST_SOURCES:
            t1 = time.time()
            build.load_host(name)
            host_s[name] = round(time.time() - t1, 2)
        native_parse._lib()
        phase("build", t, seconds={k: round(v, 2) for k, v in build_s.items()},
              host_seconds=host_s,
              libs=[os.path.basename(build.library_path(k)) for k in KERNELS]
              + [os.path.basename(build.host_library_path(k))
                 for k in build.HOST_SOURCES])

        # ---- 3. kernel vs plain version on the card, exact ---------------
        t = time.time()
        err = {k: 0 for k in KERNELS}
        rng = np.random.default_rng(7)
        for (H, W, R) in SAD_SHAPES + (SAD_FLAT,):
            flat = (H, W, R) == SAD_FLAT
            src = torch.as_tensor(rng.integers(0, 256, (H, W), np.uint8),
                                  device=dev)
            refp = torch.as_tensor(
                rng.integers(0, 256, (H + 2 * R, W + 2 * R), np.uint8),
                device=dev)
            if flat:
                src.fill_(77)
                refp.fill_(77)
            for scales in ((4, 2, 2, 1), (1, 0, 0, 0)):
                d = max_diff(sadk.sad_partition_minima(src, refp, R, scales),
                             sadk.sad_partition_minima_plain(src, refp, R,
                                                             scales))
                err["sad"] = max(err["sad"], d)
                check(d == 0, f"sad at {(H, W, R)} {scales} (flat: {flat}): "
                      f"max |diff| {d}")
            d = max_diff(sadk.sad_search_quad(src, refp, R),
                         sadk.sad_search_quad_plain(src, refp, R))
            err["sad"] = max(err["sad"], d)
            check(d == 0, f"sad quad mode at {(H, W, R)} (flat: {flat}): "
                  f"max |diff| {d}")
        memc_cases = ([("random", *shape) for shape in MEMC_SHAPES]
                      + [("flat", *MEMC_EXTRA), ("parts", *MEMC_EXTRA)])
        for kind, H, W, R in memc_cases:
            P = R + 8
            args = [torch.as_tensor(a, device=dev) for a in (
                rng.integers(0, 256, (H, W), np.uint8),
                rng.integers(0, 256, (H + 2 * P, W + 2 * P), np.uint8),
                rng.integers(-R, R + 1, (H // 8, W // 8, 2), np.int32),
                rng.integers(0, 4, (H // 16, W // 16), np.int32))]
            if kind == "flat":
                args[0].fill_(77)
                args[1].fill_(77)
            elif kind == "parts":
                args[3] = (torch.arange(args[3].numel(), device=dev) % 4) \
                    .to(torch.int32).reshape(args[3].shape)
            for sub_lv in (0, 1, 2):
                d = max_diff(memck.partition_refine_mc(*args, R, sub_lv),
                             memck.partition_refine_mc_plain(*args, R,
                                                             sub_lv))
                err["memc"] = max(err["memc"], d)
                check(d == 0, f"memc at {(H, W, R)} ({kind}) sub_lv "
                      f"{sub_lv}: max |diff| {d}")
        bs_seen = set()
        for i, (mbh, mbw) in enumerate(DEBLOCK_MBS):
            planes, maps = deblock_case(mbh, mbw, seed=i, dev=dev)
            bs_seen |= set((maps[0] & 7).unique().tolist())
            got = dbk.deblock_apply(*planes, *maps)
            d = max_diff(got, dbk.deblock_apply_plain(*planes, *maps))
            err["deblock"] = max(err["deblock"], d)
            check(d == 0, f"deblock at {(mbh, mbw)}: max |diff| {d}")
            if i == 0:
                # a memory-ordering fault shows as a rare mismatch
                runs = [dbk.deblock_apply(*planes, *maps)
                        for _ in range(DEBLOCK_REPEATS)]
                bad = sum(max_diff(r, got) != 0 for r in runs)
                check(bad == 0, f"deblock at {(mbh, mbw)}: {bad} of "
                      f"{DEBLOCK_REPEATS} repeated calls differ")
        check(bs_seen == {0, 1, 2, 3, 4}, f"bS values covered: {bs_seen}")
        torch.cuda.synchronize()
        phase("kernel_vs_plain", t, max_abs_err=err, tolerance=0,
              deblock_repeats=DEBLOCK_REPEATS)

        # ---- 4. slice 1 at 1080p: P16x16, integer-pel ---------------------
        t = time.time()
        (w, h), nfr = SESSION_SIZE, 4
        clip = moving_clip(w, h, 6, seed=1)
        sess = CompressSession(extra_cmdline=CMDLINE, device=DEV)
        sess.begin(w, h, output=os.path.join(tmp, "smoke.264"))
        enc = sess.encoder
        for m in mods.values():
            m.LAUNCHES = 0
        stream, frame_ms, mv_ok, psnrs = b"", [], [], []
        for f, frame in enumerate(clip[:nfr]):
            t1 = time.time()
            stream += sess.compress(frame)
            torch.cuda.synchronize()
            frame_ms.append((time.time() - t1) * 1e3)
            psnrs.append(psnr(enc.last_recon[0], frame[0]))
            if f:
                mv = enc.last_mv.reshape(enc.mbh, enc.mbw, 2).cpu().numpy()
                inner = mv[1:-1, 1:-1].reshape(-1, 2)
                want = np.array([-4 * SHIFT[0], -4 * SHIFT[1]])
                mv_ok.append(float((inner == want).all(-1).mean()))
        launches1 = {k: m.LAUNCHES for k, m in mods.items()}
        sess.end()
        nals = [u.nal_unit_type for u in split_annexb(stream)]
        check(nals.count(7) == 1 and nals.count(8) == 1,
              f"one SPS and one PPS, got NAL types {nals}")
        check(nals.count(5) == 1 and nals.count(1) == nfr - 1,
              f"1 IDR + {nfr - 1} P slices, got NAL types {nals}")
        check(launches1 == {"sad": nfr - 1, "memc": 0, "deblock": 0},
              f"slice-1 launches {launches1} for {nfr - 1} P frames")
        check(min(mv_ok) >= 0.9, f"interior MVs equal to the shift: {mv_ok}")
        check(min(psnrs) > 30.0, f"luma PSNR per frame {psnrs}")
        with open(os.path.join(tmp, "smoke.264"), "rb") as fh:
            check(len(fh.read()) > 0, "raw muxer wrote the stream")
        phase("session_1080p", t, bytes=len(stream),
              i_ms=round(frame_ms[0], 1),
              p_ms=[round(x, 1) for x in frame_ms[1:]],
              psnr_y=[round(x, 2) for x in psnrs],
              mv_match=[round(x, 4) for x in mv_ok], launches=launches1)

        # ---- 5. slice 2 at 1080p: deblock + P8x8 + quarter-pel -------------
        t = time.time()
        nfr = 6
        sess = CompressSession(extra_cmdline=CMDLINE_PARTS, device=DEV)
        sess.begin(w, h)
        enc = sess.encoder
        R = enc.cfg.search_range
        check((enc.cfg.deblock, enc.cfg.partitions, enc.cfg.subpel)
              == (True, True, 2), "slice-2 options reach the encoder")
        # the I frame's recon before and after the loop filter
        filtered = []
        plain_deblock = dfin._maybe_deblock

        def spy(out, *a, **k):
            res = plain_deblock(out, *a, **k)
            filtered.append(not torch.equal(out["recon_y"], res[0]))
            return res

        dfin._maybe_deblock = spy
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            stream, frame_ms, mv_ok, psnrs = b"", [], [], []
            for f, frame in enumerate(clip[:nfr]):
                prev_ref = enc.ref
                t1 = time.time()
                au = sess.compress(frame)
                torch.cuda.synchronize()
                frame_ms.append((time.time() - t1) * 1e3)
                stream += au
                # the AUs and reconstructions the decode phase reads back
                dec_streams["slice2"][0].append(au)
                dec_streams["slice2"][1].append(enc.last_recon)
                psnrs.append(psnr(enc.last_recon[0], frame[0]))
                if f:
                    mv8 = enc.last_mv8.cpu().numpy()
                    inner = mv8[2:-2, 2:-2].reshape(-1, 2)
                    want = np.array([-4 * SHIFT[0], -4 * SHIFT[1]])
                    mv_ok.append(float((inner == want).all(-1).mean()))
            launches = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin._maybe_deblock = plain_deblock
        sess.end()
        nals = [u.nal_unit_type for u in split_annexb(stream)]
        check(nals.count(7) == 1 and nals.count(8) == 1 and
              nals.count(5) == 1 and nals.count(1) == nfr - 1,
              f"SPS, PPS, 1 IDR + {nfr - 1} P slices, got NAL types {nals}")
        check(launches == {"sad": nfr - 1, "memc": nfr - 1, "deblock": nfr},
              f"slice-2 launches {launches}: want {nfr - 1} SAD and memc, "
              f"{nfr} deblock (one per frame)")
        check(min(mv_ok) >= 0.9, f"interior mv8 equal to the shift: {mv_ok}")
        check(min(psnrs) > 30.0, f"luma PSNR per frame {psnrs}")
        check(filtered[0], "the loop filter changed the I frame's recon")

        # the kernels at the session's own shapes: the last P frame's
        # inputs, formed as the encoder forms them
        H, W = 16 * enc.mbh, 16 * enc.mbw
        sy, su, sv = (torch.as_tensor(_pad(p, H // k, W // k), device=dev)
                      .to(torch.int32)
                      for p, k in zip(clip[nfr - 1], (1, 2, 2)))
        src8 = sy.to(torch.uint8).contiguous()
        refp_r = dv._edge_pad(prev_ref[0], R).to(torch.uint8).contiguous()
        refp_m = dv._edge_pad(prev_ref[0], R + 8).to(torch.uint8).contiguous()
        mins = sadk.sad_partition_minima(src8, refp_r, R)
        part, mv8i = partition_decide_from_minima(mins, R, enc.qp)
        out = dv.encode_p_frame_core(sy, su, sv, *prev_ref, enc.qp, enc.qpc,
                                     R, 2, partitions=True)
        check(torch.equal(memck.partition_refine_mc_plain(
            src8, refp_m, mv8i, part, R, 2)[0], out["mv8"]),
            "plain memc on the session's inputs gives the session's mv8")
        # each kernel against its plain version on these inputs, exact
        session_err = {
            "sad": max_diff(mins, sadk.sad_partition_minima_plain(
                src8, refp_r, R)),
            "quad": max_diff(sadk.sad_search_quad(src8, refp_r, R),
                             sadk.sad_search_quad_plain(src8, refp_r, R))}
        for sub_lv in (0, 1, 2):
            session_err[f"memc_lv{sub_lv}"] = max_diff(
                memck.partition_refine_mc(src8, refp_m, mv8i, part, R,
                                          sub_lv),
                memck.partition_refine_mc_plain(src8, refp_m, mv8i, part, R,
                                                sub_lv))
        check(not any(session_err.values()),
              f"kernels vs plain on the session's inputs: {session_err}")
        err["sad"] = max(err["sad"], session_err["sad"], session_err["quad"])
        err["memc"] = max([err["memc"]] + [d for k, d in session_err.items()
                                           if k.startswith("memc")])
        part_counts = torch.bincount(part.flatten().long(),
                                     minlength=4).tolist()
        phase("session_1080p_parts", t, bytes=len(stream),
              i_ms=round(frame_ms[0], 1),
              p_ms=[round(x, 1) for x in frame_ms[1:]],
              psnr_y=[round(x, 2) for x in psnrs],
              mv8_match=[round(x, 4) for x in mv_ok], launches=launches,
              session_max_abs_err=session_err, part_counts=part_counts)

        # ---- 6. L3, x264's ultrafast line at 1080p: batched, hierarchical --
        t = time.time()
        clip3 = moving_clip(w, h, L3_FRAMES, seed=3, shift=HIER_SHIFT)
        want_mv = [-4 * HIER_SHIFT[0], -4 * HIER_SHIFT[1]]
        sess = CompressSession(extra_cmdline=CMDLINE_L3, device=DEV)
        sess.begin(w, h)
        enc = sess.encoder
        check(sess._pipe is not None and enc.cfg.me_backend == "auto:hier"
              and enc.cfg.subpel == 0, "L3 runs batched with the "
              "hierarchical search and no sub-pel step")
        # the planes each frame keeps as its reference, in decode order,
        # and each P run's vectors
        kept, run_mvs = [], []
        plain_deblock, plain_pgop = dfin._maybe_deblock, dfin.encode_pgop_slots

        def keep_ref(*a, **k):
            res = plain_deblock(*a, **k)
            kept.append(res[0])
            return res

        def keep_mv(*a, **k):
            res = plain_pgop(*a, **k)
            run_mvs.append(res[-1])
            return res

        dfin._maybe_deblock, dfin.encode_pgop_slots = keep_ref, keep_mv
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame) for frame in clip3]
            tail = sess.end()["tail"]
            torch.cuda.synchronize()
            wall = time.time() - t1
            launches3 = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin._maybe_deblock, dfin.encode_pgop_slots = plain_deblock, \
                plain_pgop
        delay = sess.frames_info().delay
        check(delay == 23, f"L3 frames_info().delay {delay}, want 23")
        check([i for i, o in enumerate(outs) if o] == [23] and tail,
              "L3 compress() returns b'' until the second window fills, "
              "then the first window; end()['tail'] the rest")
        nals = [u.nal_unit_type for u in split_annexb(b"".join(outs) + tail)]
        check(nals.count(7) == 1 and nals.count(8) == 1 and
              nals.count(5) == 1 and nals.count(1) == L3_FRAMES - 1,
              f"SPS, PPS, 1 IDR + {L3_FRAMES - 1} P, got NAL types {nals}")
        check(launches3 == {k: 0 for k in KERNELS},
              f"L3 runs none of the kernels: {launches3}")
        mvs = torch.cat(run_mvs)
        mv_ok = [interior_match(mv, enc.mbh, enc.mbw, want_mv) for mv in mvs]
        psnrs = [psnr(r[:h, :w].cpu().numpy(), f[0])
                 for r, f in zip(kept, clip3)]
        check(len(mv_ok) == L3_FRAMES - 1 and min(mv_ok) >= 0.9,
              f"L3 interior integer MVs equal to the shift: {mv_ok}")
        check(len(psnrs) == L3_FRAMES and min(psnrs) > 30.0,
              f"L3 luma PSNR per frame {psnrs}")
        phase("session_1080p_ultrafast_crf23", t,
              bytes=len(b"".join(outs) + tail), wall_s=round(wall, 3),
              fps=round(L3_FRAMES / wall, 3), delay=delay,
              psnr_y_min=round(min(psnrs), 2),
              mv_match_min=round(min(mv_ok), 4), launches=launches3)
        del kept, run_mvs, mvs

        # ---- 7. L4: hierarchical search, quarter pel, loop filter ----------
        t = time.time()
        nfr4 = 4
        sess = CompressSession(extra_cmdline=CMDLINE_L4, device=DEV)
        sess.begin(w, h)
        enc = sess.encoder
        check((enc.cfg.me_backend, enc.cfg.subpel, enc.cfg.deblock,
               enc.cfg.partitions) == ("auto:hier", 2, True, False)
              and sess._pipe is None, "L4 options reach the encoder")
        for m in mods.values():
            m.LAUNCHES = 0
        frame_ms, mv_ok, psnrs, ops = [], [], [], CudaOps()
        for f, frame in enumerate(clip3[:nfr4]):
            t1 = time.time()
            if f == nfr4 - 1:
                with ops:
                    au = sess.compress(frame)
            else:
                au = sess.compress(frame)
            torch.cuda.synchronize()
            frame_ms.append((time.time() - t1) * 1e3)
            dec_streams["l4"][0].append(au)
            dec_streams["l4"][1].append(enc.last_recon)
            psnrs.append(psnr(enc.last_recon[0], frame[0]))
            if f:
                mv_ok.append(interior_match(enc.last_mv, enc.mbh, enc.mbw,
                                            want_mv))
        launches4 = {k: m.LAUNCHES for k, m in mods.items()}
        sess.end()
        check(launches4 == {"sad": 0, "memc": 0, "deblock": nfr4},
              f"L4 launches {launches4}: want {nfr4} deblock, one per frame")
        check(min(mv_ok) >= 0.9,
              f"L4 interior quarter-pel MVs equal to 4 x the shift: {mv_ok}")
        check(min(psnrs) > 30.0, f"L4 luma PSNR per frame {psnrs}")
        phase("session_1080p_hier_qpel_deblock", t,
              i_ms=round(frame_ms[0], 1),
              p_ms=[round(x, 1) for x in frame_ms[1:]],
              p_frame_cuda_ops=ops.n, psnr_y=[round(x, 2) for x in psnrs],
              mv_match=[round(x, 4) for x in mv_ok], launches=launches4)

        # ---- 8. veryfast: CABAC, I4x4, 8x8 transform, AQ, weightp --------
        t = time.time()
        clip_v = moving_clip(w, h, VF_FRAMES, seed=4, texture=structured)
        y_last, u_last, v_last = clip_v[-1]
        clip_v[-1] = ((y_last * FADE).astype(np.uint8), u_last, v_last)
        sess = CompressSession(extra_cmdline=CMDLINE_VF, device=DEV)
        sess.begin(w, h)
        enc = sess.encoder
        cfg = enc.cfg
        check((cfg.cabac, cfg.i4x4, cfg.dct8x8, cfg.aq_strength > 0,
               cfg.weightp, cfg.scenecut > 0, cfg.partitions, cfg.subpel,
               cfg.deblock) == (True, True, True, True, 1, True, True, 1,
                                True) and sess._pipe is None,
              "veryfast options reach the per-frame encoder")
        R = cfg.search_range
        p_outs, i4_share = [], []
        plain_p, plain_deblock = dfin.encode_p_slots, dfin._maybe_deblock

        def keep_p(*a, **k):
            res = plain_p(*a, **k)
            p_outs.append(res[-1])
            return res

        def keep_i4(out, *a, **k):
            if "use_i4" in out:
                i4_share.append(float(out["use_i4"].float().mean()))
            return plain_deblock(out, *a, **k)

        dfin.encode_p_slots, dfin._maybe_deblock = keep_p, keep_i4
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            stream, frame_ms, tc_ms, mv_ok, psnrs, weighted = \
                b"", [], [], [], [], []
            for f, frame in enumerate(clip_v):
                prev_ref = enc.ref
                t1 = time.time()
                stream += sess.compress(frame)
                torch.cuda.synchronize()
                frame_ms.append((time.time() - t1) * 1e3)
                tc_ms.append(enc.transcode_ms)
                psnrs.append(psnr(enc.last_recon[0], frame[0]))
                if f:
                    weighted.append(enc._wp is not None)
                if 0 < f < VF_FRAMES - 1:      # the fade frame aside
                    inner = enc.last_mv8.cpu().numpy()[2:-2, 2:-2] \
                        .reshape(-1, 2)
                    want = np.array([-4 * SHIFT[0], -4 * SHIFT[1]])
                    mv_ok.append(float((inner == want).all(-1).mean()))
            launches_v = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin.encode_p_slots, dfin._maybe_deblock = plain_p, plain_deblock
        sess.end()
        nals = [u.nal_unit_type for u in split_annexb(stream)]
        check(nals.count(7) == 1 and nals.count(8) == 1 and
              nals.count(5) == 1 and nals.count(1) == VF_FRAMES - 1,
              f"SPS, PPS, 1 IDR + {VF_FRAMES - 1} P, got NAL types {nals}")
        check(launches_v == {"sad": VF_FRAMES - 1, "memc": VF_FRAMES - 1,
                             "deblock": VF_FRAMES},
              f"veryfast launches {launches_v}: want one SAD and memc per P "
              "frame, one deblock per frame")
        check(min(mv_ok) >= 0.9, f"veryfast interior mv8 equal to the shift: "
              f"{mv_ok}")
        check(min(psnrs) > 30.0, f"veryfast luma PSNR per frame {psnrs}")
        check(weighted == [False] * (VF_FRAMES - 2) + [True],
              f"only the fade frame is weighted: {weighted}")
        t8_share = [float(o["t8"].float().mean()) for o in p_outs]
        qp_range = (min(int(o["qp_real"].min()) for o in p_outs),
                    max(int(o["qp_real"].max()) for o in p_outs))
        check(len(i4_share) == 1 and i4_share[0] > 0, f"I_NxN MBs {i4_share}")
        check(max(t8_share) > 0, f"8x8-transformed MBs {t8_share}")
        check(qp_range[0] < qp_range[1], f"AQ QP range {qp_range}")

        # every kernel on this phase's last P frame's inputs, formed as the
        # encoder forms them: the search, the half-pel refinement and the
        # loop filter over maps with 8x8 transforms and per-MB QPs
        out = p_outs[-1]
        H, W = 16 * enc.mbh, 16 * enc.mbw
        src8 = torch.as_tensor(_pad(clip_v[-1][0], H, W), device=dev) \
            .to(torch.uint8).contiguous()
        refp_r = dv._edge_pad(prev_ref[0], R).to(torch.uint8).contiguous()
        refp_m = dv._edge_pad(prev_ref[0], R + 8).to(torch.uint8).contiguous()
        mins = sadk.sad_partition_minima(src8, refp_r, R)
        part, mv8i = partition_decide_from_minima(mins, R, enc.qp)
        check(torch.equal(memck.partition_refine_mc_plain(
            src8, refp_m, mv8i, part, R, 1)[0], out["mv8"]),
            "plain memc on the veryfast inputs gives the session's mv8")
        maps = dv.loop_filter_maps(out, enc.qp, enc.mbh, enc.mbw, False,
                                   0, 0, enc.pps.chroma_qp_index_offset)
        recon = [out[k].contiguous()
                 for k in ("recon_y", "recon_u", "recon_v")]
        vf_err = {
            "sad": max_diff(mins, sadk.sad_partition_minima_plain(
                src8, refp_r, R)),
            "quad": max_diff(sadk.sad_search_quad(src8, refp_r, R),
                             sadk.sad_search_quad_plain(src8, refp_r, R)),
            "memc": max_diff(
                memck.partition_refine_mc(src8, refp_m, mv8i, part, R, 1),
                memck.partition_refine_mc_plain(src8, refp_m, mv8i, part, R,
                                                1)),
            "deblock": max_diff(dbk.deblock_apply(*recon, *maps),
                                dbk.deblock_apply_plain(*recon, *maps))}
        check(not any(vf_err.values()),
              f"kernels vs plain on the veryfast inputs: {vf_err}")
        for k in KERNELS:
            err[k] = max(err[k], vf_err[k])
        err["sad"] = max(err["sad"], vf_err["quad"])
        phase("session_1080p_veryfast", t, bytes=len(stream),
              i_ms=round(frame_ms[0], 1),
              p_ms=[round(x, 1) for x in frame_ms[1:]],
              cabac_ms=[round(x, 2) for x in tc_ms],
              psnr_y=[round(x, 2) for x in psnrs],
              mv8_match=[round(x, 4) for x in mv_ok], launches=launches_v,
              i_nxn_share=round(i4_share[0], 4),
              t8_share=[round(x, 4) for x in t8_share],
              weighted_p=weighted, aq_qp_range=list(qp_range),
              session_max_abs_err=vf_err)
        del p_outs, out, recon, maps

        # ---- 9. veryfast batched: B frames, MB-tree, the batched session --
        t = time.time()
        clip_b = moving_clip(w, h, VFB_FRAMES, seed=6)
        sess = CompressSession(extra_cmdline=CMDLINE_VFB, device=DEV)
        sess.begin(w, h)
        enc, pipe = sess.encoder, sess._pipe
        cfg = enc.cfg
        check(pipe is not None and sess.mbtree is not None
              and (cfg.bframes, cfg.cabac, cfg.i4x4, cfg.dct8x8,
                   cfg.aq_strength > 0, cfg.weightp, cfg.scenecut > 0,
                   cfg.partitions, cfg.subpel, cfg.deblock)
              == (3, True, True, True, True, 1, True, True, 1, True),
              "veryfast options reach the batched session")
        R = cfg.search_range
        # per frame type, each phase-1 call's device span (CUDA events, no
        # host sync) over its frames; the P anchors with MB-tree offsets
        # (their inputs and syntax tensors); the I frame's
        # recon; the MB-tree offsets; the emitted (display, type) order
        ev = {"I": [], "P": [], "B": []}
        anchors, offs, order, i_recon = [], [], [], []
        plain = {"p": dfin.encode_p_slots, "pgop": dfin.encode_pgop_slots,
                 "bgop": dfin.encode_bgop_slots, "frame": enc.encode_frame,
                 "pop": sess.mbtree._pop, "emit": sess._emit}

        def timed(fn, kind):
            """fn, recording its device span under kind(*args) -> (frame
            type, frames in the call)."""
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res = fn(*a, **k)
                e1.record()
                ftype, n = kind(*a, **k)
                ev[ftype].append((e0, e1, n))
                return res
            return run

        def keep_anchor(*a, **k):
            res = plain["p"](*a, **k)
            if k.get("qp_off") is not None:
                anchors.append((a, k["qp_off"], res[-1]))
            return res

        def keep_frame(*a, **k):
            res = timed(plain["frame"], lambda *a, force_idr=None, **k: (
                "I" if force_idr else "P", 1))(*a, **k)
            if k.get("force_idr"):
                i_recon.append(enc.last_recon[0])
            return res

        def keep_offs():
            res = plain["pop"]()
            offs.append(res[1])
            return res

        def keep_order(outs, *a, **k):
            order.extend((it[1], it[3]) for it in outs)
            return plain["emit"](outs, *a, **k)

        dfin.encode_p_slots = keep_anchor
        dfin.encode_pgop_slots = timed(
            plain["pgop"], lambda rows, *a, **k: ("P", rows.shape[0]))
        dfin.encode_bgop_slots = timed(
            plain["bgop"], lambda rows, *a, **k: ("B", rows.shape[0]))
        enc.encode_frame = keep_frame
        sess.mbtree._pop = keep_offs
        sess._emit = keep_order
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame) for frame in clip_b]
            tail = sess.end()["tail"]
            torch.cuda.synchronize()
            wall = time.time() - t1
            launches_vb = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin.encode_p_slots = plain["p"]
            dfin.encode_pgop_slots = plain["pgop"]
            dfin.encode_bgop_slots = plain["bgop"]
        stream = b"".join(outs) + tail
        types = "".join(ft for _, ft in order)
        check({k: types.count(k) for k in "IPB"} == VFB_TYPES
              and sorted(d for d, _ in order) == list(range(VFB_FRAMES)),
              f"veryfast batched frame types {types}, want {VFB_TYPES}")
        vcl = [u for u in split_annexb(stream) if u.nal_unit_type in (1, 5)]
        check("".join("I" if u.nal_unit_type == 5 else
                      ("P" if u.nal_ref_idc else "B") for u in vcl) == types,
              f"NAL types and nal_ref_idc follow the frame types {types}")
        check(launches_vb == {"sad": VFB_TYPES["P"], "memc": VFB_TYPES["P"],
                              "deblock": VFB_TYPES["I"] + VFB_TYPES["P"]},
              f"veryfast batched launches {launches_vb}: want one SAD and "
              "memc per P anchor, one deblock per I and P frame")
        delay = sess.frames_info().delay
        check(delay == 3 + 10 + 23, f"veryfast batched delay {delay}")
        psnr_i = psnr(i_recon[0], clip_b[0][0])
        last_d = max(d for d, ft in order if ft == "P")
        prev_d = max(d for d, ft in order if ft != "B" and d < last_d)
        psnr_last = psnr(enc.last_recon[0], clip_b[last_d][0])
        check(psnr_i > 30.0 and psnr_last > 30.0, f"PSNR of the I frame "
              f"{psnr_i} and of the last anchor (frame {last_d}) "
              f"{psnr_last}")
        want_col = [4 * abs(SHIFT[0]) * (last_d - prev_d),
                    4 * abs(SHIFT[1]) * (last_d - prev_d)]
        col_ok = interior_match(enc.last_mv, enc.mbh, enc.mbw, want_col)
        check(col_ok >= 0.9, f"the last anchor's colocated field equals "
              f"{want_col} on {col_ok} of interior MBs")
        ms = {k: [a.elapsed_time(b) / n for a, b, n in v]
              for k, v in ev.items()}
        off_range = (min(int(o.min()) for o in offs),
                     max(int(o.max()) for o in offs))
        check(len(offs) == VFB_FRAMES and off_range[0] < 0,
              f"MB-tree offsets {off_range} over {len(offs)} frames")

        # every kernel on a batched anchor's own inputs, formed as the
        # encoder forms them; its maps carry MB-tree + AQ per-MB QPs
        # the last batched anchor whose offsets are not all 0
        kept = [x for x in anchors if int(x[1].min()) < 0]
        check(bool(kept), "a batched P anchor with MB-tree offsets")
        (a_src, a_ry, _, _, a_qp, *_), _, out = kept[-1]
        del anchors, kept
        H, W = 16 * enc.mbh, 16 * enc.mbw
        src8 = a_src[:H * W].reshape(H, W).contiguous()
        refp_r = dv._edge_pad(a_ry, R).to(torch.uint8).contiguous()
        refp_m = dv._edge_pad(a_ry, R + 8).to(torch.uint8).contiguous()
        mins = sadk.sad_partition_minima(src8, refp_r, R)
        part, mv8i = partition_decide_from_minima(mins, R, a_qp)
        check(torch.equal(memck.partition_refine_mc_plain(
            src8, refp_m, mv8i, part, R, 1)[0], out["mv8"]),
            "plain memc on the batched anchor's inputs gives its mv8")
        maps = dv.loop_filter_maps(out, a_qp, enc.mbh, enc.mbw, False,
                                   0, 0, enc.pps.chroma_qp_index_offset)
        recon = [out[k].contiguous()
                 for k in ("recon_y", "recon_u", "recon_v")]
        qp_span = (int(out["qp_real"].min()), int(out["qp_real"].max()))
        vb_err = {
            "sad": max_diff(mins, sadk.sad_partition_minima_plain(
                src8, refp_r, R)),
            "quad": max_diff(sadk.sad_search_quad(src8, refp_r, R),
                             sadk.sad_search_quad_plain(src8, refp_r, R)),
            "memc": max_diff(
                memck.partition_refine_mc(src8, refp_m, mv8i, part, R, 1),
                memck.partition_refine_mc_plain(src8, refp_m, mv8i, part, R,
                                                1)),
            "deblock": max_diff(dbk.deblock_apply(*recon, *maps),
                                dbk.deblock_apply_plain(*recon, *maps))}
        check(not any(vb_err.values()),
              f"kernels vs plain on the batched anchor's inputs: {vb_err}")
        for k in KERNELS:
            err[k] = max(err[k], vb_err[k])
        err["sad"] = max(err["sad"], vb_err["quad"])
        calls = {
            "sad": (lambda: sadk.sad_partition_minima(src8, refp_r, R),
                    lambda: sadk.sad_partition_minima_plain(src8, refp_r, R),
                    sad_bound_ms(H, W, R)),
            "memc": (lambda: memck.partition_refine_mc(src8, refp_m, mv8i,
                                                       part, R, 1),
                     lambda: memck.partition_refine_mc_plain(
                         src8, refp_m, mv8i, part, R, 1),
                     memc_bound_ms(H, W, R, 9)),
            "deblock": (lambda: dbk.deblock_apply(*recon, *maps),
                        lambda: dbk.deblock_apply_plain(*recon, *maps),
                        deblock_bound_ms(H, W)),
            "quad": (lambda: sadk.sad_search_quad(src8, refp_r, R),
                     lambda: sadk.sad_search_quad_plain(src8, refp_r, R),
                     sad_bound_ms(H, W, R, quad=True)),
        }
        # (ms, plain ms, bound ms, bound by, ms back to back)
        timing = {k: (cuda_ms(kern, 20), cuda_ms(plain, 3), *bd,
                      cuda_ms_b2b(kern))
                  for k, (kern, plain, bd) in calls.items()}
        quad = timing.pop("quad")
        phase("session_1080p_veryfast_batched", t, bytes=len(stream),
              wall_s=round(wall, 3), fps=round(VFB_FRAMES / wall, 3),
              delay=delay, types=types,
              ms_per_frame={k: [round(x, 1) for x in v]
                            for k, v in ms.items()},
              cabac_ms=round(sum(pipe.transcode_ms), 2),
              cabac_batches=len(pipe.transcode_ms),
              mbtree_qp_offsets=list(off_range),
              anchor_qp_range=list(qp_span), psnr_i=round(psnr_i, 2),
              last_anchor=last_d, psnr_last=round(psnr_last, 2),
              colocated_match=round(col_ok, 4), launches=launches_vb,
              session_max_abs_err=vb_err,
              kernel_ms={k: round(v[0], 4) for k, v in timing.items()},
              kernel_ms_b2b={k: round(v[4], 4) for k, v in timing.items()},
              plain_ms={k: round(v[1], 2) for k, v in timing.items()},
              quad_ms=round(quad[0], 4), quad_ms_b2b=round(quad[4], 4))
        del out, recon, maps

        # ---- 10. x264's --preset medium: CompressSession() with no options -
        t = time.time()
        clip_m = flicker_clip(w, h, MED_FRAMES, seed=8)
        sess = CompressSession(extra_cmdline=CMDLINE_MED, device=DEV)
        sess.begin(w, h)
        enc, pipe = sess.encoder, sess._pipe
        cfg = enc.cfg
        check(pipe is not None and sess.mbtree is not None
              and (enc.nref, cfg.trellis, enc.partitions, cfg.bframes,
                   cfg.me_backend, cfg.subpel, cfg.weightp, cfg.cabac,
                   cfg.dct8x8, cfg.i4x4, cfg.aq_strength > 0, cfg.deblock)
              == (3, True, False, 3, "auto:hier", 2, 2, True, True, True,
                  True, True),
              "--preset medium's options reach the batched session")
        R = cfg.search_range
        # per frame type, each phase-1 call's device span; each P anchor's
        # inputs, syntax tensors and hierarchical searches; the host CABAC
        # of the frames encoded per frame; the emitted order
        ev = {"I": [], "P": [], "B": []}
        anchors, hier, tc_frame, order, i_recon = [], [], [], [], []
        plain = {"p": dfin.encode_p_slots, "pgop": dfin.encode_pgop_slots,
                 "bgop": dfin.encode_bgop_slots, "frame": enc.encode_frame,
                 "hier": dv._hier_search, "emit": sess._emit}
        searches = [0]

        def count_hier(*a, **k):
            searches[0] += 1
            return plain["hier"](*a, **k)

        def keep_anchor(*a, **k):
            before = searches[0]
            res = plain["p"](*a, **k)
            hier.append(searches[0] - before)
            anchors.append((a, res[-1]))
            return res

        def keep_frame(*a, **k):
            res = timed(plain["frame"], lambda *a, force_idr=None, **k: (
                "I" if force_idr else "P", 1))(*a, **k)
            tc_frame.append(enc.transcode_ms)
            if k.get("force_idr"):
                i_recon.append(enc.last_recon[0])
            return res

        def keep_order(outs, *a, **k):
            order.extend((it[1], it[3]) for it in outs)
            return plain["emit"](outs, *a, **k)

        dfin.encode_p_slots = keep_anchor
        dfin.encode_pgop_slots = timed(
            plain["pgop"], lambda rows, *a, **k: ("P", rows.shape[0]))
        dfin.encode_bgop_slots = timed(
            plain["bgop"], lambda rows, *a, **k: ("B", rows.shape[0]))
        dv._hier_search = count_hier
        enc.encode_frame = keep_frame
        sess._emit = keep_order
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame) for frame in clip_m]
            tail = sess.end()["tail"]
            torch.cuda.synchronize()
            wall = time.time() - t1
            launches_m = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin.encode_p_slots = plain["p"]
            dfin.encode_pgop_slots = plain["pgop"]
            dfin.encode_bgop_slots = plain["bgop"]
            dv._hier_search = plain["hier"]
        stream = b"".join(outs) + tail
        types = "".join(ft for _, ft in order)
        check({k: types.count(k) for k in "IPB"} == MED_TYPES
              and sorted(d for d, _ in order) == list(range(MED_FRAMES)),
              f"medium frame types {types}, want {MED_TYPES}")
        vcl = [u for u in split_annexb(stream) if u.nal_unit_type in (1, 5)]
        check("".join("I" if u.nal_unit_type == 5 else
                      ("P" if u.nal_ref_idc else "B") for u in vcl) == types,
              f"NAL types and nal_ref_idc follow the frame types {types}")
        check(launches_m == {"sad": 0, "memc": 0,
                             "deblock": MED_TYPES["I"] + MED_TYPES["P"]},
              f"medium launches {launches_m}: want one deblock per I and P "
              "frame and no SAD or memc (the hierarchical search)")
        check(hier == MED_DPB, f"hierarchical searches per P anchor {hier}, "
              f"want one per reference {MED_DPB}")
        check(len(anchors) == MED_TYPES["P"]
              and [a[0][1].dim() == 3 for a in anchors]
              == [n > 1 for n in MED_DPB],
              "the anchors search a stacked DPB once it holds two frames")
        # the anchors with a full DPB: ref_idx 1 (two anchors back) is the
        # match on the interior MBs
        hist = torch.zeros(3, dtype=torch.int64)
        older = []
        for (a, out), nref in zip(anchors, MED_DPB):
            if nref == 3:
                ri = out["ref_idx"].reshape(enc.mbh, enc.mbw)
                hist += torch.bincount(ri.flatten().long().cpu(),
                                       minlength=3)
                older.append(float((ri[1:-1, 1:-1] > 0).float().mean()))
        check(len(older) == 2 and min(older) >= 0.9,
              f"ref_idx > 0 on {older} of the interior MBs of the anchors "
              "with a full DPB")
        psnr_i = psnr(i_recon[0], clip_m[0][0])
        psnr_last = psnr(enc.last_recon[0], clip_m[-1][0])
        check(psnr_i > 30.0 and psnr_last > 30.0, f"PSNR of the I frame "
              f"{psnr_i} and of the last anchor {psnr_last}")
        ms = {k: [a.elapsed_time(b) / n for a, b, n in v]
              for k, v in ev.items()}

        # SAD (as --me esa runs it, once per reference) and deblock on the
        # last anchor's own inputs: its DPB of 3, its maps with ref_idx
        (a_src, a_ry, _, _, a_qp, *_), out = anchors[-1]
        H, W = 16 * enc.mbh, 16 * enc.mbw
        src8 = a_src[:H * W].reshape(H, W).contiguous()
        maps = dv.loop_filter_maps(out, a_qp, enc.mbh, enc.mbw, False,
                                   0, 0, enc.pps.chroma_qp_index_offset)
        one_ref = dv.loop_filter_maps(
            dict(out, ref_idx=torch.zeros_like(out["ref_idx"])), a_qp,
            enc.mbh, enc.mbw, False, 0, 0, enc.pps.chroma_qp_index_offset)
        check(int(out["ref_idx"].max()) > 0,
              "the last anchor's maps carry ref_idx > 0")
        ref_bs = sum(int((a != b).sum()) for a, b in zip(maps, one_ref))
        recon = [out[k].contiguous()
                 for k in ("recon_y", "recon_u", "recon_v")]
        med_err = {"deblock": max_diff(dbk.deblock_apply(*recon, *maps),
                                       dbk.deblock_apply_plain(*recon,
                                                               *maps))}
        for r in range(a_ry.shape[0]):
            refp = dv._edge_pad(a_ry[r], R).to(torch.uint8).contiguous()
            med_err[f"sad_ref{r}"] = max_diff(
                sadk.sad_partition_minima(src8, refp, R, (1, 0, 0, 0)),
                sadk.sad_partition_minima_plain(src8, refp, R, (1, 0, 0, 0)))
        check(not any(med_err.values()),
              f"kernels vs plain on the medium anchor's inputs: {med_err}")
        err["deblock"] = max(err["deblock"], med_err["deblock"])
        err["sad"] = max([err["sad"]] + [d for k, d in med_err.items()
                                         if k.startswith("sad")])
        phase("session_1080p_medium", t, bytes=len(stream),
              wall_s=round(wall, 3), fps=round(MED_FRAMES / wall, 3),
              types=types,
              ms_per_frame={k: [round(x, 1) for x in v]
                            for k, v in ms.items()},
              cabac_ms=round(sum(pipe.transcode_ms) + sum(tc_frame), 2),
              cabac_ms_batched=round(sum(pipe.transcode_ms), 2),
              cabac_ms_per_frame=[round(x, 2) for x in tc_frame],
              ref_idx_hist=hist.tolist(),
              older_ref_share=[round(x, 4) for x in older],
              hier_searches_per_anchor=hier, launches=launches_m,
              psnr_i=round(psnr_i, 2), psnr_last=round(psnr_last, 2),
              map_entries_moved_by_ref_idx=ref_bs,
              session_max_abs_err=med_err, card=repr(card))
        del anchors, out, recon, maps, one_ref

        # ---- 11. the default session measured: BGRA in, Matroska out -------
        t = time.time()
        clip_r = [to_bgra(*f) for f in moving_clip(w, h, MEAS_FRAMES, seed=9)]
        mkv = os.path.join(tmp, "measured.mkv")
        sess = CompressSession(extra_cmdline="--psnr --ssim", device=DEV)
        sess.begin(w, h, output=mkv)
        enc = sess.encoder
        check(sess._pipe is None and enc.measure and sess.mbtree is not None
              and (enc.nref, enc.cfg.bframes) == (3, 3),
              "a measuring default session runs per frame")
        # the card's conversion of frame 0 against the CPU's, exact
        conv = {d: csp.convert_to_i420("bgra", clip_r[0], device=d)
                for d in dict.fromkeys((DEV, "cpu"))}
        conv_err = max_diff([p.cpu() for p in conv[DEV]], conv["cpu"])
        check(conv_err == 0, f"BGRA -> I420 card vs CPU: max |diff| "
              f"{conv_err}")
        # what compress() pays per frame (upload, convert, pull back), and
        # the conversion alone on a frame already on the card
        bgra_d = torch.as_tensor(clip_r[0], device=dev)
        conv_ms = cuda_ms(lambda: api_mod._to_i420(clip_r[0], "bgra", dev), 5)
        conv_dev_ms = cuda_ms(lambda: csp.convert_to_i420("bgra", bgra_d), 5)
        # per frame type the host time of each encode call (each ends with
        # its payload's pull), the host measurement per frame, the emitted
        # AUs and the last P anchor's inputs and syntax tensors
        meas_ms = {"I": [], "P": [], "B": [], "metrics": []}
        emitted, anchors = [], []
        plain = {"frame": enc.encode_frame, "b": enc._encode_b,
                 "metrics": sess._frame_metrics, "emit": sess._emit,
                 "p": dfin.encode_p_slots}

        def host_timed(fn, kind):
            def run(*a, **k):
                t1 = time.time()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                meas_ms[kind(*a, **k)].append((time.time() - t1) * 1e3)
                return res
            return run

        def keep_emit(outs, *a, **k):
            emitted.extend(outs)
            return plain["emit"](outs, *a, **k)

        def keep_anchor(*a, **k):
            res = plain["p"](*a, **k)
            anchors.append((a, res[-1]))
            return res

        enc.encode_frame = host_timed(plain["frame"], lambda *a, force_idr=None,
                                      **k: "I" if force_idr else "P")
        enc._encode_b = host_timed(plain["b"], lambda *a, **k: "B")
        sess._frame_metrics = host_timed(plain["metrics"],
                                         lambda *a, **k: "metrics")
        sess._emit = keep_emit
        dfin.encode_p_slots = keep_anchor
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame, fmt="bgra") for frame in clip_r]
            stats = sess.end()
            torch.cuda.synchronize()
            wall = time.time() - t1
            launches_r = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin.encode_p_slots = plain["p"]
        types = "".join(it[3] for it in emitted)
        check({k: types.count(k) for k in "IPB"} == MEAS_TYPES
              and sorted(it[1] for it in emitted) == list(range(MEAS_FRAMES)),
              f"measured frame types {types}, want {MEAS_TYPES}")
        check(launches_r == {"sad": 0, "memc": 0,
                             "deblock": MEAS_TYPES["I"] + MEAS_TYPES["P"]},
              f"measured launches {launches_r}: want one deblock per I and P "
              "frame and no SAD or memc")
        frame_lines = [m for _, m in sess.log.history
                       if m.startswith("frame=")]
        check(set(stats.get("psnr", {})) == {"y", "u", "v", "global",
                                              "global_all"}
              and "ssim" in stats and len(frame_lines) == MEAS_FRAMES,
              f"end() stats {sorted(stats)}, {len(frame_lines)} frame= lines")
        check(stats["psnr"]["y"] > 30.0, f"luma PSNR {stats['psnr']}")
        # the Matroska file: one SimpleBlock per AU, in decode order, its
        # payload the AU without parameter sets, length-prefixed
        with open(mkv, "rb") as fh:
            blocks = mkv_blocks(fh.read())
        want = [(it[2], b"".join(len(n).to_bytes(4, "big") + n
                                 for n in iter_annexb_raw(it[0])
                                 if n[0] & 0x1F not in (7, 8)))
                for it in emitted]
        check(len(blocks) == MEAS_FRAMES and blocks == want,
              f"{len(blocks)} SimpleBlocks, equal to the AUs: "
              f"{blocks == want}")
        check(b"".join(outs) + stats["tail"] == b"".join(it[0]
                                                        for it in emitted),
              "the session returned the AUs it muxed")
        # deblock on the last P anchor's own maps (AQ QPs, ref_idx)
        (a_src, a_ry, _, _, a_qp, *_), out = anchors[-1]
        maps = dv.loop_filter_maps(out, a_qp, enc.mbh, enc.mbw, False,
                                   0, 0, enc.pps.chroma_qp_index_offset)
        recon = [out[k].contiguous()
                 for k in ("recon_y", "recon_u", "recon_v")]
        meas_err = {"deblock": max_diff(dbk.deblock_apply(*recon, *maps),
                                        dbk.deblock_apply_plain(*recon,
                                                                *maps)),
                    "bgra_to_i420": conv_err}
        check(not any(meas_err.values()),
              f"deblock vs plain on the measured anchor's maps: {meas_err}")
        err["deblock"] = max(err["deblock"], meas_err["deblock"])
        phase("session_1080p_measured", t, bytes=os.path.getsize(mkv),
              wall_s=round(wall, 3), fps=round(MEAS_FRAMES / wall, 3),
              types=types,
              ms_per_frame={k: [round(x, 1) for x in v]
                            for k, v in meas_ms.items() if k != "metrics"},
              metrics_ms=[round(x, 1) for x in meas_ms["metrics"]],
              convert_ms=round(conv_ms, 3),
              convert_device_ms=round(conv_dev_ms, 3),
              psnr={k: round(float(v), 3) for k, v in stats["psnr"].items()},
              ssim=round(float(stats["ssim"]), 5), launches=launches_r,
              mkv_blocks=len(blocks), session_max_abs_err=meas_err,
              card=repr(card))
        del anchors, out, recon, maps, conv, bgra_d

        # ---- 12. card vs CPU on a small clip, every command line -----------
        t = time.time()
        small = moving_clip(*SMALL_SIZE, L3_FRAMES, seed=2, shift=HIER_SHIFT)
        live = live_clip(*SMALL_SIZE, 6, seed=5, cut_at=3, fade_from=4)
        live_b = live_clip(*SMALL_SIZE, B_FRAMES, seed=15, cut_at=B_CUT,
                           fade_from=B_FRAMES - 4)
        live_m = live_clip(*SMALL_SIZE, M_FRAMES, seed=25, cut_at=M_CUT,
                           fade_from=M_FRAMES - 2)
        placebo_small = moving_clip(*SMALL_SIZE, PLACEBO_FRAMES, seed=19)
        # (command line, clip, display indices of the IDRs)
        lines = ((CMDLINE, small[:4], None), (CMDLINE_PARTS, small[:4], None),
                 (CMDLINE_L3, small, None), (CMDLINE_L4, small[:4], None),
                 (CMDLINE_VF + " --min-keyint 2", live, [0, 3]),
                 (CMDLINE_SF + " --min-keyint 2", live, [0, 3]),
                 (CMDLINE_VFB + " --min-keyint 2", live_b, [0, B_CUT]),
                 (CMDLINE_SFB + " --min-keyint 2", live_b, [0, B_CUT]),
                 (CMDLINE_VFB + " --min-keyint 2 --threads 1", live_b,
                  [0, B_CUT]),
                 # the multi-reference lines (the default session's scene
                 # cut is a P or B frame: its --min-keyint is 25)
                 (CMDLINE_MED, live_b, [0]),
                 (CMDLINE_FASTER + " --min-keyint 2", live_b, [0, B_CUT]),
                 (CMDLINE_SLOW + " --min-keyint 2", live_b, [0, B_CUT]),
                 (CMDLINE_MZL + " --min-keyint 2", live_m, [0, M_CUT]),
                 (CMDLINE_MZL + " --min-keyint 2 --me esa", live_m,
                  [0, M_CUT]),
                 ("--preset medium --min-keyint 2 --threads 1", live_b,
                  [0, B_CUT]),
                 # x264's last four presets (placebo's clip has no cut)
                 *((cmd + " --min-keyint 2", live_b, [0, B_CUT])
                   for cmd in PRESET_LINES),
                 (CMDLINE_PLACEBO, placebo_small, [0]))
        esa_cmd = CMDLINE_MZL + " --min-keyint 2 --me esa"
        sizes, idrs = {}, {}
        for cmd, clip_s, want_idr in lines:
            got, shown = {}, {}
            # (DEV is "cpu" only where the script is rehearsed without a
            # card: then one run stands for both)
            for d in dict.fromkeys((DEV, "cpu")):
                s = CompressSession(extra_cmdline=cmd, device=d)
                s.begin(*SMALL_SIZE)
                # the (display index, is_idr) of each AU the session emits
                shown[d] = []
                s._emit = (lambda outs, *a, _e=s._emit, _s=shown[d], **k:
                           _s.extend(it[1:3] for it in outs)
                           or _e(outs, *a, **k))
                if d == DEV and cmd == esa_cmd:
                    for m in mods.values():
                        m.LAUNCHES = 0
                outs = [s.compress(fr) for fr in clip_s]
                got[d] = (outs, s.end()["tail"], s.frames_info().delay)
                if d == DEV and cmd == CMDLINE_MED:
                    med_small = b"".join(outs) + got[d][1]
                if d == DEV and cmd == esa_cmd:
                    launches_esa = {k: m.LAUNCHES for k, m in mods.items()}
            check(got[DEV] == got["cpu"], f"card and CPU outputs differ at "
                  f"{SMALL_SIZE} for {cmd!r}")
            sizes[cmd] = len(b"".join(got["cpu"][0]) + got["cpu"][1])
            idrs[cmd] = [pts for pts, key in shown["cpu"] if key]
            check(want_idr is None or idrs[cmd] == want_idr,
                  f"IDRs of {cmd!r} at {idrs[cmd]}, want {want_idr} (the "
                  "scene cut an IDR)")
        # --me esa over the DPB: the SAD kernel once per reference of each
        # P frame (1, 2, 3, 3 before the cut, 1, 2 after it)
        esa_dpb = [min(d, 3) for d in range(1, M_CUT)] + \
            [min(d, 3) for d in range(1, M_FRAMES - M_CUT)]
        check(launches_esa == {"sad": sum(esa_dpb), "memc": 0,
                               "deblock": M_FRAMES},
              f"{esa_cmd!r} launches {launches_esa}: want the SAD kernel "
              f"{esa_dpb} times per P frame, one deblock per frame")
        # input formats, containers and telemetry: each line on the card and
        # on the CPU; the container files and end()'s stats must be equal
        for cmd, fmt, ext in SURFACE_LINES:
            files, ends = {}, {}
            for d in dict.fromkeys((DEV, "cpu")):
                path = os.path.join(tmp, f"surface_{d}.{ext}")
                s = CompressSession(extra_cmdline=cmd, device=d)
                s.begin(*SMALL_SIZE, output=path)
                for fr in live:
                    s.compress(as_format(fmt, fr), fmt=fmt)
                ends[d] = s.end()
                with open(path, "rb") as fh:
                    files[d] = fh.read()
            check(files[DEV] == files["cpu"] and ends[DEV] == ends["cpu"]
                  and len(files["cpu"]) > 0, f"card and CPU {ext} files or "
                  f"end() stats differ for {cmd!r} ({fmt} in)")
            if ext == "mp4":
                mp4_small = files[DEV]
            check(("psnr" in ends["cpu"]) == ("--psnr" in cmd),
                  f"{cmd!r} reports PSNR")
            sizes[f"{cmd} ({fmt} -> {ext})"] = len(files["cpu"])
        # the GOP-parallel route (one card named SHARD_DEVICES times; the
        # CPU as many times): encode_clip_gop_parallel, and the sharded
        # default session, which also equals --threads 1 with the options
        # it downgrades to
        from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
        from x264vfw_tpu_torch.parallel import gop as gopm
        from x264vfw_tpu_torch.parallel import transcode as tcm
        # the syntax-tensor CABAC route (I, P with partitions, three
        # references, B) on the card and on the CPU, and the card's
        # transcode route: one stream
        clip_hc = moving_clip(*SMALL_SIZE, HOST_CABAC_FRAMES, seed=20)
        for name, kw in HOST_CABAC.items():
            got = {}
            for d, host in dict.fromkeys(((DEV, True), ("cpu", True),
                                          (DEV, False))):
                e = TorchEncoder(EncoderConfig(
                    width=SMALL_SIZE[0], height=SMALL_SIZE[1], cabac=True,
                    **kw), device=d)
                e.host_entropy = host
                got[d, host] = b"".join(
                    [au for f in clip_hc for au, *_ in e.push_frame(*f)]
                    + [au for au, *_ in e.flush()])
            check(len(set(got.values())) == 1, f"host CABAC {name}: the "
                  "card's, the CPU's and the transcode route's streams "
                  f"differ at {SMALL_SIZE}")
            sizes[f"host CABAC {name}"] = len(got[DEV, True])
        cfg_s = EncoderConfig(width=SMALL_SIZE[0], height=SMALL_SIZE[1],
                              qp=26, keyint=GOP_LEN, search_range=16,
                              deblock=True, partitions=True,
                              me_backend="pallas")
        clip_s = small[:GOP_LEN * GOP_COUNT]
        gop_small = {d: gopm.encode_clip_gop_parallel(
            clip_s, cfg_s, devices=[d] * SHARD_DEVICES)
            for d in dict.fromkeys((DEV, "cpu"))}
        check(gop_small[DEV] == gop_small["cpu"], "card and CPU "
              "encode_clip_gop_parallel streams differ")
        sizes["encode_clip_gop_parallel"] = len(gop_small["cpu"])
        shard = {}
        for d in dict.fromkeys((DEV, "cpu")):
            s = CompressSession(extra_cmdline=CMDLINE_THREADS_CQP, device=d,
                                devices=[d] * SHARD_DEVICES)
            s.begin(*SMALL_SIZE)
            check(s._shard, f"{CMDLINE_THREADS_CQP!r} shards on {d}")
            shard[d] = b"".join(s.compress(fr) for fr in
                                small[:THREADS_FRAMES]) + s.end()["tail"]
        s = CompressSession(extra_cmdline=CMDLINE_THREADS_1, device=DEV)
        s.begin(*SMALL_SIZE)
        single = b"".join(s.compress(fr) for fr in small[:THREADS_FRAMES]) \
            + s.end()["tail"]
        check(shard[DEV] == shard["cpu"], "card and CPU sharded sessions "
              "differ")
        check(shard[DEV] == single, "the sharded session differs from "
              f"{CMDLINE_THREADS_1!r}")
        sizes[CMDLINE_THREADS_CQP] = len(shard["cpu"])
        # the transcode of a CAVLC source (slice 2's options) to half the
        # size; the frames the scaler hands to the encoder are kept
        s = CompressSession(extra_cmdline=CMDLINE_PARTS, device=DEV)
        s.begin(*SMALL_SIZE)
        tc_src = b"".join(s.compress(fr) for fr in small[:TC_FRAMES]) + \
            s.end()["tail"]
        dst = (SMALL_SIZE[0] // 2, SMALL_SIZE[1] // 2)
        tc_out, tc_frames = {}, {}
        plain_scaled = tcm._scaled
        for d in dict.fromkeys((DEV, "cpu")):
            tc_frames[d] = []
            tcm._scaled = (lambda *a, _k=tc_frames[d], **k:
                           _k.append(plain_scaled(*a, **k)) or _k[-1])
            try:
                tc_out[d] = tcm.transcode(tc_src, *dst, device=d)
            finally:
                tcm._scaled = plain_scaled
        tc_diff = sum(int((p != q).sum()) for x, y in
                      zip(tc_frames[DEV], tc_frames["cpu"])
                      for p, q in zip(x, y))
        tc_reencoded = False
        if tc_out[DEV] != tc_out["cpu"]:
            # the scaler rounded some sample the other way: the card's
            # re-encode of the CPU's scaled frames must equal the CPU's
            check(tc_diff > 0, "card and CPU transcodes differ with equal "
                  "scaled frames")
            s = CompressSession(tcm.EncoderParams(rc_mode="cqp", qp=26),
                                device=DEV)
            s.begin(*dst)
            again = b"".join(s.compress(fr) for fr in tc_frames["cpu"]) + \
                s.end()["tail"]
            check(again == tc_out["cpu"], "the card's re-encode of the "
                  "CPU's scaled frames differs from the CPU's transcode")
            tc_reencoded = True
        sizes["transcode"] = len(tc_out["cpu"])
        phase("card_vs_cpu", t, bytes=list(sizes.values()),
              idrs=list(idrs.values()), identical=True,
              esa_launches=launches_esa,
              transcode_scaled_diff=[tc_diff, sum(
                  p.size for x in tc_frames["cpu"] for p in x)],
              transcode_compared_reencode=tc_reencoded)

        # ---- 13. decode_1080p: the decoder on the card -------------------
        t = time.time()
        from x264vfw_tpu_torch.api import DecompressSession
        from x264vfw_tpu_torch.decode import device_decode as ddec
        # the third stream: I4x4 in the I frame, two references in the
        # last P
        clip_d = moving_clip(w, h, DEC_FRAMES, seed=6, texture=structured)
        sess = CompressSession(extra_cmdline=CMDLINE_DEC, device=DEV)
        sess.begin(w, h)
        enc = sess.encoder
        check((enc.cfg.i4x4, enc.cfg.cabac, enc.cfg.dct8x8, enc.cfg.deblock,
               enc.nref) == (True, False, False, True, 2)
              and sess._pipe is None, "the decode stream's options reach "
              "the per-frame encoder")
        dec_streams["faster_zl"] = ([], [])
        for frame in clip_d:
            dec_streams["faster_zl"][0].append(sess.compress(frame))
            dec_streams["faster_zl"][1].append(enc.last_recon)
        sess.end()
        # per picture: the C parse, upload and pull on the host clock; the
        # device span of decode_frame_core, the map build and the kernel
        # between CUDA events
        plain = {"parse": native_parse.parse_slice,
                 "upload": ddec.upload_syntax, "pull": ddec.pull_planes,
                 "core": ddec.decode_frame_core, "maps": ddec.build_maps,
                 "kernel": dbk.deblock_apply}
        cur, last_kernel = {}, []

        def host_timed(key):
            def run(*a, **k):
                torch.cuda.synchronize()
                t1 = time.time()
                res = plain[key](*a, **k)
                torch.cuda.synchronize()
                cur[key] = cur.get(key, 0.0) + (time.time() - t1) * 1e3
                return res
            return run

        def device_timed(key):
            def run(*a, **k):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                res = plain[key](*a, **k)
                ev[1].record()
                cur.setdefault("events", []).append((key, ev))
                if key == "core":
                    cur["type"] = "P" if a[2] is not None else "I"
                    cur["nref"] = 0 if a[2] is None else a[2].shape[0]
                if key == "kernel":
                    last_kernel[:] = [a]
                return res
            return run

        native_parse.parse_slice = host_timed("parse")
        ddec.upload_syntax = host_timed("upload")
        ddec.pull_planes = host_timed("pull")
        ddec.decode_frame_core = device_timed("core")
        ddec.build_maps = device_timed("maps")
        dbk.deblock_apply = device_timed("kernel")
        dec_stats, dec_launches, dec_fps, i_ops = {}, {}, {}, None
        try:
            for name, (aus_d, recons) in dec_streams.items():
                ds = DecompressSession(device=DEV)
                ds.begin()
                per = {"I": [], "P": []}
                frames, wall = [], 0.0
                dbk.LAUNCHES = 0
                for au in aus_d:
                    cur.clear()
                    t1 = time.time()
                    out = ds.decompress(au)
                    torch.cuda.synchronize()
                    ms = (time.time() - t1) * 1e3
                    wall += ms
                    if out is not None:
                        frames.append(out)
                    check("type" in cur, f"{name}: a picture left the "
                          "device route")
                    row = {"host": ms, "nref": cur["nref"],
                           **{k: cur.get(k, 0.0)
                              for k in ("parse", "upload", "pull")}}
                    for key, (e0, e1) in cur["events"]:
                        row[key] = row.get(key, 0.0) + e0.elapsed_time(e1)
                    per[cur["type"]].append(row)
                while (out := ds.decompress(b"")) is not None:
                    frames.append(out)
                dec_launches[name] = dbk.LAUNCHES
                check(dec_launches[name] == len(aus_d),
                      f"{name}: {dec_launches[name]} deblock launches for "
                      f"{len(aus_d)} pictures: each picture must take the "
                      "device route once")
                check(len(frames) == len(aus_d) and all(
                    all(np.array_equal(p, q) for p, q in zip(fr, rc))
                    for fr, rc in zip(frames, recons)),
                    f"{name}: the decoded frames equal the encoder's "
                    "reconstructions")
                dec_fps[name] = round(len(aus_d) / (wall / 1e3), 3)
                dec_stats[name] = {
                    k: {f: [round(r[f], 3) for r in v] for f in v[0]}
                    for k, v in per.items() if v}
            check(max(dec_stats["faster_zl"]["P"]["nref"]) == 2,
                  "the last P of the decode stream reads two references")
            # the I4x4 I frame's PyTorch operations on the card, counted
            # apart (the counting slows the host)
            ds = DecompressSession(device=DEV)
            ds.begin()
            ops = CudaOps()
            with ops:
                ds.decompress(dec_streams["faster_zl"][0][0])
            i_ops = ops.n
        finally:
            native_parse.parse_slice = plain["parse"]
            ddec.upload_syntax, ddec.pull_planes = plain["upload"], \
                plain["pull"]
            ddec.decode_frame_core = plain["core"]
            ddec.build_maps, dbk.deblock_apply = plain["maps"], \
                plain["kernel"]
        # the kernel against its plain version on the last picture's maps
        dec_err = max_diff(dbk.deblock_apply(*last_kernel[0]),
                           dbk.deblock_apply_plain(*last_kernel[0]))
        check(dec_err == 0, f"deblock vs plain on the decoded maps: max "
              f"|diff| {dec_err}")
        err["deblock"] = max(err["deblock"], dec_err)
        del dec_streams, clip_d

        # the second part: card against CPU at the small size, on a CAVLC
        # I/P stream with I4x4 and three references (the device route), the
        # default session's CABAC + B stream (the host route) and the MP4
        # file of the NV12 line (avcC and length-prefixed samples)
        s = CompressSession(extra_cmdline=CMDLINE_DEC + " --ref 3",
                            device=DEV)
        s.begin(*SMALL_SIZE)
        ref3 = [s.compress(fr) for fr in moving_clip(
            *SMALL_SIZE, DEC_SMALL_FRAMES, seed=16, texture=structured)]
        s.end()
        avcc, samples = mp4_samples(mp4_small)
        cases = [("ref3", ref3, {"fmt": fmt})
                 for fmt in DecompressSession.OUTPUT_FORMATS]
        cases += [("cabac_b", split_aus(med_small), {}),
                  ("mp4", samples, {"extradata": avcc})]
        core = ddec.decode_frame_core
        refs_seen = []

        def count_refs(syn, kinds, luma, *a, **k):
            refs_seen.append(0 if luma is None else luma.shape[0])
            return core(syn, kinds, luma, *a, **k)

        small = {}
        for name, aus_s, kw in cases:
            outs = {}
            for d in dict.fromkeys((DEV, "cpu")):
                refs_seen.clear()
                ddec.decode_frame_core = count_refs
                try:
                    outs[d] = run_decoder(DecompressSession(device=d), aus_s,
                                          SMALL_SIZE, **kw)
                finally:
                    ddec.decode_frame_core = core
                if name == "ref3" and d == DEV:
                    check(len(refs_seen) == DEC_SMALL_FRAMES
                          and max(refs_seen) == 3, f"the --ref 3 stream on "
                          f"the device route: references {refs_seen}")
            check(same_outputs(outs[DEV], outs["cpu"]), f"card and CPU "
                  f"decoders differ on {name} ({kw.get('fmt', 'i420')})")
            small[f"{name}_{kw.get('fmt', 'i420')}"] = len(outs["cpu"])
        # the scaler (128x96 to 64x48): within 1 of the CPU's
        sw, sh = SMALL_SIZE[0] // 2, SMALL_SIZE[1] // 2
        outs = {d: run_decoder(DecompressSession(device=d), ref3, SMALL_SIZE,
                               out_width=sw, out_height=sh)
                for d in dict.fromkeys((DEV, "cpu"))}
        diffs = [np.abs(p.astype(np.int32) - q) for x, y in
                 zip(outs[DEV], outs["cpu"]) for p, q in zip(x, y)]
        n_diff = sum(int((q != 0).sum()) for q in diffs)
        n_all = sum(q.size for q in diffs)
        check(max(int(q.max()) for q in diffs) <= 1
              and n_diff <= SCALE_MAX_SHARE * n_all,
              f"scaler card vs CPU: {n_diff} of {n_all} samples differ")
        phase("decode_1080p", t, fps=dec_fps, ms=dec_stats,
              launches=dec_launches, i_frame_cuda_ops=i_ops,
              kernel_max_abs_err=dec_err, small_identical=small,
              scale_diff=[n_diff, n_all], card=repr(card))

        # ---- 14. transcode_4k: decode -> scale -> re-encode from 4K -------
        t = time.time()
        tw, th = TC_SRC_SIZE
        clip_t = moving_clip(tw, th, TC_FRAMES, seed=13)
        sess = CompressSession(extra_cmdline=CMDLINE_PARTS, device=DEV)
        sess.begin(tw, th)
        enc = sess.encoder
        for m in mods.values():
            m.LAUNCHES = 0
        tc_src, tc_recons, tc_enc_ms = [], [], []
        for frame in clip_t:
            prev_ref = enc.ref
            t1 = time.time()
            tc_src.append(sess.compress(frame))
            torch.cuda.synchronize()
            tc_enc_ms.append((time.time() - t1) * 1e3)
            tc_recons.append(enc.last_recon)
        launches_src = {k: m.LAUNCHES for k, m in mods.items()}
        sess.end()
        check(launches_src == {"sad": TC_FRAMES - 1, "memc": TC_FRAMES - 1,
                               "deblock": TC_FRAMES},
              f"4K source launches {launches_src}")
        # SAD (both modes) and memc against their plain versions on the 4K
        # source's last P frame, formed as the encoder forms them
        # (names of their own: H, W and R stay the kernels' timed shape)
        r4 = enc.cfg.search_range
        src4 = torch.as_tensor(_pad(clip_t[-1][0], 16 * enc.mbh,
                                    16 * enc.mbw), device=dev) \
            .to(torch.uint8).contiguous()
        refp4 = dv._edge_pad(prev_ref[0], r4).to(torch.uint8).contiguous()
        refm4 = dv._edge_pad(prev_ref[0], r4 + 8).to(torch.uint8) \
            .contiguous()
        mins4 = sadk.sad_partition_minima(src4, refp4, r4)
        part4, mv8i4 = partition_decide_from_minima(mins4, r4, enc.qp)
        tc_err = {
            "sad": max_diff(mins4, sadk.sad_partition_minima_plain(
                src4, refp4, r4)),
            "quad": max_diff(sadk.sad_search_quad(src4, refp4, r4),
                             sadk.sad_search_quad_plain(src4, refp4, r4))}
        for sub_lv in (0, 1, 2):
            tc_err[f"memc_lv{sub_lv}"] = max_diff(
                memck.partition_refine_mc(src4, refm4, mv8i4, part4, r4,
                                          sub_lv),
                memck.partition_refine_mc_plain(src4, refm4, mv8i4, part4,
                                                r4, sub_lv))
        del src4, refp4, refm4, mins4, part4, mv8i4, prev_ref
        # the transcode, each stage timed: the decode (CUDA events around
        # each picture's decode_frame_core), the scale per frame and each
        # compress() and end() call of the re-encode
        from x264vfw_tpu_torch.decode import device_decode as ddec
        stage = {"decode": [], "scale": [], "encode": []}
        core_ev, db_args, tc_state = [], [], {}
        plain = {"dec": tcm.H264Decoder, "sess": tcm.CompressSession,
                 "scaled": tcm._scaled, "core": ddec.decode_frame_core,
                 "kernel": dbk.deblock_apply}

        def host_ms(key, fn, *a, **k):
            t1 = time.time()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            stage[key].append((time.time() - t1) * 1e3)
            return res

        class TimedDecoder(plain["dec"]):
            def decode(self, annexb):
                res = host_ms("decode", super().decode, annexb)
                tc_state["frames"] = self.display_order()
                tc_state["decode_launches"] = dbk.LAUNCHES
                return res

        class TimedSession(plain["sess"]):
            def begin(self, *a, **k):
                tc_state["session"] = self
                return super().begin(*a, **k)

            def compress(self, *a, **k):
                return host_ms("encode", super().compress, *a, **k)

            def end(self):
                return host_ms("encode", super().end)

        def timed_core(syn, kinds, luma, *a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = plain["core"](syn, kinds, luma, *a, **k)
            ev[1].record()
            core_ev.append(("I" if luma is None else "P", ev))
            return res

        def keep_db(*a, **k):
            if "frames" not in tc_state:       # the decode's calls
                db_args[:] = [a]
            return plain["kernel"](*a, **k)

        tcm.H264Decoder, tcm.CompressSession = TimedDecoder, TimedSession
        tcm._scaled = lambda *a, **k: host_ms("scale", plain["scaled"], *a,
                                              **k)
        ddec.decode_frame_core, dbk.deblock_apply = timed_core, keep_db
        mp4_tc = os.path.join(tmp, "transcode.mp4")
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            tc_out = tcm.transcode(b"".join(tc_src), *TC_DST_SIZE,
                                   output=mp4_tc, device=DEV)
            torch.cuda.synchronize()
            tc_wall = time.time() - t1
            launches_tc = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            tcm.H264Decoder, tcm.CompressSession = plain["dec"], \
                plain["sess"]
            tcm._scaled = plain["scaled"]
            ddec.decode_frame_core, dbk.deblock_apply = plain["core"], \
                plain["kernel"]
        check(len(core_ev) == TC_FRAMES and tc_state["decode_launches"]
              == TC_FRAMES, f"every 4K picture on the device route: "
              f"{len(core_ev)} cores, {tc_state['decode_launches']} deblock "
              "launches")
        check(all(all(np.array_equal(getattr(f, k), r) for k, r in
                      zip("yuv", rc))
                  for f, rc in zip(tc_state["frames"], tc_recons)),
              "the 4K decode equals the encoder's reconstructions")
        tc_aus = split_aus(tc_out)
        types = "".join("I" if u.nal_unit_type == 5 else
                        ("P" if u.nal_ref_idc else "B")
                        for u in split_annexb(tc_out)
                        if u.nal_unit_type in (1, 5))
        check(len(tc_aus) == TC_FRAMES and len(types) == TC_FRAMES
              and types[0] == "I", f"{len(tc_aus)} AUs ({types}) out of "
              f"{TC_FRAMES} frames")
        want_db = TC_FRAMES + types.count("I") + types.count("P")
        check(launches_tc["deblock"] == want_db, f"transcode deblock "
              f"launches {launches_tc}: want one per decoded picture and "
              f"per re-encoded I and P frame ({want_db})")
        with open(mp4_tc, "rb") as fh:
            _, samples = mp4_samples(fh.read())
        want = [b"".join(len(n).to_bytes(4, "big") + n
                         for n in iter_annexb_raw(au)
                         if n[0] & 0x1F not in (7, 8)) for au in tc_aus]
        check(samples == want, f"{len(samples)} MP4 samples equal to the "
              f"length-prefixed AUs: {samples == want}")
        tc_err["deblock"] = max_diff(dbk.deblock_apply(*db_args[0]),
                                     dbk.deblock_apply_plain(*db_args[0]))
        check(not any(tc_err.values()), f"kernels vs plain on the 4K "
              f"source's last P frame and the 4K decode's maps: {tc_err}")
        for k in KERNELS:
            err[k] = max([err[k]] + [d for n, d in tc_err.items()
                                     if n.startswith(k) or (k == "sad"
                                                            and n == "quad")])
        core_ms = [(ft, e0.elapsed_time(e1)) for ft, (e0, e1) in core_ev]
        out_w, out_h = tc_state["session"].params.width, \
            tc_state["session"].params.height
        check((out_w, out_h) == TC_DST_SIZE, f"re-encoded at {out_w}x{out_h}")
        del db_args, tc_state, clip_t, tc_recons
        phase("transcode_4k", t, src_bytes=len(b"".join(tc_src)),
              out_bytes=len(tc_out), types=types,
              encode_4k_ms=[round(x, 1) for x in tc_enc_ms],
              decode_ms_per_frame=round(sum(stage["decode"]) / TC_FRAMES, 1),
              decode_core_ms=[(ft, round(x, 1)) for ft, x in core_ms],
              scale_ms=[round(x, 2) for x in stage["scale"]],
              reencode_ms_per_frame=round(sum(stage["encode"]) / TC_FRAMES,
                                          1),
              reencode_call_ms=[round(x, 1) for x in stage["encode"]],
              wall_s=round(tc_wall, 3), fps=round(TC_FRAMES / tc_wall, 3),
              launches=launches_tc, source_launches=launches_src,
              session_max_abs_err=tc_err, mp4_samples=len(samples),
              card=repr(card))

        # ---- 15. gop_1080p: encode_clip_gop_parallel on one card, twice -----
        t = time.time()
        cfg_g = EncoderConfig(width=w, height=h, qp=26, keyint=GOP_LEN,
                              search_range=16, deblock=True, partitions=True,
                              me_backend="pallas")
        clip_g = clip[:GOP_LEN * GOP_COUNT]
        gop_ms = []
        plain_gop = gopm.encode_gop_packed_device

        def timed_gop(*a, **k):
            t1 = time.time()
            res = plain_gop(*a, **k)
            torch.cuda.synchronize()
            gop_ms.append((time.time() - t1) * 1e3)
            return res

        gopm.encode_gop_packed_device = timed_gop
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            stream_g = gopm.encode_clip_gop_parallel(
                clip_g, cfg_g, devices=[dev] * SHARD_DEVICES)
            torch.cuda.synchronize()
            wall_g = time.time() - t1
            launches_g = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            gopm.encode_gop_packed_device = plain_gop
        enc = TorchEncoder(cfg_g, device=DEV)
        t1 = time.time()
        single = b"".join(enc.encode_frame(*f) for f in clip_g)
        torch.cuda.synchronize()
        wall_1 = time.time() - t1
        check(stream_g == single, "the GOP-parallel stream differs from the "
              "per-frame encoder's at keyint = GOP length")
        n_p = GOP_COUNT * (GOP_LEN - 1)
        check(launches_g == {"sad": n_p, "memc": n_p,
                             "deblock": GOP_COUNT * GOP_LEN},
              f"gop_1080p launches {launches_g}: want one SAD and memc per "
              "P frame, one deblock per frame")
        nals = [u.nal_unit_type for u in split_annexb(stream_g)]
        check(nals.count(5) == GOP_COUNT and nals.count(1) == n_p,
              f"{GOP_COUNT} IDRs and {n_p} P slices: {nals}")
        phase("gop_1080p", t, bytes=len(stream_g), wall_s=round(wall_g, 3),
              gop_ms=[round(x, 1) for x in gop_ms],
              per_frame_encoder_s=round(wall_1, 3),
              fps=round(len(clip_g) / wall_g, 3),
              per_frame_fps=round(len(clip_g) / wall_1, 3),
              launches=launches_g, card=repr(card))

        # ---- 16. session_1080p_threads: --threads 4 on one card, twice ------
        t = time.time()
        clip_th = moving_clip(w, h, THREADS_FRAMES, seed=14)
        sess = CompressSession(extra_cmdline=CMDLINE_THREADS, device=DEV,
                               devices=[dev] * SHARD_DEVICES)
        msgs = []
        sess.log.sink = lambda lvl, m: msgs.append(m)
        sess.begin(w, h)
        pipe = sess._pipe
        warned = [m.split("support ")[1].split(";")[0] for m in msgs
                  if "(sharded GOP mode)" in m]
        check(sess._shard and isinstance(pipe, gopm.GopShardPipeline)
              and pipe.G == 4 and warned == SHARD_WARNED,
              f"--threads 4 over two devices shards, downgrading "
              f"{SHARD_WARNED}: {warned}")
        cfg = sess.encoder.cfg
        check((cfg.bframes, sess.encoder.nref, cfg.weightp, cfg.scenecut,
               sess.mbtree, sess.encoder.partitions, cfg.cabac, cfg.i4x4)
              == (0, 1, 0, 0, None, True, True, True),
              "the downgraded options reach the encoder")
        marks = []
        plain_unpack, plain_gop = gopm._unpack_src, gopm.encode_gop_packed_device

        def mark_unpack(*a, **k):
            torch.cuda.synchronize()
            marks.append(("frame", time.time()))
            return plain_unpack(*a, **k)

        def mark_gop(*a, **k):
            res = plain_gop(*a, **k)
            torch.cuda.synchronize()
            marks.append(("end", time.time()))
            return res

        gopm._unpack_src, gopm.encode_gop_packed_device = mark_unpack, \
            mark_gop
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame) for frame in clip_th]
            tail = sess.end()["tail"]
            torch.cuda.synchronize()
            wall_th = time.time() - t1
            launches_th = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            gopm._unpack_src, gopm.encode_gop_packed_device = plain_unpack, \
                plain_gop
        check([bool(o) for o in outs] == [False] * (THREADS_FRAMES - 1)
              + [True] and not tail
              and sess.frames_info().delay == THREADS_FRAMES - 1,
              "compress() returns b'' until the batch of two GOPs fills, "
              "then all of it (frames_info().delay)")
        stream = b"".join(outs)
        nals = [u.nal_unit_type for u in split_annexb(stream)]
        n_p = THREADS_FRAMES - THREADS_FRAMES // 4
        check(nals.count(5) == THREADS_FRAMES // 4 and nals.count(1) == n_p
              and len(split_aus(stream)) == THREADS_FRAMES,
              f"2 IDRs and {n_p} P slices in {THREADS_FRAMES} AUs: {nals}")
        check(launches_th == {"sad": n_p, "memc": n_p,
                              "deblock": THREADS_FRAMES},
              f"threads launches {launches_th}: want one SAD and memc per "
              "P frame, one deblock per frame")
        # each frame from its unpack to the next frame's (or its GOP's end)
        frame_ms = {"I": [], "P": []}
        k = 0
        for (kind, t_a), (_, t_b) in zip(marks, marks[1:]):
            if kind == "frame":
                frame_ms["I" if k % 4 == 0 else "P"].append(
                    (t_b - t_a) * 1e3)
                k += 1
        check(k == THREADS_FRAMES, f"{k} frames timed")
        phase("session_1080p_threads", t, bytes=len(stream),
              wall_s=round(wall_th, 3), fps=round(THREADS_FRAMES / wall_th,
                                                  3),
              ms_per_frame={t_: [round(x, 1) for x in v]
                            for t_, v in frame_ms.items()},
              cabac_ms=[round(x, 2) for x in pipe.transcode_ms],
              delay=sess.frames_info().delay, warned=warned,
              launches=launches_th, card=repr(card))
        del clip_th, outs, stream

        # ---- 17. placebo_1080p: x264's --preset placebo -----------------
        t = time.time()
        clip_pl = moving_clip(w, h, PLACEBO_FRAMES, seed=17)
        sess = CompressSession(extra_cmdline=CMDLINE_PLACEBO, device=DEV)
        sess.begin(w, h)
        enc, pipe = sess.encoder, sess._pipe
        cfg = enc.cfg
        check(pipe is not None and sess.mbtree is not None
              and (enc.nref, cfg.bframes, cfg.me_backend, cfg.subpel,
                   cfg.search_range, cfg.trellis, enc.partitions, cfg.cabac,
                   cfg.dct8x8, cfg.i4x4, cfg.deblock)
              == (4, 16, "auto", 2, 16, True, False, True, True, False, True),
              "--preset placebo's options reach the batched session (its "
              "--partitions all selects neither P partitions nor I4x4, as "
              "in the JAX package)")
        R = cfg.search_range
        want_anchors, want_refs, n_b = placebo_schedule(PLACEBO_FRAMES)
        # per frame type each phase-1 call's device span; the SAD calls
        # made in B cores and in anchors, with the inputs of the first B
        # frame's two and of every anchor's; each pipeline run's frames
        ev = {"I": [], "P": [], "B": []}
        sad_n, sad_in = {"b": 0, "p": 0}, {"b": [], "p": []}
        in_b, order, runs, tc_frame, i_recon = [False], [], [], [], []
        plain = {"frame": enc.encode_frame, "pgop": dfin.encode_pgop_slots,
                 "bgop": dfin.encode_bgop_slots, "b": dfin.encode_b_slots,
                 "sad": dv.sad16_argmin, "bcore": dv.encode_b_frame_core,
                 "emit": sess._emit, "run": pipe._run}

        def keep_sad(src8, refp, R_):
            kind = "b" if in_b[0] else "p"
            sad_n[kind] += 1
            if kind == "p" or len(sad_in["b"]) < 2:
                sad_in[kind].append((src8, refp))
            return plain["sad"](src8, refp, R_)

        def b_core(*a, **k):
            in_b[0] = True
            try:
                return plain["bcore"](*a, **k)
            finally:
                in_b[0] = False

        def keep_run(final):
            first = enc.display_idx
            res = plain["run"](final)
            runs.append((first, enc.display_idx, [it[1] for it in res]))
            return res

        def keep_frame(*a, **k):
            res = timed(plain["frame"], lambda *a, force_idr=None, **k: (
                "I" if force_idr else "P", 1))(*a, **k)
            tc_frame.append(enc.transcode_ms)
            if k.get("force_idr"):
                i_recon.append(enc.last_recon[0])
            return res

        def keep_order(outs, *a, **k):
            order.extend((it[1], it[3]) for it in outs)
            return plain["emit"](outs, *a, **k)

        dfin.encode_pgop_slots = timed(
            plain["pgop"], lambda rows, *a, **k: ("P", rows.shape[0]))
        dfin.encode_bgop_slots = timed(
            plain["bgop"], lambda rows, *a, **k: ("B", rows.shape[0]))
        dfin.encode_b_slots = timed(plain["b"], lambda *a, **k: ("B", 1))
        dv.sad16_argmin, dv.encode_b_frame_core = keep_sad, b_core
        enc.encode_frame, sess._emit, pipe._run = keep_frame, keep_order, \
            keep_run
        try:
            for m in mods.values():
                m.LAUNCHES = 0
            t1 = time.time()
            outs = [sess.compress(frame) for frame in clip_pl]
            tail = sess.end()["tail"]
            torch.cuda.synchronize()
            wall_pl = time.time() - t1
            launches_pl = {k: m.LAUNCHES for k, m in mods.items()}
        finally:
            dfin.encode_pgop_slots = plain["pgop"]
            dfin.encode_bgop_slots = plain["bgop"]
            dfin.encode_b_slots = plain["b"]
            dv.sad16_argmin = plain["sad"]
            dv.encode_b_frame_core = plain["bcore"]
        stream = b"".join(outs) + tail
        types = "".join(ft for _, ft in order)
        want_types = {"I": 1, "P": len(want_anchors), "B": n_b}
        check({k: types.count(k) for k in "IPB"} == want_types
              and sorted(d for d, _ in order) == list(range(PLACEBO_FRAMES))
              and sorted(d for d, ft in order if ft == "P") == want_anchors,
              f"placebo frame types {types}, want {want_types}, anchors "
              f"{want_anchors}")
        vcl = [u for u in split_annexb(stream) if u.nal_unit_type in (1, 5)]
        check("".join("I" if u.nal_unit_type == 5 else
                      ("P" if u.nal_ref_idc else "B") for u in vcl) == types,
              f"NAL types and nal_ref_idc follow the frame types {types}")
        want_pl = {"sad": sum(want_refs) + 2 * n_b, "memc": 0,
                   "deblock": 1 + len(want_anchors)}
        check(launches_pl == want_pl and sad_n == {"b": 2 * n_b,
                                                   "p": sum(want_refs)},
              f"placebo launches {launches_pl} ({sad_n} in B cores and "
              f"anchors): want {want_pl}, the SAD kernel once per reference "
              f"of each anchor {want_refs} and twice per B frame")
        delay = sess.frames_info().delay
        check(delay == sess.params.bframes + min(sess.params.rc_lookahead, 60)
              + 2 * pipe.window - 1 == 99,
              f"placebo frames_info().delay {delay}, want 99")
        if PLACEBO_FRAMES > 60 + pipe.window:
            # the first window: the IDR out, B candidates 1-11 pending
            # into the next run
            check(runs[0][:2] == (0, pipe.window) and runs[0][2] == [0]
                  and set(range(1, pipe.window)) <= set(runs[1][2]),
                  f"placebo's first B run waits across the first window: "
                  f"{[(a, b) for a, b, _ in runs]}")
        psnr_i = psnr(i_recon[0], clip_pl[0][0])
        psnr_last = psnr(enc.last_recon[0], clip_pl[want_anchors[-1]][0])
        check(psnr_i > 30.0 and psnr_last > 30.0, f"PSNR of the I frame "
              f"{psnr_i} and of the last anchor {psnr_last}")
        # the SAD kernel against its plain version on the first B frame's
        # L0 and L1 inputs and on the deepest anchor's last reference
        j = want_refs.index(max(want_refs))
        deep = sum(want_refs[:j]) + want_refs[j] - 1
        pl_in = {"b_l0": sad_in["b"][0], "b_l1": sad_in["b"][1],
                 f"anchor{want_anchors[j]}_ref{want_refs[j] - 1}":
                     sad_in["p"][deep]}
        pl_err = {k: max_diff(
            sadk.sad_partition_minima(src8, refp, R, (1, 0, 0, 0)),
            sadk.sad_partition_minima_plain(src8, refp, R, (1, 0, 0, 0)))
            for k, (src8, refp) in pl_in.items()}
        check(tuple(pl_in["b_l0"][0].shape) == (16 * enc.mbh, 16 * enc.mbw)
              and not any(pl_err.values()),
              f"SAD vs plain on placebo's B and anchor inputs: {pl_err}")
        err["sad"] = max([err["sad"]] + list(pl_err.values()))
        ms = {k: [a.elapsed_time(b) / n for a, b, n in v]
              for k, v in ev.items()}
        phase("placebo_1080p", t, bytes=len(stream), wall_s=round(wall_pl, 3),
              fps=round(PLACEBO_FRAMES / wall_pl, 3), types=want_types,
              anchors=want_anchors, references=want_refs, delay=delay,
              ms_per_frame={k: [round(x, 1) for x in v]
                            for k, v in ms.items()},
              cabac_ms_per_batch=[round(x, 2) for x in pipe.transcode_ms],
              cabac_ms_per_frame=[round(x, 2) for x in tc_frame],
              cabac_ms_per_slice=round(
                  (sum(pipe.transcode_ms) + sum(tc_frame)) / PLACEBO_FRAMES,
                  2),
              runs=[(a, b) for a, b, _ in runs], launches=launches_pl,
              sad_calls=sad_n, psnr_i=round(psnr_i, 2),
              psnr_last=round(psnr_last, 2), session_max_abs_err=pl_err,
              card=repr(card))
        del clip_pl, outs, stream, sad_in, pl_in

        # ---- 18. host_cabac_1080p: the syntax-tensor CABAC route --------
        t = time.time()
        from x264vfw_tpu_torch.bitstream import cabac_native as cn
        from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
        clip_hc = moving_clip(w, h, max(n for n, _ in
                                        HOST_CABAC_1080P.values()), seed=18)
        coders = ("encode_i_slice", "encode_p_slice", "encode_b_slice")
        plain_cn = {c: getattr(cn, c) for c in coders}
        coder_ms = {c[7]: [] for c in coders}

        def timed_coder(c):
            def run(*a, **k):
                t1 = time.perf_counter()
                res = plain_cn[c](*a, **k)
                coder_ms[c[7]].append((time.perf_counter() - t1) * 1e3)
                return res
            return run

        hc, launches_hc = {}, {}
        for name, (nfr, want) in HOST_CABAC_1080P.items():
            aus, launched, walls = {}, {}, {}
            for host in (True, False):
                enc = TorchEncoder(EncoderConfig(
                    width=w, height=h, cabac=True, **HOST_CABAC[name]),
                    device=DEV)
                enc.host_entropy = host
                if host:
                    for c in coders:
                        setattr(cn, c, timed_coder(c))
                try:
                    for m in mods.values():
                        m.LAUNCHES = 0
                    t1 = time.time()
                    got = [au for f in clip_hc[:nfr]
                           for au, *_ in enc.push_frame(*f)]
                    got += [au for au, *_ in enc.flush()]
                    torch.cuda.synchronize()
                    walls[host] = time.time() - t1
                    launched[host] = {k: m.LAUNCHES for k, m in mods.items()}
                finally:
                    for c in coders:
                        setattr(cn, c, plain_cn[c])
                aus[host] = got
            check(len(aus[True]) == nfr and aus[True] == aus[False],
                  f"host CABAC {name}: the route's {len(aus[True])} AUs "
                  "differ from the transcode route's")
            check(launched[True] == want and launched[False] == want,
                  f"host CABAC {name} launches {launched}, want {want}")
            launches_hc[name] = launched[True]
            hc[name] = {"bytes": len(b"".join(aus[True])),
                        "wall_s": round(walls[True], 3),
                        "transcode_route_wall_s": round(walls[False], 3)}
        phase("host_cabac_1080p", t, configs=hc,
              coder_ms={k: [round(x, 2) for x in v]
                        for k, v in coder_ms.items()},
              launches=launches_hc, identical=True, card=repr(card))
        launches_hc = {k: sum(v[k] for v in launches_hc.values())
                       for k in KERNELS}
        del clip_hc

        # ---- 19. the command line on the card ------------------------------
        t = time.time()
        y4m, out_cli = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "cli.mp4")
        clip_c = moving_clip(*SMALL_SIZE, 6, seed=12)
        with open(y4m, "wb") as fh:
            fh.write(f"YUV4MPEG2 W{SMALL_SIZE[0]} H{SMALL_SIZE[1]} F25:1 Ip "
                     "A1:1 C420jpeg\n".encode())
            for fr in clip_c:
                fh.write(b"FRAME\n" + b"".join(p.tobytes() for p in fr))
        rc = cli.main(["--preset", "ultrafast", "--frames", "4", "-o",
                       out_cli, y4m], device=DEV)
        check(rc == 0, f"the CLI returned {rc}")
        out_sess = os.path.join(tmp, "session.mp4")
        s = CompressSession(extra_cmdline="--preset ultrafast", device=DEV)
        s.begin(*SMALL_SIZE, output=out_sess)
        for fr in clip_c[:4]:
            s.compress(fr)
        s.end()
        with open(out_cli, "rb") as a, open(out_sess, "rb") as b:
            cli_bytes, sess_bytes = a.read(), b.read()
        check(cli_bytes == sess_bytes and len(cli_bytes) > 0,
              "the CLI's .mp4 equals a CompressSession's from the same frames")
        phase("cli", t, bytes=len(cli_bytes), identical=True)

        # ---- 20. the record -------------------------------------------------
        meta = {
            "sad": ("csrc/sad.cu", "x264vfw_tpu/ops/pallas/sad.py:239"),
            "memc": ("csrc/memc.cu", "x264vfw_tpu/ops/pallas/memc.py:253"),
            "deblock": ("csrc/deblock.cu",
                        "x264vfw_tpu/ops/pallas/deblock.py:206"),
        }
        names = {"sad": "sad_partition_minima", "memc": "partition_refine_mc",
                 "deblock": "deblock_apply"}
        kernels = []
        for k in KERNELS:
            ms, plain_ms, bound_ms, bound_by, ms_b2b = timing[k]
            rec = {
                "name": names[k], "route": "cuda",
                "source": "x264vfw_tpu_torch/" + meta[k][0],
                "replaces": meta[k][1], "launches": launches_vb[k],
                "max_abs_err": err[k], "ms": ms, "ms_b2b": ms_b2b,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "matched": err[k] == 0,
                "veryfast_launches": launches_v[k],
                "slice2_launches": launches[k],
                "l3_launches": launches3[k], "l4_launches": launches4[k],
                "medium_launches": launches_m[k],
                "medium_esa_launches": launches_esa[k],
                "measured_launches": launches_r[k],
                "transcode_4k_launches": launches_tc[k],
                "transcode_4k_source_launches": launches_src[k],
                "gop_1080p_launches": launches_g[k],
                "threads_launches": launches_th[k],
                "placebo_launches": launches_pl[k],
                "host_cabac_launches": launches_hc[k],
                "build_s": build_s[k], "ptxas": ptxas_report(k),
                "shape": [H, W, R], "card": card}
            if k == "sad":
                rec.update({"int_bound_ms": sad_int_bound_ms(H, W, R),
                            "sass_per_sad4": sad_sass_per_sad4(),
                            "slice1_launches": launches1["sad"],
                            "quad_replaces":
                                "x264vfw_tpu/ops/pallas/sad.py:426",
                            "quad_ms": quad[0], "quad_ms_b2b": quad[4],
                            "quad_plain_ms": quad[1],
                            "quad_bound_ms": quad[2],
                            "quad_bound_by": quad[3]})
            if k == "deblock":
                rec["launches_per_frame"] = launches_vb[k] // (
                    VFB_TYPES["I"] + VFB_TYPES["P"])
                rec["decode_launches"] = dec_launches
            kernels.append(rec)
        print(card, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
