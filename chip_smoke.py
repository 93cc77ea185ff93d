"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port's main paths from csrc/ with nvcc (one
nvcc per source, in parallel) and holds each kernel against its plain
PyTorch version on the card: the full-search SAD (minima and quad mode),
partition_refine_mc and deblock_apply (and deblock_apply's repeated calls
against each other).  Then drives four 1080p
CompressSessions on clips of textured content moving by a known shift:

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

and checks each stream, its motion vectors and its reconstruction, and
holds the SAD (both modes) and partition_refine_mc kernels against their
plain versions once more on slice 2's last P frame's own inputs.  Then
it encodes a small clip with each command line on the card and on the
CPU and requires identical bytes.  Each kernel's launch count is set to 0
just before a session and read just after it.  Prints one line per phase
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
L3_FRAMES = 26           # two windows of 12 and a flush of 2
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


def moving_clip(w: int, h: int, frames: int, seed: int, shift=None):
    """I420 frames of a texture moving by shift (default SHIFT) per frame
    (no wrap inside the frame: the canvas has a margin wider than the
    total motion)."""
    dx, dy = shift or SHIFT
    m = max(64, frames * max(abs(dx), abs(dy)) + 8)
    base = textured(h + 2 * m, w + 2 * m, seed)
    out = []
    for f in range(frames):
        y = np.ascontiguousarray(
            np.roll(base, (f * dy, f * dx), (0, 1))[m:m + h, m:m + w])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from x264vfw_tpu_torch.api import CompressSession
    from x264vfw_tpu_torch.bitstream.nal import split_annexb
    from x264vfw_tpu_torch.encode import device as dv
    from x264vfw_tpu_torch.encode import device_finalize as dfin
    from x264vfw_tpu_torch.encode.inter_partition import \
        partition_decide_from_minima
    from x264vfw_tpu_torch.encode.torch_encoder import _pad
    from x264vfw_tpu_torch.ops.kernels import build
    from x264vfw_tpu_torch.ops.kernels import deblock as dbk
    from x264vfw_tpu_torch.ops.kernels import memc as memck
    from x264vfw_tpu_torch.ops.kernels import sad as sadk

    dev = torch.device(DEV)
    mods = {"sad": sadk, "memc": memck, "deblock": dbk}
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
        phase("build", t, seconds={k: round(v, 2) for k, v in build_s.items()},
              libs=[os.path.basename(build.library_path(k)) for k in KERNELS])

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
                stream += sess.compress(frame)
                torch.cuda.synchronize()
                frame_ms.append((time.time() - t1) * 1e3)
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
        maps = dv.loop_filter_maps(out, enc.qp, enc.mbh, enc.mbw, False,
                                   0, 0, enc.pps.chroma_qp_index_offset)
        recon = [out[k].contiguous()
                 for k in ("recon_y", "recon_u", "recon_v")]
        calls = {
            "sad": (lambda: sadk.sad_partition_minima(src8, refp_r, R),
                    lambda: sadk.sad_partition_minima_plain(src8, refp_r, R),
                    sad_bound_ms(H, W, R)),
            "memc": (lambda: memck.partition_refine_mc(src8, refp_m, mv8i,
                                                       part, R, 2),
                     lambda: memck.partition_refine_mc_plain(
                         src8, refp_m, mv8i, part, R, 2),
                     memc_bound_ms(H, W, R, 25)),
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
        phase("session_1080p_parts", t, bytes=len(stream),
              i_ms=round(frame_ms[0], 1),
              p_ms=[round(x, 1) for x in frame_ms[1:]],
              psnr_y=[round(x, 2) for x in psnrs],
              mv8_match=[round(x, 4) for x in mv_ok], launches=launches,
              session_max_abs_err=session_err, part_counts=part_counts,
              kernel_ms={k: round(v[0], 4) for k, v in timing.items()},
              kernel_ms_b2b={k: round(v[4], 4) for k, v in timing.items()},
              plain_ms={k: round(v[1], 2) for k, v in timing.items()},
              quad_ms=round(quad[0], 4), quad_ms_b2b=round(quad[4], 4))

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
                    sess.compress(frame)
            else:
                sess.compress(frame)
            torch.cuda.synchronize()
            frame_ms.append((time.time() - t1) * 1e3)
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

        # ---- 8. card vs CPU on a small clip, every command line ------------
        t = time.time()
        small = moving_clip(*SMALL_SIZE, L3_FRAMES, seed=2, shift=HIER_SHIFT)
        sizes = {}
        for cmd, n in ((CMDLINE, 4), (CMDLINE_PARTS, 4),
                         (CMDLINE_L3, L3_FRAMES), (CMDLINE_L4, 4)):
            got = {}
            for d in (DEV, "cpu"):
                s = CompressSession(extra_cmdline=cmd, device=d)
                s.begin(*SMALL_SIZE)
                outs = [s.compress(fr) for fr in small[:n]]
                got[d] = (outs, s.end()["tail"], s.frames_info().delay)
            check(got[DEV] == got["cpu"], f"card and CPU outputs differ at "
                  f"{SMALL_SIZE} for {cmd!r}")
            sizes[cmd] = len(b"".join(got["cpu"][0]) + got["cpu"][1])
        phase("card_vs_cpu", t, bytes=list(sizes.values()), identical=True)

        # ---- 9. the record -------------------------------------------------
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
                "replaces": meta[k][1], "launches": launches[k],
                "max_abs_err": err[k], "ms": ms, "ms_b2b": ms_b2b,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "matched": err[k] == 0,
                "l3_launches": launches3[k], "l4_launches": launches4[k],
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
                rec["launches_per_frame"] = launches[k] // nfr
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
