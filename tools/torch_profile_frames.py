"""Where a frame's time goes in the PyTorch/CUDA port, on one CUDA card.

    python3 tools/torch_profile_frames.py [--width 1920 --height 1080]
                                          [--parts] [--out profile.jsonl]

Encodes a textured clip moving by a known shift with the port's
CompressSession (--preset ultrafast --tune zerolatency --me esa --qp 26
--keyint 2, so I and P frames alternate; with --parts also --deblock 0:0
--partitions p8x8 --subme 7), warms up on the first two frames, then
profiles two I and two P frames one by one with torch.profiler.  Prints one JSON line per profiled frame: host wall ms
(under the profiler, which slows the host), the summed duration of the
CUDA kernels, the device's busy share of the wall time, the number of
kernel launches, and the top kernels by device time.  Then one line per
frame type with the host-clock ms of each stage of a frame (upload, core,
CAVLC slots, pack, pull, NAL wrap), synchronised after each stage;
`p_core` includes the motion search, which `motion_search_mc` times
alone (with --parts: the partition search, refinement and MC), and
`deblock` times the loop filter of the frame's reconstruction.  --out
also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CMDLINE = ("--preset ultrafast --tune zerolatency --me esa --qp 26 "
           "--keyint 2")
PARTS = " --deblock 0:0 --partitions p8x8 --subme 7"


def clip(w: int, h: int, frames: int, shift=(3, -2), seed: int = 1):
    rng = np.random.default_rng(seed)
    m = 64
    n = rng.integers(0, 256, (h + 2 * m + 2, w + 2 * m + 2)).astype(np.int32)
    base = (sum(n[dy:dy + h + 2 * m, dx:dx + w + 2 * m]
                for dy in range(3) for dx in range(3)) // 9).astype(np.uint8)
    out = []
    for f in range(frames):
        y = np.ascontiguousarray(np.roll(base, (f * shift[1], f * shift[0]),
                                         (0, 1))[m:m + h, m:m + w])
        u = np.ascontiguousarray(y[::2, ::2])
        out.append((y, u, 255 - u))
    return out


def stage_lines(enc, prev, cur, card) -> list[str]:
    """Host-clock ms of each stage of one P frame (cur predicted from the
    reconstruction of prev) and of one I frame, with a device synchronise
    after each stage: the same calls TorchEncoder.encode_frame makes."""
    from x264vfw_tpu_torch.bitstream.mb_syntax import SLICE_I, SLICE_P
    from x264vfw_tpu_torch.bitstream.nal import NAL_SLICE, wrap_nal
    from x264vfw_tpu_torch.encode import device as dv
    from x264vfw_tpu_torch.encode import device_finalize as df
    from x264vfw_tpu_torch.encode import inter_partition as ip
    from x264vfw_tpu_torch.encode.torch_encoder import _pad
    H, W = enc.mbh * 16, enc.mbw * 16
    enc.encode_frame(*prev, force_idr=False)          # reference = recon
    out = []
    for ftype, frame in (("P", cur), ("I", cur)):
        ms = {}

        def stage(name, fn):
            t = time.time()
            r = fn()
            torch.cuda.synchronize()
            ms[name] = (time.time() - t) * 1e3
            return r

        src = stage("upload", lambda: torch.from_numpy(np.concatenate([
            np.ascontiguousarray(_pad(p, h, w), np.uint8).ravel()
            for p, h, w in zip(frame, (H, H // 2, H // 2),
                               (W, W // 2, W // 2))])).to(enc.device))
        planes = df._unpack_src(src, H, W)
        hv, hl = enc._header_slots(SLICE_P if ftype == "P" else SLICE_I,
                                   NAL_SLICE)
        cfg = enc.cfg
        if ftype == "P":
            if cfg.partitions:
                stage("motion_search_mc", lambda: ip.partition_search_and_mc(
                    *planes, *enc.ref, cfg.search_range, enc.qp,
                    cfg.subpel))
            else:
                stage("motion_search_mc", lambda: dv._motion_search_and_mc(
                    *planes, *enc.ref, cfg.search_range))
            o = stage("p_core", lambda: dv.encode_p_frame_core(
                *planes, *enc.ref, enc.qp, enc.qpc, cfg.search_range,
                cfg.subpel, partitions=cfg.partitions))
            v, ln = stage("cavlc_slots", lambda: df._finalize_p_core(
                o, hv, hl, enc.mbh, enc.mbw))
        else:
            o = stage("i_core", lambda: dv.encode_i_frame_core(
                *planes, enc.qp, enc.qpc))
            v, ln = stage("cavlc_slots", lambda: df._finalize_i_core(
                o, hv, hl, enc.mbh, enc.mbw))
        if cfg.deblock:
            stage("deblock", lambda: df._maybe_deblock(
                o, enc.qp, enc.mbh, enc.mbw, ftype == "I", True,
                cfg.deblock_alpha, cfg.deblock_beta,
                enc.pps.chroma_qp_index_offset))
        data, nbits = stage("pack", lambda: df.pack_slots(v, ln))
        payload = stage("pull", lambda: data[:(nbits + 7) // 8].cpu().numpy())
        stage("nal_wrap", lambda: wrap_nal(3, NAL_SLICE, payload))
        out.append(json.dumps({"stages": ftype, "ms": ms,
                               "parts": bool(cfg.partitions),
                               "payload_bytes": int(payload.size),
                               "card": card}))
        print(out[-1], flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--parts", action="store_true",
                    help="add --deblock 0:0 --partitions p8x8 --subme 7")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from x264vfw_tpu_torch.api import CompressSession

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=10).stdout.strip()
    frames = clip(args.width, args.height, 6)
    s = CompressSession(extra_cmdline=CMDLINE + (PARTS if args.parts
                                                 else ""))
    s.begin(args.width, args.height)
    for f in frames[:2]:                        # warm-up: I, P
        s.compress(f)
    torch.cuda.synchronize()
    lines = []
    for i, f in enumerate(frames[2:]):
        ftype = "I" if i % 2 == 0 else "P"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            s.compress(f)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        dev_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        line = {"frame": i + 2, "type": ftype, "wall_ms": wall_ms,
                "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
                "kernel_launches": len(kern),
                "top_device_ms": [[k[:80], v / 1e3] for k, v in top],
                "card": card, "size": [args.width, args.height],
                "parts": args.parts}
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    lines += stage_lines(s.encoder, frames[3], frames[4], card)
    s.end()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
