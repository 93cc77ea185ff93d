"""Where a frame's time goes in the PyTorch/CUDA port, on one CUDA card.

    python3 tools/torch_profile_frames.py [--width 1920 --height 1080]
                                          [--parts | --l4 | --veryfast |
                                           --batched | --medium]
                                          [--out profile.jsonl]

Encodes a textured clip moving by a known shift with the port's
CompressSession (--preset ultrafast --tune zerolatency --me esa --qp 26
--keyint 2, so I and P frames alternate; with --parts also --deblock 0:0
--partitions p8x8 --subme 7; with --l4 the line --preset ultrafast
--tune zerolatency --qp 26 --subme 7 --deblock 0:0 --keyint 2, whose
search is the hierarchical one; with --veryfast x264's --preset veryfast
--tune zerolatency --crf 23 --keyint 2: CABAC, I4x4, the 8x8 transform,
AQ, weighted P, partitions), warms up on the first two frames, then
profiles two I and two P frames (with --veryfast one of each) one by one
with torch.profiler.  Prints
one JSON line per profiled frame: host wall ms (under the profiler,
which slows the host), the summed duration of the CUDA kernels, the
device's busy share of the wall time, the number of kernel launches, and
the top kernels by device time.  Then one line per frame type with the
host-clock ms of each stage of a frame (upload, core, CAVLC slots, pack,
pull, NAL wrap), synchronised after each stage; `p_core` includes the
motion search, which `motion_search_mc` times alone (with --parts: the
partition search, refinement and MC; with --l4 split into
`hier_search`, `subpel_planes`, `subpel_refine` with the luma MC and
`chroma_mc`), `deblock_maps` and `deblock_kernel` time the loop
filter of the frame's reconstruction, and with --cabac on `cabac` the
host CABAC transcode.  With --l4 a last line gives the
kernel launches and device ms of the hierarchical search, the sub-pel
step and the chroma MC of one P frame, each run 10 times under the
profiler alone, per run.
With --batched the line is x264's --preset veryfast --crf 23 on the
batched session (B frames, MB-tree): 27 frames, of which the first 22
are pushed unprofiled (the I frame and the first window's dispatch), then
the last 5 pushes and end() are profiled as one span: the flush's run of
15 frames (P anchors and B frames), the packing and the host CABAC
transcode of both windows; one JSON line as above for that span, with
the types of the AUs it emits (window one's among them, encoded
before the span).
With --medium the line is CompressSession() with no options (x264's
--preset medium: three references, trellis, CABAC, AQ, the 8x8
transform, weighted P, --me hex, quarter pel), its frames encoded one by
one through the session's encoder (TorchEncoder.encode_frame, without
MB-tree's offsets or B frames): an I frame and three P frames fill the
DPB, then one P frame over the DPB of 3 is profiled as above, and the
next one is timed stage by stage, the motion steps once per reference
(`hier_search_ref<r>`, `subpel_planes_ref<r>`, `subpel_refine_ref<r>`,
`chroma_mc_ref<r>`), then `p_core` (the whole multi-reference core with
trellis), `cavlc_slots` (with the ref_idx slots), the loop filter, the
pack, the pull and the host `cabac` transcode; then the I frame's
stages.
--out also writes the lines to a file.
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
L4 = ("--preset ultrafast --tune zerolatency --qp 26 --subme 7 "
      "--deblock 0:0 --keyint 2")
VERYFAST = "--preset veryfast --tune zerolatency --crf 23 --keyint 2"
BATCHED = "--preset veryfast --crf 23"
MEDIUM = ""         # CompressSession() with no options: --preset medium


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


def hier_steps(enc, planes, ref=None):
    """(name, call) of each step of the 16x16 P motion search and MC with
    the hierarchical search against ref (default enc.ref), as
    encode/device._motion_search_and_mc runs them; each call hands its
    result to the next through `r`."""
    from x264vfw_tpu_torch.encode import device as dv
    R, sub_lv = enc.cfg.search_range, enc.cfg.subpel
    ref = enc.ref if ref is None else ref
    r = {"src16": planes[0].to(torch.int16)}

    def search():
        r["v"] = dv._hier_search(r["src16"], ref[0].to(torch.int16), R)

    def subpel_planes():
        r["planes"] = dv._subpel_planes(ref[0], R + 8)

    def refine():
        tx, ty, _ = dv._subpel_refine(r["src16"], r["planes"], R + 8,
                                      *r["v"], sub_lv)
        r["mv"] = torch.stack([r["v"][0] * 4 + tx, r["v"][1] * 4 + ty], -1)

    def chroma():
        dv._chroma_mc(r["mv"], ref[1], ref[2], 8)

    return [("hier_search", search), ("subpel_planes", subpel_planes),
            ("subpel_refine", refine), ("chroma_mc", chroma)]


def hier_profile_line(enc, frame, card, reps: int = 10) -> str:
    """Kernel launches and device ms of each motion step of one P frame:
    each step run reps times under torch.profiler alone, per run."""
    from x264vfw_tpu_torch.encode import device_finalize as df
    from x264vfw_tpu_torch.encode.torch_encoder import _pad
    H, W = enc.mbh * 16, enc.mbw * 16
    src = torch.from_numpy(np.concatenate([
        np.ascontiguousarray(_pad(p, h, w), np.uint8).ravel()
        for p, h, w in zip(frame, (H, H // 2, H // 2),
                           (W, W // 2, W // 2))])).to(enc.device)
    steps = {}
    for name, fn in hier_steps(enc, df._unpack_src(src, H, W)):
        fn()                                        # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        steps[name] = {"launches": len(kern) / reps, "device_ms": sum(
            e.time_range.elapsed_us() for e in kern) / 1e3 / reps}
    line = json.dumps({"motion_steps": steps, "size": [W, H],
                       "search_range": enc.cfg.search_range, "card": card})
    print(line, flush=True)
    return line


def stage_lines(enc, prev, cur, card) -> list[str]:
    """Host-clock ms of each stage of one P frame (cur predicted from the
    reconstruction of prev, and with --ref > 1 from the DPB prev enters)
    and of one I frame, with a device synchronise after each stage: the
    same calls TorchEncoder.encode_frame makes."""
    from x264vfw_tpu_torch.bitstream.mb_syntax import SLICE_I, SLICE_P
    from x264vfw_tpu_torch.bitstream.nal import NAL_SLICE, wrap_nal
    from x264vfw_tpu_torch.encode import device as dv
    from x264vfw_tpu_torch.encode import device_finalize as df
    from x264vfw_tpu_torch.encode import inter_partition as ip
    from x264vfw_tpu_torch.encode.torch_encoder import _pad
    from x264vfw_tpu_torch.ops.kernels.deblock import deblock_apply
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
            nref = enc._cur_nref
            refs = enc.stacked_dpb() if nref > 1 else enc.ref
            if enc.partitions:
                stage("motion_search_mc", lambda: ip.partition_search_and_mc(
                    *planes, *enc.ref, cfg.search_range, enc.qp,
                    cfg.subpel))
            elif cfg.me_backend.endswith(":hier"):
                for r, ref in enumerate(enc.dpb[:nref] if nref > 1
                                        else [enc.ref]):
                    for name, fn in hier_steps(enc, planes, ref):
                        stage(f"{name}_ref{r}" if nref > 1 else name, fn)
            else:
                stage("motion_search_mc", lambda: dv._motion_search_and_mc(
                    *planes, *enc.ref, cfg.search_range))
            o = stage("p_core", lambda: dv.encode_p_frame_core(
                *planes, *refs, enc.qp, enc.qpc, cfg.search_range,
                cfg.subpel, cfg.me_backend, partitions=enc.partitions,
                aq_strength=cfg.aq_strength,
                qpc_offset=enc.pps.chroma_qp_index_offset, wp=enc._wp,
                dct8x8=cfg.dct8x8, trellis=cfg.trellis))
            v, ln = stage("cavlc_slots", lambda: df._finalize_p_core(
                o, hv, hl, enc.mbh, enc.mbw, t8_mode=cfg.dct8x8, nref=nref))
        else:
            o = stage("i_core", lambda: dv.encode_i_frame_core(
                *planes, enc.qp, enc.qpc, cfg.i4x4))
            v, ln = stage("cavlc_slots", lambda: df._finalize_i_core(
                o, hv, hl, enc.mbh, enc.mbw, t8_mode=cfg.dct8x8))
        if cfg.deblock:
            maps = stage("deblock_maps", lambda: dv.loop_filter_maps(
                o, enc.qp, enc.mbh, enc.mbw, ftype == "I",
                2 * cfg.deblock_alpha, 2 * cfg.deblock_beta,
                enc.pps.chroma_qp_index_offset))
            stage("deblock_kernel", lambda: deblock_apply(
                *(o[k].contiguous() for k in ("recon_y", "recon_u",
                                              "recon_v")), *maps))
        data, nbits = stage("pack", lambda: df.pack_slots(v, ln))
        payload = stage("pull", lambda: data[:(nbits + 7) // 8].cpu().numpy())
        if cfg.cabac:
            payload = stage("cabac", lambda: np.frombuffer(
                enc._transcode(payload, hl, ftype), np.uint8))
        stage("nal_wrap", lambda: wrap_nal(3, NAL_SLICE, payload))
        out.append(json.dumps({"stages": ftype, "ms": ms,
                               "parts": bool(enc.partitions),
                               "references": enc._cur_nref
                               if ftype == "P" else 0,
                               "hier": cfg.me_backend.endswith(":hier"),
                               "payload_bytes": int(payload.size),
                               "card": card}))
        print(out[-1], flush=True)
    return out


def device_summary(prof):
    """(summed CUDA kernel ms, kernel launches, the top 8 kernels by
    device ms) of a torch.profiler run."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (sum(by_name.values()) / 1e3, len(kern),
            [[k[:80], v / 1e3] for k, v in top])


def batched_line(w: int, h: int, card: str) -> str:
    """The profiled span of the batched veryfast session (module doc)."""
    from x264vfw_tpu_torch.api import CompressSession
    frames = clip(w, h, 27)
    s = CompressSession(extra_cmdline=BATCHED)
    s.begin(w, h)
    types = []
    emit = s._emit
    s._emit = lambda outs, *a, **k: types.extend(
        it[3] for it in outs) or emit(outs, *a, **k)
    for f in frames[:22]:
        s.compress(f)
    torch.cuda.synchronize()
    before = len(types)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for f in frames[22:]:
            s.compress(f)
        s.end()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev_ms, launches, top = device_summary(prof)
    return json.dumps({
        "span": "pushes 22-26 and end()", "batched": True,
        "emitted_in_span": "".join(types[before:]), "wall_ms": wall_ms,
        "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
        "kernel_launches": launches, "top_device_ms": top,
        "card": card, "size": [w, h]})


def medium_lines(w: int, h: int, card: str) -> list[str]:
    """The --medium lines (module doc)."""
    from x264vfw_tpu_torch.api import CompressSession
    frames = clip(w, h, 7)
    s = CompressSession(extra_cmdline=MEDIUM)
    s.begin(w, h)
    enc = s.encoder
    enc.encode_frame(*frames[0], force_idr=True)
    for f in frames[1:4]:                   # the DPB fills: 1, 2, 3
        enc.encode_frame(*f, force_idr=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        enc.encode_frame(*frames[4], force_idr=False)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev_ms, launches, top = device_summary(prof)
    lines = [json.dumps({
        "frame": 4, "type": "P", "references": enc._cur_nref,
        "wall_ms": wall_ms, "device_ms": dev_ms,
        "busy_share": dev_ms / wall_ms, "kernel_launches": launches,
        "top_device_ms": top, "cabac_ms": enc.transcode_ms, "card": card,
        "size": [w, h], "medium": True})]
    print(lines[0], flush=True)
    lines += stage_lines(enc, frames[5], frames[6], card)
    s.end()
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--parts", action="store_true",
                    help="add --deblock 0:0 --partitions p8x8 --subme 7")
    ap.add_argument("--l4", action="store_true",
                    help="the hierarchical line: --preset ultrafast --tune "
                    "zerolatency --qp 26 --subme 7 --deblock 0:0")
    ap.add_argument("--veryfast", action="store_true",
                    help="x264's live line: --preset veryfast --tune "
                    "zerolatency --crf 23")
    ap.add_argument("--batched", action="store_true",
                    help="x264's VOD line on the batched session: --preset "
                    "veryfast --crf 23 (B frames, MB-tree)")
    ap.add_argument("--medium", action="store_true",
                    help="CompressSession() with no options (x264's --preset "
                    "medium): a P frame over three references")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from x264vfw_tpu_torch.api import CompressSession

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=10).stdout.strip()
    if args.batched or args.medium:
        if args.batched:
            lines = [batched_line(args.width, args.height, card)]
            print(lines[0], flush=True)
        else:
            lines = medium_lines(args.width, args.height, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                fh.write("\n".join(lines) + "\n")
        return 0
    frames = clip(args.width, args.height, 6,
                  shift=(9, -6) if args.l4 else (3, -2))
    s = CompressSession(extra_cmdline=L4 if args.l4 else VERYFAST
                        if args.veryfast else
                        CMDLINE + (PARTS if args.parts else ""))
    s.begin(args.width, args.height)
    for f in frames[:2]:                        # warm-up: I, P
        s.compress(f)
    torch.cuda.synchronize()
    lines = []
    # an I frame of the veryfast line is ~800k launches: profile one I and
    # one P frame of it, two of each of the others
    for i, f in enumerate(frames[2:4 if args.veryfast else 6]):
        ftype = "I" if i % 2 == 0 else "P"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            s.compress(f)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3
        dev_ms, launches, top = device_summary(prof)
        line = {"frame": i + 2, "type": ftype, "wall_ms": wall_ms,
                "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
                "kernel_launches": launches, "top_device_ms": top,
                "card": card, "size": [args.width, args.height],
                "parts": args.parts, "l4": args.l4,
                "veryfast": args.veryfast}
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    lines += stage_lines(s.encoder, frames[3], frames[4], card)
    if args.l4:
        lines.append(hier_profile_line(s.encoder, frames[5], card))
    s.end()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
