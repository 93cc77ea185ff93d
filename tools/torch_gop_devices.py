"""GOP-parallel encoding over every visible CUDA card, against one card.

    python3 tools/torch_gop_devices.py [--gops 8] [--gop-len 3]
                                       [--width 1920 --height 1080]

Builds the kernels, then encodes the same seeded clip (a texture moving
by chip_smoke.SHIFT, --gops closed GOPs of --gop-len frames) three
ways with the port's slice-2 GOP configuration (QP 26, the exhaustive
search over R = 16, partitions, quarter pel, the loop filter):

  * encode_clip_gop_parallel over every visible card, GOP g on card
    g % n;
  * encode_clip_gop_parallel over cuda:0 named n times, the GOPs one
    after another;
  * the per-frame TorchEncoder on cuda:0 at keyint = --gop-len;

each after one warm-up run on every card.  Fails unless the three
streams are equal and each GOP ran on the card the round robin names.
Prints one JSON line: the card count, the wall seconds and fps of each
way, the speed-up of the first over the second, the device each GOP ran
on, and the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gops", type=int, default=8)
    ap.add_argument("--gop-len", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
    from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
    from x264vfw_tpu_torch.ops.kernels import build
    from x264vfw_tpu_torch.parallel import gop

    build.build(chip_smoke.KERNELS)
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    frames = chip_smoke.moving_clip(args.width, args.height,
                                    args.gops * args.gop_len, seed=21)
    cfg = EncoderConfig(width=args.width, height=args.height, qp=26,
                        keyint=args.gop_len, search_range=16, deblock=True,
                        partitions=True, me_backend="pallas")
    placed = []
    plain = gop.encode_gop_packed_device

    def record(frames_yuv, *a, **k):
        placed.append(str(frames_yuv.device))
        return plain(frames_yuv, *a, **k)

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    # warm-up: one GOP per card
    gop.encode_clip_gop_parallel(frames[:n * args.gop_len], cfg,
                                 devices=cards)
    sync_all()
    walls, streams = {}, {}
    for name, devs in (("cards", cards), ("one_card", [cards[0]] * n)):
        gop.encode_gop_packed_device = record
        placed.clear()
        try:
            t0 = time.time()
            streams[name] = gop.encode_clip_gop_parallel(frames, cfg,
                                                         devices=devs)
            sync_all()
            walls[name] = time.time() - t0
        finally:
            gop.encode_gop_packed_device = plain
        want = [str(devs[g % len(devs)]) for g in range(args.gops)]
        if placed != want:
            raise SystemExit(f"FAILED: GOPs ran on {placed}, want {want}")
        if name == "cards":
            placed_cards = list(placed)
    enc = TorchEncoder(cfg, device=cards[0])
    t0 = time.time()
    streams["per_frame"] = b"".join(enc.encode_frame(*f) for f in frames)
    torch.cuda.synchronize(cards[0])
    walls["per_frame"] = time.time() - t0
    if not (streams["cards"] == streams["one_card"] == streams["per_frame"]):
        raise SystemExit("FAILED: the streams differ")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=10, check=True).stdout
    nf = len(frames)
    print(json.dumps({
        "cards": n, "frames": nf, "gops": args.gops,
        "size": [args.width, args.height], "bytes": len(streams["cards"]),
        "wall_s": {k: round(v, 3) for k, v in walls.items()},
        "fps": {k: round(nf / v, 3) for k, v in walls.items()},
        "speedup_vs_one_card": round(walls["one_card"] / walls["cards"], 3),
        "gop_devices": placed_cards, "identical": True,
        "smi": smi.strip().splitlines()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
