"""Command-line front end of the port: an x264-style encoder CLI.

    python -m x264vfw_tpu_torch.cli --preset ultrafast --crf 23 \
        -o out.mkv input.y4m
    python -m x264vfw_tpu_torch.cli --qp 26 --input-res 1280x720 \
        -o out.mp4 input.yuv

Reads raw I420 (.yuv, with --input-res WxH) or Y4M (.y4m, 4:2:0) input,
--frames N of it at most; the output container follows the extension
(raw .264 / .mkv / .flv / .mp4 / .avi) like the reference's select_output
(codec.c:1111-1164).  Every x264-compatible flag of config/options.py is
accepted; --fullhelp lists them.  Encodes on the CUDA card.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .api import CompressSession
from .config.options import parse_cmdline


def _parse_y4m_header(f) -> tuple[int, int, int, int]:
    line = b""
    while not line.endswith(b"\n"):
        line += f.read(1)
    parts = line.decode().strip().split(" ")
    if parts[0] != "YUV4MPEG2":
        raise ValueError("not a y4m file")
    w = h = 0
    fn, fd = 25, 1
    for p in parts[1:]:
        if p.startswith("W"):
            w = int(p[1:])
        elif p.startswith("H"):
            h = int(p[1:])
        elif p.startswith("F"):
            fn, fd = (int(x) for x in p[1:].split(":"))
        elif p.startswith("C") and not p[1:].startswith("420"):
            raise ValueError("only 4:2:0 y4m supported")
    return w, h, fn, fd


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the CLI on argv (default: sys.argv[1:]).  device: where the
    session encodes (default: the CUDA card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    in_path = None
    in_res = None
    frames_limit = None
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-o", "--output"):
            out_path = argv[i + 1]
            i += 2
        elif a == "--input-res":
            in_res = argv[i + 1]
            i += 2
        elif a == "--frames":
            frames_limit = int(argv[i + 1])
            i += 2
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        elif a == "--fullhelp":
            from .config.options import fullhelp
            print(fullhelp())
            return 0
        elif not a.startswith("-") and in_path is None and (
                a.endswith(".yuv") or a.endswith(".y4m") or i == len(argv) - 1):
            in_path = a
            i += 1
        else:
            rest.append(a)
            i += 1
    if not in_path or not out_path:
        print("usage: cli [options] --input-res WxH -o out.{264,mkv,flv,mp4,avi} in.yuv",
              file=sys.stderr)
        return 2

    params, warns = parse_cmdline(rest)
    for w in warns:
        print(f"warning: {w}", file=sys.stderr)

    with open(in_path, "rb") as f:
        y4m = in_path.endswith(".y4m")
        if y4m:
            w, h, fn, fd = _parse_y4m_header(f)
            params.fps_num, params.fps_den = fn, fd
        else:
            if not in_res:
                print("--input-res WxH required for raw yuv", file=sys.stderr)
                return 2
            w, h = (int(x) for x in in_res.lower().split("x"))

        sess = CompressSession(params, device=device)
        sess.begin(w, h, output=out_path)
        fsz = w * h * 3 // 2
        n = 0
        t0 = time.perf_counter()
        while frames_limit is None or n < frames_limit:
            if y4m:
                hdr = f.readline()
                if not hdr.startswith(b"FRAME"):
                    break
            data = f.read(fsz)
            if len(data) < fsz:
                break
            buf = np.frombuffer(data, np.uint8)
            y = buf[:w * h].reshape(h, w)
            u = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
            v = buf[w * h + w * h // 4:].reshape(h // 2, w // 2)
            sess.compress((y, u, v))
            n += 1
        stats = sess.end()
    dt = time.perf_counter() - t0
    print(f"encoded {n} frames in {dt:.2f}s ({n / dt:.2f} fps), "
          f"{stats['kbps']:.1f} kb/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
