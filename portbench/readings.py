"""The readings a cell's correctness limits are set from.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control]

encodes the cell's traffic for each seed on the card, one seed after
another in one process, with a short window at the cell's own load, and
has each seed's stream judged by check.judge in a worker process of its
own, a few at a time, while the next seed encodes.  With --control the
configuration's "control" options are appended to its command line.  One
line per seed: the numbers compared, beside the cell's current limits.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="",
                    help="WxH in place of the configuration's (CPU tries)")
    args = ap.parse_args(argv)
    import pickle
    from types import SimpleNamespace

    from portbench import check, spec
    from portbench.run import drive

    cell = spec.load(args.workload)
    extra = cell.config["control"]["cmdline"] if args.control else ""
    seeds = [int(s) for s in args.seeds.split(",")]
    running: list = []
    rows = []

    def collect(seed, proc, fps):
        out = proc.stdout.read()
        proc.stdout.close()
        rc = proc.wait()
        status, v = (pickle.loads(out)[0] if rc == 0 and out
                     else ("error", f"worker exit {rc}"))
        row = {"seed": seed, "control": args.control}
        if status == "ok":
            view = SimpleNamespace(traffic=cell.traffic, stream_fps=fps,
                                   verdict=SimpleNamespace(**v))
            row.update(stream_faults=v["stream_faults"],
                       mse_max=v["mse_max"], mse_first=v["mse_first"],
                       mse_chroma_max=v["mse_chroma_max"],
                       plane_mse_max=v["plane_mse_max"],
                       kbps=cell.reader("kbps").read(view),
                       psnr_db=cell.reader("psnr_db").read(view),
                       reasons=v["reasons"][:3],
                       decoded=v["decoded"], sampled=v["sampled"])
        else:
            row["error"] = v
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in seeds:
        size = (tuple(int(x) for x in args.size.split("x"))
                if args.size else None)
        run = drive(cell, seed, args.seconds, device=args.device, size=size,
                    extra_cmdline=extra, log=sys.stderr)
        job = ("judge", run.chunks, run.ring,
               run.traffic, run.config.get("stream", {}), seed,
               run.min_returned, run.size)
        while len(running) >= args.parallel:
            collect(*running.pop(0))
        running.append((seed, check.start_workers([job], 1)[0],
                        run.stream_fps))
        del run
    while running:
        collect(*running.pop(0))
    lim = cell.limits
    print(json.dumps({"workload": cell.name, "limits": lim,
                      "control": args.control, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
