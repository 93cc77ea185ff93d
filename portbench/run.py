"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds x264vfw_tpu_torch.  The run makes
the cell's frames from --seed, opens x264vfw_tpu_torch.api.CompressSession
with the configuration's command line and the traffic's keyint, warms it
up (the first run in a checkout builds the port's kernels into
x264vfw_tpu_torch/_build/), then drives compress() in a closed loop with
one client for --seconds: the next frame goes in when the call returns.
Once the window has closed and the session is freed, the reference judges
the stream (check.py).  With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read under the
profiler.  The last line of standard output is the result as one JSON
object; the numbers compared for `correct` are the last lines of standard
error.  Without a CUDA card, or with fewer than the cell asks for, the run
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "x264vfw_tpu")


class Run:
    """What the readers of metrics/ see of one run."""

    def __init__(self, cell, traffic, config):
        self.cell = cell
        self.traffic = traffic
        self.config = config
        self.calls: list = []        # (start, end, frames, counted)
        self.t0 = 0.0
        self.setup_s = 0.0
        self.frames = 0
        self.verdict = None
        self.readings = None
        self.rooflines: dict = {}
        self.props: dict = {}
        self.stream_fps = 25.0
        self.chunks: list = []       # (bytes, call, counted) per call
        self.ring: list = []
        self.size = (0, 0)
        self.cuda = False
        self.peak = 0
        self.min_returned = 0
        self.host: dict = {}         # host_state() over the window


def host_state() -> dict:
    """The process's CPU seconds and context switches, the host's load
    and, where the kernel reports it, its CPU pressure: read around the
    window to tell a slow run's cause on the host."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    state = {"cpu_s": ru.ru_utime + ru.ru_stime, "wall_s": time.perf_counter(),
             "voluntary": ru.ru_nvcsw, "involuntary": ru.ru_nivcsw,
             "load1": os.getloadavg()[0]}
    try:
        with open("/proc/pressure/cpu") as f:
            some = f.readline().split()
        state["cpu_pressure_us"] = int(some[-1].split("=")[1])
    except (OSError, IndexError, ValueError):
        pass
    return state


def host_delta(a: dict, b: dict) -> dict:
    """host_state() b less a; the load is b's."""
    out = {k: b[k] - a[k] for k in a if k != "load1" and k in b}
    out["load1"] = b["load1"]
    return out


def count_pictures(data: bytes) -> int:
    """Coded pictures in returned bytes: slices whose first_mb_in_slice
    is 0."""
    from portbench.reference.h264.nal import iter_annexb_raw
    return sum(1 for raw in iter_annexb_raw(data)
               if raw[0] & 0x1F in (1, 5) and raw[1] & 0x80)


def card_props(device) -> dict:
    """The card's name, SM count, highest SM clock and power limit."""
    import subprocess

    import torch
    props = torch.cuda.get_device_properties(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits", "-i",
         str(torch.device(device).index or 0)],
        capture_output=True, text=True, timeout=30, check=True)
    clock, power = (x.strip() for x in out.stdout.strip().split(","))
    return {"name": torch.cuda.get_device_name(device),
            "sms": props.multi_processor_count,
            "clock_hz": float(clock) * 1e6, "power_limit_w": power}


def drive(cell, seed: int, seconds: float, trace: bool = False,
          device: str = "cuda", size=None, extra_cmdline: str = "",
          wrap=None, log=sys.stderr) -> Run:
    """Set up, warm up and run the window; the session is freed before
    this returns.  size: (width, height) in place of the configuration's
    (CPU tests); extra_cmdline: options appended to the configuration's
    (the control); wrap: a function over the session (the fault tests)."""
    import gc

    import torch

    from portbench import generate, spec
    from portbench.trace import Tracer
    from x264vfw_tpu_torch.api import CompressSession

    cfg, tr = cell.config, cell.traffic
    run = Run(cell, tr, cfg)
    run.size = size or (cfg["width"], cfg["height"])
    run.cuda = torch.device(device).type == "cuda"
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(device)
        run.props = card_props(device)
        print(f"card: {run.props['name']}, {run.props['sms']} SMs, highest "
              f"SM clock {run.props['clock_hz'] / 1e6:.0f} MHz, power "
              f"limit {run.props['power_limit_w']} W", file=log)
    ring = generate.make_ring(tr["frames"], *run.size, seed, device)
    run.ring = ring
    cmdline = f"{cfg['cmdline']} --keyint {tr['keyint']} {extra_cmdline}"
    sess = CompressSession(extra_cmdline=cmdline.strip(), device=device)
    sess.begin(*run.size)
    run.stream_fps = sess.params.fps_num / sess.params.fps_den
    if wrap is not None:
        sess = wrap(sess)
    chunks = run.chunks
    pushed = 0
    for _ in range(int(tr["warmup_frames"])):
        chunks.append((sess.compress(ring[pushed % len(ring)], "i420"),
                       len(chunks), False))
        pushed += 1
    if run.cuda:
        torch.cuda.synchronize(device)
    tracer = None
    if trace:
        run.rooflines = spec.rooflines(cell.bench_dir)
        tracer = Tracer(run.rooflines)
        tracer.install()
        tracer.start()
    run.setup_s = time.perf_counter() - T_START
    host0 = host_state()
    # the window: a closed loop with one client
    clock = time.perf_counter
    run.t0 = clock()
    deadline = run.t0 + seconds
    w0 = time.time_ns()
    while True:
        ts = clock()
        if ts >= deadline:
            break
        out = sess.compress(ring[pushed % len(ring)], "i420")
        te = clock()
        pushed += 1
        counted = te <= deadline
        run.calls.append((ts, te, count_pictures(out), counted))
        chunks.append((out, len(chunks), counted))
        if tracer is not None:
            tracer.readings.spans.append(
                ("compress", w0 + int((ts - run.t0) * 1e9),
                 w0 + int((te - run.t0) * 1e9)))
        if not counted:
            break
    run.host = host_delta(host0, host_state())
    run.frames = sum(c[2] for c in run.calls if c[3])
    # the traced window ends with the last counted return: the work of a
    # call still in flight at the close is not the counted frames'
    last = max((c[1] for c in run.calls if c[3]), default=run.t0)
    w1 = w0 + int((last - run.t0) * 1e9)
    if tracer is not None:
        tracer.stop((w0, w1))
        tracer.uninstall()
        run.readings = tracer.readings
        print(f"trace: {tracer.readings.events} profiler events, "
              f"{len(tracer.readings.device)} on the device, read in "
              f"{tracer.readings.process_s:.1f} s", file=log)
    run.peak = torch.cuda.max_memory_allocated(device) if run.cuda else 0
    run.min_returned = pushed - sess.frames_info().delay
    del sess
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    return run


def judge(run: Run, seed: int, workers=None, log=sys.stderr) -> None:
    """The reference's judgement of the run's stream, after the window and
    the session."""
    from portbench import check

    t = time.perf_counter()
    v = check.judge(run.chunks, run.ring, run.traffic,
                    run.config.get("stream", {}), seed,
                    min_returned=run.min_returned, size=run.size,
                    workers=(check.default_workers() if workers is None
                             else workers))
    run.verdict = v
    print(f"check: {v.pictures} pictures, {v.decoded} decoded from the "
          f"IDR in {v.chain_s:.1f} s, {v.sampled} sampled from the window; "
          f"{time.perf_counter() - t:.1f} s in all; worst MSE of Y, U, V "
          f"{v.plane_mse_max}", file=log)


def compared(run: Run) -> tuple:
    """(correct, {name: {value, limit}}): the numbers that the cell's
    limits file names, each held to its limit."""
    numbers = {}
    correct = True
    for name, limit in run.cell.limits.items():
        value = getattr(run.verdict, name)
        numbers[name] = {"value": value, "limit": limit}
        correct = correct and value is not None and value <= limit
    return bool(correct), numbers


def result(run: Run, trace: bool, log=sys.stderr) -> dict:
    """The run's result object, its compared numbers last."""
    from portbench.trace import breakdown

    cell, v = run.cell, run.verdict
    print(f"I frames in the window: {v.window_i_frames}", file=log)
    print("host over the window: " + ", ".join(
        f"{k} {val}" for k, val in run.host.items()), file=log)
    for why in v.reasons:
        print(f"fault: {why}", file=log)
    correct, numbers = compared(run)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        val = cell.reader(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    attempted = len(run.calls)
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": run.props["name"] if run.cuda else "cpu",
           "count": cell.chips if run.cuda else 1,
           "memory_peak_bytes": run.peak}
    out = {"correct": correct, "attempted": attempted,
           "failed": min(attempted, v.stream_faults),
           "metrics": metrics, "device": dev}
    if trace and run.readings is not None:
        dev["busy_s"] = run.readings.busy_s()
        dev["window_s"] = run.readings.window_s
        out["breakdown"] = breakdown(run.readings)
    for name, c in numbers.items():
        print(f"compared: {name} = {c['value']} (limit {c['limit']})",
              file=log)
    out["compared"] = numbers
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", size=None, extra_cmdline: str = "",
             wrap=None, log=sys.stderr, workers=None) -> dict:
    """One run of a cell, as the command line makes it; returns the result
    object."""
    run = drive(cell, seed, seconds, trace, device, size, extra_cmdline,
                wrap, log)
    judge(run, seed, workers, log)
    return result(run, trace, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        from portbench import spec
        import x264vfw_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"cannot run: {exc}", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
