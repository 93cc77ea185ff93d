"""A configuration, a traffic mix, a cell's limits, a metric and a
kernel's counts dropped into a copy of portbench/ are found by name, with
no edit to any file that is there."""

import json
import os
import shutil

from portbench import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("spec.py", "run.py", "check.py", "trace.py")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    (bench / "configs" / "ultrafast_720p.json").write_text(json.dumps(
        {"name": "ultrafast_720p", "width": 1280, "height": 720,
         "cmdline": "--preset ultrafast --crf 23", "stream": {}}))
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"keyint": 250, "warmup_frames": 2, "decode": {"frames": 2},
         "sample": 1, "kbps_frames": [2, 4], "psnr_frames": [0, 2],
         "frames": {"ring": 8, "dx": 2, "dy": 2, "amplitude": 10,
                    "base": {"mean": 64, "ax": 64, "wx": 31.0, "ay": 48,
                             "wy": 23.0}, "chroma_amplitude": 24}}))
    (bench / "limits" / "hd.ultrafast.burst.json").write_text(
        json.dumps({"stream_faults": 0, "mse_max": 40.0}))
    (bench / "metrics" / "bytes_per_frame.py").write_text(
        "def read(run):\n    return 1234.0\n")
    (bench / "rooflines" / "scale.py").write_text(
        "KERNEL = 'scale_kernel'\nPATCH = ()\n"
        "def args(*a, **k):\n    return ()\n"
        "def counts():\n    return 1.0, 1.0\n")
    doc["configs"].append({"name": "ultrafast_720p", "source": "x",
                           "file": "portbench/configs/ultrafast_720p.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "hd.ultrafast.burst",
                             "config": "ultrafast_720p",
                             "traffic": "burst", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "bytes_per_frame", "unit": "B",
                             "better": "lower", "source": "program_counter",
                             "layer": "host entropy", "moves": "fps",
                             "workloads": ["hd.ultrafast.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load("hd.ultrafast.burst", root=str(tmp_path),
                     bench_dir=str(bench))
    assert cell.config["cmdline"] == "--preset ultrafast --crf 23"
    assert cell.traffic["keyint"] == 250
    assert cell.limits["mse_max"] == 40.0
    assert [m["name"] for m in cell.per_layer][-1] == "bytes_per_frame"
    assert cell.reader("bytes_per_frame").read(None) == 1234.0
    assert "fps" in [m["name"] for m in cell.end_to_end]
    assert "frame_ms_p95" not in [m["name"] for m in cell.end_to_end]
    assert "scale" in spec.rooflines(str(bench))
    for p, data in before.items():
        assert open(bench / p, "rb").read() == data
