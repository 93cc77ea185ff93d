"""Each cell's traffic runs end to end at 64x48 on the CPU, and its
result has the contract's keys, with the numbers compared last."""

import io
import json
import os

import pytest

from portbench import spec
from portbench.run import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(name):
    cell = spec.load(name)
    log = io.StringIO()
    res = run_cell(cell, 2**31 + 11, 6.0, False, device="cpu",
                   size=(64, 48), log=log, workers=0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert list(res["compared"]) == list(cell.limits)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["device"]["platform"] == "cpu"
    assert res["attempted"] >= 1
    json.dumps(res)
    lines = log.getvalue().strip().splitlines()[-len(cell.limits):]
    assert [ln.split(" = ")[0] for ln in lines] == [
        f"compared: {name}" for name in cell.limits]
    assert "I frames in the window: " in log.getvalue()


def _cli(cwd):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_no_result_beside_nothing_but_the_benchmark(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_codes_the_same_frames(name):
    """The texture is the traffic's, not the seed's: runs of two seeds
    code the same frames, in another order, and one seed gives the same
    ring each time."""
    import numpy as np

    from portbench import generate
    frames = spec.load(name).traffic["frames"]
    rings = [generate.make_ring(frames, 64, 48, s)
             for s in (2**31 + 7, 2**31 + 7, 5)]

    def key(fr):
        return b"".join(p.tobytes() for p in fr)

    assert [key(f) for f in rings[0]] == [key(f) for f in rings[1]]
    a, b = [[key(f) for f in r] for r in rings[1:]]
    assert sorted(a) == sorted(b) and a != b
    # the ring wraps: frame i + 1 follows frame i as frame 1 follows 0
    i = b.index(a[0])
    assert b[i:] + b[:i] == a
    assert all(p.dtype == np.uint8 for p in rings[0][0])
