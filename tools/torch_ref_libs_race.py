"""Count how often a process fails to load the JAX package's CABAC library
when several processes build it at once, with the JAX module's own build
and with tests/torch_ref_libs.py's.

    python tools/torch_ref_libs_race.py [--procs 6] [--rounds 10]

Each round copies tools/cabac/cabac_ext.c and cabac_tables.h into a new
temporary directory, with no library built, and starts --procs processes
(tests/torch_ref_libs.race) that wait for one signal and then call
x264vfw_tpu.bitstream.cabac_native.available() with the module's
_SRC/_SO pointed at that copy:
- "jax": as the module stands: a missing library is built in place
  (`gcc ... -o <final path>`), then loaded;
- "helper": torch_ref_libs.build() first (a temporary file moved into
  place), which is what the tier-1 run's collection now does, then the
  same call.
A process whose load fails prints False (cabac_native takes the library
as unavailable for the rest of its life).  The script prints one JSON
object: per mode, the failed loads out of procs x rounds.  The tree's
own libraries are not touched.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_ref_libs  # noqa: E402


def one_round(mode: str, procs: int) -> int:
    """Failed loads of `procs` processes racing on a fresh copy."""
    d = tempfile.mkdtemp(prefix="ref_libs_race_")
    try:
        for name in ("cabac_ext.c", "cabac_tables.h"):
            shutil.copy(os.path.join(ROOT, "tools", "cabac", name), d)
        return torch_ref_libs.race(d, procs, mode).count(False)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=10)
    a = ap.parse_args()
    out = {"procs": a.procs, "rounds": a.rounds}
    for mode in ("jax", "helper"):
        failed = sum(one_round(mode, a.procs) for _ in range(a.rounds))
        out[mode] = {"failed_loads": failed, "loads": a.procs * a.rounds}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
