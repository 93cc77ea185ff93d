"""The JAX package's two C libraries, tools/cabac/libcabac.so and
tools/decparse/libcavlcparse.so, built once and whole before any test
loads them.

x264vfw_tpu/bitstream/cabac_native.py and x264vfw_tpu/decode/native_parse.py
build their library at first use with `gcc ... -o <final path>`.  Under
pytest-xdist every worker that finds the library missing (as in a fresh
checkout: `*.so` is git-ignored) or older than its source runs that build
at once, and a worker that loads a file another one is still writing
takes the library as unavailable for the rest of its run: its CABAC falls
back to the pure-Python writer, or its parser to None.  The first such
use comes at collection: tests/test_cabac_transcode.py's module-level
skipif calls cabac_transcode.available().

build_reference_libraries() runs the same gcc command into a temporary
file in the library's directory and moves it into place with os.replace,
so every load finds a whole file.  tests/jax_refs/conftest.py calls it
when pytest enters tests/jax_refs/, before it imports any test module of
tests/ (it visits a directory's entries in name order), and
torch_jax_refs calls it at import for runs that name test files; where
both libraries are fresh it does nothing.  A failed build does not stop
collection: its error stays in ERRORS, which
test_torch_reference_libs.py reports.

race() starts processes that load one library from a copy of its
sources at once, with either build: test_torch_reference_libs.py and
tools/torch_ref_libs_race.py count its failed loads.  Only the standard
library is imported here, so the early call costs no PyTorch import.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time

# The JAX modules whose _SRC/_SO name the libraries, and their gcc flags.
MODULES = ("x264vfw_tpu.bitstream.cabac_native",
           "x264vfw_tpu.decode.native_parse")
GCC_FLAGS = ("-O3", "-shared", "-fPIC")

# {module: error} of the last build_reference_libraries() call.
ERRORS: dict[str, str] = {}


def stale(src: str, so: str) -> bool:
    """True where the JAX module's _get_lib would build: `so` is missing
    or older than `src`."""
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def build(src: str, so: str) -> None:
    """Compile `src` into the shared library `so` with GCC_FLAGS, through
    a temporary file beside `so` and os.replace: a concurrent reader
    opens the old file or the new one, each whole."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        r = subprocess.run(["gcc", *GCC_FLAGS, src, "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"gcc failed on {src}:\n{r.stderr}")
        os.chmod(tmp, 0o755)  # mkstemp's 0600, where gcc -o gives 0755
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_reference_libraries() -> None:
    """Build each library of MODULES that is stale; errors go to ERRORS."""
    for name in MODULES:
        try:
            mod = importlib.import_module(name)
            if stale(mod._SRC, mod._SO):
                build(mod._SRC, mod._SO)
            ERRORS.pop(name, None)
        except Exception as e:  # reported by a test, not at collection
            ERRORS[name] = f"{type(e).__name__}: {e}"


_RACER = """
import os, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from x264vfw_tpu.bitstream import cabac_native as cn
import torch_ref_libs
d, mode, i = sys.argv[3], sys.argv[4], sys.argv[5]
cn._SRC = os.path.join(d, "cabac_ext.c")
cn._SO = os.path.join(d, "libcabac.so")
open(os.path.join(d, "ready" + i), "w").close()
while not os.path.exists(os.path.join(d, "go")):
    time.sleep(0.0005)
if mode == "helper" and torch_ref_libs.stale(cn._SRC, cn._SO):
    torch_ref_libs.build(cn._SRC, cn._SO)
print(cn.available())
"""


def race(d: str, procs: int, mode: str) -> list[bool]:
    """Start `procs` processes that wait for one signal, then each load
    the CABAC library from the sources in `d` (cabac_ext.c and
    cabac_tables.h, with no library built) through
    x264vfw_tpu.bitstream.cabac_native.available(), its _SRC/_SO pointed
    at `d`.  mode "jax": the module builds a missing library in place, as
    it stands; "helper": build() first.  Returns each process's
    available(): False where its load failed."""
    tests = os.path.dirname(os.path.abspath(__file__))
    ps = [subprocess.Popen([sys.executable, "-c", _RACER,
                            os.path.dirname(tests), tests, d, mode, str(i)],
                           stdout=subprocess.PIPE, text=True)
          for i in range(procs)]
    try:
        deadline = time.monotonic() + 60
        while (sum(os.path.exists(os.path.join(d, f"ready{i}"))
                   for i in range(procs)) < procs
               and time.monotonic() < deadline):
            time.sleep(0.01)
        open(os.path.join(d, "go"), "w").close()
        return [p.communicate(timeout=120)[0].strip() == "True" for p in ps]
    finally:
        for p in ps:
            p.kill()
            p.wait()
