"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface, at first use, into x264vfw_tpu_torch/_build/.  The library's
file name carries a hash of the source, so an edited source is rebuilt
and an unchanged one is loaded as it is.  What nvcc printed (with
-Xptxas -v: registers, shared memory and spills per kernel) is kept beside
the library (report_path).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Path of the library built from csrc/<name>.cu at its current hash."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def report_path(name: str) -> str:
    """Path of what nvcc printed when it built library_path(name)."""
    return library_path(name)[:-3] + ".log"


def _start(name: str):
    """Start nvcc for one source; None when the library is already there."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    # the compiler's messages go to a file: a full pipe would stall nvcc
    log = open(tmp + ".log", "w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, log = started
    proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    if proc.returncode != 0:
        os.unlink(log.name)
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{text}")
    os.replace(log.name, report_path(name))
    os.replace(tmp, out)


def build(names) -> dict:
    """Compile every named source at once (one nvcc each, in parallel).
    Returns the seconds from the start until each nvcc ended (0.0 for a
    library that was already built)."""
    t0 = time.time()
    started = {n: _start(n) for n in names}
    seconds = {n: 0.0 for n in names}
    pending = {n for n, s in started.items() if s is not None}
    while pending:                    # note when each nvcc ends
        for n in [n for n in pending if started[n][0].poll() is not None]:
            seconds[n] = time.time() - t0
            pending.discard(n)
        time.sleep(0.02)
    errors = []
    for n, s in started.items():      # every nvcc has ended; then raise
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
