"""Committed outputs of the JAX package for the port's session tests
(slice 1, slice 2, the live veryfast/superfast lines with the I4x4 I
frame, the AQ/t8 P cores and the converted-state case, L3, L4, the
cores, finalisation, deblock and packing cases of the older test files,
the B-frame lines with the B cores and MB-tree's P cores, the single
JAX calls of the SAD, search, partition, CAVLC and map tests, and the
--psnr/--ssim sessions, muxer input and CLI files of the session
surface, the decoder's cases, the GOP-parallel, transcode and
host-entropy cases, x264's last four presets and the syntax-tensor
CABAC route).

tools/make_torch_jax_refs.py runs the JAX package on the tests' own inputs
and writes its access units (and, for the converted-state tests, the
reference planes) into tests/jax_refs/<name>.npz, together with the
sha256 of the JAX package's sources (source_hash()).  The tests compare
the port against these arrays exactly instead of compiling the JAX
programs anew in every run; test_torch_session.py::
test_jax_references_are_current fails when the sources have changed
since the files were written.

Importing this module also builds the JAX package's two C libraries where
they are missing or stale, whole and in place (torch_ref_libs.py), before
a test calls the JAX package's C coders.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

import torch_ref_libs

# The port's tests run small tensors, on which PyTorch's intra-op thread
# pool costs more than it saves (most of all beside other test workers
# on the same cores): one thread per test process.
torch.set_num_threads(1)

torch_ref_libs.build_reference_libraries()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "tests", "jax_refs")
NAMES = ("slice1", "slice2", "live", "l3", "l4", "core", "batched",
         "calls", "multiref", "units", "surface", "decode", "parallel",
         "presets", "host_cabac", "ratecontrol", "signalling", "crop",
         "encoder_batch")
SCRIPT = "tools/make_torch_jax_refs.py"


def source_hash() -> str:
    """sha256 over the JAX package's .py files: each relative path, a NUL,
    its bytes, a NUL, in sorted path order."""
    pkg = os.path.join(ROOT, "x264vfw_tpu")
    paths = sorted(os.path.relpath(os.path.join(d, n), ROOT)
                   for d, _, names in os.walk(pkg) for n in names
                   if n.endswith(".py"))
    h = hashlib.sha256()
    for rel in paths:
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(rel.replace(os.sep, "/").encode() + b"\0" + f.read()
                     + b"\0")
    return h.hexdigest()


def digest(a) -> str:
    """sha256 of an integer or boolean array's shape and values (as
    int64): committed in place of a large output and compared exactly."""
    a = np.ascontiguousarray(np.asarray(a), np.int64)
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def path(name: str) -> str:
    return os.path.join(REF_DIR, f"{name}.npz")


def load(name: str) -> dict:
    """{key: array} of tests/jax_refs/<name>.npz."""
    with np.load(path(name)) as z:
        return {k: z[k] for k in z.files}


def aus(refs: dict, prefix: str) -> list:
    """The access units stored as <prefix>_0, <prefix>_1, ... as bytes."""
    out = []
    while f"{prefix}_{len(out)}" in refs:
        out.append(refs[f"{prefix}_{len(out)}"].tobytes())
    return out
