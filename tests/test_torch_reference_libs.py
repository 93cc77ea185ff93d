"""The JAX package's two C libraries are built once and whole before any
test loads them (torch_ref_libs.py, called from tests/jax_refs/conftest.py
and at torch_jax_refs' import).

- Six processes build and load one library at once; each loads a whole
  library.  The build works on a copy of the sources in tmp_path: the
  tree's libraries are in use by other test processes and are never
  touched here.
- The build at collection recorded no error, and both JAX modules load
  their library, so neither falls back without a word.
- pytest enters tests/jax_refs/ before it imports any test module, which
  is what puts that build ahead of every use.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch_jax_refs  # noqa: F401  (its import runs the build)
import torch_ref_libs

TESTS = os.path.dirname(os.path.abspath(__file__))
CABAC_DIR = os.path.join(torch_jax_refs.ROOT, "tools", "cabac")


def test_build_is_whole_under_six_concurrent_processes(tmp_path):
    """Each process builds with the helper, then loads the library through
    cabac_native.available(): ctypes.CDLL, then cabac_encode_p_slice's
    restype, so True means a whole library that exports it."""
    for name in ("cabac_ext.c", "cabac_tables.h"):
        shutil.copy(os.path.join(CABAC_DIR, name), tmp_path / name)
    assert torch_ref_libs.race(str(tmp_path), 6, "helper") == [True] * 6
    lib = ctypes.CDLL(str(tmp_path / "libcabac.so"))
    assert hasattr(lib, "cabac_encode_p_slice")
    # Every build's temporary file was moved into place.
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["cabac_ext.c", "cabac_tables.h", "libcabac.so", "go"]
        + [f"ready{i}" for i in range(6)])


def test_collection_build_left_both_libraries_loadable():
    from x264vfw_tpu.bitstream import cabac_native
    from x264vfw_tpu.decode import native_parse

    assert torch_ref_libs.ERRORS == {}
    for mod in (cabac_native, native_parse):
        assert not torch_ref_libs.stale(mod._SRC, mod._SO), mod.__name__
    assert cabac_native.available()
    assert native_parse.available()


def test_jax_refs_is_entered_before_every_test_module():
    modules = [n for n in os.listdir(TESTS) if n.endswith(".py")
               and (n.startswith("test") or n.endswith("_test.py"))]
    assert modules
    assert all(n > "jax_refs" for n in modules), sorted(modules)[:3]
    with open(os.path.join(TESTS, "jax_refs", "conftest.py")) as f:
        assert "torch_ref_libs.build_reference_libraries()" in f.read()
