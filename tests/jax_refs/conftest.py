"""Builds the JAX package's C libraries before any test module is imported.

pytest loads this file when it enters tests/jax_refs/, which it does
before it imports any test module of tests/: it visits a directory's
entries in name order, and every test module's name sorts after
"jax_refs" (test_torch_reference_libs.py checks that).  Under
pytest-xdist each worker does so during its own collection, so the
libraries are whole on disk before tests/test_cabac_transcode.py's
collection-time skipif, or any test, loads them (torch_ref_libs.py says
why that matters).
"""

import torch_ref_libs

torch_ref_libs.build_reference_libraries()
