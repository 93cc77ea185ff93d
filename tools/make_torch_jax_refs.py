"""Write the JAX package's outputs that the port's slice-1 and slice-2
session tests compare against (tests/jax_refs/slice1.npz, slice2.npz).

    JAX_PLATFORMS=cpu python tools/make_torch_jax_refs.py

Run it from the repository root after any change to x264vfw_tpu/ or to
those tests' inputs; test_torch_session.py::
test_jax_references_are_current names this script when the recorded
source hash no longer matches.  Each file holds:

  * source_sha256: tests/torch_jax_refs.source_hash() of x264vfw_tpu/;
  * the access units of the JAX CompressSession on the tests' clips, as
    uint8 arrays <geometry or "session">_<index> (slice 2 also under
    "session_hier": its line without --me esa, which selects the
    hierarchical search for P16x16 and which the partition search
    ignores);
  * for the test that loads a reference picture into both encoders
    (convert.state_from_numpy), the JAX P frame's access unit (p_au) and
    its reconstruction (p_ref_y, p_ref_u, p_ref_v).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_partitions as tp  # noqa: E402
import test_torch_session as ts  # noqa: E402
import torch_jax_refs as refs  # noqa: E402
from x264vfw_tpu.api import CompressSession  # noqa: E402
from x264vfw_tpu.encode.tpu_encoder import TpuEncoder  # noqa: E402


def session_aus(cmdline: str, w: int, h: int, clip) -> list:
    s = CompressSession(extra_cmdline=cmdline)
    s.begin(w, h)
    out = [s.compress(f) for f in clip]
    s.end()
    return out


def p_frame(cfg, ref_planes, cur) -> dict:
    """One P frame from a loaded reference picture, as the converted-state
    tests set the JAX encoder up."""
    enc = TpuEncoder(cfg)
    enc.ref = tuple(jnp.asarray(p) for p in ref_planes)
    enc.frame_idx = enc.frame_num = enc.display_idx = 1
    enc.idr_id = 1
    au = enc.encode_frame(*cur, qp=26, force_idr=False)
    return {"p_au": np.frombuffer(au, np.uint8),
            **{f"p_ref_{k}": np.asarray(p).astype(np.uint8)
               for k, p in zip("yuv", enc.ref)}}


def put_aus(out: dict, prefix: str, aus: list) -> None:
    for i, au in enumerate(aus):
        out[f"{prefix}_{i}"] = np.frombuffer(au, np.uint8)


def main() -> int:
    digest = np.asarray(refs.source_hash())
    os.makedirs(refs.REF_DIR, exist_ok=True)

    s1 = {"source_sha256": digest}
    for w, h in ts.GEOMS:
        put_aus(s1, f"{w}x{h}", session_aus(
            ts.CMDLINE, w, h, ts.moving_clip(w, h, 3, seed=w)))
    s1.update(p_frame(*ts.converted_state_case()))
    np.savez_compressed(refs.path("slice1"), **s1)

    s2 = {"source_sha256": digest}
    for key, cmd in (("session", tp.CMDLINE),
                     ("session_hier", tp.CMDLINE_HIER)):
        put_aus(s2, key, session_aus(cmd, 64, 48,
                                     ts.moving_clip(64, 48, 3, seed=64)))
    s2.update(p_frame(*tp.converted_state_case()))
    np.savez_compressed(refs.path("slice2"), **s2)
    for name in refs.NAMES:
        print(refs.path(name), os.path.getsize(refs.path(name)), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
