"""The slice as a whole: the port's CompressSession (device="cpu") writes
the same Annex-B bytes as the JAX package's for
--preset ultrafast --tune zerolatency --me esa, and one P frame encoded
from the same reference picture through convert.state_from_numpy is the
same in both packages.  On the CPU the JAX session resolves its search to
the XLA branch, which tests/test_pallas_sad.py holds bit-equal to the
Pallas kernel.  The JAX package's outputs for these inputs are committed
in tests/jax_refs/slice1.npz (tools/make_torch_jax_refs.py), guarded by a
hash of its sources.  Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest

import torch_jax_refs
from x264vfw_tpu.encode.ref_encoder import EncoderConfig as JaxConfig
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream.nal import split_annexb
from x264vfw_tpu_torch.convert import config_from_jax_fields, state_from_numpy
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder

CMDLINE = "--preset ultrafast --tune zerolatency --me esa --qp 26"
GEOMS = [(64, 48), (128, 96), (80, 40)]     # 40 rows: a partial MB row


def moving_clip(w, h, frames, seed, shift=(2, -1)):
    """Textured I420 frames moving by `shift` (dx, dy) pixels per frame."""
    rng = np.random.default_rng(seed)
    m = 24
    n = rng.integers(0, 256, (h + 2 * m + 1, w + 2 * m + 1)).astype(np.int32)
    base = ((n[:-1, :-1] + n[1:, :-1] + n[:-1, 1:] + n[1:, 1:]) // 4) \
        .astype(np.uint8)
    out = []
    for f in range(frames):
        y = np.ascontiguousarray(np.roll(base, (f * shift[1], f * shift[0]),
                                         (0, 1))[m:m + h, m:m + w])
        u = np.ascontiguousarray(y[::2, ::2])
        out.append((y, u, np.ascontiguousarray(255 - u)))
    return out


def converted_state_case():
    """(JAX EncoderConfig, reference planes, current frame) of the P frame
    encoded from a loaded reference picture."""
    w, h = 64, 48
    jcfg = JaxConfig(width=w, height=h, qp=26, keyint=250, search_range=16,
                     subpel=0)
    rng = np.random.default_rng(11)
    ref = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    return jcfg, ref, moving_clip(w, h, 2, seed=3)[1]


@pytest.fixture(scope="module")
def jax_refs():
    return torch_jax_refs.load("slice1")


@pytest.mark.parametrize("name", torch_jax_refs.NAMES)
def test_jax_references_are_current(name):
    """The committed JAX outputs were written from the JAX package's
    current sources."""
    got = str(torch_jax_refs.load(name)["source_sha256"])
    assert got == torch_jax_refs.source_hash(), (
        f"x264vfw_tpu/ changed since tests/jax_refs/{name}.npz was "
        f"written: rerun {torch_jax_refs.SCRIPT}")


@pytest.mark.parametrize("w,h", GEOMS)
def test_session_bytes_equal_jax(jax_refs, w, h):
    s = CompressSession(extra_cmdline=CMDLINE, device="cpu")
    s.begin(w, h)
    aus = [s.compress(f) for f in moving_clip(w, h, 3, seed=w)]
    stats = s.end()
    assert stats["frames"] == 3
    types = [u.nal_unit_type for u in split_annexb(b"".join(aus))]
    assert types.count(5) == 1 and types.count(1) == 2, types
    want = torch_jax_refs.aus(jax_refs, f"{w}x{h}")
    assert len(want) == 3
    for i, (got, w_) in enumerate(zip(aus, want)):
        assert got == w_, f"AU {i} differs"


def test_p_frame_from_converted_state(jax_refs):
    """Same reference picture -> same P-frame bytes and reconstruction."""
    jcfg, ref, cur = converted_state_case()
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    enc = TorchEncoder(cfg, device="cpu")
    enc.load_state(state_from_numpy(*ref, frame_idx=1, idr_id=1,
                                    device="cpu"))
    got = enc.encode_frame(*cur, qp=26, force_idr=False)
    assert got == jax_refs["p_au"].tobytes()
    for a, k in zip(enc.ref, "yuv"):
        np.testing.assert_array_equal(a.numpy(), jax_refs[f"p_ref_{k}"])


def test_config_from_jax_fields_round_trip():
    jcfg = JaxConfig(width=320, height=240, qp=30, search_range=12,
                     subpel=0, colorprim=1)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError):
        config_from_jax_fields({**dataclasses.asdict(jcfg), "bogus": 1})
