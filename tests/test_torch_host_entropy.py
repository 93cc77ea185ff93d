"""The encoder's host-entropy path with CAVLC (TorchEncoder.host_entropy:
the I or P core, then the numpy CAVLC coder bitstream/cavlc_vec.py on
the host; with --cabac, test_torch_host_cabac.py), held to the JAX
package: cavlc_vec against the JAX package's numpy
module and the port's device coder cavlc_dev on seeded blocks, and the
host-entropy stream against JAX's committed bytes
(tests/jax_refs/parallel.npz) and the device-entropy stream, on
tests/test_tpu_encoder.py::test_device_entropy_matches_host_entropy's
clip.
"""

import numpy as np
import pytest
import torch

import oracle
import torch_jax_refs
from x264vfw_tpu.bitstream import cavlc_vec as jax_vec
from x264vfw_tpu_torch.bitstream import cavlc_dev, cavlc_vec
from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder

HE_SIZE, HE_FRAMES, HE_SEED = 64, 3, 42
HE_CFG = dict(width=HE_SIZE, height=HE_SIZE, qp=26, search_range=4)


def he_frames() -> list:
    s = HE_SIZE
    clip = oracle.make_test_clip(s, s, HE_FRAMES, seed=HE_SEED)
    return [(c[:s * s].reshape(s, s),
             c[s * s:s * s * 5 // 4].reshape(s // 2, s // 2),
             c[s * s * 5 // 4:].reshape(s // 2, s // 2)) for c in clip]


def _blocks(max_coeffs: int, seed: int):
    """Seeded blocks over the coder's cases: empty, sparse, dense, trailing
    ones, large levels (escapes)."""
    rng = np.random.default_rng(seed)
    n = 600
    lv = rng.integers(-3, 4, (n, max_coeffs))
    lv[rng.random((n, max_coeffs)) < rng.random((n, 1))] = 0
    big = rng.random((n, max_coeffs)) < 0.05
    lv[big] = rng.integers(-3000, 3000, big.sum())
    lv[:20] = 0
    nc = (np.full(n, -1) if max_coeffs == 4
          else rng.integers(0, 17, n))
    return lv.astype(np.int32), nc


def _bit_strings(vals, lens) -> list:
    """Per block, its codes in slot order as one string of bits."""
    return ["".join(format(int(v), f"0{int(n)}b")[-int(n):]
                    for v, n in zip(vr, lr) if n > 0)
            for vr, lr in zip(np.asarray(vals), np.asarray(lens))]


@pytest.mark.parametrize("max_coeffs", [16, 15, 4])
def test_encode_blocks_equals_jax_and_cavlc_dev(max_coeffs):
    lv, nc = _blocks(max_coeffs, seed=max_coeffs)
    v, l = cavlc_vec.encode_blocks(lv, nc, max_coeffs)
    jv, jl = jax_vec.encode_blocks(lv, nc, max_coeffs)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(l, jl)
    dv, dl = cavlc_dev.encode_blocks(torch.as_tensor(lv), torch.as_tensor(nc),
                                     max_coeffs)
    assert _bit_strings(v, l) == _bit_strings(dv, dl)


def test_host_entropy_equals_jax_and_device_entropy():
    refs = torch_jax_refs.load("parallel")
    streams = {}
    for host in (True, False):
        enc = TorchEncoder(EncoderConfig(**HE_CFG), device="cpu")
        enc.host_entropy = host
        streams[host] = b"".join(enc.encode_frame(*f) for f in he_frames())
    assert streams[True] == refs["he_stream"].tobytes()
    assert streams[True] == streams[False]


@pytest.mark.parametrize("field,value,error", [
    ("deblock", True, AssertionError),
    ("weightp", 1, AssertionError),
])
def test_host_entropy_refuses(field, value, error):
    """JAX's two asserts of the CAVLC host path (no loop filter, no
    weighted prediction); with --cabac the encoder takes the
    syntax-tensor CABAC route (test_torch_host_cabac.py)."""
    enc = TorchEncoder(EncoderConfig(**{**HE_CFG, field: value}),
                       device="cpu")
    enc.host_entropy = True
    with pytest.raises(error):
        enc.encode_frame(*he_frames()[0])
