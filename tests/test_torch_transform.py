"""Port's integer transform + quantisation vs the JAX package, exactly.

Same numpy-seeded inputs through x264vfw_tpu.ops.transform and
x264vfw_tpu_torch.ops.transform; every comparison is integer equality
(tolerance: none).  The quantisers' and DC paths' JAX outputs at every
QP are committed as digests in tests/jax_refs/units.npz
(tools/make_torch_jax_refs.py units, hash-guarded).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.ops import transform as tj
from x264vfw_tpu.ops import transform_np as tnp
from x264vfw_tpu_torch.ops import tables
from x264vfw_tpu_torch.ops import transform as tt

QPS = (0, 5, 11, 12, 23, 26, 35, 36, 41, 51)


def _ints(shape, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, size=shape) \
        .astype(np.int32)


def _same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,lo,hi", [("fdct4x4", -255, 255),
                                         ("idct4x4_core", -9000, 9000),
                                         ("hadamard4x4", -4080, 4080),
                                         ("hadamard2x2", -4080, 4080)])
def test_unquantised_transforms(name, lo, hi):
    shape = (97, 2, 2) if name == "hadamard2x2" else (97, 4, 4)
    x = _ints(shape, lo, hi, seed=len(name))
    _same(getattr(tt, name)(torch.from_numpy(x)),
          getattr(tj, name)(jnp.asarray(x)))


def jax_units() -> dict:
    """The JAX package's side of test_quant_dequant_all_qps and
    test_dc_paths, as digests, committed in tests/jax_refs/units.npz
    (tools/make_torch_jax_refs.py units).  Each dequantiser takes the
    quantiser's output."""
    dig = torch_jax_refs.digest
    out = {}
    w = jnp.asarray(_ints((64, 4, 4), -9180, 9180, seed=1))
    for intra in (True, False):
        for qp in range(52):
            q = tj.quant4x4(w, qp, intra=intra)
            out[f"tf_q{int(intra)}_{qp}"] = dig(q)
            out[f"tf_dq{int(intra)}_{qp}"] = dig(tj.dequant4x4(q, qp))
    for qp in QPS:
        lv = tj.luma_dc_fwd_quant(jnp.asarray(
            _ints((40, 4, 4), -4080, 4080, seed=qp)), qp)
        out[f"tf_ldc_{qp}"] = dig(lv)
        out[f"tf_ldq_{qp}"] = dig(tj.luma_dc_dequant(lv, qp))
        c = jnp.asarray(_ints((40, 2, 2), -2040, 2040, seed=qp + 1))
        for intra in (True, False):
            cl = tj.chroma_dc_fwd_quant(c, qp, intra)
            out[f"tf_cdc{int(intra)}_{qp}"] = dig(cl)
            out[f"tf_cdq{int(intra)}_{qp}"] = dig(tj.chroma_dc_dequant(cl,
                                                                       qp))
    return out


@pytest.fixture(scope="module")
def refs():
    return torch_jax_refs.load("units")


def _dig_same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    assert torch_jax_refs.digest(got) == str(want)


@pytest.mark.parametrize("intra", [True, False])
def test_quant_dequant_all_qps(refs, intra):
    w = _ints((64, 4, 4), -9180, 9180, seed=1)
    for qp in range(52):
        q = tt.quant4x4(torch.from_numpy(w), qp, intra=intra)
        _dig_same(q, refs[f"tf_q{int(intra)}_{qp}"])
        _dig_same(tt.dequant4x4(q, qp), refs[f"tf_dq{int(intra)}_{qp}"])


@pytest.mark.parametrize("qp", QPS)
def test_dc_paths(refs, qp):
    dc = _ints((40, 4, 4), -4080, 4080, seed=qp)
    lv = tt.luma_dc_fwd_quant(torch.from_numpy(dc), qp)
    _dig_same(lv, refs[f"tf_ldc_{qp}"])
    _dig_same(tt.luma_dc_dequant(lv, qp), refs[f"tf_ldq_{qp}"])
    c = _ints((40, 2, 2), -2040, 2040, seed=qp + 1)
    for intra in (True, False):
        cl = tt.chroma_dc_fwd_quant(torch.from_numpy(c), qp, intra)
        _dig_same(cl, refs[f"tf_cdc{int(intra)}_{qp}"])
        _dig_same(tt.chroma_dc_dequant(cl, qp),
                  refs[f"tf_cdq{int(intra)}_{qp}"])


def test_zigzag_and_tables():
    x = _ints((11, 4, 4), -50, 50, seed=3)
    z = tt.zigzag_scan(torch.from_numpy(x))
    _same(z, tj.zigzag_scan(jnp.asarray(x)))
    _same(tt.zigzag_unscan(z), x)
    for name in ("DEQUANT_TABLE", "QUANT_TABLE", "QUANT_MF", "DEQUANT_V",
                 "ZIGZAG_4x4", "_CHROMA_QP_TABLE"):
        np.testing.assert_array_equal(getattr(tables, name),
                                      getattr(tnp, name), err_msg=name)
    for off in (-12, -3, 0, 4, 12):
        np.testing.assert_array_equal(tables.chroma_qp(np.arange(52), off),
                                      tnp.chroma_qp(np.arange(52), off))
