"""Quarter-pel refinement + luma MC: the port's plain version vs the JAX
golden model.

x264vfw_tpu_torch.ops.kernels.memc.partition_refine_mc_plain against
x264vfw_tpu.encode.inter_partition._refine_and_mc_xla (which
tests/test_pallas_memc.py holds bit-equal to the Pallas kernel), the
half-pel planes against encode/device._halfpel_planes, and the partition
decision's lambda table against the JAX float32 expression (the golden
model's outputs committed in tests/jax_refs/units.npz,
tools/make_torch_jax_refs.py, hash-guarded).  Inputs come from numpy
seeds.  Tolerance: none.  The CUDA kernel is held against the
plain version on the card (the `cuda` test below and chip_smoke.py).
"""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.encode import device as jdev
from x264vfw_tpu.encode import inter_partition as jip
from x264vfw_tpu_torch.encode import device as tdev
from x264vfw_tpu_torch.encode.inter_partition import LAMBDA
from x264vfw_tpu_torch.ops.kernels import memc as tmemc

SHAPES = [(48, 64, 4), (64, 80, 8)]
LAYOUTS = [0, 1, 2, 3, "random"]

def _case(H, W, R, layout, seed):
    rng = np.random.default_rng(seed)
    P = R + 8
    src = rng.integers(0, 256, (H, W), dtype=np.uint8)
    # smooth reference: sub-pel candidates then win often, not just (0, 0)
    n = rng.integers(0, 256, (H + 2, W + 2)).astype(np.int32)
    ref = ((n[:-2, :-2] + n[2:, 2:] + n[1:-1, 1:-1] * 2) // 4).astype(np.uint8)
    src = np.where(rng.random((H, W)) < 0.7, np.roll(ref, (1, -2), (0, 1)),
                   src).astype(np.uint8)
    refp = np.pad(ref, P, mode="edge")
    mv8i = rng.integers(-R, R + 1, (H // 8, W // 8, 2)).astype(np.int32)
    if layout == "random":
        part = rng.integers(0, 4, (H // 16, W // 16)).astype(np.int32)
    else:
        part = np.full((H // 16, W // 16), layout, np.int32)
    return src, refp, mv8i, part


def _port(src, refp, mv8i, part, R, sub_lv):
    mv8, pred = tmemc.partition_refine_mc(
        *(torch.from_numpy(a) for a in (src, refp, mv8i, part)), R, sub_lv)
    return mv8.numpy(), pred.numpy()


def _halfpel_case():
    return np.random.default_rng(3).integers(0, 256, (40, 56)).astype(
        np.int32)


def jax_units() -> dict:
    """The JAX golden model's outputs for the half-pel plane and
    refinement tests (digests of the refinement's), committed in
    tests/jax_refs/units.npz (tools/make_torch_jax_refs.py units)."""
    refine = jax.jit(jip._refine_and_mc_xla, static_argnums=(4, 5))
    out = {f"mc_half_{i}": np.asarray(a) for i, a in enumerate(
        jdev._halfpel_planes(jnp.asarray(_halfpel_case())))}

    def run(src, refp, mv8i, part, R, sub_lv):
        return refine(jnp.asarray(src, jnp.int16),
                      jnp.asarray(refp, jnp.int16), jnp.asarray(mv8i),
                      jnp.asarray(part), R, sub_lv)

    for H, W, R in SHAPES:
        for layout in LAYOUTS:
            for sub_lv in (1, 2):
                case = _case(H, W, R, layout, seed=H + R + sub_lv)
                for name, a in zip(("mv", "pred"), run(*case, R, sub_lv)):
                    out[f"mc_ref_{H}x{W}_{R}_{layout}_{sub_lv}_{name}"] = \
                        torch_jax_refs.digest(a)
        out[f"mc_lv0_{H}x{W}_{R}"] = np.asarray(
            run(*_case(H, W, R, "random", seed=R), R, 0)[1])
    return out


@pytest.fixture(scope="module")
def units():
    return torch_jax_refs.load("units")


def test_halfpel_planes_match_jax(units):
    got = tdev._halfpel_planes(torch.from_numpy(_halfpel_case()))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), units[f"mc_half_{i}"])


@pytest.mark.parametrize("sub_lv", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("H,W,R", SHAPES)
def test_refine_plain_matches_jax(units, H, W, R, layout, sub_lv):
    src, refp, mv8i, part = _case(H, W, R, layout, seed=H + R + sub_lv)
    mv8, pred = _port(src, refp, mv8i, part, R, sub_lv)
    key = f"mc_ref_{H}x{W}_{R}_{layout}_{sub_lv}"
    assert torch_jax_refs.digest(mv8) == str(units[f"{key}_mv"])
    assert torch_jax_refs.digest(pred) == str(units[f"{key}_pred"])
    assert len(np.unique(mv8 - 4 * mv8i)) > 1     # sub-pel deltas won


@pytest.mark.parametrize("H,W,R", SHAPES)
def test_refine_sub_lv0_is_integer_mc(units, H, W, R):
    """sub_lv 0 is plain integer-pel MC at each block's vector.  The JAX
    golden model's sub_lv 0 branch reads one column to the left (its
    single alignment variant is the o = -1 one); ROADMAP.md section C
    records that reference fault, and this test pins it."""
    src, refp, mv8i, part = _case(H, W, R, "random", seed=R)
    P = R + 8
    mv8, pred = _port(src, refp, mv8i, part, R, 0)
    np.testing.assert_array_equal(mv8, 4 * mv8i)
    ys = np.arange(H)[:, None] + np.repeat(np.repeat(mv8i[..., 1], 8, 0),
                                           8, 1)
    xs = np.arange(W)[None, :] + np.repeat(np.repeat(mv8i[..., 0], 8, 0),
                                           8, 1)
    np.testing.assert_array_equal(pred, refp[P + ys, P + xs])
    np.testing.assert_array_equal(units[f"mc_lv0_{H}x{W}_{R}"],
                                  refp[P + ys, P + xs - 1])


def test_lambda_table_matches_jax():
    f = jax.jit(lambda qp: jnp.maximum(1, jnp.round(
        3.4 * jnp.exp2((jnp.asarray(qp, jnp.float32) - 12.0) / 3.0)))
        .astype(jnp.int32))
    assert [int(f(q)) for q in range(52)] == LAMBDA.tolist()


def test_cuda_operand_table_matches_qpel_pairs():
    """The kernel's Table 8-12 operand pairs (csrc/memc.cu qpel_pair, one
    `case 0x<fx><fy>:` per fractional position, from which every candidate's
    operand rows are derived at compile time) are the port's _QPEL_PAIRS,
    entry for entry."""
    path = os.path.join(tmemc.build.CSRC_DIR, "memc.cu")
    cases = re.findall(r"case 0x([0-3])([0-3]): return "
                       r"\{\{(-?\d+), (-?\d+), (-?\d+)\}, "
                       r"\{(-?\d+), (-?\d+), (-?\d+)\}\};",
                       open(path).read())
    assert len(cases) == 16
    got = {(int(c[0]), int(c[1])): [int(x) for x in c[2:]] for c in cases}
    assert set(got) == set(tdev._QPEL_PAIRS)
    for (fx, fy), row in got.items():
        (p1, x1, y1), (p2, x2, y2) = tdev._QPEL_PAIRS[(fx, fy)]
        assert row == [p1, x1, y1, p2, x2, y2], (fx, fy)


@pytest.mark.parametrize("bad", ["dtype", "shape", "radius", "sub_lv",
                                 "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    src, refp, mv8i, part = (torch.from_numpy(a)
                             for a in _case(32, 48, 4, 0, seed=1))
    R, sub_lv = 4, 2
    if bad == "dtype":
        mv8i = mv8i.to(torch.int64)
    elif bad == "shape":
        refp = refp[:-1]
    elif bad == "radius":
        R = 40
    elif bad == "sub_lv":
        sub_lv = 3
    else:
        part = part.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        tmemc.partition_refine_mc(src, refp, mv8i, part, R, sub_lv)


def test_cpu_tensor_takes_plain_version():
    args = [torch.from_numpy(a) for a in _case(32, 32, 3, "random", seed=2)]
    before = tmemc.LAUNCHES
    got = tmemc.partition_refine_mc(*args, 3, 2)
    assert tmemc.LAUNCHES == before
    want = tmemc.partition_refine_mc_plain(*args, 3, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H,W,R", [
    ("random", 1088, 1920, 16), ("random", 48, 320, 4), ("random", 64, 80, 8),
    ("random", 32, 272, 16),
    ("random", 16, 16, 4),          # one MB: one CTA, one warp
    ("all_parts", 64, 80, 8),       # partition codes 0-3 in turn
    ("all_parts", 48, 320, 4),      # mbw not a multiple of the CTA's strip
    ("flat", 32, 272, 16),          # every candidate's SAD ties
    ("flat", 64, 80, 8)])
def test_kernel_matches_plain_on_card(kind, H, W, R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    src, refp, mv8i, part = _case(H, W, R, "random", seed=R)
    if kind == "all_parts":
        part = (np.arange(part.size) % 4).reshape(part.shape).astype(np.int32)
    elif kind == "flat":
        src[:] = 77
        refp[:] = 77
    args = [torch.from_numpy(a).cuda() for a in (src, refp, mv8i, part)]
    for sub_lv in (0, 1, 2):
        before = tmemc.LAUNCHES
        got = tmemc.partition_refine_mc(*args, R, sub_lv)
        assert tmemc.LAUNCHES == before + 1
        want = tmemc.partition_refine_mc_plain(*args, R, sub_lv)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), sub_lv
