"""Port's device CAVLC and bit packing vs the JAX package, exactly.

encode_blocks must give the same (vals, lens) slot for slot as
x264vfw_tpu.bitstream.cavlc_jax.encode_blocks, and pack_slots the same
bytes and bit count as x264vfw_tpu.encode.device_pack.pack_slots (its
outputs on these inputs committed in tests/jax_refs/core.npz,
tools/make_torch_jax_refs.py, hash-guarded) and as the host packer.
Tolerance: none.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_jax_refs
from x264vfw_tpu.bitstream import cavlc_jax
from x264vfw_tpu.utils.bitstream import pack_codes
from x264vfw_tpu_torch.bitstream import cavlc_dev
from x264vfw_tpu_torch.encode.device_pack import pack_slots as tpack


def _blocks(maxc, n, seed):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(size=(n, 1))
    mag = np.where(rng.uniform(size=(n, maxc)) < 0.9,
                   rng.integers(-3, 4, size=(n, maxc)),
                   rng.integers(-3000, 3001, size=(n, maxc)))
    return (mag * (rng.uniform(size=(n, maxc)) < dens)).astype(np.int32)


BLOCK_CASES = ((16, (0, 1, 2, 3, 4, 7, 8, 16)), (15, (0, 3, 6, 9)),
               (4, (-1,)))


def blocks_case(maxc, ncs):
    """(levels, nC) of an encode_blocks case: random blocks plus extremes
    (escape levels, trailing ones, a full block)."""
    lv = _blocks(maxc, 600, seed=maxc)
    extreme = np.zeros((6, maxc), np.int32)
    extreme[0, 0] = 2047
    extreme[1, 0] = -4000
    extreme[2, :3] = [1, -1, 1]
    extreme[3, :] = np.arange(1, maxc + 1)
    extreme[4, -1] = -7
    extreme[5, :2] = [30, -31]
    lv = np.concatenate([lv, extreme])
    rng = np.random.default_rng(1)
    return lv, rng.choice(np.asarray(ncs), size=lv.shape[0]).astype(np.int32)


@pytest.mark.parametrize("maxc,ncs", BLOCK_CASES)
def test_encode_blocks_slot_for_slot(maxc, ncs):
    """Against cavlc_jax.encode_blocks's slots on these inputs, committed
    in tests/jax_refs/calls.npz (blocks_<maxc>_vals/_lens)."""
    lv, nC = blocks_case(maxc, ncs)
    gv, gl = cavlc_dev.encode_blocks(torch.from_numpy(lv),
                                     torch.from_numpy(nC), maxc)
    refs = torch_jax_refs.load("calls")
    np.testing.assert_array_equal(gl.numpy(), refs[f"blocks_{maxc}_lens"])
    np.testing.assert_array_equal(gv.numpy(), refs[f"blocks_{maxc}_vals"])


def test_exp_golomb_codes():
    v = np.concatenate([np.arange(-300, 301), [8159, -8160, 65535]])
    for tf, jf, arg in ((cavlc_dev.ue_codes_dev, cavlc_jax.ue_codes_j,
                         np.abs(v)),
                        (cavlc_dev.se_codes_dev, cavlc_jax.se_codes_j, v)):
        gv, gl = tf(torch.from_numpy(arg.astype(np.int32)))
        wv, wl = jf(jnp.asarray(arg.astype(np.int32)))
        np.testing.assert_array_equal(gv.numpy(),
                                      np.asarray(wv).astype(np.int64))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


PACK_SHAPES = [(2500,), (40, 34), (7, 892)]


def pack_case(shape):
    """(vals, lens) of a slot array: random codes, half of them empty, and
    leading-zero long codes first."""
    rng = np.random.default_rng(sum(shape))
    lens = rng.integers(0, 32, size=shape)
    lens[rng.uniform(size=shape) < 0.5] = 0
    lens.flat[:3] = [46, 33, 31]                # leading-zero long codes
    vals = rng.integers(0, 1 << 31, size=shape) & ((1 << np.minimum(lens, 31)) - 1)
    return vals, lens


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_pack_slots_bytes(shape):
    vals, lens = pack_case(shape)
    got, nbits = tpack(torch.from_numpy(vals.astype(np.int64)),
                       torch.from_numpy(lens.astype(np.int32)))
    # the JAX package's pack_slots on this case (committed)
    refs = torch_jax_refs.load("core")
    i = PACK_SHAPES.index(shape)
    want, wbits = refs[f"pack_{i}_bytes"], int(refs[f"pack_{i}_bits"])
    assert nbits == wbits
    nb = (nbits + 7) // 8
    np.testing.assert_array_equal(got.numpy()[:nb], np.asarray(want)[:nb])
    ref, rbits = pack_codes(vals.reshape(-1).astype(np.uint64),
                            lens.reshape(-1).astype(np.int64))
    assert rbits == nbits
    np.testing.assert_array_equal(got.numpy()[:nb], ref[:nb])


def test_pack_slots_empty():
    got, nbits = tpack(torch.zeros(5, dtype=torch.int64),
                       torch.zeros(5, dtype=torch.int32))
    assert nbits == 0 and got.numel() == 0
