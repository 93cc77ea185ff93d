"""The hierarchical motion search and the 16x16 sub-pel branch: the port's
encode/device._motion_search_and_mc against the JAX package's, with
me_backend "auto:hier" (x264's --me dia/hex/umh), and the per-frame
sessions that run them.

The clip has two regions that move differently, with a border that does
not lie on an MB edge, and motion that runs toward the frame's edges, so
that the refine's neighbour alignment and the edge clamp both show.
Cases: rng 16 at integer, half and quarter pel; rng 7 (odd: rng_c and
lim differ from the even case); rng 5 (below 6 the search is exhaustive,
the SAD kernel's plain version).  The comparison is exact (mv_q, pred_y,
pred_u, pred_v).

The session of L4, --preset ultrafast --tune zerolatency --qp 26
--subme 7 --deblock 0:0 (the hierarchical search, 16x16 quarter-pel
refinement and the loop filter), 1 IDR + 3 P at 64x48 on a clip moving
beyond the +-2 rescue: bytes compared exactly with the JAX package's, and
stock FFmpeg decodes its stream to the port's own (deblocked)
reconstruction.  (The slice-2 partition line without --me esa is held to
slice 2's bytes in test_torch_partitions.py.)  Inputs come from numpy
seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from test_torch_session import moving_clip
from x264vfw_tpu.api import CompressSession as JaxSession
from x264vfw_tpu.encode import device as jdev
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.encode import device as tdev

H, W = 96, 128
_jax_search = jax.jit(jdev._motion_search_and_mc, static_argnums=(6, 7, 8))


def two_region_frames(seed, shifts=((11, -7), (-13, 5)), border=56):
    """(src planes, ref planes) int32: the source is the reference moved
    by shifts[0] (dx, dy) left of column `border` and by shifts[1] right
    of it (edge-clamped reads), with noise; chroma likewise at half
    size."""
    rng = np.random.default_rng(seed)

    def texture(h, w):
        n = rng.integers(0, 256, (h + 2, w + 2)).astype(np.int32)
        return sum(n[dy:dy + h, dx:dx + w] for dy in range(3)
                   for dx in range(3)) // 9

    def moved(ref, sh, b):
        h, w = ref.shape
        out = np.empty_like(ref)
        for (x0, x1), (dx, dy) in zip(((0, b), (b, w)), sh):
            ys = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
            xs = np.clip(np.arange(x0, x1)[None, :] + dx, 0, w - 1)
            out[:, x0:x1] = ref[ys, xs]
        return out

    ref = [texture(H, W), texture(H // 2, W // 2), texture(H // 2, W // 2)]
    src = [moved(ref[0], shifts, border)]
    half = [(dx // 2, dy // 2) for dx, dy in shifts]
    src += [moved(c, half, border // 2) for c in ref[1:]]
    src = [(s + rng.integers(-2, 3, s.shape)).clip(0, 255).astype(np.int32)
           for s in src]
    return src, ref


@pytest.mark.parametrize("rng_,subpel", [(16, 0), (16, 1), (16, 2), (7, 2),
                                         (5, 1)])
def test_motion_search_and_mc_matches_jax(rng_, subpel):
    src, ref = two_region_frames(seed=rng_ * 3 + subpel)
    planes = (*src, *ref)
    want = _jax_search(*(jnp.asarray(a) for a in planes), rng_, subpel,
                       "auto:hier")
    got = tdev._motion_search_and_mc(*(torch.from_numpy(a) for a in planes),
                                     rng_, subpel, "auto:hier")
    for name, g, w in zip(("mv_q", "pred_y", "pred_u", "pred_v"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    mv = got[0].numpy().reshape(-1, 2)
    # the search found both regions' motion (clipped to the range)
    assert len({tuple(v) for v in (mv // 4).tolist()}) > 2


def test_split_me_method():
    assert tdev._split_me_method("auto:hier") == ("auto", True)
    assert tdev._split_me_method("pallas_interpret") == ("pallas_interpret",
                                                         False)
    with pytest.raises(ValueError):
        tdev._split_me_method("dia")


def test_argmin_first_takes_the_first_minimum():
    cost = torch.tensor([[3, 1, 2], [1, 1, 2], [1, 5, 0]])
    idx, val = tdev._argmin_first(cost)
    assert idx.tolist() == [1, 0, 2] and val.tolist() == [1, 1, 0]


L4 = "--preset ultrafast --tune zerolatency --qp 26 --subme 7 --deblock 0:0"
SW, SH, NFR = 64, 48, 4


def session_clip():
    return moving_clip(SW, SH, NFR, seed=9, shift=(6, -5))


@pytest.fixture(scope="module")
def jax_l4():
    """The JAX package's access units for L4."""
    s = JaxSession(extra_cmdline=L4)
    s.begin(SW, SH)
    aus = [s.compress(f) for f in session_clip()]
    s.end()
    return aus


def test_session_bytes_equal_jax(jax_l4):
    s = CompressSession(extra_cmdline=L4, device="cpu")
    s.begin(SW, SH)
    cfg = s.encoder.cfg
    assert (cfg.me_backend, cfg.subpel, cfg.deblock, cfg.partitions) == \
        ("auto:hier", 2, True, False)
    aus = [s.compress(f) for f in session_clip()]
    assert s.end()["tail"] == b"" and s.frames_info().delay == 0
    assert len(aus) == len(jax_l4) == NFR
    for i, (got, want) in enumerate(zip(aus, jax_l4)):
        assert got == want, f"AU {i} differs"


def test_l4_stream_decodes_to_reconstruction():
    s = CompressSession(extra_cmdline=L4, device="cpu")
    s.begin(SW, SH)
    stream, recon = b"", []
    for f in session_clip():
        stream += s.compress(f)
        recon.append(s.encoder.last_recon[0])
    mv = s.encoder.last_mv.numpy().reshape(SH // 16, SW // 16, 2)
    assert (mv[1:-1, 1:-1] == [-24, 20]).all()     # 4 x the shift, reversed
    decoded = oracle.decode_h264(stream)
    assert decoded is not None and len(decoded) == NFR
    for d, r in zip(decoded, recon):
        np.testing.assert_array_equal(d[:SW * SH].reshape(SH, SW), r)
