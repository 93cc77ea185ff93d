"""The encoder's syntax-tensor CABAC route (TorchEncoder.host_entropy with
--cabac: the I, P or B core alone, its syntax tensors pulled, the slice
written on the host by the C coder bitstream/cabac_native.py), held to
the JAX package and to the port's own hot path.

On tests/test_cabac_transcode.py's four configurations (basic;
full-feature: AQ, trellis, I4x4, P partitions; three references; two B
frames), at 64x64 over 6 frames, the route's stream equals the JAX
package's syntax-tensor CABAC stream (its TpuEncoder with _transcode_ok
returning False; tests/jax_refs/host_cabac.npz, written by
tools/make_torch_jax_refs.py host_cabac) and the port's CAVLC -> CABAC
transcode route's.  The C coder equals bitstream/cabac_slice.CabacSlice,
its plain version, slice by slice on seeded syntax: I16x16, I16x16 with
I_NxN MBs, P16x16 with mb_qp_delta, P partitions with ref_idx over three
references, and B.  With the 8x8 transform, where the JAX package's route
writes no transform_size_8x8_flag (its stream does not decode to its
reconstruction), the port's stream decodes in stock FFmpeg to its own.
Without the C coder the route raises.  The C coder's ref_idx contexts
of P partitions over several references follow the standard, not the
JAX package's copy of the coder (ROADMAP.md, section C).
"""

import numpy as np
import pytest

import oracle
import torch_jax_refs
from x264vfw_tpu_torch.bitstream import cabac_native as cn
from x264vfw_tpu_torch.bitstream.cabac_slice import CabacSlice
from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
from x264vfw_tpu_torch.ops.kernels import build

SIZE, FRAMES = 64, 6
CONFIGS = {
    "basic": dict(qp=28, keyint=4, deblock=True),
    "full-feature": dict(qp=30, keyint=8, deblock=True, aq_strength=1.0,
                         trellis=True, i4x4=True, partitions=True),
    "multiref": dict(qp=30, keyint=8, deblock=True, num_ref_frames=3),
    "bframes": dict(qp=30, keyint=8, deblock=True, bframes=2),
}
T8_CFG = dict(qp=28, keyint=4, deblock=True, dct8x8=True, i4x4=True,
              aq_strength=1.0)
MBH, MBW, SLICE_QP = 4, 5, 27


def clip(w=SIZE, h=SIZE, n=FRAMES, seed=7) -> list:
    """tests/test_cabac_transcode.py's clip: a textured pattern moving by
    (-2, 1) pixels per frame, chroma drifting."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (60 + 80 * np.sin((xx + 2 * yy) / 23.0)
            + 50 * ((xx // 20 + yy // 14) % 2)
            + r.integers(-14, 15, (h, w)))
    fs = []
    for i in range(n):
        y = np.clip(np.roll(base, (i, -2 * i), (0, 1)), 0, 255) \
            .astype(np.uint8)
        u = np.clip(120 + 30 * np.sin(xx[::2, ::2] / 31.0 + i),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 24 * np.cos(yy[::2, ::2] / 27.0 - i),
                    0, 255).astype(np.uint8)
        fs.append((y, u, v))
    return fs


def encode_stream(enc, frames=None) -> bytes:
    """headers(), then every AU of push_frame over the clip and flush()
    (the JAX test's _encode, for either package's encoder)."""
    bs = enc.headers()
    for f in clip() if frames is None else frames:
        for au, *_ in enc.push_frame(*f):
            bs += au
    for au, *_ in enc.flush():
        bs += au
    return bs


def port_stream(host_entropy: bool, **kw) -> bytes:
    enc = TorchEncoder(EncoderConfig(width=SIZE, height=SIZE, cabac=True,
                                     **kw), device="cpu")
    enc.host_entropy = host_entropy
    return encode_stream(enc)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_equals_jax_and_the_transcode(name):
    refs = torch_jax_refs.load("host_cabac")
    got = port_stream(True, **CONFIGS[name])
    assert got == refs[f"{name}_stream"].tobytes()
    assert got == port_stream(False, **CONFIGS[name])


def _luma(stream: bytes) -> list:
    decoded = oracle.decode_h264(stream)
    assert decoded is not None and len(decoded) == FRAMES
    return [d[:SIZE * SIZE].reshape(SIZE, SIZE) for d in decoded]


def test_route_with_the_8x8_transform_decodes_to_its_reconstruction():
    """A departure from a fault of the JAX package (ROADMAP.md, section
    C): with --8x8dct its route's P slices carry no
    transform_size_8x8_flag, though the PPS enables the 8x8 transform,
    so FFmpeg does not decode its stream to its reconstruction.  The
    port's route writes the flags (the C coder's t8 input, as the
    transcode route does), and its stream decodes to its own
    reconstruction."""
    refs = torch_jax_refs.load("host_cabac")
    jax_stream = refs["t8_stream"].tobytes()
    assert any((d != refs[f"t8_recon_{i}"]).any()
               for i, d in enumerate(_luma(jax_stream)))
    enc = TorchEncoder(EncoderConfig(width=SIZE, height=SIZE, cabac=True,
                                     **T8_CFG), device="cpu")
    enc.host_entropy = True
    bs, recon = enc.headers(), []
    for f in clip():
        bs += enc.encode_frame(*f)
        recon.append(enc.last_recon[0])
    assert bs != jax_stream
    for i, (d, r) in enumerate(zip(_luma(bs), recon)):
        np.testing.assert_array_equal(d, r, err_msg=f"frame {i}")


def test_route_raises_without_the_c_coder(monkeypatch):
    def no_gcc(name):
        raise RuntimeError(f"gcc failed on csrc/host/{name}")

    monkeypatch.setattr(build, "load_host", no_gcc)
    enc = TorchEncoder(EncoderConfig(width=SIZE, height=SIZE, cabac=True,
                                     **CONFIGS["basic"]), device="cpu")
    enc.host_entropy = True
    with pytest.raises(RuntimeError, match="gcc failed"):
        enc.encode_frame(*clip()[0])


# ------------------------------------------------- C coder vs CabacSlice

def _levels(rng, shape):
    """Sparse seeded levels with a few beyond the unary prefix (escapes)."""
    lv = rng.integers(-3, 4, shape)
    lv[rng.random(shape) < 0.6] = 0
    big = rng.random(shape) < 0.03
    lv[big] = rng.integers(-600, 600, int(big.sum()))
    return lv.astype(np.int32)


def _residual(rng, n, coded):
    """cbp_luma, cbp_chroma and the residual arrays masked by them (zero
    where an MB codes none)."""
    cbp_l = np.where(coded, rng.integers(0, 16, n), 0).astype(np.int32)
    cbp_c = np.where(coded, rng.integers(0, 3, n), 0).astype(np.int32)
    quad = ((cbp_l[:, None] >> (np.arange(16) // 4)) & 1).astype(bool)
    dc = (cbp_c >= 1)[:, None]
    ac = (cbp_c == 2)[:, None, None]
    return (cbp_l, cbp_c,
            np.where(quad[:, :, None], _levels(rng, (n, 16, 16)), 0),
            np.where(dc, _levels(rng, (n, 4)), 0),
            np.where(dc, _levels(rng, (n, 4)), 0),
            np.where(ac, _levels(rng, (n, 4, 15)), 0),
            np.where(ac, _levels(rng, (n, 4, 15)), 0))


def _mbs(cs, n, write):
    for k in range(n):
        write(k, k % MBW, k // MBW)
        cs.end_mb(k == n - 1)
    return cs.payload()


def _i_case(rng, n, with_i4):
    i16 = rng.integers(0, 4, n).astype(np.int32)
    cmode = rng.integers(0, 4, n).astype(np.int32)
    acf = rng.integers(0, 2, n).astype(np.uint8)
    cbc = rng.integers(0, 3, n).astype(np.int32)
    dc = _levels(rng, (n, 16))
    ac = np.where(acf[:, None, None].astype(bool), _levels(rng, (n, 16, 15)),
                  0)
    _, _, _, dcu, dcv, acu, acv = _residual(rng, n, np.ones(n, bool))
    dcu, dcv = (np.where((cbc >= 1)[:, None], a, 0) for a in (dcu, dcv))
    acu, acv = (np.where((cbc == 2)[:, None, None], a, 0) for a in (acu, acv))
    i4 = None
    if with_i4:
        use = rng.random(n) < 0.5
        prev = rng.integers(0, 2, (n, 16)).astype(np.uint8)
        rem = rng.integers(0, 8, (n, 16)).astype(np.int32)
        cbp4 = np.where(use, rng.integers(0, 16, n), 0).astype(np.int32)
        quad = ((cbp4[:, None] >> (np.arange(16) // 4)) & 1).astype(bool)
        lv4 = np.where(quad[:, :, None], _levels(rng, (n, 16, 16)), 0)
        i4 = (use.astype(np.uint8), prev, rem, cbp4, lv4)
    got = cn.encode_i_slice(SLICE_QP, MBH, MBW, i16, cmode, acf, cbc, dc, ac,
                            dcu, dcv, acu, acv, i4=i4)
    cs = CabacSlice(SLICE_QP, True, MBH, MBW)

    def write(k, mx, my):
        if i4 is not None and i4[0][k]:
            cs.i4_mb(mx, my, i4[1][k], i4[2][k], int(cmode[k]),
                     int(i4[3][k]), int(cbc[k]), i4[4][k], dcu[k], dcv[k],
                     acu[k], acv[k])
        else:
            cs.i16_mb(mx, my, int(i16[k]), int(cmode[k]), bool(acf[k]),
                      int(cbc[k]), dc[k], ac[k], dcu[k], dcv[k], acu[k],
                      acv[k])
    return got, _mbs(cs, n, write)


def _p_case(rng, n, parts, nref):
    skip = rng.random(n) < 0.3
    part = np.where(skip, 0, rng.integers(0, 4, n) if parts
                    else 0).astype(np.int32)
    used = np.array([[1, 0, 0, 0], [1, 0, 1, 0], [1, 1, 0, 0],
                     [1, 1, 1, 1]], bool)[part]
    mvd = np.where(used[:, :, None], rng.integers(-40, 41, (n, 4, 2)),
                   0).astype(np.int32)
    ref = np.where(skip, 0, rng.integers(0, nref, n)).astype(np.int32)
    res = _residual(rng, n, ~skip)
    has_res = (res[0] != 0) | (res[1] != 0)
    qpd = np.where(has_res, rng.integers(-4, 5, n), 0).astype(np.int32)
    got = cn.encode_p_slice(SLICE_QP, 0, MBH, MBW, skip.astype(np.uint8),
                            mvd, *res, qpd, part, ref, nref,
                            np.zeros(n, np.uint8), False)
    cs = CabacSlice(SLICE_QP, False, MBH, MBW)

    def write(k, mx, my):
        cs.p_mb(mx, my, bool(skip[k]), mvd[k], int(res[0][k]),
                int(res[1][k]), *(a[k] for a in res[2:]), qpd=int(qpd[k]),
                part=int(part[k]), ref=int(ref[k]), nref=nref)
    return got, _mbs(cs, n, write)


def _b_case(rng, n):
    skip = rng.random(n) < 0.3
    mode = np.where(skip, 0, rng.integers(0, 4, n)).astype(np.int32)
    mvd0 = np.where(((mode == 1) | (mode == 3))[:, None],
                    rng.integers(-40, 41, (n, 2)), 0).astype(np.int32)
    mvd1 = np.where(((mode == 2) | (mode == 3))[:, None],
                    rng.integers(-40, 41, (n, 2)), 0).astype(np.int32)
    res = _residual(rng, n, ~skip)
    got = cn.encode_b_slice(SLICE_QP, 0, MBH, MBW, skip.astype(np.uint8),
                            mode, mvd0, mvd1, *res, False,
                            np.zeros(n, np.uint8))
    cs = CabacSlice(SLICE_QP, False, MBH, MBW)

    def write(k, mx, my):
        cs.b_mb(mx, my, bool(skip[k]), int(mode[k]), mvd0[k], mvd1[k],
                int(res[0][k]), int(res[1][k]), *(a[k] for a in res[2:]))
    return got, _mbs(cs, n, write)


CODER_CASES = {
    "i16": lambda rng, n: _i_case(rng, n, False),
    "i4x4": lambda rng, n: _i_case(rng, n, True),
    "p16_qp_delta": lambda rng, n: _p_case(rng, n, False, 1),
    "p8x8_ref_idx": lambda rng, n: _p_case(rng, n, True, 3),
    "b": _b_case,
}


@pytest.mark.parametrize("kind", list(CODER_CASES))
def test_c_coder_equals_cabac_slice(kind):
    for seed in range(3):
        rng = np.random.default_rng(100 * seed + len(kind))
        got, want = CODER_CASES[kind](rng, MBH * MBW)
        assert len(got) > 8
        assert got == want, f"{kind}, seed {seed}"


def test_partition_ref_idx_context_fault_not_copied():
    """The JAX package's C coder (its copy of csrc/host/cabac_ext.c) codes
    every partition's ref_idx before it records any of them, so the
    bottom partition of a 16x8 MB reads its neighbour B, the top
    partition of the same MB, as refIdx 0 (9.3.3.1.1.6 reads it as 1).
    No encoder path writes P partitions with several references
    (ROADMAP.md, section C); the port's coder follows the standard and
    CabacSlice, and its bin string reads back."""
    from x264vfw_tpu.bitstream import cabac_native as jcn
    from x264vfw_tpu_torch.bitstream.cabac_slice import CabacSliceReader
    one = np.ones(1, np.int32)
    args = (np.zeros(1, np.uint8), np.zeros((1, 4, 2), np.int32),
            0 * one, 0 * one, np.zeros((1, 16, 16), np.int32),
            np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32),
            np.zeros((1, 4, 15), np.int32), np.zeros((1, 4, 15), np.int32),
            0 * one)
    got = cn.encode_p_slice(SLICE_QP, 0, 1, 1, *args, one, one, 2,
                            np.zeros(1, np.uint8), False)
    cs = CabacSlice(SLICE_QP, False, 1, 1)
    cs.p_mb(0, 0, False, args[1][0], 0, 0, *(a[0] for a in args[4:9]),
            part=1, ref=1, nref=2)
    cs.end_mb(True)
    assert got == cs.payload()
    assert jcn.encode_p_slice(SLICE_QP, 0, 1, 1, *args, part=one, ref=one,
                              nref=2) != got
    rd = CabacSliceReader(SLICE_QP, False, 1, 1, got)
    rd.num_ref_l0 = 2
    mb = rd.read_p_mb(0, 0)
    assert mb["part"] == 1 and list(mb["refs4"][[0, 2]]) == [1, 1], mb
