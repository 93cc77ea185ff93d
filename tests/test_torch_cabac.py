"""The host CABAC transcode: the port's bitstream/cabac_transcode against
the JAX package's, on the same CAVLC slices.

The slices are the port's own device CAVLC payloads, caught where the
encoder hands them to the transcoder, from sessions that cover the I and
P branches with and without the 8x8 transform (transform_size_8x8_flag)
and with and without AQ (mb_qp_delta), I16x16 and I_NxN.  Both
transcoders must return the same bytes, and the port's must match the
CABAC slice the port's session wrote.  Also: the port builds its own
copies of the C sources (csrc/host/) into x264vfw_tpu_torch/_build/ and
never writes into tools/; a failed gcc build raises; a rejected slice
raises in the encoder; a B slice the parser cannot read is rejected as
the JAX transcoder rejects it (B slices themselves: test_torch_bframes.py).
Inputs come from numpy seeds; no tolerance.
"""

import os

import numpy as np
import pytest

from test_torch_live_presets import live_clip
from x264vfw_tpu.bitstream import cabac_transcode as jct
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.bitstream import cabac_transcode as tct
from x264vfw_tpu_torch.encode import torch_encoder as tenc
from x264vfw_tpu_torch.ops.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
BASE = "--preset veryfast --tune zerolatency --qp 26"
CASES = {"t8_aq": BASE,
         "t8": BASE + " --aq-mode 0",
         "aq": BASE + " --no-8x8dct",
         "plain": BASE + " --aq-mode 0 --no-8x8dct --partitions p8x8"}


@pytest.fixture(scope="module")
def slices():
    """{case: [(payload, hdr_bits, slice_type, mbh, mbw, qp, t8_mode,
    the port's CABAC slice)]} from a 4-frame session per case."""
    out = {}
    keep = tenc.TorchEncoder._transcode
    for case, cmd in CASES.items():
        got = []

        def spy(self, payload, hl, slice_type):
            body = keep(self, payload, hl, slice_type)
            got.append((payload.copy(), int(hl.sum()), slice_type, self.mbh,
                        self.mbw, self.qp,
                        bool(self.pps.transform_8x8_mode_flag), body))
            return body

        tenc.TorchEncoder._transcode = spy
        try:
            s = CompressSession(extra_cmdline=cmd, device="cpu")
            s.begin(W, H)
            for f in live_clip(W, H, 4, seed=31):
                s.compress(f)
            s.end()
        finally:
            tenc.TorchEncoder._transcode = keep
        out[case] = got
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_transcode_equals_jax(slices, case):
    assert [s[2] for s in slices[case]] == ["I", "P", "P", "P"]
    for payload, hdr_bits, st, mbh, mbw, qp, t8_mode, body in slices[case]:
        got = tct.transcode_slice(payload, hdr_bits, st, mbh, mbw, qp,
                                  t8_mode=t8_mode)
        want = jct.transcode_slice(payload, hdr_bits, st, mbh, mbw, qp,
                                   t8_mode=t8_mode)
        assert got is not None and got == want == body, (case, st)


def test_cases_cover_the_syntax(slices):
    """The P slices carry 8x8 flags only where the PPS has the 8x8 mode,
    and mb_qp_delta only with AQ; the I slices have I_NxN MBs where
    --partitions has i4x4."""
    from x264vfw_tpu_torch.bitstream import native_parse
    for case, got in slices.items():
        t8 = qpd = 0
        for payload, hdr_bits, st, mbh, mbw, qp, t8_mode, _ in got:
            syn = native_parse.parse_slice(payload, hdr_bits,
                                           0 if st == "P" else 2, mbh, mbw,
                                           qp, 1, t8_mode)
            if st == "I":
                assert (syn["mb_kind"] == 6).any() == (case != "plain")
            else:
                t8 += int(syn["t8"].sum())
                qpd += int((syn["qpd"] != 0).sum())
        assert (t8 > 0) == case.startswith("t8"), (case, t8)
        assert (qpd > 0) == ("aq" in case), (case, qpd)


# the one repair the port's copy of the C coder makes (ROADMAP.md,
# section C): ref_idx contexts of P partitions over several references
# read the MB's earlier partitions (test_torch_host_cabac.py::
# test_partition_ref_idx_context_fault_not_copied)
SOURCE_REPAIRS = {"cabac_ext.c": ("""            if (nref > 1)
                for (int pi = 0; pi < np; pi++)
                    ref_idx_code(&c, m, qx0 + POS[pt][pi][0],
                                 qy0 + POS[pt][pi][1], r);
""", """            if (nref > 1)
                for (int pi = 0; pi < np; pi++) {
                    int qx = qx0 + POS[pt][pi][0], qy = qy0 + POS[pt][pi][1];
                    ref_idx_code(&c, m, qx, qy, r);
                    /* the MB's later partitions read this one as their
                     * neighbour A or B (9.3.3.1.1.6) */
                    ref_fill(m, qx, qy, pt == 0 ? 2 : SIZ[pt][0],
                             pt == 0 ? 2 : SIZ[pt][1], r);
                }
""")}


def test_builds_its_own_copies(slices):
    """The port's host libraries come from csrc/host/ and live in
    _build/; the sources equal the JAX side's but for SOURCE_REPAIRS, and
    nothing under tools/ changed while the port built and ran them."""
    tools = os.path.join(ROOT, "tools")
    before = {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
              for d, _, ns in os.walk(tools) for n in ns}
    for name, files in build.HOST_SOURCES.items():
        path = build.host_library_path(name)
        assert os.path.dirname(path) == build.BUILD_DIR
        assert build.BUILD_DIR.startswith(os.path.join(ROOT,
                                                       "x264vfw_tpu_torch"))
        lib = build.load_host(name)
        assert os.path.samefile(lib._name, path)
        for f in files:
            src = "decparse" if name == "cavlcparse" else "cabac"
            with open(os.path.join(build.HOST_DIR, f)) as a, \
                    open(os.path.join(tools, src, f)) as b:
                port, jax = a.read(), b.read()
            if f in SOURCE_REPAIRS:
                was, now = SOURCE_REPAIRS[f]
                assert jax.count(was) == 1, f
                jax = jax.replace(was, now)
            assert port == jax, f
    after = {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
             for d, _, ns in os.walk(tools) for n in ns}
    assert after == before


def test_failed_gcc_build_raises(tmp_path, monkeypatch):
    (tmp_path / "cabac_ext.c").write_text("this is not C\n")
    (tmp_path / "cabac_tables.h").write_text("")
    monkeypatch.setattr(build, "HOST_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="gcc failed"):
        build.load_host("cabac")


def test_rejected_slice_raises(monkeypatch):
    monkeypatch.setattr(tct, "transcode_slice", lambda *a, **k: None)
    s = CompressSession(extra_cmdline=BASE, device="cpu")
    s.begin(W, H)
    with pytest.raises(RuntimeError, match="rejected"):
        s.compress(live_clip(W, H, 1, seed=31)[0])
    assert s.error


def test_b_slices_are_refused():
    """B slices go through the transcoder now; one that does not parse
    (all zero bits) is refused with None, by both transcoders, and an
    unknown slice type raises."""
    junk = np.zeros(8, np.uint8)
    assert tct.transcode_slice(junk, 8, "B", 3, 4, 26) is None
    assert jct.transcode_slice(junk, 8, "B", 3, 4, 26) is None
    with pytest.raises(ValueError):
        tct.transcode_slice(junk, 8, "SP", 3, 4, 26)
