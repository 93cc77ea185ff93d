"""The port stands alone and never runs quietly on the CPU.

* No file of x264vfw_tpu_torch/, nor chip_smoke.py, imports jax or
  anything of the JAX package x264vfw_tpu (AST scan of every import).
* The entry points (the decoder's among them) default to the CUDA
  device and raise when there is none, instead of carrying on on the CPU.
* No file of x264vfw_tpu_torch/, nor chip_smoke.py, names the tools/
  directory, whose C sources and libraries are the JAX package's: the
  port builds its own copies (csrc/host/) into its _build/.
* Options once refused now run (the two refusal tests keep their names:
  --threads > 1, --psnr/--ssim and every container); a session the JAX
  package would batch on one device runs through the port's
  BatchPipeline.
"""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "x264vfw_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "x264vfw_tpu")]
    assert bad == []


def test_port_never_names_the_tools_directory():
    """No string literal of the port's sources is a path into tools/
    (where the JAX package builds its host libraries)."""
    bad = []
    for f in _port_files():
        tree = ast.parse(open(f).read(), filename=f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.strip("/").split("/")[0] == "tools":
                bad.append((os.path.relpath(f, ROOT), node.value))
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_session_without_cuda_raises(no_cuda):
    from x264vfw_tpu_torch.api import CompressSession
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompressSession(extra_cmdline="--preset ultrafast --me esa")


def test_encoder_and_state_without_cuda_raise(no_cuda):
    import numpy as np
    from x264vfw_tpu_torch.convert import state_from_numpy
    from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
    from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
    with pytest.raises(RuntimeError):
        TorchEncoder(EncoderConfig(subpel=0))
    z = np.zeros((16, 16), np.int32)
    with pytest.raises(RuntimeError):
        state_from_numpy(z, z[:8, :8], z[:8, :8], frame_idx=1)


@pytest.mark.parametrize("make", ["session", "session_host", "decoder"])
def test_decoder_without_cuda_raises(no_cuda, make):
    """DecompressSession() (the device route and the output conversion on
    the card) and H264Decoder(use_device=True) raise without a card;
    H264Decoder() is the host route and needs none."""
    from x264vfw_tpu_torch.api import DecompressSession
    from x264vfw_tpu_torch.decode.decoder import H264Decoder
    with pytest.raises(RuntimeError, match="device='cpu'"):
        {"session": lambda: DecompressSession(),
         "session_host": lambda: DecompressSession(use_device=False),
         "decoder": lambda: H264Decoder(use_device=True)}[make]()
    assert H264Decoder().device is None


@pytest.mark.parametrize("base", ["", "--preset ultrafast --tune "
                                  "zerolatency --me esa"],
                         ids=["default", "zerolatency"])
@pytest.mark.parametrize("extra", ["--threads 2", "--psnr", "--ssim"])
def test_out_of_slice_options_raise(extra, base):
    """Refused before this slice (the name is kept from then): --threads >
    1 and --psnr/--ssim begin and encode a frame.  --threads 2 batches the
    default session (one device: the JAX package's one-device route) and
    keeps a zero-latency one per frame; a measuring session runs per frame
    either way and reports its stat in end()."""
    from x264vfw_tpu_torch.api import CompressSession
    s = CompressSession(extra_cmdline=(base + " " + extra).strip(),
                        device="cpu")
    s.begin(32, 32)
    assert (s._pipe is not None) == (extra == "--threads 2" and base == "")
    assert s.encoder.measure == (extra != "--threads 2")
    au = s.compress((np.full((32, 32), 90, np.uint8),
                     np.full((16, 16), 128, np.uint8),
                     np.full((16, 16), 128, np.uint8)))
    end = s.end()
    assert (au or end["tail"]) and end["frames"] == 1
    stat = extra.strip("-")
    assert (stat in end) == (stat != "threads 2")


@pytest.mark.parametrize("extra", ["", "--ref 2", "--trellis 1"])
def test_multi_ref_and_trellis_now_run(extra):
    """Refused before multi-reference P and trellis were ported: the
    default session (x264's --preset medium: --ref 3, trellis) and --ref
    2 or --trellis 1 on --preset ultrafast --me esa begin on the batched
    path and encode a frame, which comes out of end()."""
    from x264vfw_tpu_torch.api import CompressSession
    base = "" if extra == "" else "--preset ultrafast --me esa "
    s = CompressSession(extra_cmdline=(base + extra).strip(), device="cpu")
    s.begin(32, 32)
    au = s.compress((np.full((32, 32), 90, np.uint8),
                     np.full((16, 16), 128, np.uint8),
                     np.full((16, 16), 128, np.uint8)))
    end = s.end()
    assert (au or end["tail"]) and end["frames"] == 1
    enc = s.encoder
    assert s._pipe is not None
    assert enc.nref == {"": 3, "--ref 2": 2, "--trellis 1": 1}[extra]
    assert enc.cfg.trellis == (extra != "--ref 2")
    assert enc.pps.num_ref_idx_l0_default_active_minus1 == enc.nref - 1


def test_batched_pipeline_refuses_only_multi_ref():
    """BatchPipeline takes every option the encoder takes, several
    references too (it refused them before the sliding DPB was ported)."""
    from x264vfw_tpu_torch.encode.pipeline import BatchPipeline
    from x264vfw_tpu_torch.encode.ref_encoder import EncoderConfig
    from x264vfw_tpu_torch.encode.torch_encoder import TorchEncoder
    kw = dict(width=64, height=48, bframes=3, cabac=True, aq_strength=1.0,
              dct8x8=True, i4x4=True, weightp=1, scenecut=40)
    BatchPipeline(TorchEncoder(EncoderConfig(**kw), device="cpu"), rc=None,
                  mbtree=object())
    enc = TorchEncoder(EncoderConfig(**kw, num_ref_frames=2, trellis=True),
                       device="cpu")
    pipe = BatchPipeline(enc, rc=None)
    assert pipe.enc.nref == 2 and enc.dpb == []


@pytest.mark.parametrize("extra", ["--cabac", "--partitions i8x8",
                                   "--partitions p8x8,i4x4",
                                   "--aq-mode 1", "--weightp 1",
                                   "--8x8dct", "--scenecut 40",
                                   "--bframes 2", "--mbtree --rc-lookahead 4"])
def test_out_of_slice_options_now_run(extra):
    """Refused before CABAC, I4x4, AQ, weighted prediction, the 8x8
    transform, scene cuts, B frames and MB-tree were ported; they begin
    and encode a frame now (--partitions i8x8 is taken and ignored, as in
    the JAX package).  B frames and MB-tree make the session batched,
    whose frame comes out of end()."""
    from x264vfw_tpu_torch.api import CompressSession
    s = CompressSession(extra_cmdline="--preset ultrafast --tune zerolatency "
                        "--me esa " + extra, device="cpu")
    s.begin(32, 32)
    batched = extra.startswith(("--bframes", "--mbtree"))
    assert (s._pipe is not None) == batched
    au = s.compress((np.full((32, 32), 90, np.uint8),
                     np.full((16, 16), 128, np.uint8),
                     np.full((16, 16), 128, np.uint8)))
    end = s.end()
    assert (au or end["tail"]) and end["frames"] == 1
    cfg = s.encoder.cfg
    assert cfg.i4x4 == ("i4x4" in extra)
    assert (cfg.cabac, cfg.aq_strength > 0, cfg.weightp, cfg.dct8x8,
            cfg.scenecut, cfg.bframes, s.mbtree is not None) == (
        "--cabac" in extra, "--aq-mode" in extra, int("--weightp" in extra),
        "--8x8dct" in extra, 40 if "--scenecut" in extra else 0,
        2 if "--bframes" in extra else 0, "--mbtree" in extra)


@pytest.mark.parametrize("ext,muxer", [("264", "RawMuxer"),
                                       ("mkv", "MkvMuxer"),
                                       ("mp4", "Mp4Muxer"),
                                       ("flv", "FlvMuxer"),
                                       ("avi", "AviMuxer")])
def test_other_containers_raise(ext, muxer):
    """Refused before this slice but for raw Annex-B (the name is kept from
    then): the extension picks the muxer, as in the JAX package."""
    from x264vfw_tpu_torch.output.base import select_muxer
    assert type(select_muxer(f"out.{ext}")).__name__ == muxer
    assert type(select_muxer("out", ext)).__name__ == muxer


@pytest.mark.parametrize("extra,batched", [("", True),
                                           (" --tune zerolatency", False),
                                           (" --threads 1", False),
                                           (" --me hex --subme 2", True),
                                           (" --cabac", True),
                                           (" --aq-mode 1", True),
                                           (" --8x8dct", True)])
def test_batched_session_runs(extra, batched):
    """A session the JAX package sends to BatchPipeline (no zero-latency
    tune, --threads other than 1) runs batched; zero-latency and
    --threads 1 sessions run per frame there too.  --me hex and --subme
    without partitions, refused before the hierarchical search and the
    16x16 sub-pel branch were ported, begin as well, and so do CABAC, AQ
    and the 8x8 transform on the batched path, refused there before
    this slice."""
    from x264vfw_tpu_torch.api import CompressSession
    s = CompressSession(extra_cmdline="--preset ultrafast --me esa --crf 23"
                        + extra, device="cpu")
    s.begin(64, 48)
    assert (s._pipe is not None) == batched
    assert s.frames_info().delay == (23 if batched else 0)
    s.end()
