"""The port stands alone and never runs quietly on the CPU.

* No file of x264vfw_tpu_torch/, nor chip_smoke.py, imports jax or
  anything of the JAX package x264vfw_tpu (AST scan of every import).
* The entry points default to the CUDA device and raise when there is
  none, instead of carrying on on the CPU.
* Options outside the ported slices raise NotImplementedError naming the
  ROADMAP instead of encoding something else; a session the JAX package
  would batch runs through the port's BatchPipeline.
"""

import ast
import os

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


@pytest.mark.parametrize("extra", ["", "--bframes 2", "--ref 2", "--cabac",
                                   "--partitions i8x8",
                                   "--partitions p8x8,i4x4",
                                   "--aq-mode 1", "--weightp 1"])
def test_out_of_slice_options_raise(extra):
    from x264vfw_tpu_torch.api import CompressSession
    base = "" if extra == "" else "--preset ultrafast --me esa "
    s = CompressSession(extra_cmdline=(base + extra).strip() or "--qp 26",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.begin(64, 48)


def test_other_containers_raise():
    from x264vfw_tpu_torch.output.base import select_muxer
    assert type(select_muxer("out.264")).__name__ == "RawMuxer"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_muxer("out.mp4")


@pytest.mark.parametrize("extra,batched", [("", True),
                                           (" --tune zerolatency", False),
                                           (" --threads 1", False),
                                           (" --me hex --subme 2", True)])
def test_batched_session_runs(extra, batched):
    """A session the JAX package sends to BatchPipeline (no zero-latency
    tune, --threads other than 1) now runs batched; zero-latency and
    --threads 1 sessions run per frame there too.  --me hex and --subme
    without partitions, refused before the hierarchical search and the
    16x16 sub-pel branch were ported, begin as well."""
    from x264vfw_tpu_torch.api import CompressSession
    s = CompressSession(extra_cmdline="--preset ultrafast --me esa --crf 23"
                        + extra, device="cpu")
    s.begin(64, 48)
    assert (s._pipe is not None) == batched
    assert s.frames_info().delay == (23 if batched else 0)
    s.end()
