"""x264vfw_tpu_torch — the PyTorch/CUDA port of x264vfw_tpu.

A second package beside the JAX one, held byte for byte against it: the
same inputs give the same syntax tensors, reconstructions and Annex-B
bytes.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a kernel written by hand for Hopper (csrc/, built with
nvcc at first use and bound with ctypes); the host CABAC passes are C
(csrc/host/, built with gcc at first use).  Entry points run on the CUDA
device unless the caller passes device="cpu", where each kernel's plain
PyTorch version takes its place.

Ported so far: the whole compress side: CompressSession with x264's
presets from ultrafast to slow (per frame and batched), every input
colourspace, --psnr/--ssim, the raw, Matroska, MP4, FLV and AVI muxers,
--threads N on one card, config persistence and the command line
(python -m x264vfw_tpu_torch.cli); ROADMAP.md lists the rest (the
decoder, multi-device GOP sharding).
"""

__version__ = "0.1.0"
