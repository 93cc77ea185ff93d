"""x264vfw_tpu_torch — the PyTorch/CUDA port of x264vfw_tpu.

A second package beside the JAX one, held byte for byte against it: the
same inputs give the same syntax tensors, reconstructions and Annex-B
bytes.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a kernel written by hand for Hopper (csrc/, built with
nvcc at first use and bound with ctypes); the host CABAC passes are C
(csrc/host/, built with gcc at first use).  Entry points run on the CUDA
device unless the caller passes device="cpu", where each kernel's plain
PyTorch version takes its place.

Ported so far: x264's --preset ultrafast (per frame and batched) and the
per-frame --preset veryfast / superfast --tune zerolatency lines (CABAC,
I4x4, the 8x8 transform, AQ, weighted P, scene cuts); ROADMAP.md lists
the rest.
"""

__version__ = "0.1.0"
