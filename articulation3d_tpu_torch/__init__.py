"""articulation3d_tpu_torch: the PyTorch/CUDA port of articulation3d_tpu.

A second package beside the JAX one, for one NVIDIA H100.  It mirrors the
JAX package's module names and imports nothing from it.  Plain tensor code
is PyTorch; the ROIAlign forward that the JAX package ran as a Pallas TPU
kernel is a hand-written CUDA kernel (`csrc/roi_align_fwd.cu`).  Entry
points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from .config import Config, load_config  # noqa: F401
