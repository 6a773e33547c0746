"""Hand-written CUDA kernels for the two compute hot spots, each beside its
plain PyTorch version:

  * gram.py + csrc/gram.cu: stage-1 batch kernel matrix (kernel B1);
  * smo.py  + csrc/smo.cu:  stage-2 SMO epoch over all tasks (kernel B2).

ops.py holds the public wrappers that dispatch by device; build.py compiles
csrc/ with nvcc at first use.
"""
from repro_torch.kernels.ops import gram, smo_epoch

__all__ = ["gram", "smo_epoch"]
