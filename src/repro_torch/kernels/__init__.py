"""Hand-written CUDA kernels for the compute hot spots, each beside its plain
PyTorch version:

  * gram.py + csrc/gram.cu: stage-1 batch kernel matrix, from fp32 rows
    (kernel B1) or from int8 codes with their scale table (kernel B3);
  * smo.py  + csrc/smo.cu:  stage-2 SMO epoch over all tasks, whole G or
    one streamed row block (kernel B2).

ops.py holds the public wrappers that dispatch by device; build.py compiles
csrc/ with nvcc at first use.
"""
from repro_torch.kernels.ops import gram, gram_q8, smo_epoch

__all__ = ["gram", "gram_q8", "smo_epoch"]
