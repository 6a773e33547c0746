"""Hand-written CUDA kernels for the compute hot spots, each beside its plain
PyTorch version:

  * gram.py + csrc/gram.cu: stage-1 batch kernel matrix, from fp32 rows
    (kernel B1) or from int8 codes with their scale table (kernel B3);
  * smo.py  + csrc/smo.cu:  stage-2 SMO epoch over all tasks, whole G or
    one streamed row block (kernel B2);
  * flash_attention.py + csrc/flash_attention.cu: the backbone's attention
    core, online softmax over grouped-query heads (kernel B4), with the
    autograd Function that training goes through;
  * exact.py + csrc/exact_epoch.cu: one epoch of the exact dual solver over
    the full Q, the Table 2 comparator (kernel E1; it replaces a jit loop,
    not a TPU kernel).

ops.py holds the public wrappers that dispatch by device; build.py compiles
csrc/ with nvcc at first use.
"""
from repro_torch.kernels.ops import (exact_epoch, flash_attention, gram, gram_q8,
                                     smo_epoch)

__all__ = ["exact_epoch", "flash_attention", "gram", "gram_q8", "smo_epoch"]
