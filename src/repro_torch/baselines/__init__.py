"""Baselines the paper compares against (Table 2), ported from the JAX
package's ``baselines/``: the exact dual solver (kernel B1 for K, kernel E1
for its epochs), the LLSVM-style chunked solver (B1, then B2's full pass)
and primal mini-batch SGD (B1, then torch ops)."""
from repro_torch.baselines.exact_smo import ExactDualSVM
from repro_torch.baselines.llsvm import LLSVMStyle
from repro_torch.baselines.primal_sgd import PrimalSGDSVM

__all__ = ["ExactDualSVM", "LLSVMStyle", "PrimalSGDSVM"]
