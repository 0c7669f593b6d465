"""linops_tpu_torch: the PyTorch/CUDA port of linops_tpu, slices 1 to 3.

Matrix-free linear operators in PyTorch: a lazy operator graph (scale, sum,
compose, adjoint wrappers over dense, function, identity, diagonal,
permutation and sparse operators: COO, CSR, ELL, block-sparse rows and the
Clos-routed CSR for unstructured patterns, built by ``opSparse``, with an
RCM reordering), compact L-BFGS operators and a preconditioned CG. The
block-sparse products run hand-written CUDA kernels for Hopper
(``kernels/csrc/``: K1/K2, the windowed K3-K6 for large x) and the routed
ones the lane-gather kernels K7-K12, on CUDA tensors; CPU tensors take
their plain PyTorch versions. Factories build on the CUDA device unless
given ``device="cpu"``.

Names follow ``linops_tpu`` so each module has an obvious counterpart; this
package imports ``torch`` and numpy, never ``jax``. The rest of the
reference's ``__all__`` comes with later slices.
"""

from .core.base import LinearOperatorException, Counters, compose_modes, MODES
from .core.base import LinearOperator as AbstractLinearOperator
from .core.dense import MatrixOperator, FunctionOperator, make_operator, aslinearoperator
from .core.algebra import Scale, Sum, Compose
from .core.adjoint import (AdjointOperator, TransposeOperator, ConjugateOperator,
                           adjoint, transpose, conj)
from .core.apply import matvec, matmat, mul, to_dense
from .core.precision import matmul_precision, f32_exact, check_f32_exact
from .ops.eye import Eye, UniversalEye, opEye
from .ops.diagonal import DiagonalOperator, opDiagonal
from .sparse import (BSR, COO, CSR, ELL, bsr_from_dense, coo_from_dense, csr_from_dense,
                     csr_from_parts, ell_from_csr_parts, ell_from_dense, BSROperator,
                     COOOperator, CSROperator, ELLOperator, RoutedCSROperator,
                     ReorderedOperator, opSparse)
from .ops.permutation import PermutationOperator, opPermutation
from .qn import LBFGSState, LBFGSOperator, InverseLBFGSOperator
from .utils.krylov import matvec_chain, cg

# reference spelling: the polymorphic constructor is exported as LinearOperator
LinearOperator = make_operator

__all__ = [
    "LinearOperatorException",
    "AbstractLinearOperator",
    "LinearOperator",
    "Counters",
    "compose_modes",
    "MODES",
    "MatrixOperator",
    "FunctionOperator",
    "make_operator",
    "aslinearoperator",
    "Scale",
    "Sum",
    "Compose",
    "AdjointOperator",
    "TransposeOperator",
    "ConjugateOperator",
    "adjoint",
    "transpose",
    "conj",
    "matvec",
    "matmat",
    "mul",
    "to_dense",
    "matmul_precision",
    "f32_exact",
    "check_f32_exact",
    "Eye",
    "UniversalEye",
    "opEye",
    "DiagonalOperator",
    "opDiagonal",
    "BSR",
    "COO",
    "CSR",
    "ELL",
    "bsr_from_dense",
    "coo_from_dense",
    "csr_from_dense",
    "csr_from_parts",
    "ell_from_csr_parts",
    "ell_from_dense",
    "BSROperator",
    "COOOperator",
    "CSROperator",
    "ELLOperator",
    "RoutedCSROperator",
    "ReorderedOperator",
    "PermutationOperator",
    "opPermutation",
    "opSparse",
    "LBFGSState",
    "LBFGSOperator",
    "InverseLBFGSOperator",
    "matvec_chain",
    "cg",
]
