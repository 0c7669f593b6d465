"""linops_tpu_torch: the PyTorch/CUDA port of linops_tpu, slices 1 to 6.

Matrix-free linear operators in PyTorch: a lazy operator graph (scale, sum,
compose, adjoint wrappers over dense, function, identity, ones, zeros,
diagonal, permutation, restriction/extension, shifted, Kronecker, timed,
factorization-backed inverse (Cholesky, LDL, dense, iterative, sparse host
factor), Householder and hermitian operators, and sparse operators: COO,
CSR, ELL, block-sparse rows and the Clos-routed CSR for unstructured
patterns, built by ``opSparse``, with an RCM reordering; DIA diagonals and
grid stencils with the ``laplacian_*`` builders), block concatenation
(``hcat``, ``vcat``, ``hvcat``, block diagonal) and slicing
(``op[rows, cols]``); quasi-Newton operators (compact L-BFGS with shifted
solves, L-SR1, the diagonal family); the Krylov solvers (``cg`` for one or
several right-hand sides, ``gmres``, ``minres``, ``bicgstab``, ``lsqr``,
``chebyshev``, ``power_iteration``); norm, trace, diagonal and spectral-sum
estimators, ``funm_apply``, ``lobpcg``, ``svds``, ``rsvd`` and the Nyström
preconditioner; property checks and checkpointing. The block-sparse
products run hand-written CUDA kernels for Hopper (``kernels/csrc/``:
K1/K2, the windowed K3-K6 for large x) and the routed ones the lane-gather
kernels K7-K14, on CUDA tensors; CPU tensors take their plain PyTorch
versions. Every scatter-add sums in a fixed order. Factories build on the
CUDA device unless given ``device="cpu"``.

Names follow ``linops_tpu`` so each module has an obvious counterpart; this
package imports ``torch`` and numpy, never ``jax``. Of the reference's
``__all__`` two are still missing: ``apply_cache_sizes`` (no jit cache to
count) and ``apply_linear`` (the AD slice).
"""

from .core.base import LinearOperatorException, Counters, compose_modes, MODES
from .core.base import LinearOperator as AbstractLinearOperator
from .core.dense import MatrixOperator, FunctionOperator, make_operator, aslinearoperator
from .core.algebra import Scale, Sum, Compose
from .core.adjoint import (AdjointOperator, TransposeOperator, ConjugateOperator,
                           adjoint, transpose, conj)
from .core.apply import matvec, matmat, mul, to_dense
from .core.precision import matmul_precision, f32_exact, check_f32_exact
from .ops.eye import Eye, UniversalEye, Ones, Zeros, opEye, opOnes, opZeros
from .ops.diagonal import DiagonalOperator, opDiagonal
from .ops.restriction import RestrictionOperator, opRestriction, opExtension
from .ops.cat import HCatOperator, VCatOperator, BlockDiagonalOperator, hcat, vcat, hvcat
from .ops.shifted import ShiftedOperator
from .sparse import (BSR, COO, CSR, ELL, bsr_from_dense, coo_from_dense, csr_from_dense,
                     csr_from_parts, ell_from_csr_parts, ell_from_dense, BSROperator,
                     COOOperator, CSROperator, ELLOperator, RoutedCSROperator,
                     ReorderedOperator, opSparse)
from .ops.permutation import PermutationOperator, opPermutation
from .qn import (LBFGSState, LBFGSOperator, InverseLBFGSOperator, solve_shifted_system,
                 solve_shifted_systems, ldiv)
from .utils.krylov import (matvec_chain, cg, gmres, minres, bicgstab, lsqr, chebyshev,
                           power_iteration)
from .ops.kron import KronOperator, kron
from .ops.linalg_ops import (InverseOperator, IterativeInverseOperator, CholeskyOperator,
                             LDLOperator, HouseholderOperator, HermitianOperator, opInverse,
                             opIterativeInverse, opCholesky, opLDL, opHouseholder, opHermitian)
from .ops.timed import TimedOperator
from .ops.sparse_factor import SparseInverseOperator, opSparseInverse, opSparseLDL
from .qn import (LSR1State, LSR1Operator, DiagonalQNOperator, DiagonalPSB, DiagonalAndrei,
                 SpectralGradient, DiagonalBFGS)
from .sparse import (DIAOperator, opDIA, dia_from_dense, laplacian_1d, laplacian_2d,
                     laplacian_2d_dia, StencilOperator, Stencil2DOperator, opStencil, opStencil2D)
from .utils.norm import normest, estimate_opnorm
from .utils.estimate import (estimate_trace, estimate_diagonal, estimate_spectral_sum,
                             estimate_logdet, funm_apply)
from .utils.eig import lobpcg, svds, rsvd, nystrom_preconditioner, NystromPreconditioner
from .utils.checks import check_ctranspose, check_hermitian, check_positive_definite
from .utils.checkpoint import save_operator, load_operator_state, op_state

# reference spelling: the polymorphic constructor is exported as LinearOperator
LinearOperator = make_operator

# the reference's names for the same classes
TimedLinearOperator = TimedOperator
AdjointLinearOperator = AdjointOperator
TransposeLinearOperator = TransposeOperator
ConjugateLinearOperator = ConjugateOperator

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
    "Ones",
    "Zeros",
    "opEye",
    "opOnes",
    "opZeros",
    "DiagonalOperator",
    "opDiagonal",
    "RestrictionOperator",
    "opRestriction",
    "opExtension",
    "HCatOperator",
    "VCatOperator",
    "BlockDiagonalOperator",
    "hcat",
    "vcat",
    "hvcat",
    "ShiftedOperator",
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
    "solve_shifted_system",
    "solve_shifted_systems",
    "ldiv",
    "matvec_chain",
    "cg",
    "gmres",
    "minres",
    "bicgstab",
    "lsqr",
    "chebyshev",
    "power_iteration",
    "KronOperator",
    "kron",
    "InverseOperator",
    "IterativeInverseOperator",
    "CholeskyOperator",
    "LDLOperator",
    "HouseholderOperator",
    "HermitianOperator",
    "opInverse",
    "opIterativeInverse",
    "opCholesky",
    "opLDL",
    "opHouseholder",
    "opHermitian",
    "TimedOperator",
    "TimedLinearOperator",
    "AdjointLinearOperator",
    "TransposeLinearOperator",
    "ConjugateLinearOperator",
    "SparseInverseOperator",
    "opSparseInverse",
    "opSparseLDL",
    "LSR1State",
    "LSR1Operator",
    "DiagonalQNOperator",
    "DiagonalPSB",
    "DiagonalAndrei",
    "SpectralGradient",
    "DiagonalBFGS",
    "DIAOperator",
    "opDIA",
    "dia_from_dense",
    "laplacian_1d",
    "laplacian_2d",
    "laplacian_2d_dia",
    "StencilOperator",
    "Stencil2DOperator",
    "opStencil",
    "opStencil2D",
    "normest",
    "estimate_opnorm",
    "estimate_trace",
    "estimate_diagonal",
    "estimate_spectral_sum",
    "estimate_logdet",
    "funm_apply",
    "lobpcg",
    "svds",
    "rsvd",
    "nystrom_preconditioner",
    "NystromPreconditioner",
    "check_ctranspose",
    "check_hermitian",
    "check_positive_definite",
    "save_operator",
    "load_operator_state",
    "op_state",
]
