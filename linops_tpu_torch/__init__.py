"""linops_tpu_torch: the PyTorch/CUDA port of linops_tpu, slices 1 to 4.

Matrix-free linear operators in PyTorch: a lazy operator graph (scale, sum,
compose, adjoint wrappers over dense, function, identity, ones, zeros,
diagonal, permutation, restriction/extension, shifted and sparse operators:
COO, CSR, ELL, block-sparse rows and the Clos-routed CSR for unstructured
patterns, built by ``opSparse``, with an RCM reordering), block
concatenation (``hcat``, ``vcat``, ``hvcat``, block diagonal) and slicing
(``op[rows, cols]``), compact L-BFGS operators with shifted solves, and the
Krylov solvers (``cg`` for one or several right-hand sides, ``gmres``,
``minres``, ``bicgstab``, ``lsqr``, ``chebyshev``, ``power_iteration``).
The block-sparse products run hand-written CUDA kernels for Hopper
(``kernels/csrc/``: K1/K2, the windowed K3-K6 for large x) and the routed
ones the lane-gather kernels K7-K14, on CUDA tensors; CPU tensors take their
plain PyTorch versions. Factories build on the CUDA device unless given
``device="cpu"``.

Names follow ``linops_tpu`` so each module has an obvious counterpart; this
package imports ``torch`` and numpy, never ``jax``. Of the reference's
``__all__`` these are still missing: ``apply_cache_sizes`` (no jit cache to
count) and ``apply_linear``; ``KronOperator``/``kron``; the ``linalg_ops``
operators (``opInverse``, ``opIterativeInverse``, ``opCholesky``, ``opLDL``,
``opHouseholder``, ``opHermitian`` and their classes); ``TimedOperator``;
the sparse factor operators (``opSparseInverse``, ``opSparseLDL``,
``SparseInverseOperator``); ``LSR1State``/``LSR1Operator`` and the diagonal
quasi-Newton operators; the DIA and stencil operators and the
``laplacian_*`` builders; ``normest``, ``estimate_*`` and ``funm_apply``;
``lobpcg``, ``svds``, ``rsvd`` and the Nyström preconditioner;
``save_operator``, ``load_operator_state`` and ``op_state``; the property
checks ``check_*``; and the reference-name aliases ``*LinearOperator``.
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
]
