"""Sparse storage formats, the sparse operators and ``opSparse``, and the
banded formats: DIA diagonals, grid stencils and the Laplacian builders."""

from .formats import (BSR, COO, CSR, ELL, bsr_from_dense, check_int32_range, coo_from_dense,
                      csr_from_dense, csr_from_parts, ell_from_csr_parts, ell_from_dense)
from .ops import (BSROperator, COOOperator, CSROperator, ELLOperator, RoutedCSROperator,
                  opSparse)
from .reorder import ReorderedOperator
from .dia import (DIAOperator, opDIA, dia_from_dense, laplacian_1d, laplacian_2d,
                  laplacian_2d_dia)
from .stencil import StencilOperator, Stencil2DOperator, opStencil, opStencil2D

__all__ = ["BSR", "COO", "CSR", "ELL", "bsr_from_dense", "check_int32_range", "coo_from_dense",
           "csr_from_dense", "csr_from_parts", "ell_from_csr_parts", "ell_from_dense",
           "BSROperator", "COOOperator", "CSROperator", "ELLOperator", "RoutedCSROperator",
           "ReorderedOperator", "opSparse", "DIAOperator", "opDIA", "dia_from_dense",
           "laplacian_1d", "laplacian_2d", "laplacian_2d_dia", "StencilOperator",
           "Stencil2DOperator", "opStencil", "opStencil2D"]
