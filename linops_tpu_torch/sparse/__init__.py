"""Sparse storage formats, the sparse operators and ``opSparse``."""

from .formats import (BSR, COO, CSR, ELL, bsr_from_dense, check_int32_range, coo_from_dense,
                      csr_from_dense, csr_from_parts, ell_from_csr_parts, ell_from_dense)
from .ops import (BSROperator, COOOperator, CSROperator, ELLOperator, RoutedCSROperator,
                  opSparse)
from .reorder import ReorderedOperator

__all__ = ["BSR", "COO", "CSR", "ELL", "bsr_from_dense", "check_int32_range", "coo_from_dense",
           "csr_from_dense", "csr_from_parts", "ell_from_csr_parts", "ell_from_dense",
           "BSROperator", "COOOperator", "CSROperator", "ELLOperator", "RoutedCSROperator",
           "ReorderedOperator", "opSparse"]
