"""Block-sparse storage and the BSR operator."""

from .formats import BSR, bsr_from_dense
from .ops import BSROperator

__all__ = ["BSR", "bsr_from_dense", "BSROperator"]
