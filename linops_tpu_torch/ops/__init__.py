"""Special operators: identity, ones and zeros, diagonal, permutation,
restriction and extension, shift, and block concatenation."""
