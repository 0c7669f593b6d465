"""Special operators: identity, ones and zeros, diagonal, permutation,
restriction and extension, shift, block concatenation, Kronecker products,
the factorization-backed inverses, the timing decorator and the host
sparse factor."""
