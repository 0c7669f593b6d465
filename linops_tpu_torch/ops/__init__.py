"""Special operators: identity and diagonal."""
