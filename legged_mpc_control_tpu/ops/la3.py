"""Closed-form 3x3 linear algebra (adjugate/Cramer), batched.

The closed loop solves thousands of tiny 3x3 systems per substep (leg
Jacobian maps, inertia solves) under `vmap`. `jnp.linalg.solve`/`inv` lower
these to batched LU library calls, a batched-tiny regime orders of
magnitude slower than arithmetic. A 3x3 adjugate is 27 multiplies of
elementwise tensors that XLA fuses straight into the surrounding
computation.

All functions take (..., 3, 3) and broadcast over leading axes.
"""

import jax.numpy as jnp


def det3(A):
    """Determinant of (..., 3, 3)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def adj3(A):
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1),
    ], axis=-2)


def inv3(A):
    """Inverse of (..., 3, 3)."""
    return adj3(A) / det3(A)[..., None, None]


def solve3(A, b):
    """Solve A x = b: A (..., 3, 3); b (..., 3) [vector] or
    (..., 3, k) [matrix RHS, same ndim as A]."""
    adj = adj3(A)
    d = det3(A)
    if b.ndim == A.ndim:                  # matrix RHS (..., 3, k)
        return jnp.einsum("...ij,...jk->...ik", adj, b) / d[..., None, None]
    return jnp.einsum("...ij,...j->...i", adj, b) / d[..., None]


def solve3_t(A, b):
    """Solve A^T x = b (the J^-T force maps): same cost, no transpose op."""
    adj = adj3(A)
    d = det3(A)
    if b.ndim == A.ndim:
        return jnp.einsum("...ji,...jk->...ik", adj, b) / d[..., None, None]
    return jnp.einsum("...ji,...j->...i", adj, b) / d[..., None]
