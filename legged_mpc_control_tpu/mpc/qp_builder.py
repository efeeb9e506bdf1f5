"""Condensed-horizon convex MPC QP construction.

The reference hands OSQP a sparse QP over `[u_0, x_1, u_1, ..., x_H]` with 360
dynamics equalities (reference: ConvexQPSolver.cpp:60-128, 286-305). Here we
eliminate the states instead: substituting

    X_k := x_{k+1} = Ad_k X_{k-1} + Bd_k u_k + d,      X_{-1} = x0
    d = [0...0, -g*dt]                      (reference: :175-177, 294-297)

into the tracking cost yields a *dense* QP in U = [u_0..u_{H-1}] in R^{12H}:

    min_U  1/2 U^T P U + q^T U
    s.t.   per (step k, leg l):  friction pyramid + normal-force box
           (block-separable 6 rows over that leg's 3 forces)

    P = S^T Qbar S + Rbar,   q = S^T Qbar (c - Xref)
    S[k,j] = Ad_k ... Ad_{j+1} Bd_j  (block lower-triangular)
    c_k    = prefix rollout of x0 under Ad_k and d

This is exactly the reference QP after exact elimination of its equality
constraints — same optimum — but every operation is a batched matmul, and the
inequality structure stays block-diagonal for the interior-point solver
(pdip.py).

Contact gating: the reference zeroes the normal-force upper bound for swing
legs (fz in [0, 0], reference: :329-346), which forces the swing-leg force to
exactly 0 (friction rows then pin fx=fy=0). We realize the same optimum by
masking those legs' columns out of Bd per step — their forces decouple, carry
only the R-penalty, and solve to exactly 0 — avoiding the empty-interior box
that would break an interior-point method.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Default-precision f32 matmuls may run at reduced precision (TF32 on the
# GPU's tensor cores, ~1e-3 relative error). That error is larger than this
# QP's R-regularization eigenvalues
# (r_weights ~ 1e-4), so a default-precision P = S^T Q S comes out
# *indefinite* and downstream Cholesky factorizations fail. Every
# P/q-forming contraction below runs at HIGHEST (full f32) precision —
# these are (12H)^3 ~ 1.7 MFLOP GEMMs, bandwidth-bound either way.
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

from legged_mpc_control_tpu.constants import (
    DIM_GRF,
    GRAVITY,
    MPC_STATE_DIM,
    NUM_LEG,
)


class CondensedQP(NamedTuple):
    """Dense condensed QP + separable constraint data."""
    P: jnp.ndarray          # (12H, 12H) Hessian (PSD)
    q: jnp.ndarray          # (12H,)
    contact: jnp.ndarray    # (H, 4) contact schedule in {0., 1.}
    mu: jnp.ndarray         # friction coefficient (scalar)
    fz_max: jnp.ndarray     # normal force cap (scalar)


def build_condensed_qp(x0, x_ref, A_seq, B, contact, q_weights, r_weights,
                       mu, fz_max, dt):
    """Build the condensed QP.

    Args:
      x0:       (12,) current state [rpy, pos, omega, v].
      x_ref:    (H, 12) reference states; x_{k+1} tracks x_ref[k]
                (reference: ConvexQPSolver.cpp:262-276, 308).
      A_seq:    (H, 12, 12) discrete A per step (yaw-linearized).
      B:        (12, 12) discrete B (current foot positions; the reference
                uses the same B for all steps, ConvexQPSolver.cpp:280-283).
      contact:  (H, 4) contact schedule, {0,1}.
      q_weights,(12,) / r_weights (12,): diagonal costs.
      mu, fz_max: friction / force cap scalars.
      dt: MPC step (for the gravity affine term).

    Returns CondensedQP.
    """
    H = x_ref.shape[0]
    dtype = x_ref.dtype

    # --- closed-form transition products (no scan) ---
    # Ad_k = I + dt*C_k with C_k having exactly two blocks:
    #   C[0:3, 6:9] = M(yaw_k)  and  C[3:6, 9:12] = I.
    # C_k maps the (omega, v) half into the (rpy, pos) half, so C_k C_j = 0
    # and every product collapses:
    #   Phi_{k,j} = Ad_k ... Ad_{j+1} = I + dt * sum_{m=j+1..k} C_m.
    # Everything below is elementwise math + two big GEMMs — the scan the
    # reference's sparse solver implies (and our first version used) would
    # serialize H tiny matmuls on the MXU instead.
    M_seq = A_seq[:, 0:3, 6:9] / dt                       # (H,3,3) yaw maps
    Mcum = jnp.cumsum(M_seq, axis=0)                      # sum_{m<=k} M_m

    # per-step B with swing-leg columns masked; split into its two
    # nonzero row bands
    leg_mask = jnp.repeat(contact, 3, axis=-1)            # (H,12)
    Bt = B[6:9, :][None] * leg_mask[:, None, :]           # (H,3,12) torque
    Bf = B[9:12, :][None] * leg_mask[:, None, :]          # (H,3,12) force

    # S[k,j] = Phi_{k,j} B_j for j<=k:
    #   rows 0:3  = dt * (Mcum[k] - Mcum[j]) @ Bt[j]
    #   rows 3:6  = dt * (k - j) * Bf[j]
    #   rows 6:9  = Bt[j]
    #   rows 9:12 = Bf[j]
    U = _einsum("kab,jbc->kjac", Mcum, Bt)             # (H,H,3,12)
    V = _einsum("jab,jbc->jac", Mcum, Bt)              # (H,3,12)
    ks = jnp.arange(H, dtype=dtype)
    kmj = ks[:, None] - ks[None, :]                       # (H,H)
    tril = (kmj >= 0).astype(dtype)[:, :, None, None]

    rows03 = dt * (U - V[None, :, :, :])
    rows36 = dt * kmj[:, :, None, None] * Bf[None]
    rows69 = jnp.broadcast_to(Bt[None], (H, H, 3, DIM_GRF))
    rows912 = jnp.broadcast_to(Bf[None], (H, H, 3, DIM_GRF))
    S = jnp.concatenate([rows03, rows36, rows69, rows912], axis=2) * tril

    # --- closed-form free evolution c_k (gravity + initial state) ---
    # y0 = Ad_0 x0;  c_k = Phi'_{k} y0 + (k+1) d - g dt^2 k(k+1)/2 e5
    # with Phi'_k = I + dt sum_{m=1..k} C_m.
    y0 = A_seq[0] @ x0
    Msum1k = Mcum - Mcum[0][None]                         # sum_{m=1..k}
    c = jnp.broadcast_to(y0, (H, MPC_STATE_DIM))
    c = c.at[:, 0:3].add(dt * _einsum("kab,b->ka", Msum1k, y0[6:9]))
    c = c.at[:, 3:6].add(dt * ks[:, None] * y0[9:12][None])
    g_dt = GRAVITY * dt
    c = c.at[:, 11].add(-(ks + 1.0) * g_dt)
    c = c.at[:, 5].add(-g_dt * dt * ks * (ks + 1.0) / 2.0)

    # flatten to (12H, 12H): rows are states (k), cols are inputs (j)
    Sm = S.transpose(0, 2, 1, 3).reshape(H * MPC_STATE_DIM, H * DIM_GRF)

    qbar = jnp.tile(q_weights, H)                         # (12H,)
    rbar = jnp.tile(r_weights, H)

    SQ = Sm * qbar[:, None]
    P = _einsum("ki,kj->ij", Sm, SQ) + jnp.diag(rbar)
    # enforce exact symmetry (the contraction is symmetric only up to
    # rounding; Cholesky-based solvers read both triangles)
    P = 0.5 * (P + P.T)
    resid = (c - x_ref).reshape(-1)                       # (12H,)
    q = _einsum("ki,k->i", SQ, resid)

    return CondensedQP(P=P, q=q, contact=contact,
                       mu=jnp.asarray(mu, dtype),
                       fz_max=jnp.asarray(fz_max, dtype))


def reference_sparse_qp(x0, x_ref, A_seq, B, contact, q_weights, r_weights,
                        mu, fz_max, dt):
    """Reproduce the reference's *sparse* QP (decision vars
    [u_0, x_1, u_1, ..., x_H]) as dense numpy-style arrays.

    Used by tests as the oracle formulation: identical to
    reference: ConvexQPSolver.cpp:33-196, including the degenerate
    fz in [0, 0*fz_max] swing boxes. Returns (Hs, g, Ac, lb, ub) for
    min 1/2 z^T Hs z + g^T z  s.t.  lb <= Ac z <= ub.
    """
    import numpy as np

    H = int(x_ref.shape[0])
    n = (MPC_STATE_DIM + DIM_GRF) * H
    x0 = np.asarray(x0, dtype=np.float64)
    x_ref = np.asarray(x_ref, dtype=np.float64)
    A_seq = np.asarray(A_seq, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    contact = np.asarray(contact, dtype=np.float64)
    qw = np.asarray(q_weights, dtype=np.float64)
    rw = np.asarray(r_weights, dtype=np.float64)
    mu = float(mu)
    fz_max = float(fz_max)

    def u_off(k):
        return k * (MPC_STATE_DIM + DIM_GRF)

    def x_off(k):            # x_{k+1}
        return k * (MPC_STATE_DIM + DIM_GRF) + DIM_GRF

    # Hessian: alternating R, Q diagonal (reference: :33-50)
    hdiag = np.zeros(n)
    for k in range(H):
        hdiag[u_off(k):u_off(k) + DIM_GRF] = rw
        hdiag[x_off(k):x_off(k) + MPC_STATE_DIM] = qw
    Hs = np.diag(hdiag)

    # gradient: -Q x_ref[k] at x_{k+1} (reference: :308)
    g = np.zeros(n)
    for k in range(H):
        g[x_off(k):x_off(k) + MPC_STATE_DIM] = -qw * x_ref[k]

    n_dyn = MPC_STATE_DIM * H
    n_fr = 4 * NUM_LEG * H
    n_box = NUM_LEG * H
    Ac = np.zeros((n_dyn + n_fr + n_box, n))
    lb = np.zeros(n_dyn + n_fr + n_box)
    ub = np.zeros(n_dyn + n_fr + n_box)

    grav = GRAVITY * float(dt)
    for k in range(H):
        r = k * MPC_STATE_DIM
        Ac[r:r + 12, u_off(k):u_off(k) + 12] = B
        Ac[r:r + 12, x_off(k):x_off(k) + 12] = -np.eye(12)
        if k == 0:
            rhs = -A_seq[0] @ x0
            rhs[11] += grav
            lb[r:r + 12] = rhs
            ub[r:r + 12] = rhs
        else:
            Ac[r:r + 12, x_off(k - 1):x_off(k - 1) + 12] = A_seq[k]
            lb[r + 11] = grav
            ub[r + 11] = grav

    INF = 1e20
    for k in range(H):
        for l in range(NUM_LEG):
            r = n_dyn + 16 * k + 4 * l
            cx = u_off(k) + 3 * l
            Ac[r + 0, cx] = 1; Ac[r + 0, cx + 2] = mu
            Ac[r + 1, cx] = 1; Ac[r + 1, cx + 2] = -mu
            Ac[r + 2, cx + 1] = 1; Ac[r + 2, cx + 2] = mu
            Ac[r + 3, cx + 1] = 1; Ac[r + 3, cx + 2] = -mu
            lb[r + 0], ub[r + 0] = 0.0, INF
            lb[r + 1], ub[r + 1] = -INF, 0.0
            lb[r + 2], ub[r + 2] = 0.0, INF
            lb[r + 3], ub[r + 3] = -INF, 0.0

            rb = n_dyn + n_fr + NUM_LEG * k + l
            Ac[rb, cx + 2] = 1.0
            lb[rb] = 0.0
            ub[rb] = contact[k, l] * fz_max

    return Hs, g, Ac, lb, ub
