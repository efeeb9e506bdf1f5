"""High-accuracy CPU QP oracle for tests.

Solves min 1/2 z^T H z + g^T z  s.t.  lb <= A z <= ub in float64 numpy with an
OSQP-style ADMM followed by an active-set "polish" step (solve the equality-
constrained KKT system on the detected active set) — the same strategy OSQP
itself uses to return high-accuracy solutions. Independent of the JAX solver
under test.
"""

import numpy as np
from scipy.linalg import cho_factor, cho_solve


def solve_qp_oracle(H, g, A, lb, ub, rho=0.1, sigma=1e-6, alpha=1.6,
                    iters=4000, polish_tol=1e-6):
    n = H.shape[0]
    m = A.shape[0]
    x = np.zeros(n)
    z = np.zeros(m)
    y = np.zeros(m)

    eq_row = (ub - lb) < 1e-12
    rho_vec = np.where(eq_row, rho * 1e3, rho)

    K = H + sigma * np.eye(n) + A.T @ (rho_vec[:, None] * A)
    K_chol = cho_factor(K, lower=True)

    def ksolve(b):
        return cho_solve(K_chol, b)

    for _ in range(iters):
        rhs = sigma * x - g + A.T @ (rho_vec * z - y)
        x_new = ksolve(rhs)
        Ax = A @ x_new
        z_tilde = alpha * Ax + (1 - alpha) * z
        z_new = np.clip(z_tilde + y / rho_vec, lb, ub)
        y = y + rho_vec * (z_tilde - z_new)
        x, z = x_new, z_new

    # --- polish: iterative active-set refinement (qpOASES-style working-set
    # loop, warm-started from the ADMM point). Each round solves the
    # equality-constrained KKT on the working set, drops wrong-sign
    # multipliers, and adds violated rows, until primal + dual feasible.
    # This pins the solution even along near-flat directions the ADMM
    # leaves loose.
    Ax = A @ x
    low_active = (Ax - lb) < polish_tol * np.maximum(1.0, np.abs(lb))
    up_active = (ub - Ax) < polish_tol * np.maximum(1.0, np.abs(ub))
    best = x
    seen = set()
    for _round in range(300):
        active = (low_active | up_active | eq_row)
        Aa = A[active]
        ba = np.where(up_active[active] & ~eq_row[active], ub[active],
                      lb[active])
        ka = Aa.shape[0]
        KKT = np.block([[H + 1e-12 * np.eye(n), Aa.T],
                        [Aa, -1e-12 * np.eye(ka)]])
        try:
            sol = np.linalg.solve(KKT, np.concatenate([-g, ba]))
        except np.linalg.LinAlgError:
            break
        x_pol, nu = sol[:n], sol[n:]
        Axp = A @ x_pol

        # wrong-sign multipliers (lower-active need nu<=0, upper nu>=0
        # under H x + g + A^T nu = 0)
        act_idx = np.where(active)[0]
        lo_mask = low_active[act_idx] & ~eq_row[act_idx]
        up_mask = up_active[act_idx] & ~eq_row[act_idx]
        wrong_lo = lo_mask & (nu > 1e-9)
        wrong_up = up_mask & (nu < -1e-9)
        # violated inactive rows
        viol_lo = (lb - Axp) > 1e-9 * np.maximum(1.0, np.abs(lb))
        viol_up = (Axp - ub) > 1e-9 * np.maximum(1.0, np.abs(ub))
        viol_lo &= ~active
        viol_up &= ~active

        if not (wrong_lo.any() or wrong_up.any()
                or viol_lo.any() or viol_up.any()):
            return x_pol
        best = x_pol
        # drop wrong-sign rows (all at once while making progress; fall back
        # to one-at-a-time if the working set starts cycling), add all
        # violated rows
        key = (low_active.tobytes(), up_active.tobytes())
        cycling = key in seen
        seen.add(key)
        if wrong_lo.any() or wrong_up.any():
            if cycling:
                scores = (np.where(wrong_lo, nu, 0.0)
                          - np.where(wrong_up, nu, 0.0))
                worst = act_idx[np.argmax(scores)]
                low_active[worst] = False
                up_active[worst] = False
            else:
                drop = act_idx[wrong_lo | wrong_up]
                low_active[drop] = False
                up_active[drop] = False
        low_active |= viol_lo
        up_active |= viol_up
    return best
