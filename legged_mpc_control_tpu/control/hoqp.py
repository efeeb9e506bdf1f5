"""Hierarchical QP with inequality tiers — the HoQp equivalent.

Re-design of the reference's recursive null-space hierarchy
(reference: src/legged_ctrl/src/wbc_ctrl/HoQp.cpp:147-174, itself after
bernhardpg/quadruped_locomotion). Each priority level solves

    min_{z, v}  || A_k (x_prev + Z_prev z) - b_k ||^2 + || v ||^2
    s.t.        v >= 0
                D_j (x_prev + Z_prev z) <= f_j + v_j*   for j < k (relaxed
                                                         by their optimal
                                                         slacks v_j*)
                D_k (x_prev + Z_prev z) - v <= f_k

then descends into the null space of A_k Z_prev. The reference solves each
level with qpOASES active sets (HoQp.cpp:158-174) and extracts the null
basis with a rank-revealing LU kernel (HoQp.cpp:150); both are data-dependent
control flow. Here:

  * each level is a fixed-iteration infeasible-start Mehrotra interior-point
    solve (`solve_ineq_qp`) — branchless, jittable, batchable with `vmap`;
  * the null basis keeps a FIXED width n with soft rank masking: an SVD
    zeroes the non-null columns instead of dropping them, so varying contact
    configurations (rank changes) never change shapes;
  * contact-dependent task rows are zeroed by masks rather than removed
    (the reference rebuilds row counts per contact mode, wbc.cpp:137-175).

All levels keep static shapes, so the whole hierarchy jits once and vmaps
over scenario batches.
"""

from functools import partial as _partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class HoTask(NamedTuple):
    """One priority level. Inactive (contact-masked) rows must be zeroed
    (A row AND b; D row AND f) — a zero row is trivially satisfied."""
    A: jnp.ndarray               # (ka, n) equality rows, or (0, n)
    b: jnp.ndarray               # (ka,)
    D: jnp.ndarray               # (kd, n) inequality rows D x <= f, or (0, n)
    f: jnp.ndarray               # (kd,)


def solve_ineq_qp(Hm, c, D, f, *, iters=20, tol=None, x0=None):
    """min 1/2 x^T H x + c^T x  s.t.  D x <= f  (dense, small).

    Infeasible-start Mehrotra predictor-corrector, fixed iteration count,
    converged/non-finite iterates freeze via masking — the same scheme as
    mpc/pdip.py but with a general dense constraint matrix. H must be PSD
    (callers add Tikhonov damping). Fully jittable; vmap over batches.

    Returns x (n,).
    """
    n = Hm.shape[-1]
    m = D.shape[0]
    dtype = Hm.dtype
    if tol is None:
        tol = 1e-11 if dtype == jnp.float64 else 1e-6
    d_max = 1e14 if dtype == jnp.float64 else 1e6
    reg = 1e-11 if dtype == jnp.float64 else 1e-6
    eps = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-20, dtype)

    x = jnp.zeros((n,), dtype=dtype) if x0 is None else x0
    s = jnp.maximum(f - D @ x, 1.0)
    lam = jnp.ones((m,), dtype=dtype)

    def newton_solve(L, rhs):
        y = solve_triangular(L, rhs, lower=True)
        return solve_triangular(L.T, y, lower=False)

    def body(carry, _):
        x, s, lam, done = carry
        r_dual = Hm @ x + c + D.T @ lam
        r_prim = D @ x + s - f
        mu_gap = jnp.sum(s * lam) / m

        d = jnp.clip(lam / jnp.maximum(s, eps), 0.0, d_max)
        K = Hm + _einsum("ri,r,rj->ij", D, d, D)
        K = K + jnp.eye(n, dtype=dtype) * reg
        L = jnp.linalg.cholesky(K)

        def solve_dir(rc):
            w = (lam * r_prim - rc) / jnp.maximum(s, eps)
            dx = newton_solve(L, -(r_dual + D.T @ w))
            ds = -(r_prim + D @ dx)
            dlam = -(rc + lam * ds) / jnp.maximum(s, eps)
            return dx, ds, dlam

        dx_a, ds_a, dl_a = solve_dir(lam * s)

        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio))

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = jnp.sum((s + a_p * ds_a) * (lam + a_d * dl_a)) / m
        sigma = jnp.clip((mu_aff / jnp.maximum(mu_gap, eps)) ** 3,
                         1e-4, 0.9)
        corr = jnp.clip(ds_a * dl_a, -10.0 * mu_gap, 10.0 * mu_gap)
        dx, ds, dlam = solve_dir(lam * s + corr - sigma * mu_gap)

        a_p = 0.99 * max_step(s, ds)
        a_d = 0.99 * max_step(lam, dlam)

        conv = (mu_gap < tol) & (jnp.max(jnp.abs(r_prim)) < 1e3 * tol)
        bad = ~(jnp.all(jnp.isfinite(dx)) & jnp.all(jnp.isfinite(ds))
                & jnp.all(jnp.isfinite(dlam)))
        done = done | conv | bad
        x2 = jnp.where(done, x, x + a_p * dx)
        s2 = jnp.where(done, s, s + a_p * ds)
        lam2 = jnp.where(done, lam, lam + a_d * dlam)
        return (x2, s2, lam2, done), None

    done0 = jnp.zeros((), dtype=bool)
    (x, s, lam, done), _ = jax.lax.scan(
        body, (x, s, lam, done0), None, length=iters)
    return x


def soft_nullspace(A, tol=1e-8):
    """Fixed-width null basis of A: (n, n) with non-null columns zeroed.

    Right singular vectors whose singular value is below tol*s_max (or that
    have no singular value at all, n > rows) span the null space; the rest
    are zeroed instead of dropped so downstream shapes stay static across
    contact-dependent rank changes (reference HoQp.cpp:150 uses a
    rank-revealing LU kernel with dynamic width)."""
    n = A.shape[1]
    k = A.shape[0]
    _, s, vt = jnp.linalg.svd(A, full_matrices=True)
    smax = jnp.maximum(1.0, s[0])
    mask = jnp.concatenate([
        (s < tol * smax).astype(A.dtype),
        jnp.ones((n - min(k, n),), dtype=A.dtype)])
    return vt.T * mask[None, :]


def hoqp_solve(tasks: Sequence[HoTask], n: int, *, iters=20, damping=1e-9):
    """Resolve the full priority hierarchy. Returns the decision vector x.

    tasks are ordered highest priority first (the reference builds
    HoQp(task_2, HoQp(task_1, HoQp(task_0))) inside-out, wbc.cpp:99-102).
    """
    dtype = tasks[0].A.dtype
    x = jnp.zeros((n,), dtype=dtype)
    Z = jnp.eye(n, dtype=dtype)
    stacked: list = []            # [(D_j, f_j + v_j*)] from solved levels

    for t in tasks:
        ka, kd = t.A.shape[0], t.D.shape[0]
        M = t.A @ Z                                         # (ka, n)

        # objective over (z, v): ||M z - (b - A x)||^2 + ||v||^2
        H_zz = M.T @ M + damping * jnp.eye(n, dtype=dtype)
        c_z = M.T @ (t.A @ x - t.b)

        # inequality rows over (z, v)
        rows_D, rows_V, rhs = [], [], []
        if kd:
            rows_D.append(jnp.zeros((kd, n), dtype=dtype))   # -v <= 0
            rows_V.append(-jnp.eye(kd, dtype=dtype))
            rhs.append(jnp.zeros((kd,), dtype=dtype))
        for Dj, fj in stacked:                               # prev, relaxed
            rows_D.append(Dj @ Z)
            rows_V.append(jnp.zeros((Dj.shape[0], kd), dtype=dtype))
            rhs.append(fj - Dj @ x)
        if kd:
            rows_D.append(t.D @ Z)                           # D x - v <= f
            rows_V.append(-jnp.eye(kd, dtype=dtype))
            rhs.append(t.f - t.D @ x)

        if rows_D:
            Dhat = jnp.concatenate(
                [jnp.concatenate([rd, rv], axis=1)
                 for rd, rv in zip(rows_D, rows_V)], axis=0)
            fhat = jnp.concatenate(rhs)
            Hm = jnp.zeros((n + kd, n + kd), dtype=dtype)
            Hm = Hm.at[:n, :n].set(H_zz)
            if kd:
                Hm = Hm.at[n:, n:].set(jnp.eye(kd, dtype=dtype))
            c = jnp.concatenate([c_z, jnp.zeros((kd,), dtype=dtype)])
            sol = solve_ineq_qp(Hm, c, Dhat, fhat, iters=iters)
            z, v = sol[:n], sol[n:]
        else:
            # pure equality level with no inherited inequalities: closed form
            z = jnp.linalg.solve(H_zz, -c_z)
            v = jnp.zeros((0,), dtype=dtype)

        x = x + Z @ z
        if kd:
            stacked.append((t.D, t.f + v))
        if ka:
            Z = Z @ soft_nullspace(M)

    return x
