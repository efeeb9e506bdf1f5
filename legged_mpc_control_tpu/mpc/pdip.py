"""Batched primal-dual interior-point solver for the condensed MPC QP.

Replaces the reference's OSQP/ADMM solve (reference: ConvexQPSolver.cpp:
182-194, 314-327) with a Mehrotra predictor-corrector interior-point method
designed for batched accelerator execution:

  * fixed iteration count — no data-dependent control flow under `jit`;
    converged batch elements take frozen (zero) steps via masking;
  * the inequality Jacobian G is never materialized: the 6 constraint rows
    per (step, leg) touch only that leg's 3 forces, so G@u, G^T@w and the
    Newton contribution G^T D G (block-diagonal 3x3) are computed
    arithmetically on (H, 4, ...) tensors;
  * one Cholesky factorization of (P + G^T D G) per iteration, two
    triangular-solve pairs (predictor + corrector) — all batched over
    scenarios, mapping to batched GEMM / batched Cholesky.

Constraint rows per (step k, leg l), forces u = (fx, fy, fz):
    -fx - mu fz <= 0            (reference friction pyramid,
     fx - mu fz <= 0             ConvexQPSolver.cpp:130-158)
    -fy - mu fz <= 0
     fy - mu fz <= 0
     fz         <= fz_max       (box, :160-177; contact gating is done by
    -fz         <= 0             masking B columns — see qp_builder.py)
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# full-f32 contractions: a reduced-precision f32 matmul (TF32 on the GPU's
# tensor cores, ~1e-3 relative) injects more error into the Newton
# residuals than the QP's R-regularization scale (see qp_builder.py)
from functools import partial as _partial
_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

N_CON_PER_LEG = 6


class PdipResult(NamedTuple):
    u: jnp.ndarray            # (12H,) optimal GRFs over the horizon
    gap: jnp.ndarray          # final average complementarity gap
    r_dual: jnp.ndarray       # final dual residual inf-norm
    iters: jnp.ndarray        # iterations actually used (<= max_iter)


# The per-leg constraint matrix decomposes as G(mu) = GA + mu * GB with
# constant GA/GB — rows are the 4 friction pyramid faces, fz cap, and -fz.
# (Expressed via dense constants so G, G^T and G^T D G all lower to einsums
# plus a broadcast multiply-add, which XLA fuses into their consumers. The
# decomposition also admits per-scenario mu, which the domain-randomized
# runner needs.)
_GA = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
       (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_GB = ((0.0, 0.0, -1.0),) * 4 + ((0.0, 0.0, 0.0),) * 2


def _bmu(mu, out_ndim, dtype):
    """Reshape scalar or (B,) mu to broadcast against an out_ndim tensor."""
    mu = jnp.asarray(mu, dtype)
    return mu.reshape(mu.shape + (1,) * (out_ndim - mu.ndim))


def _g_local(mu, dtype):
    """G(mu) per leg: shape mu.shape + (6, 3). mu scalar or (B,)."""
    mu = jnp.asarray(mu, dtype)
    return (jnp.array(_GA, dtype)
            + mu[..., None, None] * jnp.array(_GB, dtype))


def _g_apply(u_legs, mu):
    """G @ u. u_legs: (..., H, 4, 3) -> (..., H, 4, 6). mu scalar or (B,)."""
    dtype = u_legs.dtype
    a = _einsum("...i,ri->...r", u_legs, jnp.array(_GA, dtype))
    b = _einsum("...i,ri->...r", u_legs, jnp.array(_GB, dtype))
    return a + _bmu(mu, a.ndim, dtype) * b


def _gt_apply(w, mu):
    """G^T @ w. w: (..., H, 4, 6) -> (..., H, 4, 3). mu scalar or (B,)."""
    dtype = w.dtype
    a = _einsum("...r,ri->...i", w, jnp.array(_GA, dtype))
    b = _einsum("...r,ri->...i", w, jnp.array(_GB, dtype))
    return a + _bmu(mu, a.ndim, dtype) * b


def _gtdg_blocks(d, mu):
    """3x3 blocks of G^T diag(d) G per (step, leg).
    d: (..., H, 4, 6) -> (..., H, 4, 3, 3). mu scalar or (B,).

    G^T D G = A^T D A + mu (A^T D B + B^T D A) + mu^2 B^T D B."""
    dtype = d.dtype
    GA, GB = jnp.array(_GA, dtype), jnp.array(_GB, dtype)
    aa = _einsum("...r,ri,rj->...ij", d, GA, GA)
    ab = _einsum("...r,ri,rj->...ij", d, GA, GB)
    bb = _einsum("...r,ri,rj->...ij", d, GB, GB)
    m = _bmu(mu, aa.ndim, dtype)
    return aa + m * (ab + jnp.swapaxes(ab, -1, -2)) + m * m * bb


def _h_vec(H, fz_max, dtype):
    """RHS h of G u <= h: fz_max.shape + (H, 4, 6). The fz cap stays fz_max
    for all legs; swing-leg forces are already forced to zero by B-masking +
    R-penalty. fz_max scalar or (B,)."""
    fz = jnp.asarray(fz_max, dtype)
    e_cap = jnp.zeros((6,), dtype=dtype).at[4].set(1.0)
    return fz[..., None, None, None] * jnp.broadcast_to(e_cap, (H, 4, 6))


def solve_qp_pdip(P, q, mu, fz_max, *, contact=None, iters=18, tol=None):
    """Solve min 1/2 u^T P u + q^T u s.t. friction/box constraints.

    Args:
      P: (12H, 12H) PSD Hessian. q: (12H,).
      mu, fz_max: scalars.
      iters: fixed Mehrotra iteration count (static; converged elements
             freeze, so a generous count is safe).
      tol: complementarity-gap freeze threshold. Defaults to 1e-11 in f64 /
           1e-6 in f32. Once an element's gap, dual and primal residuals all
           drop below tol its iterates freeze — this both saves the central
           path from post-convergence blow-up (lambda/s -> inf) and keeps
           the whole solve branchless.

    Returns PdipResult. Fully jittable; vmap over leading batch via jax.vmap.
    """
    n = P.shape[-1]
    H = n // 12
    dtype = P.dtype
    m = H * 4 * N_CON_PER_LEG
    if tol is None:
        tol = 1e-11 if dtype == jnp.float64 else 1e-6
    # cap on the IP scaling d = lambda/s: bounds cond(K) so the Cholesky
    # stays finite even if an element runs past its freeze point. In f32
    # the Newton system must stay well inside eps^-1 ~ 1e7 or the
    # factorization produces non-finite pivots.
    d_max = 1e14 if dtype == jnp.float64 else 1e6
    reg = 1e-11 if dtype == jnp.float64 else 1e-6

    h = _h_vec(H, fz_max, dtype)

    def Gdot(u):
        return _g_apply(u.reshape(H, 4, 3), mu)

    def GTdot(w):
        return _gt_apply(w, mu).reshape(n)

    # --- initialization ---
    u = jnp.zeros((n,), dtype=dtype)
    s = jnp.maximum(h - Gdot(u), 1.0)
    lam = jnp.ones_like(s)

    eps = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-20, dtype)

    def newton_solve(L, rhs):
        x = solve_triangular(L, rhs, lower=True)
        return solve_triangular(L.T, x, lower=False)

    def body(carry, _):
        u, s, lam, done = carry

        r_dual = _einsum("ij,j->i", P, u) + q + GTdot(lam)
        r_prim = Gdot(u) + s - h                         # (H,4,6)
        mu_gap = jnp.sum(s * lam) / m

        d = jnp.clip(lam / jnp.maximum(s, eps), 0.0, d_max)   # (H,4,6)
        K = P + _block_diag_add(_gtdg_blocks(d, mu), n, dtype)
        # regularize for factorization robustness
        K = K + jnp.eye(n, dtype=dtype) * reg
        L = jnp.linalg.cholesky(K)

        def solve_dir(rc):
            """Newton direction for complementarity residual rc."""
            w = (lam * r_prim - rc) / jnp.maximum(s, eps)
            rhs = -(r_dual + GTdot(w))
            du = newton_solve(L, rhs)
            ds = -(r_prim + Gdot(du))
            dlam = -(rc + lam * ds) / jnp.maximum(s, eps)
            return du, ds, dlam

        # predictor (affine)
        rc_aff = lam * s
        du_a, ds_a, dl_a = solve_dir(rc_aff)

        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio))

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = jnp.sum((s + a_p * ds_a) * (lam + a_d * dl_a)) / m
        sigma = (mu_aff / jnp.maximum(mu_gap, eps)) ** 3
        sigma = jnp.clip(sigma, 1e-4, 0.9)

        # corrector, with the standard clamp on the cross term so a wild
        # affine direction cannot destroy the centrality target
        corr = jnp.clip(ds_a * dl_a, -10.0 * mu_gap, 10.0 * mu_gap)
        rc = lam * s + corr - sigma * mu_gap
        du, ds, dlam = solve_dir(rc)

        a_p = 0.99 * max_step(s, ds)
        a_d = 0.99 * max_step(lam, dlam)

        # freeze converged elements via where (not step-scaling: a frozen
        # element may carry NaN directions from an exhausted central path,
        # and 0 * NaN = NaN)
        conv = (mu_gap < tol) & (jnp.max(jnp.abs(r_prim)) < 1e3 * tol)
        # non-finite directions (f32 central-path exhaustion past the
        # freeze threshold): keep the last good iterate
        bad = ~(jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(ds))
                & jnp.all(jnp.isfinite(dlam)))
        done = done | conv | bad
        u2 = jnp.where(done, u, u + a_p * du)
        s2 = jnp.where(done, s, s + a_p * ds)
        lam2 = jnp.where(done, lam, lam + a_d * dlam)
        return (u2, s2, lam2, done), None

    done0 = jnp.zeros((), dtype=bool)
    (u, s, lam, done), _ = jax.lax.scan(
        body, (u, s, lam, done0), None, length=iters)

    if contact is not None:
        # Swing-leg forces are exactly zero at the optimum (their columns
        # were masked out of the dynamics and only the tiny R penalty acts
        # on them), but with r ~ 1e-4 the interior point leaves an
        # O(sqrt(gap)/r) residue on them. Zeroing them is exact.
        u = u * jnp.repeat(contact.reshape(H, 4), 3, axis=-1).reshape(n)

    gap = jnp.sum(s * lam) / m
    r_dual = jnp.max(jnp.abs(_einsum("ij,j->i", P, u) + q + GTdot(lam)))
    return PdipResult(u=u, gap=gap, r_dual=r_dual,
                      iters=jnp.asarray(iters))


def solve_qp_pdip_batched(P, q, mu, fz_max, contact, *, iters=18, tol=None,
                          warm_u=None):
    """Explicitly-batched PDIP: P (B,n,n), q (B,n), contact (B,H,4).

    Same algorithm as `solve_qp_pdip` but with the scenario batch as a real
    axis, so each iteration's B Newton systems factorize in one batched
    Cholesky call.

    warm_u: optional (B, n) previous-tick solution (shift it with
    riccati.warm_shift first) — primal warm start with recentered interior
    duals, the cross-tick reuse the reference gets from OSQP's
    setWarmStart(true) (reference: ConvexQPSolver.cpp:185).

    Returns PdipResult with batched fields.
    """
    B, n = q.shape
    H = n // 12
    dtype = P.dtype
    m = H * 4 * N_CON_PER_LEG
    if tol is None:
        tol = 1e-11 if dtype == jnp.float64 else 1e-6
    d_max = 1e14 if dtype == jnp.float64 else 1e6
    reg = 1e-11 if dtype == jnp.float64 else 1e-6
    eps = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-20, dtype)

    # h broadcasts over the batch; with per-scenario fz_max it is (B,H,4,6)
    h = jnp.broadcast_to(_h_vec(H, fz_max, dtype), (B, H, 4, 6))

    def Gdot(u):
        return _g_apply(u.reshape(B, H, 4, 3), mu)

    def GTdot(w):
        return _gt_apply(w, mu).reshape(B, n)

    if warm_u is None:
        u = jnp.zeros((B, n), dtype=dtype)
        s = jnp.maximum(h - Gdot(u), 1.0)
        lam = jnp.ones_like(s)
    else:
        u = warm_u
        s = jnp.maximum(h - Gdot(u), 0.1)
        lam = jnp.clip(1.0 / s, 1e-3, 1e2)

    def body(carry, _):
        u, s, lam, done = carry
        r_dual = _einsum("bij,bj->bi", P, u) + q + GTdot(lam)
        r_prim = Gdot(u) + s - h
        mu_gap = jnp.sum(s * lam, axis=(1, 2, 3)) / m       # (B,)

        d = jnp.clip(lam / jnp.maximum(s, eps), 0.0, d_max)
        blocks = _gtdg_blocks(d, mu)                        # (B,H,4,3,3)
        K = (P + jax.vmap(lambda bb: _block_diag_add(bb, n, dtype))(blocks)
             + jnp.eye(n, dtype=dtype) * reg)

        L = jnp.linalg.cholesky(K)

        def newton_solve(rhs):                              # rhs (B,n)
            x = solve_triangular(L, rhs[..., None], lower=True)
            return solve_triangular(jnp.swapaxes(L, -1, -2), x,
                                    lower=False)[..., 0]

        def solve_dir(rc):
            w = (lam * r_prim - rc) / jnp.maximum(s, eps)
            du = newton_solve(-(r_dual + GTdot(w)))
            ds = -(r_prim + Gdot(u + du) - Gdot(u))
            dlam = -(rc + lam * ds) / jnp.maximum(s, eps)
            return du, ds, dlam

        du_a, ds_a, dl_a = solve_dir(lam * s)

        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio.reshape(B, -1), axis=-1))

        def bc(x):                                          # (B,) -> bcast
            return x[:, None, None, None]

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = jnp.sum((s + bc(a_p) * ds_a) * (lam + bc(a_d) * dl_a),
                         axis=(1, 2, 3)) / m
        sigma = jnp.clip((mu_aff / jnp.maximum(mu_gap, eps)) ** 3,
                         1e-4, 0.9)
        corr = jnp.clip(ds_a * dl_a, -10.0 * bc(mu_gap), 10.0 * bc(mu_gap))
        rc = lam * s + corr - bc(sigma) * bc(mu_gap)
        du, ds, dlam = solve_dir(rc)

        a_p = 0.99 * max_step(s, ds)
        a_d = 0.99 * max_step(lam, dlam)

        # all three residuals gate the freeze (a warm-started iterate can
        # hold tiny complementarity with an unconverged dual residual)
        conv = ((mu_gap < tol)
                & (jnp.max(jnp.abs(r_prim.reshape(B, -1)), axis=-1)
                   < 1e3 * tol)
                & (jnp.max(jnp.abs(r_dual), axis=-1) < 1e3 * tol))
        # per-element non-finite direction guard: freeze at the last good
        # iterate instead of letting one exhausted central path poison the
        # batch element (f32 Cholesky can emit non-finite pivots once
        # d saturates)
        bad = ~(jnp.all(jnp.isfinite(du), axis=-1)
                & jnp.all(jnp.isfinite(ds.reshape(B, -1)), axis=-1)
                & jnp.all(jnp.isfinite(dlam.reshape(B, -1)), axis=-1))
        done = done | conv | bad
        dn = done[:, None]
        dn4 = bc(done.astype(dtype)) > 0.5
        u2 = jnp.where(dn, u, u + a_p[:, None] * du)
        s2 = jnp.where(dn4, s, s + bc(a_p) * ds)
        lam2 = jnp.where(dn4, lam, lam + bc(a_d) * dlam)
        return (u2, s2, lam2, done), None

    done0 = jnp.zeros((B,), dtype=bool)
    (u, s, lam, done), _ = jax.lax.scan(
        body, (u, s, lam, done0), None, length=iters)

    u = u * jnp.repeat(contact.reshape(B, H, 4), 3, axis=-1).reshape(B, n)
    gap = jnp.sum(s * lam, axis=(1, 2, 3)) / m
    r_dual = jnp.max(jnp.abs(
        _einsum("bij,bj->bi", P, u) + q + GTdot(lam)), axis=-1)
    return PdipResult(u=u, gap=gap, r_dual=r_dual, iters=jnp.asarray(iters))


def _block_diag_add(blocks, n, dtype):
    """Assemble (H,4,3,3) blocks into an (n, n) block-diagonal matrix.

    Scatter-free: embed[b3k+i, 3m+j] = blocks[k,i,j] * I[k,m] via a
    broadcast multiply with a static identity — XLA fuses this into the
    consumer add, where a gather/scatter formulation would serialize."""
    nb = n // 3
    b = blocks.reshape(nb, 3, 3)
    eye = jnp.eye(nb, dtype=dtype)
    out = b[:, :, None, :] * eye[:, None, :, None]     # (nb,3,nb,3)
    return out.reshape(n, n)
