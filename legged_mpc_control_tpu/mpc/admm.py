"""Batched ADMM (OSQP-equivalent) solver for the condensed MPC QP.

The reference solves its MPC QP with OSQP — an ADMM splitting method with
warm starts and loose tolerances (abs 1e-3 / rel 1e-4, reference:
ConvexQPSolver.cpp:182-185). This module is the equivalent on the
*condensed* QP (qp_builder.py):

    min_u  1/2 u^T P u + q^T u   s.t.   G u <= h

with G block-separable: 6 rows per (step, leg) touching only that leg's 3
forces (same structure as pdip.py).

Like OSQP, the problem is equilibrated before splitting — the condensed P
mixes ~1e-4 R-regularization eigenvalues with ~1e-1 tracking eigenvalues and
raw ADMM stalls on it (dual residual plateaus around 1e-2). We apply Jacobi
scaling u = D u~ with D = diag(P)^(-1/2) plus unit-row-norm equilibration of
the scaled constraint blocks (OSQP's Ruiz loop converges to essentially this
on a diagonally-dominated QP). The scaled iteration is

    solve  (P~ + sigma I + rho G~^T G~) x_t = sigma x - q~ + G~^T (rho z - y)
    x  <- alpha x_t + (1 - alpha) x
    z  <- clip(G~ x + y / rho, -inf, h~)
    y  <- y + rho (G~ x - z)

The KKT matrix is constant across iterations (rho fixed), so it is
factorized ONCE per solve; each iteration is two triangular solves plus
elementwise work. Use PDIP (pdip.py) when the 1e-4 GRF parity bound matters
on a cold solve; use ADMM for closed-loop operation where warm starts carry
the active set across ticks — mirroring how the reference actually runs OSQP
(`setWarmStart(true)`, reference: ConvexQPSolver.cpp:185).
"""

from functools import partial as _partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from legged_mpc_control_tpu.mpc.pdip import (
    N_CON_PER_LEG,
    _block_diag_add,
    _g_local,
    _h_vec,
)

# full-f32 contractions (see qp_builder.py for why bf16 passes are unsafe
# near this QP's tiny R-regularization scale)
_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class AdmmResult(NamedTuple):
    u: jnp.ndarray        # (B, 12H) optimal GRFs over the horizon
    r_prim: jnp.ndarray   # (B,) final primal residual inf-norm (scaled)
    r_dual: jnp.ndarray   # (B,) final dual residual inf-norm (unscaled)
    warm: tuple           # (x, z, y) scaled state for warm-starting


def solve_qp_admm_batched(P, q, mu, fz_max, contact, *, iters=200,
                          rho=0.1, sigma=1e-6, alpha=1.6, warm=None):
    """OSQP-style ADMM on the batched condensed QP.

    Args:
      P: (B, n, n) PSD Hessians, q: (B, n), contact: (B, H, 4).
      iters: fixed iteration count (static under jit). 200 cold iterations
        reach OSQP's own operating accuracy (~0.1 N GRF error at abs 1e-3);
        warm-started re-solves across MPC ticks need far fewer (~30).
      rho / sigma / alpha: OSQP step, regularization, relaxation parameters
        (OSQP defaults: rho=0.1, sigma=1e-6, alpha=1.6).
      warm: optional `AdmmResult.warm` from a previous solve. Valid across
        ticks because the scaling D depends only on diag(P), which is
        near-constant tick to tick.

    Returns AdmmResult. Fully jittable.
    """
    B, n = q.shape
    H = n // 12
    dtype = P.dtype

    # --- equilibration ---
    dgP = jax.vmap(jnp.diag)(P)                           # (B,n)
    d = jax.lax.rsqrt(jnp.maximum(dgP, 1e-12))            # Jacobi scale
    Ps = P * d[:, :, None] * d[:, None, :]
    qs = q * d

    # per-(step,leg) scaled constraint blocks G~ = E G_loc D_leg
    # (_g_local handles scalar or per-scenario (B,) mu)
    Glb = jnp.broadcast_to(_g_local(mu, dtype), (B, 6, 3))
    d_leg = d.reshape(B, H, 4, 3)
    Gb = Glb[:, None, None] * d_leg[..., None, :]         # (B,H,4,6,3)
    e = jax.lax.rsqrt(jnp.maximum(
        jnp.sum(Gb * Gb, axis=-1), 1e-12))                # (B,H,4,6)
    Gb = Gb * e[..., None]
    hs = jnp.broadcast_to(
        _h_vec(H, fz_max, dtype), (B, H, 4, N_CON_PER_LEG)) * e
    NEG = jnp.asarray(-1e20 if dtype == jnp.float64 else -3e38, dtype)

    rho_arr = jnp.asarray(rho, dtype)
    sigma_arr = jnp.asarray(sigma, dtype)

    def Gdot(u):
        return _einsum("bhlri,bhli->bhlr", Gb, u.reshape(B, H, 4, 3))

    def GTdot(w):
        return _einsum("bhlri,bhlr->bhli", Gb, w).reshape(B, n)

    # constant KKT matrix: K = P~ + sigma I + rho G~^T G~ (block-diagonal
    # 3x3 contribution per (step, leg))
    gtg_blocks = _einsum("bhlri,bhlrj->bhlij", Gb, Gb)    # (B,H,4,3,3)
    K = (Ps + jax.vmap(lambda bb: _block_diag_add(bb, n, dtype))(gtg_blocks)
         * rho_arr + sigma_arr * jnp.eye(n, dtype=dtype)[None])

    L = jnp.linalg.cholesky(K)

    def kkt_solve(rhs):                                   # rhs (B,n)
        s1 = solve_triangular(L, rhs[..., None], lower=True)
        return solve_triangular(jnp.swapaxes(L, -1, -2), s1,
                                lower=False)[..., 0]

    if warm is None:
        x = jnp.zeros((B, n), dtype=dtype)
        z = jnp.zeros((B, H, 4, N_CON_PER_LEG), dtype=dtype)
        y = jnp.zeros_like(z)
    else:
        x, z, y = warm

    def body(carry, _):
        x, z, y = carry
        rhs = sigma_arr * x - qs + GTdot(rho_arr * z - y)
        x_t = kkt_solve(rhs)
        x2 = alpha * x_t + (1.0 - alpha) * x
        Gx = Gdot(x2)
        z2 = jnp.clip(Gx + y / rho_arr, NEG, hs)
        y2 = y + rho_arr * (Gx - z2)
        return (x2, z2, y2), None

    (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=iters)

    Gx = Gdot(x)
    r_prim = jnp.max(jnp.abs(Gx - z).reshape(B, -1), axis=-1)

    # unscale: u = D x; dual residual reported in original units
    u = x * d
    lam = (y * e).reshape(B, H, 4, N_CON_PER_LEG)
    r_dual_vec = (_einsum("bij,bj->bi", P, u) + q
                  + _einsum("bri,bhlr->bhli", Glb, lam).reshape(B, n))
    r_dual = jnp.max(jnp.abs(r_dual_vec), axis=-1)

    # exact swing-leg zeroing (same argument as pdip.py: masked-out columns
    # leave only the R penalty on swing forces, whose optimum is 0; ADMM
    # leaves an O(r_prim) residue there)
    u = u * jnp.repeat(contact.reshape(B, H, 4), 3, axis=-1).reshape(B, n)
    return AdmmResult(u=u, r_prim=r_prim, r_dual=r_dual, warm=(x, z, y))
