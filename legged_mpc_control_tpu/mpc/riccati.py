"""Riccati-structured batched interior-point MPC solver (long horizons).

The condensed dense formulation (qp_builder.py + pdip.py) factorizes a
(12H x 12H) Newton matrix per iteration — O((12H)^3) flops, which grows
past the stagewise cost quickly with the horizon. This module solves the
SAME QP without ever condensing: the stagewise (sparse) form

    min  sum_k 1/2 (x_{k+1} - xref_k)^T Q (x_{k+1} - xref_k)
              + 1/2 u_k^T R u_k
    s.t. x_{k+1} = A_k x_k + B_k u_k + d          (gravity affine,
                                                   reference:
                                                   ConvexQPSolver.cpp:174-177)
         G(mu) u_k <= h_k                          (friction pyramid + fz box,
                                                   reference: :130-177)

is attacked with the same Mehrotra predictor-corrector as pdip.py, but each
Newton system — (P + G^T D G + reg) du = rhs in condensed coordinates — is
solved by a time-varying LQR Riccati sweep: O(H * 12^3) work, H small
(12x12) factorizations, block-banded structure exploited exactly
(Rao-Wright-Rawlings efficient-IPM structure; SURVEY §7 "hard parts").
The dual residual is evaluated stagewise via a forward rollout + backward
adjoint, so the dense P / S matrices are never materialized at any horizon.

Layout: all stage algebra runs BATCH-LAST — tensors are (..., 12, 12, B)
with the scenario batch on the minor axis, and every 12x12 matrix product /
Cholesky step is hand-unrolled into (12, B) or (12, 12, B) elementwise ops
that XLA fuses, instead of thousands of batched 12x12 library calls.
Whether that still beats a batched dot_general / cuSOLVER formulation on
the GPU is not measured yet. Produces iterates identical (up to roundoff)
to pdip.solve_qp_pdip_batched on the condensed QP.
"""

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu.constants import GRAVITY
from legged_mpc_control_tpu.mpc.pdip import (
    N_CON_PER_LEG,
    PdipResult,
    _g_apply,
    _gt_apply,
    _gtdg_blocks,
    _h_vec,
)

NX = 12
# stage-scan unroll factor (1 = rolled). Unrolling lets XLA fuse across
# stages instead of paying a scan-iteration boundary per 12x12 block, at
# the cost of a larger program.
STAGE_UNROLL = 1

# --- batch-in-lanes small-matrix algebra -----------------------------------
# Operands are (..., n, n, B) / (..., n, B); the loops below unroll the tiny
# contraction dimension so each term is a broadcasted elementwise FMA over
# the lane axis. n is static and small (12).

def _mm(A, C):
    """A @ C, both (..., n, n, B)."""
    n = A.shape[-2]
    acc = A[..., :, 0, :][..., :, None, :] * C[..., 0, :, :][..., None, :, :]
    for j in range(1, n):
        acc = acc + (A[..., :, j, :][..., :, None, :]
                     * C[..., j, :, :][..., None, :, :])
    return acc

def _mtm(A, C):
    """A^T @ C, both (..., n, n, B)."""
    n = A.shape[-3]
    acc = A[..., 0, :, :][..., :, None, :] * C[..., 0, :, :][..., None, :, :]
    for j in range(1, n):
        acc = acc + (A[..., j, :, :][..., :, None, :]
                     * C[..., j, :, :][..., None, :, :])
    return acc

def _mv(A, x):
    """A @ x: (..., n, n, B), (..., n, B) -> (..., n, B)."""
    n = A.shape[-2]
    acc = A[..., :, 0, :] * x[..., 0, :][..., None, :]
    for j in range(1, n):
        acc = acc + A[..., :, j, :] * x[..., j, :][..., None, :]
    return acc

def _mtv(A, x):
    """A^T @ x: (..., n, n, B), (..., n, B) -> (..., n, B)."""
    n = A.shape[-3]
    acc = A[..., 0, :, :] * x[..., 0, :][..., None, :]
    for j in range(1, n):
        acc = acc + A[..., j, :, :] * x[..., j, :][..., None, :]
    return acc

def _chol_lanes(A):
    """Lower Cholesky of (n, n, B) SPD, fully unrolled (n static, small).
    Returns rows as a python list-of-lists of (B,) lane vectors plus the
    stacked (n, n, B) tensor (for scan carries)."""
    n = A.shape[0]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - rows[j][k] * rows[j][k]
        dj = jnp.sqrt(d)
        rows[j][j] = dj
        inv = 1.0 / dj
        for i in range(j + 1, n):
            v = A[i, j]
            for k in range(j):
                v = v - rows[i][k] * rows[j][k]
            rows[i][j] = v * inv
    zero = jnp.zeros_like(A[0, 0])
    Lt = jnp.stack([jnp.stack([rows[i][j] if j <= i else zero
                               for j in range(n)]) for i in range(n)])
    return Lt

def _cho_solve_lanes(L, M):
    """Solve (L L^T) Y = M with L (n, n, B) lower, M (n, m, B) or (n, B)."""
    vec = M.ndim == 2
    if vec:
        M = M[:, None, :]
    n = L.shape[0]
    ys = []
    for i in range(n):
        acc = M[i]
        for k in range(i):
            acc = acc - L[i, k][None, :] * ys[k]
        ys.append(acc / L[i, i][None, :])
    zs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = ys[i]
        for k in range(i + 1, n):
            acc = acc - L[k, i][None, :] * zs[k]
        zs[i] = acc / L[i, i][None, :]
    out = jnp.stack(zs)
    return out[:, 0, :] if vec else out

def warm_shift(u_prev, contact):
    """Cross-tick warm start primal: shift the previous tick's optimal
    input sequence forward one stage (stage k of this tick aligns with
    stage k+1 of the last tick — the ticks are one MPC step apart), repeat
    the terminal stage, and zero swing legs under the NEW contact schedule.
    The role of OSQP's setWarmStart(true) in the reference
    (ConvexQPSolver.cpp:185).

    u_prev: (B, H*12) -> (B, H*12)."""
    B = u_prev.shape[0]
    H = contact.shape[1]
    u = u_prev.reshape(B, H, NX)
    u = jnp.concatenate([u[:, 1:], u[:, -1:]], axis=1)
    return (u * jnp.repeat(contact, 3, axis=-1)).reshape(B, H * NX)


def solve_qp_riccati_batched(x0, x_ref, A_seq, Bmat, contact, q_weights,
                             r_weights, mu, fz_max, dt, *, iters=18,
                             tol=None, warm_u=None):
    """Batched stagewise interior-point solve. No condensation.

    Args:
      x0: (B, 12) current states.
      x_ref: (B, H, 12) reference states (x_{k+1} tracks x_ref[:, k]).
      A_seq: (B, H, 12, 12) discrete A per step.
      Bmat: (B, 12, 12) discrete B (shared across steps, like the
        reference ConvexQPSolver.cpp:280-283).
      contact: (B, H, 4) contact schedule in {0., 1.} — swing legs' B
        columns are masked (same optimum as the reference's fz in [0,0]
        boxes, see qp_builder.py docstring).
      q_weights / r_weights: (12,) or (B, 12) diagonal costs.
      mu, fz_max: scalar or (B,).
      dt: MPC step (gravity affine term).
      warm_u: optional (B, 12H) PREVIOUS-tick solution (already
        warm_shift-ed by the caller): primal warm start with recentered
        interior duals — cuts the iterations needed for control-grade
        accuracy roughly in half in closed loop.

    Returns PdipResult with u flattened to (B, 12H) like the condensed path.
    """
    B, H, nx = x_ref.shape
    dtype = x_ref.dtype
    m = H * 4 * N_CON_PER_LEG
    if tol is None:
        tol = 1e-11 if dtype == jnp.float64 else 1e-6
    d_max = 1e14 if dtype == jnp.float64 else 1e6
    reg = 1e-11 if dtype == jnp.float64 else 1e-6
    eps = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-20, dtype)

    qw = jnp.broadcast_to(jnp.asarray(q_weights, dtype), (B, NX)).T  # (12,B)
    rw = jnp.broadcast_to(jnp.asarray(r_weights, dtype), (B, NX)).T

    legmask = jnp.repeat(contact, 3, axis=-1)              # (B,H,12)
    d_aff = jnp.zeros((NX, 1), dtype).at[11, 0].set(-GRAVITY * dt)

    h = jnp.broadcast_to(_h_vec(H, fz_max, dtype), (B, H, 4, 6))

    # lanes-layout stage data: (H, 12, 12, B)
    A_t = A_seq.transpose(1, 2, 3, 0)
    B_t = (Bmat[:, None] * legmask[:, :, None, :]).transpose(1, 2, 3, 0)
    xref_t = x_ref.transpose(1, 2, 0)                      # (H,12,B)
    x0_t = x0.T                                            # (12,B)
    eyeNX = jnp.eye(NX, dtype=dtype)

    def Gdot(u_t):                                         # u_t (H,12,B)
        u = u_t.transpose(2, 0, 1)                         # (B,H,12)
        return _g_apply(u.reshape(B, H, 4, 3), mu)

    def GTdot(w):                                          # (B,H,4,6)
        return _gt_apply(w, mu).reshape(B, H, NX).transpose(1, 2, 0)

    def rollout(u_t):
        """x_1..x_H from x0 under the stage dynamics. (H,12,B)."""
        def step(x, inp):
            Ak, Bk, uk = inp
            xn = _mv(Ak, x) + _mv(Bk, uk) + d_aff
            return xn, xn

        _, X = jax.lax.scan(step, x0_t, (A_t, B_t, u_t),
                            unroll=STAGE_UNROLL)
        return X

    def adjoint(qx_t):
        """psi_k = qx_k + A_{k+1}^T psi_{k+1}. qx_t, out: (H,12,B)."""
        A_next = jnp.concatenate(
            [A_t[1:], jnp.zeros_like(A_t[:1])], axis=0)

        def step(p, inp):
            Ak1, qk = inp
            pk = qk + _mtv(Ak1, p)
            return pk, pk

        _, psi = jax.lax.scan(step, jnp.zeros((NX, B), dtype),
                              (A_next[::-1], qx_t[::-1]),
                              unroll=STAGE_UNROLL)
        return psi[::-1]

    def factor(Hu_t):
        """Riccati factor sweep. Hu_t: (H,12,12,B).
        Returns stage-major caches (L, K, Hux), each (H,12,12,B)."""
        qdiag = eyeNX[:, :, None] * qw[:, None, :]          # (12,12,B)

        def step(Pn, inp):
            Ak, Bk, Huk = inp
            W = Pn + qdiag                                  # Q + P'_{k+1}
            BW = _mtm(Bk, W)
            Huu = Huk + _mm(BW, Bk)
            Hux = _mm(BW, Ak)
            L = _chol_lanes(Huu)
            K = -_cho_solve_lanes(L, Hux)
            Pk = _mm(_mtm(Ak, W), Ak) + _mtm(Hux, K)
            Pk = 0.5 * (Pk + jnp.swapaxes(Pk, 0, 1))
            return Pk, (L, K, Hux)

        P0 = jnp.zeros((NX, NX, B), dtype)
        _, caches = jax.lax.scan(step, P0,
                                 (A_t[::-1], B_t[::-1], Hu_t[::-1]),
                                 unroll=STAGE_UNROLL)
        return jax.tree.map(lambda c: c[::-1], caches)

    def lqr_solve(caches, g_t):
        """du = -K^{-1} g: one backward + one forward linear sweep.
        g_t, out: (H,12,B)."""
        L_t, K_t, Hux_t = caches

        def back(p, inp):
            Ak, Bk, Lk, Huxk, gk = inp
            gtot = gk + _mtv(Bk, p)
            kff = -_cho_solve_lanes(Lk, gtot)
            pk = _mtv(Ak, p) + _mtv(Huxk, kff)
            return pk, kff

        _, kff_t = jax.lax.scan(
            back, jnp.zeros((NX, B), dtype),
            (A_t[::-1], B_t[::-1], L_t[::-1], Hux_t[::-1], g_t[::-1]),
            unroll=STAGE_UNROLL)
        kff_t = kff_t[::-1]

        def fwd(dx, inp):
            Ak, Bk, Kk, kffk = inp
            du = kffk + _mv(Kk, dx)
            dxn = _mv(Ak, dx) + _mv(Bk, du)
            return dxn, du

        _, du_t = jax.lax.scan(fwd, jnp.zeros((NX, B), dtype),
                               (A_t, B_t, K_t, kff_t),
                               unroll=STAGE_UNROLL)
        return du_t

    def dual_residual(u_t, lam):
        X = rollout(u_t)
        psi = adjoint(qw[None] * (X - xref_t))
        return u_t * rw[None] + GTdot(lam) + _mtv(B_t, psi)

    # --- initialization (mirrors pdip.py; warm: primal from the shifted
    # previous solution, slacks clipped interior, duals recentered to a
    # small complementarity target) ---
    if warm_u is None:
        u = jnp.zeros((H, NX, B), dtype=dtype)
        s = jnp.maximum(h - Gdot(u), 1.0)
        lam = jnp.ones_like(s)
    else:
        u = warm_u.reshape(B, H, NX).transpose(1, 2, 0)
        u = u * legmask.transpose(1, 2, 0)
        s = jnp.maximum(h - Gdot(u), 0.1)
        lam = jnp.clip(1.0 / s, 1e-3, 1e2)

    def body(carry, _):
        u, s, lam, done = carry
        r_dual = dual_residual(u, lam)                     # (H,12,B)
        r_prim = Gdot(u) + s - h                           # (B,H,4,6)
        mu_gap = jnp.sum(s * lam, axis=(1, 2, 3)) / m      # (B,)

        dscale = jnp.clip(lam / jnp.maximum(s, eps), 0.0, d_max)
        blocks = _gtdg_blocks(dscale, mu)                  # (B,H,4,3,3)
        # Hu_k = diag(r) + blockdiag(G^T D G) + reg I as (H,12,12,B):
        # place the (H,4,3,3,B) leg blocks by explicit concatenation.
        # NEVER via a one-hot einsum: at default precision that contraction
        # may round its operands (TF32 on the GPU), quantizing the
        # interior-point D-scale (spans ~1e6) enough to make Huu indefinite
        # on hard scenarios -> Cholesky NaN -> the non-finite guard freezes
        # those scenarios at an unconverged iterate.
        blk_t = blocks.transpose(1, 2, 3, 4, 0)            # (H,4,3,3,B)
        zero33 = jnp.zeros((H, 3, 3, B), dtype)
        Hu = jnp.concatenate([
            jnp.concatenate([blk_t[:, leg] if c == leg else zero33
                             for c in range(4)], axis=2)
            for leg in range(4)], axis=1)                  # (H,12,12,B)
        Hu = Hu + eyeNX[:, :, None] * (rw[:, None, :] + reg)
        caches = factor(Hu)

        def solve_dir(rc):
            w = (lam * r_prim - rc) / jnp.maximum(s, eps)
            du = lqr_solve(caches, r_dual + GTdot(w))
            ds = -(r_prim + Gdot(du))
            dlam = -(rc + lam * ds) / jnp.maximum(s, eps)
            return du, ds, dlam

        du_a, ds_a, dl_a = solve_dir(lam * s)

        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio.reshape(B, -1), axis=-1))

        def max_step_u(v, dv):                             # (H,12,B) lanes
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio, axis=(0, 1)))

        def bc(x):
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

        # all three residuals gate the freeze: a warm-started iterate can
        # hold tiny complementarity with a large DUAL residual — freezing
        # on (gap, primal) alone strands such lanes off-optimum
        conv = ((mu_gap < tol)
                & (jnp.max(jnp.abs(r_prim.reshape(B, -1)), axis=-1)
                   < 1e3 * tol)
                & (jnp.max(jnp.abs(r_dual), axis=(0, 1)) < 1e3 * tol))
        bad = ~(jnp.all(jnp.isfinite(du), axis=(0, 1))
                & jnp.all(jnp.isfinite(ds.reshape(B, -1)), axis=-1)
                & jnp.all(jnp.isfinite(dlam.reshape(B, -1)), axis=-1))
        done = done | conv | bad
        dn_u = done[None, None, :]
        dn4 = bc(done)
        u2 = jnp.where(dn_u, u, u + a_p[None, None, :] * du)
        s2 = jnp.where(dn4, s, s + bc(a_p) * ds)
        lam2 = jnp.where(dn4, lam, lam + bc(a_d) * dlam)
        return (u2, s2, lam2, done), None

    done0 = jnp.zeros((B,), dtype=bool)
    (u, s, lam, done), _ = jax.lax.scan(
        body, (u, s, lam, done0), None, length=iters)

    # exact swing-leg zeroing (see pdip.py)
    u = u * legmask.transpose(1, 2, 0)
    gap = jnp.sum(s * lam, axis=(1, 2, 3)) / m
    r_dual_t = dual_residual(u, lam)                       # (H,12,B)
    r_dual = jnp.max(jnp.abs(r_dual_t), axis=(0, 1))
    u_out = u.transpose(2, 0, 1).reshape(B, H * NX)
    return PdipResult(u=u_out, gap=gap, r_dual=r_dual,
                      iters=jnp.asarray(iters))

