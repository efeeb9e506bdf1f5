"""Contact-implicit MPC: trajectory optimization THROUGH contact.

The reference's second MPC backend (reference:
src/legged_ctrl/src/mpc_ctrl/ci_mpc/LciMpc.cpp:8-24 bridging to
ContactImplicitMPC.jl; capability claim README.md:14 — Go1 trot,
box-step, wall-lean) optimizes body AND foot trajectories without a
pre-committed contact schedule: contact forces and make/break timing come
out of complementarity conditions against the terrain, so stepping ONTO a
box emerges from the geometry instead of from a hand-fed gait table.

This module is the framework's own engine for that slot
(the Julia engine is an empty submodule in the reference snapshot):

  * model — single rigid body + 4 point feet:
      state  z in R^24 = [pos(3), eul(3), v(3), omega(3), feet_world(12)]
      input  u in R^24 = [grf(12) world, foot_vel(12) world]
    body integrates SRB dynamics under the GRFs applied at the feet; feet
    are velocity-controlled (the standard simplified contact-implicit
    model: the WBC/leg-PD tracks whatever foot motion the optimizer asks
    for, exactly how the LciMpc seam consumes the result).
  * contact via RELAXED/SMOOTHED COMPLEMENTARITY penalties, annealed like
    a central path (rho shrinks with iteration — the same relaxation
    ContactImplicitMPC.jl's interior-point applies to its NCP):
      - smoothed Fischer-Burmeister residual on (fz, gap):
          FB(a, b; rho) = a + b - sqrt(a^2 + b^2 + rho^2),  penalize FB^2
        (zero iff fz >= 0, gap >= 0, fz*gap ~ rho^2/2 — one residual
        covers force-at-distance, penetration, and negative normal force,
        and unlike softplus products it vanishes EXACTLY at legitimate
        contact, so stance forces are not biased)
      - slip:               fz * |w_xy|^2         -> 0  (stick while loaded)
      - friction pyramid:   sp_rho(|f_t| - mu fz)^2 -> 0
    with forces in units of f0=50 N and gaps in units of g0=2 cm so the
    residual is O(1), where gap(foot) = foot_z - terrain_height(foot_xy)
    over the SAME height field the simulator stands on — the optimizer
    literally sees the box.
  * solver — Gauss-Newton iLQR: AD stage derivatives (jacfwd dynamics,
    hessian cost), Riccati-style backward scan, parallel-alpha forward
    line search. Fixed iteration count, no data-dependent control flow:
    one XLA compilation, batchable with vmap (stage Hessians are 48x48 —
    MXU-friendly dense blocks).

API: `ci_solve` (the optimizer), `make_ci_reference` (trot-template
reference the tracker pulls toward — the reference system likewise tracks
a template trajectory; complementarity, not the template, decides the
actual contact), `make_ci_walk_policy` (the `(x40, t) -> (78,)` policy
that plugs into the LciMpc seam, mpc/lci_mpc.py).
"""

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu.sim import terrain as terrain_mod

NZ = 24
NU = 24
GRAV = 9.81


class CiWeights(NamedTuple):
    """Cost weights. Complementarity weights are the penalty strengths the
    rho-anneal tightens against."""
    q_pos: Any
    q_eul: Any
    q_vel: Any
    q_omega: Any
    q_foot: Any          # foot-position template tracking (weak)
    r_f: Any             # GRF regularization
    r_w: Any             # foot-velocity regularization
    c_fb: Any            # Fischer-Burmeister complementarity residual
    c_slip: Any          # tangential foot velocity while loaded
    c_cone: Any          # friction pyramid
    c_mask: Any          # force on mask-forbidden feet (stage-0 reality)


# complementarity scaling: forces in f0 N, gaps in g0 m (O(1) residuals)
F0 = 50.0
G0 = 0.02


def default_weights(dtype=jnp.float32) -> CiWeights:
    a = lambda v: jnp.asarray(v, dtype)
    return CiWeights(
        q_pos=a([30.0, 30.0, 120.0]),
        q_eul=a([60.0, 60.0, 30.0]),
        q_vel=a([20.0, 20.0, 30.0]),
        q_omega=a([1.0, 1.0, 1.0]),
        q_foot=a([18.0, 18.0, 60.0]),
        r_f=a(1e-3),
        r_w=a(5e-2),
        c_fb=a(40.0),
        c_slip=a(8.0),
        c_cone=a(10.0),
        c_mask=a(60.0),
    )


def _sp(x, rho):
    """Smoothed relu: rho * softplus(x / rho) -> max(x, 0) as rho -> 0."""
    return rho * jax.nn.softplus(x / rho)


def _fb(a, b, rho):
    """Smoothed Fischer-Burmeister: zero iff a >= 0, b >= 0 and
    a*b ~ rho^2/2; negative when either is negative. Smooth everywhere."""
    return a + b - jnp.sqrt(a * a + b * b + rho * rho)


def env_gap_normal(terrain, wall, p, beta=0.03):
    """Smooth gap function and contact normal of the whole environment —
    the ground height field plus an optional vertical wall
    (sim.terrain.Wall) — at points p (..., 3).

    The two half-space gaps are blended by a sigmoid softmin of width
    `beta` so gap and normal are smooth in p everywhere, including at the
    ground/wall corner: near the wall the contact normal rotates from +z
    to the wall normal, which is what lets one foot-force vector carry
    BOTH the ground complementarity and the wall complementarity without
    double-counting (the closer surface owns the contact)."""
    gap_g = p[..., 2] - terrain_mod.height_at(terrain, p[..., 0:2])
    up = jnp.array([0.0, 0.0, 1.0], p.dtype)
    if wall is None:
        return gap_g, jnp.broadcast_to(up, p.shape)
    gap_w = terrain_mod.wall_gap(wall, p)
    w_wall = jax.nn.sigmoid((gap_g - gap_w) / beta)    # ~1 where wall closer
    gap = w_wall * gap_w + (1.0 - w_wall) * gap_g
    n = (w_wall[..., None] * wall.normal.astype(p.dtype)
         + (1.0 - w_wall[..., None]) * up)
    n = n / jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True) + 1e-12)
    return gap, n


def ci_dynamics(z, u, mass, inertia_w_inv, dt):
    """One smooth SRB+feet step. inertia_w_inv: (3,3) world-frame inverse
    trunk inertia (fixed at the current yaw — the same time-invariant
    linearization the convex path uses, mpc/reference.py)."""
    dtype = z.dtype
    pos, eul, v, om = z[0:3], z[3:6], z[6:9], z[9:12]
    feet = z[12:24].reshape(4, 3)
    f = u[0:12].reshape(4, 3)
    w = u[12:24].reshape(4, 3)

    f_tot = jnp.sum(f, axis=0)
    acc = f_tot / mass + jnp.array([0.0, 0.0, -GRAV], dtype)
    tau = jnp.sum(jnp.cross(feet - pos[None, :], f), axis=0)

    pos2 = pos + dt * v
    eul2 = eul + dt * om            # small-angle euler rates (convex path)
    v2 = v + dt * acc
    om2 = om + dt * (inertia_w_inv @ tau)
    feet2 = feet + dt * w
    return jnp.concatenate([pos2, eul2, v2, om2, feet2.reshape(-1)])


def ci_stage_cost(z, u, ref_z, ref_u, terrain, wts: CiWeights, mu, rho,
                  f_mask=None, wall=None):
    """Tracking + relaxed complementarity. All terms smooth in (z, u).

    f_mask: optional (4,) in [0,1]; feet with mask 0 are penalized for
    carrying normal force at this stage — how the policy tells the solver
    which feet have physically registered contact RIGHT NOW (stage 0), so
    the plan redistributes support instead of counting on a foot the
    executor will gate out (the condensed distilled policy encodes the
    same fact as sched[0] = measured support, mpc/lci_mpc.py)."""
    pos, eul, v, om = z[0:3], z[3:6], z[6:9], z[9:12]
    feet = z[12:24].reshape(4, 3)
    f = u[0:12].reshape(4, 3)
    w = u[12:24].reshape(4, 3)
    fz = f[:, 2]

    track = (jnp.sum(wts.q_pos * (pos - ref_z[0:3]) ** 2)
             + jnp.sum(wts.q_eul * (eul - ref_z[3:6]) ** 2)
             + jnp.sum(wts.q_vel * (v - ref_z[6:9]) ** 2)
             + jnp.sum(wts.q_omega * (om - ref_z[9:12]) ** 2)
             + jnp.sum(wts.q_foot[None, :]
                       * (feet - ref_z[12:24].reshape(4, 3)) ** 2)
             + wts.r_f * jnp.sum((u[0:12] - ref_u[0:12]) ** 2)
             + wts.r_w * jnp.sum((u[12:24] - ref_u[12:24]) ** 2))

    if wall is None:
        # flat-normal fast path (byte-identical to the pre-wall model)
        gap = feet[:, 2] - terrain_mod.height_at(terrain, feet[:, 0:2])
        a = fz / F0                              # scaled normal force
        b = gap / G0                             # scaled gap
        comp = (wts.c_fb * jnp.sum(_fb(a, b, rho) ** 2)
                + wts.c_slip * jnp.sum(_sp(a, rho)[:, None]
                                       * w[:, 0:2] ** 2)
                + wts.c_cone * jnp.sum(
                    _sp((jnp.abs(f[:, 0]) - mu * fz) / F0, rho) ** 2
                    + _sp((jnp.abs(f[:, 1]) - mu * fz) / F0, rho) ** 2))
    else:
        # generalized contact: normal/tangent decomposition against the
        # blended environment normal (ground OR wall, whichever is closer).
        # NOTE the friction geometry deliberately switches form here: the
        # flat branch uses the per-axis PYRAMID (matching the convex MPC,
        # reference: ConvexQPSolver.cpp:130-158) but per-axis bounds are
        # meaningless against a rotated normal, so the wall branch uses
        # the circular CONE on |f_t|. The cone is the pyramid's inscribed
        # (conservative) set — a wall=None and wall=far-away solve can
        # therefore differ slightly in the corner-loaded regime.
        gap, n = env_gap_normal(terrain, wall, feet)       # (4,), (4,3)
        fn = jnp.sum(f * n, axis=-1)
        ft = f - fn[:, None] * n
        wt = w - jnp.sum(w * n, axis=-1, keepdims=True) * n
        a = fn / F0
        b = gap / G0
        ft_mag = jnp.sqrt(jnp.sum(ft * ft, axis=-1) + 1e-8)
        comp = (wts.c_fb * jnp.sum(_fb(a, b, rho) ** 2)
                + wts.c_slip * jnp.sum(_sp(a, rho)[:, None] * wt ** 2)
                + wts.c_cone * jnp.sum(
                    _sp((ft_mag - mu * fn) / F0, rho) ** 2))
    if f_mask is not None:
        comp = comp + wts.c_mask * jnp.sum(((1.0 - f_mask) * a) ** 2)
    return track + comp


# ---------------------------------------------------------------------------
# Batch-native Gauss-Newton iLQR core
#
# Everything below is written batch-FIRST: z0 (B, NZ), U (B, H, NU), and
# every inner operation is an explicitly batched einsum / elementwise op, so
# one compilation serves both the B=1 product tick and the scenario-sweep
# batch (the reference runs one robot, main.cpp:130-163; the sweep batch is
# this framework's scaling surface). Three structural rewrites vs a naive
# vmap of a solo solver:
#   * analytic dynamics Jacobians (`_dyn_jac_b`) — the SRB+feet model's
#     Fz/Fu are a handful of constant and skew blocks; no AD over the
#     dynamics at all;
#   * per-foot Gauss-Newton quadratization (`_quad_ggn_b`) — the stage
#     cost is diagonal tracking plus per-foot complementarity residuals in
#     9 variables (foot pos, force, foot vel), so the 48x48 stage Hessian
#     is J^T W J of a (6,9) per-foot residual Jacobian (9 JVPs) plus a
#     diagonal, instead of a 36-dim jax.hessian (36 HVPs). Gradients stay
#     EXACT (the cost is exactly sum_i W_i r_i^2); only the Hessian drops
#     the residual-curvature term — the textbook Gauss-Newton step, PSD by
#     construction, so the gain solve is a guaranteed-valid Cholesky;
#   * batched Cholesky gain solves (`_psd_solve_b`) — the gain systems are
#     SPD by construction, so a Cholesky replaces jnp.linalg.solve's
#     pivoting batched LU.
# ---------------------------------------------------------------------------


def _skew_b(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], -1),
        jnp.stack([v[..., 2], z, -v[..., 0]], -1),
        jnp.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _dyn_b(z, uh, mass, Iw_inv, dt, s_f=1.0):
    """Batched smooth SRB+feet step. z (..., NZ), uh (..., NU) with force
    channels in units of `s_f` N, Iw_inv (..., 3, 3) world-frame inverse
    trunk inertia. Identical math to `ci_dynamics`."""
    dtype = z.dtype
    lead = z.shape[:-1]
    pos, v, om = z[..., 0:3], z[..., 6:9], z[..., 9:12]
    feet = z[..., 12:24].reshape(lead + (4, 3))
    f = s_f * uh[..., 0:12].reshape(lead + (4, 3))
    w = uh[..., 12:24].reshape(lead + (4, 3))
    acc = jnp.sum(f, axis=-2) / mass + jnp.array([0.0, 0.0, -GRAV], dtype)
    tau = jnp.sum(jnp.cross(feet - pos[..., None, :], f), axis=-2)
    return jnp.concatenate([
        pos + dt * v,
        z[..., 3:6] + dt * om,
        v + dt * acc,
        om + dt * jnp.einsum("...ij,...j->...i", Iw_inv, tau),
        (feet + dt * w).reshape(lead + (12,))], axis=-1)


def _rollout_b(z0, U, mass, Iw_inv, dt, s_f=1.0):
    """z0 (B, NZ), U (B, H, NU) -> Z (B, H+1, NZ)."""
    def step(z, u):
        z2 = _dyn_b(z, u, mass, Iw_inv, dt, s_f)
        return z2, z2
    _, Z1 = jax.lax.scan(step, z0, jnp.swapaxes(U, 0, 1))
    return jnp.concatenate([z0[:, None], jnp.swapaxes(Z1, 0, 1)], axis=1)


def _traj_cost_b(Z, U, refs_z, refs_u, terrain, wts, mu, rho, f_mask,
                 wall=None):
    """Batched exact total cost of an ALREADY-ROLLED-OUT trajectory.
    Z (B,H+1,NZ), U UNSCALED (B,H,NU), rho (B,). Returns (B,)."""
    stage = jax.vmap(jax.vmap(
        lambda z, u, rz, ru, fm, rh: ci_stage_cost(
            z, u, rz, ru, terrain, wts, mu, rh, fm, wall),
        in_axes=(0, 0, 0, 0, 0, None)),
        in_axes=(0, 0, 0, 0, 0, 0))(
        Z[:, :-1], U, refs_z[:, :-1], refs_u, f_mask, rho)
    zT, rT = Z[:, -1], refs_z[:, -1]
    term = (jnp.sum(wts.q_pos * (zT[:, 0:3] - rT[:, 0:3]) ** 2, -1)
            + jnp.sum(wts.q_eul * (zT[:, 3:6] - rT[:, 3:6]) ** 2, -1)
            + jnp.sum(wts.q_vel * (zT[:, 6:9] - rT[:, 6:9]) ** 2, -1))
    return jnp.sum(stage, axis=1) + term


def _total_cost_b(z0, U, refs_z, refs_u, terrain, wts, mu, rho, mass,
                  Iw_inv, dt, f_mask, wall=None):
    """Batched exact total cost. U UNSCALED (B, H, NU); rho (B,).
    Returns ((B,), Z)."""
    Z = _rollout_b(z0, U, mass, Iw_inv, dt)
    return _traj_cost_b(Z, U, refs_z, refs_u, terrain, wts, mu, rho,
                        f_mask, wall), Z


def _dyn_jac_b(Zs, Uh, mass, Iw_inv, dt, s_f):
    """Analytic per-stage Jacobians of `_dyn_b` in scaled input coords.
    Zs (B, H, NZ) stage states, Uh (B, H, NU). Returns Fz, Fu
    (B, H, NZ, NZ) / (B, H, NZ, NU).

    Nonzero structure (z = [pos eul v om feet], u = [f w]):
      pos<-v, eul<-om, feet<-w : dt*I           (constant)
      v<-f                     : dt*s_f/m * I   (constant)
      om<-pos   : +dt*Iw_inv @ sum_i skew(f_i)
      om<-feet_i: -dt*Iw_inv @ skew(f_i)
      om<-f_i   : +dt*s_f*Iw_inv @ skew(feet_i - pos)
    """
    B, H = Zs.shape[0], Zs.shape[1]
    dtype = Zs.dtype
    f = s_f * Uh[..., 0:12].reshape(B, H, 4, 3)
    r = Zs[..., 12:24].reshape(B, H, 4, 3) - Zs[..., None, 0:3]
    sk_f = _skew_b(f)                                     # (B,H,4,3,3)

    def cst(mat, rows, cols):
        return jnp.broadcast_to(jnp.asarray(mat, dtype),
                                (B, H, rows, cols))
    I3 = jnp.eye(3)
    Z3 = jnp.zeros((3, 3))

    # om-row varying blocks (the only state-dependent pieces)
    P = dt * jnp.einsum("bij,bhjk->bhik", Iw_inv, jnp.sum(sk_f, axis=2))
    G = -dt * jnp.einsum("bij,bhfjk->bhfik", Iw_inv, sk_f)   # (B,H,4,3,3)
    G12 = jnp.swapaxes(G, 2, 3).reshape(B, H, 3, 12)
    Rm = (dt * s_f) * jnp.einsum("bij,bhfjk->bhfik", Iw_inv, _skew_b(r))
    R12 = jnp.swapaxes(Rm, 2, 3).reshape(B, H, 3, 12)

    # assemble by block rows (one concat each — no repeated full-array
    # scatter passes over the (B,H,24,24) operands)
    row_pos = cst(jnp.concatenate(
        [I3, Z3, dt * I3, Z3, jnp.zeros((3, 12))], axis=1), 3, NZ)
    row_eul = cst(jnp.concatenate(
        [Z3, I3, Z3, dt * I3, jnp.zeros((3, 12))], axis=1), 3, NZ)
    row_v = cst(jnp.concatenate(
        [Z3, Z3, I3, Z3, jnp.zeros((3, 12))], axis=1), 3, NZ)
    row_om = jnp.concatenate(
        [P, cst(Z3, 3, 3), cst(Z3, 3, 3), cst(I3, 3, 3), G12], axis=-1)
    row_feet = cst(jnp.concatenate(
        [jnp.zeros((12, 12)), jnp.eye(12)], axis=1), 12, NZ)
    Fz = jnp.concatenate([row_pos, row_eul, row_v, row_om, row_feet],
                         axis=-2)

    vrow = cst(jnp.concatenate(
        [jnp.tile((dt * s_f) * I3, (1, 4)),
         jnp.zeros((3, 12))], axis=1), 3, NU) / mass
    omrow = jnp.concatenate([R12, cst(jnp.zeros((3, 12)), 3, 12)], axis=-1)
    Fu = jnp.concatenate([
        cst(jnp.zeros((6, NU)), 6, NU),
        vrow, omrow,
        cst(jnp.concatenate([jnp.zeros((12, 12)), dt * jnp.eye(12)],
                            axis=1), 12, NU)], axis=-2)
    return Fz, Fu


def _foot_res(zeta, fm, rho, terrain, wall, mu, s_f):
    """Per-foot complementarity residual vector r (8,) in the per-foot
    variables zeta = [foot_pos(3), f_hat(3), w(3)] (force scaled by s_f).
    The stage cost's non-tracking part is EXACTLY sum_i W_i r_i^2 with the
    weights from `_foot_res_weights` — same terms as `ci_stage_cost`.

    The last two rows are NOT residuals: they carry the scaled normal
    force `a` and scaled gap `b` (weight 0), so one jacfwd of this
    function also yields grad(a)/grad(b) — the directions the
    Fischer-Burmeister curvature restoration in `_quad_ggn_b` needs."""
    p, fh, wh = zeta[0:3], zeta[3:6], zeta[6:9]
    f = s_f * fh
    if wall is None:
        a = f[2] / F0
        b = (p[2] - terrain_mod.height_at(terrain, p[0:2])) / G0
        sq = jnp.sqrt(_sp(a, rho) + 1e-12)
        return jnp.stack([
            _fb(a, b, rho),
            sq * wh[0], sq * wh[1],
            _sp((jnp.abs(f[0]) - mu * f[2]) / F0, rho),
            _sp((jnp.abs(f[1]) - mu * f[2]) / F0, rho),
            (1.0 - fm) * a,
            a, b])
    gap, n = env_gap_normal(terrain, wall, p)
    fn = jnp.dot(f, n)
    ft = f - fn * n
    wt = wh - jnp.dot(wh, n) * n
    a = fn / F0
    b = gap / G0
    ft_mag = jnp.sqrt(jnp.dot(ft, ft) + 1e-8)
    sq = jnp.sqrt(_sp(a, rho) + 1e-12)
    return jnp.stack([
        _fb(a, b, rho),
        sq * wt[0], sq * wt[1], sq * wt[2],
        _sp((ft_mag - mu * fn) / F0, rho),
        (1.0 - fm) * a,
        a, b])


def _foot_res_weights(wts: CiWeights, wall):
    zero = jnp.zeros_like(wts.c_fb)
    if wall is None:
        return jnp.stack([wts.c_fb, wts.c_slip, wts.c_slip,
                          wts.c_cone, wts.c_cone, wts.c_mask,
                          zero, zero])
    return jnp.stack([wts.c_fb, wts.c_slip, wts.c_slip, wts.c_slip,
                      wts.c_cone, wts.c_mask, zero, zero])


def _flat_res_jac(feet, fh, wh, fm, rho, terrain, mu, s_f):
    """Closed-form flat-branch per-foot residuals r (...,8) and Jacobian
    J (...,8,9) w.r.t. zeta = [foot_pos(3), f_hat(3), w(3)] — the exact
    derivatives of `_foot_res` (wall=None). rho broadcastable to feet's
    leading dims. Row order matches `_foot_res_weights`:
    [fb, slip_x, slip_y, cone_x, cone_y, mask, a, b]."""
    dtype = feet.dtype
    f = s_f * fh
    a = f[..., 2] / F0
    h = terrain_mod.height_at(terrain, feet[..., 0:2])
    hg = terrain_mod.height_grad_at(terrain, feet[..., 0:2])
    b = (feet[..., 2] - h) / G0
    s = jnp.sqrt(a * a + b * b + rho * rho)
    spa = _sp(a, rho)
    sig = jax.nn.sigmoid(a / rho)                       # sp'(a; rho)
    sq = jnp.sqrt(spa + 1e-12)
    dsq = sig / (2.0 * sq)                              # d sq / d a
    sfF0 = s_f / F0
    # da/dzeta: col 5 only (f_hat z); db/dzeta: cols 0..2
    dbx = -hg[..., 0] / G0
    dby = -hg[..., 1] / G0
    dbz = jnp.full_like(b, 1.0 / G0)
    z = jnp.zeros_like(a)

    ca = 1.0 - a / s
    cb = 1.0 - b / s
    t4 = (jnp.abs(f[..., 0]) - mu * f[..., 2]) / F0
    t5 = (jnp.abs(f[..., 1]) - mu * f[..., 2]) / F0
    sig4 = jax.nn.sigmoid(t4 / rho)
    sig5 = jax.nn.sigmoid(t5 / rho)
    sgn0 = jnp.sign(f[..., 0])
    sgn1 = jnp.sign(f[..., 1])

    r = jnp.stack([
        a + b - s,
        sq * wh[..., 0], sq * wh[..., 1],
        _sp(t4, rho), _sp(t5, rho),
        (1.0 - fm) * a,
        a, b], axis=-1)

    def row(c0=None, c1=None, c2=None, c3=None, c4=None, c5=None,
            c6=None, c7=None, c8=None):
        cols = [c if c is not None else z
                for c in (c0, c1, c2, c3, c4, c5, c6, c7, c8)]
        return jnp.stack(cols, axis=-1)

    J = jnp.stack([
        row(c0=cb * dbx, c1=cb * dby, c2=cb * dbz, c5=ca * sfF0),
        row(c5=dsq * wh[..., 0] * sfF0, c6=sq),
        row(c5=dsq * wh[..., 1] * sfF0, c7=sq),
        row(c3=sig4 * sgn0 * sfF0, c5=-sig4 * mu * sfF0),
        row(c4=sig5 * sgn1 * sfF0, c5=-sig5 * mu * sfF0),
        row(c5=(1.0 - fm) * sfF0),
        row(c5=jnp.full_like(a, sfF0)),
        row(c0=dbx, c1=dby, c2=dbz)], axis=-2)
    return r.astype(dtype), J.astype(dtype)


# per-foot variable positions inside the 48-dim stage vector zu = [z; uh]
_FOOT_IDX = jnp.asarray(
    [[12 + 3 * i, 13 + 3 * i, 14 + 3 * i,
      24 + 3 * i, 25 + 3 * i, 26 + 3 * i,
      36 + 3 * i, 37 + 3 * i, 38 + 3 * i] for i in range(4)],
    dtype=jnp.int32)                                      # (4, 9)


def _quad_ggn_b(Zs, Uh, refs_z, refs_u, f_mask, terrain, wall, wts, mu,
                rho, s_f):
    """Per-stage gradient (exact) and Gauss-Newton Hessian (PSD) of the
    stage cost in scaled coordinates. Zs (B,H,NZ), Uh (B,H,NU), rho (B,).
    Returns g (B,H,48), Hm (B,H,48,48)."""
    B, H = Uh.shape[0], Uh.shape[1]
    dtype = Uh.dtype
    feet = Zs[..., 12:24].reshape(B, H, 4, 3)
    fh = Uh[..., 0:12].reshape(B, H, 4, 3)
    wh = Uh[..., 12:24].reshape(B, H, 4, 3)

    if wall is None:
        # closed-form residuals AND Jacobian — the per-foot flat-terrain
        # derivatives are a handful of sigmoid/sqrt expressions, so the
        # 9-JVP jacfwd (kept for the wall branch, where the blended
        # normal makes hand derivatives error-prone) is pure overhead
        # here. Bitwise-matches jacfwd of `_foot_res` (wall=None) up to
        # fp reassociation; pinned by tests/test_ci_batched.py.
        r, J = _flat_res_jac(feet, fh, wh, f_mask, rho[:, None, None],
                             terrain, mu, s_f)
    else:
        zeta = jnp.concatenate([feet, fh, wh], axis=-1)   # (B,H,4,9)
        res = lambda ze, fm, rh: _foot_res(ze, fm, rh, terrain, wall,
                                           mu, s_f)
        both = lambda ze, fm, rh: (res(ze, fm, rh),
                                   jax.jacfwd(res)(ze, fm, rh))
        r, J = jax.vmap(jax.vmap(jax.vmap(
            both, in_axes=(0, 0, None)), in_axes=(0, 0, None)),
            in_axes=(0, 0, 0))(zeta, f_mask, rho)
        # (B,H,4,8), (B,H,4,8,9)

    # scatter per-foot Jacobians into 48-dim stage coordinates
    E = jax.nn.one_hot(_FOOT_IDX, NZ + NU, dtype=dtype)   # (4,9,48)
    J48f = jnp.einsum("bhfrn,fna->bhfra", J, E)           # (B,H,4,8,48)
    nres = r.shape[-1]
    J48 = J48f.reshape(B, H, 4 * nres, NZ + NU)
    Wv = jnp.tile(_foot_res_weights(wts, wall).astype(dtype), 4)
    r_all = r.reshape(B, H, 4 * nres)
    Hm = 2.0 * jnp.einsum("bhra,r,bhrc->bhac", J48, Wv, J48)
    g = 2.0 * jnp.einsum("bhra,bhr->bha", J48, Wv * r_all)

    # Fischer-Burmeister curvature restoration (violation side only).
    # Gauss-Newton drops the 2*c_fb*r*hess(r) term of the FB penalty; on
    # the r<0 side (force at distance / penetration) that term is PSD and
    # carries the stiffness that makes the optimizer respect a terrain
    # riser it is about to penetrate (without it the closed-loop box
    # climb stalls at the edge). hess_{ab}(FB) = (vv^T - s^2 I)/s^3 with
    # v = (a, b), s = sqrt(a^2 + b^2 + rho^2); chain through the exact
    # grad(a)/grad(b) rows the residual Jacobian already carries.
    a_v = r[..., nres - 2]
    b_v = r[..., nres - 1]
    s_v = jnp.sqrt(a_v * a_v + b_v * b_v
                   + (rho[:, None, None] ** 2))           # (B,H,4)
    m_v = 2.0 * wts.c_fb * jnp.minimum(r[..., 0], 0.0) / (s_v ** 3)
    Ja = J48f[..., nres - 2, :]                           # (B,H,4,48)
    Jb = J48f[..., nres - 1, :]
    c_aa = m_v * (a_v * a_v - s_v * s_v)
    c_bb = m_v * (b_v * b_v - s_v * s_v)
    c_ab = m_v * (a_v * b_v)
    Hm = Hm + (jnp.einsum("bhf,bhfa,bhfc->bhac", c_aa, Ja, Ja)
               + jnp.einsum("bhf,bhfa,bhfc->bhac", c_bb, Jb, Jb)
               + jnp.einsum("bhf,bhfa,bhfc->bhac", c_ab, Ja, Jb)
               + jnp.einsum("bhf,bhfa,bhfc->bhac", c_ab, Jb, Ja))

    # diagonal tracking terms (exact — the quadratics ARE their Hessian)
    track_h = 2.0 * jnp.concatenate([
        wts.q_pos, wts.q_eul, wts.q_vel, wts.q_omega,
        jnp.tile(wts.q_foot, 4),
        jnp.full((12,), wts.r_f * s_f * s_f, dtype),
        jnp.full((12,), wts.r_w, dtype)]).astype(dtype)
    zu = jnp.concatenate([Zs, Uh], axis=-1)
    ref_zu = jnp.concatenate([refs_z[:, :-1], refs_u[..., 0:12] / s_f,
                              refs_u[..., 12:24]], axis=-1)
    g = g + track_h * (zu - ref_zu)
    Hm = Hm + jnp.diag(track_h)
    return g, Hm


def _psd_solve_b(A, rhs):
    """Batched SPD solve: A (B,n,n), rhs (B,n,m) -> A^{-1} rhs."""
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), rhs)


@partial(jax.jit, static_argnames=("iters", "dt", "rho_min", "reg",
                                   "state_reg", "f_scale"))
def ci_solve_batched(z0, U0, refs_z, refs_u, terrain, mass, inertia_w,
                     mu, wts: CiWeights = None, f_mask=None, *, iters=16,
                     dt=0.02, rho0=0.5, rho_min=0.05, reg=1e-2,
                     state_reg=1e-1, f_scale=F0, wall=None):
    """Batch-native Gauss-Newton iLQR with an annealed complementarity
    relaxation — ONE solve for a whole scenario batch.

    Args:
      z0: (B, NZ) current states. U0: (B, H, NU) input warm starts.
      refs_z: (B, H+1, NZ) templates, refs_u: (B, H, NU).
      terrain: sim.terrain.Terrain, SHARED across the batch.
      mass, mu: scalars (shared). inertia_w: (B, 3, 3) world-frame at each
        scenario's yaw.
      f_mask: optional (B, H, 4).
      rho0: scalar or (B,) initial relaxation — per-scenario, so a
        warm-started scenario can skip the loose end of the anneal
        (cross-tick warm carry, make_ci_walk_policy).
      iters: fixed sweep count (anneal rho0 -> rho_min geometrically).

    Conditioning (f32): force channels are optimized in units of
    `f_scale` N so every control is O(1), and the gain solve uses
    state-space (Levenberg) regularization Quu + mu_x Fu'Fu — without
    both, the Riccati backward pass explodes through the strong
    feet->torque->attitude coupling and the tiny r_f curvature.

    Returns (U (B,H,NU), Z (B,H+1,NZ), cost (B,)) at the tightest
    relaxation.
    """
    dtype = z0.dtype
    B, H = U0.shape[0], U0.shape[1]
    if wts is None:
        wts = default_weights(dtype)
    if f_mask is None:
        f_mask = jnp.ones((B, H, 4), dtype)
    Iw_inv = jnp.linalg.inv(inertia_w)                     # (B,3,3)
    alphas = jnp.array([1.0, 0.5, 0.25, 0.05, 0.0], dtype)
    s_u = jnp.concatenate([jnp.full((12,), f_scale, dtype),
                           jnp.ones((12,), dtype)])        # u = s_u * uh
    rho0 = jnp.broadcast_to(jnp.asarray(rho0, dtype), (B,))

    eyeU = jnp.eye(NU, dtype=dtype)
    hT = 2.0 * jnp.concatenate([
        wts.q_pos, wts.q_eul, wts.q_vel,
        jnp.zeros((15,), dtype)]).astype(dtype)            # terminal diag

    def backward(Z, Uh, rho):
        Zs = Z[:, :-1]
        Fz, Fu = _dyn_jac_b(Zs, Uh, mass, Iw_inv, dt, f_scale)
        g, Hm = _quad_ggn_b(Zs, Uh, refs_z, refs_u, f_mask, terrain,
                            wall, wts, mu, rho, f_scale)
        Vx = hT * (Z[:, -1] - refs_z[:, -1])
        Vxx = jnp.broadcast_to(jnp.diag(hT), (B, NZ, NZ))

        def bstep(carry, inp):
            Vx, Vxx = carry
            fz, fu, gk, hk = inp
            fzT = jnp.swapaxes(fz, -1, -2)
            fuT = jnp.swapaxes(fu, -1, -2)
            VxxFz = jnp.einsum("bij,bjk->bik", Vxx, fz)
            VxxFu = jnp.einsum("bij,bjk->bik", Vxx, fu)
            Qx = gk[:, :NZ] + jnp.einsum("bji,bj->bi", fz, Vx)
            Qu = gk[:, NZ:] + jnp.einsum("bji,bj->bi", fu, Vx)
            Qxx = hk[:, :NZ, :NZ] + jnp.einsum("bij,bjk->bik", fzT, VxxFz)
            Quu = hk[:, NZ:, NZ:] + jnp.einsum("bij,bjk->bik", fuT, VxxFu)
            Qux = hk[:, NZ:, :NZ] + jnp.einsum("bij,bjk->bik", fuT, VxxFz)
            # Levenberg state-space regularization (Tassa'12): gains from
            # the mu_x-damped system; value update keeps the canonical
            # (unregularized) form. Tames the feet->attitude coupling.
            Quu_r = Quu + reg * eyeU + state_reg * jnp.einsum(
                "bij,bjk->bik", fuT, fu)
            Qux_r = Qux + state_reg * jnp.einsum("bij,bjk->bik", fuT, fz)
            sol = _psd_solve_b(
                Quu_r, jnp.concatenate([Qu[:, :, None], Qux_r], axis=2))
            kff = -sol[:, :, 0]
            K = -sol[:, :, 1:]
            # non-finite stage guard (per scenario): zero that stage's
            # correction rather than poisoning the whole sweep (line
            # search still vets cost)
            okk = (jnp.all(jnp.isfinite(kff), axis=-1)
                   & jnp.all(jnp.isfinite(K), axis=(-2, -1)))
            kff = jnp.where(okk[:, None], kff, 0.0)
            K = jnp.where(okk[:, None, None], K, 0.0)
            KT = jnp.swapaxes(K, -1, -2)
            QuxT = jnp.swapaxes(Qux, -1, -2)
            KtQuu = jnp.einsum("bij,bjk->bik", KT, Quu)
            Vx2 = (Qx + jnp.einsum("bij,bj->bi", KtQuu, kff)
                   + jnp.einsum("bij,bj->bi", KT, Qu)
                   + jnp.einsum("bij,bj->bi", QuxT, kff))
            Vxx2 = (Qxx + jnp.einsum("bij,bjk->bik", KtQuu, K)
                    + jnp.einsum("bij,bjk->bik", KT, Qux)
                    + jnp.einsum("bij,bjk->bik", QuxT, K))
            Vxx2 = 0.5 * (Vxx2 + jnp.swapaxes(Vxx2, -1, -2))
            okv = (jnp.all(jnp.isfinite(Vx2), axis=-1)
                   & jnp.all(jnp.isfinite(Vxx2), axis=(-2, -1)))
            Vx2 = jnp.where(okv[:, None], Vx2, Vx)
            Vxx2 = jnp.where(okv[:, None, None], Vxx2, Vxx)
            return (Vx2, Vxx2), (kff, K)

        stagewise = lambda x: jnp.swapaxes(x, 0, 1)        # (H,B,...)
        _, (kff, K) = jax.lax.scan(
            bstep, (Vx, Vxx),
            (stagewise(Fz), stagewise(Fu), stagewise(g), stagewise(Hm)),
            reverse=True)
        return stagewise(kff), stagewise(K)                # (B,H,...)

    def forward(Z, Uh, kff, K, alpha):
        def fstep(z, inp):
            zn, un, kf, Kk = inp
            u = un + alpha * kf + jnp.einsum("bij,bj->bi", Kk, z - zn)
            z2 = _dyn_b(z, u, mass, Iw_inv, dt, f_scale)
            return z2, (u, z2)
        stagewise = lambda x: jnp.swapaxes(x, 0, 1)
        _, (U2, Z1) = jax.lax.scan(
            fstep, Z[:, 0],
            (stagewise(Z[:, :-1]), stagewise(Uh), stagewise(kff),
             stagewise(K)))
        return (stagewise(U2),
                jnp.concatenate([Z[:, 0:1], stagewise(Z1)], axis=1))

    def sweep(carry, it):
        Uh, Z = carry
        frac = it / (iters - 1.0) if iters > 1 else 1.0
        rho = jnp.maximum(rho0 * (rho_min / rho0) ** frac,
                          rho_min).astype(dtype)           # (B,)
        kff, K = backward(Z, Uh, rho)

        # line search: alpha = 0 reproduces the nominal (Uh, Z) EXACTLY
        # (the feedback term vanishes along the nominal rollout), so the
        # no-improvement fallback is just another candidate — one vmapped
        # pass evaluates candidates and baseline, each costed directly on
        # the trajectory its forward pass just produced (no re-rollout)
        def try_alpha(alpha):
            U2, Z2 = forward(Z, Uh, kff, K, alpha)
            c = _traj_cost_b(Z2, s_u * U2, refs_z, refs_u, terrain, wts,
                             mu, rho, f_mask, wall)
            return U2, Z2, jnp.where(jnp.isfinite(c), c, jnp.inf)
        U2s, Z2s, cs = jax.vmap(try_alpha)(alphas)         # (A,B,...)
        best = jnp.argmin(cs, axis=0)                      # (B,)
        cbest = jnp.take_along_axis(cs, best[None, :], 0)[0]
        U_new = jnp.take_along_axis(U2s, best[None, :, None, None], 0)[0]
        Z_new = jnp.take_along_axis(Z2s, best[None, :, None, None], 0)[0]
        return (U_new, Z_new), cbest

    Uh0 = U0 / s_u
    Z0 = _rollout_b(z0, U0, mass, Iw_inv, dt)
    (Uh, Z), costs = jax.lax.scan(sweep, (Uh0, Z0),
                                  jnp.arange(iters, dtype=dtype))
    return s_u * Uh, Z, costs[-1]


@partial(jax.jit, static_argnames=("iters", "dt", "rho_min", "reg",
                                   "state_reg", "f_scale"))
def ci_solve(z0, U0, refs_z, refs_u, terrain, mass, inertia_w,
             mu, wts: CiWeights = None, f_mask=None, *, iters=16, dt=0.02,
             rho0=0.5, rho_min=0.05, reg=1e-2, state_reg=1e-1,
             f_scale=F0, wall=None):
    """Single-scenario Gauss-Newton iLQR — the B=1 view of
    `ci_solve_batched` (see there for the algorithm and conditioning
    notes).

    Args:
      z0: (NZ,) current state. U0: (H, NU) input warm start.
      refs_z: (H+1, NZ) template references, refs_u: (H, NU).
      terrain: sim.terrain.Terrain (the gap function's height field).
      mass, inertia_w: SRB params (inertia world-frame at current yaw).
      iters: fixed sweep count (anneal rho0 -> rho_min geometrically).

    Returns (U (H,NU), Z (H+1,NZ), cost) at the tightest relaxation.
    """
    fm = None if f_mask is None else f_mask[None]
    U, Z, cost = ci_solve_batched(
        z0[None], U0[None], refs_z[None], refs_u[None], terrain, mass,
        inertia_w[None], mu, wts, fm, iters=iters, dt=dt, rho0=rho0,
        rho_min=rho_min, reg=reg, state_reg=state_reg, f_scale=f_scale,
        wall=wall)
    return U[0], Z[0], cost[0]


def make_ci_reference(z0, t, terrain, params, velx=0.2, body_height=0.3,
                      gait_freq=None, swing_clearance=0.06, horizon=10,
                      dt_plan=0.02, offsets=(0.0, 0.5, 0.5, 0.0),
                      stance_frac=0.5):
    """Trot-template references (refs_z (H+1,NZ), refs_u (H,NU), and the
    input warm start U0). The template carries the PREFERRED gait rhythm
    and terrain-aware foothold arcs; complementarity against the real
    height field decides the actual contact (e.g. touchdown height on a
    box comes from the terrain, not from the template's flat-ground
    guess — both template foot z and warm-start forces are terrain-lifted
    here so the box is in the initial guess too)."""
    from legged_mpc_control_tpu.control import raibert
    from legged_mpc_control_tpu.ops import so3

    dtype = z0.dtype
    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)
    pos, eul, v = z0[0:3], z0[3:6], z0[6:9]
    feet0 = z0[12:24].reshape(4, 3)
    yaw = eul[2]
    Rz = so3.rot_z(yaw)
    v_d = Rz @ jnp.array([velx, 0.0, 0.0], dtype)

    # footholds: Raibert target, z snapped to the terrain
    target_abs, _ = raibert.raibert_footholds(
        pos, v, Rz, jnp.array([velx, 0.0, 0.0], dtype), params,
        terrain=terrain)
    target_world = target_abs + pos[None, :]
    tgt_h = terrain_mod.height_at(terrain, target_world[:, 0:2])
    target_world = target_world.at[:, 2].set(tgt_h)

    # template clock: offsets/stance_frac select the gait — (0,.5,.5,0)
    # at 0.5 is the diagonal trot; (0,.5,.75,.25) at 0.75 is the one-leg-
    # at-a-time crawl (the reference's standing_trot regime, gait.info)
    # that keeps >= 3 feet down for quasi-static riser climbs
    offs = jnp.asarray(offsets, dtype)
    ks = jnp.arange(horizon + 1, dtype=dtype)
    phase_k = jnp.mod((t + ks * dt_plan)[:, None] * gait_freq
                      + offs[None, :], 1.0)                 # (H+1, 4)
    stance_k = phase_k < stance_frac
    # complete the swing by 75% of the swing window: the template (and so
    # the plan) reaches the foothold with margin before the clock flips
    # the leg to stance — otherwise the plan foresees a support gap at
    # every touchdown (real feet land late by the PD tracking lag) and
    # compensates by pre-loading the outgoing diagonal, porpoising the
    # body (same margin as the distilled policy, mpc/lci_mpc.py)
    swing_s = jnp.clip((phase_k - stance_frac)
                       / (1.0 - stance_frac) / 0.75, 0.0, 1.0)

    # body reference: terrain-following height, approached at a BOUNDED
    # rate with the matching vertical velocity reference — an absolute
    # height target with v_ref_z = 0 makes the velocity-tracking term
    # veto its own position recovery (the plan then just sustains mg and
    # the height error persists); the convex path's reference builder
    # saturates the same way (mpc/reference.py)
    z_rate = jnp.asarray(0.3, dtype)                        # m/s
    pos_k = pos[None, :] + ks[:, None] * dt_plan * v_d[None, :]
    ground_k = terrain_mod.height_at(terrain, pos_k[:, 0:2])
    z_tgt = ground_k + body_height
    dz = z_tgt - pos[2]
    z_k = pos[2] + jnp.clip(dz, -z_rate * ks * dt_plan,
                            z_rate * ks * dt_plan)
    pos_k = pos_k.at[:, 2].set(z_k)
    vz_k = jnp.diff(z_k, append=z_k[-1:]) / dt_plan         # (H+1,)
    eul_k = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype) * yaw, (horizon + 1, 3))

    # foot reference: stance holds the (terrain-snapped) foothold, swing
    # arcs toward it. The arc's HEIGHT profile is anchored to the terrain
    # under liftoff/landing (ground0 -> target height + clearance bump),
    # NOT to the live foot z: a re-planned arc based on the current foot
    # would re-add clearance on top of wherever the foot already is, and
    # in closed loop that feedback ratchets the swing ever higher.
    hold = jnp.where(stance_k[0][:, None], feet0, target_world)
    ground0 = terrain_mod.height_at(terrain, feet0[:, 0:2])
    lerp = (feet0[None] * (1.0 - swing_s)[..., None]
            + target_world[None] * swing_s[..., None])     # (H+1,4,3)
    arc_z = ((1.0 - swing_s) * ground0[None]
             + swing_s * tgt_h[None]
             + swing_clearance * jnp.sin(jnp.pi * swing_s))
    swing_traj = lerp.at[..., 2].set(arc_z)
    feet_k = jnp.where(stance_k[..., None], hold[None], swing_traj)

    v_k = jnp.broadcast_to(v_d, (horizon + 1, 3))
    v_k = jnp.concatenate([v_k[:, 0:2], vz_k[:, None]], axis=1)
    refs_z = jnp.concatenate([
        pos_k, eul_k, v_k,
        jnp.zeros((horizon + 1, 3), dtype),
        feet_k.reshape(horizon + 1, -1)], axis=1)

    # input template/warm start: weight shared over template-stance feet,
    # foot velocities from the template foot-path differences
    n_st = jnp.maximum(jnp.sum(stance_k[:-1], axis=1), 1.0)
    fz0 = (params.mass * GRAV / n_st)[:, None] * stance_k[:-1]
    f_ref = jnp.zeros((horizon, 4, 3), dtype).at[:, :, 2].set(fz0)
    w_ref = (feet_k[1:] - feet_k[:-1]) / dt_plan
    refs_u = jnp.concatenate([f_ref.reshape(horizon, -1),
                              w_ref.reshape(horizon, -1)], axis=1)
    return refs_z, refs_u, refs_u


def _walk_prep(x, t, params, terrain, velx, body_height, gait_freq,
               horizon, dt_plan, offsets, stance_frac):
    """Unbatched per-scenario prep for the CI walk policy: state packing,
    trot-template references, world-yaw inertia, measured-support stage-0
    mask. Shared by the solo and the batched policy (vmapped there)."""
    from legged_mpc_control_tpu.ops import so3

    dtype = x.dtype
    pos, eul = x[0:3], x[3:6]
    foot_abs = x[6:18].reshape(4, 3)           # CoM-origin world axes
    v, omega = x[18:21], x[21:24]
    feet_w = foot_abs + pos[None, :]
    z0 = jnp.concatenate([pos, eul, v, omega, feet_w.reshape(-1)])

    refs_z, refs_u, U0 = make_ci_reference(
        z0, t, terrain, params, velx=velx, body_height=body_height,
        gait_freq=gait_freq, horizon=horizon, dt_plan=dt_plan,
        offsets=offsets, stance_frac=stance_frac)
    Rz = so3.rot_z(eul[2])
    inertia_w = Rz @ params.trunk_inertia.astype(dtype) @ Rz.T
    # stage 0 carries the MEASURED support: only feet that are down
    # (position gap or registered force — the force estimate lags a
    # touchdown by a tick) may push now; later stages plan freely
    gap0 = feet_w[:, 2] - terrain_mod.height_at(terrain, feet_w[:, 0:2])
    grounded_now = ((x[36:40] > 2.0) | (gap0 < 0.003)).astype(dtype)
    f_mask = jnp.ones((horizon, 4), dtype).at[0].set(grounded_now)
    return z0, refs_z, refs_u, U0, inertia_w, f_mask, grounded_now, feet_w


def _walk_post(U, Z, refs_z, grounded_now, feet_w, terrain, fz_min):
    """Unbatched per-scenario post-processing of a CI walk solve into the
    (78,) seam output (support gating, touchdown press, swing targets —
    see the inline rationale). Shared by the solo and batched policy."""
    dtype = U.dtype
    f0 = U[0, 0:12].reshape(4, 3)
    loaded = (f0[:, 2] > fz_min).astype(dtype)
    # execute force only through feet that BOTH the optimizer loads
    # AND the hardware/sim actually reports grounded — commanding
    # GRF through a foot millimetres in the air silently drops that
    # support and random-walks the attitude. Feet the plan loads but
    # that have not registered force yet get a bootstrap push so the
    # contact can establish (same two rules as the distilled policy,
    # mpc/lci_mpc.py make_walk_policy).
    support = loaded * grounded_now
    boot = (loaded * (1.0 - grounded_now))[:, None] \
        * jnp.array([0.0, 0.0, 2.0 * jnp.maximum(fz_min, 5.0)],
                    dtype)[None, :]
    u = (f0 * support[:, None] + boot).reshape(-1)

    # desired foot positions: the optimized path one planning step
    # ahead (world frame, the seam's optimized_state foot slots).
    # Execution fix-up around the contact boundary (the optimizer's
    # own z respects gap >= 0 exactly, so a raw target leaves the
    # foot hovering by the PD tracking error and contact flickers):
    #   loaded + already grounded -> hold the current foot position;
    #   loaded but still airborne -> aim 1 cm below the surface to
    #   drive the touchdown through;
    #   unloaded (swing)          -> the optimized arc as-is.
    foot_tgt = Z[1, 12:24].reshape(4, 3)
    g_tgt = terrain_mod.height_at(terrain, foot_tgt[:, 0:2])
    press = foot_tgt.at[:, 2].set(g_tgt - 0.01)
    stance_tgt = jnp.where(grounded_now[:, None] > 0.5, feet_w, press)
    foot_tgt = jnp.where(loaded[:, None] > 0.5, stance_tgt, foot_tgt)

    state_des = jnp.concatenate([refs_z[1, 0:3], refs_z[1, 3:6],
                                 foot_tgt.reshape(-1)])
    vel_des = jnp.concatenate([refs_z[1, 6:9], jnp.zeros(3, dtype),
                               U[0, 12:24]])
    return jnp.concatenate([u, state_des, vel_des, state_des,
                            jnp.zeros(12, dtype)])


def make_ci_walk_policy(params, terrain=None, velx=0.1, body_height=0.3,
                        gait_freq=2.5, horizon=10, dt_plan=0.02,
                        iters=32, fz_min=2.0, wts: CiWeights = None,
                        offsets=(0.0, 0.5, 0.5, 0.0), stance_frac=0.5,
                        rho_warm=0.15):
    """The contact-implicit engine as a STATEFUL LciMpc-seam policy
    `(x40, t, warm) -> ((78,), warm')` (reference: LciMpc.cpp:95-139
    exec_policy contract; the warm slot rides LciState.policy_warm).
    Each tick re-solves the CI trajectory optimization from the measured
    state, warm-started from the previous tick's solution — without the
    warm carry adjacent replans chatter between nearby local optima of
    the complementarity landscape and the executed forces flip, which is
    what destabilizes the gait. First-stage GRFs and the optimized foot
    path become the torque mapping / swing targets.

    rho_warm: optional initial complementarity relaxation for
    warm-started ticks (cold ticks keep rho0=0.5): a warm solution is
    already near the tight-relaxation optimum, so skipping the loose end
    of the anneal spends every sweep at relaxations that matter.

    Init the seam with `lci_init(dtype, policy_warm=policy.warm_init())`.
    """
    if terrain is None:
        terrain = terrain_mod.flat()
    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)

    def policy(x, t, warm):
        dtype = x.dtype
        (z0, refs_z, refs_u, U0, inertia_w, f_mask, grounded_now,
         feet_w) = _walk_prep(x, t, params, terrain, velx, body_height,
                              gait_freq, horizon, dt_plan, offsets,
                              stance_frac)
        # cross-tick warm start: previous tick's trajectory (the state
        # advanced only one 10 ms tick, under one plan stage — no shift)
        U0 = jnp.where(warm["valid"] > 0.5, warm["u"], U0)
        rho0 = (0.5 if rho_warm is None
                else jnp.where(warm["valid"] > 0.5, rho_warm, 0.5))
        U, Z, _cost = ci_solve(
            z0, U0, refs_z, refs_u, terrain, params.mass.astype(dtype),
            inertia_w, params.mu.astype(dtype), wts, f_mask, iters=iters,
            dt=dt_plan, rho0=rho0)
        out = _walk_post(U, Z, refs_z, grounded_now, feet_w, terrain,
                         fz_min)
        return out, {"u": U, "valid": jnp.ones((), dtype)}

    policy.ci_stateful = True
    policy.warm_init = lambda dtype=jnp.float32: {
        "u": jnp.zeros((horizon, NU), dtype),
        "valid": jnp.zeros((), dtype)}
    return policy


def make_ci_walk_policy_batched(params, terrain=None, velx=0.1,
                                body_height=0.3, gait_freq=2.5,
                                horizon=10, dt_plan=0.02, iters=24,
                                fz_min=2.0, wts: CiWeights = None,
                                offsets=(0.0, 0.5, 0.5, 0.0),
                                stance_frac=0.5, rho_warm=0.15):
    """Batch-native CI walk policy `(x (B,40), t, warm) -> ((B,78),
    warm')`: the per-scenario prep/post (`_walk_prep`/`_walk_post`) are
    vmapped, but the optimizer itself is ONE `ci_solve_batched` call —
    batch-in-lanes Cholesky gain solves, analytic Jacobians, per-foot
    Gauss-Newton quadratization — instead of a vmap of the solo solver.
    Plugs into `lci_mpc.lci_mpc_tick_batched` /
    `control.step.closed_loop_tick_lci_batched`.

    warm slot: {"u": (B, H, NU), "valid": (B,)}.
    """
    if terrain is None:
        terrain = terrain_mod.flat()
    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)

    def policy(x, t, warm):
        dtype = x.dtype
        t_b = jnp.broadcast_to(jnp.asarray(t, dtype), x.shape[:1])
        prep = jax.vmap(lambda xx, tt: _walk_prep(
            xx, tt, params, terrain, velx, body_height, gait_freq,
            horizon, dt_plan, offsets, stance_frac))
        (z0, refs_z, refs_u, U0, inertia_w, f_mask, grounded_now,
         feet_w) = prep(x, t_b)
        valid = warm["valid"] > 0.5                        # (B,)
        U0 = jnp.where(valid[:, None, None], warm["u"], U0)
        rho0 = jnp.where(valid, jnp.asarray(rho_warm, dtype),
                         jnp.asarray(0.5, dtype))
        U, Z, _cost = ci_solve_batched(
            z0, U0, refs_z, refs_u, terrain, params.mass.astype(dtype),
            inertia_w, params.mu.astype(dtype), wts, f_mask, iters=iters,
            dt=dt_plan, rho0=rho0)
        out = jax.vmap(lambda u_, z_, rz, gn, fw: _walk_post(
            u_, z_, rz, gn, fw, terrain, fz_min))(
            U, Z, refs_z, grounded_now, feet_w)
        return out, {"u": U, "valid": jnp.ones(x.shape[:1], dtype)}

    policy.ci_stateful = True
    policy.ci_batched = True
    policy.warm_init = lambda batch, dtype=jnp.float32: {
        "u": jnp.zeros((batch, horizon, NU), dtype),
        "valid": jnp.zeros((batch,), dtype)}
    return policy


def make_ci_lean_reference(z0, wall, feet_target, body_pos, body_eul,
                           params, terrain, horizon=10, dt_plan=0.02,
                           balance_pos=None, balance_feet=None):
    """Wall-lean hold template (reference capability: README.md:14 "lean
    against wall"): every stage holds the lean pose — body at
    (body_pos, body_eul), all four feet at feet_target (4,3), typically
    front feet ON the wall plane and rear feet on the ground.

    The input template splits gravity by which surface each target foot is
    closer to: ground feet share the weight vertically; wall feet get a
    wall-normal preload plus the friction share that vertical equilibrium
    needs — just a warm-start basin, the FB complementarity (with the
    blended wall/ground normal, `env_gap_normal`) owns the physics."""
    dtype = z0.dtype
    gap, n = env_gap_normal(terrain, wall, feet_target)
    on_wall = (terrain_mod.wall_gap(wall, feet_target)
               < feet_target[:, 2]
               - terrain_mod.height_at(terrain, feet_target[:, 0:2]))
    mg = params.mass.astype(dtype) * GRAV
    n_wall = jnp.maximum(jnp.sum(on_wall), 1).astype(dtype)
    n_ground = jnp.maximum(jnp.sum(~on_wall), 1).astype(dtype)
    f_wall_n = 20.0
    # EQUILIBRIUM-CONSISTENT template at the chosen wall-normal preload.
    # Wall-lean equilibria form a one-parameter family in the preload fn;
    # the template must be an actual member of it — the policy tracks the
    # template strongly (r_f), and tracking an inconsistent template (the
    # old zero-rear-friction one) leaves a net body wrench the closed
    # loop integrates into drift. Planar (x-z) static balance over
    # n_wall wall feet and n_ground ground feet (general stance, not
    # just the symmetric 2+2):
    #   fx_ground = -fn n_x n_wall/n_ground   (cancel the wall press)
    #   n_wall fw + n_ground fz = mg          (weight)
    #   n_wall r_wx fw + n_ground r_gx fz
    #       = n_wall fn (r_gz - r_wz)(-n_x)   (pitch torque)
    # solved for the wall-foot vertical share fw and ground load fz.
    # balance levers from the MEASURED pose when given (the policy passes
    # the contact-corrected feet + current CoM): the template is then an
    # equilibrium AT the current pose, so the only residual input is the
    # pose-tracking restoring gradient — a nominal-pose template leaves a
    # constant wrench error that the closed loop integrates into z/pitch
    # drift until the rear legs hit full extension
    body = jnp.asarray(body_pos if balance_pos is None else balance_pos,
                       dtype)
    bal_feet = feet_target if balance_feet is None else balance_feet
    r_w = jnp.sum(jnp.where(on_wall[:, None], bal_feet - body[None, :],
                            0.0), axis=0) / n_wall
    r_g = jnp.sum(jnp.where(on_wall[:, None], 0.0,
                            bal_feet - body[None, :]), axis=0) / n_ground
    nx = jnp.sum(jnp.where(on_wall[:, None], n, 0.0), axis=0)[0] / n_wall
    # 2x2 solve in the aggregates a = n_wall*fw, b = n_ground*fz:
    #   [1, 1; r_wx, r_gx] [a, b] = [mg, c2]
    c2 = n_wall * f_wall_n * (r_g[2] - r_w[2]) * (-nx)
    det = r_g[0] - r_w[0]
    # sign-PRESERVING degenerate-geometry clamp: substituting a fixed
    # +eps for small |det| flips the solve's sign when det is small and
    # positive, landing fw on the wrong friction-cone bound
    safe_det = jnp.where(jnp.abs(det) < 1e-6,
                         jnp.where(det < 0, -1e-6, 1e-6), det)
    a = (c2 - r_g[0] * mg) / (-safe_det)
    fw = jnp.clip(a / n_wall, -0.9 * params.mu.astype(dtype) * f_wall_n,
                  0.9 * params.mu.astype(dtype) * f_wall_n)
    fz_g = (mg - n_wall * fw) / n_ground
    f_wall = f_wall_n * n + jnp.array([0.0, 0.0, 1.0], dtype)[None, :] * fw
    f_ground = jnp.zeros((4, 3), dtype) \
        .at[:, 0].set(-f_wall_n * nx * n_wall / n_ground) \
        .at[:, 2].set(fz_g)
    f0 = jnp.where(on_wall[:, None], f_wall, f_ground)

    # restoring reference velocity toward the nominal pose: with zero
    # velocity refs the velocity-damped plan HOVERS at whatever pose the
    # tick starts from, so any realized-force bias (compliant-contact
    # surplus in the articulated sim) integrates into unbounded z/x drift
    # — the closed loop rode that drift into rear-leg full extension and
    # fell. A clipped proportional velocity reference turns the pose
    # error into commanded motion the very first stage executes.
    pos_err = jnp.asarray(body_pos, dtype) - z0[0:3]
    eul_err = jnp.asarray(body_eul, dtype) - z0[3:6]
    v_ref = jnp.clip(1.5 * pos_err, -0.15, 0.15)
    om_ref = jnp.clip(2.0 * jnp.stack([eul_err[0], eul_err[1],
                                       eul_err[2]]), -0.3, 0.3)
    zr = jnp.concatenate([
        jnp.asarray(body_pos, dtype), jnp.asarray(body_eul, dtype),
        v_ref, om_ref, feet_target.reshape(-1)])
    refs_z = jnp.tile(zr[None], (horizon + 1, 1))
    refs_u = jnp.tile(
        jnp.concatenate([f0.reshape(-1), jnp.zeros(12, dtype)])[None],
        (horizon, 1))
    return refs_z, refs_u, refs_u


def make_ci_lean_policy(params, wall, feet_target, body_pos, body_eul,
                        terrain=None, horizon=10, dt_plan=0.02, iters=24,
                        fz_min=2.0, wts: CiWeights = None,
                        wall_press_m=None):
    """The contact-implicit engine holding a wall-lean as an LciMpc-seam
    policy `(x40, t, warm) -> ((78,), warm')` — same seam contract as
    `make_ci_walk_policy`. Each tick re-solves the CI optimization from
    the measured state against the ground+wall environment; the per-foot
    contact normal (and with it the friction geometry that lets wall feet
    carry weight through friction) comes out of `env_gap_normal`, not a
    schedule."""
    from legged_mpc_control_tpu.ops import so3

    if terrain is None:
        terrain = terrain_mod.flat()
    if wts is None:
        # lean-specific weights (validated in tests/test_ci_wall_lean.py):
        #  * r_f 10x: the lean needs REAL input tracking toward the
        #    preloaded template — wall-lean equilibria form a
        #    one-parameter family in the wall-normal preload, and the
        #    minimal-force member (which a weak ||u||^2 preference
        #    selects) SATURATES the friction cone (fw = mu*fn exactly),
        #    so the wall feet creep down the wall in closed loop;
        #  * roll weight 150: the two-surface stance couples roll into
        #    wall-foot load asymmetry — the foot that picks up extra
        #    vertical share hits its cone first and starts the slide.
        wts = default_weights()._replace(
            r_f=jnp.asarray(1e-2),
            q_eul=jnp.asarray([150.0, 60.0, 60.0]))
    if wall_press_m is None:
        # the plane-pinned press FORCE scales with the joint-space kp the
        # PD applies across the pin depth, so normalize the preload — not
        # the depth — across robots (A1 kp 15 -> 2 mm, Go1's hardware
        # kp 30 -> 1 mm): a fixed 2 mm at Go1's stiffer gains over-presses
        # the wall beyond what rear-foot friction can cancel and the body
        # slides backward off the lean (x drifts, press escalates, falls)
        import numpy as _np
        press_m = 0.03 / float(_np.mean(_np.asarray(params.kp_foot)))
    else:
        press_m = float(wall_press_m)

    def policy(x, t, warm):
        dtype = x.dtype
        pos, eul = x[0:3], x[3:6]
        foot_abs = x[6:18].reshape(4, 3)
        v, omega = x[18:21], x[21:24]
        feet_w = foot_abs + pos[None, :]

        gap0, n0 = env_gap_normal(terrain, wall, feet_w)
        # contact gate at 15 mm (vs the walk policy's 3 mm): wall feet
        # read ~0 on the world-z force sensor (wb_read_sensors docstring),
        # so geometry is the ONLY contact evidence for them — and the
        # controller's deliberately-mismatched leg kinematics projects
        # up to ~11 mm of wall-gap bias at the lean's extended front-leg
        # pose (measured on Go1: true foot at 1.3 mm penetration reads a
        # 10 mm gap). A tight gate left Go1's wall feet permanently
        # "airborne": the planned wall press never executed (only the
        # bootstrap push did) and the uncancelled wall reaction slid the
        # robot backward off the lean. Generous is safe HERE because the
        # lean keeps all four feet in sustained contact — there is no
        # swing phase to mis-gate.
        grounded_now = ((x[36:40] > 2.0) | (gap0 < 0.015)).astype(dtype)
        # contact-aided foot correction: feet known to be in contact are
        # snapped onto the environment surface along the contact normal
        # before the solve. The measured FK carries a systematic few-mm
        # bias (the controller's leg geometry is deliberately mismatched
        # from the simulated robot's, sim/wb_sim.wb_rho_fix) which the
        # convex path shrugs off (millimeters barely move torque arms) but
        # complementarity reads as real penetration — the optimizer is
        # then REWARDED for loading "penetrating" feet and lifting the
        # body, which is exactly the runaway that killed the closed-loop
        # lean. Same principle as the estimator's contact-gated foot
        # height measurement (estimation/basic_kf.py; reference:
        # BasicKF.cpp:129-130).
        feet_corr = feet_w - (grounded_now * gap0)[:, None] * n0
        z0 = jnp.concatenate([pos, eul, v, omega, feet_corr.reshape(-1)])

        tgt = jnp.asarray(feet_target, dtype)
        refs_z, refs_u, U0 = make_ci_lean_reference(
            z0, wall, tgt, body_pos, body_eul, params, terrain,
            horizon=horizon, dt_plan=dt_plan,
            balance_pos=pos, balance_feet=feet_corr)
        Rz = so3.rot_z(eul[2])
        inertia_w = Rz @ params.trunk_inertia.astype(dtype) @ Rz.T
        f_mask = jnp.ones((horizon, 4), dtype).at[0].set(grounded_now)
        U0 = jnp.where(warm["valid"] > 0.5, warm["u"], U0)
        U, Z, _cost = ci_solve(
            z0, U0, refs_z, refs_u, terrain, params.mass.astype(dtype),
            inertia_w, params.mu.astype(dtype), wts, f_mask, iters=iters,
            dt=dt_plan, wall=wall)

        f0 = U[0, 0:12].reshape(4, 3)
        fn0 = jnp.sum(f0 * n0, axis=-1)
        loaded = (fn0 > fz_min).astype(dtype)
        support = loaded * grounded_now
        boot = (loaded * (1.0 - grounded_now))[:, None] \
            * (2.0 * jnp.maximum(fz_min, 5.0)) * n0
        u = (f0 * support[:, None] + boot).reshape(-1)

        # stance fix-up. Ground feet hold their measured position (the
        # walk policy's rule); wall feet instead PD-press a target pinned
        # 2 mm INSIDE the wall plane — holding the measured position of a
        # foot against the stiff wall turns contact chatter into command
        # chatter, while a plane-pinned press gives a steady spring preload
        # and a PD-velocity-limited approach (no damping impulse on
        # touchdown, which is what knocks the body off the lean
        # equilibrium).
        gap_w0 = terrain_mod.wall_gap(wall, feet_w)
        gap_g0 = feet_w[:, 2] - terrain_mod.height_at(terrain,
                                                      feet_w[:, 0:2])
        on_wall0 = gap_w0 < gap_g0
        n_w = wall.normal.astype(dtype)
        foot_tgt = Z[1, 12:24].reshape(4, 3)
        # for a foot already judged in contact, the measured wall gap is
        # kinematic-mismatch PHANTOM (up to ~11 mm on Go1) — driving the
        # PD through it multiplies the press by kp x phantom-depth and
        # the uncancelled excess shoves the body off the lean. Grounded
        # feet press only press_m beyond their MEASURED position; only
        # genuinely airborne feet close their full gap.
        drive = jnp.where(grounded_now > 0.5, 0.0, gap_w0)
        press_wall = feet_w - (drive + press_m)[:, None] * n_w[None, :]
        press_gnd = foot_tgt - 0.01 * n0
        stance_tgt = jnp.where(grounded_now[:, None] > 0.5, feet_w,
                               press_gnd)
        stance_tgt = jnp.where(on_wall0[:, None], press_wall, stance_tgt)
        foot_tgt = jnp.where(loaded[:, None] > 0.5, stance_tgt, foot_tgt)

        state_des = jnp.concatenate([refs_z[1, 0:3], refs_z[1, 3:6],
                                     foot_tgt.reshape(-1)])
        vel_des = jnp.concatenate([refs_z[1, 6:9], jnp.zeros(3, dtype),
                                   U[0, 12:24]])
        out = jnp.concatenate([u, state_des, vel_des, state_des,
                               jnp.zeros(12, dtype)])
        return out, {"u": U, "valid": jnp.ones((), dtype)}

    policy.ci_stateful = True
    policy.warm_init = lambda dtype=jnp.float32: {
        "u": jnp.zeros((horizon, NU), dtype),
        "valid": jnp.zeros((), dtype)}
    return policy
