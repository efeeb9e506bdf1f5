"""Damped-least-squares inverse kinematics on the full floating-base model.

Equivalent of the reference's `LeggedIKSolver` (reference:
src/legged_ctrl/src/utils/LeggedIKSolver.cpp:129-160 — numerical DLS IK on
the Pinocchio model with Levenberg damping 1e-9, up to 50 iterations, stop
tolerance 1e-4, warm-started from the previous solution, used by
`wbc_update`'s workspace swing mode, BaseInterface.cpp:536-542).

Differences by design (not by omission):
- the iteration is a fixed-trip `lax.scan` with a convergence *mask* instead
  of an early `break` — branchless, so it jits and `vmap`s over scenarios;
  converged instances simply stop moving (delta is gated to zero).
- the Jacobian comes from `jax.jacfwd` of the whole-body FK
  (models/whole_body.py) instead of Pinocchio.

The analytic 3-DoF IK (models/kinematics.py `ik`) remains the fast path for
the live controller, exactly as the reference uses A1Kinematics::inv_kin in
tau_ctrl_update and keeps LeggedIKSolver for the WBC path.
"""

from functools import partial

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu.models import whole_body as wb

DAMPING = 1e-6      # Levenberg damping (reference uses 1e-9 in f64;
                    # slightly larger for f32 conditioning)
EPS = 1e-4          # stop tolerance on the position residual
MAX_ITERS = 50


@partial(jax.jit, static_argnames=("iters",))
def ik_feet(q_init, base_pose, foot_pos_world_des, model: wb.WbModel,
            iters: int = MAX_ITERS, damping: float = DAMPING,
            eps: float = EPS):
    """Solve joint angles so all four feet reach world targets.

    Args:
      q_init: (12,) warm-start joint angles (FL,FR,RL,RR x HAA,HFE,KFE).
      base_pose: (6,) [base pos(3), euler (yaw,pitch,roll)] — held fixed;
        only the 12 joint coordinates iterate, like the reference masks its
        DLS update to the leg block.
      foot_pos_world_des: (4,3) desired world foot positions.
    Returns (q (12,), err (4,3) final residual, converged bool).
    """
    dtype = q_init.dtype
    base_pose = base_pose.astype(dtype)

    def residual(qj):
        qfull = jnp.concatenate([base_pose, qj])
        return foot_pos_world_des - wb.foot_positions(qfull, model)  # (4,3)

    def body(carry, _):
        qj, done = carry
        err = residual(qj)                                  # (4,3)
        J = jax.jacfwd(residual)(qj)                        # (4,3,12)
        Jf = -J.reshape(12, 12)                             # d(foot)/d(qj)
        e = err.reshape(12)
        # DLS step: dq = J^T (J J^T + lambda I)^-1 e
        JJt = Jf @ Jf.T + damping * jnp.eye(12, dtype=dtype)
        dq = Jf.T @ jnp.linalg.solve(JJt, e)
        new_done = jnp.linalg.norm(e) < eps
        qj = jnp.where(done, qj, qj + dq)
        return (qj, done | new_done), None

    (qj, done), _ = jax.lax.scan(body, (q_init, jnp.zeros((), bool)),
                                 None, length=iters)
    err = residual(qj)
    converged = jnp.linalg.norm(err.reshape(-1)) < eps
    return qj, err, converged


@partial(jax.jit, static_argnames=("iters",))
def ik_single_leg(q_leg_init, base_pose, leg, foot_pos_world_des,
                  model: wb.WbModel, q_other=None,
                  iters: int = MAX_ITERS, damping: float = DAMPING,
                  eps: float = EPS):
    """Per-leg variant (3 DoF) — the reference's `solveIK` operates on one
    3-joint block at a time (LeggedIKSolver.cpp:129-160).

    leg is a static python int in {0,1,2,3}. q_other: (12,) full joint
    vector supplying the other legs' angles (defaults to zeros).
    """
    dtype = q_leg_init.dtype
    if q_other is None:
        q_other = jnp.zeros(12, dtype=dtype)

    def residual(qleg):
        qj = jax.lax.dynamic_update_slice(q_other, qleg, (3 * leg,))
        qfull = jnp.concatenate([base_pose.astype(dtype), qj])
        feet = wb.foot_positions(qfull, model)
        return foot_pos_world_des - feet[leg]

    def body(carry, _):
        qleg, done = carry
        e = residual(qleg)
        J = -jax.jacfwd(residual)(qleg)                     # (3,3)
        JJt = J @ J.T + damping * jnp.eye(3, dtype=dtype)
        dq = J.T @ jnp.linalg.solve(JJt, e)
        new_done = jnp.linalg.norm(e) < eps
        qleg = jnp.where(done, qleg, qleg + dq)
        return (qleg, done | new_done), None

    (qleg, done), _ = jax.lax.scan(body, (q_leg_init, jnp.zeros((), bool)),
                                   None, length=iters)
    err = residual(qleg)
    return qleg, err, jnp.linalg.norm(err) < eps
