"""Convex-MPC tick orchestrator.

Functional equivalent of `ConvexMpc::update`
(reference: src/legged_ctrl/src/mpc_ctrl/convex_mpc/ConvexMpc.cpp:24-108):
joystick-command filtering, per-leg gait FSM stepping, QP construction +
solve, and packing of `optimized_state` / `optimized_input` for the
low-level controller.

The tick is split into `mpc_prepare` (everything up to the QP) and
`mpc_finish` (packing after the GRF solve) so a scenario batch can vmap the
cheap build/pack stages while the solve runs once for the whole batch
through the *explicitly-batched* solvers — `riccati.solve_qp_riccati_batched`
(the default), `pdip.solve_qp_pdip_batched`, `admm.solve_qp_admm_batched`.
"""

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.mpc import admm, gait as gait_mod
from legged_mpc_control_tpu.mpc import pdip, qp_builder, reference, riccati
from legged_mpc_control_tpu.ops.filters import moving_window_update
from legged_mpc_control_tpu.types import ControllerState


class StageQP(NamedTuple):
    """Stagewise MPC QP data (pre-condensation). The Riccati solver
    consumes this directly; the condensed solvers derive (P, q) from it."""
    x0: jnp.ndarray          # (12,)
    x_ref: jnp.ndarray       # (H, 12)
    A_seq: jnp.ndarray       # (H, 12, 12)
    B: jnp.ndarray           # (12, 12)
    contact: jnp.ndarray     # (H, 4)
    q_weights: jnp.ndarray   # (12,)
    r_weights: jnp.ndarray   # (12,)
    mu: jnp.ndarray          # scalar
    fz_max: jnp.ndarray      # scalar


def mpc_prepare(state: ControllerState, params: RobotParams,
                pattern: gait_mod.GaitPattern, dt, *,
                horizon: int) -> Tuple[ControllerState, StageQP]:
    """Everything before the QP solve: joystick filtering, gait stepping,
    contact prediction, reference + linearization
    (reference: ConvexMpc.cpp:33-108 minus the solve at :64-78).

    Returns (state with ctrl/gait/filters updated, StageQP)."""
    fbk, ctrl, joy = state.fbk, state.ctrl, state.joy
    dtype = fbk.root_pos.dtype
    legs = jnp.arange(4, dtype=jnp.int32)

    # --- joystick command processing (reference: ConvexMpc.cpp:33-38) ---
    vfx, velx_f = moving_window_update(state.vel_filter_x, joy.velx)
    vfy, vely_f = moving_window_update(state.vel_filter_y, joy.vely)
    ctrl = ctrl.replace(
        root_pos_d=ctrl.root_pos_d.at[2].set(joy.body_height),
        root_lin_vel_d_rel=ctrl.root_lin_vel_d_rel
        .at[0].set(velx_f).at[1].set(vely_f),
        root_ang_vel_d_rel=ctrl.root_ang_vel_d_rel.at[2].set(joy.yaw_rate),
        root_euler_d=ctrl.root_euler_d.at[2].add(joy.yaw_rate * dt),
    )

    # --- foot update (reference: ConvexMpc.cpp:80-108) ---
    standing = ctrl.movement_mode == 0
    gait_reset = jax.vmap(
        gait_mod.gait_leg_reset, in_axes=(0, None, 0))(
        state.gait, pattern, legs)
    gait_upd = jax.vmap(
        gait_mod.gait_leg_update,
        in_axes=(0, None, 0, None, None, 0, 0, 0))(
        state.gait, pattern, legs, dt, params.gait_counter_speed,
        fbk.foot_pos_world, ctrl.foot_pos_target_world,
        fbk.foot_contact_bool)
    new_gait = jax.tree.map(
        lambda a, b: jnp.where(standing, a, b), gait_reset, gait_upd)

    plan_contacts = jnp.where(
        standing, jnp.ones(4, dtype=dtype),
        jax.vmap(gait_mod.get_contact_state)(gait_upd))
    ctrl = ctrl.replace(plan_contacts=plan_contacts)

    # --- QP construction (reference: ConvexMpc.cpp:64-78 build half) ---
    cmd = reference.MpcCmd(
        root_pos_d=ctrl.root_pos_d,
        root_euler_d=ctrl.root_euler_d,
        root_lin_vel_d_rel=ctrl.root_lin_vel_d_rel,
        root_ang_vel_d_rel=ctrl.root_ang_vel_d_rel,
    )
    x_ref, yaw_ref, _ = reference.build_reference(
        fbk.root_euler, fbk.root_pos, fbk.root_rot_mat, cmd, horizon, dt)
    A_seq, B = reference.build_linearization(
        yaw_ref, params.mass, params.trunk_inertia, fbk.root_rot_mat,
        fbk.foot_pos_abs, dt)

    # contact schedule down the horizon: step 0 from current plan, future
    # steps from FSM phase prediction (reference: ConvexQPSolver.cpp:329-346)
    ks = jnp.arange(1, horizon, dtype=dtype) * dt
    future = jax.vmap(
        lambda t: jax.vmap(
            gait_mod.predict_contact_state, in_axes=(0, None, 0, None, None))(
            new_gait, pattern, legs, t, params.gait_counter_speed))(ks)
    future = jnp.where(standing, jnp.ones_like(future), future)
    contact = jnp.concatenate([plan_contacts[None, :], future], axis=0)

    x0 = jnp.concatenate([fbk.root_euler, fbk.root_pos,
                          fbk.root_ang_vel, fbk.root_lin_vel])
    stage = StageQP(
        x0=x0, x_ref=x_ref, A_seq=A_seq, B=B, contact=contact,
        q_weights=jnp.asarray(params.q_weights, dtype),
        r_weights=jnp.asarray(params.r_weights, dtype),
        mu=jnp.asarray(params.mu, dtype),
        fz_max=jnp.asarray(params.fz_max, dtype))

    state = state.replace(
        ctrl=ctrl, gait=new_gait,
        vel_filter_x=vfx, vel_filter_y=vfy)
    return state, stage


def mpc_finish(state: ControllerState, grf) -> ControllerState:
    """Pack the solved GRFs + FSM foot targets into optimized_state/input
    (reference: ConvexMpc.cpp:49-57)."""
    ctrl = state.ctrl
    foot_targets = state.gait.target_pos          # (4,3) FSM world targets
    foot_vels = state.gait.target_vel
    optimized_state = jnp.concatenate(
        [ctrl.root_pos_d, ctrl.root_euler_d, foot_targets.reshape(-1)])
    optimized_input = jnp.concatenate([grf, foot_vels.reshape(-1)])
    ctrl = ctrl.replace(optimized_state=optimized_state,
                        optimized_input=optimized_input)
    return state.replace(ctrl=ctrl, mpc_inited=jnp.ones((), dtype=bool))


def build_condensed_from_stage(stage: StageQP, dt):
    """Condense one StageQP into the dense (P, q) form (qp_builder.py)."""
    return qp_builder.build_condensed_qp(
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, dt)


def mpc_tick(state: ControllerState, params: RobotParams,
             pattern: gait_mod.GaitPattern, dt, *,
             horizon: int, pdip_iters: int = 18) -> ControllerState:
    """One MPC update (reference 100 Hz thread body, ConvexMpc.cpp:24-62).

    Single-scenario path (CLI / hardware loop). Batched rollouts should use
    `mpc_tick_batched` so the whole batch shares one solver call."""
    state, stage = mpc_prepare(state, params, pattern, dt, horizon=horizon)
    qp = build_condensed_from_stage(stage, dt)
    res = pdip.solve_qp_pdip(qp.P, qp.q, qp.mu, qp.fz_max,
                             contact=qp.contact, iters=pdip_iters)
    grf = res.u[0:12]
    # NaN guard (reference: ConvexQPSolver.cpp:321-326)
    grf = jnp.where(jnp.any(jnp.isnan(grf)), jnp.zeros_like(grf), grf)
    return mpc_finish(state, grf)


def mpc_tick_batched(states: ControllerState, params: RobotParams,
                     pattern: gait_mod.GaitPattern, dt, *,
                     horizon: int, iters: int = 15,
                     solver: str = "riccati", warm=None
                     ) -> Tuple[ControllerState, Optional[tuple]]:
    """Batched MPC tick: vmap the QP build/pack, solve the whole scenario
    batch in ONE explicitly-batched solver call.

    Args:
      states: ControllerState with a leading scenario axis on every leaf.
      params: RobotParams with a leading scenario axis on every leaf
        (broadcast shared leaves with `parallel.runner.broadcast_params`).
      solver: "riccati" (default — the stagewise IPM), "pdip" (condensed
        dense IPM), or "admm" (OSQP-equivalent).
      warm: previous tick's warm state, mirroring the reference's
        `setWarmStart(true)` (ConvexQPSolver.cpp:185) —
        solver="admm": the ADMM warm tuple; solver="riccati"/"pdip": the
        previous (B, 12H) solution, shift-aligned here to this tick's
        schedule and used as an interior-point primal warm start.

    Returns (states', warm') where warm' carries to the next tick's call
    (None only for cold riccati/pdip requests where warm was None and the
    caller never carries it — warm' is always returned for reuse).
    """
    states, stage = jax.vmap(
        lambda s, p: mpc_prepare(s, p, pattern, dt, horizon=horizon)
    )(states, params)

    if solver == "riccati":
        wu = None if warm is None else riccati.warm_shift(warm, stage.contact)
        res = riccati.solve_qp_riccati_batched(
            stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, dt,
            iters=iters, warm_u=wu)
        warm_out = res.u
    elif solver == "admm":
        qp = jax.vmap(lambda s: build_condensed_from_stage(s, dt))(stage)
        res = admm.solve_qp_admm_batched(
            qp.P, qp.q, qp.mu, qp.fz_max, qp.contact,
            iters=iters, warm=warm)
        warm_out = res.warm
    else:
        qp = jax.vmap(lambda s: build_condensed_from_stage(s, dt))(stage)
        wu = None if warm is None else riccati.warm_shift(warm, qp.contact)
        res = pdip.solve_qp_pdip_batched(
            qp.P, qp.q, qp.mu, qp.fz_max, qp.contact,
            iters=iters, warm_u=wu)
        warm_out = res.u

    grf = res.u[:, 0:12]
    # per-scenario NaN guard (reference: ConvexQPSolver.cpp:321-326)
    bad = jnp.any(jnp.isnan(grf), axis=-1, keepdims=True)
    grf = jnp.where(bad, jnp.zeros_like(grf), grf)
    states = jax.vmap(mpc_finish)(states, grf)
    return states, warm_out
