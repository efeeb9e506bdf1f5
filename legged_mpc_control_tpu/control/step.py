"""The fused control step: the reference's three threads as one pure function.

The reference runs MPC (100 Hz), low-level control (800 Hz) and
feedback/estimation (800 Hz) as free-running threads over a racy blackboard
(reference: main.cpp:110-256). Here one MPC "tick" is a pure function:

    tick = [ mpc_tick ; scan of 8 x (sense -> estimate -> raibert ->
             tau_ctrl -> safety -> PD -> sim step) ]

compiled under `jit`, batched over scenarios with `vmap`, rolled out in time
with `lax.scan`. The 8:1 rate ratio is the reference's
MPC_UPDATE_FREQUENCY / LOW_LEVEL_CTRL_FREQUENCY (LeggedParams.h:7-8).
"""

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu import constants as C
from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.control import low_level, raibert, safety, sensors
from legged_mpc_control_tpu.estimation import basic_kf, ekf as ekf_mod
from legged_mpc_control_tpu.mpc import convex_mpc, gait as gait_mod
from legged_mpc_control_tpu.ops import filters
from legged_mpc_control_tpu.sim import srb_sim
from legged_mpc_control_tpu.types import (
    ControllerState,
    init_ctrl,
    init_feedback,
    init_joy,
)


@pytree.dataclass
class LoopState:
    """Carry of the closed-loop rollout: controller + simulated world."""
    controller: ControllerState
    sim: srb_sim.SimState


def controller_init(params: RobotParams, dtype=jnp.float32,
                    body_height=0.3) -> ControllerState:
    window = int(1000.0 * C.MPC_DT * 0.3)   # reference: ConvexMpc.cpp:19-20
    legs = jnp.arange(4, dtype=jnp.int32)
    pattern = gait_mod.trot_pattern(dtype)
    return ControllerState(
        fbk=init_feedback(dtype),
        ctrl=init_ctrl(dtype),
        joy=init_joy(dtype, body_height),
        gait=jax.vmap(gait_mod.gait_leg_init, in_axes=(None, 0, None))(
            pattern, legs, dtype),
        kf=basic_kf.KfState(
            x=jnp.zeros(18, dtype=dtype),
            P=jnp.eye(18, dtype=dtype) * 3.0,
            initialized=jnp.zeros((), dtype=bool)),
        ekf=ekf_mod.EkfState(
            x=jnp.zeros(ekf_mod.STATE_SIZE, dtype=dtype),
            P=jnp.eye(ekf_mod.STATE_SIZE, dtype=dtype),
            initialized=jnp.zeros((), dtype=bool)),
        vel_filter_x=filters.moving_window_init(window, dtype=dtype),
        vel_filter_y=filters.moving_window_init(window, dtype=dtype),
        estimation_inited=jnp.zeros((), dtype=bool),
        mpc_inited=jnp.zeros((), dtype=bool),
    )


def feedback_update(cs: ControllerState, sensors_raw, params: RobotParams,
                    dt, use_ground_truth: bool = True,
                    kf_type: int = None, terrain=None) -> ControllerState:
    """Feedback-thread body: ingest raw sensors, run FK + contact detection +
    state estimation (reference: BaseInterface::fbk_update -> sensor_update ->
    estimation_update, BaseInterface.cpp:212-449).

    kf_type dispatch mirrors the reference (BaseInterface.cpp:404-449):
    0 = ground-truth bypass (sim only), 1 = linear BasicKF, 2 = EKF with
    attitude in the state (CasadiEKF surface). `use_ground_truth` is the
    legacy boolean alias for kf_type 0 vs 1.
    """
    if kf_type is None:
        kf_type = 0 if use_ground_truth else 1
    use_ground_truth = kf_type == 0
    fbk = cs.fbk.replace(
        root_quat=sensors_raw["quat"],
        imu_acc=sensors_raw["imu_acc"],
        imu_ang_vel=sensors_raw["imu_ang_vel"],
        joint_pos=sensors_raw["joint_pos"],
        joint_vel=sensors_raw["joint_vel"],
        foot_force_sensor=sensors_raw["foot_force_sensor"],
        joint_tau_est=sensors_raw.get("joint_tau_est",
                                      cs.fbk.joint_tau_est),
    )
    if use_ground_truth:
        # kf_type 0 bypass (reference: GazeboInterface.cpp:124-141)
        fbk = fbk.replace(root_pos=sensors_raw["pos"],
                          root_lin_vel=sensors_raw["vel"])
    fbk = sensors.sensor_update(fbk, params,
                                joint_ang_tgt=cs.ctrl.joint_ang_tgt,
                                joint_vel_tgt=cs.ctrl.joint_vel_tgt)

    kf = cs.kf
    ekf = cs.ekf
    est_inited = jnp.ones((), dtype=bool)
    if kf_type == 1:
        # linear KF path, kf_type 1 (reference: BaseInterface.cpp:407-413)
        kf_fresh = basic_kf.kf_init(fbk.root_rot_mat, fbk.foot_pos_rel,
                                    dtype=fbk.root_pos.dtype)
        contacts = jnp.where(cs.ctrl.movement_mode == 0,
                             jnp.ones(4, dtype=fbk.root_pos.dtype),
                             fbk.foot_contact_flag)
        kf_stepped, pos_est, vel_est = basic_kf.kf_update(
            kf, dt, fbk.root_rot_mat, fbk.imu_acc, fbk.imu_ang_vel,
            fbk.foot_pos_rel, fbk.foot_vel_rel, contacts)
        first = ~kf.initialized
        kf = jax.tree.map(
            lambda a, b: jnp.where(first, a, b), kf_fresh, kf_stepped)
        fbk = fbk.replace(
            root_pos=jnp.where(first, fbk.root_pos, pos_est),
            root_lin_vel=jnp.where(first, fbk.root_lin_vel, vel_est),
            estimated_contacts=contacts,
        )
    elif kf_type == 2:
        # EKF path, kf_type 2 (reference: BaseInterface.cpp:414-446) —
        # attitude is estimated too, so root_euler/quat come from the filter
        from legged_mpc_control_tpu.ops import so3 as _so3

        ekf_fresh = ekf_mod.ekf_init(fbk.root_quat, fbk.root_pos,
                                     fbk.foot_pos_rel,
                                     dtype=fbk.root_pos.dtype)
        contacts = jnp.where(cs.ctrl.movement_mode == 0,
                             jnp.ones(4, dtype=fbk.root_pos.dtype),
                             fbk.foot_contact_flag)
        ekf_stepped, pos_est, vel_est, eul_est = ekf_mod.ekf_update(
            ekf, dt, fbk.imu_acc, fbk.imu_ang_vel,
            fbk.foot_pos_rel, fbk.foot_vel_rel, contacts)
        if "mocap_pos" in sensors_raw:
            # external mocap correction (reference: simulated mocap feeds
            # the EKF in Gazebo, GazeboInterface.cpp:147-177; real NatNet
            # path HardwareInterface.cpp:203-228)
            ekf_stepped = ekf_mod.ekf_update_with_opti(
                ekf_stepped, sensors_raw["mocap_pos"],
                sensors_raw["mocap_euler"])
            pos_est = ekf_stepped.x[0:3]
            vel_est = ekf_stepped.x[3:6]
            eul_est = ekf_stepped.x[6:9]
        first = ~ekf.initialized
        ekf = jax.tree.map(
            lambda a, b: jnp.where(first, a, b), ekf_fresh, ekf_stepped)
        fbk = fbk.replace(
            root_pos=jnp.where(first, fbk.root_pos, pos_est),
            root_lin_vel=jnp.where(first, fbk.root_lin_vel, vel_est),
            estimated_contacts=contacts,
        )
        # overwrite orientation products from the filtered euler
        # (reference: BaseInterface.cpp:439-446)
        eul = jnp.where(first, fbk.root_euler, eul_est)
        quat = _so3.euler_to_quat(eul)
        R = _so3.quat_to_rotmat(quat)
        fbk = fbk.replace(root_euler=eul, root_quat=quat, root_rot_mat=R,
                          root_rot_mat_z=_so3.rot_z(eul[2]),
                          root_ang_vel=R @ fbk.imu_ang_vel)

    # Raibert foothold targets (reference: BaseInterface.cpp:358-399);
    # with a height field the foothold z snaps to the map (BASELINE
    # config 4: height-map footholds)
    target_abs, target_world = raibert.raibert_footholds(
        fbk.root_pos, fbk.root_lin_vel, fbk.root_rot_mat_z,
        cs.ctrl.root_lin_vel_d_rel, params, terrain=terrain)
    ctrl = cs.ctrl.replace(foot_pos_target_abs=target_abs,
                           foot_pos_target_world=target_world)
    return cs.replace(fbk=fbk, ctrl=ctrl, kf=kf, ekf=ekf,
                      estimation_inited=est_inited)


def lowlevel_update(cs: ControllerState, params: RobotParams,
                    low_level_type: int = 0, wb_model=None):
    """Control-thread body: GRF mapping + swing IK + safety + PD torque
    (reference: ctrl_update, GazeboInterface.cpp:63-88).

    low_level_type (reference: LeggedState.h:149):
      0 = Jacobian-transpose tau control (reference tau_ctrl_update,
          BaseInterface.cpp:451-500) — the reference's live default;
      1 = hierarchical WBC feedforward torques (reference wbc_update,
          BaseInterface.cpp:502-557; compiled-but-disabled there, a live
          selectable path here) with the IK joint PD targets kept on top,
          as the reference's workspace swing mode does (:531-543).
    wb_model: whole_body.WbModel the WBC linearizes against (defaults to
          A1; select per robot with models.whole_body.wb_model_for).
    """
    q_tgt, dq_tgt, tau_ff = low_level.tau_ctrl_update(
        cs.fbk, cs.ctrl.optimized_state, cs.ctrl.optimized_input,
        cs.ctrl.movement_mode, params)
    if low_level_type == 1:
        from legged_mpc_control_tpu.control import wbc as wbc_mod
        from legged_mpc_control_tpu.models import whole_body as wb
        if wb_model is None:
            wb_model = wb.a1_wb_model()
        tau_ff, _F = wbc_mod.wbc_from_controller(cs.fbk, cs.ctrl, wb_model)
    ctrl = cs.ctrl.replace(joint_ang_tgt=q_tgt, joint_vel_tgt=dq_tgt,
                           joint_tau_tgt=tau_ff)
    tau = low_level.pd_torque(cs.fbk.joint_pos, cs.fbk.joint_vel,
                              q_tgt, dq_tgt, tau_ff, params)
    safe = safety.is_safe(cs.fbk.root_euler, cs.fbk.joint_vel)
    tau = safety.gate_torques(tau, safe)
    return cs.replace(ctrl=ctrl), tau, safe


def _sim_sensors(sim: srb_sim.SimState, params: RobotParams, grf_est):
    raw = srb_sim.read_sensors(sim, params)
    raw["foot_force_sensor"] = grf_est
    return raw


@partial(jax.jit, static_argnames=("horizon", "substeps", "use_ground_truth",
                                   "pdip_iters", "kf_type", "low_level_type"))
def closed_loop_tick(loop: LoopState, params: RobotParams,
                     pattern: gait_mod.GaitPattern, *,
                     horizon: int = 10,
                     substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                     use_ground_truth: bool = True,
                     kf_type: int = None,
                     low_level_type: int = 0,
                     terrain=None,
                     pdip_iters: int = 15) -> LoopState:
    """One full MPC period of closed-loop sim: mpc tick + `substeps`
    low-level/sim steps. Pass a sim.terrain.Terrain for height-field
    ground (box-stepping, stairs — BASELINE config 4)."""
    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps
    if kf_type is None:
        kf_type = 0 if use_ground_truth else 1

    cs = loop.controller
    # feedback once before MPC so the first tick sees valid sensors
    grf_normal = jnp.where(loop.sim.contact,
                           _anchored_normal_force(loop, params), 0.0)
    cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_normal),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs = convex_mpc.mpc_tick(cs, params, pattern, dt_mpc,
                             horizon=horizon, pdip_iters=pdip_iters)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = lowlevel_update(cs, params, low_level_type)
        sim = srb_sim.sim_step(sim, tau, params, dt_ll, terrain=terrain)
        grf_n = jnp.where(sim.contact,
                          _anchored_normal_force(
                              LoopState(controller=cs, sim=sim), params),
                          0.0)
        cs = feedback_update(cs, _sim_sensors(sim, params, grf_n), params,
                             dt_ll, kf_type=kf_type, terrain=terrain)
        return (cs, sim), None

    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps)
    return LoopState(controller=cs, sim=sim)


@partial(jax.jit, static_argnames=("horizon", "substeps", "kf_type",
                                   "low_level_type", "pdip_iters",
                                   "n_inner"))
def closed_loop_tick_wb(loop: LoopState, params: RobotParams,
                        pattern: gait_mod.GaitPattern, model, *,
                        horizon: int = 10,
                        substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                        kf_type: int = 0,
                        low_level_type: int = 0,
                        terrain=None,
                        pdip_iters: int = 15,
                        n_inner: int = 4) -> LoopState:
    """One MPC period of closed loop against the ARTICULATED whole-body
    simulator (sim/wb_sim.py) — the Gazebo-fidelity twin: torques act
    through full rigid-body dynamics, contact is physical (flight phases,
    step-down, impacts), and the foot sensor reads real normal forces
    (reference: GazeboInterface.cpp:99-118 + the Gazebo physics engine).

    `loop.sim` must be a wb_sim.WbSimState; `model` a whole_body.WbModel.
    """
    from legged_mpc_control_tpu.sim import wb_sim

    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    cs = loop.controller
    cs = feedback_update(cs, wb_sim.wb_read_sensors(loop.sim, model),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs = convex_mpc.mpc_tick(cs, params, pattern, dt_mpc,
                             horizon=horizon, pdip_iters=pdip_iters)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = lowlevel_update(cs, params, low_level_type,
                                         wb_model=model)
        sim = wb_sim.wb_sim_step(sim, tau, model, params, dt_ll,
                                 n_inner=n_inner, terrain=terrain)
        cs = feedback_update(cs, wb_sim.wb_read_sensors(sim, model),
                             params, dt_ll, kf_type=kf_type,
                             terrain=terrain)
        return (cs, sim), None

    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps)
    return LoopState(controller=cs, sim=sim)


@partial(jax.jit, static_argnames=("horizon", "substeps", "kf_type",
                                   "iters", "solver", "low_level_type",
                                   "n_inner"))
def closed_loop_tick_wb_batched(loop: LoopState, params: RobotParams,
                                pattern: gait_mod.GaitPattern, model, *,
                                horizon: int = 10,
                                substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                                kf_type: int = 0,
                                iters: int = 15,
                                solver: str = "riccati",
                                low_level_type: int = 0,
                                n_inner: int = 4,
                                terrain=None,
                                warm=None):
    """Scenario-batched closed-loop tick against the ARTICULATED
    whole-body simulator — the Gazebo-fidelity twin as a SWEEP backend:
    domain randomization runs against real rigid-body physics instead of
    the anchored SRB. The QP solve runs
    once for the whole batch (batched Riccati); the 18-DoF mass matrices
    factorize in one batched Cholesky (sim/wb_sim.wb_sim_step_batched).

    `loop.sim` must be a wb_sim.WbSimState with a leading scenario axis;
    `model` is the shared robot. Returns (loop', warm')."""
    from legged_mpc_control_tpu.sim import wb_sim

    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    v_sensors = jax.vmap(lambda s: wb_sim.wb_read_sensors(s, model))
    v_fb = jax.vmap(
        lambda cs, raw, p: feedback_update(cs, raw, p, dt_ll,
                                           kf_type=kf_type,
                                           terrain=terrain))
    v_ll = jax.vmap(lambda cs, p: lowlevel_update(cs, p, low_level_type,
                                                  wb_model=model))

    cs = loop.controller
    cs = v_fb(cs, v_sensors(loop.sim), params)
    cs, warm = convex_mpc.mpc_tick_batched(
        cs, params, pattern, dt_mpc, horizon=horizon, iters=iters,
        solver=solver, warm=warm)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = v_ll(cs, params)
        sim = wb_sim.wb_sim_step_batched(sim, tau, model, params, dt_ll,
                                         n_inner=n_inner, terrain=terrain)
        cs = v_fb(cs, v_sensors(sim), params)
        return (cs, sim), None

    # rolled, not unrolled: the articulated substep body is large, and
    # 8x-unrolling it inside a long rollout scan has crashed XLA:CPU's
    # compiler in full-suite runs
    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps)
    return LoopState(controller=cs, sim=sim), warm


@partial(jax.jit, static_argnames=("stand_policy", "walk_policy",
                                   "substeps", "kf_type",
                                   "low_level_type"))
def closed_loop_tick_lci(loop: LoopState, lci_state, params: RobotParams,
                         stand_policy, walk_policy, t, *,
                         substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                         kf_type: int = 0,
                         low_level_type: int = 0,
                         terrain=None):
    """One closed-loop MPC period through the LCI-MPC backend
    (reference: LciMpc::update in the MPC thread, LciMpc.cpp:45-153 +
    main.cpp:113-121 mpc_type 0). Same structure as `closed_loop_tick`
    with the convex QP replaced by the pluggable policy seam. Pass a
    sim.terrain.Terrain for height-field ground (the CI engine's box-step
    scenario, mpc/ci_mpc.py).

    Returns (loop', lci_state')."""
    from legged_mpc_control_tpu.mpc import lci_mpc

    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    cs = loop.controller
    grf_normal = jnp.where(loop.sim.contact,
                           _anchored_normal_force(loop, params), 0.0)
    cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_normal),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, lci_state = lci_mpc.lci_mpc_tick(
        cs, lci_state, stand_policy, walk_policy, t, dt_mpc)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = lowlevel_update(cs, params, low_level_type)
        sim = srb_sim.sim_step(sim, tau, params, dt_ll, terrain=terrain)
        grf_n = jnp.where(sim.contact,
                          _anchored_normal_force(
                              LoopState(controller=cs, sim=sim), params),
                          0.0)
        cs = feedback_update(cs, _sim_sensors(sim, params, grf_n), params,
                             dt_ll, kf_type=kf_type, terrain=terrain)
        return (cs, sim), None

    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps)
    return LoopState(controller=cs, sim=sim), lci_state


@partial(jax.jit, static_argnames=("stand_policy", "walk_policy",
                                   "substeps", "kf_type",
                                   "low_level_type"))
def closed_loop_tick_lci_batched(loop: LoopState, lci_state,
                                 params: RobotParams, stand_policy,
                                 walk_policy, t, *,
                                 substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                                 kf_type: int = 0,
                                 low_level_type: int = 0,
                                 terrain=None):
    """Scenario-batched closed-loop MPC period through the LCI-MPC
    backend: `closed_loop_tick_lci` with a leading scenario axis, the CI
    engine evaluated as ONE batch-native solve
    (lci_mpc.lci_mpc_tick_batched + mpc/ci_mpc.ci_solve_batched).

    `loop`/`lci_state` batched on every leaf; `walk_policy` must carry
    the `ci_batched` contract. Returns (loop', lci_state')."""
    from legged_mpc_control_tpu.mpc import lci_mpc

    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    # params are SHARED across scenarios here (the batch-native CI engine
    # closes over one robot), unlike closed_loop_tick_batched's
    # broadcast_params contract
    v_anf = jax.vmap(_anchored_normal_force, in_axes=(0, None))
    v_sensors = jax.vmap(_sim_sensors, in_axes=(0, None, 0))
    v_fb = jax.vmap(
        lambda cs, raw: feedback_update(cs, raw, params, dt_ll,
                                        kf_type=kf_type,
                                        terrain=terrain))
    v_ll = jax.vmap(lambda cs: lowlevel_update(cs, params,
                                               low_level_type))
    v_sim = jax.vmap(lambda sim, tau: srb_sim.sim_step(
        sim, tau, params, dt_ll, terrain=terrain))

    cs = loop.controller
    grf_normal = jnp.where(loop.sim.contact, v_anf(loop, params), 0.0)
    cs = v_fb(cs, v_sensors(loop.sim, params, grf_normal))
    cs, lci_state = lci_mpc.lci_mpc_tick_batched(
        cs, lci_state, stand_policy, walk_policy, t, dt_mpc)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = v_ll(cs)
        sim = v_sim(sim, tau)
        grf_n = jnp.where(
            sim.contact,
            v_anf(LoopState(controller=cs, sim=sim), params), 0.0)
        cs = v_fb(cs, v_sensors(sim, params, grf_n))
        return (cs, sim), None

    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps, unroll=True)
    return LoopState(controller=cs, sim=sim), lci_state


@partial(jax.jit, static_argnames=("stand_policy", "walk_policy",
                                   "substeps", "kf_type",
                                   "low_level_type", "n_inner"))
def closed_loop_tick_lci_wb(loop: LoopState, lci_state,
                            params: RobotParams, model, stand_policy,
                            walk_policy, t, *,
                            substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                            kf_type: int = 0,
                            low_level_type: int = 0,
                            n_inner: int = 4,
                            terrain=None,
                            wall=None):
    """LCI-MPC seam against the ARTICULATED whole-body simulator — the
    contact-implicit backend validated at torque level through full
    rigid-body dynamics, optionally with a vertical wall in the world
    (sim.terrain.Wall): the reference's CI-MPC wall-lean capability
    (reference: README.md:14) runs through this tick
    (tests/test_ci_wall_lean.py).

    `loop.sim` must be a wb_sim.WbSimState. Returns (loop', lci_state')."""
    from legged_mpc_control_tpu.mpc import lci_mpc
    from legged_mpc_control_tpu.sim import wb_sim

    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    cs = loop.controller
    cs = feedback_update(cs, wb_sim.wb_read_sensors(loop.sim, model),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, lci_state = lci_mpc.lci_mpc_tick(
        cs, lci_state, stand_policy, walk_policy, t, dt_mpc)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = lowlevel_update(cs, params, low_level_type,
                                         wb_model=model)
        sim = wb_sim.wb_sim_step(sim, tau, model, params, dt_ll,
                                 n_inner=n_inner, terrain=terrain,
                                 wall=wall)
        cs = feedback_update(cs, wb_sim.wb_read_sensors(sim, model),
                             params, dt_ll, kf_type=kf_type,
                             terrain=terrain)
        return (cs, sim), None

    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps)
    return LoopState(controller=cs, sim=sim), lci_state


def broadcast_params(params: RobotParams, batch: int) -> RobotParams:
    """Give every RobotParams leaf a leading scenario axis. Leaves already
    batched (runner.randomize_params output) pass through; shared leaves are
    broadcast — XLA keeps these as broadcasts, no memory is materialized.

    Batched-ness is decided against the canonical (unbatched) leaf rank, not
    by comparing shape[0] to `batch` — leg-indexed leaves like rho_fix (4,5)
    must not be mistaken for scenario axes when batch == 4."""
    from legged_mpc_control_tpu import config as config_mod

    base_ndims = config_mod.param_base_ndims()

    def bc(x, nd):
        x = jnp.asarray(x)
        if x.ndim == nd + 1:
            return x
        return jnp.broadcast_to(x, (batch,) + x.shape)
    return jax.tree.map(bc, params, base_ndims)


def admm_warm_init(batch: int, horizon: int, dtype=jnp.float32):
    """Zero ADMM warm tuple (== cold start) shaped for the rollout carry."""
    n = 12 * horizon
    z = jnp.zeros((batch, horizon, 4, 6), dtype=dtype)
    return (jnp.zeros((batch, n), dtype=dtype), z, z)


@partial(jax.jit, static_argnames=("horizon", "substeps", "kf_type",
                                   "iters", "solver", "low_level_type"))
def closed_loop_tick_batched(loop: LoopState, params: RobotParams,
                             pattern: gait_mod.GaitPattern, *,
                             horizon: int = 10,
                             substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                             kf_type: int = 0,
                             iters: int = 15,
                             solver: str = "riccati",
                             low_level_type: int = 0,
                             terrain=None,
                             warm=None):
    """Scenario-batched closed-loop tick. Same semantics as
    `closed_loop_tick` vmapped over a leading scenario axis, EXCEPT the QP
    solve runs once for the whole batch through the explicitly-batched
    solver instead of a vmap of the unbatched solve.

    Args:
      loop: LoopState with a leading scenario axis on every leaf.
      params: RobotParams with a leading scenario axis on every leaf
        (see `broadcast_params`).
      solver/warm: "riccati"/"pdip" (warm primal) or "admm" with the warm
        tuple carried across ticks (reference: ConvexQPSolver.cpp:185).

    Returns (loop', warm').
    """
    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps

    v_anf = jax.vmap(_anchored_normal_force)
    v_sensors = jax.vmap(_sim_sensors)
    # terrain is SHARED across scenarios (closed over, not vmapped); for
    # per-scenario terrain randomization, vmap these helpers explicitly
    v_fb = jax.vmap(
        lambda cs, raw, p: feedback_update(cs, raw, p, dt_ll,
                                           kf_type=kf_type,
                                           terrain=terrain))
    v_ll = jax.vmap(lambda cs, p: lowlevel_update(cs, p, low_level_type))
    v_sim = jax.vmap(lambda sim, tau, p: srb_sim.sim_step(
        sim, tau, p, dt_ll, terrain=terrain))

    cs = loop.controller
    grf_normal = jnp.where(loop.sim.contact, v_anf(loop, params), 0.0)
    cs = v_fb(cs, v_sensors(loop.sim, params, grf_normal), params)
    cs, warm = convex_mpc.mpc_tick_batched(
        cs, params, pattern, dt_mpc, horizon=horizon, iters=iters,
        solver=solver, warm=warm)

    def substep(carry, _):
        cs, sim = carry
        cs, tau, _safe = v_ll(cs, params)
        sim = v_sim(sim, tau, params)
        grf_n = jnp.where(
            sim.contact,
            v_anf(LoopState(controller=cs, sim=sim), params), 0.0)
        cs = v_fb(cs, v_sensors(sim, params, grf_n), params)
        return (cs, sim), None

    # fully unrolled: the substep bodies are chains of tiny elementwise
    # ops — unrolling lets XLA fuse across substep boundaries instead of
    # paying loop-carry materialization 8x per tick
    (cs, sim), _ = jax.lax.scan(substep, (cs, loop.sim), None,
                                length=substeps, unroll=True)
    return LoopState(controller=cs, sim=sim), warm


def _anchored_normal_force(loop: LoopState, params: RobotParams):
    """Foot-sensor model: normal force the anchored legs transmit, from the
    last commanded torques (quasi-static)."""
    from legged_mpc_control_tpu.models import kinematics as kin
    from legged_mpc_control_tpu.ops import la3, so3

    sim = loop.sim
    tau = loop.controller.ctrl.joint_tau_tgt.reshape(4, 3)
    q_legs = sim.q.reshape(4, 3)
    jac = kin.jac_legs(q_legs, params.rho_fix)
    f_rel = la3.solve3_t(jac, -tau)
    R = so3.quat_to_rotmat(sim.quat)
    fz = jnp.einsum("ab,lb->la", R, f_rel)[:, 2]
    return jnp.maximum(fz, 0.0)
