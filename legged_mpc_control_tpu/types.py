"""State pytrees — the functional replacement of the LeggedState blackboard.

The reference shares one mutable `LeggedState` struct across three racy
threads (reference: include/LeggedState.h:211-227, with the warning comment
about deadlocks at :223-224). Here the same fields become immutable pytrees
threaded through pure functions — the race class is gone by construction
(SURVEY.md §5 "Race detection").

Field names track the reference (LeggedState.h:13-138) for auditability.
Leg-indexed quantities use shape (4, ...) in FL, FR, RL, RR order.
"""

from typing import Any

import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.estimation.basic_kf import KfState
from legged_mpc_control_tpu.estimation.ekf import EkfState
from legged_mpc_control_tpu.mpc.gait import GaitLegState
from legged_mpc_control_tpu.ops.filters import MovingWindowState


@pytree.dataclass
class Feedback:
    """Sensor + estimator outputs. reference: LeggedState.h:13-65."""
    root_quat: Any            # (4,) [w,x,y,z]
    root_pos: Any             # (3,)
    root_lin_vel: Any         # (3,) world
    root_euler: Any           # (3,) rpy
    root_rot_mat: Any         # (3,3) world-from-body
    root_rot_mat_z: Any       # (3,3) yaw-only
    root_ang_vel: Any         # (3,) world (R @ gyro)
    imu_acc: Any              # (3,) body
    imu_ang_vel: Any          # (3,) body
    joint_pos: Any            # (12,)
    joint_vel: Any            # (12,)
    joint_tau_est: Any        # (12,) estimated actuation torque
    foot_force_sensor: Any    # (4,)
    foot_contact_flag: Any    # (4,) sigmoid contact belief in [0,1]
    foot_contact_bool: Any    # (4,) force > threshold (see sensors.py note)
    foot_pos_rel: Any         # (4,3) body frame
    foot_vel_rel: Any         # (4,3)
    jac_foot: Any             # (4,3,3)
    foot_pos_abs: Any         # (4,3) world axes, CoM origin
    foot_vel_abs: Any         # (4,3)
    foot_pos_world: Any       # (4,3)
    foot_vel_world: Any       # (4,3)
    foot_force_tau_est: Any   # (4,3) GRF estimate from joint torques
    estimated_contacts: Any   # (4,)


@pytree.dataclass
class Ctrl:
    """Controller working set. reference: LeggedState.h:67-112."""
    movement_mode: Any        # int32: 0 stand, 1 walk
    root_pos_d: Any           # (3,)
    root_euler_d: Any         # (3,)
    root_lin_vel_d_rel: Any   # (3,) body frame command (filtered)
    root_ang_vel_d_rel: Any   # (3,)
    foot_pos_target_world: Any   # (4,3) Raibert footholds
    foot_pos_target_abs: Any     # (4,3)
    foot_pos_target_rel: Any     # (4,3)
    plan_contacts: Any        # (4,) in {0.,1.}
    optimized_state: Any      # (18,) [pos_d, euler_d, foot pos targets]
    optimized_input: Any      # (24,) [GRFs, foot vel targets]
    joint_ang_tgt: Any        # (12,)
    joint_vel_tgt: Any        # (12,)
    joint_tau_tgt: Any        # (12,)


@pytree.dataclass
class JoyCmd:
    """Processed operator command. reference: LeggedState.h:114-138."""
    velx: Any
    vely: Any
    velz: Any
    yaw_rate: Any
    body_height: Any
    ctrl_state: Any           # int32: 0 stand, 1 walk
    prev_mode_button: Any     # bool: last mode-button state (edge detect)
    exit_flag: Any            # bool: operator requested shutdown


@pytree.dataclass
class ControllerState:
    """Full functional controller state threaded through the control step."""
    fbk: Feedback
    ctrl: Ctrl
    joy: JoyCmd
    gait: GaitLegState        # leaves have leading leg axis (4, ...)
    kf: KfState
    ekf: EkfState
    vel_filter_x: MovingWindowState
    vel_filter_y: MovingWindowState
    estimation_inited: Any    # bool
    mpc_inited: Any           # bool


def _z(shape, dtype):
    return jnp.zeros(shape, dtype=dtype)


def init_feedback(dtype=jnp.float32) -> Feedback:
    eye = jnp.eye(3, dtype=dtype)
    return Feedback(
        root_quat=jnp.array([1., 0., 0., 0.], dtype=dtype),
        root_pos=_z(3, dtype), root_lin_vel=_z(3, dtype),
        root_euler=_z(3, dtype), root_rot_mat=eye, root_rot_mat_z=eye,
        root_ang_vel=_z(3, dtype), imu_acc=_z(3, dtype),
        imu_ang_vel=_z(3, dtype), joint_pos=_z(12, dtype),
        joint_vel=_z(12, dtype), joint_tau_est=_z(12, dtype),
        foot_force_sensor=_z(4, dtype), foot_contact_flag=_z(4, dtype),
        foot_contact_bool=jnp.zeros(4, dtype=bool),
        foot_pos_rel=_z((4, 3), dtype), foot_vel_rel=_z((4, 3), dtype),
        jac_foot=jnp.broadcast_to(eye, (4, 3, 3)),
        foot_pos_abs=_z((4, 3), dtype), foot_vel_abs=_z((4, 3), dtype),
        foot_pos_world=_z((4, 3), dtype), foot_vel_world=_z((4, 3), dtype),
        foot_force_tau_est=_z((4, 3), dtype),
        estimated_contacts=_z(4, dtype),
    )


def init_ctrl(dtype=jnp.float32) -> Ctrl:
    return Ctrl(
        movement_mode=jnp.zeros((), dtype=jnp.int32),
        root_pos_d=_z(3, dtype), root_euler_d=_z(3, dtype),
        root_lin_vel_d_rel=_z(3, dtype), root_ang_vel_d_rel=_z(3, dtype),
        foot_pos_target_world=_z((4, 3), dtype),
        foot_pos_target_abs=_z((4, 3), dtype),
        foot_pos_target_rel=_z((4, 3), dtype),
        plan_contacts=jnp.ones(4, dtype=dtype),
        optimized_state=_z(18, dtype), optimized_input=_z(24, dtype),
        joint_ang_tgt=_z(12, dtype), joint_vel_tgt=_z(12, dtype),
        joint_tau_tgt=_z(12, dtype),
    )


def init_joy(dtype=jnp.float32, body_height=0.3) -> JoyCmd:
    return JoyCmd(
        velx=_z((), dtype), vely=_z((), dtype), velz=_z((), dtype),
        yaw_rate=_z((), dtype),
        body_height=jnp.asarray(body_height, dtype=dtype),
        ctrl_state=jnp.zeros((), dtype=jnp.int32),
        prev_mode_button=jnp.zeros((), dtype=bool),
        exit_flag=jnp.zeros((), dtype=bool),
    )
