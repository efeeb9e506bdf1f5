"""On-device single-rigid-body simulator — the Gazebo stand-in.

The reference validates its controller in a Gazebo twin behind the same
interface as the hardware (reference: GazeboInterface.cpp; SURVEY.md §4
"Gazebo is the fake backend"). Here the fake backend is an analytic,
fully-jittable SRB simulator so closed-loop rollouts run on-device, batch
under `vmap` for domain randomization, and need no ROS.

Model: rigid trunk + massless legs with quasi-static ground contact.
  * Torque commands map to realized world-frame foot forces through the leg
    Jacobian (F = -R J^-T tau), exactly inverting the controller's
    tau = -J^T R^T F mapping — then projected into the friction cone.
  * Stance feet are position-anchored where they touch down; their joint
    state follows from IK of the anchor (kinematic closure). Contact
    releases when the commanded normal force drops to zero.
  * Swing legs integrate light second-order joint dynamics under the
    commanded torques.
  * IMU model: accelerometer measures specific force R^T(v_dot + g_up);
    gyro measures body angular velocity; foot sensor reads normal force.
"""

from typing import Any

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.constants import GRAVITY_EST
from legged_mpc_control_tpu.models import kinematics as kin
from legged_mpc_control_tpu.ops import la3, so3

LEG_INERTIA = 0.04        # effective per-joint inertia of a light leg, kg m^2
LEG_DAMPING = 0.05        # viscous joint damping, N m s/rad
CONTACT_RELEASE_FZ = 1.0  # N: release anchor when commanded support drops


@pytree.dataclass
class SimState:
    pos: Any            # (3,) trunk CoM, world
    quat: Any           # (4,) [w,x,y,z]
    vel: Any            # (3,) world
    omega: Any          # (3,) world angular velocity
    q: Any              # (12,) joint angles
    dq: Any             # (12,)
    contact: Any        # (4,) bool: leg anchored
    anchor: Any         # (4,3) world anchor points of stance feet
    last_acc: Any       # (3,) world linear acceleration (for the IMU model)


def sim_init(params: RobotParams, height=0.3, dtype=jnp.float32,
             terrain=None) -> SimState:
    """Start standing: body at `height` above the ground, feet at default
    stance on the (possibly non-flat) ground."""
    ground = 0.0
    if terrain is not None:
        from legged_mpc_control_tpu.sim import terrain as terrain_mod

        ground = terrain_mod.height_at(
            terrain, jnp.zeros(2, dtype=dtype))
    pos = jnp.array([0.0, 0.0, 0.0], dtype=dtype).at[2].set(height + ground)
    # joints from IK of default stance (feet on the ground under the hips)
    foot_rel = params.default_foot_pos.astype(dtype).at[:, 2].set(-height)
    q_guess = jnp.tile(jnp.array([0.0, 0.8, -1.6], dtype=dtype), (4, 1))
    q = kin.ik_legs(foot_rel, q_guess, params.rho_fix)
    anchor = foot_rel + pos[None, :]
    if terrain is not None:
        from legged_mpc_control_tpu.sim import terrain as terrain_mod

        anchor = anchor.at[:, 2].set(
            terrain_mod.height_at(terrain, anchor[:, :2]))
    return SimState(
        pos=pos,
        quat=jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype),
        vel=jnp.zeros(3, dtype=dtype),
        omega=jnp.zeros(3, dtype=dtype),
        q=q.reshape(-1),
        dq=jnp.zeros(12, dtype=dtype),
        contact=jnp.ones(4, dtype=bool),
        anchor=anchor,
        last_acc=jnp.zeros(3, dtype=dtype),
    )


def sim_step(s: SimState, tau: jnp.ndarray, params: RobotParams,
             dt, terrain_height=0.0, terrain=None) -> SimState:
    """Advance the world by dt under joint torques `tau` (12,).

    Ground model: flat plane at `terrain_height`, or a height field if
    `terrain` (sim/terrain.Terrain) is given — per-foot touchdown height is
    then sampled under each foot."""
    dtype = s.pos.dtype
    R = so3.quat_to_rotmat(s.quat)
    q_legs = s.q.reshape(4, 3)
    dq_legs = s.dq.reshape(4, 3)
    tau_legs = tau.reshape(4, 3)

    foot_rel = kin.fk_legs(q_legs, params.rho_fix)
    jac = kin.jac_legs(q_legs, params.rho_fix)
    foot_world = jnp.einsum("ab,lb->la", R, foot_rel) + s.pos[None, :]

    # realized ground reaction (world) from commanded torques, contact legs
    # (closed-form 3x3 solves: the batched-tiny library calls dominate the
    # whole substep otherwise, ops/la3.py)
    f_rel = la3.solve3_t(jac, -tau_legs)
    f_world = jnp.einsum("ab,lb->la", R, f_rel)
    # unilateral + friction-cone projection
    fz = jnp.maximum(f_world[:, 2], 0.0)
    cap = params.mu * fz
    fx = jnp.clip(f_world[:, 0], -cap, cap)
    fy = jnp.clip(f_world[:, 1], -cap, cap)
    f_world = jnp.stack([fx, fy, fz], axis=-1)

    # contact transitions: engage on touchdown, release when support force
    # commanded through the leg vanishes
    if terrain is not None:
        from legged_mpc_control_tpu.sim import terrain as terrain_mod

        ground_h = terrain_mod.height_at(terrain, foot_world[:, :2])  # (4,)
    else:
        ground_h = jnp.full((4,), terrain_height, dtype=dtype)
    # engage only on near-surface crossings FROM ABOVE: when a swing foot's
    # xy drifts under a raised cell (box/stair riser) its z can sit far
    # below the local surface — anchoring there would teleport the foot up
    # the ledge mid-swing and churn contact on/off (the physical analog is
    # hitting the riser wall, which transmits no support)
    touching = (foot_world[:, 2] <= ground_h) & (
        foot_world[:, 2] >= ground_h - 0.02)
    new_contact = jnp.where(s.contact, fz > CONTACT_RELEASE_FZ, touching)
    anchor = jnp.where(
        (~s.contact & new_contact)[:, None],
        foot_world.at[:, 2].set(ground_h), s.anchor)

    grf = jnp.where(new_contact[:, None], f_world, 0.0)

    # trunk dynamics
    g_vec = jnp.array([0.0, 0.0, -GRAVITY_EST], dtype=dtype)
    acc = jnp.sum(grf, axis=0) / params.mass + g_vec
    I_world = R @ params.trunk_inertia @ R.T
    torque = jnp.sum(jnp.cross(anchor - s.pos[None, :], grf), axis=0)
    omega_dot = la3.solve3(
        I_world, torque - jnp.cross(s.omega, I_world @ s.omega))

    vel = s.vel + acc * dt
    pos = s.pos + vel * dt
    omega = s.omega + omega_dot * dt
    quat = so3.quat_integrate(s.quat, omega, dt)
    R_new = so3.quat_to_rotmat(quat)

    # leg kinematics update
    # swing legs: second-order joint dynamics under commanded torque
    ddq = (tau_legs - LEG_DAMPING * dq_legs) / LEG_INERTIA
    dq_swing = dq_legs + ddq * dt
    q_swing = q_legs + dq_swing * dt
    # stance legs: kinematic closure on the world anchor
    anchor_rel = jnp.einsum("ba,lb->la", R_new, anchor - pos[None, :])
    q_stance = kin.ik_legs(anchor_rel, q_legs, params.rho_fix)
    foot_vel_rel_closure = jnp.einsum(
        "ba,lb->la", R_new,
        -vel[None, :] - jnp.cross(jnp.broadcast_to(omega, (4, 3)),
                                  anchor - pos[None, :]))
    jac_new = kin.jac_legs(q_stance, params.rho_fix)
    dq_stance = la3.solve3(jac_new, foot_vel_rel_closure)

    q_new = jnp.where(new_contact[:, None], q_stance, q_swing)
    dq_new = jnp.where(new_contact[:, None], dq_stance, dq_swing)

    return SimState(
        pos=pos, quat=quat, vel=vel, omega=omega,
        q=q_new.reshape(-1), dq=dq_new.reshape(-1),
        contact=new_contact, anchor=anchor, last_acc=acc,
    )


def read_sensors(s: SimState, params: RobotParams):
    """Raw proprioception dict from sim state (the fake robot's UDP packet).

    Mirrors what GazeboInterface ingests (reference: GazeboInterface.cpp:
    122-295): IMU, joint states, foot forces, plus ground-truth pose for the
    kf_type-0 bypass."""
    R = so3.quat_to_rotmat(s.quat)
    q_legs = s.q.reshape(4, 3)
    jac = kin.jac_legs(q_legs, params.rho_fix)
    # commanded force reading of the foot sensor: project realized GRF;
    # here: normal force carried by anchored legs
    imu_acc = R.T @ (s.last_acc
                     + jnp.array([0., 0., GRAVITY_EST], dtype=s.pos.dtype))
    imu_gyro = R.T @ s.omega
    del jac
    return dict(
        quat=s.quat, pos=s.pos, vel=s.vel,
        imu_acc=imu_acc, imu_ang_vel=imu_gyro,
        joint_pos=s.q, joint_vel=s.dq,
        contact=s.contact,
    )
