"""Articulated whole-body simulator — full rigid-body physics Gazebo twin.

The reference validates its controller against Gazebo's articulated
rigid-body physics with per-joint torque actuation
(reference: src/legged_ctrl/src/interfaces/GazeboInterface.cpp:99-118,
urdf/a1_description/urdf/robot.xacro). The anchored-contact SRB stand-in
(sim/srb_sim.py) cannot express flight phases or torque-level dynamics;
this module is the real thing: 18-DoF floating-base dynamics driven by the
autodiff Lagrangian model (models/whole_body.py), with compliant ground
contact on a height field. Everything is jittable and `vmap`s over
scenarios.

Dynamics:  M(q) a = S^T tau + sum_l J_l^T f_l - nle(q, v)
with M / nle / J from models.whole_body (exact, via autodiff through FK)
plus actuator armature and viscous joint friction. Semi-implicit Euler with
`n_inner` internal substeps per control period.

Contact model (per foot, world frame):
  * normal: spring-damper on terrain penetration,
    fn = max(0, KP_N * d - KD_N * vz),  d = ground - foot_z > 0
  * tangential: anchored spring (stiction) with Coulomb cap,
    fs = -KT (p_xy - anchor) - KD_T v_xy,  |ft| <= mu * fn,
    anchor dragged so the spring exactly sustains the capped force when
    sliding (classic Hunt-Crossley + bristle friction used by analytic
    simulators; the Gazebo/ODE equivalent is its soft-constraint ERP/CFM
    contact with a friction pyramid).

Torques saturate at the reference's actuator envelope +-33.5 Nm
(reference: config/task.info:228-230 torqueLimitsTask).
"""

from typing import Any

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.constants import GRAVITY_EST
from legged_mpc_control_tpu.models import kinematics as kin
from legged_mpc_control_tpu.models import whole_body as wb
from legged_mpc_control_tpu.sim import terrain as terrain_mod

# contact compliance (see module docstring). Sized to mimic Gazebo/ODE's
# near-rigid contact: a trot's 2-foot support sinks ~1.5 mm — soft ground
# delays touchdowns at every diagonal exchange and destabilizes the gait.
# The damping term is integrated explicitly, so the inner step must satisfy
# h < 2 m_eff / KD_N (~0.6 ms at the ~0.25 kg reflected foot mass);
# the default n_inner=4 (312 us) leaves 2x margin.
KP_N = 40000.0      # N/m normal stiffness
KD_N = 800.0        # N s/m normal damping
KT = 20000.0        # N/m tangential (stiction) stiffness
KD_T = 400.0        # N s/m tangential damping
ARMATURE = 0.01     # kg m^2 reflected rotor inertia per joint
JOINT_DAMPING = 0.02  # N m s/rad viscous joint friction
TAU_MAX = 33.5      # N m actuator limit (reference: task.info:228-230)
CONTACT_SENSE_MIN = 1.0  # N: report "contact" to the sensor model above this


@pytree.dataclass
class WbSimState:
    """Articulated world state.

    q (18,) = [base pos(3), euler ZYX (yaw, pitch, roll), joints(12)]
    v (18,) = dq/dt (the whole-body model's generalized velocity)
    """
    q: Any
    v: Any
    anchor: Any      # (4,2) tangential friction anchors, world xy
    wall_anchor: Any  # (4,3) stiction anchors on the wall plane, world
    f_contact: Any   # (4,3) last contact forces, world
    last_acc: Any    # (3,) last world base acceleration (IMU model)


def wb_rho_fix(model: wb.WbModel, dtype=jnp.float32):
    """The dynamics model's own leg geometry in kinematics-rho form
    [ox, oy, d, lt, lc] per leg — for IK against the *simulated* robot
    (the controller keeps its own, deliberately mismatched, rho_fix)."""
    ox = model.hip_origin[:, 0]
    oy = model.hip_origin[:, 1]
    d = model.hfe_origin[:, 1]
    lt = -model.kfe_origin[:, 2]
    lc = -model.foot_origin[:, 2]
    return jnp.stack([jnp.asarray(a, dtype) for a in (ox, oy, d, lt, lc)],
                     axis=-1)


def wb_sim_init(model: wb.WbModel, params: RobotParams, height=0.3,
                dtype=jnp.float32, terrain=None) -> WbSimState:
    """Standing start: default stance, feet resting on the ground."""
    ground = jnp.asarray(0.0, dtype)
    if terrain is not None:
        ground = terrain_mod.height_at(terrain, jnp.zeros(2, dtype=dtype))
    foot_rel = params.default_foot_pos.astype(dtype).at[:, 2].set(-height)
    q_guess = jnp.tile(jnp.array([0.0, 0.8, -1.6], dtype=dtype), (4, 1))
    qj = kin.ik_legs(foot_rel, q_guess, wb_rho_fix(model, dtype))
    q = jnp.concatenate([
        jnp.array([0.0, 0.0, 0.0], dtype).at[2].set(height + ground),
        jnp.zeros(3, dtype),                   # yaw, pitch, roll
        qj.reshape(-1)])
    feet = wb.foot_positions(q, model)
    return WbSimState(
        q=q, v=jnp.zeros(18, dtype),
        anchor=feet[:, :2],
        wall_anchor=feet,
        f_contact=jnp.zeros((4, 3), dtype),
        last_acc=jnp.zeros(3, dtype))


def _contact_forces(feet, vfeet, anchor, mu, terrain, dtype):
    """Compliant ground reaction per foot. Returns (f (4,3), anchor')."""
    if terrain is not None:
        ground = terrain_mod.height_at(terrain, feet[:, :2])
    else:
        ground = jnp.zeros(4, dtype=dtype)
    d = ground - feet[:, 2]                         # penetration depth
    in_contact = d > 0.0
    fn = jnp.maximum(KP_N * d - KD_N * vfeet[:, 2], 0.0)
    fn = jnp.where(in_contact, fn, 0.0)

    fs = -KT * (feet[:, :2] - anchor) - KD_T * vfeet[:, :2]
    cap = mu * fn
    norm = jnp.sqrt(jnp.sum(fs * fs, axis=-1) + 1e-12)
    ft = fs * jnp.minimum(1.0, cap / norm)[:, None]
    # drag the anchor so the spring sustains exactly the capped force; when
    # unsaturated this reduces to anchor' == anchor (no drift)
    a_contact = feet[:, :2] + (ft + KD_T * vfeet[:, :2]) / KT
    anchor = jnp.where(in_contact[:, None], a_contact, feet[:, :2])
    f = jnp.concatenate([ft, fn[:, None]], axis=-1)
    return f, anchor


def _wall_contact_forces(feet, vfeet, wall_anchor, mu, wall, dtype):
    """Compliant wall reaction per foot — the same Hunt-Crossley + bristle
    model as `_contact_forces`, rotated onto the wall plane: normal along
    wall.normal, stiction spring in the plane (which is what lets a foot
    pressed against a vertical wall carry VERTICAL weight through
    friction — the wall-lean mechanism). Returns (f (4,3), wall_anchor')."""
    n = wall.normal.astype(dtype)
    d = -terrain_mod.wall_gap(wall, feet)            # penetration depth
    in_contact = d > 0.0
    vn = jnp.sum(vfeet * n, axis=-1)
    fn = jnp.maximum(KP_N * d - KD_N * vn, 0.0)
    fn = jnp.where(in_contact, fn, 0.0)

    pt = feet - jnp.sum(feet * n, axis=-1, keepdims=True) * n
    at = wall_anchor - jnp.sum(wall_anchor * n, axis=-1,
                               keepdims=True) * n
    vt = vfeet - vn[:, None] * n
    fs = -KT * (pt - at) - KD_T * vt
    cap = mu * fn
    norm = jnp.sqrt(jnp.sum(fs * fs, axis=-1) + 1e-12)
    ft = fs * jnp.minimum(1.0, cap / norm)[:, None]
    a_contact = pt + (ft + KD_T * vt) / KT
    wall_anchor = jnp.where(in_contact[:, None], a_contact, pt)
    return ft + fn[:, None] * n, wall_anchor


def wb_sim_step(s: WbSimState, tau: jnp.ndarray, model: wb.WbModel,
                params: RobotParams, dt, *, n_inner: int = 4,
                terrain=None, wall=None) -> WbSimState:
    """Advance the articulated world by `dt` under joint torques tau (12,).

    `n_inner` semi-implicit inner steps keep the stiff contact mode stable
    at the 1.25 ms control period (reference loop rate, LeggedParams.h:8).
    """
    dtype = s.q.dtype
    h = jnp.asarray(dt, dtype) / n_inner
    tau_c = jnp.clip(tau, -TAU_MAX, TAU_MAX)
    mu = jnp.asarray(params.mu, dtype)

    def inner(carry, _):
        q, v, anchor, wall_anchor = carry
        M = wb.mass_matrix(q, model)
        M = M + jnp.diag(jnp.concatenate(
            [jnp.zeros(6, dtype), jnp.full((12,), ARMATURE, dtype)]))
        nle = wb.nonlinear_effects(q, v, model)
        J = wb.foot_jacobians(q, model)             # (4,3,18)
        feet = wb.foot_positions(q, model)
        vfeet = jnp.einsum("lij,j->li", J, v)

        f, anchor = _contact_forces(feet, vfeet, anchor, mu, terrain, dtype)
        if wall is not None:
            fw, wall_anchor = _wall_contact_forces(
                feet, vfeet, wall_anchor, mu, wall, dtype)
            f = f + fw

        gen = (-nle).at[6:].add(tau_c - JOINT_DAMPING * v[6:])
        gen = gen + jnp.einsum("lij,li->j", J, f)
        a = jnp.linalg.solve(M, gen)
        v = v + a * h
        q = q + v * h
        return (q, v, anchor, wall_anchor), (f, a[:3])

    (q, v, anchor, wall_anchor), (fs, accs) = jax.lax.scan(
        inner, (s.q, s.v, s.anchor, s.wall_anchor), None, length=n_inner)
    return WbSimState(q=q, v=v, anchor=anchor, wall_anchor=wall_anchor,
                      f_contact=fs[-1], last_acc=accs[-1])


def wb_sim_step_batched(s: WbSimState, tau: jnp.ndarray, model: wb.WbModel,
                        params: RobotParams, dt, *, n_inner: int = 4,
                        terrain=None, wall=None):
    """Scenario-batched articulated step: every leaf of `s`/`tau`/`params`
    carries a leading batch axis; `model` (the robot) is shared.

    Identical physics to vmap(wb_sim_step) EXCEPT two batch-native
    substitutions (pinned by tests/test_wb_batched.py +
    tests/test_wb_dynamics_b.py):
      * M/nle/J/feet come from the analytic batched CRBA/RNEA sweep
        (models/whole_body_b.dyn_terms_b) — one leg-vectorized FK pass +
        einsums, replacing four per-scenario autodiff derivations of the
        same quantities (the dominant cost of the sweep backend);
      * the 18x18 mass-matrix solve runs as one batched solve over all B
        mass matrices (SPD: CRBA + armature)."""
    from legged_mpc_control_tpu.models import whole_body_b as wbb

    dtype = s.q.dtype
    h = jnp.asarray(dt, dtype) / n_inner
    tau_c = jnp.clip(tau, -TAU_MAX, TAU_MAX)
    mu = jnp.asarray(params.mu, dtype)           # (B,)
    arma = jnp.concatenate([jnp.zeros(6, dtype),
                            jnp.full((12,), ARMATURE, dtype)])

    v_cf = jax.vmap(lambda f, vf, a, m: _contact_forces(
        f, vf, a, m, terrain, dtype))
    v_wf = (jax.vmap(lambda f, vf, a, m: _wall_contact_forces(
        f, vf, a, m, wall, dtype)) if wall is not None else None)

    def inner(carry, _):
        q, v, anchor, wall_anchor = carry
        M, nle, J, feet = wbb.dyn_terms_b(q, v, model)
        M = M + jnp.diag(arma)[None]
        vfeet = jnp.einsum("blij,bj->bli", J, v)

        f, anchor = v_cf(feet, vfeet, anchor, mu)
        if v_wf is not None:
            fw, wall_anchor = v_wf(feet, vfeet, wall_anchor, mu)
            f = f + fw

        gen = (-nle).at[:, 6:].add(tau_c - JOINT_DAMPING * v[:, 6:])
        gen = gen + jnp.einsum("blij,bli->bj", J, f)
        a = jnp.linalg.solve(M, gen[..., None])[..., 0]
        v = v + a * h
        q = q + v * h
        return (q, v, anchor, wall_anchor), (f, a[:, :3])

    (q, v, anchor, wall_anchor), (fs, accs) = jax.lax.scan(
        inner, (s.q, s.v, s.anchor, s.wall_anchor), None, length=n_inner)
    return WbSimState(q=q, v=v, anchor=anchor, wall_anchor=wall_anchor,
                      f_contact=fs[-1], last_acc=accs[-1])


def wb_read_sensors(s: WbSimState, model: wb.WbModel):
    """Raw proprioception dict — same contract as srb_sim.read_sensors
    (what GazeboInterface ingests, reference: GazeboInterface.cpp:122-295),
    with the foot force sensor fed by the *physical* contact normal force
    (the Gazebo bumper-plugin analog).

    Limitation (like the real A1's sole-mounted pressure sensor): the
    reading is the WORLD-Z force component, so a foot pressed against a
    vertical wall reads ~0 even while loaded. Wall scenarios must
    therefore gate contact on environment geometry (the lean policy's
    gap-based `grounded_now`, mpc/ci_mpc.make_ci_lean_policy) and use
    kf_type=0; the kf_type=1 estimator treats any contact as
    at-terrain-height and would mis-handle wall-contacting feet."""
    from legged_mpc_control_tpu.ops import so3

    dtype = s.q.dtype
    R, dR = jax.jvp(wb.base_rot, (s.q,), (s.v,))
    W = dR @ R.T
    omega = jnp.stack([W[2, 1], W[0, 2], W[1, 0]])
    euler_rpy = jnp.stack([s.q[5], s.q[4], s.q[3]])   # model q is ZYX order
    quat = so3.euler_to_quat(euler_rpy)
    g_up = jnp.array([0.0, 0.0, GRAVITY_EST], dtype)
    return dict(
        quat=quat, pos=s.q[0:3], vel=s.v[0:3],
        imu_acc=R.T @ (s.last_acc + g_up),
        imu_ang_vel=R.T @ omega,
        joint_pos=s.q[6:18], joint_vel=s.v[6:18],
        foot_force_sensor=s.f_contact[:, 2],
        contact=s.f_contact[:, 2] > CONTACT_SENSE_MIN,
    )
