"""Contact-implicit MPC seam: the pluggable-policy MPC backend.

The reference hosts a second MPC backend — contact-implicit MPC evaluated by
an embedded Julia runtime (reference: src/mpc_ctrl/ci_mpc/LciMpc.cpp). The
Julia engine itself is an external submodule (empty in the reference
snapshot, .gitmodules:1-8); what the framework must provide is the *seam*:

  * the `LeggedMPC::update` contract — consume the controller state, write
    `optimized_state` (18,) and `optimized_input` (24,)
    (reference: LciMpc.cpp:131-149);
  * the policy input packing x in R^40 =
    [pos(3), rpy(3), foot_pos_abs(12) | v(3), omega(3), foot_vel_abs(12) |
     foot_force(4)]  (reference: LciMpc.cpp:62-92);
  * per-mode policy selection (stand / walk, reference: LciMpc.cpp:95-104);
  * 2-tap averaging filters on foot pos/vel (reference: LciMpc.cpp:37-40,
    79-88).

A policy is any jittable `(x40, t) -> (78,)` function returning
[u(12); state_des(18); vel_des(18); state_ref(18); vel_ref(12)] — matching
the Julia side's `exec_policy` output unpacking (reference:
LciMpc.cpp:118-139). A neural policy, a learned distillation
of the convex MPC, or a host-callback into an external solver all fit this
slot. `StandPolicy` provides a built-in PD hover policy so the seam is
usable out of the box.
"""

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.types import ControllerState

PolicyFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
X_DIM = 40
OUT_DIM = 78


@pytree.dataclass
class LciState:
    """Filter + clock state (reference: LciMpc.cpp:37-59), plus an opaque
    warm-start slot for stateful engines (the CI optimizer carries its
    previous input trajectory across ticks here — the same cross-tick
    reuse the convex solvers get from their warm carry)."""
    prev_foot_pos: Any        # (4,3) previous tick foot pos (2-tap filter)
    prev_foot_vel: Any        # (4,3)
    policy_time: Any          # time since mode switch
    prev_mode: Any            # int32
    policy_warm: Any = None   # engine-defined pytree (None for stateless)


def lci_init(dtype=jnp.float32, policy_warm=None) -> LciState:
    """policy_warm: initial warm slot for a stateful walk policy (use
    `policy.warm_init()` for the CI engine, mpc/ci_mpc.py)."""
    return LciState(
        prev_foot_pos=jnp.zeros((4, 3), dtype=dtype),
        prev_foot_vel=jnp.zeros((4, 3), dtype=dtype),
        policy_time=jnp.zeros((), dtype=dtype),
        prev_mode=jnp.zeros((), dtype=jnp.int32),
        policy_warm=policy_warm,
    )


def pack_policy_state(fbk, lci: LciState):
    """Assemble x in R^40 with the reference's 2-tap foot filtering.

    reference: LciMpc.cpp:62-92. Returns (x40, new LciState fields)."""
    foot_pos_f = 0.5 * (fbk.foot_pos_abs + lci.prev_foot_pos)
    foot_vel_f = 0.5 * (fbk.foot_vel_abs + lci.prev_foot_vel)
    x = jnp.concatenate([
        fbk.root_pos, fbk.root_euler, foot_pos_f.reshape(-1),
        fbk.root_lin_vel, fbk.root_ang_vel, foot_vel_f.reshape(-1),
        fbk.foot_force_sensor,
    ])
    return x, foot_pos_f, foot_vel_f


def lci_mpc_tick(state: ControllerState, lci: LciState,
                 stand_policy: PolicyFn, walk_policy: PolicyFn,
                 t, dt):
    """One LCI-MPC update (reference: LciMpc.cpp:45-153).

    Returns (new ControllerState, new LciState)."""
    fbk, ctrl = state.fbk, state.ctrl
    mode = ctrl.movement_mode

    # mode change resets the policy clock (reference: :46-59)
    changed = mode != lci.prev_mode
    policy_time = jnp.where(changed, 0.0, lci.policy_time + dt)

    x, fp, fv = pack_policy_state(fbk, lci)

    out_stand = stand_policy(x, policy_time)
    # stateful engines (ci_stateful attr) take and return their warm slot
    if getattr(walk_policy, "ci_stateful", False):
        out_walk, warm2 = walk_policy(x, policy_time, lci.policy_warm)
    else:
        out_walk, warm2 = walk_policy(x, policy_time), lci.policy_warm
    out = jnp.where(mode == 0, out_stand, out_walk)

    u = out[0:12]
    state_des = out[12:30]
    vel_des = out[30:48]
    # euler order flip: the policy returns [pos, euler...]; optimized_state
    # wants [pos(3), euler(3), foot(12)] (reference: :131-139)
    optimized_state = jnp.concatenate([
        state_des[0:3], state_des[3:6], state_des[6:18]])
    optimized_input = jnp.concatenate([u, vel_des[6:18]])

    # plan contacts from measured flags (reference: :143-149)
    plan_contacts = fbk.foot_contact_flag

    new_ctrl = ctrl.replace(
        optimized_state=optimized_state,
        optimized_input=optimized_input,
        plan_contacts=plan_contacts.astype(ctrl.plan_contacts.dtype),
    )
    new_lci = LciState(prev_foot_pos=fbk.foot_pos_abs,
                       prev_foot_vel=fbk.foot_vel_abs,
                       policy_time=policy_time,
                       prev_mode=mode,
                       policy_warm=warm2)
    return state.replace(ctrl=new_ctrl,
                         mpc_inited=jnp.ones((), dtype=bool)), new_lci


def lci_init_batched(batch: int, dtype=jnp.float32,
                     policy_warm=None) -> LciState:
    """Scenario-batched LciState (leading axis on every leaf).
    policy_warm: the BATCHED warm slot from a batch-native engine
    (e.g. `make_ci_walk_policy_batched(...).warm_init(batch)`)."""
    return LciState(
        prev_foot_pos=jnp.zeros((batch, 4, 3), dtype=dtype),
        prev_foot_vel=jnp.zeros((batch, 4, 3), dtype=dtype),
        policy_time=jnp.zeros((batch,), dtype=dtype),
        prev_mode=jnp.zeros((batch,), dtype=jnp.int32),
        policy_warm=policy_warm,
    )


def lci_mpc_tick_batched(state: ControllerState, lci: LciState,
                         stand_policy: PolicyFn, walk_policy, t, dt):
    """Scenario-batched LCI-MPC update: `lci_mpc_tick` over a leading
    batch axis, with the walk engine evaluated as ONE batch-native call
    (`policy.ci_batched` contract, mpc/ci_mpc.make_ci_walk_policy_batched
    — batched iLQR, batch-in-lanes gain solves) instead of a vmap of the
    solo engine into XLA's batched-LU/AD-heavy lowering.

    `state`/`lci` carry a leading scenario axis on every leaf; `t` is a
    scalar or (B,). Returns (new ControllerState, new LciState)."""
    fbk, ctrl = state.fbk, state.ctrl
    mode = ctrl.movement_mode                              # (B,)
    changed = mode != lci.prev_mode
    policy_time = jnp.where(changed, 0.0, lci.policy_time + dt)

    x, _fp, _fv = jax.vmap(pack_policy_state)(fbk, lci)

    out_stand = jax.vmap(stand_policy)(x, policy_time)
    if getattr(walk_policy, "ci_batched", False):
        out_walk, warm2 = walk_policy(x, policy_time, lci.policy_warm)
    elif getattr(walk_policy, "ci_stateful", False):
        out_walk, warm2 = jax.vmap(walk_policy)(x, policy_time,
                                                lci.policy_warm)
    else:
        out_walk, warm2 = jax.vmap(walk_policy)(x, policy_time), \
            lci.policy_warm
    out = jnp.where((mode == 0)[:, None], out_stand, out_walk)

    u = out[:, 0:12]
    state_des = out[:, 12:30]
    vel_des = out[:, 30:48]
    optimized_state = jnp.concatenate([
        state_des[:, 0:3], state_des[:, 3:6], state_des[:, 6:18]], axis=1)
    optimized_input = jnp.concatenate([u, vel_des[:, 6:18]], axis=1)
    plan_contacts = fbk.foot_contact_flag

    new_ctrl = ctrl.replace(
        optimized_state=optimized_state,
        optimized_input=optimized_input,
        plan_contacts=plan_contacts.astype(ctrl.plan_contacts.dtype),
    )
    new_lci = LciState(prev_foot_pos=fbk.foot_pos_abs,
                       prev_foot_vel=fbk.foot_vel_abs,
                       policy_time=policy_time,
                       prev_mode=mode,
                       policy_warm=warm2)
    return state.replace(ctrl=new_ctrl,
                         mpc_inited=jnp.ones(mode.shape, dtype=bool)), \
        new_lci


def make_walk_policy(params: RobotParams, velx=0.25, body_height=0.3,
                     gait_freq=None, swing_clearance=0.08,
                     horizon=8, dt_plan=0.02, qp_iters=12,
                     fz_min=5.0) -> PolicyFn:
    """Built-in trot WALK policy for the LCI slot (reference: p_walk,
    LciMpc.cpp:95-104 — the Julia engine is an empty submodule there; this
    is the framework's own jittable walking policy filling the seam).

    A distilled convex-MPC policy: the policy's internal trot clock (driven
    purely by the policy time, exactly like the reference's Julia policies)
    produces a predicted contact schedule, and the GRFs come from a
    short-horizon SRB QP solved with the framework's interior-point solver
    over that schedule — horizon prediction stabilizes the two-feet tipping
    mode that a quasi-static wrench distribution cannot. Swing feet track a
    Bezier arc toward a Raibert foothold. Swing foot velocity targets are
    zero — faithfully matching the reference's Bezier, whose velocity
    output is always zero (reference: Utils.cpp:179-192).
    """
    from legged_mpc_control_tpu.control import raibert
    from legged_mpc_control_tpu.mpc import pdip, qp_builder, reference
    from legged_mpc_control_tpu.ops import bezier, so3

    if gait_freq is None:
        # match the convex path's trot rate (reference:
        # gazebo_a1_convex.yaml gait_counter_speed = 3.5 cycles/s) — slower
        # trots leave the body on two diagonal feet long enough to tip
        gait_freq = float(params.gait_counter_speed)

    def policy(x, t):
        dtype = x.dtype
        pos, euler = x[0:3], x[3:6]
        foot_abs = x[6:18].reshape(4, 3)       # CoM-origin world axes
        v, omega = x[18:21], x[21:24]
        foot_force = x[36:40]                  # measured normal forces

        # --- internal trot clock (legs FL,RR vs FR,RL) ---
        phase = (t * gait_freq) % 1.0
        leg_phase = jnp.mod(
            phase + jnp.array([0.0, 0.5, 0.5, 0.0], dtype), 1.0)
        contact = (leg_phase < 0.5).astype(dtype)           # (4,)
        # a clock-stance foot only counts as support once it actually
        # carries force (late-touchdown handling — the convex path's FSM
        # does this with its early-contact transition,
        # reference: LeggedContactFSM.cpp:61-66)
        grounded = (foot_force > 2.0).astype(dtype)
        support = contact * grounded
        # complete the arc by 75% of swing so the foot has tracking margin
        # to actually touch down before the clock flips it to stance
        swing_s = jnp.clip((leg_phase - 0.5) * 2.0 / 0.75, 0.0, 1.0)

        # --- GRFs: short-horizon SRB QP over the clock's future schedule ---
        yaw = euler[2]
        Rz = so3.rot_z(yaw)
        R = so3.quat_to_rotmat(so3.euler_to_quat(euler))
        v_d = Rz @ jnp.array([velx, 0.0, 0.0], dtype)
        pos_des = jnp.array([pos[0], pos[1], body_height], dtype)
        eul_des = jnp.array([0.0, 0.0, yaw], dtype)
        cmd = reference.MpcCmd(
            root_pos_d=jnp.array([0.0, 0.0, body_height], dtype),
            root_euler_d=jnp.zeros(3, dtype).at[2].set(yaw),
            root_lin_vel_d_rel=jnp.array([velx, 0.0, 0.0], dtype),
            root_ang_vel_d_rel=jnp.zeros(3, dtype))
        x_ref, yaw_ref, _ = reference.build_reference(
            euler, pos, R, cmd, horizon, dt_plan)
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass, params.trunk_inertia, R, foot_abs,
            dt_plan)
        ks = jnp.arange(horizon, dtype=dtype) * dt_plan
        phase_k = jnp.mod((t + ks)[:, None] * gait_freq
                          + jnp.array([0.0, 0.5, 0.5, 0.0], dtype)[None, :],
                          1.0)
        sched = (phase_k < 0.5).astype(dtype)               # (H,4)
        sched = sched.at[0].set(support)   # now: actually-loaded feet only
        x0 = jnp.concatenate([euler, pos, omega, v])
        qp = qp_builder.build_condensed_qp(
            x0, x_ref, A_seq, Bm, sched, params.q_weights,
            params.r_weights, params.mu, params.fz_max, dt_plan)
        res = pdip.solve_qp_pdip(qp.P, qp.q, qp.mu, qp.fz_max,
                                 contact=sched, iters=qp_iters)
        grf = res.u[0:12]
        grf = jnp.where(jnp.any(jnp.isnan(grf)), jnp.zeros_like(grf), grf)
        u = grf.reshape(4, 3) * support[:, None]
        # bootstrap load on clock-stance feet not yet registering force:
        # the foot-force estimate comes from the commanded feedforward, so
        # an unloaded foot must be commanded INTO the ground before the
        # support detector can ever see it
        boot = (contact * (1.0 - grounded))[:, None] \
            * jnp.array([0.0, 0.0, 2.0 * fz_min], dtype)[None, :]
        u = (u + boot).reshape(-1)

        # --- swing: Bezier arc from the current foot to the foothold ---
        target_abs, _ = raibert.raibert_footholds(
            pos, v, Rz, jnp.array([velx, 0.0, 0.0], dtype), params)
        foot_world = foot_abs + pos[None, :]
        target_world = target_abs + pos[None, :]
        # aim marginally below ground so the PD actually loads the foot
        target_world = target_world.at[:, 2].set(-0.01)
        arc = jax.vmap(
            lambda s, p0, p1: bezier.swing_foot_pos(s, p0, p1))(
            swing_s, foot_world, target_world)
        arc = arc.at[:, 2].add(swing_clearance
                               * jnp.sin(jnp.pi * swing_s))
        # clock-stance feet: hold position once grounded; push straight
        # down at the current xy while still airborne (a "hold in the air"
        # target would never load the foot)
        push_down = foot_world.at[:, 2].set(-0.01)
        stance_tgt = jnp.where(grounded[:, None] > 0.5, foot_world,
                               push_down)
        foot_tgt = jnp.where(contact[:, None] > 0.5, stance_tgt, arc)

        state_des = jnp.concatenate([
            pos_des, eul_des, foot_tgt.reshape(-1)])
        vel_des = jnp.concatenate([v_d, jnp.zeros(3, dtype),
                                   jnp.zeros(12, dtype)])
        state_ref = state_des
        vel_ref = jnp.zeros(12, dtype)
        return jnp.concatenate([u, state_des, vel_des, state_ref, vel_ref])

    return policy


def make_stand_policy(params: RobotParams, body_height=0.3,
                      kp=jnp.asarray([120.0, 120.0, 200.0]),
                      kd=jnp.asarray([20.0, 20.0, 30.0])) -> PolicyFn:
    """Built-in hover policy for the stand slot: world-frame PD on the body
    mapped to per-foot forces (equal weight distribution), holding the
    default stance. Gives the LCI seam a working default without the
    external engine."""

    def policy(x, t):
        dtype = x.dtype
        pos, euler = x[0:3], x[3:6]
        foot_pos = x[6:18].reshape(4, 3)
        v = x[18:21]
        pos_des = jnp.array([pos[0], pos[1], body_height], dtype)
        f_body = (kp.astype(dtype) * (pos_des - pos)
                  - kd.astype(dtype) * v
                  + jnp.array([0., 0., 9.8], dtype) * params.mass)
        u = jnp.tile(f_body / 4.0, 4)
        state_des = jnp.concatenate([
            pos_des, jnp.zeros(3, dtype),
            (foot_pos + pos[None, :]).reshape(-1)])
        vel_des = jnp.zeros(18, dtype)
        state_ref = state_des
        vel_ref = jnp.zeros(12, dtype)
        return jnp.concatenate([u, state_des, vel_des, state_ref, vel_ref])

    return policy
