"""Closed-loop validation on the ARTICULATED whole-body simulator.

These are the tests the anchored-SRB stand-in could not express
(tests/test_terrain_walk.py noted step-down was out of reach): full
rigid-body dynamics with per-joint torque actuation and physical contact —
the role Gazebo plays for the reference
(reference: GazeboInterface.cpp:99-118 manual PD torque + physics engine).

Covered: physical settling under gravity, standing balance, trot at speed,
stepping DOWN a 3 cm ledge, a flight-phase gait (flying_trot, with ticks
where ALL four feet are off the ground), pronking, and the hierarchical WBC
stabilizing at torque level (low_level_type=1).

Swing PD gains: the articulated backend runs kp=40 / kd=1.2 instead of the
reference YAML's 15 / 0.4 — those were tuned against Gazebo/ODE's rigid
contact; on the compliant-contact twin the weak gains under-track swing
legs against real leg gravity/inertia and the trot destabilizes at
>= 0.2 m/s. The reference itself treats these gains as live-tunable
(reference: BaseInterface.cpp:147-162 low_level_gains topic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legged_mpc_control_tpu.config import a1_params
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.models import whole_body as wb
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.sim import terrain as terrain_mod, wb_sim

DT = jnp.float64
MODEL = wb.a1_wb_model()


def _params():
    return a1_params(DT).replace(kp_foot=jnp.full(3, 40.0, DT),
                                 kd_foot=jnp.full(3, 1.2, DT))


def _start(params, terrain=None, height=0.28):
    return step_mod.LoopState(
        controller=step_mod.controller_init(params, dtype=DT,
                                            body_height=height),
        sim=wb_sim.wb_sim_init(MODEL, params, height=height, dtype=DT,
                               terrain=terrain))


def _walk(loop, params, pattern, n_ticks, velx, terrain=None,
          low_level_type=0, stand_ticks=50):
    """Stand `stand_ticks`, switch to walk at `velx`, run `n_ticks`.
    Returns (final loop, min total feet in contact over the walk,
    trace of (x, z, roll, pitch) per tick)."""
    kw = dict(horizon=10, terrain=terrain, low_level_type=low_level_type)
    for _ in range(stand_ticks):
        loop = step_mod.closed_loop_tick_wb(loop, params, pattern, MODEL,
                                            **kw)
    cs = loop.controller
    cs = cs.replace(
        ctrl=cs.ctrl.replace(movement_mode=jnp.ones((), jnp.int32)),
        joy=cs.joy.replace(velx=jnp.asarray(velx, DT)))
    loop = loop.replace(controller=cs)
    min_contacts = 4
    trace = []
    for _ in range(n_ticks):
        if terrain is not None:
            g = terrain_mod.height_at(terrain, loop.sim.q[:2])
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(
                joy=cs.joy.replace(body_height=0.28 + g)))
        loop = step_mod.closed_loop_tick_wb(loop, params, pattern, MODEL,
                                            **kw)
        nc = int(jnp.sum(loop.sim.f_contact[:, 2] > 1.0))
        min_contacts = min(min_contacts, nc)
        trace.append([float(loop.sim.q[0]), float(loop.sim.q[2]),
                      float(loop.sim.q[5]), float(loop.sim.q[4])])
    return loop, min_contacts, np.array(trace)


def test_settle_under_gravity():
    """Drop from 3 cm with joint PD holding pose: the robot lands, comes to
    rest, and the contact normal forces carry exactly the robot's weight."""
    params = _params()
    s = wb_sim.wb_sim_init(MODEL, params, height=0.28, dtype=DT)
    s = s.replace(q=s.q.at[2].add(0.03))
    q0 = s.q[6:18]

    def step(s):
        tau = 55.0 * (q0 - s.q[6:18]) - 1.5 * s.v[6:18]
        return wb_sim.wb_sim_step(s, tau, MODEL, params, 0.00125)

    step = jax.jit(step)
    for _ in range(1600):                      # 2 s
        s = step(s)
    masses = float(MODEL.trunk_mass) + float(np.sum(MODEL.link_mass))
    weight = masses * 9.8
    total_fn = float(jnp.sum(s.f_contact[:, 2]))
    assert abs(total_fn - weight) < 0.05 * weight, (total_fn, weight)
    assert float(jnp.linalg.norm(s.v)) < 0.2, np.asarray(s.v)
    assert 0.2 < float(s.q[2]) < 0.32
    assert np.all(np.abs(np.asarray(s.q[3:6])) < 0.06)


def test_standing_balance():
    """MPC standing balance closed loop on articulated dynamics: 1 s."""
    params = _params()
    loop = _start(params)
    for _ in range(100):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), MODEL,
                                            horizon=10)
    assert 0.26 < float(loop.sim.q[2]) < 0.30, float(loop.sim.q[2])
    assert np.all(np.abs(np.asarray(loop.sim.q[3:6])) < 0.05)
    assert float(jnp.linalg.norm(loop.sim.v[:6])) < 0.15
    # all four feet loaded
    assert int(jnp.sum(loop.sim.f_contact[:, 2] > 5.0)) == 4


def test_trot_walk():
    """Trot at 0.2 m/s for 4 s on flat ground: travels forward, holds
    height and attitude — torques acting through real articulated
    dynamics, contact physical (no kinematic anchoring)."""
    params = _params()
    loop, _, trace = _walk(_start(params), params, gait.trot_pattern(DT),
                           400, velx=0.2)
    assert trace[-1, 0] > 0.35, trace[-1]            # traveled forward
    assert np.all(trace[100:, 1] > 0.22) and np.all(trace[100:, 1] < 0.33)
    assert np.max(np.abs(trace[:, 2:4])) < 0.2       # roll, pitch bounded


def test_step_down_ledge():
    """Walk OFF a 3 cm platform mid-trot and keep trotting on the lower
    ground — the case the anchored-SRB sim could not do
    (tests/test_terrain_walk.py docstring)."""
    params = _params()
    terrain = terrain_mod.flat(extent=3.0, cell=0.05, dtype=DT)
    terrain = terrain_mod.add_box(terrain, center_xy=(-1.3, 0.0),
                                  size_xy=(3.4, 2.0), height=0.03)
    loop, _, trace = _walk(_start(params, terrain=terrain), params,
                           gait.trot_pattern(DT), 600, velx=0.15,
                           terrain=terrain)
    x = trace[-1, 0]
    assert x > 0.5, x                                # past the edge at 0.4
    g = float(terrain_mod.height_at(terrain, loop.sim.q[:2]))
    assert g < 0.001, g                              # on the lower ground
    z_rel = trace[-1, 1] - g
    assert 0.22 < z_rel < 0.33, z_rel                # still at height
    assert np.max(np.abs(trace[:, 2:4])) < 0.25


def test_flying_trot_flight_phase():
    """flying_trot at 0.3 m/s for 4 s: stays up AND genuinely flies —
    some control ticks have ZERO feet in contact. Impossible on the
    anchored-contact SRB sim; physical here."""
    params = _params()
    loop, min_contacts, trace = _walk(
        _start(params), params, gait.named_pattern("flying_trot", DT),
        400, velx=0.3)
    assert trace[-1, 0] > 0.55, trace[-1]
    assert np.all(trace[100:, 1] > 0.20) and np.all(trace[100:, 1] < 0.35)
    assert np.max(np.abs(trace[:, 2:4])) < 0.25
    assert min_contacts == 0, min_contacts           # true flight happened


def test_pronk():
    """Pronk in place for 3 s: all-four hops with flight, lands upright."""
    params = _params()
    loop, min_contacts, trace = _walk(
        _start(params), params, gait.named_pattern("pronk", DT),
        300, velx=0.0)
    assert np.all(trace[:, 1] > 0.18)
    assert np.max(np.abs(trace[:, 2:4])) < 0.25
    assert min_contacts == 0, min_contacts
    assert abs(trace[-1, 0]) < 0.3                   # stays near origin


def test_bound_holds():
    """Bound held >= 3 s without falling (the loosest of the dynamic
    gaits: pitch rocking is inherent and the Raibert planner is
    trot-shaped, so only survival is asserted)."""
    params = _params()
    loop, _, trace = _walk(_start(params), params,
                           gait.named_pattern("bound", DT), 300, velx=0.0)
    assert np.all(trace[:, 1] > 0.13)                # never collapsed
    assert np.max(np.abs(trace[:, 2])) < 0.4         # roll bounded


def test_wbc_torque_level_stand():
    """Hierarchical WBC (low_level_type=1) stabilizes standing at TORQUE
    level on the articulated dynamics — proving the WBC's torques against
    real whole-body physics, which the SRB sim never could."""
    params = _params()
    loop = _start(params)
    for _ in range(150):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), MODEL,
                                            horizon=10, low_level_type=1)
    assert 0.26 < float(loop.sim.q[2]) < 0.30
    assert np.all(np.abs(np.asarray(loop.sim.q[3:6])) < 0.03)
    assert float(jnp.linalg.norm(loop.sim.v[:6])) < 0.1


# --- Go1 on the articulated sim (reference runs Go1 in Gazebo/hardware,
#     launch/gazebo_go1_convex.launch + urdf/go1_description) ---

GO1 = wb.go1_wb_model()


def _go1_params():
    from legged_mpc_control_tpu.config import go1_params
    return go1_params(DT).replace(kp_foot=jnp.full(3, 40.0, DT),
                                  kd_foot=jnp.full(3, 1.2, DT))


def _go1_start(params, height=0.28):
    return step_mod.LoopState(
        controller=step_mod.controller_init(params, dtype=DT,
                                            body_height=height),
        sim=wb_sim.wb_sim_init(GO1, params, height=height, dtype=DT))


def test_go1_standing_balance():
    """Go1 whole-body model + go1 controller params, standing 1 s."""
    params = _go1_params()
    loop = _go1_start(params)
    for _ in range(100):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), GO1,
                                            horizon=10)
    assert 0.26 < float(loop.sim.q[2]) < 0.30, float(loop.sim.q[2])
    assert np.all(np.abs(np.asarray(loop.sim.q[3:6])) < 0.05)
    assert int(jnp.sum(loop.sim.f_contact[:, 2] > 5.0)) == 4


def test_go1_trot_walk():
    """Go1 trots at 0.2 m/s for 3 s on articulated dynamics."""
    params = _go1_params()
    loop = _go1_start(params)
    kw = dict(horizon=10)
    for _ in range(50):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), GO1,
                                            **kw)
    cs = loop.controller
    cs = cs.replace(
        ctrl=cs.ctrl.replace(movement_mode=jnp.ones((), jnp.int32)),
        joy=cs.joy.replace(velx=jnp.asarray(0.2, DT)))
    loop = loop.replace(controller=cs)
    trace = []
    for _ in range(300):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), GO1,
                                            **kw)
        trace.append([float(loop.sim.q[0]), float(loop.sim.q[2]),
                      float(loop.sim.q[5]), float(loop.sim.q[4])])
    trace = np.array(trace)
    assert trace[-1, 0] > 0.25, trace[-1]
    assert np.all(trace[100:, 1] > 0.22) and np.all(trace[100:, 1] < 0.33)
    assert np.max(np.abs(trace[:, 2:4])) < 0.25


def test_go1_wbc_torque_level_stand():
    """Hierarchical WBC with the GO1 whole-body model at torque level."""
    params = _go1_params()
    loop = _go1_start(params)
    for _ in range(150):
        loop = step_mod.closed_loop_tick_wb(loop, params,
                                            gait.trot_pattern(DT), GO1,
                                            horizon=10, low_level_type=1)
    assert 0.26 < float(loop.sim.q[2]) < 0.30
    assert np.all(np.abs(np.asarray(loop.sim.q[3:6])) < 0.03)
    assert float(jnp.linalg.norm(loop.sim.v[:6])) < 0.1


def test_standing_pace_holds():
    """standing_pace (gait.info lateral pairs with all-stance dwells) held
    3 s on the articulated dynamics: the only pace variant that is
    laterally stabilizable with the trot-shaped Raibert planner — the
    flight-phase `pace` is schedule-faithful (test_gait_info.py) but
    rolls over in closed loop, matching its real-robot difficulty."""
    params = _params()
    loop, _, trace = _walk(_start(params), params,
                           gait.named_pattern("standing_pace", DT), 300,
                           velx=0.1)
    assert np.all(trace[:, 1] > 0.18)                # never collapsed
    assert np.max(np.abs(trace[:, 2])) < 0.3         # roll bounded
    assert np.max(np.abs(trace[:, 3])) < 0.2         # pitch bounded
