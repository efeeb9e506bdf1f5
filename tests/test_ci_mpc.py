"""Contact-implicit MPC engine (mpc/ci_mpc.py): the reference's second
backend capability set (reference: README.md:14 — trot, box-step — via
ContactImplicitMPC.jl, LciMpc.cpp:8-24), here a jittable FB-complementarity
iLQR over SRB+feet.

Covers: standing equilibrium, contact DISCOVERY (force-gap complementarity
honored without a contact schedule), trot emerging as alternating diagonal
support, landing a swing foot ON a box from terrain geometry alone, and —
the capability headline — the closed-loop box-step through the LciMpc seam.
"""

import jax
import jax.numpy as jnp
import numpy as np

from legged_mpc_control_tpu.config import a1_params
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.mpc import ci_mpc, lci_mpc
from legged_mpc_control_tpu.sim import srb_sim
from legged_mpc_control_tpu.sim import terrain as terrain_mod

DTYPE = jnp.float32   # the engine's product dtype
PARAMS = a1_params(DTYPE)
MG = float(PARAMS.mass) * 9.81


def _standing_problem(H=10, raise_fl=None):
    pos = jnp.array([0.0, 0.0, 0.3], DTYPE)
    feet = np.array(PARAMS.default_foot_pos + pos[None, :],
                    dtype=np.float32)
    if raise_fl is not None:
        feet[0, 2] = raise_fl
    z0 = jnp.concatenate([pos, jnp.zeros(9, DTYPE),
                          jnp.asarray(feet).reshape(-1)])
    refs_z = jnp.tile(z0[None], (H + 1, 1))
    f_ref = jnp.zeros((H, 4, 3), DTYPE).at[:, :, 2].set(MG / 4)
    refs_u = jnp.concatenate([f_ref.reshape(H, -1),
                              jnp.zeros((H, 12), DTYPE)], axis=1)
    return z0, refs_z, refs_u


def test_ci_standing_equilibrium():
    """All-stance template on flat ground solves to exact static
    equilibrium: mg/4 per foot, zero slip, body pinned at the target."""
    terr = terrain_mod.flat(dtype=DTYPE)
    z0, refs_z, refs_u = _standing_problem()
    U, Z, cost = ci_mpc.ci_solve(
        z0, refs_u, refs_z, refs_u, terr, PARAMS.mass,
        PARAMS.trunk_inertia.astype(DTYPE), PARAMS.mu, iters=16)
    f = np.asarray(U[:, 0:12]).reshape(-1, 4, 3)
    np.testing.assert_allclose(f[:, :, 2], MG / 4, atol=1.0)
    np.testing.assert_allclose(np.asarray(U[:, 12:24]), 0.0, atol=1e-2)
    np.testing.assert_allclose(np.asarray(Z[:, 2]), 0.3, atol=2e-3)


def test_ci_contact_discovery():
    """A foot hovering 5 cm up — even with the template claiming stance
    there — must NOT carry force until the optimizer drives it to the
    ground: the complementarity residual fz*gap stays near zero at every
    stage, with no contact schedule saying so."""
    terr = terrain_mod.flat(dtype=DTYPE)
    z0, refs_z, refs_u = _standing_problem(raise_fl=0.05)
    U, Z, _ = ci_mpc.ci_solve(
        z0, refs_u, refs_z, refs_u, terr, PARAMS.mass,
        PARAMS.trunk_inertia.astype(DTYPE), PARAMS.mu, iters=16)
    fz_fl = np.asarray(U[:, 2])                       # FL normal force
    gap_fl = np.asarray(Z[:-1, 14])                   # FL foot z
    resid = np.abs(fz_fl * np.maximum(gap_fl, 0.0))
    assert resid.max() < 0.5, resid                   # N*m scale ~ 6.4
    # at-distance force is bounded by the relaxation (~rho leakage),
    # nowhere near a stance load (~32 N here)
    assert np.all(fz_fl[gap_fl > 0.01] < 10.0), (fz_fl, gap_fl)


def test_ci_trot_emerges():
    """With a trot-template reference, the optimized support alternates
    between the diagonals at ~mg each, swing feet carrying nothing."""
    terr = terrain_mod.flat(dtype=DTYPE)
    pos = jnp.array([0.0, 0.0, 0.3], DTYPE)
    feet = PARAMS.default_foot_pos.astype(DTYPE) + pos[None, :]
    z0 = jnp.concatenate([pos, jnp.zeros(3, DTYPE),
                          jnp.array([0.2, 0.0, 0.0], DTYPE),
                          jnp.zeros(3, DTYPE), feet.reshape(-1)])
    refs_z, refs_u, U0 = ci_mpc.make_ci_reference(
        z0, jnp.float32(0.05), terr, PARAMS, velx=0.2, gait_freq=3.5,
        horizon=10)
    U, Z, _ = ci_mpc.ci_solve(
        z0, U0, refs_z, refs_u, terr, PARAMS.mass,
        PARAMS.trunk_inertia.astype(DTYPE), PARAMS.mu, iters=16)
    f = np.asarray(U[:, 0:12]).reshape(10, 4, 3)
    # stage 0: FL+RR diagonal carries ~mg, FR+RL near zero
    assert f[0, 0, 2] + f[0, 3, 2] > 0.75 * MG
    assert f[0, 1, 2] + f[0, 2, 2] < 0.25 * MG
    # late horizon: the other diagonal has taken over
    assert f[-1, 1, 2] + f[-1, 2, 2] > 0.75 * MG
    assert f[-1, 0, 2] + f[-1, 3, 2] < 0.25 * MG
    # complementarity holds across the whole plan
    feet_z = np.asarray(Z[:-1, 12:24]).reshape(10, 4, 3)[:, :, 2]
    resid = np.abs(f[:, :, 2] * np.maximum(feet_z, 0.0))
    assert resid.max() < 0.5, resid.max()


def test_ci_box_landing_open_loop():
    """A swing foot whose foothold lies on a 4 cm box lands ON the box:
    its optimized path settles at the box height with ~zero gap and the
    normal force activates only there — contact location and timing from
    the terrain geometry, no schedule (the reference's box-step claim,
    README.md:14)."""
    terr = terrain_mod.add_box(terrain_mod.flat(dtype=DTYPE),
                               center_xy=(1.3, 0.0), size_xy=(2.0, 2.0),
                               height=0.04)
    pos = jnp.array([0.12, 0.0, 0.3], DTYPE)
    feet = PARAMS.default_foot_pos.astype(DTYPE) + pos[None, :]
    z0 = jnp.concatenate([pos, jnp.zeros(3, DTYPE),
                          jnp.array([0.25, 0.0, 0.0], DTYPE),
                          jnp.zeros(3, DTYPE), feet.reshape(-1)])
    refs_z, refs_u, U0 = ci_mpc.make_ci_reference(
        z0, jnp.float32(0.16), terr, PARAMS, velx=0.25, gait_freq=3.5,
        horizon=12, dt_plan=0.025)
    U, Z, _ = ci_mpc.ci_solve(
        z0, U0, refs_z, refs_u, terr, PARAMS.mass,
        PARAMS.trunk_inertia.astype(DTYPE), PARAMS.mu, iters=16,
        dt=0.025)
    feet_t = np.asarray(Z[:, 12:24]).reshape(13, 4, 3)
    fz_fl = np.asarray(U[:, 2])
    ground = np.asarray(jax.vmap(
        lambda fw: terrain_mod.height_at(terr, fw[:, 0:2])
    )(jnp.asarray(feet_t)))
    gap_fl = feet_t[:-1, 0, 2] - ground[:-1, 0]
    # mid-horizon the foot lands and loads (the template clock lifts it
    # again near the end of the plan — that's the next swing, fine);
    # every loaded stage must be AT the surface, and that surface is the
    # BOX (raised terrain under the foot), not the flat ground. Stage 0
    # is excluded: its (penetrating) foot position is the test's initial
    # condition, which no optimizer choice can move.
    loaded_stages = fz_fl[1:] > 20.0
    assert loaded_stages.any()
    np.testing.assert_array_less(np.abs(gap_fl[1:][loaded_stages]), 6e-3)
    assert ground[1:-1, 0][loaded_stages].min() > 0.02


def _drive_lci_ci(terrain, walk, n_ticks, params=PARAMS):
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)
    loop = step_mod.LoopState(
        controller=step_mod.controller_init(params, dtype=DTYPE),
        sim=srb_sim.sim_init(params, height=0.3, dtype=DTYPE))
    lci = lci_mpc.lci_init(dtype=DTYPE, policy_warm=walk.warm_init(DTYPE))
    tick = jax.jit(lambda lp, lc, t: step_mod.closed_loop_tick_lci(
        lp, lc, params, stand, walk, t, terrain=terrain))
    t = 0.0
    for _ in range(20):
        loop, lci = tick(loop, lci, jnp.asarray(t, DTYPE))
        t += 0.01
    cs = loop.controller
    cs = cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((), jnp.int32)))
    loop = loop.replace(controller=cs)
    worst_rp = 0.0
    for _ in range(n_ticks):
        loop, lci = tick(loop, lci, jnp.asarray(t, DTYPE))
        t += 0.01
        e = np.asarray(loop.controller.fbk.root_euler)
        worst_rp = max(worst_rp, abs(float(e[0])), abs(float(e[1])))
        assert float(loop.sim.pos[2]) > 0.1, "fell"
    return loop, worst_rp


def test_ci_closed_loop_walk_flat():
    """The CI engine in the full closed loop (LciMpc seam, warm-started
    across ticks): trots on flat ground, upright, at the commanded
    speed."""
    terr = terrain_mod.flat(dtype=DTYPE)
    walk = ci_mpc.make_ci_walk_policy(PARAMS, terrain=terr, velx=0.10)
    loop, worst_rp = _drive_lci_ci(terr, walk, 300)
    x = float(loop.sim.pos[0])
    z = float(loop.sim.pos[2])
    assert x > 0.15, x
    assert 0.25 < z < 0.35, z
    assert worst_rp < 0.25, worst_rp


def test_ci_closed_loop_box_step():
    """THE capability test (reference README.md:14): the contact-implicit
    backend — not the convex distillation — walks up onto a 3 cm box in
    closed loop. 3 cm is the same quasi-static envelope the convex path's
    terrain test documents (test_terrain_walk.py)."""
    terr = terrain_mod.flat(extent=3.0, cell=0.05, dtype=DTYPE)
    terr = terrain_mod.add_box(terr, center_xy=(1.3, 0.0),
                               size_xy=(2.2, 2.0), height=0.03)
    # iters=48 is the shipped TERRAIN operating point: the climb outcome
    # is chaotic in velx at lower sweep counts (0.119/0.121 perturbations
    # flip pass/fall at iters=32 — on the round-4 solver too), while
    # rho_warm + 48 sweeps clears x in [0.585, 0.633] across the same
    # perturbation grid. Flat-ground walking ships iters=32 (the
    # latency-bench config; fused kernel path).
    walk = ci_mpc.make_ci_walk_policy(PARAMS, terrain=terr, velx=0.12,
                                      iters=48)
    loop, worst_rp = _drive_lci_ci(terr, walk, 700)
    p = np.asarray(loop.sim.pos)
    ground = float(terrain_mod.height_at(terr, loop.sim.pos[:2]))
    assert p[0] > 0.4, p[0]                      # made it to the box
    assert ground > 0.027, ground                # body is OVER the box
    assert 0.25 < p[2] - ground < 0.35           # standing height on top
    feet = (np.asarray(loop.controller.fbk.foot_pos_abs) + p[None, :])
    under = [float(terrain_mod.height_at(terr, jnp.asarray(feet[i, :2],
                                                           DTYPE)))
             for i in range(4)]
    assert min(under) > 0.027, under             # all four feet on the box
    assert worst_rp < 0.45, worst_rp


def test_ci_closed_loop_box_step_go1():
    """The box-step capability ON GO1 — the robot the reference's CI-MPC
    claim names ("our CI-MPC controller can enable Go1 to trot, step on
    boxes, and lean against wall", reference: README.md:14). Same terrain
    operating point as the A1 test (rho_warm + 48 sweeps)."""
    from legged_mpc_control_tpu.config import go1_params

    g = go1_params(DTYPE)
    terr = terrain_mod.flat(extent=3.0, cell=0.05, dtype=DTYPE)
    terr = terrain_mod.add_box(terr, center_xy=(1.3, 0.0),
                               size_xy=(2.2, 2.0), height=0.03)
    walk = ci_mpc.make_ci_walk_policy(g, terrain=terr, velx=0.12,
                                      iters=48)
    loop, worst_rp = _drive_lci_ci(terr, walk, 700, params=g)
    p = np.asarray(loop.sim.pos)
    ground = float(terrain_mod.height_at(terr, loop.sim.pos[:2]))
    assert p[0] > 0.4, p[0]                      # made it to the box
    assert ground > 0.027, ground                # body is OVER the box
    assert 0.25 < p[2] - ground < 0.35           # standing height on top
    assert worst_rp < 0.45, worst_rp
