"""Batched closed-loop tick (the product path) vs per-scenario reference.

Round-2 requirement: the closed loop must route its scenario batch through
the explicitly-batched solvers (`solve_qp_pdip_batched` /
`solve_qp_admm_batched`), not vmap the unbatched solve. These tests pin:
  * `closed_loop_tick_batched` == vmap(`closed_loop_tick`) numerically;
  * the ADMM-warm closed loop (reference OSQP operating mode,
    ConvexQPSolver.cpp:185) tracks the cold-PDIP closed loop.
"""

import jax
import jax.numpy as jnp
import numpy as np

from legged_mpc_control_tpu.config import a1_params
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.parallel import runner

DTYPE = jnp.float64


def test_batched_tick_matches_vmapped_reference():
    params = a1_params(DTYPE)
    pattern = gait.trot_pattern(DTYPE)
    batch = 3
    loop = runner.init_loop_batch(params, batch, jax.random.PRNGKey(0),
                                  dtype=DTYPE)
    params_b = step_mod.broadcast_params(params, batch)

    got, warm = step_mod.closed_loop_tick_batched(
        loop, params_b, pattern, horizon=5, iters=12, solver="pdip")
    # the tick returns its primal for the next tick's cross-tick warm start
    # (reference: ConvexQPSolver.cpp:185)
    assert warm.shape == (batch, 12 * 5)

    def one(lp, pp):
        return step_mod.closed_loop_tick(lp, pp, pattern, horizon=5,
                                         pdip_iters=12)

    want = jax.vmap(one)(loop, params_b)
    np.testing.assert_allclose(np.asarray(got.sim.pos),
                               np.asarray(want.sim.pos), atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.sim.vel),
                               np.asarray(want.sim.vel), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(got.controller.ctrl.optimized_input),
        np.asarray(want.controller.ctrl.optimized_input), atol=1e-7)


def test_riccati_batched_tick_matches_pdip():
    """The product-default Riccati solver drives the closed loop to the
    same place as the condensed PDIP (identical Newton systems)."""
    params = a1_params(DTYPE)
    pattern = gait.trot_pattern(DTYPE)
    batch = 3
    loop = runner.init_loop_batch(params, batch, jax.random.PRNGKey(2),
                                  dtype=DTYPE)
    params_b = step_mod.broadcast_params(params, batch)

    got_r, _ = step_mod.closed_loop_tick_batched(
        loop, params_b, pattern, horizon=5, iters=15, solver="riccati")
    got_p, _ = step_mod.closed_loop_tick_batched(
        loop, params_b, pattern, horizon=5, iters=15, solver="pdip")
    np.testing.assert_allclose(np.asarray(got_r.sim.pos),
                               np.asarray(got_p.sim.pos), atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(got_r.controller.ctrl.optimized_input),
        np.asarray(got_p.controller.ctrl.optimized_input), atol=1e-5)


def test_admm_warm_rollout_tracks_pdip_rollout():
    """Closed-loop trot with the warm-started ADMM solver lands where the
    cold-PDIP loop lands (OSQP-equivalent operating accuracy ~0.1 N)."""
    params = a1_params(DTYPE)
    pattern = gait.trot_pattern(DTYPE)
    batch = 2
    key = jax.random.PRNGKey(1)
    n_ticks = 5

    loop0 = runner.init_loop_batch(params, batch, key, dtype=DTYPE)
    roll_pdip = jax.jit(runner.make_batched_rollout(
        pattern, horizon=5, n_ticks=n_ticks, pdip_iters=15, solver="pdip",
        walk_velx=0.2))
    roll_admm = jax.jit(runner.make_batched_rollout(
        pattern, horizon=5, n_ticks=n_ticks, pdip_iters=60, solver="admm",
        walk_velx=0.2))

    fin_p, _ = roll_pdip(loop0, params)
    fin_a, _ = roll_admm(loop0, params)

    # same closed-loop trajectory to within the solver accuracy difference
    np.testing.assert_allclose(np.asarray(fin_a.sim.pos),
                               np.asarray(fin_p.sim.pos), atol=2e-3)
    assert np.all(np.asarray(fin_a.sim.pos[:, 2]) > 0.2)
