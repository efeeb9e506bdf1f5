"""The articulated whole-body simulator as a BATCHED sweep backend:
domain-randomized scenarios run closed loop against
real rigid-body dynamics through `closed_loop_tick_wb_batched` /
`runner.make_batched_rollout_wb`, with the QP solved once per batch.
"""

import jax
import jax.numpy as jnp
import numpy as np

from legged_mpc_control_tpu.config import a1_params
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.models import whole_body as wb
from legged_mpc_control_tpu.parallel import runner

DT = jnp.float32
MODEL = wb.a1_wb_model()


def _params():
    return a1_params(DT).replace(kp_foot=jnp.full(3, 40.0, DT),
                                 kd_foot=jnp.full(3, 1.2, DT))


def test_wb_batched_matches_per_scenario():
    """One batched wb tick == vmap of the per-scenario wb tick."""
    params = _params()
    pattern = gait.trot_pattern(DT)
    batch = 3
    loop = runner.init_wb_loop_batch(params, MODEL, batch,
                                     jax.random.PRNGKey(0), dtype=DT)
    params_b = step_mod.broadcast_params(params, batch)

    got, _warm = step_mod.closed_loop_tick_wb_batched(
        loop, params_b, pattern, MODEL, horizon=5, iters=12,
        solver="pdip")

    def one(lp, pp):
        return step_mod.closed_loop_tick_wb(lp, pp, pattern, MODEL,
                                            horizon=5, pdip_iters=12)

    want = jax.vmap(one)(loop, params_b)
    np.testing.assert_allclose(np.asarray(got.sim.q),
                               np.asarray(want.sim.q), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.sim.v),
                               np.asarray(want.sim.v), atol=1e-3)


def test_wb_batched_domain_randomized_trot():
    """8 scenarios with randomized mass/friction/initial height trot on
    the ARTICULATED dynamics for 1 s after a 0.3 s stand — every scenario
    stays up, at height, and moves forward."""
    params = _params()
    pattern = gait.trot_pattern(DT)
    batch = 8
    key = jax.random.PRNGKey(3)
    params_b = runner.randomize_params(params, key, batch,
                                       mass_range=(0.9, 1.1),
                                       mu_range=(0.7, 1.2),
                                       speed_range=(1.0, 1.0))
    loop = runner.init_wb_loop_batch(params, MODEL, batch,
                                     jax.random.PRNGKey(1), dtype=DT)
    roll = jax.jit(runner.make_batched_rollout_wb(
        pattern, MODEL, horizon=10, n_ticks=90, pdip_iters=10,
        walk_velx=0.2, solver="riccati", stand_ticks=30))
    final, (pos, vel) = roll(loop, params_b)
    z = np.asarray(final.sim.q[:, 2])
    x = np.asarray(final.sim.q[:, 0])
    rp = np.asarray(final.sim.q[:, 4:6])
    assert np.all(z > 0.2) and np.all(z < 0.35), z
    assert np.all(x > 0.035), x                      # 0.6 s at 0.2 m/s
    assert np.abs(rp).max() < 0.3, rp
    # trajectory never collapsed either
    assert np.asarray(pos)[:, :, 2].min() > 0.15
