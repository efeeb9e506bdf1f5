"""Profiling of the batched closed-loop tick on the device JAX runs on:
times the full tick, the MPC solve alone, and a per-stage breakdown of
the substep (lowlevel / sim / feedback).

    python tools/profile_tick.py
"""
import time

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import device
from legged_mpc_control_tpu.config import go1_params
from legged_mpc_control_tpu.mpc import gait, convex_mpc
from legged_mpc_control_tpu.parallel import runner
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.sim import srb_sim
from legged_mpc_control_tpu import constants as C

B = 4096
H = 10
dtype = jnp.float32
params1 = go1_params(dtype)
pattern = gait.trot_pattern(dtype)
loop = runner.init_loop_batch(params1, B, jax.random.PRNGKey(0), dtype=dtype)
params = step_mod.broadcast_params(params1, B)
print(device.device_info())


def timeit(fn, args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


# full tick
full = jax.jit(lambda lp, p: step_mod.closed_loop_tick_batched(
    lp, p, pattern, horizon=H, iters=8, solver="riccati"))
t_full = timeit(full, (loop, params))
print(f"full tick:        {t_full*1e3:8.3f} ms  -> {B/t_full:,.0f} ticks/s")

# MPC tick alone (feedback once + solve)
def mpc_only(lp, p):
    cs = lp.controller
    grf_n = jnp.where(lp.sim.contact,
                      jax.vmap(step_mod._anchored_normal_force)(lp, p), 0.0)
    cs = jax.vmap(lambda c, raw, pp: step_mod.feedback_update(
        c, raw, pp, C.MPC_DT / C.SUBSTEPS_PER_MPC_TICK))(
            cs, jax.vmap(step_mod._sim_sensors)(lp.sim, p, grf_n), p)
    cs, _ = convex_mpc.mpc_tick_batched(cs, p, pattern, C.MPC_DT,
                                        horizon=H, iters=8,
                                        solver="riccati")
    return cs
t_mpc = timeit(jax.jit(mpc_only), (loop, params))
print(f"fb+mpc solve:     {t_mpc*1e3:8.3f} ms")

# substep stages, one substep each (x8 per tick)
dt_ll = C.MPC_DT / C.SUBSTEPS_PER_MPC_TICK
cs0 = loop.controller

ll = jax.jit(lambda cs, p: jax.vmap(
    lambda c, pp: step_mod.lowlevel_update(c, pp, 0))(cs, p))
t_ll = timeit(ll, (cs0, params))
print(f"lowlevel (x8):    {t_ll*1e3:8.3f} ms/substep = {8*t_ll*1e3:.3f} ms/tick")

cs1, tau, _ = ll(cs0, params)
sim_f = jax.jit(lambda s, t, p: jax.vmap(
    lambda ss, tt, pp: srb_sim.sim_step(ss, tt, pp, dt_ll))(s, t, p))
t_sim = timeit(sim_f, (loop.sim, tau, params))
print(f"sim step (x8):    {t_sim*1e3:8.3f} ms/substep = {8*t_sim*1e3:.3f} ms/tick")

def fb_once(lp, p):
    grf_n = jnp.where(lp.sim.contact,
                      jax.vmap(step_mod._anchored_normal_force)(lp, p), 0.0)
    return jax.vmap(lambda c, raw, pp: step_mod.feedback_update(
        c, raw, pp, dt_ll))(lp.controller,
                            jax.vmap(step_mod._sim_sensors)(lp.sim, p, grf_n),
                            p)
t_fb = timeit(jax.jit(fb_once), (loop, params))
print(f"feedback (x8):    {t_fb*1e3:8.3f} ms/substep = {8*t_fb*1e3:.3f} ms/tick")

print(f"\nsum of parts: {(t_mpc + 8*(t_ll + t_sim + t_fb))*1e3:.3f} ms "
      f"vs full {t_full*1e3:.3f} ms")
