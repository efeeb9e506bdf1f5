"""Batched scenario runner: domain-randomized closed-loop sweeps.

Covers BASELINE.json configs 3 and 5: thousands of randomized Go1/A1
scenarios (mass, friction, gait speed, initial state) vmapped on one chip
and sharded over a mesh across chips/hosts. The controller+sim loop state is
a pytree, so the whole rollout is `scan(vmap(tick))` under one jit with the
scenario axis sharded.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import constants as C
from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.mpc import gait as gait_mod
from legged_mpc_control_tpu.parallel.mesh import (
    BATCH_AXIS,
    batch_sharding,
    scenario_mesh,
    shard_scenarios,
)
from legged_mpc_control_tpu.sim import srb_sim


def randomize_params(params: RobotParams, key, batch: int,
                     mass_range=(0.8, 1.2), mu_range=(0.5, 1.2),
                     speed_range=(0.9, 1.1)) -> RobotParams:
    """Per-scenario domain randomization: mass/friction/gait-speed scales.

    Returns a RobotParams whose randomized leaves carry a leading batch
    axis; untouched leaves are broadcast by the runner's vmap in_axes.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    dtype = params.mass.dtype
    mass = params.mass * jax.random.uniform(
        k1, (batch,), dtype, *mass_range)
    mu = params.mu * jax.random.uniform(k2, (batch,), dtype, *mu_range)
    speed = params.gait_counter_speed * jax.random.uniform(
        k3, (batch,), dtype, *speed_range)
    return params.replace(mass=mass, mu=mu, gait_counter_speed=speed)


def make_batched_rollout(pattern: gait_mod.GaitPattern, *, horizon=10,
                         n_ticks=100, substeps=C.SUBSTEPS_PER_MPC_TICK,
                         pdip_iters=12, use_ground_truth=True, kf_type=None,
                         walk_velx=0.0, solver="riccati",
                         low_level_type=0, stand_ticks=0):
    """Returns rollout(loop_batch, params_batched) -> (final, diag).

    The scenario batch flows through `closed_loop_tick_batched`, so every
    tick's Newton factorizations run in ONE explicitly-batched solver call.

    Args:
      solver: "pdip" (cold interior point each tick) or "admm" — the
        OSQP-equivalent with its warm tuple carried tick-to-tick in the
        rollout state, mirroring the reference's `setWarmStart(true)`
        (reference: ConvexQPSolver.cpp:185).
      pdip_iters: iteration count for either solver.
      stand_ticks: with a nonzero `walk_velx`, the batch STANDS for this
        many ticks and then switches movement_mode to walk — the
        stand->walk sequence every closed-loop test drives (the reference
        operator does the same through the joystick FSM,
        BaseInterface.cpp:165-209). 0 = walk from tick 0.

    diag: per-tick (pos (T,B,3), vel (T,B,3)) trajectories.
    """
    if kf_type is None:
        kf_type = 0 if use_ground_truth else 1

    def rollout(loop, params, stand_ticks_arg=None):
        """stand_ticks_arg: optional TRACED override of the build-time
        `stand_ticks` — a resumed sweep passes its remaining stand count
        here so the compiled graph (and so the persistent-compilation-
        cache key) is identical across restart legs (a resume that bakes
        a different stand schedule into the graph pays a full
        recompile)."""
        batch = loop.sim.pos.shape[0]
        dtype = loop.sim.pos.dtype
        st = (stand_ticks if stand_ticks_arg is None else stand_ticks_arg)
        params_b = step_mod.broadcast_params(params, batch)
        # riccati/pdip carry the previous tick's primal (B, 12H) as the
        # cross-tick warm start (reference: ConvexQPSolver.cpp:185); a
        # zeros tick-0 carry is the cold start expressed in warm form (the
        # scan carry must keep one pytree structure across ticks).
        warm0 = (step_mod.admm_warm_init(batch, horizon, dtype)
                 if solver == "admm"
                 else jnp.zeros((batch, horizon * 12), dtype))

        def body(carry, k):
            loop, warm = carry
            cs = loop.controller
            walking = jnp.logical_and(walk_velx != 0.0, k >= st)
            mode = jnp.where(walking, 1, 0).astype(jnp.int32)
            cs = cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=jnp.broadcast_to(
                    mode, cs.ctrl.movement_mode.shape)),
                joy=cs.joy.replace(
                    velx=jnp.full((batch,), walk_velx, dtype)))
            loop = loop.replace(controller=cs)
            loop, warm = step_mod.closed_loop_tick_batched(
                loop, params_b, pattern, horizon=horizon, substeps=substeps,
                kf_type=kf_type, iters=pdip_iters, solver=solver,
                low_level_type=low_level_type, warm=warm)
            return (loop, warm), (loop.sim.pos, loop.sim.vel)

        (final, _), diag = jax.lax.scan(body, (loop, warm0),
                                        jnp.arange(n_ticks))
        return final, diag

    return rollout


def make_batched_rollout_wb(pattern: gait_mod.GaitPattern, model, *,
                            horizon=10, n_ticks=100,
                            substeps=C.SUBSTEPS_PER_MPC_TICK,
                            pdip_iters=12, kf_type=0, walk_velx=0.0,
                            solver="riccati",
                            low_level_type=0, n_inner=4, stand_ticks=20,
                            terrain=None):
    """Batched rollout against the ARTICULATED simulator (the
    Gazebo-fidelity twin as a sweep backend — reference:
    GazeboInterface.cpp:99-118 + the Gazebo physics engine). Same
    contract as `make_batched_rollout`; `loop.sim` must be a batched
    wb_sim.WbSimState (see `init_wb_loop_batch`)."""

    def rollout(loop, params):
        batch = loop.sim.q.shape[0]
        dtype = loop.sim.q.dtype
        params_b = step_mod.broadcast_params(params, batch)
        warm0 = (step_mod.admm_warm_init(batch, horizon, dtype)
                 if solver == "admm"
                 else jnp.zeros((batch, horizon * 12), dtype))

        def body(carry, k):
            loop, warm = carry
            cs = loop.controller
            walking = jnp.logical_and(walk_velx != 0.0, k >= stand_ticks)
            mode = jnp.where(walking, 1, 0).astype(jnp.int32)
            cs = cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=jnp.broadcast_to(
                    mode, cs.ctrl.movement_mode.shape)),
                joy=cs.joy.replace(
                    velx=jnp.full((batch,), walk_velx, dtype)))
            loop = loop.replace(controller=cs)
            loop, warm = step_mod.closed_loop_tick_wb_batched(
                loop, params_b, pattern, model, horizon=horizon,
                substeps=substeps, kf_type=kf_type, iters=pdip_iters,
                solver=solver,
                low_level_type=low_level_type, n_inner=n_inner,
                terrain=terrain, warm=warm)
            return (loop, warm), (loop.sim.q[:, 0:3], loop.sim.v[:, 0:3])

        (final, _), diag = jax.lax.scan(body, (loop, warm0),
                                        jnp.arange(n_ticks))
        return final, diag

    return rollout


def init_wb_loop_batch(params: RobotParams, model, batch: int, key,
                       height_range=(0.26, 0.30), dtype=jnp.float32,
                       body_height=0.28, terrain=None):
    """Batch of randomized articulated-sim loop states."""
    from legged_mpc_control_tpu.sim import wb_sim

    heights = jax.random.uniform(key, (batch,), dtype, *height_range)

    def init_one(h):
        return step_mod.LoopState(
            controller=step_mod.controller_init(params, dtype=dtype,
                                                body_height=body_height),
            sim=wb_sim.wb_sim_init(model, params, height=h, dtype=dtype,
                                   terrain=terrain))

    return jax.jit(jax.vmap(init_one))(heights)


def init_loop_batch(params: RobotParams, batch: int, key,
                    height_range=(0.27, 0.32), dtype=jnp.float32,
                    body_height=0.3):
    """Batch of randomized initial loop states. `body_height` is the
    commanded standing height (A1 0.30, Go1 0.28 — reference:
    gazebo_*_convex.yaml default body height)."""
    heights = jax.random.uniform(key, (batch,), dtype, *height_range)

    def init_one(h):
        return step_mod.LoopState(
            controller=step_mod.controller_init(params, dtype=dtype,
                                                body_height=body_height),
            sim=srb_sim.sim_init(params, height=h, dtype=dtype))

    # jit: eager vmapped init dispatches hundreds of tiny ops per scenario
    # (~minutes of host overhead at batch 4096 on the CPU mesh)
    return jax.jit(jax.vmap(init_one))(heights)
