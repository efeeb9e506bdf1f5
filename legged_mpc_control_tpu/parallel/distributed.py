"""Multi-host runtime: jax.distributed bootstrap + global scenario sweeps.

The reference's scale-out fabric is ROS pub/sub + UDP on one machine
(SURVEY.md §2.4); the replacement here is SPMD over a global (host, chip)
mesh: `jax.distributed.initialize` brings up the process group, every host
initializes only its addressable shard of the scenario batch, and one
jitted rollout runs data-parallel over the sharded batch. Scenarios are
independent, so the rollout itself needs no communication; the metric
reductions are `psum`s the compiler inserts from the replicated
out-sharding (NCCL between the GPUs of a host).

Deliverables covered (BASELINE.md): the 65,536-scenario multi-host sweep
and the >=85%-at->=2-hosts scaling-efficiency measurement (weak scaling:
fixed per-host load, efficiency = t_1host / t_Nhost).

Tested without a cluster via N CPU processes x
--xla_force_host_platform_device_count virtual devices and Gloo
collectives (tests/test_distributed.py), the same mechanism the JAX
multi-host docs prescribe.
"""

import functools
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legged_mpc_control_tpu.config import RobotParams
from legged_mpc_control_tpu.control import step as step_mod
from legged_mpc_control_tpu.mpc import gait as gait_mod
from legged_mpc_control_tpu.parallel import runner

HOST_AXIS = "host"
CHIP_AXIS = "chip"
BATCH_SPEC = P((HOST_AXIS, CHIP_AXIS))


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the jax.distributed process group.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); a no-op when num_processes <= 1 or
    the group is already initialized.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:              # already initialized
        if "already initialized" not in str(e):
            raise


def global_mesh() -> Mesh:
    """2-D (host, chip) mesh over every device in the job. jax.devices()
    orders devices by process, so rows are hosts."""
    devs = np.array(jax.devices())
    n_hosts = jax.process_count()
    return Mesh(devs.reshape(n_hosts, -1), (HOST_AXIS, CHIP_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, BATCH_SPEC)


def device_sharded_loop(params: RobotParams, global_batch: int, key,
                        mesh: Mesh, dtype=jnp.float32,
                        height_range=(0.26, 0.30), body_height=0.28):
    """Build the global scenario LoopState with each host initializing ONLY
    its addressable shards (no host ever materializes the 65k batch).

    Per-device shards are seeded by the device's global mesh position, so
    the global batch is deterministic regardless of host count."""
    devs = mesh.devices.reshape(-1)
    ndev = devs.size
    if global_batch % ndev:
        raise ValueError(f"global_batch {global_batch} % {ndev} devices")
    b_loc = global_batch // ndev

    local_trees = []
    local_devs = []
    for gidx, d in enumerate(devs):
        if d.process_index != jax.process_index():
            continue
        sub = runner.init_loop_batch(
            params, b_loc, jax.random.fold_in(key, gidx), dtype=dtype,
            height_range=height_range, body_height=body_height)
        local_trees.append(jax.device_put(sub, d))
        local_devs.append(d)

    def assemble(*leaves):
        gshape = (global_batch,) + leaves[0].shape[1:]
        spec = P((HOST_AXIS, CHIP_AXIS),
                 *([None] * (leaves[0].ndim - 1)))
        return jax.make_array_from_single_device_arrays(
            gshape, NamedSharding(mesh, spec), list(leaves))

    return jax.tree.map(assemble, *local_trees)


def replicate_global(mesh: Mesh, tree):
    """Replicate a (host-local) pytree onto every device of the global
    mesh — each process supplies its own copy (values must agree)."""
    def put(x):
        x = np.asarray(x)
        s = NamedSharding(mesh, P())
        return jax.make_array_from_callback(x.shape, s,
                                            lambda idx: x[idx])
    return jax.tree.map(put, tree)


def make_sweep(pattern: gait_mod.GaitPattern, mesh: Mesh, *, horizon=10,
               n_ticks=10, pdip_iters=15, solver="pdip",
               walk_velx=0.25, stand_ticks=20):
    """Jitted global rollout + replicated metric reduction.

    Returns sweep(loop_global, params_global) ->
      (final LoopState, metrics dict of replicated scalars).
    """
    roll = runner.make_batched_rollout(
        pattern, horizon=horizon, n_ticks=n_ticks, pdip_iters=pdip_iters,
        solver=solver, walk_velx=walk_velx, stand_ticks=stand_ticks)

    rep = NamedSharding(mesh, P())

    @jax.jit
    def metrics_of(final, diag):
        pos, vel = diag
        return {
            "mean_height": jnp.mean(final.sim.pos[:, 2]),
            "min_height": jnp.min(final.sim.pos[:, 2]),
            "mean_dx": jnp.mean(final.sim.pos[:, 0]),
            "mean_speed": jnp.mean(vel[-1][:, 0]),
            "upright_frac": jnp.mean(
                (final.sim.pos[:, 2] > 0.15).astype(jnp.float32)),
        }

    def sweep(loop, params, stand_ticks_now=None):
        """stand_ticks_now: optional per-call stand count, passed TRACED
        so every restart leg reuses one compiled graph (and so hits the
        persistent compilation cache) regardless of how much of the
        stand phase a resumed checkpoint already consumed."""
        st = jnp.asarray(stand_ticks if stand_ticks_now is None
                         else stand_ticks_now, jnp.int32)
        final, diag = jax.jit(roll)(loop, params, st)
        m = jax.jit(metrics_of, out_shardings=rep)(final, diag)
        return final, {k: float(v) for k, v in m.items()}

    return sweep


def save_sharded(path: str, tree, step: int = 0):
    """Checkpoint a globally-sharded pytree: each process writes the
    concatenation of ITS addressable shards to `path.pN` — no host ever
    gathers the global batch (utils/checkpoint.py handles the pickling).
    Resume with `load_sharded` on the same process layout."""
    from legged_mpc_control_tpu.utils import checkpoint as ckpt

    def local(x):
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards])

    ckpt.save_checkpoint(f"{path}.p{jax.process_index()}",
                         jax.tree.map(local, tree), step=step)


def load_sharded(path: str, mesh: Mesh, step_only: bool = False):
    """Restore a `save_sharded` checkpoint onto the global mesh (same
    process count / local device count). Returns (tree, step)."""
    from legged_mpc_control_tpu.utils import checkpoint as ckpt

    local_tree, step = ckpt.load_checkpoint(
        f"{path}.p{jax.process_index()}")
    if step_only:
        return None, step
    local_devs = [d for d in mesh.devices.reshape(-1)
                  if d.process_index == jax.process_index()]
    n_loc = len(local_devs)
    n_glob = mesh.devices.size

    def assemble(x):
        x = np.asarray(x)
        if x.shape[0] % n_loc:
            raise ValueError(f"shard axis {x.shape[0]} % {n_loc}")
        pieces = np.split(x, n_loc)
        arrs = [jax.device_put(p, d) for p, d in zip(pieces, local_devs)]
        gshape = (x.shape[0] * n_glob // n_loc,) + x.shape[1:]
        spec = P((HOST_AXIS, CHIP_AXIS), *([None] * (x.ndim - 1)))
        return jax.make_array_from_single_device_arrays(
            gshape, NamedSharding(mesh, spec), arrs)

    return jax.tree.map(assemble, local_tree), step


def _barrier():
    """Align every process before a timed region (collective no-op)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("weak_scaling_barrier")


def weak_scaling_report(pattern: gait_mod.GaitPattern,
                        params: RobotParams, *, per_device_batch=64,
                        horizon=10, n_ticks=5, pdip_iters=15,
                        solver="pdip", reps=3,
                        dtype=jnp.float32):
    """Weak-scaling efficiency: per-tick wall time of (rollout + replicated
    metric reduction) with the SAME per-device load on (a) a host-local
    mesh and (b) the full global mesh. efficiency = t_local / t_global
    (1.0 = perfect; BASELINE target >= 0.85 at >= 2 hosts).

    Fairness on shared hardware: all processes run BOTH phases
    concurrently, barrier-aligned — in the local phase every host still
    executes its own mesh simultaneously, so CPU/chip contention is
    identical in numerator and denominator and the ratio isolates what
    scaling actually adds: the cross-host collective (the metric psum riding
    DCN/Gloo) and multi-process dispatch. Timing the local phase with the
    other hosts idle instead would charge steady-state contention to
    "scaling" and report garbage on oversubscribed CI boxes.

    Noise on a shared box: the phases alternate call by call, so a change
    in the box's load during the run hits both. Every call starts
    barrier-aligned and lasts until its slowest host ends — in the global
    phase the psum makes every host wait for it, so the local phase is
    charged the same wait — and each phase keeps its fastest call: load
    from outside the job only ever adds time.

    Returns dict with timings + efficiency; every process reports the same
    numbers (the per-call times are gathered from all of them).
    """
    phases = {}
    for scope in ("local", "global"):
        if scope == "local":
            devs = np.array(jax.local_devices())
            mesh = Mesh(devs.reshape(1, -1), (HOST_AXIS, CHIP_AXIS))
        else:
            mesh = global_mesh()
        ndev = mesh.devices.size
        batch = per_device_batch * ndev
        loop = device_sharded_loop(params, batch, jax.random.PRNGKey(0),
                                   mesh, dtype=dtype)
        params_g = replicate_global(mesh, params)
        roll = runner.make_batched_rollout(
            pattern, horizon=horizon, n_ticks=n_ticks,
            pdip_iters=pdip_iters, solver=solver)
        rep_shard = NamedSharding(mesh, P())

        @functools.partial(jax.jit, out_shardings=rep_shard)
        def roll_and_reduce(loop, params_g):
            final, _ = roll(loop, params_g)
            # replicated scalar -> psum over every device in the mesh:
            # the cross-host communication of the product sweep
            return jnp.mean(final.sim.pos[:, 2])

        jax.block_until_ready(roll_and_reduce(loop, params_g))  # compile
        phases[scope] = (roll_and_reduce, loop, params_g)

    times = {scope: [] for scope in phases}
    for _ in range(reps):
        for scope, (fn, loop, params_g) in phases.items():
            _barrier()
            t0 = time.perf_counter()
            jax.block_until_ready(fn(loop, params_g))
            times[scope].append(time.perf_counter() - t0)
    _barrier()
    results = {}
    for scope, ts in times.items():
        ts = np.asarray(ts)
        if jax.process_count() > 1:
            # a call of the job ends when its last host ends
            from jax.experimental import multihost_utils
            ts = np.asarray(multihost_utils.process_allgather(ts)).max(0)
        results[scope] = float(ts.min()) / n_ticks

    eff = results["local"] / results["global"]
    return {
        "hosts": jax.process_count(),
        "devices_global": len(jax.devices()),
        "per_device_batch": per_device_batch,
        "tick_s_local": results["local"],
        "tick_s_global": results["global"],
        "weak_scaling_efficiency": eff,
    }
