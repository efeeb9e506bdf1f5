"""Multi-host scenario sweep driver (BASELINE: 65,536-scenario sweep).

Run one process per host (SPMD — every process executes this same program):

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 \\
    JAX_PROCESS_ID=$i python -m legged_mpc_control_tpu.sweep \\
        --scenarios 65536 --ticks 10 --velx 0.25

One process drives every local device (all four GPUs of a host); the
coordinator variables are needed only with several processes.

Prints one JSON line of replicated sweep metrics (identical on every host),
plus an optional weak-scaling efficiency report (--report-efficiency).
CPU testing: JAX_PLATFORMS=cpu with
XLA_FLAGS=--xla_force_host_platform_device_count=N per process (Gloo
collectives) — see tests/test_distributed.py.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios", type=int, default=65536)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--velx", type=float, default=0.15)
    ap.add_argument("--stand-ticks", type=int, default=20)
    ap.add_argument("--reps", type=int, default=1,
                    help="run the sweep N times and report the LAST "
                         "timing (first call pays compile; the artifact "
                         "number should be the compiled steady state)")
    ap.add_argument("--robot", default="go1", choices=["a1", "go1"])
    ap.add_argument("--solver", default="riccati",
                    choices=["riccati", "pdip", "admm"])
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--report-efficiency", action="store_true")
    ap.add_argument("--per-device-batch", type=int, default=64,
                    help="weak-scaling load per device for the report")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="write a per-host shard checkpoint of the final "
                         "loop state to PATH.pN (resume with --resume)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="restore the loop state from a --checkpoint "
                         "(same process/device layout) and continue")
    args = ap.parse_args(argv)

    from legged_mpc_control_tpu import device
    from legged_mpc_control_tpu.parallel import distributed as dist

    dist.initialize()

    import jax
    import jax.numpy as jnp

    device.enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from legged_mpc_control_tpu.config import a1_params, go1_params
    from legged_mpc_control_tpu.mpc import gait

    dtype = jnp.float64 if args.f64 else jnp.float32
    params = (a1_params if args.robot == "a1" else go1_params)(dtype)
    pattern = gait.trot_pattern(dtype)

    mesh = dist.global_mesh()
    start_tick = 0
    if args.resume:
        loop, start_tick = dist.load_sharded(args.resume, mesh)
    else:
        loop = dist.device_sharded_loop(params, args.scenarios,
                                        jax.random.PRNGKey(0), mesh,
                                        dtype=dtype)
    # flush the (async) host->device transfers NOW: the timed region
    # below measures sweep compute, not checkpoint-restore bandwidth (a
    # 65k-scenario restore is hundreds of MB)
    loop = jax.block_until_ready(loop)
    params_g = dist.replicate_global(mesh, params)
    sweep = dist.make_sweep(pattern, mesh, horizon=args.horizon,
                            n_ticks=args.ticks, pdip_iters=args.iters,
                            solver=args.solver, walk_velx=args.velx,
                            stand_ticks=args.stand_ticks)

    import time
    final = metrics = None
    n_reps = max(1, args.reps)
    for rep in range(n_reps):
        # the stand phase is consumed exactly once across resume legs AND
        # reps: leg 1 stands for (stand_ticks - start_tick), every later
        # rep continues walking (re-applying the stand schedule would
        # briefly command walkers back to stand). Passed TRACED so all
        # legs/reps share one compiled graph (cache-stable resume).
        st_now = max(0, args.stand_ticks - start_tick - rep * args.ticks)
        t0 = time.perf_counter()
        final, metrics = sweep(loop if rep == 0 else final, params_g,
                               stand_ticks_now=st_now)
        wall = time.perf_counter() - t0
    if args.checkpoint:
        # step records ALL ticks actually advanced (reps included)
        dist.save_sharded(args.checkpoint, final,
                          step=start_tick + n_reps * args.ticks)

    out = {
        "scenarios": args.scenarios,
        "start_tick": start_tick,
        "hosts": jax.process_count(),
        "device": device.device_info(),
        "ticks": args.ticks,
        "wall_s": round(wall, 3),
        "scenario_ticks_per_s": round(
            args.scenarios * args.ticks / wall, 1),
        **{k: round(v, 4) for k, v in metrics.items()},
    }
    if jax.process_index() == 0:
        print(json.dumps(out), flush=True)

    if args.report_efficiency:
        rep = dist.weak_scaling_report(
            pattern, params, per_device_batch=args.per_device_batch,
            horizon=args.horizon, n_ticks=max(2, args.ticks // 2),
            pdip_iters=args.iters, solver=args.solver, dtype=dtype)
        if jax.process_index() == 0:
            print(json.dumps({k: (round(v, 6) if isinstance(v, float)
                                  else v) for k, v in rep.items()}),
                  flush=True)


if __name__ == "__main__":
    main()
