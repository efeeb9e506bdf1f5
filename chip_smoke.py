"""Smoke test of the whole system on one NVIDIA GPU, in one process.

    python chip_smoke.py           # phases 1-5 on one card
    python chip_smoke.py --four    # only the 4-GPU sharded sweep phase

Each phase prints one line ("PHASE <name> ok ..." with what it measured and
the tolerance it was held to). The first phase that fails ends the run:
the last line is then {"ok": false, ...} and the exit code is 1. On
success the last line is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):
  1 device   JAX must run on a GPU; prints nvidia-smi's name, power limit.
  2 cli      `python -m legged_mpc_control_tpu` in-process: Go1 trot kf0
             and kf1, and the contact-implicit MPC; each upright, on GPU.
  3 fleet    Go1 trot B=4096 H=10, Riccati iters=4, kf0 and kf1: 20
             standing + 30 walking ticks; finite, upright, forward
             progress, KF error (the gates of bench.py).
  4 solver   8 H=30 problems solved in f64 on the GPU vs the CPU oracle
             (tests/oracle.py, atol 1e-4); f32 B=4096 H=30 15 iterations
             vs the f64 GPU solve of the same problems (first-stage GRFs,
             max-abs <= 0.5 N).
  5 ci_wb    contact-implicit closed loop B=256 (24 sweeps, 60 ticks)
             with the 24-vs-48-sweep distribution gate, and the
             articulated closed loop B=256 (40 ticks), at default matmul
             precision (bench.py's gates).
No phase compares a hand-written kernel: every path is plain JAX, compiled
by XLA. Scenario-ticks/s figures are printed for information only.

--four: a (1, 4) mesh over four GPUs, 4 x 4,096 scenarios, 10 ticks of the
sharded sweep (parallel/distributed.py), against the same four shards run
one after another unsharded on one card.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLEET = 4096         # scenarios: BASELINE config 3, the Go1 trot fleet
CI_WB = 256          # scenarios of the contact-implicit/articulated loops


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase_device(n_expected):
    import jax

    platform = jax.default_backend()
    check(platform == "gpu", f"JAX runs on {platform!r}, not on a GPU")
    from legged_mpc_control_tpu import device

    device.enable_compile_cache()
    info = device.device_info()
    check(info["count"] >= n_expected,
          f"{info['count']} GPU(s), {n_expected} needed")
    gpu = device.gpu_name_and_power_limit()
    check(gpu is not None, "nvidia-smi gave no card name and power limit")
    print(f"GPU {gpu}", flush=True)
    return info


def phase_cli():
    from legged_mpc_control_tpu import main as cli

    runs = {
        "go1_kf0": ["--robot", "go1", "--seconds", "1", "--velx", "0.25"],
        "go1_kf1": ["--robot", "go1", "--seconds", "1", "--velx", "0.25",
                    "--kf", "1"],
        "ci": ["--mpc", "ci", "--seconds", "0.5", "--velx", "0.1"],
    }
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0, f"{name}: exit {rc}, {summary}")
        check(summary["upright"], f"{name}: not upright, {summary}")
        check(summary["device"]["platform"] == "gpu",
              f"{name}: ran on {summary['device']}")
        out[name] = {k: summary[k] for k in ("final_height_m", "final_xy",
                                              "wall_seconds")}
    return out


def phase_fleet():
    import jax
    import jax.numpy as jnp

    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import runner

    B, velx, stand, walk = FLEET, 0.15, 20, 30
    dtype = jnp.float32
    params = go1_params(dtype)
    pattern = gait.trot_pattern(dtype)
    loop0 = runner.init_loop_batch(params, B, jax.random.PRNGKey(0),
                                   height_range=(0.26, 0.30), dtype=dtype,
                                   body_height=0.28)
    out = {}
    for kf in (0, 1):
        roll = jax.jit(runner.make_batched_rollout(
            pattern, horizon=10, n_ticks=stand + walk, pdip_iters=4,
            solver="riccati", walk_velx=velx, stand_ticks=stand,
            kf_type=kf))
        final, _ = jax.block_until_ready(roll(loop0, params))
        t0 = time.perf_counter()
        jax.block_until_ready(roll(loop0, params))
        rate = B * (stand + walk) / (time.perf_counter() - t0)
        pos = final.sim.pos
        z, x = pos[:, 2], pos[:, 0]
        check(bool(jnp.all(jnp.isfinite(pos))), f"kf{kf}: non-finite")
        check(float(jnp.min(z)) > 0.2 and float(jnp.max(z)) < 0.4,
              f"kf{kf}: fallen, z in [{float(jnp.min(z))}, "
              f"{float(jnp.max(z))}]")
        # 30 walking ticks (0.3 s) at 0.15 m/s: every scenario moved ahead
        progress = 0.5 * velx * walk * 0.01
        check(float(jnp.min(x)) > progress,
              f"kf{kf}: min progress {float(jnp.min(x))} <= {progress}")
        res = {"mean_z": float(jnp.mean(z)), "min_x": float(jnp.min(x)),
               "scenario_ticks_per_s": round(rate, 1)}
        if kf == 1:
            err = jnp.abs(final.controller.kf.x[:, 0:3] - pos)
            ez, exy = float(jnp.mean(err[:, 2])), float(
                jnp.mean(err[:, 0:2]))
            check(ez < 0.025 and exy < 0.04,
                  f"kf1 estimate off truth: z {ez} m, xy {exy} m")
            res.update(kf_err_z=ez, kf_err_xy=exy)
        out[f"kf{kf}"] = res
    return out


def _oracle_problems(n, H):
    """n H=30 problems as in tests/test_qp.py (yaw turn, random contact
    schedules), their stagewise data and the oracle's GRFs."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import solve_qp_oracle

    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import qp_builder, reference
    from legged_mpc_control_tpu.ops import so3

    f64 = jnp.float64
    params = go1_params(f64)
    dt = 0.01
    probs, want = [], []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        contact = (rng.uniform(size=(H, 4)) > 0.4).astype(float)
        contact[0] = 1.0
        x0 = np.zeros(12)
        x0[2], x0[5] = 0.7, 0.28
        x0 = jnp.asarray(x0, f64)
        R = so3.quat_to_rotmat(so3.euler_to_quat(x0[0:3]))
        cmd = reference.MpcCmd(
            root_pos_d=jnp.array([0.0, 0.0, 0.3], f64),
            root_euler_d=jnp.array([0.0, 0.0, 0.7], f64),
            root_lin_vel_d_rel=jnp.array([0.3, 0.1, 0.0], f64),
            root_ang_vel_d_rel=jnp.array([0.0, 0.0, 0.5], f64))
        x_ref, yaw_ref, _ = reference.build_reference(
            x0[0:3], x0[3:6], R, cmd, H, dt)
        fpa = (R @ params.default_foot_pos.T).T
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass, params.trunk_inertia, R, fpa, dt)
        c = jnp.asarray(contact, f64)
        probs.append((x0, x_ref, A_seq, Bm, c))
        Hs, g, Ac, lb, ub = (np.asarray(a) for a in
                             qp_builder.reference_sparse_qp(
                                 x0, x_ref, A_seq, Bm, c, params.q_weights,
                                 params.r_weights, params.mu,
                                 params.fz_max, dt))
        z = solve_qp_oracle(Hs, g, Ac, lb, ub)
        want.append(np.concatenate([z[k * 24:k * 24 + 12]
                                    for k in range(H)]))
    stacked = [jnp.stack(a) for a in zip(*probs)]
    return params, stacked, np.stack(want)


def phase_solver():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge
    from legged_mpc_control_tpu.mpc import riccati

    jax.config.update("jax_enable_x64", True)
    try:
        H = 30
        params, (x0, x_ref, A_seq, Bm, c), want = _oracle_problems(8, H)
        got = riccati.solve_qp_riccati_batched(
            x0, x_ref, A_seq, Bm, c, params.q_weights, params.r_weights,
            params.mu, params.fz_max, 0.01, iters=25).u
        err64 = float(np.max(np.abs(np.asarray(got) - want)))
        check(err64 <= 1e-4, f"f64 H=30 vs oracle: {err64} > 1e-4")

        # f32 at B=4096, 15 iterations, vs the f64 solve of the same batch
        p64, x64_, c64 = ge._make_problem_batch(FLEET, H, jnp.float64)
        p32, x32_, c32 = ge._make_problem_batch(FLEET, H, jnp.float32)
        u64 = jax.jit(ge._solve_batch_fn(p64, H, iters=25))(x64_, c64)
        u32 = jax.jit(ge._solve_batch_fn(p32, H, iters=15))(x32_, c32)
        err32 = float(jnp.max(jnp.abs(u32.astype(jnp.float64) - u64)))
        check(bool(jnp.all(jnp.isfinite(u32))), "f32 solve non-finite")
        check(err32 <= 0.5, f"f32 vs f64 first-stage GRFs: {err32} > 0.5 N")
    finally:
        jax.config.update("jax_enable_x64", False)
    return {"f64_vs_oracle_max_abs": err64, "f64_tol": 1e-4,
            "f32_vs_f64_max_abs_N": err32, "f32_tol_N": 0.5}


def _lci_roll(params, stand, walk, n_ticks):
    """Jitted n-tick batched closed loop through the CI seam."""
    import jax
    import jax.numpy as jnp

    from legged_mpc_control_tpu.control import step as step_mod

    def roll(loop, lci):
        def body(carry, k):
            loop, lci = carry
            t = 0.01 * k.astype(loop.sim.pos.dtype)
            return step_mod.closed_loop_tick_lci_batched(
                loop, lci, params, stand, walk, t), None
        return jax.lax.scan(body, (loop, lci), jnp.arange(n_ticks))[0]
    return jax.jit(roll)


def phase_ci_wb():
    """Contact-implicit closed loop (24 sweeps, its 24-vs-48 gate) and
    articulated closed loop, at default matmul precision."""
    import jax
    import jax.numpy as jnp

    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.models import whole_body as wb
    from legged_mpc_control_tpu.mpc import ci_mpc, gait, lci_mpc
    from legged_mpc_control_tpu.parallel import runner
    from legged_mpc_control_tpu.sim import terrain as terrain_mod

    dtype = jnp.float32
    params = a1_params(dtype)
    terr = terrain_mod.flat(dtype=dtype)
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)

    def start(b, key, walk):
        loop = runner.init_loop_batch(params, b, jax.random.PRNGKey(key),
                                      dtype=dtype)
        cs = loop.controller
        loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
            movement_mode=jnp.ones((b,), jnp.int32))))
        return loop, lci_mpc.lci_init_batched(
            b, dtype=dtype, policy_warm=walk.warm_init(b, dtype))

    # bench.py's gate: the 24-sweep operating point lands in the same body
    # statistics as the terrain-grade 48 sweeps (60 ticks); the 24-sweep
    # run is also the upright check and the timed loop
    out, fin = {}, {}
    for it in (24, 48):
        walk = ci_mpc.make_ci_walk_policy_batched(params, terrain=terr,
                                                  velx=0.1, iters=it)
        roll = _lci_roll(params, stand, walk, 60)
        init = start(CI_WB, 7, walk)
        fin[it] = jax.block_until_ready(roll(*init))[0].sim.pos
        if it == 24:
            t0 = time.perf_counter()
            jax.block_until_ready(roll(*init))
            out["ci_scenario_ticks_per_s"] = round(
                CI_WB * 60 / (time.perf_counter() - t0), 1)
    for axis, tol, what in ((2, 0.01, "height"), (0, 0.02, "progress")):
        d = abs(float(jnp.mean(fin[24][:, axis]))
                - float(jnp.mean(fin[48][:, axis])))
        check(d < tol, f"CI 24 vs 48 sweeps: mean {what} differs by {d}")
        out[f"ci_24v48_mean_{what}_diff"] = d
    z = fin[24][:, 2]
    check(bool(jnp.all(jnp.isfinite(fin[24]))), "CI non-finite")
    check(float(jnp.min(z)) > 0.15, f"CI fell: min z {float(jnp.min(z))}")
    out["ci_min_z"] = float(jnp.min(z))

    # articulated: 30 standing + 10 walking ticks (bench.py's gains)
    wb_params = params.replace(kp_foot=jnp.full(3, 40.0, dtype),
                               kd_foot=jnp.full(3, 1.2, dtype))
    model = wb.a1_wb_model()
    roll = jax.jit(runner.make_batched_rollout_wb(
        gait.trot_pattern(dtype), model, horizon=10, n_ticks=40,
        pdip_iters=8, walk_velx=0.2, solver="riccati", stand_ticks=30))
    loop0 = runner.init_wb_loop_batch(wb_params, model, CI_WB,
                                      jax.random.PRNGKey(0), dtype=dtype)
    final, _ = jax.block_until_ready(roll(loop0, wb_params))
    t0 = time.perf_counter()
    jax.block_until_ready(roll(loop0, wb_params))
    z = final.sim.q[:, 2]
    check(bool(jnp.all(jnp.isfinite(final.sim.q))), "articulated non-finite")
    check(0.15 < float(jnp.mean(z)) < 0.4,
          f"articulated: mean height {float(jnp.mean(z))}")
    out["wb_mean_z"] = float(jnp.mean(z))
    out["wb_scenario_ticks_per_s"] = round(
        CI_WB * 40 / (time.perf_counter() - t0), 1)
    return out


def phase_four():
    import jax
    import jax.numpy as jnp

    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import distributed as dist
    from legged_mpc_control_tpu.parallel import runner

    per, n_dev, ticks = FLEET, 4, 10
    dtype = jnp.float32
    params = go1_params(dtype)
    pattern = gait.trot_pattern(dtype)
    key = jax.random.PRNGKey(0)
    kw = dict(horizon=10, n_ticks=ticks, pdip_iters=15, solver="riccati",
              walk_velx=0.15, stand_ticks=0)
    mesh = dist.global_mesh()
    check(mesh.devices.shape == (1, n_dev), f"mesh {mesh.devices.shape}")
    loop = dist.device_sharded_loop(params, per * n_dev, key, mesh,
                                    dtype=dtype)
    sweep = dist.make_sweep(pattern, mesh, **kw)
    final, metrics = sweep(loop, dist.replicate_global(mesh, params))
    t0 = time.perf_counter()
    final, metrics = sweep(loop, dist.replicate_global(mesh, params))
    wall4 = time.perf_counter() - t0

    # the same four shards, unsharded, one after another on one card
    roll = jax.jit(runner.make_batched_rollout(pattern, **kw))
    dev0 = jax.devices()[0]
    finals, speeds = [], []
    for gidx in range(n_dev):
        sub = jax.device_put(runner.init_loop_batch(
            params, per, jax.random.fold_in(key, gidx), dtype=dtype,
            height_range=(0.26, 0.30), body_height=0.28), dev0)
        f, (pos, vel) = roll(sub, jax.device_put(params, dev0))
        finals.append(f.sim.pos)
        speeds.append(vel[-1][:, 0])
    pos1 = jnp.concatenate(finals)
    ref = {"mean_height": float(jnp.mean(pos1[:, 2])),
           "min_height": float(jnp.min(pos1[:, 2])),
           "mean_dx": float(jnp.mean(pos1[:, 0])),
           "mean_speed": float(jnp.mean(jnp.concatenate(speeds))),
           "upright_frac": float(jnp.mean(pos1[:, 2] > 0.15))}
    dz = abs(metrics["mean_height"] - ref["mean_height"])
    dx = abs(metrics["mean_dx"] - ref["mean_dx"])
    check(dz < 1e-3, f"mean height differs by {dz} m")
    check(dx < 0.02, f"mean progress differs by {dx} m")
    check(metrics["upright_frac"] == ref["upright_frac"],
          f"upright fraction {metrics['upright_frac']} vs "
          f"{ref['upright_frac']}")
    return {"sharded": metrics, "unsharded": ref, "mean_height_diff": dz,
            "mean_progress_diff": dx,
            "sharded_scenario_ticks_per_s": round(
                per * n_dev * ticks / wall4, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded sweep phase")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    phases = [("device", lambda: phase_device(n_dev))]
    if args.four:
        phases.append(("four", phase_four))
    else:
        phases += [("cli", phase_cli), ("fleet", phase_fleet),
                   ("solver", phase_solver), ("ci_wb", phase_ci_wb)]
    info = None
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:            # report the failed phase, stop
            print(f"PHASE {name} FAILED after "
                  f"{time.perf_counter() - t0:.1f} s: {e!r}", flush=True)
            print(json.dumps({"ok": False, "phase": name,
                              "error": repr(e)}), flush=True)
            return 1
        if name == "device":
            info = res
        print(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s) "
              f"{json.dumps(res)}", flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
