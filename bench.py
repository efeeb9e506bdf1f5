"""Benchmarks: convex-MPC solver + closed-loop throughput on one device.

Prints the device (JAX's platform, kind and count, and on a GPU the card's
name and power limit from nvidia-smi) first, then one JSON line per metric:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
A metric that fails prints {"metric": ..., "error": ...} instead, and the
run exits non-zero. The HEADLINE metric
(convex_mpc_solves_per_s_per_chip_go1_trot_h10, target >= 10,000 solves/s,
BASELINE.md) is printed LAST.

Metrics:
  * closed_loop_scenario_ticks_per_s_b4096_h10 — BASELINE config 3: 4,096
    domain-randomized scenarios in closed loop (feedback + estimation +
    gait + batched QP + low-level + SRB sim). vs_baseline = real-time
    factor against
    4096 scenarios x 100 Hz MPC (the reference's 10 ms budget,
    LeggedParams.h:7).
  * convex_mpc_solves_per_s_per_chip_go1_trot_h30 — the reference's actual
    H=30 horizon (LeggedParams.h:13), same 10k target.
  * qp_solve_latency_ms_b1_h10_cold_pdip / _warm_admm30 — single-scenario
    MPC tick latency vs the ~2 ms 500 Hz-parity budget (BASELINE.md);
    warm ADMM mirrors the reference's OSQP warm-start operating mode
    (ConvexQPSolver.cpp:185).
  * qp_solve_latency_ms_b1_h10_riccati / _warm_riccati8 — the PRODUCT
    DEFAULT solver's B=1 latency, cold (15 iters) and cross-tick
    warm-started (8 iters, gated on matching a 40-iter converged solve to
    0.5 N) — the documented 500 Hz product config.
  * weak_scaling_efficiency_2host_cpu_proxy — BASELINE "≥85% scaling to 2+
    hosts", measured on a 2-process Gloo CPU mesh in child processes that
    never touch the accelerator (the proxy exercises the real
    jax.distributed + psum path; it is not a device number).

Measurement hygiene: inputs are cycled across timed repetitions, so no
timed call repeats the previous one's exact inputs.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import device

_DEVICE = None


def emit(metric, value, unit, vs_baseline):
    print(json.dumps({"metric": metric, "value": round(value, 3),
                      "unit": unit, "vs_baseline": round(vs_baseline, 3),
                      "device": _DEVICE}), flush=True)


def _timeit(fn, variants, n_rep):
    out = None
    t0 = time.perf_counter()
    for i in range(n_rep):
        out = fn(*variants[i % len(variants)])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_rep


def bench_throughput(ge, solver, horizon, batch, iters=15):
    """Batched solve throughput at the given horizon: "riccati" (stagewise
    IPM) or "pdip" (QP condensation + dense IPM)."""
    dtype = jnp.float32
    params, x0, contact = ge._make_problem_batch(batch, horizon, dtype)
    fn = jax.jit(ge._solve_batch_fn(params, horizon, iters=iters,
                                    solver=solver))
    variants = [(x0 + 1e-3 * k, contact) for k in range(4)]
    out = fn(*variants[0])
    out.block_until_ready()
    # solution sanity: all finite, stance legs carry weight. A solver that
    # emits NaNs must never win the benchmark.
    assert bool(jnp.all(jnp.isfinite(out))), "non-finite GRFs"
    mean_fz = float(jnp.mean(jnp.sum(out[:, 2:12:3], axis=-1)))
    assert 0.3 * 9.8 * float(params.mass) < mean_fz < 2.0 * 9.8 * float(
        params.mass), f"implausible stance load {mean_fz}"
    dt = _timeit(fn, variants, n_rep=8)
    return batch / dt


def bench_closed_loop(batch=4096, horizon=10, n_ticks=10, iters=4,
                      velx=0.15):
    """Closed-loop scenario-ticks/s: full tick (feedback + MPC + 8 substeps
    of low-level + sim) with the batch ACTUALLY TROTTING (stand 20 ticks,
    then movement_mode=1 at `velx` — the Go1 product operating point).

    iters=4 is the warm-started closed-loop operating point: the rollout
    carries each tick's primal to the next (reference:
    ConvexQPSolver.cpp:185). Untimed gates run first on a 120-tick
    walking rollout at B=64:
      * fidelity vs a 20-iteration run — DISTRIBUTIONAL, because contact
        make/break is chaotic and max-abs trajectory deviation saturates
        at foot-placement scale even for iters=19 vs 20: mean-abs
        position deviation < 2 mm across the batch and mean height
        within 1 mm (measured: 1.45 mm / 0.01 mm at iters=4; iters=3 is
        past the cliff and NaNs, which the finiteness gate catches);
      * quality — every scenario ends upright at trot height with
        forward progress, so the bench cannot win by measuring fallen or
        standing-still robots;
      * per-solve accuracy at B=1 is gated separately by
        qp_solve_latency_ms_b1_h10_warm_riccati8 (0.5 N vs 40 iters)."""
    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import runner

    dtype = jnp.float32
    params = go1_params(dtype)
    pattern = gait.trot_pattern(dtype)

    def make(n, it):
        return jax.jit(runner.make_batched_rollout(
            pattern, horizon=horizon, n_ticks=n, pdip_iters=it,
            solver="riccati", walk_velx=velx,
            stand_ticks=20))

    def init(b, k):
        return runner.init_loop_batch(
            params, b, jax.random.PRNGKey(k), height_range=(0.26, 0.30),
            dtype=dtype, body_height=0.28)

    # --- fidelity + quality gates (small batch, 120 ticks, untimed) ---
    loop64 = init(64, 9)
    ref_out, probe_out = [make(120, it)(loop64, params)[0]
                          for it in (20, iters)]
    assert bool(jnp.all(jnp.isfinite(probe_out.sim.pos))), \
        f"non-finite states at iters={iters}"
    mean_dev = float(jnp.mean(jnp.abs(probe_out.sim.pos
                                      - ref_out.sim.pos)))
    assert mean_dev < 2e-3, \
        f"warm iters={iters} diverges from converged: {mean_dev}"
    dz = abs(float(jnp.mean(probe_out.sim.pos[:, 2])
                   - jnp.mean(ref_out.sim.pos[:, 2])))
    assert dz < 1e-3, f"height distribution shifted: {dz}"
    z = probe_out.sim.pos[:, 2]
    x = probe_out.sim.pos[:, 0]
    assert float(jnp.min(z)) > 0.2 and float(jnp.max(z)) < 0.4, \
        f"fallen scenarios in the gate rollout: z={z}"
    assert float(jnp.min(x)) > 0.5 * velx * 1.0, \
        f"no forward progress: x={x}"
    # --- timed: 10 walking ticks from a walked-in state (stand_ticks=0:
    # every timed tick is a full mode-1 trot tick) ---
    roll = jax.jit(runner.make_batched_rollout(
        pattern, horizon=horizon, n_ticks=n_ticks, pdip_iters=iters,
        solver="riccati", walk_velx=velx, stand_ticks=0))
    warmup = make(30, iters)
    variants = []
    for k in range(2):
        walked, _ = warmup(init(batch, k), params)
        variants.append((jax.block_until_ready(walked), params))
    final, _ = roll(*variants[0])
    jax.block_until_ready(final)
    mean_h = float(jnp.mean(final.sim.pos[:, 2]))
    assert 0.2 < mean_h < 0.4, f"implausible closed-loop height {mean_h}"
    dt = _timeit(roll, variants, n_rep=4)
    return batch * n_ticks / dt


def bench_closed_loop_kf1(batch=4096, horizon=10, n_ticks=10, iters=4,
                          velx=0.15):
    """Closed-loop throughput WITH THE STATE ESTIMATOR IN THE LOOP
    (kf_type=1): the 18-state contact-gated KF runs inside every substep
    and the controller consumes its estimates
    — the reference's live configuration (estimation_update every
    feedback tick, BaseInterface.cpp:404-449; hardware forbids the
    kf_type=0 bypass, main.cpp:97-100). Untimed gates: estimator accuracy
    (mean |pos_est - pos_true| < 1 cm on a 120-tick walk) and the same
    upright/progress quality gates as the kf0 bench."""
    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import runner

    dtype = jnp.float32
    params = go1_params(dtype)
    pattern = gait.trot_pattern(dtype)

    def make(n, it):
        return jax.jit(runner.make_batched_rollout(
            pattern, horizon=horizon, n_ticks=n, pdip_iters=it,
            solver="riccati", walk_velx=velx,
            stand_ticks=20, kf_type=1))

    def init(b, k):
        return runner.init_loop_batch(
            params, b, jax.random.PRNGKey(k), height_range=(0.26, 0.30),
            dtype=dtype, body_height=0.28)

    # --- estimator + quality gates (small batch, 120 ticks, untimed) ---
    final64, diag = make(120, iters)(init(64, 9), params)
    z = final64.sim.pos[:, 2]
    x = final64.sim.pos[:, 0]
    assert bool(jnp.all(jnp.isfinite(final64.sim.pos))), "non-finite kf1"
    assert float(jnp.min(z)) > 0.2 and float(jnp.max(z)) < 0.4, \
        f"fallen kf1 scenarios: z={z}"
    assert float(jnp.min(x)) > 0.5 * velx * 1.0, f"no progress: x={x}"
    # estimator accuracy: the KF ingests FK measurements from the
    # controller's DELIBERATELY-mismatched leg kinematics (rho_fix vs the
    # simulated robot's geometry), so a cm-scale systematic bias is the
    # faithful behavior — the same bias the hardware filter carries; z is
    # still anchored by the flat-ground foot heights, and absolute xy
    # additionally integrates odometric drift (the reference suppresses
    # xy covariance for exactly this reason, BasicKF.cpp:146)
    err = jnp.abs(final64.controller.kf.x[:, 0:3] - final64.sim.pos)
    ez = float(jnp.mean(err[:, 2]))
    exy = float(jnp.mean(err[:, 0:2]))
    assert ez < 0.025, f"KF z estimate off truth by {ez} m"
    assert exy < 0.04, f"KF xy drift {exy} m over 1.2 s"

    # --- timed: walked-in warm state, every tick a full kf1 trot tick ---
    roll = jax.jit(runner.make_batched_rollout(
        pattern, horizon=horizon, n_ticks=n_ticks, pdip_iters=iters,
        solver="riccati", walk_velx=velx, stand_ticks=0,
        kf_type=1))
    warmup = make(30, iters)
    variants = []
    for k in range(2):
        walked, _ = warmup(init(batch, k), params)
        variants.append((jax.block_until_ready(walked), params))
    final, _ = roll(*variants[0])
    jax.block_until_ready(final)
    mean_h = float(jnp.mean(final.sim.pos[:, 2]))
    assert 0.2 < mean_h < 0.4, f"implausible kf1 height {mean_h}"
    dt = _timeit(roll, variants, n_rep=4)
    return batch * n_ticks / dt


def bench_latency(ge, horizon=10, warm_admm=False):
    """Single-scenario tick latency (ms): QP build + condensed solve (cold
    PDIP, or warm-started ADMM), batch = 1."""
    from legged_mpc_control_tpu.mpc import admm

    dtype = jnp.float32
    params, x0, contact = ge._make_problem_batch(1, horizon, dtype)

    if not warm_admm:
        fn = jax.jit(ge._solve_batch_fn(params, horizon, iters=15,
                                        solver="pdip"))
        variants = [(x0 + 1e-4 * k, contact) for k in range(8)]
    else:
        build = ge._qp_batch_fn(params, horizon)

        def solve_warm(x0s, contacts, warm):
            qp = build(x0s, contacts)
            res = admm.solve_qp_admm_batched(
                qp.P, qp.q, params.mu, params.fz_max, contacts,
                iters=30, warm=warm)
            return res.u[:, :12], res.warm

        fn0 = jax.jit(solve_warm)
        # cold solve of a neighboring tick's QP provides the warm tuple —
        # the cross-tick reuse pattern of the closed loop
        qp0 = jax.jit(build)(x0, contact)
        cold = admm.solve_qp_admm_batched(
            qp0.P, qp0.q, params.mu, params.fz_max, contact,
            iters=200)
        warm = jax.block_until_ready(cold.warm)

        def fn(x0s, contacts):
            u, _w = fn0(x0s, contacts, warm)
            return u
        variants = [(x0 + 1e-4 * k, contact) for k in range(8)]

    out = fn(*variants[0])
    jax.block_until_ready(out)
    dt = _timeit(fn, variants, n_rep=30)
    return dt * 1e3


def bench_latency_riccati(ge, horizon=10, warm=False, iters=None):
    """B=1 latency of the PRODUCT DEFAULT solver (stagewise Riccati IPM).

    warm=True measures the closed-loop steady state: tick t's converged
    solution, shift-aligned (riccati.warm_shift) to tick t+1's contact
    schedule, warm-starts an 8-iteration solve — the cross-tick reuse the
    reference gets from OSQP's setWarmStart(true) (ConvexQPSolver.cpp:185).
    The warm solve is GATED on matching a 40-iteration converged solve to
    0.5 N max-abs so the bench cannot win by under-iterating.
    """
    from legged_mpc_control_tpu.mpc import riccati

    dtype = jnp.float32
    if iters is None:
        iters = 8 if warm else 15
    params, x0, contact = ge._make_problem_batch(1, horizon, dtype)
    lin = ge._lin_batch_fn(params, horizon)

    def solve(x0s, contacts, warm_u, n_it):
        x_ref, A_seq, Bm = lin(x0s)
        wu = None if warm_u is None else riccati.warm_shift(warm_u, contacts)
        return riccati.solve_qp_riccati_batched(
            x0s, x_ref, A_seq, Bm, contacts, params.q_weights,
            params.r_weights, params.mu, params.fz_max, 0.01,
            iters=n_it, warm_u=wu).u

    if not warm:
        fn = jax.jit(lambda a, c: solve(a, c, None, iters))
        variants = [(x0 + 1e-4 * k, contact) for k in range(8)]
    else:
        # tick t: converged solve on the previous schedule; tick t+1: the
        # schedule advances one stage, the state drifts a little
        u_prev = jax.jit(lambda a, c: solve(a, c, None, 40))(x0, contact)
        u_prev = jax.block_until_ready(u_prev)
        contact2 = jnp.concatenate([contact[:, 1:], contact[:, -1:]], axis=1)
        fn = jax.jit(lambda a, c, w: solve(a, c, w, iters))
        got = fn(x0 + 1e-4, contact2, u_prev)
        want = jax.jit(lambda a, c, w: solve(a, c, w, 40))(
            x0 + 1e-4, contact2, u_prev)
        err = float(jnp.max(jnp.abs(got - want)))
        assert err < 0.5, f"warm-{iters} off converged by {err} N"
        base = (x0 + 1e-4, contact2, u_prev)
        variants = [(base[0] + 1e-4 * k, contact2, u_prev) for k in range(8)]

    out = fn(*variants[0])
    jax.block_until_ready(out)
    dt = _timeit(fn, variants, n_rep=30)
    return dt * 1e3


def bench_latency_pdip_warm(ge, horizon=10, iters=8):
    """B=1 latency of the CONDENSED PDIP solver warm-started across ticks
    — the oracle-accuracy path at its closed-loop operating point (the
    cold 15-iter number is the worst-case first tick; the loop itself
    always has the previous tick's primal, exactly like the reference's
    OSQP setWarmStart(true), ConvexQPSolver.cpp:185). GATED on matching a
    40-iteration converged solve to 0.5 N so it cannot win by
    under-iterating."""
    from legged_mpc_control_tpu.mpc import pdip, riccati

    dtype = jnp.float32
    params, x0, contact = ge._make_problem_batch(1, horizon, dtype)
    build = ge._qp_batch_fn(params, horizon)

    def solve(x0s, contacts, warm_u, n_it):
        qp = build(x0s, contacts)
        res = pdip.solve_qp_pdip_batched(
            qp.P, qp.q, params.mu, params.fz_max, contacts,
            iters=n_it, warm_u=warm_u)
        return res.u

    # tick t: converged solve; tick t+1: schedule shifts one stage
    u_prev = jax.jit(lambda a, c: solve(a, c, None, 40))(x0, contact)
    u_prev = jax.block_until_ready(u_prev)
    contact2 = jnp.concatenate([contact[:, 1:], contact[:, -1:]], axis=1)
    wu = riccati.warm_shift(u_prev, contact2)
    fn = jax.jit(lambda a, c, w: solve(a, c, w, iters))
    got = fn(x0 + 1e-4, contact2, wu)
    want = jax.jit(lambda a, c, w: solve(a, c, w, 40))(
        x0 + 1e-4, contact2, wu)
    err = float(jnp.max(jnp.abs(got - want)))
    assert err < 0.5, f"warm-{iters} PDIP off converged by {err} N"
    variants = [(x0 + 1e-4 * k, contact2, wu) for k in range(8)]
    out = fn(*variants[0])
    jax.block_until_ready(out)
    dt = _timeit(fn, variants, n_rep=30)
    return dt * 1e3


def bench_ci_latency(iters=32, horizon=10):
    """B=1 latency (ms) of one contact-implicit MPC policy evaluation —
    the `--mpc ci` product path's MPC-thread body (FB-complementarity
    GN-iLQR, mpc/ci_mpc.make_ci_walk_policy), warm-started across ticks
    exactly as the closed loop runs it (LciState.policy_warm). The
    reference runs its CI-MPC inside the same 10 ms MPC-thread budget as
    the convex backend (reference: main.cpp:130-163)."""
    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.mpc import ci_mpc
    from legged_mpc_control_tpu.sim import terrain as terrain_mod

    dtype = jnp.float32
    params = a1_params(dtype)
    terr = terrain_mod.flat(dtype=dtype)
    policy = ci_mpc.make_ci_walk_policy(params, terrain=terr, velx=0.1,
                                        horizon=horizon, iters=iters)
    pos = jnp.array([0.0, 0.0, 0.3], dtype)
    feet = params.default_foot_pos.astype(dtype) + pos[None, :]
    x = jnp.concatenate([pos, jnp.zeros(3, dtype),
                         (feet - pos[None, :]).reshape(-1),
                         jnp.array([0.1, 0.0, 0.0], dtype),
                         jnp.zeros(3, dtype), jnp.zeros(12, dtype),
                         jnp.full((4,), 30.0, dtype)])
    fn = jax.jit(lambda xx, t, w: policy(xx, t, w))
    out0, warm = fn(x, jnp.float32(0.0), policy.warm_init(dtype))
    warm = jax.block_until_ready(warm)
    assert bool(jnp.all(jnp.isfinite(out0))), "non-finite CI output"
    variants = [(x + 1e-4 * k, jnp.float32(0.01 * k), warm)
                for k in range(8)]

    def run(xx, t, w):
        out, _w = fn(xx, t, w)
        return out
    run(*variants[0])
    dt = _timeit(run, variants, n_rep=20)
    return dt * 1e3


def bench_ci_closed_loop(batch=256, n_ticks=10, iters=24):
    """CI-backend closed-loop throughput: the BATCH-NATIVE
    `closed_loop_tick_lci_batched` (one ci_solve_batched per tick —
    batched Cholesky gain solves, analytic Jacobians — + the substep
    chain) over a scenario batch, timed from a walked-in
    warm-started state (every timed tick is a warm trot tick, matching
    how the closed loop actually runs). vs_baseline = real-time factor
    against batch x 100 Hz (the reference's 10 ms MPC budget,
    LeggedParams.h:7)."""
    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.control import step as step_mod
    from legged_mpc_control_tpu.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu.parallel import runner
    from legged_mpc_control_tpu.sim import terrain as terrain_mod

    dtype = jnp.float32
    params = a1_params(dtype)
    terr = terrain_mod.flat(dtype=dtype)
    walk = ci_mpc.make_ci_walk_policy_batched(params, terrain=terr,
                                              velx=0.1, iters=iters)
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)

    def make_roll(n, t0):
        def roll(loop, lci):
            def body(carry, k):
                loop, lci = carry
                loop, lci = step_mod.closed_loop_tick_lci_batched(
                    loop, lci, params, stand, walk,
                    t0 + 0.01 * k.astype(dtype), terrain=None)
                return (loop, lci), None
            (loop, lci), _ = jax.lax.scan(body, (loop, lci),
                                          jnp.arange(n))
            return loop, lci
        return jax.jit(roll)

    def init(k):
        loop = runner.init_loop_batch(params, batch, jax.random.PRNGKey(k),
                                      dtype=dtype)
        cs = loop.controller
        cs = cs.replace(ctrl=cs.ctrl.replace(
            movement_mode=jnp.ones((batch,), jnp.int32)))
        loop = loop.replace(controller=cs)
        lci = lci_mpc.lci_init_batched(
            batch, dtype=dtype, policy_warm=walk.warm_init(batch, dtype))
        return (loop, lci)

    # --- fidelity gate (untimed): the timed 24-sweep warm operating
    # point must land in the same DISTRIBUTION as a 48-sweep run (the
    # terrain-grade sweep count) — contact make/break is chaotic, so the
    # body statistics are the semantic contract, as in bench_closed_loop
    def gate_roll(it):
        w = ci_mpc.make_ci_walk_policy_batched(params, terrain=terr,
                                               velx=0.1, iters=it)

        def roll(loop, lci):
            def body(carry, k):
                loop, lci = carry
                loop, lci = step_mod.closed_loop_tick_lci_batched(
                    loop, lci, params, stand, w,
                    0.01 * k.astype(dtype), terrain=None)
                return (loop, lci), None
            (loop, lci), _ = jax.lax.scan(body, (loop, lci),
                                          jnp.arange(60))
            return loop, lci
        return jax.jit(roll), w

    g24, w24 = gate_roll(iters)
    g48, w48 = gate_roll(48)
    loop32 = runner.init_loop_batch(params, 32, jax.random.PRNGKey(7),
                                    dtype=dtype)
    cs32 = loop32.controller
    cs32 = cs32.replace(ctrl=cs32.ctrl.replace(
        movement_mode=jnp.ones((32,), jnp.int32)))
    loop32 = loop32.replace(controller=cs32)
    out24, _ = g24(loop32, lci_mpc.lci_init_batched(
        32, dtype=dtype, policy_warm=w24.warm_init(32, dtype)))
    out48, _ = g48(loop32, lci_mpc.lci_init_batched(
        32, dtype=dtype, policy_warm=w48.warm_init(32, dtype)))
    for a, b, tol, what in (
            (out24.sim.pos[:, 2], out48.sim.pos[:, 2], 0.01, "height"),
            (out24.sim.pos[:, 0], out48.sim.pos[:, 0], 0.02, "progress")):
        d = abs(float(jnp.mean(a)) - float(jnp.mean(b)))
        assert d < tol, f"warm iters={iters} diverges in mean {what}: {d}"
    assert float(jnp.min(out24.sim.pos[:, 2])) > 0.15, "gate run fell"

    # walk in for 20 ticks (untimed) so every timed tick is a warm,
    # mid-trot tick; two variants so repeated timing can't be served from
    # a result cache
    warmup = make_roll(20, jnp.asarray(0.0, dtype))
    roll = make_roll(n_ticks, jnp.asarray(0.2, dtype))
    variants = []
    for k in range(2):
        variants.append(jax.block_until_ready(warmup(*init(k))))
    out = roll(*variants[0])
    jax.block_until_ready(out)
    final_z = out[0].sim.pos[:, 2]
    assert float(jnp.min(final_z)) > 0.15, "CI scenarios fell in bench"
    assert bool(jnp.all(jnp.isfinite(out[0].sim.pos))), "non-finite CI"
    dt = _timeit(roll, variants, n_rep=2)
    return batch * n_ticks / dt


def bench_wb_closed_loop(batch=256, n_ticks=10, iters=8):
    """Closed-loop throughput on the ARTICULATED whole-body simulator —
    the Gazebo-fidelity twin as a batched sweep backend
    (runner.make_batched_rollout_wb): full rigid-body dynamics, compliant
    contact, batched mass-matrix solves. vs_baseline =
    real-time factor against batch x 100 Hz."""
    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.models import whole_body as wb
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import runner

    dtype = jnp.float32
    params = a1_params(dtype).replace(kp_foot=jnp.full(3, 40.0, dtype),
                                      kd_foot=jnp.full(3, 1.2, dtype))
    model = wb.a1_wb_model()
    pattern = gait.trot_pattern(dtype)

    warmup = jax.jit(runner.make_batched_rollout_wb(
        pattern, model, horizon=10, n_ticks=40, pdip_iters=iters,
        walk_velx=0.2, solver="riccati", stand_ticks=30))
    roll = jax.jit(runner.make_batched_rollout_wb(
        pattern, model, horizon=10, n_ticks=n_ticks, pdip_iters=iters,
        walk_velx=0.2, solver="riccati", stand_ticks=0))
    variants = []
    for k in range(2):
        walked, _ = warmup(runner.init_wb_loop_batch(
            params, model, batch, jax.random.PRNGKey(k), dtype=dtype),
            params)
        variants.append((jax.block_until_ready(walked), params))
    final, _ = roll(*variants[0])
    jax.block_until_ready(final)
    z = final.sim.q[:, 2]
    assert 0.15 < float(jnp.mean(z)) < 0.4, "implausible wb height"
    dt = _timeit(roll, variants, n_rep=2)
    return batch * n_ticks / dt


def bench_weak_scaling(timeout=600):
    """2-process Gloo CPU-mesh weak-scaling efficiency (BASELINE: >=0.85 at
    >=2 hosts). Spawns the same driver shape as tests/test_distributed.py;
    both phases run barrier-aligned under identical contention so the ratio
    isolates collective + multi-process dispatch overhead. The children
    force the CPU, so they never touch the accelerator."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()

    driver = r"""
import json, os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:" + port
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
from legged_mpc_control_tpu import device
device.enable_compile_cache()
import jax.numpy as jnp
from legged_mpc_control_tpu.config import a1_params
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.parallel import distributed as dist
dist.initialize()
rep = dist.weak_scaling_report(gait.trot_pattern(jnp.float32),
                               a1_params(jnp.float32), per_device_batch=32,
                               horizon=5, n_ticks=4, pdip_iters=6, reps=3,
                               dtype=jnp.float32)
print("EFF" + str(pid) + " " + json.dumps(rep), flush=True)
"""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, "-c", driver, str(pid), "2",
                               port], cwd=repo, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for pid, out in enumerate(outs):
        assert f"EFF{pid}" in out, f"proc {pid} failed:\n{out[-2000:]}"
    rep = json.loads(outs[0].split("EFF0 ")[1].splitlines()[0])
    return rep["weak_scaling_efficiency"]


def main():
    global _DEVICE
    device.enable_compile_cache()
    _DEVICE = device.device_info()
    print(json.dumps({"device": _DEVICE,
                      "gpu": device.gpu_name_and_power_limit()}),
          flush=True)

    import __graft_entry__ as ge

    failed = []

    def cell(metric, unit, baseline, fn):
        try:
            v = fn()
        except Exception as e:              # the cell's gate or run failed
            failed.append(metric)
            print(json.dumps({"metric": metric, "error": repr(e)}),
                  flush=True)
            return
        emit(metric, v, unit, baseline(v))

    # --- secondary metrics (headline last) ---
    cell("closed_loop_scenario_ticks_per_s_b4096_h10", "scenario-ticks/s",
         lambda v: v / (4096 * 100.0), bench_closed_loop)
    # estimator-in-the-loop variant of the closed loop (the kf0 bypass is
    # the reference's sim-debug mode; this is the mode hardware runs)
    cell("closed_loop_scenario_ticks_per_s_b4096_kf1", "scenario-ticks/s",
         lambda v: v / (4096 * 100.0), bench_closed_loop_kf1)
    cell("convex_mpc_solves_per_s_per_chip_go1_trot_h30", "solves/s",
         lambda v: v / 10000.0,
         lambda: bench_throughput(ge, "riccati", horizon=30, batch=4096))
    # the condensed solver (QP condensation + dense batched Cholesky),
    # tracked so the alternative solver cannot regress unmeasured
    cell("convex_mpc_solves_per_s_condensed_pallas_h10", "solves/s",
         lambda v: v / 10000.0,
         lambda: bench_throughput(ge, "pdip", horizon=10, batch=16384))
    # B=1 latency favors the condensed solver (the Riccati stage scan is
    # throughput-oriented; its sequential tiny stages idle the device at
    # batch 1)
    cell("qp_solve_latency_ms_b1_h10_cold_pdip", "ms", lambda v: 2.0 / v,
         lambda: bench_latency(ge, warm_admm=False))
    cell("qp_solve_latency_ms_b1_h10_warm_admm30", "ms", lambda v: 2.0 / v,
         lambda: bench_latency(ge, warm_admm=True))
    # oracle-accuracy condensed solver at ITS closed-loop operating point
    # (warm; the cold metric above is the worst-case first tick)
    cell("qp_solve_latency_ms_b1_h10_warm_pdip8", "ms", lambda v: 2.0 / v,
         lambda: bench_latency_pdip_warm(ge))
    # product-default solver B=1: cold and cross-tick warm
    cell("qp_solve_latency_ms_b1_h10_riccati", "ms", lambda v: 2.0 / v,
         lambda: bench_latency_riccati(ge, warm=False))
    cell("qp_solve_latency_ms_b1_h10_warm_riccati8", "ms", lambda v: 2.0 / v,
         lambda: bench_latency_riccati(ge, warm=True))
    cell("wb_closed_loop_scenario_ticks_per_s_b256", "scenario-ticks/s",
         lambda v: v / (256 * 100.0), bench_wb_closed_loop)
    # CI backend B=1 MPC-thread latency vs the reference's 10 ms budget
    # (main.cpp:130-163)
    cell("ci_tick_latency_ms_b1", "ms", lambda v: 10.0 / v,
         bench_ci_latency)
    cell("ci_closed_loop_scenario_ticks_per_s_b256", "scenario-ticks/s",
         lambda v: v / (256 * 100.0), bench_ci_closed_loop)
    cell("weak_scaling_efficiency_2host_cpu_proxy", "ratio",
         lambda v: v / 0.85, bench_weak_scaling)

    # --- headline metric: LAST line (product-default solver) ---
    cell("convex_mpc_solves_per_s_per_chip_go1_trot_h10", "solves/s",
         lambda v: v / 10000.0,
         lambda: bench_throughput(ge, "riccati", horizon=10, batch=4096))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
