"""Process entry point — the `main.cpp` equivalent.

The reference's main (reference: src/legged_ctrl/src/main.cpp:24-256) reads
`/use_sim_time`, `/robot_type`, `/mpc_type` params, instantiates the
interface + MPC, and spawns three real-time threads. Here the same selectors
become CLI flags, the threads are one jitted closed-loop step, and the
"rosbag" is a structured .npz diagnostics bag.

Usage:
    python -m legged_mpc_control_tpu --robot a1 --mpc convex --kf 0 \
        --seconds 2.0 --bag /tmp/run.npz
"""

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="legged_mpc_control_tpu",
        description="Legged convex-MPC runtime on JAX")
    p.add_argument("--robot", choices=["a1", "go1"], default="a1",
                   help="robot_type (reference: main.cpp:36-44)")
    p.add_argument("--mpc", choices=["convex", "lci", "ci"],
                   default="convex",
                   help="mpc_type 1=convex, 0=lci (reference: main.cpp:113)"
                        "; 'ci' runs the true contact-implicit optimizer "
                        "(mpc/ci_mpc.py) in the lci seam")
    p.add_argument("--kf", type=int, choices=[0, 1, 2], default=0,
                   help="kf_type: 0 ground truth (sim only), 1 linear KF, "
                        "2 EKF (reference: BaseInterface.cpp:404-449)")
    p.add_argument("--backend", choices=["sim", "hardware"], default="sim")
    p.add_argument("--wire", choices=["native", "unitree"],
                   default="native",
                   help="hardware wire protocol: 'native' (framework "
                        "runtime packets, loopback HIL) or 'unitree' "
                        "(real unitree_legged_sdk v3.2 LowCmd/LowState, "
                        "reference: HardwareInterface.cpp:7)")
    p.add_argument("--robot-ip", default="127.0.0.1",
                   help="robot address (Unitree low-level default "
                        "192.168.123.10)")
    p.add_argument("--robot-port", type=int, default=8007)
    p.add_argument("--gait", default="trot",
                   help="named gait (gait.info equivalent): trot, "
                        "standing_trot, flying_trot, pace, crawl, bound, "
                        "pronk, stance, ...")
    p.add_argument("--config", default=None,
                   help="YAML variant file (configs/*.yaml); overrides "
                        "--robot and parameter defaults")
    p.add_argument("--low-level", type=int, choices=[0, 1], default=0,
                   dest="low_level",
                   help="low_level_type: 0 J^T tau control, 1 hierarchical "
                        "WBC (reference: LeggedState.h:149)")
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--velx", type=float, default=0.0,
                   help="forward velocity command; nonzero switches to walk")
    p.add_argument("--bag", default=None, help="write diagnostics .npz here")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a JAX profiler trace of the run into DIR "
                        "(open with TensorBoard / xprof)")
    p.add_argument("--tune-port", type=int, default=None, dest="tune_port",
                   help="listen for live parameter updates (UDP JSON) on "
                        "this port — the reference's low_level_gains "
                        "channel (BaseInterface.cpp:147-162); push with "
                        "utils.tuning.send_gains")
    p.add_argument("--joy-port", type=int, default=None, dest="joy_port",
                   help="listen for live gamepad frames (UDP JSON) on this "
                        "port — the reference's /joy subscription "
                        "(BaseInterface.cpp:122-145); push with "
                        "interfaces.joystick.send_joy")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests, hosts without a GPU)")
    p.add_argument("--yes", action="store_true",
                   help="skip the hardware confirmation prompt "
                        "(reference: main.cpp:57-60)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from legged_mpc_control_tpu import constants as C
    from legged_mpc_control_tpu import device
    from legged_mpc_control_tpu.config import a1_params, go1_params
    from legged_mpc_control_tpu.control import step as step_mod
    from legged_mpc_control_tpu.mpc import gait as gait_mod
    from legged_mpc_control_tpu.utils import bag as bag_mod

    device.check_platform()
    device.enable_compile_cache()
    if args.backend == "hardware" and not args.yes:
        # reference: hardware confirmation prompt, main.cpp:57-60
        reply = input("About to drive REAL hardware. Type 'yes' to "
                      "continue: ")
        if reply.strip().lower() != "yes":
            print("aborted")
            return 1
    if args.backend == "hardware" and args.kf == 0:
        # reference interlock: hardware requires estimation, main.cpp:97-100
        print("error: kf_type 0 (ground-truth bypass) is sim-only",
              file=sys.stderr)
        return 1
    if args.mpc == "lci":
        print("LCI-MPC backend: built-in stand + trot-walk policies "
              "through the pluggable policy seam (mpc/lci_mpc.py)")
    elif args.mpc == "ci":
        print("contact-implicit MPC backend: FB-complementarity iLQR "
              "(mpc/ci_mpc.py) through the policy seam, warm-started "
              "across ticks")

    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.config:
        from legged_mpc_control_tpu.config import load_yaml_params

        params = load_yaml_params(args.config, dtype)
    else:
        params = (a1_params if args.robot == "a1" else go1_params)(dtype)
    pattern = gait_mod.named_pattern(args.gait, dtype)

    if args.backend == "hardware":
        return _run_hardware(args, params, pattern, dtype)

    from legged_mpc_control_tpu.interfaces.sim_iface import SimInterface

    iface = SimInterface(params, pattern, dtype=dtype, height=args.height,
                         body_height=args.height, horizon=args.horizon,
                         kf_type=args.kf, mpc_type=args.mpc,
                         low_level_type=args.low_level,
                         walk_velx=(args.velx or 0.25))
    n_ticks = int(args.seconds / C.MPC_DT)
    records = []
    tick_wall_ms = []
    tuner = None
    if args.tune_port is not None:
        from legged_mpc_control_tpu.utils.tuning import GainTuner

        tuner = GainTuner(bind=("127.0.0.1", args.tune_port)).start()
    joy_src = None
    if args.joy_port is not None:
        from legged_mpc_control_tpu.interfaces.joystick import UdpJoystick

        joy_src = UdpJoystick(bind=("127.0.0.1", args.joy_port)).start()
    profile_cm = None
    if args.profile:
        profile_cm = jax.profiler.trace(args.profile)
        profile_cm.__enter__()
    t0 = time.perf_counter()
    try:
        for i in range(n_ticks):
            if joy_src is not None:
                # live operator input through the joy FSM
                # (reference: joy_update, BaseInterface.cpp:165-209)
                from legged_mpc_control_tpu.control import joy as joy_mod

                axes, buttons = joy_src.get()
                cs = joy_mod.joy_update(iface.loop.controller, axes,
                                        buttons, C.MPC_DT, params)
                iface.loop = iface.loop.replace(controller=cs)
                if bool(cs.joy.exit_flag):
                    print("operator exit", file=sys.stderr)
                    break
            elif args.velx != 0.0 and i == min(20, n_ticks // 4):
                cs = iface.loop.controller
                cs = cs.replace(
                    ctrl=cs.ctrl.replace(
                        movement_mode=jnp.ones((), jnp.int32)),
                    joy=cs.joy.replace(velx=jnp.asarray(args.velx, dtype),
                                       ctrl_state=jnp.ones((), jnp.int32)))
                iface.loop = iface.loop.replace(controller=cs)
            if tuner is not None:
                iface.params = tuner.apply(iface.params)
            t_tick = time.perf_counter()
            iface.tick()
            if args.bag:
                jax.block_until_ready(iface.loop)
                tick_wall_ms.append(
                    (time.perf_counter() - t_tick) * 1e3)
                records.append(jax.device_get(
                    bag_mod.diag_from_loop(iface.loop)))
    finally:
        if profile_cm is not None:
            jax.block_until_ready(iface.loop)
            profile_cm.__exit__(None, None, None)
        if tuner is not None:
            tuner.close()
        if joy_src is not None:
            joy_src.close()
    wall = time.perf_counter() - t0

    loop = iface.loop
    z = float(loop.sim.pos[2])
    summary = {
        "ticks": n_ticks,
        "sim_seconds": n_ticks * C.MPC_DT,
        "wall_seconds": round(wall, 3),
        "realtime_factor": round(n_ticks * C.MPC_DT / wall, 2),
        "final_height_m": round(z, 4),
        "final_xy": [round(float(v), 3) for v in loop.sim.pos[:2]],
        "upright": bool(abs(float(loop.controller.fbk.root_euler[0])) < 0.3
                        and abs(float(
                            loop.controller.fbk.root_euler[1])) < 0.3),
        "device": device.device_info(),
    }
    if args.bag and records:
        import numpy as np
        stacked = {k: np.stack([r[k] for r in records])
                   for k in records[0]}
        # per-tick host wall time: the per-stage timing channel of the
        # observability plan (SURVEY §5 tracing/profiling)
        stacked["tick_wall_ms"] = np.asarray(tick_wall_ms)
        bag_mod.save_bag(args.bag, stacked,
                         meta={"dt": C.MPC_DT, "args": vars(args)})
        summary["bag"] = args.bag
    if args.profile:
        summary["profile"] = args.profile
    if tuner is not None:
        summary["tuning_updates"] = tuner.updates_applied
    print(json.dumps(summary))
    return 0 if summary["upright"] and z > 0.1 else 2


def _run_hardware(args, params, pattern, dtype):
    """Hardware path: native runtime carries the 800 Hz UDP link; Python
    runs the MPC-rate loop (reference thread structure: main.cpp:110-256)."""
    import jax.numpy as jnp
    import numpy as np

    from legged_mpc_control_tpu import constants as C
    from legged_mpc_control_tpu.control import step as step_mod
    from legged_mpc_control_tpu.interfaces.hardware import (
        HardwareInterface,
        UnitreeHardwareInterface,
    )

    if args.wire == "unitree":
        iface = UnitreeHardwareInterface(
            peer=(args.robot_ip, args.robot_port))
    else:
        iface = HardwareInterface(peer=(args.robot_ip, args.robot_port))
    iface.start()
    cs = step_mod.controller_init(params, dtype=dtype,
                                  body_height=args.height)
    n_ticks = int(args.seconds / C.MPC_DT)
    # solve-time-compensated pacing on an absolute deadline (the reference
    # subtracts the measured loop time from the period, main.cpp:156-162;
    # an absolute deadline additionally avoids drift accumulation)
    deadline = time.perf_counter()
    try:
        for _ in range(n_ticks):
            deadline += C.MPC_DT
            raw = iface.fbk_update()
            if raw is None:
                time.sleep(C.LOW_LEVEL_DT)
                continue
            raw = {k: jnp.asarray(v, dtype) for k, v in raw.items()}
            cs = step_mod.feedback_update(cs, raw, params, C.MPC_DT,
                                          kf_type=args.kf)
            from legged_mpc_control_tpu.mpc import convex_mpc
            cs = convex_mpc.mpc_tick(cs, params, pattern, C.MPC_DT,
                                     horizon=args.horizon)
            cs, tau, safe = step_mod.lowlevel_update(
                cs, params, low_level_type=args.low_level)
            if not bool(safe):
                print("safety stop", file=sys.stderr)
                return 3
            iface.send_cmd(np.asarray(cs.ctrl.joint_ang_tgt),
                           np.asarray(cs.ctrl.joint_vel_tgt),
                           np.asarray(cs.ctrl.joint_tau_tgt),
                           np.tile(np.asarray(params.kp_foot), 4),
                           np.tile(np.asarray(params.kd_foot), 4))
            remaining = deadline - time.perf_counter()
            if remaining > 0:
                time.sleep(remaining)
        print(json.dumps({"ticks": n_ticks, "stats": iface.stats()}))
        return 0
    finally:
        iface.close()


if __name__ == "__main__":
    sys.exit(main())
