"""Robot and controller configuration.

The reference spreads configuration over compile-time macros, roslaunch YAML
variants, OCS2 `.info` trees, and runtime topics (SURVEY.md §5). Here the
entire configuration is a single immutable pytree (`RobotParams`) so it can be
domain-randomized under `vmap` (per-scenario mass/inertia/friction/gait
parameters) — the replacement for ROS's param server.

Values mirror reference: src/legged_ctrl/config/gazebo_a1_convex.yaml and
gazebo_go1_convex.yaml, with fallback defaults from
src/legged_ctrl/src/LeggedState.cpp:20-209.
"""

from typing import Any

import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu import constants as C


@pytree.dataclass
class RobotParams:
    """Per-robot physical + controller parameters (all leaves are arrays)."""

    # --- rigid body (reference: gazebo_a1_convex.yaml robot parameters) ---
    mass: Any                 # scalar
    trunk_inertia: Any        # (3,3)

    # --- MPC cost (reference: gazebo_*_convex.yaml q_weights/r_weights) ---
    q_weights: Any            # (12,) on state [rpy, pos, omega, v]
    r_weights: Any            # (12,) on GRFs

    # --- contact model (reference: ConvexQPSolver.cpp:25, 171, 336) ---
    mu: Any                   # friction coefficient, scalar
    fz_max: Any               # max normal force per foot, scalar

    # --- gait (reference: gazebo_*_convex.yaml gait_counter_speed) ---
    gait_counter_speed: Any   # gait cycles per second, scalar

    # --- default foothold, body frame (reference: yaml default_foot_pos_*) ---
    default_foot_pos: Any     # (4,3) FL,FR,RL,RR

    # --- swing PD gains (reference: yaml kp_foot_*/kd_foot_*) ---
    kp_foot: Any              # (3,) per-axis joint-space kp (same all legs)
    kd_foot: Any              # (3,)

    # --- contact sensor thresholds (reference: yaml foot_sensor_*) ---
    foot_sensor_min: Any      # scalar
    foot_sensor_max: Any      # scalar
    foot_sensor_ratio: Any    # scalar

    # --- leg geometry (reference: BaseInterface.cpp:76-98) ---
    # rho_fix = [offset_x, offset_y, motor_offset, thigh_len, calf_len] per leg
    rho_fix: Any              # (4,5)

    # --- joystick/command scales (reference: yaml joystick_*) ---
    max_body_height: Any      # scalar
    min_body_height: Any      # scalar


def param_base_ndims() -> RobotParams:
    """Canonical (unbatched) rank of each RobotParams leaf.

    Used by control.step.broadcast_params to distinguish a scenario batch
    axis from structural axes (the leg axis of rho_fix/default_foot_pos)."""
    return RobotParams(
        mass=0, trunk_inertia=2, q_weights=1, r_weights=1, mu=0,
        fz_max=0, gait_counter_speed=0, default_foot_pos=2,
        kp_foot=1, kd_foot=1, foot_sensor_min=0, foot_sensor_max=0,
        foot_sensor_ratio=0, rho_fix=2, max_body_height=0,
        min_body_height=0)


def _rho_fix(dtype):
    """A1/Go1 leg geometry. reference: BaseInterface.cpp:76-89 (both robots
    use the same hard-coded kinematic constants in the reference)."""
    ox = [0.1805, 0.1805, -0.1805, -0.1805]
    oy = [0.047, -0.047, 0.047, -0.047]
    d = [0.0838, -0.0838, 0.0838, -0.0838]
    lt = [0.21] * 4
    lc = [0.21] * 4          # LOWER_LEG_LENGTH, LeggedParams.h:24
    return jnp.array(list(zip(ox, oy, d, lt, lc)), dtype=dtype)


def a1_params(dtype=jnp.float32) -> RobotParams:
    """Unitree A1. reference: config/gazebo_a1_convex.yaml."""
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return RobotParams(
        mass=f(13.0),
        trunk_inertia=jnp.diag(f([0.0158533, 0.0377999, 0.0456542])),
        q_weights=f([60.0, 100.0, 0.0,      # rpy
                     0.0, 0.0, 450.0,       # pos
                     0.15, 0.15, 100.0,     # omega
                     3.0, 3.0, 5.0]),       # v
        r_weights=f([1e-4] * 12),
        mu=f(0.3),
        fz_max=f(180.0),
        gait_counter_speed=f(3.5),
        default_foot_pos=f([[0.17, 0.17, -0.3],
                            [0.17, -0.17, -0.3],
                            [-0.17, 0.17, -0.3],
                            [-0.17, -0.17, -0.3]]),
        kp_foot=f([15.0, 15.0, 15.0]),
        kd_foot=f([0.4, 0.4, 0.4]),
        foot_sensor_min=f(0.0),
        foot_sensor_max=f(200.0),
        foot_sensor_ratio=f(0.5),
        rho_fix=_rho_fix(dtype),
        max_body_height=f(0.30),
        min_body_height=f(0.03),
    )


def go1_params(dtype=jnp.float32) -> RobotParams:
    """Unitree Go1. reference: config/gazebo_go1_convex.yaml (mass/inertia
    fall back to the loader defaults, LeggedState.cpp:146-160).

    Joint PD gains are the HARDWARE Go1 values (kp 30 / kd 1.5,
    reference: config/hardware_go1_convex.yaml) — the robot's product
    gains. The gazebo_go1 yaml's 0.5/0.3 belongs to that sim's actuation
    mode and leaves the swing legs too soft to track a trot against the
    on-device simulators (~3.5 rad/s joint bandwidth at the reflected
    leg inertia); load configs/*.yaml explicitly to reproduce it."""
    f = lambda v: jnp.asarray(v, dtype=dtype)
    base = a1_params(dtype)
    return base.replace(
        q_weights=f([50.0, 100.0, 0.0,
                     0.0, 0.0, 3500.0,
                     0.01, 0.01, 10.0,
                     15.0, 15.0, 20.0]),
        gait_counter_speed=f(4.0),
        default_foot_pos=f([[0.17, 0.12, -0.3],
                            [0.17, -0.12, -0.3],
                            [-0.17, 0.12, -0.3],
                            [-0.17, -0.12, -0.3]]),
        kp_foot=f([30.0, 30.0, 30.0]),
        kd_foot=f([1.5, 1.5, 1.5]),
        foot_sensor_max=f(300.0),
    )


def load_yaml_params(path: str, dtype=jnp.float32) -> RobotParams:
    """Load a reference-style flat YAML config (the reference's config tier 2,
    LeggedState.cpp:20-209). Unspecified keys fall back to robot defaults."""
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    robot_type = raw.get("robot_type", 0)
    base = a1_params(dtype) if robot_type == 0 else go1_params(dtype)
    f = lambda v: jnp.asarray(v, dtype=dtype)

    def get(name, default):
        return raw.get(name, default)

    q = [get(f"q_weights_{i}", float(base.q_weights[i])) for i in range(12)]
    r = [get(f"r_weights_{i}", float(base.r_weights[i])) for i in range(12)]
    dfp = [[get(f"default_foot_pos_{leg}_{ax}",
                float(base.default_foot_pos[i, j]))
            for j, ax in enumerate("xyz")]
           for i, leg in enumerate(C.LEG_NAMES)]
    inertia = jnp.diag(f([
        get("a1_trunk_inertia_xx", float(base.trunk_inertia[0, 0])),
        get("a1_trunk_inertia_yy", float(base.trunk_inertia[1, 1])),
        get("a1_trunk_inertia_zz", float(base.trunk_inertia[2, 2])),
    ]))
    return base.replace(
        mass=f(get("a1_robot_mass", float(base.mass))),
        trunk_inertia=inertia,
        q_weights=f(q),
        r_weights=f(r),
        gait_counter_speed=f(get("gait_counter_speed",
                                 float(base.gait_counter_speed))),
        default_foot_pos=f(dfp),
        kp_foot=f([get(f"kp_foot_{a}", float(base.kp_foot[i]))
                   for i, a in enumerate("xyz")]),
        kd_foot=f([get(f"kd_foot_{a}", float(base.kd_foot[i]))
                   for i, a in enumerate("xyz")]),
        foot_sensor_min=f(get("foot_sensor_min_value",
                              float(base.foot_sensor_min))),
        foot_sensor_max=f(get("foot_sensor_max_value",
                              float(base.foot_sensor_max))),
        foot_sensor_ratio=f(get("foot_sensor_ratio",
                                float(base.foot_sensor_ratio))),
        max_body_height=f(get("joystick_max_height",
                              float(base.max_body_height))),
        min_body_height=f(get("joystick_min_height",
                              float(base.min_body_height))),
    )
