"""Extended Kalman filter with leg odometry, foot states, and mocap fusion.

Equivalent of the reference's CasADi-codegen EKF
(`A1KFCombineLOWithFootTerrain` in the `ShuoYangRobotics/legged-kalman-filter`
submodule; call surface: reference src/legged_ctrl/src/interfaces/
BaseInterface.cpp:104-118 `set_noise_params` with 13 noise parameters,
:424-445 `input_dt/input_imu/input_leg -> update_filter -> get_state` where
the first 9 states are [pos, vel, euler], and
HardwareInterface.cpp:203-228 `update_filter_with_opti` for OptiTrack
correction).

Instead of CasADi-generated C, the process/measurement Jacobians are obtained
with `jax.jacfwd` on the (pure) models — fixed 25-state shapes, so the whole
predict/update compiles into the jitted control step and `vmap`s over
scenarios.

State (25): [root_pos(3), root_vel(3), root_euler(3) (ZYX rpy),
foot_pos_world(4x3), terrain_height(4)] — the foot + TERRAIN states that
give the reference estimator its name (`A1KFCombineLOWithFootTerrain`): the
foot-height channel measures `foot_z - terrain_i = 0` instead of pinning
feet to a flat plane, so the filter stays consistent on steps and slopes.
Unlike `BasicKF` (estimation/basic_kf.py) the attitude is *in* the state,
so leg odometry and mocap corrections propagate into roll/pitch/yaw — which
is why the reference requires kf_type != 0 on hardware
(reference: main.cpp:97-100).
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.constants import GRAVITY_EST, NUM_LEG
from legged_mpc_control_tpu.ops import so3

STATE_SIZE = 25
MEAS_SIZE = 32   # 4x3 FK residual + 4x3 leg velocity + 4 foot-vs-terrain
                 # + 4 terrain prior (see ekf_update)


class EkfNoise(NamedTuple):
    """The reference passes 13 scalar noise parameters into the EKF
    (reference: BaseInterface.cpp:104-118 reads p_process_*, p_measure_* from
    YAML via LeggedParam::load, LeggedState.cpp). Same count, same roles."""
    proc_pos: Any = 0.001          # process noise, position random walk
    proc_vel: Any = 0.01           # process noise, velocity (accel-driven)
    proc_euler: Any = 0.0005       # process noise, attitude (gyro-driven)
    proc_foot_stance: Any = 0.001  # foot position process noise in stance
    proc_foot_swing: Any = 1000.0  # ... inflated in swing
    meas_fk: Any = 0.005           # FK residual measurement noise
    meas_vel: Any = 0.05           # leg-odometry velocity noise
    meas_height: Any = 0.005       # foot-on-terrain height noise
    meas_vel_swing_mult: Any = 1e3  # swing-leg inflation on velocity rows
    opti_pos: Any = 0.002          # mocap position measurement noise
    opti_euler: Any = 0.002        # mocap attitude measurement noise
    init_pos_unc: Any = 0.1        # initial covariance, position block
    init_unc: Any = 1.0            # initial covariance, everything else
    # terrain random walk: tight while the foot stands on it, loose while
    # the foot travels to new ground (the foot+terrain refinement of the
    # reference's A1KFCombineLOWithFootTerrain)
    proc_terrain_stance: Any = 1e-5
    proc_terrain_swing: Any = 0.01


@pytree.dataclass
class EkfState:
    x: Any            # (21,)
    P: Any            # (21,21)
    initialized: Any  # bool scalar


def _euler_rate_matrix(eul):
    """T(rpy): body angular velocity -> ZYX euler-angle rates."""
    r, p = eul[0], eul[1]
    sr, cr = jnp.sin(r), jnp.cos(r)
    cp = jnp.cos(p)
    tp = jnp.tan(p)
    # guard the pitch singularity the way the reference's euler paths do
    # (yaw-only approximations elsewhere keep |pitch| well below pi/2)
    cp = jnp.where(jnp.abs(cp) < 1e-4, jnp.sign(cp) * 1e-4 + (cp == 0) * 1e-4,
                   cp)
    return jnp.array([
        [1.0, sr * tp, cr * tp],
        [0.0, cr, -sr],
        [0.0, sr / cp, cr / cp],
    ], dtype=eul.dtype)


def _rotmat(eul):
    return so3.quat_to_rotmat(so3.euler_to_quat(eul))


def _process(x, imu_acc, imu_gyro, dt):
    """IMU-driven strapdown process model (feet + terrain constant)."""
    dtype = x.dtype
    p, v, eul, rest = x[0:3], x[3:6], x[6:9], x[9:]
    R = _rotmat(eul)
    acc_w = R @ imu_acc + jnp.array([0.0, 0.0, -GRAVITY_EST], dtype=dtype)
    p_new = p + v * dt + 0.5 * acc_w * dt * dt
    v_new = v + acc_w * dt
    eul_new = eul + (_euler_rate_matrix(eul) @ imu_gyro) * dt
    return jnp.concatenate([p_new, v_new, eul_new, rest])


def _measure(x, foot_pos_rel, foot_vel_rel, imu_gyro):
    """h(x): per-leg FK residual (world), leg-odometry velocity, foot
    height ABOVE the per-foot terrain state — the same 28 channels as
    BasicKF (reference: BasicKF.cpp:12-19) but nonlinear in the euler
    states and terrain-referenced in the height rows."""
    p, v, eul = x[0:3], x[3:6], x[6:9]
    feet = x[9:21].reshape(NUM_LEG, 3)
    terrain = x[21:25]
    R = _rotmat(eul)
    fk_pred = jnp.einsum("ba,lb->la", R, feet - p[None, :])  # body frame
    # leg odometry: v_world = -R (J dq + omega x p_rel)
    leg_v_body = -foot_vel_rel - jnp.cross(
        jnp.broadcast_to(imu_gyro, (NUM_LEG, 3)), foot_pos_rel)
    vel_pred = jnp.broadcast_to(v, (NUM_LEG, 3))
    vel_meas_model = jnp.einsum("ba,lb->la", R, vel_pred)    # body frame
    height_pred = feet[:, 2] - terrain
    # terrain prior rows: with foot-vs-terrain heights alone, absolute
    # height is a gauge freedom (any offset satisfies foot_z = terrain);
    # a weak terrain ~ 0 prior anchors it on level ground while still
    # letting each foot's terrain state track real steps
    return jnp.concatenate([fk_pred.reshape(-1), vel_meas_model.reshape(-1),
                            height_pred, terrain]), leg_v_body


def ekf_init(root_quat, root_pos, foot_pos_rel,
             noise: EkfNoise = EkfNoise(), dtype=jnp.float32) -> EkfState:
    """Initialize from the first full sensor frame (reference:
    `init_filter`, called once at BaseInterface.cpp:432-434)."""
    eul = so3.quat_to_euler(root_quat).astype(dtype)
    R = _rotmat(eul)
    feet = (R @ foot_pos_rel.T).T + root_pos[None, :]
    x = jnp.concatenate([root_pos.astype(dtype), jnp.zeros(3, dtype=dtype),
                         eul, feet.reshape(-1).astype(dtype),
                         feet[:, 2].astype(dtype)])     # terrain := feet z
    diag = jnp.concatenate([
        jnp.full((3,), noise.init_pos_unc, dtype=dtype),
        jnp.full((18,), noise.init_unc, dtype=dtype),
        jnp.full((4,), noise.init_pos_unc, dtype=dtype)])
    return EkfState(x=x, P=jnp.diag(diag),
                    initialized=jnp.ones((), dtype=bool))


def ekf_update(ekf: EkfState, dt, imu_acc, imu_gyro, foot_pos_rel,
               foot_vel_rel, estimated_contacts,
               noise: EkfNoise = EkfNoise(), assume_flat_ground=True):
    """One predict+update from IMU + leg odometry (reference surface:
    `input_dt/input_imu/input_leg` then `update_filter`,
    BaseInterface.cpp:424-437).

    Returns (new EkfState, pos (3,), vel (3,), euler (3,)).
    """
    dtype = ekf.x.dtype
    x, P = ekf.x, ekf.P
    c = estimated_contacts.astype(dtype)                    # (4,) in [0,1]
    swing_infl = 1.0 + (1.0 - c) * noise.meas_vel_swing_mult

    # --- predict ---
    f = lambda xx: _process(xx, imu_acc, imu_gyro, dt)
    F = jax.jacfwd(f)(x)
    xbar = f(x)
    foot_proc = (c * noise.proc_foot_stance
                 + (1.0 - c) * noise.proc_foot_swing)
    terr_proc = (c * noise.proc_terrain_stance
                 + (1.0 - c) * noise.proc_terrain_swing)
    qdiag = jnp.concatenate([
        jnp.full((3,), noise.proc_pos * dt, dtype=dtype),
        jnp.full((3,), noise.proc_vel * dt, dtype=dtype),
        jnp.full((3,), noise.proc_euler * dt, dtype=dtype),
        jnp.repeat(foot_proc * dt, 3).astype(dtype),
        (terr_proc * dt).astype(dtype)])
    Pbar = F @ P @ F.T + jnp.diag(qdiag)

    # --- measurement ---
    def h(xx):
        return _measure(xx, foot_pos_rel, foot_vel_rel, imu_gyro)[0]

    H = jax.jacfwd(h)(xbar)
    yhat, leg_v_body = _measure(xbar, foot_pos_rel, foot_vel_rel, imu_gyro)
    # actual measurements in the same channels
    v_body_pred = jnp.einsum(
        "ba,b->a", _rotmat(xbar[6:9]), xbar[3:6])
    vel_meas = (c[:, None] * leg_v_body
                + (1.0 - c)[:, None] * v_body_pred[None, :])
    height_meas = jnp.zeros((NUM_LEG,), dtype=dtype)   # foot ON terrain
    terrain_prior = jnp.zeros((NUM_LEG,), dtype=dtype)  # level-ground prior
    y = jnp.concatenate([foot_pos_rel.reshape(-1), vel_meas.reshape(-1),
                         height_meas, terrain_prior])

    rdiag = jnp.concatenate([
        jnp.repeat(swing_infl * noise.meas_fk, 3).astype(dtype),
        jnp.repeat(swing_infl * noise.meas_vel, 3).astype(dtype),
        (swing_infl * noise.meas_height).astype(dtype),
        jnp.full((4,), 0.02, dtype=dtype)
        if assume_flat_ground else jnp.full((4,), 1e6, dtype=dtype)])

    # sequential scalar update (diagonal R -> identical to the joint
    # 32-row solve; no library factorization, see basic_kf.py)
    from legged_mpc_control_tpu.estimation.basic_kf import sequential_update

    x_new, P_new = sequential_update(xbar, Pbar, H, y - yhat, rdiag)
    P_new = 0.5 * (P_new + P_new.T)

    new = EkfState(x=x_new, P=P_new, initialized=ekf.initialized)
    return new, x_new[0:3], x_new[3:6], x_new[6:9]


def ekf_update_with_opti(ekf: EkfState, opti_pos, opti_euler,
                         noise: EkfNoise = EkfNoise()):
    """Fuse an external mocap pose (reference:
    `update_filter_with_opti` fed from /mocap_node/Robot_1/pose,
    HardwareInterface.cpp:203-228). Linear measurement of pos + euler."""
    dtype = ekf.x.dtype
    x, P = ekf.x, ekf.P
    H = jnp.zeros((6, STATE_SIZE), dtype=dtype)
    H = H.at[0:3, 0:3].set(jnp.eye(3, dtype=dtype))
    H = H.at[3:6, 6:9].set(jnp.eye(3, dtype=dtype))
    # wrap yaw innovation to (-pi, pi]
    err = jnp.concatenate([opti_pos - x[0:3], opti_euler - x[6:9]])
    err = err.at[5].set(jnp.arctan2(jnp.sin(err[5]), jnp.cos(err[5])))
    rdiag = jnp.concatenate([
        jnp.full((3,), noise.opti_pos, dtype=dtype),
        jnp.full((3,), noise.opti_euler, dtype=dtype)])
    from legged_mpc_control_tpu.estimation.basic_kf import sequential_update

    x_new, P_new = sequential_update(x, P, H, err, rdiag)
    return EkfState(x=x_new, P=0.5 * (P_new + P_new.T),
                    initialized=ekf.initialized)


def get_state(ekf: EkfState):
    """First 9 states are [pos, vel, euler] (reference:
    BaseInterface.cpp:439-445)."""
    return ekf.x
