"""18-state contact-gated linear Kalman filter.

Functional re-design of the reference's `BasicKF`
(reference: src/legged_ctrl/src/estimation/BasicKF.cpp). State:
[root_pos(3), root_vel(3), foot_pos_world(4x3)]; 28 measurements:
4x3 body-to-foot FK residuals, 4x3 leg-odometry velocities, 4 foot heights
(reference: BasicKF.h:13-14, BasicKF.cpp:12-19).

The mutable filter object becomes an immutable `KfState` pytree; contact
gating (noise inflation x1e3 on swing legs, reference: :94-110) becomes
arithmetic on the contact vector, so the filter vmaps over scenarios and
fuses into the jitted control step.
"""

from typing import Any

import jax
import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.constants import GRAVITY_EST, NUM_LEG
from legged_mpc_control_tpu.ops.so3 import skew

STATE_SIZE = 18
MEAS_SIZE = 28

# reference: BasicKF.h:15-20
PROCESS_NOISE_PIMU = 0.01
PROCESS_NOISE_VIMU = 0.01
PROCESS_NOISE_PFOOT = 0.01
SENSOR_NOISE_PIMU_REL_FOOT = 0.001
SENSOR_NOISE_VIMU_REL_FOOT = 0.1
SENSOR_NOISE_ZFOOT = 0.001


@pytree.dataclass
class KfState:
    x: Any          # (18,)
    P: Any          # (18,18)
    initialized: Any  # bool scalar


def sequential_update(xbar, Pbar, H, err0, rdiag):
    """Kalman measurement update by sequential scalar rows.

    With diagonal measurement noise this is algebraically identical to the
    joint update (classic sequential processing): each row i applies a
    rank-1 correction with innovation err0_i - H_i (x - xbar), all
    linearized at xbar. Every step is an (n,)-vector op that fuses under
    vmap — no m x m factorization anywhere.

    Args: H (m,n), err0 (m,) = y - h(xbar), rdiag (m,).
    Returns (x_new, P_new)."""
    n = xbar.shape[-1]

    def row(carry, inp):
        dx, P = carry
        h, e0, r = inp
        Ph = P @ h
        s = h @ Ph + r
        K = Ph / s
        dx = dx + K * (e0 - h @ dx)
        P = P - jnp.outer(K, Ph)
        return (dx, P), None

    (dx, P_new), _ = jax.lax.scan(
        row, (jnp.zeros((n,), dtype=xbar.dtype), Pbar), (H, err0, rdiag))
    return xbar + dx, P_new


def _measurement_matrix(dtype):
    """Fixed C (28, 18). reference: BasicKF.cpp:12-19."""
    C = jnp.zeros((MEAS_SIZE, STATE_SIZE), dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    for i in range(NUM_LEG):
        C = C.at[i * 3:i * 3 + 3, 0:3].set(-eye3)
        C = C.at[i * 3:i * 3 + 3, 6 + i * 3:9 + i * 3].set(eye3)
        C = C.at[12 + i * 3:15 + i * 3, 3:6].set(eye3)
        C = C.at[24 + i, 8 + i * 3].set(1.0)
    return C


def kf_init(root_rot_mat, foot_pos_rel, dtype=jnp.float32) -> KfState:
    """reference: BasicKF.cpp:57-70 — body starts at (0,0,0.09), feet from
    FK under the current orientation."""
    x = jnp.zeros((STATE_SIZE,), dtype=dtype)
    x = x.at[2].set(0.09)
    feet = (root_rot_mat @ foot_pos_rel.T).T + x[0:3][None, :]
    x = x.at[6:18].set(feet.reshape(-1))
    P = jnp.eye(STATE_SIZE, dtype=dtype) * 3.0
    return KfState(x=x, P=P, initialized=jnp.ones((), dtype=bool))


def kf_update(kf: KfState, dt, root_rot_mat, imu_acc, imu_ang_vel,
              foot_pos_rel, foot_vel_rel, estimated_contacts,
              assume_flat_ground=True):
    """One predict+update. reference: BasicKF.cpp:72-167.

    Args:
      foot_pos_rel / foot_vel_rel: (4,3) body-frame FK positions/velocities.
      estimated_contacts: (4,) in [0,1] (continuous contact belief; the
        reference uses the sigmoid contact flag in walk mode, :81-89).
    Returns (new KfState, root_pos (3,), root_vel (3,)).
    """
    dtype = kf.x.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    x, P = kf.x, kf.P

    A = jnp.eye(STATE_SIZE, dtype=dtype).at[0:3, 3:6].set(dt * eye3)
    # control input u = R a + g (reference: :74-78)
    u = root_rot_mat @ imu_acc + jnp.array([0., 0., -GRAVITY_EST],
                                           dtype=dtype)

    c = estimated_contacts
    infl = 1.0 + (1.0 - c) * 1e3                          # (4,)

    # process noise (reference: :91-99)
    qdiag = jnp.concatenate([
        jnp.full((3,), PROCESS_NOISE_PIMU * dt / 20.0, dtype=dtype),
        jnp.full((3,), PROCESS_NOISE_VIMU * dt * 9.8 / 20.0, dtype=dtype),
        jnp.repeat(infl * dt * PROCESS_NOISE_PFOOT, 3).astype(dtype),
    ])
    Q = jnp.diag(qdiag)

    # measurement noise (reference: :29-34, 101-110)
    rdiag = jnp.concatenate([
        jnp.repeat(infl * SENSOR_NOISE_PIMU_REL_FOOT, 3).astype(dtype),
        jnp.repeat(infl * SENSOR_NOISE_VIMU_REL_FOOT, 3).astype(dtype),
        (infl * SENSOR_NOISE_ZFOOT).astype(dtype)
        if assume_flat_ground else jnp.full((4,), 1e5, dtype=dtype),
    ])

    # predict (reference: :113-115)
    xbar = A @ x
    xbar = xbar.at[3:6].add(dt * u)
    Pbar = A @ P @ A.T + Q

    # measurements (reference: :117-131)
    C = _measurement_matrix(dtype)
    yhat = C @ xbar
    fk_world = (root_rot_mat @ foot_pos_rel.T).T                 # (4,3)
    leg_v = -foot_vel_rel - jnp.einsum(
        "ab,lb->la", skew(imu_ang_vel), foot_pos_rel)            # (4,3)
    vel_meas = ((1.0 - c)[:, None] * x[3:6][None, :]
                + c[:, None] * (root_rot_mat @ leg_v.T).T)
    height_meas = (1.0 - c) * (x[2] + foot_pos_rel[:, 2])
    y = jnp.concatenate([fk_world.reshape(-1), vel_meas.reshape(-1),
                         height_meas])

    # update — SEQUENTIAL scalar processing (exactly equivalent to the
    # reference's joint 28x28 solve because R is diagonal; avoids a
    # batched-small library solve per scenario, see ops/la3.py for the
    # same choice at 3x3)
    x_new, P_new = sequential_update(xbar, Pbar, C, y - yhat, rdiag)
    P_new = 0.5 * (P_new + P_new.T)

    # xy-drift suppression (reference: :146-150)
    det2 = (P_new[0, 0] * P_new[1, 1] - P_new[0, 1] * P_new[1, 0])
    suppress = det2 > 1e-6
    P_supp = P_new.at[0:2, 2:].set(0.0).at[2:, 0:2].set(0.0)
    P_supp = P_supp.at[0:2, 0:2].multiply(0.1)
    P_new = jnp.where(suppress, P_supp, P_new)

    new_kf = KfState(x=x_new, P=P_new, initialized=kf.initialized)
    return new_kf, x_new[0:3], x_new[3:6]
