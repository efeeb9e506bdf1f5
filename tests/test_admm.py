"""ADMM (OSQP-equivalent) backend vs the interior-point solver and oracle.

The reference runs OSQP at abs 1e-3 / rel 1e-4 (reference:
ConvexQPSolver.cpp:182-185); the ADMM backend must reproduce the PDIP/oracle
GRFs to that operating accuracy, and warm starts must cut the iterations
needed — mirroring OSQP's cross-tick warm starting (:185).
"""

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge
from legged_mpc_control_tpu.mpc import admm, pdip, qp_builder


def _batch_qps(B=6, H=10, dtype=jnp.float64):
    params, x0, contact = ge._make_problem_batch(B, H, dtype)
    from legged_mpc_control_tpu.mpc import reference
    from legged_mpc_control_tpu.ops import so3

    def build_one(x0_, c_):
        root_euler = x0_[0:3]
        R = so3.quat_to_rotmat(so3.euler_to_quat(root_euler))
        cmd = reference.MpcCmd(
            root_pos_d=jnp.array([0.0, 0.0, 0.3], dtype),
            root_euler_d=jnp.zeros(3, dtype).at[2].set(root_euler[2]),
            root_lin_vel_d_rel=jnp.array([0.3, 0.0, 0.0], dtype),
            root_ang_vel_d_rel=jnp.zeros(3, dtype))
        x_ref, yaw_ref, _ = reference.build_reference(
            root_euler, x0_[3:6], R, cmd, H, 0.01)
        fpa = (R @ params.default_foot_pos.astype(dtype).T).T
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass, params.trunk_inertia, R, fpa, 0.01)
        return qp_builder.build_condensed_qp(
            x0_, x_ref, A_seq, Bm, c_, params.q_weights, params.r_weights,
            params.mu, params.fz_max, 0.01)

    qp = jax.vmap(build_one)(x0, contact)
    return params, qp, contact


def test_admm_matches_pdip_at_osqp_accuracy():
    params, qp, contact = _batch_qps()
    ref = pdip.solve_qp_pdip_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact,
        iters=25).u
    got = admm.solve_qp_admm_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact,
        iters=500).u
    # OSQP-grade agreement on the GRFs (forces are O(10-100) N; OSQP at
    # abs 1e-3 / rel 1e-4 leaves comparable solution error)
    err = np.max(np.abs(np.asarray(got - ref)))
    assert err < 5e-2, err


def test_admm_respects_constraints():
    params, qp, contact = _batch_qps()
    res = admm.solve_qp_admm_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact,
        iters=500)
    u = np.asarray(res.u).reshape(res.u.shape[0], -1, 4, 3)
    fz = u[..., 2]
    mu = float(params.mu)
    tol = 5e-2
    assert np.all(fz >= -tol)
    assert np.all(fz <= float(params.fz_max) + tol)
    assert np.all(np.abs(u[..., 0]) <= mu * fz + tol)
    assert np.all(np.abs(u[..., 1]) <= mu * fz + tol)
    # swing legs carry exactly zero force
    c = np.asarray(contact)
    assert np.all(u[c == 0.0] == 0.0)


def test_admm_warm_start_accelerates():
    params, qp, contact = _batch_qps(B=4)
    kw = dict(mu=params.mu, fz_max=params.fz_max, contact=contact)
    full = admm.solve_qp_admm_batched(qp.P, qp.q, iters=800, **kw)
    cold = admm.solve_qp_admm_batched(qp.P, qp.q, iters=30, **kw)
    warm = admm.solve_qp_admm_batched(qp.P, qp.q, iters=30,
                                      warm=full.warm, **kw)
    err_cold = np.max(np.abs(np.asarray(cold.u - full.u)))
    err_warm = np.max(np.abs(np.asarray(warm.u - full.u)))
    assert err_warm < 1e-4, err_warm        # re-solve from optimum stays put
    assert err_warm < 0.1 * err_cold


def test_admm_jit_compiles_and_is_finite_f32():
    params, qp, contact = _batch_qps(B=4, dtype=jnp.float32)
    fn = jax.jit(lambda P, q, c: admm.solve_qp_admm_batched(
        P, q, params.mu, params.fz_max, c, iters=60).u)
    u = fn(qp.P, qp.q, contact)
    assert bool(jnp.all(jnp.isfinite(u)))
    # stance legs carry roughly the robot weight
    mean_fz = float(jnp.mean(jnp.sum(u.reshape(4, -1, 4, 3)[..., 2],
                                     axis=-1)))
    assert 0.3 * 9.8 * float(params.mass) < mean_fz < 2.0 * 9.8 * float(
        params.mass)
