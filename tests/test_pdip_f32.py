"""float32 PDIP regression tests.

The production/bench path runs the QP in f32 on the accelerator. Two failure modes are
pinned here (both were real bugs found against the f64 oracle):
  1. bf16 MXU default-precision contractions making the condensed Hessian
     indefinite (qp_builder now forces HIGHEST precision + symmetrizes);
  2. post-convergence central-path blow-up emitting NaN iterates (pdip now
     freezes elements with non-finite directions at the last good iterate).
"""

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge


def _solutions(dtype, iters, horizon=10, batch=16):
    params, x0, contact = ge._make_problem_batch(batch, horizon, dtype)
    fn = jax.jit(ge._solve_batch_fn(params, horizon, iters=iters,
                                    solver="pdip"))
    return np.asarray(fn(x0, contact))


def test_f32_solutions_finite_and_close_to_f64():
    u32 = _solutions(jnp.float32, iters=15)
    assert np.isfinite(u32).all(), "f32 PDIP emitted non-finite GRFs"
    u64 = _solutions(jnp.float64, iters=30)
    assert np.isfinite(u64).all()
    scale = np.max(np.abs(u64))
    dev = np.max(np.abs(u32 - u64))
    # f32 end-to-end (build + solve) vs f64: comparable to the reference's
    # OSQP stopping tolerances (abs 1e-3 / rel 1e-4 on ~160 N forces,
    # reference: ConvexQPSolver.cpp:183-185)
    assert dev < 5e-3 * scale, f"f32 deviation {dev} vs scale {scale}"


def test_f32_hessian_symmetric_psd():
    import numpy.linalg as la

    from legged_mpc_control_tpu.mpc import qp_builder  # noqa: F401

    params, x0, contact = ge._make_problem_batch(8, 10, jnp.float32)
    from legged_mpc_control_tpu.mpc import reference
    from legged_mpc_control_tpu.ops import so3

    def build_one(x0v, c):
        root_euler = x0v[0:3]
        R = so3.quat_to_rotmat(so3.euler_to_quat(root_euler))
        cmd = reference.MpcCmd(
            root_pos_d=jnp.array([0.0, 0.0, 0.3], x0v.dtype),
            root_euler_d=jnp.zeros(3, x0v.dtype),
            root_lin_vel_d_rel=jnp.array([0.3, 0.0, 0.0], x0v.dtype),
            root_ang_vel_d_rel=jnp.zeros(3, x0v.dtype))
        x_ref, yaw_ref, _ = reference.build_reference(
            root_euler, x0v[3:6], R, cmd, 10, 0.01)
        foot = (R @ params.default_foot_pos.astype(x0v.dtype).T).T
        A_seq, B = reference.build_linearization(
            yaw_ref, params.mass, params.trunk_inertia, R, foot, 0.01)
        return qp_builder.build_condensed_qp(
            x0v, x_ref, A_seq, B, c, params.q_weights, params.r_weights,
            params.mu, params.fz_max, 0.01)

    qp = jax.jit(jax.vmap(build_one))(*ge._make_problem_batch(
        8, 10, jnp.float32)[1:])
    P = np.asarray(qp.P)
    asym = np.max(np.abs(P - P.transpose(0, 2, 1)))
    assert asym == 0.0, f"Hessian not exactly symmetric: {asym}"
    for b in range(P.shape[0]):
        w = la.eigvalsh(P[b].astype(np.float64))
        assert w.min() > 0, f"indefinite Hessian, min eig {w.min()}"
