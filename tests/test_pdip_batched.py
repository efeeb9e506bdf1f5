"""Batched PDIP path (the condensed bench path) vs the per-scenario
reference."""

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge
from legged_mpc_control_tpu.mpc import pdip


def test_batched_xla_matches_vmap_path():
    dtype = jnp.float64
    H, B = 10, 6
    params, x0, contact = ge._make_problem_batch(B, H, dtype)
    solve_batched = jax.jit(ge._solve_batch_fn(params, H, iters=20,
                                               solver="pdip"))
    got = solve_batched(x0, contact)

    # per-scenario reference through the original API
    from legged_mpc_control_tpu.mpc import qp_builder, reference
    from legged_mpc_control_tpu.ops import so3

    def one(x0_, c_):
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
        qp = qp_builder.build_condensed_qp(
            x0_, x_ref, A_seq, Bm, c_, params.q_weights, params.r_weights,
            params.mu, params.fz_max, 0.01)
        return pdip.solve_qp_pdip(qp.P, qp.q, qp.mu, qp.fz_max,
                                  contact=c_, iters=20).u[:12]

    want = jax.vmap(one)(x0, contact)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-9)

