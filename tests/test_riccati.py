"""Riccati stagewise IPM vs the condensed dense PDIP (same QP, same optimum).

The Riccati solver factors the SAME Newton systems through the LQR
recursion, so its iterates — and solutions — must match the condensed
pdip path to roundoff in f64, at both short and long (H=30) horizons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from legged_mpc_control_tpu.mpc import pdip, riccati


def _problem(batch, horizon, dtype=jnp.float64):
    params, x0, contact = ge._make_problem_batch(batch, horizon, dtype)
    build = ge._qp_batch_fn(params, horizon)

    from legged_mpc_control_tpu.mpc import reference
    from legged_mpc_control_tpu.ops import so3

    def lin_one(x0_):
        root_euler = x0_[0:3]
        R = so3.quat_to_rotmat(so3.euler_to_quat(root_euler))
        cmd = reference.MpcCmd(
            root_pos_d=jnp.array([0.0, 0.0, 0.3], dtype),
            root_euler_d=jnp.zeros(3, dtype).at[2].set(root_euler[2]),
            root_lin_vel_d_rel=jnp.array([0.3, 0.0, 0.0], dtype),
            root_ang_vel_d_rel=jnp.zeros(3, dtype))
        x_ref, yaw_ref, _ = reference.build_reference(
            root_euler, x0_[3:6], R, cmd, horizon, 0.01)
        fpa = (R @ params.default_foot_pos.astype(dtype).T).T
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass, params.trunk_inertia, R, fpa, 0.01)
        return x_ref, A_seq, Bm

    x_ref, A_seq, Bm = jax.vmap(lin_one)(x0)
    return params, x0, contact, x_ref, A_seq, Bm, build


def test_riccati_matches_condensed_h10():
    params, x0, contact, x_ref, A_seq, Bm, build = _problem(4, 10)
    qp = build(x0, contact)
    want = pdip.solve_qp_pdip_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact,
        iters=25)
    got = riccati.solve_qp_riccati_batched(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, 0.01, iters=25)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               atol=1e-8)


def test_riccati_matches_condensed_h30():
    """H=30 (the reference's actual horizon, LeggedParams.h:13)."""
    params, x0, contact, x_ref, A_seq, Bm, build = _problem(3, 30)
    qp = build(x0, contact)
    want = pdip.solve_qp_pdip_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact,
        iters=30)
    got = riccati.solve_qp_riccati_batched(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, 0.01, iters=30)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               atol=1e-7)
    # constraint sanity: cones + box hold on the stance legs
    u = np.asarray(got.u).reshape(3, 30, 4, 3)
    c = np.asarray(contact)
    fz = u[..., 2]
    assert np.all(fz > -1e-8)
    assert np.all(fz <= float(params.fz_max) + 1e-6)
    mu_ = float(params.mu)
    assert np.all(np.abs(u[..., 0]) <= mu_ * fz + 1e-6)
    assert np.all(np.abs(u[..., 1]) <= mu_ * fz + 1e-6)
    assert np.all(np.abs(u[c == 0.0]) < 1e-12)   # swing exactly zero


@pytest.mark.parametrize("horizon,batch", [(10, 5), (12, 3), (30, 3)])
def test_stage_scan_matches_condensed_odd_batch(horizon, batch):
    """The XLA stage scan (the product solver at every horizon) vs the
    condensed PDIP on odd batches, at the product horizon H=10, the
    H=12 plan and the reference's H=30."""
    params, x0, contact, x_ref, A_seq, Bm, build = _problem(batch, horizon)
    qp = build(x0, contact)
    want = pdip.solve_qp_pdip_batched(
        qp.P, qp.q, params.mu, params.fz_max, contact, iters=30)
    got = riccati.solve_qp_riccati_batched(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, 0.01, iters=30)
    assert got.u.shape == (batch, 12 * horizon)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               atol=1e-7)
    assert np.all(np.asarray(got.gap) < 1e-8)


def test_riccati_f32_close_to_f64():
    params, x0, contact, x_ref, A_seq, Bm, build = _problem(3, 30,
                                                            jnp.float64)
    want = riccati.solve_qp_riccati_batched(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, 0.01, iters=30)
    f32 = lambda t: jnp.asarray(t, jnp.float32)
    got = riccati.solve_qp_riccati_batched(
        f32(x0), f32(x_ref), f32(A_seq), f32(Bm), f32(contact),
        f32(params.q_weights), f32(params.r_weights),
        jnp.float32(params.mu), jnp.float32(params.fz_max), 0.01, iters=20)
    err = np.max(np.abs(np.asarray(got.u, np.float64)
                        - np.asarray(want.u)))
    # f32 GRF agreement within ~0.02 N over |u| ~ 100 N (same envelope the
    # condensed f32 path holds, tests/test_pdip_f32.py)
    assert err < 5e-2, err
    assert np.all(np.isfinite(np.asarray(got.u)))
