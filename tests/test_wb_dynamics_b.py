"""Analytic batched CRBA/RNEA (models/whole_body_b.py) vs the autodiff
Lagrangian model (models/whole_body.py): the AD derivation is the oracle —
the analytic sweep must reproduce M(q), nle(q,v), foot Jacobians, and foot
positions exactly (same coordinates, same URDF data; reference parity
anchor: Pinocchio crba/rnea feeding the WBC, wbc.cpp:59-91)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legged_mpc_control_tpu.models import whole_body as wb
from legged_mpc_control_tpu.models import whole_body_b as wbb


def _rand_states(model, B=5, seed=0, dtype=jnp.float64):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    q = jnp.concatenate([
        0.3 * jax.random.normal(k1, (B, 3), dtype),
        0.6 * jax.random.normal(k2, (B, 3), dtype),
        jnp.tile(jnp.array([0.1, 0.9, -1.7], dtype), (B, 4))
        + 0.4 * jax.random.normal(k3, (B, 12), dtype)], axis=1)
    v = jax.random.normal(jax.random.PRNGKey(seed + 7), (B, 18), dtype)
    return q, v


@pytest.mark.parametrize("robot", ["a1", "go1"])
def test_analytic_matches_autodiff(robot):
    model = wb.wb_model_for(robot)
    q, v = _rand_states(model)

    M_b, nle_b, J_b, feet_b = wbb.dyn_terms_b(q, v, model)
    M_ad = jax.vmap(lambda qq: wb.mass_matrix(qq, model))(q)
    nle_ad = jax.vmap(lambda qq, vv: wb.nonlinear_effects(qq, vv, model))(
        q, v)
    J_ad = jax.vmap(lambda qq: wb.foot_jacobians(qq, model))(q)
    feet_ad = jax.vmap(lambda qq: wb.foot_positions(qq, model))(q)

    np.testing.assert_allclose(np.asarray(M_b), np.asarray(M_ad),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(nle_b), np.asarray(nle_ad),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(J_b), np.asarray(J_ad),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(feet_b), np.asarray(feet_ad),
                               rtol=1e-9, atol=1e-12)


def test_analytic_f32_consistency():
    """The f32 product path stays within fp tolerance of the f64 analytic
    sweep (the articulated sim runs f32 on the accelerator)."""
    model = wb.a1_wb_model()
    q64, v64 = _rand_states(model, B=3, seed=3)
    M64, nle64, J64, _ = wbb.dyn_terms_b(q64, v64, model)
    M32, nle32, J32, _ = wbb.dyn_terms_b(
        q64.astype(jnp.float32), v64.astype(jnp.float32), model)
    np.testing.assert_allclose(np.asarray(M32), np.asarray(M64),
                               rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(nle32), np.asarray(nle64),
                               rtol=3e-3, atol=2e-2)
    np.testing.assert_allclose(np.asarray(J32), np.asarray(J64),
                               rtol=2e-4, atol=2e-5)
