"""Batched ANALYTIC floating-base dynamics for the articulated simulator.

The autodiff Lagrangian model (models/whole_body.py — the idiomatic JAX
derivation the WBC linearizes against) re-derives M(q)/nle(q,v)/J(q) through
`jax.jvp`/`jax.hessian` of a per-scenario FK at every call; under a
scenario batch that is the dominant cost of the articulated sweep backend.
This module is the hand-structured equivalent the reference gets from Pinocchio's CRBA/RNEA (reference: src/wbc_ctrl/
wbc.cpp:59-91 pulling M/nle/J from pinocchio::crba/rnea), written
batch-first: one leg-vectorized FK pass, then

  * M(q)   — composite over the 13 bodies: M = sum_b m_b Jv_b^T Jv_b
             + Jw_b^T I_b^w Jw_b with ANALYTIC body Jacobians (base
             columns from the ZYX euler-rate matrix E, joint columns from
             world joint axes x lever arms);
  * nle    — recursive Newton-Euler bias sweep with qdd = 0: propagate
             bias angular/linear accelerations down each leg chain
             (including the Edot*erate term of the euler-rate
             parameterization), map the per-body Newton-Euler bias
             wrenches back through the same Jacobians;
  * J_feet — the calf-point Jacobian columns of the same structure.

Everything is einsums over (B, bodies, 3, 18) arrays — large batched
contractions the MXU tiles, zero AD at runtime. Exactness is pinned
against the autodiff model by tests/test_wb_dynamics_b.py (same
coordinates q = [base pos, ZYX euler, 12 joints], v = dq/dt)."""

from typing import NamedTuple

import jax.numpy as jnp

from legged_mpc_control_tpu.constants import GRAVITY_EST
from legged_mpc_control_tpu.models import whole_body as wb


def _rx_b(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack([
        jnp.stack([o, z, z], -1),
        jnp.stack([z, c, -s], -1),
        jnp.stack([z, s, c], -1)], -2)


def _ry_b(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack([
        jnp.stack([c, z, s], -1),
        jnp.stack([z, o, z], -1),
        jnp.stack([-s, z, c], -1)], -2)


def _rz_b(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1)], -2)


class _Fk(NamedTuple):
    """Leg-vectorized FK products (B batch, 4 legs)."""
    pos: jnp.ndarray        # (B,3) base origin
    Rb: jnp.ndarray         # (B,3,3)
    E: jnp.ndarray          # (B,3,3) euler-rate matrix: omega = E @ erate
    R_hip: jnp.ndarray      # (B,4,3,3)
    R_thigh: jnp.ndarray
    R_calf: jnp.ndarray
    p_hipj: jnp.ndarray     # (B,4,3) joint positions, world
    p_hfe: jnp.ndarray
    p_kfe: jnp.ndarray
    p_foot: jnp.ndarray
    a1: jnp.ndarray         # (B,4,3) world joint axes
    a2: jnp.ndarray
    a3: jnp.ndarray
    c_trunk: jnp.ndarray    # (B,3) trunk COM, world
    c_hip: jnp.ndarray      # (B,4,3) link COMs, world
    c_thigh: jnp.ndarray
    c_calf: jnp.ndarray


def fk_b(q, model: wb.WbModel) -> _Fk:
    """Batched FK of the 13-body tree. q (B,18)."""
    dtype = q.dtype
    pos = q[:, 0:3]
    Rz, Ry, Rx = _rz_b(q[:, 3]), _ry_b(q[:, 4]), _rx_b(q[:, 5])
    RzRy = jnp.einsum("bij,bjk->bik", Rz, Ry)
    Rb = jnp.einsum("bij,bjk->bik", RzRy, Rx)
    # ZYX euler-rate matrix: omega = psi_dot z + theta_dot Rz y
    #                              + phi_dot Rz Ry x
    E = jnp.stack([
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype), pos.shape),
        Rz[:, :, 1], RzRy[:, :, 0]], axis=-1)              # (B,3,3)

    qj = q[:, 6:18].reshape(-1, 4, 3)
    R_hip = jnp.einsum("bij,bljk->blik", Rb, _rx_b(qj[..., 0]))
    R_thigh = jnp.einsum("blij,bljk->blik", R_hip, _ry_b(qj[..., 1]))
    R_calf = jnp.einsum("blij,bljk->blik", R_thigh, _ry_b(qj[..., 2]))

    mdl = lambda x: jnp.asarray(x, dtype)
    p_hipj = pos[:, None] + jnp.einsum("bij,lj->bli", Rb,
                                       mdl(model.hip_origin))
    p_hfe = p_hipj + jnp.einsum("blij,lj->bli", R_hip,
                                mdl(model.hfe_origin))
    p_kfe = p_hfe + jnp.einsum("blij,lj->bli", R_thigh,
                               mdl(model.kfe_origin))
    p_foot = p_kfe + jnp.einsum("blij,lj->bli", R_calf,
                                mdl(model.foot_origin))

    a1 = jnp.broadcast_to(Rb[:, None, :, 0], p_hipj.shape)  # base x axis
    a2 = R_hip[..., :, 1]                                    # hip-frame y
    a3 = R_thigh[..., :, 1]                                  # thigh-frame y

    lc = mdl(model.link_com)                                 # (4,3,3)
    c_trunk = pos + jnp.einsum("bij,j->bi", Rb, mdl(model.trunk_com))
    c_hip = p_hipj + jnp.einsum("blij,lj->bli", R_hip, lc[:, 0])
    c_thigh = p_hfe + jnp.einsum("blij,lj->bli", R_thigh, lc[:, 1])
    c_calf = p_kfe + jnp.einsum("blij,lj->bli", R_calf, lc[:, 2])
    return _Fk(pos, Rb, E, R_hip, R_thigh, R_calf, p_hipj, p_hfe, p_kfe,
               p_foot, a1, a2, a3, c_trunk, c_hip, c_thigh, c_calf)


def _leg_cols_to_12(blk):
    """(B,4,3,3) per-leg joint columns -> (B,4,3,12) block-diagonal in the
    leg index (leg l's columns live at 3l..3l+2, other legs zero)."""
    eye4 = jnp.eye(4, dtype=blk.dtype)
    full = blk[:, :, :, None, :] * eye4[None, :, None, :, None]
    return full.reshape(blk.shape[0], 4, 3, 12)


def _point_jac(fk: _Fk, p, lever_joints):
    """Jacobian (B,...,3,18) of world point(s) p fixed in a leg body.
    lever_joints: list of (axis (B,4,3), joint_pos (B,4,3)) on the chain.
    p: (B,4,3)."""
    B = p.shape[0]
    dtype = p.dtype
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 4, 3, 3))
    rel = p - fk.pos[:, None]
    # euler columns: E_k x (p - pos)
    Je = jnp.stack([jnp.cross(jnp.broadcast_to(fk.E[:, None, :, k], rel.shape),
                              rel) for k in range(3)], axis=-1)
    cols = []
    for a, pj in lever_joints:
        cols.append(jnp.cross(a, p - pj))
    while len(cols) < 3:
        cols.append(jnp.zeros_like(p))
    Jj = _leg_cols_to_12(jnp.stack(cols, axis=-1))
    return jnp.concatenate([I3, Je, Jj], axis=-1)          # (B,4,3,18)


def _body_jacs(fk: _Fk, model: wb.WbModel, dtype):
    """Stacked linear/angular COM Jacobians of the 13 bodies.
    Returns Jv (B,13,3,18), Jw (B,13,3,18), coms (B,13,3)."""
    B = fk.pos.shape[0]
    zero4 = jnp.zeros((B, 4, 3), dtype)

    # trunk
    rel_t = fk.c_trunk - fk.pos
    Je_t = jnp.stack([jnp.cross(fk.E[:, :, k], rel_t) for k in range(3)],
                     axis=-1)
    Jv_trunk = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)), Je_t,
        jnp.zeros((B, 3, 12), dtype)], axis=-1)[:, None]   # (B,1,3,18)
    Jw_trunk = jnp.concatenate([
        jnp.zeros((B, 3, 3), dtype), fk.E,
        jnp.zeros((B, 3, 12), dtype)], axis=-1)[:, None]

    # legs: COM Jacobians per body
    Jv_hip = _point_jac(fk, fk.c_hip, [(fk.a1, fk.p_hipj)])
    Jv_thigh = _point_jac(fk, fk.c_thigh,
                          [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe)])
    Jv_calf = _point_jac(fk, fk.c_calf,
                         [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe),
                          (fk.a3, fk.p_kfe)])

    def jw_leg(axes):
        cols = list(axes) + [zero4] * (3 - len(axes))
        Jj = _leg_cols_to_12(jnp.stack(cols, axis=-1))
        Jbase = jnp.broadcast_to(fk.E[:, None], (B, 4, 3, 3))
        return jnp.concatenate([jnp.zeros((B, 4, 3, 3), dtype), Jbase, Jj],
                               axis=-1)
    Jw_hip = jw_leg([fk.a1])
    Jw_thigh = jw_leg([fk.a1, fk.a2])
    Jw_calf = jw_leg([fk.a1, fk.a2, fk.a3])

    def interleave(h, t, c):
        # (B,4,3,18) x3 -> (B,12,3,18) in body order hip,thigh,calf per leg
        return jnp.stack([h, t, c], axis=2).reshape(
            h.shape[0], 12, 3, 18)
    Jv = jnp.concatenate([Jv_trunk, interleave(Jv_hip, Jv_thigh, Jv_calf)],
                         axis=1)
    Jw = jnp.concatenate([Jw_trunk, interleave(Jw_hip, Jw_thigh, Jw_calf)],
                         axis=1)
    coms = jnp.concatenate([
        fk.c_trunk[:, None],
        jnp.stack([fk.c_hip, fk.c_thigh, fk.c_calf], axis=2).reshape(
            fk.pos.shape[0], 12, 3)], axis=1)
    return Jv, Jw, coms


def _world_inertias(fk: _Fk, model: wb.WbModel, dtype):
    """(B,13,3,3) world-frame body inertias about COM, in trunk/hip/thigh/
    calf interleaved body order; plus (13,) masses."""
    I_tr = jnp.einsum("bij,jk,blk->bil", fk.Rb,
                      jnp.asarray(model.trunk_inertia, dtype), fk.Rb)
    li = jnp.asarray(model.link_inertia, dtype)            # (4,3,3,3)
    Iw = []
    for ci, R in ((0, fk.R_hip), (1, fk.R_thigh), (2, fk.R_calf)):
        Iw.append(jnp.einsum("blij,ljk,blmk->blim", R, li[:, ci], R))
    Iw_legs = jnp.stack(Iw, axis=2).reshape(fk.pos.shape[0], 12, 3, 3)
    Iw_all = jnp.concatenate([I_tr[:, None], Iw_legs], axis=1)
    masses = jnp.concatenate([
        jnp.asarray([model.trunk_mass], dtype),
        jnp.asarray(model.link_mass, dtype).reshape(-1)])
    return Iw_all, masses


def dyn_terms_b(q, v, model: wb.WbModel):
    """All dynamics terms of the articulated step from ONE batched FK pass:
    returns (M (B,18,18), nle (B,18), J_feet (B,4,3,18), feet (B,4,3)).

    Matches models.whole_body.{mass_matrix, nonlinear_effects,
    foot_jacobians, foot_positions} (pinned by tests/test_wb_dynamics_b.py)
    at a fraction of the cost: no AD, one FK, batched einsums."""
    dtype = q.dtype
    fk = fk_b(q, model)
    Jv, Jw, coms = _body_jacs(fk, model, dtype)
    Iw, masses = _world_inertias(fk, model, dtype)

    # --- mass matrix: composite over bodies ---
    M = (jnp.einsum("n,bnik,bnil->bkl", masses, Jv, Jv)
         + jnp.einsum("bnik,bnij,bnjl->bkl", Jw, Iw, Jw))

    # --- RNEA bias sweep (qdd = 0) ---
    erate = v[:, 3:6]
    dqj = v[:, 6:18].reshape(-1, 4, 3)
    w_base = jnp.einsum("bij,bj->bi", fk.E, erate)
    # alpha_base = Edot @ erate with Edot columns from the chain rule:
    #   d/dt E2 = psi_dot (E1 x E2),  d/dt E3 = psi_dot (E1 x E3)
    #                                         + theta_dot (E2 x E3)
    E1, E2, E3 = fk.E[:, :, 0], fk.E[:, :, 1], fk.E[:, :, 2]
    psi_d, th_d, ph_d = erate[:, 0], erate[:, 1], erate[:, 2]
    al_base = (th_d[:, None] * psi_d[:, None] * jnp.cross(E1, E2)
               + ph_d[:, None] * (psi_d[:, None] * jnp.cross(E1, E3)
                                  + th_d[:, None] * jnp.cross(E2, E3)))

    wb4 = jnp.broadcast_to(w_base[:, None], (q.shape[0], 4, 3))
    ab4 = jnp.broadcast_to(al_base[:, None], wb4.shape)
    w_hip = wb4 + fk.a1 * dqj[..., 0:1]
    al_hip = ab4 + jnp.cross(wb4, fk.a1) * dqj[..., 0:1]
    w_thigh = w_hip + fk.a2 * dqj[..., 1:2]
    al_thigh = al_hip + jnp.cross(w_hip, fk.a2) * dqj[..., 1:2]
    w_calf = w_thigh + fk.a3 * dqj[..., 2:3]
    al_calf = al_thigh + jnp.cross(w_thigh, fk.a3) * dqj[..., 2:3]

    def pt_acc(a_ref, al, w, r):
        return a_ref + jnp.cross(al, r) + jnp.cross(w, jnp.cross(w, r))

    a_hipj = pt_acc(0.0, ab4, wb4, fk.p_hipj - fk.pos[:, None])
    a_hfe = pt_acc(a_hipj, al_hip, w_hip, fk.p_hfe - fk.p_hipj)
    a_kfe = pt_acc(a_hfe, al_thigh, w_thigh, fk.p_kfe - fk.p_hfe)

    a_c_trunk = pt_acc(0.0, al_base[:, None], w_base[:, None],
                       fk.c_trunk[:, None] - fk.pos[:, None])[:, 0]
    a_c_hip = pt_acc(a_hipj, al_hip, w_hip, fk.c_hip - fk.p_hipj)
    a_c_thigh = pt_acc(a_hfe, al_thigh, w_thigh, fk.c_thigh - fk.p_hfe)
    a_c_calf = pt_acc(a_kfe, al_calf, w_calf, fk.c_calf - fk.p_kfe)

    def stack_bodies(tr, h, t, c):
        return jnp.concatenate([
            tr[:, None],
            jnp.stack([h, t, c], axis=2).reshape(q.shape[0], 12, 3)],
            axis=1)
    acc = stack_bodies(a_c_trunk, a_c_hip, a_c_thigh, a_c_calf)
    wbod = stack_bodies(w_base, w_hip, w_thigh, w_calf)
    albod = stack_bodies(al_base, al_hip, al_thigh, al_calf)

    g_up = jnp.array([0.0, 0.0, GRAVITY_EST], dtype)
    F = masses[None, :, None] * (acc + g_up)               # (B,13,3)
    T = (jnp.einsum("bnij,bnj->bni", Iw, albod)
         + jnp.cross(wbod, jnp.einsum("bnij,bnj->bni", Iw, wbod)))
    nle = (jnp.einsum("bnik,bni->bk", Jv, F)
           + jnp.einsum("bnik,bni->bk", Jw, T))

    J_feet = _point_jac(fk, fk.p_foot,
                        [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe),
                         (fk.a3, fk.p_kfe)])
    return M, nle, J_feet, fk.p_foot


def mass_matrix_b(q, model: wb.WbModel):
    M, _, _, _ = dyn_terms_b(q, jnp.zeros_like(q), model)
    return M


def nonlinear_effects_b(q, v, model: wb.WbModel):
    _, nle, _, _ = dyn_terms_b(q, v, model)
    return nle


def foot_jacobians_b(q, model: wb.WbModel):
    fk = fk_b(q, model)
    return _point_jac(fk, fk.p_foot,
                      [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe),
                       (fk.a3, fk.p_kfe)])


def foot_positions_b(q, model: wb.WbModel):
    return fk_b(q, model).p_foot
