"""Height-map terrain: jittable ground model for footholds and simulation.

The reference handles non-flat ground implicitly — each leg's FSM records
the terrain height it touched down on (reference: LeggedContactFSM.cpp:86-90
`terrain_height = ...` in stance) and the CI-MPC README demonstrates
box-stepping (reference: README.md:14). Here terrain is an explicit
first-class height field so the planner can place footholds on it
(BASELINE.md config 4: "H=30 QP with time-varying contact sequence +
height-map footholds") and the SRB simulator can stand on it.

A `Terrain` is a regular grid of heights with bilinear interpolation —
a pure pytree, so it vmaps over scenarios (per-scenario terrain
randomization) and lives inside `jit`/`scan`.
"""

from typing import Any

import jax.numpy as jnp

from legged_mpc_control_tpu import pytree


@pytree.dataclass
class Terrain:
    heights: Any      # (Nx, Ny) grid of ground heights
    origin: Any       # (2,) world xy of grid node [0, 0]
    cell: Any         # scalar grid spacing (m)


@pytree.dataclass
class Wall:
    """Vertical half-space obstacle: free space is {p : (p - point)·normal
    >= 0}, i.e. `normal` is the unit contact normal pointing OUT of the
    wall. Feeds the contact-implicit optimizer's gap function
    (mpc/ci_mpc.py) and the articulated simulator's compliant contact
    (sim/wb_sim.py) — the surface the reference's CI-MPC leans Go1 against
    (reference: README.md:14 "lean against wall")."""
    point: Any        # (3,) any point on the wall plane
    normal: Any       # (3,) unit normal into free space


def wall_at_x(x, dtype=jnp.float32) -> Wall:
    """Wall plane x = `x` with free space on the -x side (robot approaches
    walking +x)."""
    return Wall(point=jnp.array([x, 0.0, 0.0], dtype=dtype),
                normal=jnp.array([-1.0, 0.0, 0.0], dtype=dtype))


def wall_gap(w: Wall, p):
    """Signed distance of points p (..., 3) to the wall (>= 0 in free
    space)."""
    return jnp.sum((p - w.point) * w.normal, axis=-1)


def flat(extent=4.0, cell=0.1, dtype=jnp.float32) -> Terrain:
    n = int(2 * extent / cell) + 1
    return Terrain(
        heights=jnp.zeros((n, n), dtype=dtype),
        origin=jnp.array([-extent, -extent], dtype=dtype),
        cell=jnp.asarray(cell, dtype=dtype))


def add_box(t: Terrain, center_xy, size_xy, height) -> Terrain:
    """Raise a rectangular box/platform out of the ground."""
    dtype = t.heights.dtype
    nx, ny = t.heights.shape
    xs = t.origin[0] + t.cell * jnp.arange(nx, dtype=dtype)
    ys = t.origin[1] + t.cell * jnp.arange(ny, dtype=dtype)
    inx = jnp.abs(xs - center_xy[0]) <= size_xy[0] / 2.0
    iny = jnp.abs(ys - center_xy[1]) <= size_xy[1] / 2.0
    mask = inx[:, None] & iny[None, :]
    return t.replace(heights=jnp.where(mask,
                                       jnp.maximum(t.heights, height),
                                       t.heights))


def stairs(n_steps=5, step_height=0.05, step_depth=0.25, start_x=0.3,
           extent=4.0, cell=0.05, dtype=jnp.float32) -> Terrain:
    """Ascending staircase along +x."""
    t = flat(extent=extent, cell=cell, dtype=dtype)
    nx, ny = t.heights.shape
    xs = t.origin[0] + t.cell * jnp.arange(nx, dtype=dtype)
    step_idx = jnp.clip(jnp.floor((xs - start_x) / step_depth) + 1.0,
                        0.0, float(n_steps))
    h = (step_idx * step_height)[:, None]
    return t.replace(heights=jnp.broadcast_to(h, (nx, ny)).astype(dtype))


def random_rough(key, amplitude=0.03, extent=4.0, cell=0.1,
                 dtype=jnp.float32) -> Terrain:
    """Uniform random rough field (domain-randomization terrain)."""
    import jax

    t = flat(extent=extent, cell=cell, dtype=dtype)
    h = jax.random.uniform(key, t.heights.shape, dtype,
                           minval=0.0, maxval=amplitude)
    return t.replace(heights=h)


def height_at(t: Terrain, xy):
    """Bilinearly-interpolated ground height at world xy.

    xy: (..., 2). Returns (...). Out-of-grid queries clamp to the edge.
    """
    nx, ny = t.heights.shape
    g = (xy - t.origin) / t.cell                     # fractional grid coords
    gx = jnp.clip(g[..., 0], 0.0, nx - 1.000001)
    gy = jnp.clip(g[..., 1], 0.0, ny - 1.000001)
    ix = jnp.floor(gx).astype(jnp.int32)
    iy = jnp.floor(gy).astype(jnp.int32)
    fx = gx - ix
    fy = gy - iy
    h00 = t.heights[ix, iy]
    h10 = t.heights[jnp.minimum(ix + 1, nx - 1), iy]
    h01 = t.heights[ix, jnp.minimum(iy + 1, ny - 1)]
    h11 = t.heights[jnp.minimum(ix + 1, nx - 1),
                    jnp.minimum(iy + 1, ny - 1)]
    return ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
            + (1 - fx) * fy * h01 + fx * fy * h11)


def height_grad_at(t: Terrain, xy):
    """Analytic gradient of `height_at` w.r.t. world xy: (..., 2).

    The bilinear interpolant's exact in-cell gradient (clamped-edge cells
    included); at cell boundaries this is the right-sided subgradient,
    matching what AD of `height_at` produces. Used by the contact-implicit
    solver's closed-form quadratization (mpc/ci_mpc._quad_ggn_b)."""
    nx, ny = t.heights.shape
    g = (xy - t.origin) / t.cell
    gx = jnp.clip(g[..., 0], 0.0, nx - 1.000001)
    gy = jnp.clip(g[..., 1], 0.0, ny - 1.000001)
    ix = jnp.floor(gx).astype(jnp.int32)
    iy = jnp.floor(gy).astype(jnp.int32)
    fx = gx - ix
    fy = gy - iy
    h00 = t.heights[ix, iy]
    h10 = t.heights[jnp.minimum(ix + 1, nx - 1), iy]
    h01 = t.heights[ix, jnp.minimum(iy + 1, ny - 1)]
    h11 = t.heights[jnp.minimum(ix + 1, nx - 1),
                    jnp.minimum(iy + 1, ny - 1)]
    dhx = ((1 - fy) * (h10 - h00) + fy * (h11 - h01)) / t.cell
    dhy = ((1 - fx) * (h01 - h00) + fx * (h11 - h10)) / t.cell
    # out-of-grid queries clamp to the edge -> zero gradient there
    in_x = (g[..., 0] > 0.0) & (g[..., 0] < nx - 1.000001)
    in_y = (g[..., 1] > 0.0) & (g[..., 1] < ny - 1.000001)
    return jnp.stack([jnp.where(in_x, dhx, 0.0),
                      jnp.where(in_y, dhy, 0.0)], axis=-1)


def slope_pitch_at(t: Terrain, xy, heading_xy):
    """Terrain pitch (rad) along a heading direction — feeds the Bezier
    swing curve's terrain_pitch_angle (ops/bezier.py)."""
    d = heading_xy / jnp.maximum(jnp.linalg.norm(heading_xy), 1e-6)
    step = t.cell
    h0 = height_at(t, xy - 0.5 * step * d)
    h1 = height_at(t, xy + 0.5 * step * d)
    return jnp.arctan2(h1 - h0, step)
