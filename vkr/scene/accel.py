"""Scene acceleration structure — the BLAS/TLAS analog as an array program.

The reference builds per-mesh Vulkan BLASes plus a TLAS of instanced
transforms (src/scene/scene_as.cpp:19-134,205-272) and consumes them
through opaque hardware ray queries (gtao.cpp:150-196,
shaders/gtao/rt_main.frag). A hierarchical BVH walk is a poor fit for
a vectorized array program (data-dependent tree descent per ray), so
the analog here is a UNIFORM GRID over the world-space triangle pool:

  * build (host, numpy, at scene upload): bin every world-space
    triangle into the grid cells its AABB overlaps — a dense
    (cells, CAP) triangle-id table (id -1 = empty slot). Dense beats
    CSR here: per-cell slot lookups stay regular-shaped for XLA, and
    the GTAO-RT consumer's rays are SHORT (0.2 world units,
    rt_main.frag:94), so cells stay small and CAP modest.
  * traversal (jnp, jit-able): a 3-D DDA (branchless lax.fori_loop over
    a static max step count) walks the cells pierced by each ray
    segment; each visited cell tests its CAP triangle slots with
    Moller-Trumbore any-hit. Everything is vectorized over rays;
    triangle data reaches the lanes through two gathers per
    (cell, slot); the consumer (gtao_rt) is opt-in exactly like the
    reference's
    USE_RAY_QUERY=0 default (main.cpp:40).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TriGrid:
    """Uniform-grid acceleration structure (the BLAS/TLAS analog)."""

    tri_verts: jnp.ndarray   # (T, 3, 3) f32 world-space triangles
    cell_tris: jnp.ndarray   # (cells, CAP) i32 triangle ids, -1 empty
    grid_min: jnp.ndarray    # (3,) f32
    cell_size: jnp.ndarray   # (3,) f32
    dims: Tuple[int, int, int]  # static cell counts per axis
    cap: int                    # static slots per cell
    overflowed: int             # static: cells that exceeded CAP (build
                                # keeps the first CAP — conservative MISS)

    def tree_flatten(self):
        return (self.tri_verts, self.cell_tris, self.grid_min,
                self.cell_size), (self.dims, self.cap, self.overflowed)

    @classmethod
    def tree_unflatten(cls, aux, children):
        tri_verts, cell_tris, grid_min, cell_size = children
        dims, cap, overflowed = aux
        return cls(tri_verts=tri_verts, cell_tris=cell_tris,
                   grid_min=grid_min, cell_size=cell_size, dims=dims,
                   cap=cap, overflowed=overflowed)


def build_tri_grid(world_positions, indices, resolution: int = 48,
                   cap: int = 24) -> TriGrid:
    """Bin world-space triangles into a uniform grid (host-side numpy —
    the scene_as.cpp build analog; runs once at scene upload).

    world_positions: (V, 3); indices: (T, 3) int. resolution: cells on
    the LONGEST axis (others scale by extent, min 1). cap: triangle
    slots per cell; overflowing cells keep the first cap ids and are
    counted in .overflowed (any-hit there can MISS — conservative in
    the AO sense: less occlusion, never a false hit)."""
    pos = np.asarray(world_positions, np.float64)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    tri = pos[idx]  # (T, 3, 3)
    t_min = tri.min(axis=1)
    t_max = tri.max(axis=1)
    lo = t_min.min(axis=0)
    hi = t_max.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    longest = extent.max()
    dims = np.maximum(
        1, np.round(extent / longest * resolution).astype(np.int64)
    )
    cell = extent / dims
    ncell = int(dims.prod())

    c_lo = np.clip(((t_min - lo) / cell).astype(np.int64), 0, dims - 1)
    c_hi = np.clip(((t_max - lo) / cell).astype(np.int64), 0, dims - 1)
    span = c_hi - c_lo + 1  # (T, 3)

    counts = np.zeros(ncell, np.int64)
    table = np.full((ncell, cap), -1, np.int64)
    overflow = 0
    sx, sy, sz = int(dims[0]), int(dims[1]), int(dims[2])
    for t in range(tri.shape[0]):
        x0, y0, z0 = c_lo[t]
        nx, ny, nz = span[t]
        for dz in range(nz):
            for dy in range(ny):
                base = ((z0 + dz) * sy + (y0 + dy)) * sx + x0
                for dx in range(nx):
                    c = base + dx
                    k = counts[c]
                    if k < cap:
                        table[c, k] = t
                        counts[c] = k + 1
                    else:
                        overflow += 1
    return TriGrid(
        tri_verts=jnp.asarray(tri, jnp.float32),
        cell_tris=jnp.asarray(table, jnp.int32),
        grid_min=jnp.asarray(lo, jnp.float32),
        cell_size=jnp.asarray(cell, jnp.float32),
        dims=(sx, sy, sz),
        cap=int(cap),
        overflowed=int(overflow),
    )


def _tri_hit_mask(orig, dirs, v0, e1, e2, t_max, eps=1e-12):
    """Moller-Trumbore any-hit for t in (eps, t_max). All args broadcast
    over leading dims; returns bool mask."""
    p = jnp.cross(dirs, e2)
    det = (e1 * p).sum(-1)
    inv = jnp.where(jnp.abs(det) < 1e-20, 0.0, 1.0 / jnp.where(
        det == 0.0, 1.0, det))
    s = orig - v0
    u = (s * p).sum(-1) * inv
    q = jnp.cross(s, e1)
    v = (dirs * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return (
        (jnp.abs(det) >= 1e-20)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps) & (t < t_max)
    )


def ray_any_hit(grid: TriGrid, origin, direction, t_max,
                max_steps: "int | None" = None):
    """rayQuery any-hit analog: True where the segment
    origin + t*direction, t in (0, t_max] intersects scene geometry.

    origin/direction: (..., 3); t_max: scalar or (...). Branchless 3-D
    DDA with per-ray axis stepping; each step tests the current cell's
    CAP triangle slots (two gathers per slot batch). max_steps bounds
    the cell walk — callers with short rays (gtao_rt: 0.2 world units)
    should pass ceil(manhattan cell span) + 2; default walks the whole
    grid."""
    sx, sy, sz = grid.dims
    dims = jnp.asarray([sx, sy, sz], jnp.int32)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             origin.shape[:-1])
    cell = grid.cell_size
    if max_steps is None:
        max_steps = int(sx + sy + sz)

    inv = jnp.where(
        jnp.abs(direction) < 1e-20, 1e20,
        1.0 / jnp.where(direction == 0.0, 1.0, direction),
    )
    # entry cell
    rel = (origin - grid.grid_min) / cell
    ic = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, dims - 1)
    step = jnp.where(direction >= 0.0, 1, -1)
    # t to the next boundary per axis
    next_b = (ic + (step > 0).astype(jnp.int32)).astype(jnp.float32)
    t_next = (next_b * cell + grid.grid_min - origin) * inv
    t_next = jnp.where(jnp.abs(direction) < 1e-20, 1e20, t_next)
    dt = jnp.abs(cell * inv)

    flat_dim = sx * sy * sz
    cap = grid.cap

    def test_cell(ic_cur, t_lo, active):
        flat = ((ic_cur[..., 2] * sy + ic_cur[..., 1]) * sx
                + ic_cur[..., 0])
        flat = jnp.clip(flat, 0, flat_dim - 1)
        slots = grid.cell_tris[flat]              # (..., CAP) gather
        tv = grid.tri_verts[jnp.maximum(slots, 0)]  # (..., CAP, 3, 3)
        v0 = tv[..., 0, :]
        e1 = tv[..., 1, :] - v0
        e2 = tv[..., 2, :] - v0
        m = _tri_hit_mask(
            origin[..., None, :], direction[..., None, :], v0, e1, e2,
            t_max[..., None],
        )
        m = m & (slots >= 0) & active[..., None]
        return m.any(-1)

    def body(_, carry):
        ic_cur, t_next_c, t_cur, hit, alive = carry
        hit = hit | test_cell(ic_cur, t_cur, alive & ~hit)
        # advance to the next cell along the smallest t_next
        tmin = jnp.min(t_next_c, axis=-1)
        ax = jnp.argmin(t_next_c, axis=-1)
        onehot = ax[..., None] == jnp.arange(3)[None, :]
        ic_new = ic_cur + jnp.where(onehot, step, 0)
        t_next_new = t_next_c + jnp.where(onehot, dt, 0.0)
        inside = ((ic_new >= 0) & (ic_new < dims)).all(-1)
        alive = alive & inside & (tmin <= t_max)
        ic_new = jnp.clip(ic_new, 0, dims - 1)
        return (jnp.where(alive[..., None], ic_new, ic_cur),
                t_next_new, tmin, hit, alive)

    hit0 = jnp.zeros(origin.shape[:-1], bool)
    alive0 = jnp.ones(origin.shape[:-1], bool)
    zeros_t = jnp.zeros(origin.shape[:-1], jnp.float32)
    _, _, _, hit, _ = jax.lax.fori_loop(
        0, max_steps, body, (ic, t_next, zeros_t, hit0, alive0)
    )
    return hit
