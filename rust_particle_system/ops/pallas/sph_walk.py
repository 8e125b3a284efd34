"""SPH neighbour walk over sorted cell runs — Pallas kernels lowered through Triton.

This is the reference's own scheme (`compute_shader.wgsl:207-384`): particles are
sorted by dense cell key ``cy*gw + cx`` (``ops/grid.py`` ``build_grid``), so the
three cells of one neighbour row form ONE contiguous run of the sorted arrays, and
a walk needs no per-cell capacity.

Program shape (both launches):

* one program per tile of ``TX`` consecutive cells of one grid row, where ``TX`` is
  derived from the mean cell occupancy so that a tile holds about ``BLOCK_I``
  particles;
* the program loops over its own particles in chunks of ``BLOCK_I``;
* for each of the three neighbour rows it loops over the row's one contiguous run
  (cells ``x0-1 .. x1`` of that row) in masked chunks of ``BLOCK_J``;
* the radius test alone masks pairs: cells are one smoothing radius wide, so every
  pair within ``h`` lies in adjacent cells;
* pair terms stay in registers; only per-particle sums are written —
  (ρ, ρ_near) from the density launch, (fx, fy, fvx, fvy) from the force launch.

Spec v2 is kept (``ops/reference_step.py``): viscosity reads the pre-pressure
velocities, so pressure and viscosity share one walk.  So are the reference quirks:
self-inclusive density, the ε-guarded (0, 1) direction and the ρ_j·ρnear_j
denominator.  No matrix product appears, so nothing here runs in TF32.

``interpret=True`` runs the kernels in the Pallas interpreter (the CPU tests);
nothing infers it from the backend.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core import kernels as K
from ...core.params import SimParams
from ...core.state import ParticleState
from ..grid import GridSpec, SPHQuantities, build_grid

BLOCK_I = 64
BLOCK_J = 32
NUM_WARPS = 4
_EPS_DIST = 1e-4  # direction guard (compute_shader.wgsl:305)


def tile_width(n: int, num_cells: int) -> int:
    """Cells per program: about ``BLOCK_I`` particles at the mean occupancy."""
    return max(1, BLOCK_I * num_cells // max(n, 1))


def tile_ranges(starts, gw: int, gh: int, tx: int, row_lo: int = 0,
                row_hi: int | None = None):
    """[P, 8] int32 sorted-index ranges, one row per program.

    Program ``p`` owns cells ``x0 .. x1-1`` of grid row ``cy`` (rows ``row_lo ..
    row_hi-1``, ``ceil(gw/tx)`` tiles per row).  Columns: its own particles' run,
    then for ``d = -1, 0, +1`` the run of cells ``max(x0-1, 0) .. min(x1+1, gw)-1``
    in row ``cy+d`` (empty when that row is off the grid).  ``starts[c]`` is the
    first sorted index with key >= c, ``len(starts) >= gw*gh + 1``.
    """
    row_hi = gh if row_hi is None else row_hi
    ntx = -(-gw // tx)
    cy = jnp.repeat(jnp.arange(row_lo, row_hi, dtype=jnp.int32), ntx)
    x0 = jnp.tile(jnp.arange(ntx, dtype=jnp.int32) * tx, row_hi - row_lo)
    x1 = jnp.minimum(x0 + tx, gw)
    cols = [starts[cy * gw + x0], starts[cy * gw + x1]]
    nx0, nx1 = jnp.maximum(x0 - 1, 0), jnp.minimum(x1 + 1, gw)
    for d in (-1, 0, 1):
        r = cy + d
        on_grid = (r >= 0) & (r < gh)
        rc = jnp.clip(r, 0, gh - 1)
        lo = jnp.where(on_grid, starts[rc * gw + nx0], 0)
        hi = jnp.where(on_grid, starts[rc * gw + nx1], 0)
        cols += [lo, hi]
    return jnp.stack(cols, axis=1).astype(jnp.int32)


def _pair_geometry(xi, yi, xj, yj, h):
    """[BI, BJ] delta, distance and in-radius mask (d² <= h², as the reference)."""
    dx = xj[None, :] - xi[:, None]
    dy = yj[None, :] - yi[:, None]
    sq = dx * dx + dy * dy
    positive = sq > 0
    dist = jnp.where(positive, jnp.sqrt(jnp.where(positive, sq, 1.0)), 0.0)
    return dx, dy, dist, sq <= h * h


def _walk(ranges_ref, init, row_body, finish):
    """Loop over the program's own particles, then its three neighbour runs.

    ``init(i_idx, i_mask) -> (i_vals, acc)``; ``row_body(i_vals, j_idx, j_mask, acc)
    -> acc``; ``finish(i_idx, i_mask, i_vals, acc)`` stores the sums.  The
    accumulators are [BLOCK_I, BLOCK_J] tiles summed over j only in ``finish``, so
    the loop does no cross-lane reduction."""
    pid = pl.program_id(0)
    own_lo = ranges_ref[pid, 0]
    own_hi = ranges_ref[pid, 1]

    def i_chunk(ci, carry):
        i_idx = own_lo + ci * BLOCK_I + jnp.arange(BLOCK_I, dtype=jnp.int32)
        i_mask = i_idx < own_hi
        i_vals, acc = init(i_idx, i_mask)
        for d in range(3):
            lo = ranges_ref[pid, 2 + 2 * d]
            hi = ranges_ref[pid, 3 + 2 * d]

            def j_chunk(cj, acc, lo=lo, hi=hi):
                j_idx = lo + cj * BLOCK_J + jnp.arange(BLOCK_J, dtype=jnp.int32)
                return row_body(i_vals, j_idx, j_idx < hi, acc)

            acc = lax.fori_loop(0, pl.cdiv(hi - lo, BLOCK_J), j_chunk, acc)
        finish(i_idx, i_mask, i_vals, tuple(jnp.sum(a, axis=1) for a in acc))
        return carry

    lax.fori_loop(0, pl.cdiv(own_hi - own_lo, BLOCK_I), i_chunk, 0)


def _density_kernel(ranges_ref, scal_ref, x_ref, y_ref, rho_ref, rhon_ref):
    h, dnorm, nnorm = scal_ref[0], scal_ref[1], scal_ref[2]

    def init(i_idx, i_mask):
        xi = plgpu.load(x_ref.at[i_idx], mask=i_mask, other=0.0)
        yi = plgpu.load(y_ref.at[i_idx], mask=i_mask, other=0.0)
        zero = jnp.zeros((BLOCK_I, BLOCK_J), jnp.float32)
        return (xi, yi), (zero, zero)

    def row_body(i_vals, j_idx, j_mask, acc):
        xi, yi = i_vals
        xj = plgpu.load(x_ref.at[j_idx], mask=j_mask, other=0.0)
        yj = plgpu.load(y_ref.at[j_idx], mask=j_mask, other=0.0)
        _, _, dist, near = _pair_geometry(xi, yi, xj, yj, h)
        valid = near & j_mask[None, :]
        w = jnp.where(valid, K.density_kernel(dist, h, dnorm), 0.0)
        wn = jnp.where(valid, K.near_density_kernel(dist, h, nnorm), 0.0)
        return acc[0] + w, acc[1] + wn

    def finish(i_idx, i_mask, i_vals, acc):
        plgpu.store(rho_ref.at[i_idx], acc[0], mask=i_mask)
        plgpu.store(rhon_ref.at[i_idx], acc[1], mask=i_mask)

    _walk(ranges_ref, init, row_body, finish)


def _force_kernel(ranges_ref, scal_ref, x_ref, y_ref, vx_ref, vy_ref, a_ref, b_ref,
                  c_ref, fx_ref, fy_ref, fvx_ref, fvy_ref):
    h, dnorm, nnorm, vnorm = scal_ref[0], scal_ref[1], scal_ref[2], scal_ref[3]

    def init(i_idx, i_mask):
        vals = tuple(
            plgpu.load(r.at[i_idx], mask=i_mask, other=0.0)
            for r in (x_ref, y_ref, vx_ref, vy_ref, a_ref, b_ref)
        )
        zero = jnp.zeros((BLOCK_I, BLOCK_J), jnp.float32)
        return (i_idx,) + vals, (zero, zero, zero, zero)

    def row_body(i_vals, j_idx, j_mask, acc):
        i_idx, xi, yi, vxi, vyi, ai, bi = i_vals
        xj, yj, vxj, vyj, aj, cj = (
            plgpu.load(r.at[j_idx], mask=j_mask, other=0.0)
            for r in (x_ref, y_ref, vx_ref, vy_ref, a_ref, c_ref)
        )
        dx, dy, dist, near = _pair_geometry(xi, yi, xj, yj, h)
        valid = near & j_mask[None, :] & (i_idx[:, None] != j_idx[None, :])
        far = dist > _EPS_DIST
        inv = jnp.where(far, 1.0 / jnp.where(far, dist, 1.0), 0.0)
        ux = jnp.where(far, dx * inv, 0.0)
        uy = jnp.where(far, dy * inv, 1.0)
        # p_i/ρ_i² + p_j/ρ_j² and np_i/ρ_i² + np_j/(ρ_j·ρnear_j), per particle.
        dw = K.density_kernel_derivative(dist, h, dnorm)
        dwn = K.near_density_kernel_derivative(dist, h, nnorm)
        mag = jnp.where(
            valid, (ai[:, None] + aj[None, :]) * dw + (bi[:, None] + cj[None, :]) * dwn,
            0.0,
        )
        wv = jnp.where(valid, K.viscosity_kernel(dist, h, vnorm), 0.0)
        return (
            acc[0] + ux * mag,
            acc[1] + uy * mag,
            acc[2] + (vxj[None, :] - vxi[:, None]) * wv,
            acc[3] + (vyj[None, :] - vyi[:, None]) * wv,
        )

    def finish(i_idx, i_mask, i_vals, acc):
        for ref, v in zip((fx_ref, fy_ref, fvx_ref, fvy_ref), acc):
            plgpu.store(ref.at[i_idx], v, mask=i_mask)

    _walk(ranges_ref, init, row_body, finish)


def _launch(kernel, name, ranges, scalars, arrays, n_out, interpret):
    n = arrays[0].shape[0]
    out = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * n_out,
        grid=(ranges.shape[0],),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )(ranges, scalars, *arrays)
    return tuple(out)


def density_walk(x, y, ranges, params: SimParams, interpret: bool = False):
    """(ρ, ρ_near) for every sorted particle that some program of ``ranges`` owns.

    Rows no program owns are left unwritten (undefined)."""
    scal = jnp.stack([params.smoothing_radius, params.density_kernel_norm,
                      params.near_density_kernel_norm]).astype(jnp.float32)
    return _launch(_density_kernel, "sph_density_walk", ranges, scal, (x, y), 2,
                   interpret)


def pressure_terms(rho, rhon, params: SimParams):
    """Per-particle (a, b, c) so that the pair's pressure factor is a_i + a_j and
    its near factor b_i + c_j (compute_shader.wgsl:318-327, quirk kept)."""
    p = K.density_to_pressure(rho, params.target_density, params.pressure_multiplier)
    pn = K.density_to_near_pressure(rhon, params.near_density_multiplier)
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    rhon_safe = jnp.where(rhon > 0, rhon, 1.0)
    return (p / (rho_safe * rho_safe), pn / (rho_safe * rho_safe),
            pn / (rho_safe * rhon_safe))


def force_walk(x, y, vx, vy, a, b, c, ranges, params: SimParams,
               interpret: bool = False):
    """(fx, fy, fvx, fvy): pressure force and Σ(v_j − v_i)·W_visc per owned row."""
    scal = jnp.stack([params.smoothing_radius, params.density_kernel_norm,
                      params.near_density_kernel_norm,
                      params.viscosity_kernel_norm]).astype(jnp.float32)
    return _launch(_force_kernel, "sph_force_walk", ranges, scal,
                   (x, y, vx, vy, a, b, c), 4, interpret)


def walk_sums(pred_s, vel_s, ranges, params: SimParams,
              interpret: bool = False) -> SPHQuantities:
    """Both walks over sorted predicted positions and (pre-pressure) velocities."""
    x, y = pred_s[:, 0], pred_s[:, 1]
    rho, rhon = density_walk(x, y, ranges, params, interpret)
    a, b, c = pressure_terms(rho, rhon, params)
    fx, fy, fvx, fvy = force_walk(x, y, vel_s[:, 0], vel_s[:, 1], a, b, c, ranges,
                                  params, interpret)
    return SPHQuantities(rho, rhon, jnp.stack([fx, fy], -1), jnp.stack([fvx, fvy], -1))


def walk_quantities(pred, vel, params: SimParams, spec: GridSpec,
                    interpret: bool = False):
    """(perm, sorted-order SPHQuantities) for predicted positions ``pred``."""
    grid = build_grid(spec, pred, with_table=False)
    tx = tile_width(pred.shape[0], spec.num_cells)
    ranges = tile_ranges(grid.starts, spec.gw, spec.gh, tx)
    q = walk_sums(pred[grid.perm], vel[grid.perm], ranges, params, interpret)
    return grid.perm, q


def walk_physics(state: ParticleState, params: SimParams, spec: GridSpec,
                 interpret: bool = False) -> ParticleState:
    """One bulk-synchronous frame (spec v2) through the two walks."""
    dt = params.dt
    vel = state.vel + jnp.array([0.0, -1.0], jnp.float32) * params.gravity * dt
    pred = state.pos + vel * dt
    perm, q = walk_quantities(pred, vel, params, spec, interpret)
    dv_s = q.fp * dt + q.fv * (params.viscosity_strength * dt)
    vel = vel + jnp.zeros_like(vel).at[perm].set(dv_s, unique_indices=True)
    pos = state.pos + vel * dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame)


@functools.partial(jax.jit, static_argnames=("spec", "interpret"))
def walk_step(state: ParticleState, params: SimParams, spec: GridSpec,
              interpret: bool = False) -> ParticleState:
    """One frame (warm-up honouring) through the run walk.  Lossless: no capacity."""
    stepped = lax.cond(
        state.frame >= params.shader_delay,
        lambda s: walk_physics(s, params, spec, interpret),
        lambda s: s,
        state,
    )
    return stepped._replace(frame=state.frame + 1)
