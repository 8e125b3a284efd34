"""Grid-accelerated SPH step in pure JAX — ~O(n·k), parity-tested against the oracle.

Replaces the reference's per-particle sorted-run walks (three of them per frame:
density `compute_shader.wgsl:207-254`, pressure `:256-334`, viscosity `:336-384`) with
**cell-dense pairwise blocks**: after sorting into cell order, every cell's <=C particles
interact with the <=9C particles of its 3x3 neighborhood as one statically-shaped
``[C, 9C]`` pairwise tile.  This is the plain XLA path: the CPU path, and the parity
anchor of the run walk (``ops/pallas/sph_walk.py``), which computes the same sums.

Spec deviations from the reference (both deliberate, see SURVEY.md §3.5):

* the grid is built from **predicted** positions (the reference bins by pre-update
  positions but then queries by predicted-position cell — an inconsistency the
  bulk-synchronous spec removes; the oracle in ``reference_step.py`` uses true
  predicted-position distances, which this matches exactly);
* dense cell keys instead of ``hash % n`` (no collision aliasing).

Per-cell capacity is static; particles beyond it are counted in ``Grid.overflow`` and
exert/receive no pair forces that frame (choose capacity so overflow stays 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import kernels as K
from ..core.params import SimParams
from ..core.state import ParticleState
from .grid import GridSpec, SPHQuantities, build_grid, gather_to_cells

_EPS_DIST = 1e-4  # direction guard (compute_shader.wgsl:305)


class CellChunk(NamedTuple):
    """Per-cell-chunk gathered data fed to the pairwise passes."""

    own_pos: jnp.ndarray  # [B, C, 2]
    own_idx: jnp.ndarray  # [B, C] sorted index, -1 = empty
    nbr_pos: jnp.ndarray  # [B, 9C, 2]
    nbr_idx: jnp.ndarray  # [B, 9C] sorted index, -1 = empty


def pair_geometry(chunk: CellChunk, h):
    """Shared pairwise masks/distances for a chunk: [B, C, 9C].

    Double-where'd sqrt keeps the step differentiable (sqrt'(0) = inf otherwise)."""
    delta = chunk.nbr_pos[:, None, :, :] - chunk.own_pos[:, :, None, :]  # x_j - x_i
    sq = jnp.sum(delta * delta, axis=-1)
    positive = sq > 0
    dist = jnp.where(positive, jnp.sqrt(jnp.where(positive, sq, 1.0)), 0.0)
    valid = (
        (chunk.own_idx[:, :, None] >= 0)
        & (chunk.nbr_idx[:, None, :] >= 0)
        & (sq <= h * h)
    )
    return delta, dist, valid


def density_pass(chunk: CellChunk, params: SimParams):
    h = params.smoothing_radius
    _, dist, valid = pair_geometry(chunk, h)
    w = jnp.where(valid, K.density_kernel(dist, h, params.density_kernel_norm), 0.0)
    wn = jnp.where(
        valid, K.near_density_kernel(dist, h, params.near_density_kernel_norm), 0.0
    )
    return jnp.sum(w, axis=-1), jnp.sum(wn, axis=-1)  # [B, C] each


def pressure_pass(chunk: CellChunk, own_rho, own_rhon, nbr_rho, nbr_rhon, params):
    """[B, C, 2] pressure + near-pressure force; self excluded by sorted index."""
    h = params.smoothing_radius
    delta, dist, valid = pair_geometry(chunk, h)
    valid &= chunk.own_idx[:, :, None] != chunk.nbr_idx[:, None, :]

    safe_dist = jnp.where(dist > _EPS_DIST, dist, 1.0)
    direction = jnp.where(
        (dist > _EPS_DIST)[..., None],
        delta / safe_dist[..., None],
        jnp.array([0.0, 1.0], jnp.float32),
    )

    p_i = K.density_to_pressure(own_rho, params.target_density, params.pressure_multiplier)
    p_j = K.density_to_pressure(nbr_rho, params.target_density, params.pressure_multiplier)
    np_i = K.density_to_near_pressure(own_rhon, params.near_density_multiplier)
    np_j = K.density_to_near_pressure(nbr_rhon, params.near_density_multiplier)

    # Guard padded slots (rho = 0) before dividing; 'valid' masks them out after.
    rho_i = jnp.where(own_rho > 0, own_rho, 1.0)[:, :, None]
    rho_j = jnp.where(nbr_rho > 0, nbr_rho, 1.0)[:, None, :]
    rhon_j = jnp.where(nbr_rhon > 0, nbr_rhon, 1.0)[:, None, :]

    pressure_term = p_i[:, :, None] / (rho_i * rho_i) + p_j[:, None, :] / (rho_j * rho_j)
    # Reference quirk kept: ρ_j·ρnear_j denominator (compute_shader.wgsl:326-327).
    near_term = np_i[:, :, None] / (rho_i * rho_i) + np_j[:, None, :] / (rho_j * rhon_j)

    dw = K.density_kernel_derivative(dist, h, params.density_kernel_norm)
    dwn = K.near_density_kernel_derivative(dist, h, params.near_density_kernel_norm)

    contrib = direction * (pressure_term * dw + near_term * dwn)[..., None]
    return jnp.sum(jnp.where(valid[..., None], contrib, 0.0), axis=2)


def viscosity_pass(chunk: CellChunk, own_vel, nbr_vel, params):
    """[B, C, 2] viscosity force Σ (v_j − v_i)·W_visc."""
    h = params.smoothing_radius
    _, dist, valid = pair_geometry(chunk, h)
    valid &= chunk.own_idx[:, :, None] != chunk.nbr_idx[:, None, :]
    w = jnp.where(valid, K.viscosity_kernel(dist, h, params.viscosity_kernel_norm), 0.0)
    dv = nbr_vel[:, None, :, :] - own_vel[:, :, None, :]
    return jnp.sum(dv * w[..., None], axis=2)


def _chunked_cells(arrs, num_cells: int, chunk: int):
    """Pad leading cell axis to a multiple of `chunk` and reshape to [k, chunk, ...]."""
    pad = (-num_cells) % chunk
    out = []
    for a, fill in arrs:
        a = a[:num_cells]
        if pad:
            padding = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
            a = jnp.concatenate([a, padding], axis=0)
        out.append(a.reshape((num_cells + pad) // chunk, chunk, *a.shape[1:]))
    return out


def grid_quantities(pred, vel, params: SimParams, spec: GridSpec,
                    chunk_cells: int = 256):
    """(grid, sorted-order SPHQuantities) from predicted positions and velocities."""
    grid = build_grid(spec, pred)
    nc, C = spec.num_cells, spec.capacity

    pred_s = pred[grid.perm]
    vel_s = vel[grid.perm]

    # Cell-dense layout (+1 padding row for out-of-grid neighbor lookups).
    cpos = gather_to_cells(grid, spec, pred_s)  # [nc+1, C, 2]
    nids = spec.neighbor_cell_ids()  # [nc, 9]
    nbr_idx = grid.table[nids].reshape(nc, 9 * C)  # [nc, 9C]
    nbr_pos = cpos[nids].reshape(nc, 9 * C, 2)
    own_idx = grid.table[:nc]
    own_pos = cpos[:nc]

    def run_pass(fn, extras):
        """Map a pairwise pass over cell chunks. extras: list of (array, fill)."""
        chunks = _chunked_cells(
            [(own_pos, 0.0), (own_idx, -1), (nbr_pos, 0.0), (nbr_idx, -1)]
            + list(extras),
            nc,
            chunk_cells,
        )

        def body(args):
            chunk = CellChunk(*args[:4])
            return fn(chunk, *args[4:])

        out = jax.lax.map(body, tuple(chunks))
        return jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:])[:nc], out)

    # Pass 1: density.
    rho, rhon = run_pass(lambda c: density_pass(c, params), [])

    # Gather per-cell densities into neighbor layout for the pressure pass.
    rho_pad = jnp.concatenate([rho, jnp.zeros((1, C), rho.dtype)])
    rhon_pad = jnp.concatenate([rhon, jnp.zeros((1, C), rhon.dtype)])
    nbr_rho = rho_pad[nids].reshape(nc, 9 * C)
    nbr_rhon = rhon_pad[nids].reshape(nc, 9 * C)

    # Pass 2: pressure force (and the viscosity inputs share the same chunking).
    f_p = run_pass(
        lambda c, orho, orhon, nrho, nrhon: pressure_pass(
            c, orho, orhon, nrho, nrhon, params
        ),
        [(rho, 0.0), (rhon, 0.0), (nbr_rho, 0.0), (nbr_rhon, 0.0)],
    )

    # Per-cell values back to sorted particle order (overflow rows read 0).
    def cells_to_sorted(cell_vals):
        in_table = grid.slot < C
        slot = jnp.minimum(grid.slot, C - 1)
        vals = cell_vals[grid.sorted_keys, slot]
        return jnp.where(in_table[(...,) + (None,) * (vals.ndim - 1)], vals, 0.0)

    # Pass 3: viscosity over PRE-pressure velocities (spec v2 — one barrier applies
    # pressure + viscosity together; see ops/reference_step.py docstring).
    cvel = gather_to_cells(grid, spec, vel_s)
    nbr_vel = cvel[nids].reshape(nc, 9 * C, 2)
    f_v = run_pass(
        lambda c, ovel, nvel: viscosity_pass(c, ovel, nvel, params),
        [(cvel[:nc], 0.0), (nbr_vel, 0.0)],
    )
    q = SPHQuantities(cells_to_sorted(rho), cells_to_sorted(rhon),
                      cells_to_sorted(f_p), cells_to_sorted(f_v))
    return grid, q


def grid_physics(state: ParticleState, params: SimParams, spec: GridSpec,
                 chunk_cells: int = 256):
    """One physics frame via the spatial grid.  Returns (new_state, overflow)."""
    dt = params.dt
    vel = state.vel + jnp.array([0.0, -1.0], jnp.float32) * params.gravity * dt
    pred = state.pos + vel * dt

    grid, q = grid_quantities(pred, vel, params, spec, chunk_cells)
    vel_s = vel[grid.perm] + q.fp * dt + q.fv * params.viscosity_strength * dt

    # Un-sort back to original particle order via the inverse permutation, then
    # integrate, bounce, colour.
    new_vel = vel_s[jnp.argsort(grid.perm)]
    pos = state.pos + new_vel * dt
    pos, new_vel = K.bounce_bounds(pos, new_vel, params.bounds, params.damping_factor)
    color = K.energy_color(new_vel, params.max_energy)
    new_state = ParticleState(pos=pos, vel=new_vel, color=color, frame=state.frame)
    return new_state, grid.overflow


@functools.partial(jax.jit, static_argnames=("spec", "chunk_cells"))
def grid_step(state: ParticleState, params: SimParams, spec: GridSpec,
              chunk_cells: int = 256) -> ParticleState:
    """One frame (warm-up honoring), grid-accelerated.  Drop-in for reference_step."""
    stepped = jax.lax.cond(
        state.frame >= params.shader_delay,
        lambda s: grid_physics(s, params, spec, chunk_cells)[0],
        lambda s: s,
        state,
    )
    return stepped._replace(frame=state.frame + 1)
