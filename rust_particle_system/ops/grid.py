"""Spatial uniform grid — the reference's neighbour structure with dense keys.

The reference builds its neighbor structure per frame in three GPU dispatches
(`src/particle_compute.rs:106-163`):

1. ``bin_particles_in_grid``: cell coord = floor((pos + max_bound)/h), key =
   ``(cx*15823 + cy*9737333) % n`` (compute_shader.wgsl:121-142,455-468);
2. a 136-step bitonic merge sort of (key, index) pairs (compute_shader.wgsl:470-505);
3. sorted-run head detection into an offsets table (compute_shader.wgsl:507-525).

Here:

* **Dense keys, no hashing.** The domain is bounded, so ``key = cy*gw + cx`` is exact —
  no ``hash % n`` collisions aliasing far-apart cells into one neighbor run
  (SURVEY.md §3.5.2), and the three cells of a neighbour row are one contiguous run.
* **XLA's sort** (one stable ``lax.sort``) instead of a hand-scheduled bitonic
  network; run starts via ``searchsorted`` instead of a head-detection scatter.
* **Optional capped-occupancy cell table** for the XLA grid step
  (``ops/grid_step.py``): each cell holds at most ``capacity`` particles in a dense
  ``[num_cells, capacity]`` slot table (overflow is counted and surfaced — extra
  particles exert/receive no grid forces that step).  The run walk
  (``ops/pallas/sph_walk.py``) reads only the sorted runs and needs no capacity
  (``capacity=0``).

The grid's cell size is a **static** build parameter.  Correctness of the 9-cell
neighborhood requires ``smoothing_radius <= cell_size``; the reference ties the two
(`src/main.rs:88`), and the host does the same here at build time, so lowering the
radius "slider" afterwards is free while raising it requires a rebuild (recompile).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

# 3x3 neighborhood, matching GRID_OFFSETS (compute_shader.wgsl:201-205).
NEIGHBOR_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static (hashable) grid geometry — safe to close over in jitted functions."""

    x_min: float
    y_min: float
    cell_size: float  # cell width and height
    gw: int  # grid width in cells
    gh: int  # grid height in cells
    capacity: int = 0  # max particles per cell in the slot table; 0 = no table

    @classmethod
    def from_bounds(cls, bounds, cell_size: float, capacity: int = 0) -> "GridSpec":
        x_min, x_max, y_min, y_max = [float(b) for b in bounds]
        gw = int(math.floor((x_max - x_min) / cell_size)) + 1
        gh = int(math.floor((y_max - y_min) / cell_size)) + 1
        return cls(x_min=x_min, y_min=y_min, cell_size=float(cell_size), gw=gw,
                   gh=gh, capacity=int(capacity))

    @property
    def num_cells(self) -> int:
        return self.gw * self.gh

    def cell_coords(self, pos):
        """Integer cell coords, clipped into the grid.

        Equivalent to the reference's ``floor((pos + max_bound)/h)``
        (compute_shader.wgsl:121-130) for its symmetric bounds, but anchored at the
        min corner so asymmetric domains work too.
        """
        cx = jnp.floor((pos[..., 0] - self.x_min) / self.cell_size).astype(jnp.int32)
        cy = jnp.floor((pos[..., 1] - self.y_min) / self.cell_size).astype(jnp.int32)
        return jnp.clip(cx, 0, self.gw - 1), jnp.clip(cy, 0, self.gh - 1)

    def cell_keys(self, pos):
        cx, cy = self.cell_coords(pos)
        return cy * self.gw + cx

    def neighbor_cell_ids(self):
        """[num_cells, 9] neighbor cell ids; out-of-grid neighbors map to num_cells
        (a padding row in the slot table)."""
        cid = jnp.arange(self.num_cells, dtype=jnp.int32)
        cx = cid % self.gw
        cy = cid // self.gw
        ids = []
        for dx, dy in NEIGHBOR_OFFSETS:
            nx, ny = cx + dx, cy + dy
            valid = (nx >= 0) & (nx < self.gw) & (ny >= 0) & (ny < self.gh)
            ids.append(jnp.where(valid, ny * self.gw + nx, self.num_cells))
        return jnp.stack(ids, axis=1)


class Grid(NamedTuple):
    """Per-frame neighbor structure over a sorted particle layout.

    ``perm`` maps sorted slot -> original particle index; particle arrays indexed by
    ``perm`` become contiguous per cell (the analog of the reference's sorted
    ``spatial_lookup`` runs).  ``table[c, s]`` is the *sorted-order* index of the s-th
    particle in cell c, or -1 for an empty slot.  ``table`` has an extra all-empty
    padding row at index num_cells for out-of-grid neighbor lookups.
    """

    perm: jnp.ndarray  # [n] int32, sorted -> original
    sorted_keys: jnp.ndarray  # [n] int32
    starts: jnp.ndarray  # [num_cells + 1] int32 run starts (ends via next entry)
    table: jnp.ndarray  # [num_cells + 1, capacity] int32, -1 = empty
    slot: jnp.ndarray  # [n] int32, slot of each sorted particle within its cell
    overflow: jnp.ndarray  # [] int32, particles beyond capacity this frame


class SPHQuantities(NamedTuple):
    """Per-particle sums of one physics frame (the parity surface of every path)."""

    rho: jnp.ndarray  # [n]
    rhon: jnp.ndarray  # [n]
    fp: jnp.ndarray  # [n, 2] pressure + near-pressure force
    fv: jnp.ndarray  # [n, 2] Σ (v_j − v_i)·W_visc (before viscosity_strength)

    def unsorted(self, perm) -> "SPHQuantities":
        """Sorted-order sums back to original particle order (``perm``: sorted ->
        original)."""
        return jax.tree.map(
            lambda v: jnp.zeros_like(v).at[perm].set(v, unique_indices=True), self)


def sorted_runs(keys, num_keys: int):
    """(perm, sorted_keys, starts) for integer keys in ``[0, num_keys]``.

    One stable sort yields both the sorted keys and the permutation (sorted ->
    original); ``starts[k]`` is the first sorted index with key >= k, for
    ``k = 0 .. num_keys`` (so ``starts[k+1] - starts[k]`` counts key k)."""
    n = keys.shape[0]
    sorted_keys, perm = jax.lax.sort(
        (keys, jnp.arange(n, dtype=jnp.int32)), num_keys=1, is_stable=True
    )
    ids = jnp.arange(num_keys + 1, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_keys, ids, side="left").astype(jnp.int32)
    return perm, sorted_keys, starts


def build_grid(spec: GridSpec, pos, with_table: bool = True) -> Grid:
    """Bin + sort + offsets, fused: dispatch passes 1-3 of the reference.

    The slot table is derived *arithmetically* from the sorted run starts —
    ``table[c, s] = starts[c] + s`` while inside the run — with no scatter.
    ``with_table=False`` (or ``spec.capacity == 0``) skips it and sets a zero-size
    placeholder: the run walk reads only ``perm``, ``sorted_keys`` and ``starts``.
    """
    n = pos.shape[0]
    # +1: row num_cells is the always-empty padding row (start == end == n there).
    perm, sorted_keys, starts_full = sorted_runs(spec.cell_keys(pos), spec.num_cells + 1)
    starts = starts_full[: spec.num_cells + 1]

    # Slot within the cell run, via a run-start cummax over the sorted keys.
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    slot = iota - run_start
    counts = starts_full[1:] - starts_full[:-1]  # [num_cells + 1]
    if spec.capacity > 0:
        overflow = jnp.sum(jnp.maximum(counts - spec.capacity, 0)).astype(jnp.int32)
    else:
        overflow = jnp.zeros((), jnp.int32)

    if with_table and spec.capacity > 0:
        sidx = jax.lax.broadcasted_iota(
            jnp.int32, (spec.num_cells + 1, spec.capacity), 1
        )
        rows = starts_full[:-1, None] + sidx
        table = jnp.where(sidx < counts[:, None], rows, -1)
    else:
        table = jnp.zeros((0, spec.capacity), jnp.int32)

    return Grid(
        perm=perm,
        sorted_keys=sorted_keys,
        starts=starts,
        table=table,
        slot=slot,
        overflow=overflow,
    )


def gather_to_cells(grid: Grid, spec: GridSpec, sorted_values):
    """[n, k] sorted-order values -> [num_cells + 1, capacity, k] cell-dense values.

    Empty slots are zero-filled; use ``grid.table >= 0`` as the validity mask.
    """
    # Map empty (-1) to the padded row n so the gather stays in bounds.
    n = sorted_values.shape[0]
    padded = jnp.concatenate(
        [sorted_values, jnp.zeros((1,) + sorted_values.shape[1:], sorted_values.dtype)]
    )
    idx = jnp.where(grid.table >= 0, grid.table, n)
    return padded[idx]


def suggest_capacity(n: int, spec_or_bounds, cell_size: float | None = None, safety: float = 4.0) -> int:
    """Heuristic per-cell capacity: safety x the uniform average occupancy, >= 8.

    The reference tolerates arbitrary occupancy via variable-length sorted runs (as
    does the run walk); the XLA grid step's slot table must pick a static cap.  Callers with clustered initial conditions (the
    Gaussian scatter) should pass a larger safety factor or measure
    ``Grid.overflow`` and rebuild.
    """
    if cell_size is None:
        spec = spec_or_bounds
        num_cells = spec.num_cells
    else:
        x_min, x_max, y_min, y_max = [float(b) for b in spec_or_bounds]
        gw = int(math.floor((x_max - x_min) / cell_size)) + 1
        gh = int(math.floor((y_max - y_min) / cell_size)) + 1
        num_cells = gw * gh
    avg = n / max(num_cells, 1)
    return max(8, int(math.ceil(avg * safety)))
