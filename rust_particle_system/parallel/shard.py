"""Band-sharded particle state: the multi-device layout the reference never had.

The domain is cut into ``n_bands`` horizontal bands of grid-cell rows, one band per
device (SURVEY.md §2.3 / §7: the long-context analog — shard the "sequence" of
particles by spatial band, exchange one-cell-deep ghost rows with ring neighbors).
Each device owns a fixed number of particle **slots** (``cap``); a boolean validity
mask says which slots hold live particles.  Slots make every shape static: migration
between bands and the ghost exchange both move fixed-capacity buffers with validity
channels, so the whole step jits and scans.

Global sharded arrays have leading axis ``n_bands * cap`` and are sharded along it with
``P("bands")``; inside ``shard_map`` each device sees its own ``[cap, ...]`` slab.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.state import ParticleState
from ..ops.grid import GridSpec
from ..ops.pallas.sph_walk import tile_width


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static multi-device geometry (hashable)."""

    grid: GridSpec  # full-domain grid; gh == n_bands * rows_per_band
    n_bands: int
    rows_per_band: int
    cap: int  # particle slots per band
    mig_cap: int  # migration buffer slots per direction per step
    ghost_cap: int  # boundary-row ghost buffer slots per direction per step
    tile_cells: int  # run-walk cells per program (from the mean occupancy)
    # Migration exchange rounds per frame.  Each round moves a particle at most one
    # band toward its home; K rounds handle crossings of up to K bands/frame.  Pick
    # via :func:`migration_rounds_for_speed` — after the rounds, any particle still
    # outside its home band counts in the ``band_violations`` diagnostic (check it
    # with :func:`rust_particle_system.parallel.check_diags`).
    mig_rounds: int = 1

    @property
    def local_cells(self) -> int:
        return self.rows_per_band * self.grid.gw

    @property
    def total_slots(self) -> int:
        return self.n_bands * self.cap

    @property
    def band_height(self) -> float:
        return self.rows_per_band * self.grid.cell_size


def migration_rounds_for_speed(band_height: float, max_speed: float, dt: float) -> int:
    """Exchange rounds needed so particles at ``max_speed`` never out-run migration.

    The CFL-style bound: a particle crosses at most ``ceil(max_speed*dt /
    band_height)`` bands per frame; that many ±1-band rounds provably reach the home
    band, making ``band_violations > 0`` impossible below ``max_speed``."""
    return max(1, int(math.ceil((max_speed * dt) / band_height)))


def make_shard_spec(
    bounds,
    cell_size: float,
    n: int,
    n_bands: int,
    slack: float = 2.0,
    mig_frac: float = 0.25,
    max_speed: float | None = None,
    dt: float = 0.01,
    mig_rounds: int | None = None,
    ghost_cap: int | None = None,
) -> ShardSpec:
    """Build a ShardSpec; pads the grid height so bands divide it evenly.

    Pass ``max_speed`` (expected top particle speed) to size the per-frame
    migration exchange rounds so fast particles can never out-run their band
    (the CFL-style guard); or set ``mig_rounds`` explicitly.  ``ghost_cap``
    defaults to ``2 * slack`` times a cell row's mean particle count."""
    base = GridSpec.from_bounds(bounds, cell_size)
    rows_per_band = max(1, math.ceil(base.gh / n_bands))
    gh = rows_per_band * n_bands
    grid = dataclasses.replace(base, gh=gh)
    cap = int(math.ceil(n / n_bands * slack))
    cap = (cap + 7) // 8 * 8
    mig_cap = max(64, int(cap * mig_frac))
    if ghost_cap is None:
        ghost_cap = max(64, int(math.ceil(2.0 * slack * n / base.gh)))
        ghost_cap = (ghost_cap + 7) // 8 * 8
    if mig_rounds is None:
        band_height = rows_per_band * float(cell_size)
        mig_rounds = (
            migration_rounds_for_speed(band_height, max_speed, dt)
            if max_speed is not None
            else 1
        )
    return ShardSpec(
        grid=grid, n_bands=n_bands, rows_per_band=rows_per_band, cap=cap,
        mig_cap=mig_cap, ghost_cap=int(ghost_cap),
        tile_cells=tile_width(n, base.num_cells), mig_rounds=int(mig_rounds),
    )


class ShardedState(NamedTuple):
    """Slot-based particle state; leading axis = n_bands * cap, shard with P('bands')."""

    pos: jnp.ndarray  # [S, 2]
    vel: jnp.ndarray  # [S, 2]
    color: jnp.ndarray  # [S, 4]
    valid: jnp.ndarray  # [S] bool
    frame: jnp.ndarray  # [] int32 (replicated)


def band_of_positions(spec: ShardSpec, pos) -> jnp.ndarray:
    """Which band owns each position (by grid cell row)."""
    cy = jnp.clip(
        jnp.floor((pos[..., 1] - spec.grid.y_min) / spec.grid.cell_size).astype(jnp.int32),
        0,
        spec.grid.gh - 1,
    )
    return cy // spec.rows_per_band


def shard_state(state: ParticleState, spec: ShardSpec) -> tuple[ShardedState, int]:
    """Host-side packing of a dense ParticleState into band slots.

    Returns (sharded_state, dropped) where dropped counts particles beyond a band's
    slot capacity (raise ``cap``/``slack`` if nonzero).
    """
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    color = np.asarray(state.color)
    band = np.asarray(band_of_positions(spec, jnp.asarray(pos)))

    S = spec.total_slots
    out_pos = np.zeros((S, 2), np.float32)
    out_vel = np.zeros((S, 2), np.float32)
    out_color = np.zeros((S, 4), np.float32)
    out_valid = np.zeros((S,), bool)
    dropped = 0
    for b in range(spec.n_bands):
        idx = np.nonzero(band == b)[0]
        take = idx[: spec.cap]
        dropped += len(idx) - len(take)
        lo = b * spec.cap
        out_pos[lo : lo + len(take)] = pos[take]
        out_vel[lo : lo + len(take)] = vel[take]
        out_color[lo : lo + len(take)] = color[take]
        out_valid[lo : lo + len(take)] = True
    return (
        ShardedState(
            pos=jnp.asarray(out_pos),
            vel=jnp.asarray(out_vel),
            color=jnp.asarray(out_color),
            valid=jnp.asarray(out_valid),
            frame=state.frame,
        ),
        dropped,
    )


def unshard_state(sstate: ShardedState) -> ParticleState:
    """Host-side gather of live particles (order: band-major, slot order)."""
    valid = np.asarray(sstate.valid)
    return ParticleState(
        pos=jnp.asarray(np.asarray(sstate.pos)[valid]),
        vel=jnp.asarray(np.asarray(sstate.vel)[valid]),
        color=jnp.asarray(np.asarray(sstate.color)[valid]),
        frame=sstate.frame,
    )


def state_sharding(mesh: jax.sharding.Mesh, axis: str = "bands"):
    """NamedShardings for a ShardedState on the given 1-D mesh."""
    P = jax.sharding.PartitionSpec
    shard = jax.sharding.NamedSharding(mesh, P(axis))
    rep = jax.sharding.NamedSharding(mesh, P())
    return ShardedState(pos=shard, vel=shard, color=shard, valid=shard, frame=rep)
