"""Debug validators & inspectors — the live version of the reference's disabled tools.

The reference ships a debug node (`src/debug.rs`) that is compiled out
(``DEBUG=false``, body commented); its helpers do blocking GPU→CPU readbacks to print
and "validate" the spatial lookup table, offsets, and densities
(`debug.rs:121-287`).  In JAX, pulling any intermediate to the host is free of
ceremony, so these are real, always-available functions — and they raise on violation
instead of printing.

Use them in tests, notebooks, or sprinkled into driver loops when debugging.
"""

from __future__ import annotations

import numpy as np

from ..core.params import SimParams
from ..core.state import ParticleState
from ..ops.grid import Grid, GridSpec, build_grid


def _require(cond: bool, message: str) -> None:
    """Raise ValueError on violation.

    Explicit raise (not ``assert``): these validators back the documented always-on
    guarantees of Simulation.stats()/CLI --stats, which must survive ``python -O``.
    """
    if not cond:
        raise ValueError(message)


def validate_grid(grid: Grid, spec: GridSpec, n: int) -> dict:
    """Check the neighbor structure's invariants (debug.rs:166-175 made strict).

    Returns occupancy stats.  Raises ValueError on violation.
    """
    sorted_keys = np.asarray(grid.sorted_keys)
    perm = np.asarray(grid.perm)
    starts = np.asarray(grid.starts)
    table = np.asarray(grid.table)

    _require(bool(np.all(np.diff(sorted_keys) >= 0)), "spatial lookup not sorted")
    _require(np.array_equal(np.sort(perm), np.arange(n)), "perm is not a permutation")
    _require(bool(np.all(starts[:-1] <= starts[1:])), "run starts not monotone")
    counts = np.diff(starts)  # true run lengths, capacity or not
    _require(int(counts.sum()) == int((sorted_keys < spec.num_cells).sum()),
             "run starts do not cover the sorted keys")
    overflow = int(np.asarray(grid.overflow))
    if table.shape[0]:
        _require(bool(np.all(table[-1] == -1)), "padding row not empty")
        live = table >= 0
        # front-packed: within every row, no live slot may follow an empty one
        _require(bool(np.all(live[:, 1:] <= live[:, :-1])),
                 "slots not packed front-first")
    return {
        "cells_used": int((counts > 0).sum()),
        "max_occupancy": int(counts.max()) if counts.size else 0,
        "mean_occupancy": float(counts[counts > 0].mean()) if (counts > 0).any() else 0.0,
        "overflow": overflow,
    }


def validate_state(state: ParticleState, params: SimParams) -> dict:
    """Invariant check on a state: finite, inside bounds.  Raises ValueError."""
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    b = np.asarray(params.bounds)
    _require(bool(np.all(np.isfinite(pos))), "non-finite positions")
    _require(bool(np.all(np.isfinite(vel))), "non-finite velocities")
    _require(
        bool(pos[:, 0].min() >= b[0] - 1e-4 and pos[:, 0].max() <= b[1] + 1e-4),
        "positions outside x bounds",
    )
    _require(
        bool(pos[:, 1].min() >= b[2] - 1e-4 and pos[:, 1].max() <= b[3] + 1e-4),
        "positions outside y bounds",
    )
    speed = np.linalg.norm(vel, axis=1)
    return {
        "n": pos.shape[0],
        "frame": int(state.frame),
        "speed_mean": float(speed.mean()),
        "speed_max": float(speed.max()),
        "kinetic_energy_mean": float(0.5 * (speed**2).mean()),
    }


def density_report(state: ParticleState, params: SimParams, spec: GridSpec) -> dict:
    """Density statistics over the current state (debug.rs:267-287 analog)."""
    from ..ops.grid_step import grid_physics  # local import to avoid cycles
    import jax

    _, overflow = jax.jit(
        lambda s, p: grid_physics(s, p, spec), static_argnums=()
    )(state, params)
    grid = build_grid(spec, state.pos)
    stats = validate_grid(grid, spec, state.n)
    stats["step_overflow"] = int(overflow)
    return stats


def print_config(params: SimParams) -> str:
    """Human-readable parameter dump (debug.rs:96-119 analog).  Returns the text."""
    lines = ["SimParams:"]
    for name in params._fields:
        val = np.asarray(getattr(params, name))
        lines.append(f"  {name:26s} = {np.array2string(val, precision=6)}")
    text = "\n".join(lines)
    print(text)
    return text
