"""Tests for the spatial-grid structure and the grid step's parity with the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state
from rust_particle_system.ops.grid import GridSpec, build_grid, gather_to_cells, suggest_capacity
from rust_particle_system.ops.grid_step import grid_step, grid_physics
from rust_particle_system.ops.reference_step import reference_step

BOUNDS = (-100.0, 100.0, -50.0, 50.0)


def _random_state(rng, n, bounds=BOUNDS, vmax=30.0):
    x_min, x_max, y_min, y_max = bounds
    pos = np.stack(
        [rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)], axis=-1
    ).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def test_grid_spec_geometry():
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=8)
    assert spec.gw == 23 and spec.gh == 12
    assert spec.num_cells == 276
    # corner positions land in corner cells
    cx, cy = spec.cell_coords(jnp.asarray([[-100.0, -50.0], [100.0, 50.0]]))
    assert (int(cx[0]), int(cy[0])) == (0, 0)
    assert (int(cx[1]), int(cy[1])) == (22, 11)


def test_build_grid_sorted_runs_and_table(rng):
    n = 500
    pos, _ = _random_state(rng, n)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=16)
    grid = build_grid(spec, jnp.asarray(pos))

    keys = np.asarray(spec.cell_keys(jnp.asarray(pos)))
    sorted_keys = np.asarray(grid.sorted_keys)
    perm = np.asarray(grid.perm)
    # sortedness + permutation validity
    assert np.all(np.diff(sorted_keys) >= 0)
    assert np.array_equal(np.sort(perm), np.arange(n))
    assert np.array_equal(keys[perm], sorted_keys)

    # starts bracket each cell's run exactly
    starts = np.asarray(grid.starts)
    for c in [0, 5, int(sorted_keys[n // 2]), spec.num_cells - 1]:
        lo, hi = starts[c], starts[c + 1] if c + 1 < len(starts) else n
        assert np.all(sorted_keys[lo:hi] == c)

    # table holds exactly the particles of each cell, in slot order
    table = np.asarray(grid.table)
    assert table.shape == (spec.num_cells + 1, 16)
    assert np.all(table[-1] == -1)  # padding row empty
    counts = np.bincount(keys, minlength=spec.num_cells)
    for c in range(spec.num_cells):
        slots = table[c][table[c] >= 0]
        assert len(slots) == counts[c]
        assert np.all(sorted_keys[slots] == c)
    assert int(grid.overflow) == 0


def test_grid_overflow_counted():
    # 20 particles in one cell with capacity 4 -> 16 overflow
    pos = jnp.zeros((20, 2), jnp.float32)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=4)
    grid = build_grid(spec, pos)
    assert int(grid.overflow) == 16
    # table still well-formed: exactly 4 slots used
    table = np.asarray(grid.table)
    assert (table >= 0).sum() == 4


def test_gather_to_cells_roundtrip(rng):
    n = 200
    pos, vel = _random_state(rng, n)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=16)
    grid = build_grid(spec, jnp.asarray(pos))
    vel_s = jnp.asarray(vel)[grid.perm]
    cvel = np.asarray(gather_to_cells(grid, spec, vel_s))
    table = np.asarray(grid.table)
    got = cvel[table >= 0]
    want = np.asarray(vel_s)[table[table >= 0]]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [64, 300])
def test_grid_step_matches_reference_step(rng, n):
    """The make-or-break parity test: grid path == O(n²) oracle on random states."""
    pos, vel = _random_state(rng, n, vmax=20.0)
    params = make_params(bounds=BOUNDS, gravity=80.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=64)

    state = make_state(pos, vel)
    ref = jax.jit(reference_step)(state, params)
    got = grid_step(state, params, spec)

    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(ref.vel), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(got.color), np.asarray(ref.color), rtol=1e-3, atol=1e-3)
    assert int(got.frame) == int(ref.frame)


def test_grid_step_multi_frame_trajectory_parity(rng):
    n = 128
    pos, vel = _random_state(rng, n, vmax=10.0)
    params = make_params(bounds=BOUNDS, gravity=150.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=64)

    s_grid = make_state(pos, vel)
    s_ref = make_state(pos, vel)
    ref_step = jax.jit(reference_step)
    for _ in range(8):
        s_grid = grid_step(s_grid, params, spec)
        s_ref = ref_step(s_ref, params)
    np.testing.assert_allclose(
        np.asarray(s_grid.pos), np.asarray(s_ref.pos), rtol=1e-3, atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(s_grid.vel), np.asarray(s_ref.vel), rtol=1e-3, atol=5e-2
    )


def test_grid_physics_reports_overflow(rng):
    # cram everything into one cell with tiny capacity
    pos = np.zeros((32, 2), dtype=np.float32) + 0.1
    params = make_params(bounds=BOUNDS, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=4)
    _, overflow = jax.jit(
        lambda s, p: grid_physics(s, p, spec)
    )(make_state(pos), params)
    assert int(overflow) == 28


def test_grid_step_warmup_identity():
    params = make_params(bounds=BOUNDS, gravity=500.0, shader_delay=3)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=32)
    pos = np.asarray([[0.0, 0.0], [3.0, 0.0]], np.float32)
    s = make_state(pos)
    for _ in range(3):
        s = grid_step(s, params, spec)
    np.testing.assert_array_equal(np.asarray(s.pos), pos)
    assert int(s.frame) == 3


def test_suggest_capacity():
    assert suggest_capacity(1000, BOUNDS, 9.0) >= 8
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=1)
    assert suggest_capacity(100_000, spec) > 100


@pytest.mark.parametrize("num_keys,n", [(1, 1), (7, 50), (40, 300)])
def test_sorted_runs_match_brute_force(rng, num_keys, n):
    from rust_particle_system.ops.grid import sorted_runs

    keys = rng.integers(0, num_keys + 1, n).astype(np.int32)  # num_keys = trash
    perm, sk, starts = (np.asarray(a) for a in sorted_runs(jnp.asarray(keys), num_keys))
    np.testing.assert_array_equal(sk, keys[perm])
    assert np.all(np.diff(sk) >= 0)
    # stable: equal keys keep their input order
    for k in range(num_keys + 1):
        assert list(perm[sk == k]) == list(np.nonzero(keys == k)[0])
    assert starts.shape == (num_keys + 1,)
    for k in range(num_keys + 1):
        assert starts[k] == int((keys < k).sum())


def test_build_grid_without_capacity_has_no_table(rng):
    """The run walk's grid (capacity 0): runs and starts only, nothing overflows."""
    pos, _ = _random_state(rng, 400)
    pos[:100] = 3.0  # one crowded cell
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0)
    assert spec.capacity == 0
    grid = build_grid(spec, jnp.asarray(pos))
    assert grid.table.shape == (0, 0)
    assert int(grid.overflow) == 0
    counts = np.diff(np.asarray(grid.starts))
    assert counts.sum() == 400 and counts.max() >= 100


def test_quantities_unsorted_inverts_the_sort(rng):
    from rust_particle_system.ops.grid import SPHQuantities

    n = 37
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    orig = SPHQuantities(jnp.asarray(rng.random(n)), jnp.asarray(rng.random(n)),
                         jnp.asarray(rng.random((n, 2))), jnp.asarray(rng.random((n, 2))))
    sorted_q = jax.tree.map(lambda v: v[perm], orig)
    back = sorted_q.unsorted(perm)
    for a, b in zip(back, orig):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
